// Merton kernels of the port, for sm_90a.
//
// merton_partials_kernel replaces mc_tpu/models/merton.py _merton_partials
// (the Pallas call at :289): one path per thread over a grid-stride loop;
// the exact terminal draw or the Euler loop over step pairs, each pair m
// drawing merton_draw3 (counters 3m, 3m+1, 3m+2: diffusion normals,
// jump-size normals, Poisson uniforms); threefry-13 or -20; the antithetic
// twin in the same thread from the same draws (normals negated, u -> 1-u);
// paths at or past `bound` add zeros; each block writes one row of f64
// [sum pay, sum pay^2] (reduce.cuh), no float atomics.  The terminal draw
// keeps mc_tpu's layout: the diffusion normal and the jump-size normal are
// the two halves of pair (id, 0), the uniform word 0 of (id, 2).  The
// Euler loop takes every payoff of the registry, the terminal draw the six
// terminal-only ones.
//
// merton_trajectories (#15) and the Merton instantiations of the family NMC
// kernels are in merton_nmc_kernels.cu.
//
// What bounds them on the H100: operations.  A step pair spends three
// threefry calls (GBM's log-Euler spends one), two Box-Muller pairs, the
// Poisson scan (kmax iterations of a multiply, an IEEE division, an add and
// a compare, kmax = 4 at lam*dt = 0.003) and per step a sqrtf and an expf.
// The parameters are 76 bytes and each block writes 16.  Everything stays in
// registers: one thread per path, both legs from the same draws.

#include <cstdint>

#include <cuda_runtime.h>

#include "merton.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kMertonThreads = 256;

// The two methods as the partials kernel takes them: the path's payoff and,
// if antithetic, the pair mean.
struct MertonEuler {
  template <class Payoff, int ROUNDS>
  __device__ static float pay(const MertonParams& m, int kmax, bool antithetic, uint32_t k0,
                              uint32_t k1, uint32_t id, int n_steps) {
    using State = typename Payoff::State;
    const float s0 = m.pay.s0;
    float w = 0.0f, s = s0, wn = 0.0f, sn = s0;
    State st = Payoff::init(m.pay), stn = st;
    for (int pair = 0; pair < n_steps / 2; ++pair) {
      const MertonDraws d = merton_draw3<ROUNDS>(k0, k1, id, static_cast<uint32_t>(pair));
      merton_step<Payoff>(m, kmax, d.z0, d.e0, d.u0, s0, w, s, st);
      merton_step<Payoff>(m, kmax, d.z1, d.e1, d.u1, s0, w, s, st);
      if (antithetic) {
        merton_step<Payoff>(m, kmax, -d.z0, -d.e0, 1.0f - d.u0, s0, wn, sn, stn);
        merton_step<Payoff>(m, kmax, -d.z1, -d.e1, 1.0f - d.u1, s0, wn, sn, stn);
      }
    }
    float p = Payoff::terminal(st, s, m.pay);
    if (antithetic) p = 0.5f * (p + Payoff::terminal(stn, sn, m.pay));
    return p;
  }
};

struct MertonTerminal {
  // S_T = s0*exp((drift_t + vol_t*z) + jump(N(u; lam*T), e)).
  __device__ static float terminal_s(const MertonParams& m, int kmax, float z, float e, float u) {
    const float n = poisson_inv_cdf(u, m.lam_t, kmax);
    return m.pay.s0 *
           expf((m.pay.drift_t + m.pay.vol_t * z) + jump_increment(m.mu_j, m.sigma_j, n, e));
  }

  template <class Payoff, int ROUNDS>
  __device__ static float pay(const MertonParams& m, int kmax, bool antithetic, uint32_t k0,
                              uint32_t k1, uint32_t id, int) {
    float z, e;
    normal_pair<ROUNDS>(k0, k1, id, 0u, z, e);
    const float u = unit_draw<ROUNDS>(k0, k1, id, 2u);
    const typename Payoff::State st = Payoff::init(m.pay);
    float p = Payoff::terminal(st, terminal_s(m, kmax, z, e, u), m.pay);
    if (antithetic) {
      p = 0.5f * (p + Payoff::terminal(st, terminal_s(m, kmax, -z, -e, 1.0f - u), m.pay));
    }
    return p;
  }
};

template <class Payoff, class Method, int ROUNDS>
__global__ void __launch_bounds__(kMertonThreads)
merton_partials_kernel(int antithetic, uint32_t k0, uint32_t k1,
                       const float* __restrict__ params, int kmax, int n_steps,
                       uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                       double* __restrict__ partials) {
  const MertonParams m = load_merton(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {Method::template pay<Payoff, ROUNDS>(m, kmax, antithetic != 0, k0,
                                                              k1, id, n_steps)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kMertonThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x),
                                         2);
}

template <class Payoff, class Method>
cudaError_t launch_merton_partials(int rounds, int antithetic, uint32_t k0, uint32_t k1,
                                   const float* params, int kmax, int n_steps,
                                   uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                   double* partials, int n_blocks, cudaStream_t stream) {
  if (rounds == 13) {
    merton_partials_kernel<Payoff, Method, 13><<<n_blocks, kMertonThreads, 0, stream>>>(
        antithetic, k0, k1, params, kmax, n_steps, n_paths, path_offset, bound, partials);
  } else if (rounds == 20) {
    merton_partials_kernel<Payoff, Method, 20><<<n_blocks, kMertonThreads, 0, stream>>>(
        antithetic, k0, k1, params, kmax, n_steps, n_paths, path_offset, bound, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_merton_block_threads() { return mc::kMertonThreads; }

int mc_merton_partials(int payoff_id, int terminal, int rounds, int antithetic, uint32_t k0,
                       uint32_t k1, const float* params, int kmax, int n_steps,
                       uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                       double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kmax < 1 || kmax > 256 || (!terminal && n_steps % 2)) return cudaErrorInvalidValue;
#define MC_CASE(ID, PAYOFF)                                                                \
  case mc::ID:                                                                             \
    return mc::launch_merton_partials<mc::PAYOFF, METHOD>(rounds, antithetic, k0, k1,      \
                                                          params, kmax, n_steps, n_paths,  \
                                                          path_offset, bound, partials,    \
                                                          n_blocks, s);
  if (terminal) {
#define METHOD mc::MertonTerminal
    switch (payoff_id) {
      MC_TERMINAL_PAYOFFS(MC_CASE)
      default: return cudaErrorInvalidValue;  // path payoffs need the step loop
    }
#undef METHOD
  }
#define METHOD mc::MertonEuler
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef METHOD
#undef MC_CASE
}

}  // extern "C"
