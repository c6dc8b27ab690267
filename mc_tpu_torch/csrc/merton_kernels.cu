// Merton kernels of the port, for sm_90a.
//
// merton_partials_kernel replaces mc_tpu/models/merton.py _merton_partials
// (the Pallas call at :289): the exact terminal draw or the Euler loop over
// step pairs, each pair m drawing merton_draw3's counters (3m, 3m+1, 3m+2:
// diffusion normals, jump-size normals, Poisson uniforms); threefry-13 or
// -20; the antithetic twin from the same draws (normals negated, u -> 1-u)
// as one more lockstep leg; paths at or past `bound` add zeros; each block
// writes one row of f64 [sum pay, sum pay^2] (reduce.cuh), no float
// atomics.  The terminal draw keeps mc_tpu's layout: the diffusion normal
// and the jump-size normal are the two halves of pair (id, 0), the uniform
// word 0 of (id, 2).  The Euler loop takes every payoff of the registry,
// the terminal draw the six terminal-only ones.
//
// One path a thread, kMertonThreads = 256 a block, grid-strided, as the
// kernel it replaced; its block tree sums the threads, so every row keeps
// its bits.  (Two paths a thread in lockstep ran slower on the H100, with
// spills: family_nmc_probe.py --partials.)
//
// The Poisson count: thread 0 builds the block's cdf table F(0..kmax-1) at
// lam*dt (Euler) or lam*T (terminal) in shared memory, the scan's
// recurrence in its order (poisson_cdf_table), and its least entry after
// it; a count is taken against the table (poisson_counts), bit for bit the
// scan's, without the scan's expf and kmax divisions a draw.
//
// The jump only where a count can be nonzero: a uniform below the table's
// least entry counts 0, and a count of 0 gives the jump n*mu_j +
// (sigma_j*sqrtf(n))*e = +0 or -0 whatever e is (mu_j and sigma_j finite;
// else every pair draws them).
// Where none of a thread's uniforms of a step pair reaches the table, the
// pair's jump-size normals (counter 3m+1) are not drawn and each step adds
// +0: w = ((w + drift_dt) + vol_dt*z) + 0.  That is the scan's w bit for
// bit because w is never -0: it starts at +0, and a sum is -0 only when
// both of its terms are (w + drift_dt, then w itself).  At lam*dt = 0.003 a
// thread draws them on ~0.6% of its pairs, a warp on ~17% (antithetic:
// ~1.2%, ~32%).
//
// merton_trajectories (#15) and the Merton instantiations of the family NMC
// kernels are in merton_nmc_kernels.cu.
//
// What bounds them on the H100: operations.  A step pair spends two
// threefry calls (the diffusion normals and the uniforms), a Box-Muller
// pair, the counts (one compare a uniform; kmax compare-adds against the
// table where it reaches it) and per step ~5 f32 operations and an expf;
// the jump-size pair (a threefry call, a Box-Muller pair, per step a sqrtf
// and 4 operations) only where a count can be nonzero.  The parameters are
// 76 bytes and each block writes 16.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "merton.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kMertonThreads = 256;
constexpr int kMertonMaxKmax = 256;

// The Merton step on a jump drawn before it: w = ((w + drift_dt) +
// vol_dt*z) + jump, S = base*exp(w) (merton_step_n's association).
template <class Payoff>
__device__ __forceinline__ void merton_step_jump(const MertonParams& m, float jump, float z,
                                                 float base, float& w, float& s,
                                                 typename Payoff::State& st) {
  w = ((w + m.pay.drift_dt) + m.pay.vol_dt * z) + jump;
  s = base * expf(w);  // log-space: one exp rounding per S_t
  st = Payoff::update(st, s, m.pay);
}

// The two methods as the partials kernel takes them: a path's payoff (the
// pair's mean if antithetic), the counts against the block's table `cdf`
// (kmax entries, their least at cdf[kmax]).
struct MertonEuler {
  __device__ static float lam(const MertonParams& m) { return m.lam_dt; }

  template <class Payoff, int ROUNDS, bool A>
  __device__ static float pay(const MertonParams& m, const float* cdf, int kmax, uint32_t k0,
                              uint32_t k1, uint32_t id, int n_steps) {
    constexpr int L = A ? 2 : 1;  // leg 0 the path, leg 1 its antithetic twin
    const float s0 = m.pay.s0;
    const float f_min = cdf[kmax];
    const bool always = !(isfinite(m.mu_j) && isfinite(m.sigma_j));
    float w[L], s[L];
    typename Payoff::State st[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      w[l] = 0.0f;
      s[l] = s0;
      st[l] = Payoff::init(m.pay);
    }
    for (int pair = 0; pair < n_steps / 2; ++pair) {
      const uint32_t base = 3u * static_cast<uint32_t>(pair);
      float z0[L], z1[L], u0[L], u1[L];
      normal_pair<ROUNDS>(k0, k1, id, base, z0[0], z1[0]);
      uint32_t x0 = id, x1 = base + 2u;
      threefry2x32<ROUNDS>(k0, k1, x0, x1);
      u0[0] = bits_to_unit(x0);
      u1[0] = bits_to_unit(x1);
      if constexpr (A) {
        z0[1] = -z0[0];
        z1[1] = -z1[0];
        u0[1] = 1.0f - u0[0];
        u1[1] = 1.0f - u1[0];
      }
      bool jumps = always;
#pragma unroll
      for (int l = 0; l < L; ++l) jumps = jumps || !(u0[l] < f_min) || !(u1[l] < f_min);
      float j0[L], j1[L];
      if (jumps) {
        float e0[L], e1[L], n0[L], n1[L];
        normal_pair<ROUNDS>(k0, k1, id, base + 1u, e0[0], e1[0]);
        if constexpr (A) {
          e0[1] = -e0[0];
          e1[1] = -e1[0];
        }
        poisson_counts(cdf, kmax, u0, n0);
        poisson_counts(cdf, kmax, u1, n1);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          j0[l] = jump_increment(m.mu_j, m.sigma_j, n0[l], e0[l]);
          j1[l] = jump_increment(m.mu_j, m.sigma_j, n1[l], e1[l]);
        }
      } else {
#pragma unroll
        for (int l = 0; l < L; ++l) j0[l] = j1[l] = 0.0f;
      }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        merton_step_jump<Payoff>(m, j0[l], z0[l], s0, w[l], s[l], st[l]);
        merton_step_jump<Payoff>(m, j1[l], z1[l], s0, w[l], s[l], st[l]);
      }
    }
    const float p = Payoff::terminal(st[0], s[0], m.pay);
    if constexpr (A) return 0.5f * (p + Payoff::terminal(st[1], s[1], m.pay));
    return p;
  }
};

struct MertonTerminal {
  __device__ static float lam(const MertonParams& m) { return m.lam_t; }

  // S_T = s0*exp((drift_t + vol_t*z) + jump(n, e)).
  __device__ static float terminal_s(const MertonParams& m, float z, float e, float n) {
    return m.pay.s0 *
           expf((m.pay.drift_t + m.pay.vol_t * z) + jump_increment(m.mu_j, m.sigma_j, n, e));
  }

  template <class Payoff, int ROUNDS, bool A>
  __device__ static float pay(const MertonParams& m, const float* cdf, int kmax, uint32_t k0,
                              uint32_t k1, uint32_t id, int) {
    constexpr int L = A ? 2 : 1;
    float z, e;
    normal_pair<ROUNDS>(k0, k1, id, 0u, z, e);
    const float u = unit_draw<ROUNDS>(k0, k1, id, 2u);
    float us[L], n[L];
    us[0] = u;
    if constexpr (A) us[1] = 1.0f - u;
    poisson_counts(cdf, kmax, us, n);
    const typename Payoff::State st = Payoff::init(m.pay);
    const float p = Payoff::terminal(st, terminal_s(m, z, e, n[0]), m.pay);
    if constexpr (A) return 0.5f * (p + Payoff::terminal(st, terminal_s(m, -z, -e, n[1]), m.pay));
    return p;
  }
};

// The partials kernel: one path a thread, grid-strided; paths at or past
// `bound` add zeros; one f64 row [sum pay, sum pay^2] a block.
template <class Payoff, class Method, int ROUNDS, bool A>
__global__ void __launch_bounds__(kMertonThreads)
merton_partials_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params, int kmax,
                       int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                       double* __restrict__ partials) {
  __shared__ float cdf[kMertonMaxKmax + 1];
  const MertonParams m = load_merton(params);
  if (threadIdx.x == 0) {
    poisson_cdf_table(Method::lam(m), kmax, cdf);
    float f_min = cdf[0];
    for (int k = 1; k < kmax; ++k) f_min = fminf(f_min, cdf[k]);
    cdf[kmax] = f_min;
  }
  __syncthreads();
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kMertonThreads;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kMertonThreads + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {
        Method::template pay<Payoff, ROUNDS, A>(m, cdf, kmax, k0, k1, id, n_steps)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kMertonThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Payoff, class Method>
cudaError_t launch_merton_partials(int rounds, int antithetic, uint32_t k0, uint32_t k1,
                                   const float* params, int kmax, int n_steps,
                                   uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                   double* partials, int n_blocks, cudaStream_t stream) {
#define MC_MERTON_LAUNCH(R, A)                                                            \
  merton_partials_kernel<Payoff, Method, R, A>                                           \
      <<<n_blocks, kMertonThreads, 0, stream>>>(k0, k1, params, kmax, n_steps, n_paths, \
                                                path_offset, bound, partials);            \
  return cudaGetLastError()
  if (rounds == 13) {
    if (antithetic) { MC_MERTON_LAUNCH(13, true); }
    MC_MERTON_LAUNCH(13, false);
  }
  if (rounds == 20) {
    if (antithetic) { MC_MERTON_LAUNCH(20, true); }
    MC_MERTON_LAUNCH(20, false);
  }
#undef MC_MERTON_LAUNCH
  return cudaErrorInvalidValue;
}

template <class Method>
cudaError_t merton_occupancy(int antithetic, int* blocks) {
  using Fn = void (*)(uint32_t, uint32_t, const float*, int, int, uint32_t, uint32_t,
                      uint32_t, double*);
  const Fn f = antithetic ? merton_partials_kernel<VanillaCall, Method, 13, true>
                          : merton_partials_kernel<VanillaCall, Method, 13, false>;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f, kMertonThreads, 0);
}

}  // namespace mc

extern "C" {

// The partials kernel's paths a block (its grid: ceil(n_paths / it),
// capped).
int mc_merton_block_paths() { return mc::kMertonThreads; }

// Resident blocks per SM of the partials kernel (VanillaCall, threefry-13).
int mc_merton_occupancy(int payoff_id, int terminal, int antithetic, int* blocks) {
  if (payoff_id != mc::PAYOFF_VANILLA_CALL) return cudaErrorInvalidValue;
  return terminal ? mc::merton_occupancy<mc::MertonTerminal>(antithetic, blocks)
                  : mc::merton_occupancy<mc::MertonEuler>(antithetic, blocks);
}

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
