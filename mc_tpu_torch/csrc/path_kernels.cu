// Path-simulation kernels 1 and 2 of the port, for sm_90a.
//
// terminal_pair_kernel replaces mc_tpu/ops/path_kernels.py
// terminal_pair_partials (the Pallas call at :1031): element e draws one
// threefry + Box-Muller pair and prices the two exact GBM terminal paths 2e
// and 2e+1, each masked by pid < n_paths.
//
// simulate_kernel replaces mc_tpu/ops/path_kernels.py simulate_partials (the
// Pallas call at :450): the exact terminal draw or the log-Euler step loop
// (w += drift_dt + vol_dt*z; S = s0*exp(w)), one threefry per two steps,
// the payoff templated in, the antithetic leg and the control-variate
// moments fused into the same pass.  Importance sampling and resume are not
// ported yet; the Python wrapper refuses them.
//
// What bounds them on the H100: neither reads anything but 60 bytes of
// parameters and writes one row of moments per block, so bytes do not
// matter.  The cost is the RNG's integer work (13 or 20 threefry rounds of
// add/rotate/xor per pair) and the transcendentals (log1pf, sqrtf, cosf,
// sinf per pair, one expf per step).  The design keeps all of it in
// registers: one thread per path (per element for the pair kernel) over a
// grid-stride loop, both Box-Muller halves consumed, both antithetic legs
// stepped from the same draw, and f64 moment sums per thread reduced once
// per block (reduce.cuh).  Float contraction is off in the build
// (--fmad=false), so each mul and add rounds as in the plain version.

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kThreads = 256;

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kThreads)
terminal_pair_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params,
                     uint32_t n_elems, uint32_t n_paths_total,
                     double* __restrict__ partials) {
  const Params p = load_params(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t e = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_elems; e += stride) {
    float z0, z1;
    normal_pair<ROUNDS>(k0, k1, static_cast<uint32_t>(e), 0u, z0, z1);
    const uint64_t pid = 2 * e;
    const float pa = pid < n_paths_total
        ? Payoff::terminal(0.0f, p.s0 * expf(p.drift_t + p.vol_t * z0), p) : 0.0f;
    const float pb = pid + 1 < n_paths_total
        ? Payoff::terminal(0.0f, p.s0 * expf(p.drift_t + p.vol_t * z1), p) : 0.0f;
    acc[0] += static_cast<double>(pa + pb);
    acc[1] += static_cast<double>(pa * pa + pb * pb);
  }
  block_store_moments<2, kThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Payoff>
__device__ __forceinline__ void euler_step(const Params& p, float z, float& w,
                                           float& s, float& st) {
  w = w + (p.drift_dt + p.vol_dt * z);
  s = p.s0 * expf(w);  // log-space: one exp rounding per S_t
  st = Payoff::update(st, s, p);
}

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kThreads)
simulate_kernel(int euler, int antithetic, int with_cv, uint32_t k0, uint32_t k1,
                const float* __restrict__ params, int n_steps, uint32_t n_paths,
                uint32_t path_offset, uint32_t bound, double* __restrict__ partials,
                int n_mom) {
  const Params p = load_params(params);
  double acc[kMaxMoments] = {0.0, 0.0, 0.0, 0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    float pay, x;
    if (!euler) {
      float z, unused;
      normal_pair<ROUNDS>(k0, k1, id, 0u, z, unused);
      const float sp = p.s0 * expf(p.drift_t + p.vol_t * z);
      pay = Payoff::terminal(Payoff::init(), sp, p);
      x = sp;
      if (antithetic) {
        const float sn = p.s0 * expf(p.drift_t + p.vol_t * -z);
        pay = 0.5f * (pay + Payoff::terminal(Payoff::init(), sn, p));
        x = 0.5f * (x + sn);
      }
    } else {
      float w = 0.0f, s = p.s0, st = Payoff::init();
      float wn = 0.0f, sn = p.s0, stn = Payoff::init();  // antithetic leg
      float z0, z1;
      for (int m = 0; m < n_steps / 2; ++m) {
        normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
        euler_step<Payoff>(p, z0, w, s, st);
        euler_step<Payoff>(p, z1, w, s, st);
        if (antithetic) {
          euler_step<Payoff>(p, -z0, wn, sn, stn);
          euler_step<Payoff>(p, -z1, wn, sn, stn);
        }
      }
      if (n_steps & 1) {  // odd step count: the epilogue takes the head half
        normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(n_steps / 2), z0, z1);
        euler_step<Payoff>(p, z0, w, s, st);
        if (antithetic) euler_step<Payoff>(p, -z0, wn, sn, stn);
      }
      pay = Payoff::terminal(st, s, p);
      x = s;
      if (antithetic) {
        pay = 0.5f * (pay + Payoff::terminal(stn, sn, p));
        x = 0.5f * (x + sn);
      }
    }
    const bool valid = id < bound;
    pay = valid ? pay : 0.0f;
    acc[0] += static_cast<double>(pay);
    acc[1] += static_cast<double>(pay * pay);
    if (with_cv) {
      // Control variate X = terminal price (pair mean if antithetic).
      x = valid ? x : 0.0f;
      acc[2] += static_cast<double>(x);
      acc[3] += static_cast<double>(x * x);
      acc[4] += static_cast<double>(pay * x);
    }
  }
  block_store_moments<kMaxMoments, kThreads>(
      acc, partials + static_cast<size_t>(n_mom) * blockIdx.x, n_mom);
}

template <class Payoff>
cudaError_t launch_terminal_pair(int rounds, uint32_t k0, uint32_t k1,
                                 const float* params, uint32_t n_elems,
                                 uint32_t n_paths_total, double* partials,
                                 int n_blocks, cudaStream_t stream) {
  if (rounds == 13) {
    terminal_pair_kernel<Payoff, 13><<<n_blocks, kThreads, 0, stream>>>(
        k0, k1, params, n_elems, n_paths_total, partials);
  } else if (rounds == 20) {
    terminal_pair_kernel<Payoff, 20><<<n_blocks, kThreads, 0, stream>>>(
        k0, k1, params, n_elems, n_paths_total, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <class Payoff>
cudaError_t launch_simulate(int rounds, int euler, int antithetic, int with_cv,
                            uint32_t k0, uint32_t k1, const float* params,
                            int n_steps, uint32_t n_paths, uint32_t path_offset,
                            uint32_t bound, double* partials, int n_mom,
                            int n_blocks, cudaStream_t stream) {
  if (rounds == 13) {
    simulate_kernel<Payoff, 13><<<n_blocks, kThreads, 0, stream>>>(
        euler, antithetic, with_cv, k0, k1, params, n_steps, n_paths,
        path_offset, bound, partials, n_mom);
  } else if (rounds == 20) {
    simulate_kernel<Payoff, 20><<<n_blocks, kThreads, 0, stream>>>(
        euler, antithetic, with_cv, k0, k1, params, n_steps, n_paths,
        path_offset, bound, partials, n_mom);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

const char* mc_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int mc_block_threads() { return mc::kThreads; }

int mc_terminal_pair(int payoff_id, int rounds, uint32_t k0, uint32_t k1,
                     const float* params, uint32_t n_elems, uint32_t n_paths_total,
                     double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (payoff_id) {
    case mc::PAYOFF_VANILLA_CALL:
      return mc::launch_terminal_pair<mc::VanillaCall>(
          rounds, k0, k1, params, n_elems, n_paths_total, partials, n_blocks, s);
    case mc::PAYOFF_VANILLA_PUT:
      return mc::launch_terminal_pair<mc::VanillaPut>(
          rounds, k0, k1, params, n_elems, n_paths_total, partials, n_blocks, s);
    default:  // path-dependent payoffs have no terminal draw
      return cudaErrorInvalidValue;
  }
}

int mc_simulate_partials(int payoff_id, int rounds, int euler, int antithetic,
                         int with_cv, uint32_t k0, uint32_t k1, const float* params,
                         int n_steps, uint32_t n_paths, uint32_t path_offset,
                         uint32_t bound, double* partials, int n_mom, int n_blocks,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (payoff_id) {
    case mc::PAYOFF_VANILLA_CALL:
      return mc::launch_simulate<mc::VanillaCall>(
          rounds, euler, antithetic, with_cv, k0, k1, params, n_steps, n_paths,
          path_offset, bound, partials, n_mom, n_blocks, s);
    case mc::PAYOFF_VANILLA_PUT:
      return mc::launch_simulate<mc::VanillaPut>(
          rounds, euler, antithetic, with_cv, k0, k1, params, n_steps, n_paths,
          path_offset, bound, partials, n_mom, n_blocks, s);
    case mc::PAYOFF_BULLET_CALL:
      return mc::launch_simulate<mc::BulletCall>(
          rounds, euler, antithetic, with_cv, k0, k1, params, n_steps, n_paths,
          path_offset, bound, partials, n_mom, n_blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
