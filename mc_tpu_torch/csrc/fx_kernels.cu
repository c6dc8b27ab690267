// The cross-currency kernel of the port, for sm_90a.
//
// fx_partials_kernel replaces mc_tpu/models/fx.py _fx_partials (the Pallas
// call at :219): one path per thread over a grid-stride loop, one threefry
// pair at counter (id, 0) (13 or 20 rounds), the asset on z0 and the FX rate
// on rho*z0 + rho_perp*z1, both terminal laws exact, the contract's domestic
// payoff (a runtime switch: the contract is the same for every thread),
// paths at or past `bound` adding zeros; each block writes one row of f64
// [sum pay, sum pay^2] (reduce.cuh).  The twin of
// mc_tpu_torch/models/fx.py fx_vals operation for operation (--fmad=false).
//
// What bounds it on the H100: operations.  A path spends one threefry pair
// and its Box-Muller (log1pf, sqrtf, cosf, sinf), two expf and ~12 f32
// operations; it reads 44 bytes of parameters (uniform loads) and each block
// writes 16.

#include <cstdint>

#include <cuda_runtime.h>

#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kFxThreads = 256;

struct FxParams {
  float s0, k, x0, kx, x_bar, rho, rho_perp, drift_s_t, vol_s_t, drift_x_t, vol_x_t;
};

// Contract ids of mc_tpu_torch/models/fx.py FX_CONTRACTS: kind = id >> 1
// (gk, quanto, compo, flexo), a put where id is odd.
__device__ __forceinline__ float fx_pay(int contract, const FxParams& p, float s_t, float x_t) {
  const float sign = (contract & 1) ? -1.0f : 1.0f;
  switch (contract >> 1) {
    case 0: return fmaxf(sign * (x_t - p.kx), 0.0f);
    case 1: return p.x_bar * fmaxf(sign * (s_t - p.k), 0.0f);
    case 2: return fmaxf(sign * (s_t * x_t - p.k), 0.0f);
    default: return x_t * fmaxf(sign * (s_t - p.k), 0.0f);
  }
}

template <int ROUNDS>
__global__ void __launch_bounds__(kFxThreads)
fx_partials_kernel(int contract, uint32_t k0, uint32_t k1, const float* __restrict__ params,
                   uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                   double* __restrict__ partials) {
  const FxParams p = *reinterpret_cast<const FxParams*>(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    float z0, z1;
    normal_pair<ROUNDS>(k0, k1, id, 0u, z0, z1);
    const float z_x = p.rho * z0 + p.rho_perp * z1;
    const float s_t = p.s0 * expf(p.drift_s_t + p.vol_s_t * z0);
    const float x_t = p.x0 * expf(p.drift_x_t + p.vol_x_t * z_x);
    const float pv[1] = {fx_pay(contract, p, s_t, x_t)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kFxThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

}  // namespace mc

extern "C" {

int mc_fx_block_threads() { return mc::kFxThreads; }

// params: the 11 packed floats of pack_fx; partials (n_blocks, 2) f64.
int mc_fx_partials(int contract, int rounds, uint32_t k0, uint32_t k1, const float* params,
                   uint32_t n_paths, uint32_t path_offset, uint32_t bound, double* partials,
                   int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (contract < 0 || contract > 7 || n_blocks < 1) return cudaErrorInvalidValue;
  if (rounds == 13) {
    mc::fx_partials_kernel<13><<<n_blocks, mc::kFxThreads, 0, s>>>(
        contract, k0, k1, params, n_paths, path_offset, bound, partials);
  } else if (rounds == 20) {
    mc::fx_partials_kernel<20><<<n_blocks, mc::kFxThreads, 0, s>>>(
        contract, k0, k1, params, n_paths, path_offset, bound, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
