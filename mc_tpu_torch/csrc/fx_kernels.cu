// The cross-currency kernel of the port, for sm_90a.
//
// fx_partials_kernel replaces mc_tpu/models/fx.py _fx_partials (the Pallas
// call at :219): one threefry pair at counter (id, 0) a path (13 or 20
// rounds), the asset on z0 and the FX rate on rho*z0 + rho_perp*z1, both
// terminal laws exact, the contract's domestic payoff, paths at or past
// `bound` adding zeros; each block writes one row of f64 [sum pay, sum
// pay^2] (reduce.cuh).  The twin of mc_tpu_torch/models/fx.py fx_vals
// operation for operation (--fmad=false).
//
// Each of the 8 contracts is an instantiation of its own, picked once on the
// host (mc_fx_partials), and computes only the terminal values its payoff
// reads: the quanto S_T, Garman-Kohlhagen z_x and X_T, the compo and the
// flexo both.  Each value computed keeps its bits, and a payoff reads no
// other, so the rows keep theirs.  A block sums kFxBlockPaths = 256 paths,
// block b paths b*256 .. b*256+255, grid-strided, as the one-path-a-thread
// kernel did: its 256 / P threads each run P of them in lockstep, thread t
// paths t, t + T, .. t + (P-1)T (T the block's threads), each path's f64
// [pay, pay^2] in a lane of its own.  The lanes add as that kernel's block
// tree added its threads t + pT (lane p and p + h at its level T*h), and the
// T threads' tree finishes, its last levels in a warp (reduce.cuh
// block_store_moments_warp): every row keeps its bits.
//
// What bounds it on the H100: operations.  A path spends one threefry pair
// and its Box-Muller (log1pf, sqrtf, sincosf), one or two expf and 7-13 f32
// operations; it reads 44 bytes of parameters (uniform loads, once a
// thread) and each block writes 16.  The parameters, the grid-stride loop
// and the block's tree cost about as much as a path: P paths a thread pay
// them once for P.

#include <cstdint>

#include <cuda_runtime.h>

#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kFxBlockPaths = 256;  // paths a block: the one-path kernel's threads
// Paths a thread in lockstep: on the H100 (family_nmc_probe.py --fx,
// PERF.md) 1, 2 and 4 took the quanto call at 2^24 paths in 0.0962 /
// 0.0937 / 0.0929 ms, at 1M in 0.0098 / 0.0095 / 0.0109 ms (4 spills
// under GK); 2 ran the six timed rows fastest.
constexpr int kFxPaths = 2;
constexpr int kFxThreads = kFxBlockPaths / kFxPaths;
static_assert(kFxBlockPaths % kFxPaths == 0 && kFxThreads >= 32 &&
                  (kFxThreads & (kFxThreads - 1)) == 0,
              "a block's threads are a power of two of at least a warp");

struct FxParams {
  float s0, k, x0, kx, x_bar, rho, rho_perp, drift_s_t, vol_s_t, drift_x_t, vol_x_t;
};

// Contract ids of mc_tpu_torch/models/fx.py FX_CONTRACTS: kind = id >> 1
// (gk, quanto, compo, flexo), a put where id is odd.  The payoff of one
// path from its pair, each terminal value only where the payoff reads it.
template <int CONTRACT>
__device__ __forceinline__ float fx_pay(const FxParams& p, float z0, float z1) {
  constexpr int kKind = CONTRACT >> 1;
  constexpr float kSign = (CONTRACT & 1) ? -1.0f : 1.0f;
  if constexpr (kKind == 1) {  // quanto: S_T alone
    const float s_t = p.s0 * expf(p.drift_s_t + p.vol_s_t * z0);
    return p.x_bar * fmaxf(kSign * (s_t - p.k), 0.0f);
  } else {
    const float z_x = p.rho * z0 + p.rho_perp * z1;
    const float x_t = p.x0 * expf(p.drift_x_t + p.vol_x_t * z_x);
    if constexpr (kKind == 0) {  // Garman-Kohlhagen: X_T alone
      return fmaxf(kSign * (x_t - p.kx), 0.0f);
    } else {
      const float s_t = p.s0 * expf(p.drift_s_t + p.vol_s_t * z0);
      if constexpr (kKind == 2) return fmaxf(kSign * (s_t * x_t - p.k), 0.0f);
      return x_t * fmaxf(kSign * (s_t - p.k), 0.0f);
    }
  }
}

template <int CONTRACT, int ROUNDS>
__global__ void __launch_bounds__(kFxThreads)
fx_partials_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params,
                   uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                   double* __restrict__ partials) {
  constexpr int P = kFxPaths;
  constexpr int T = kFxThreads;
  const FxParams p = *reinterpret_cast<const FxParams*>(params);
  double acc[P][2];
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q][0] = acc[q][1] = 0.0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kFxBlockPaths;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kFxBlockPaths + threadIdx.x;
       i < n_paths; i += stride) {
    float z0[P], z1[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      normal_pair<ROUNDS>(k0, k1, path_offset + static_cast<uint32_t>(i + q * T), 0u, z0[q],
                          z1[q]);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const uint32_t id = path_offset + static_cast<uint32_t>(i + q * T);
      const float pv[1] = {fx_pay<CONTRACT>(p, z0[q], z1[q])};
      // a lane past the last path adds zeros
      add_moments(acc[q], pv, i + q * T < n_paths && id < bound);
    }
  }
#pragma unroll
  for (int h = P / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int q = 0; q < h; ++q) {
      acc[q][0] += acc[q + h][0];
      acc[q][1] += acc[q + h][1];
    }
  }
  block_store_moments_warp<2, T>(acc[0], partials + 2 * static_cast<size_t>(blockIdx.x));
}

template <int CONTRACT>
cudaError_t launch_fx(int rounds, uint32_t k0, uint32_t k1, const float* params,
                      uint32_t n_paths, uint32_t path_offset, uint32_t bound, double* partials,
                      int n_blocks, cudaStream_t stream) {
  if (rounds == 13) {
    fx_partials_kernel<CONTRACT, 13><<<n_blocks, kFxThreads, 0, stream>>>(
        k0, k1, params, n_paths, path_offset, bound, partials);
  } else if (rounds == 20) {
    fx_partials_kernel<CONTRACT, 20><<<n_blocks, kFxThreads, 0, stream>>>(
        k0, k1, params, n_paths, path_offset, bound, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int CONTRACT>
cudaError_t fx_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fx_partials_kernel<CONTRACT, 13>,
                                                       kFxThreads, 0);
}

}  // namespace mc

// The 8 contracts of FX_CONTRACTS, by id.
#define MC_FX_CONTRACTS(X) X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7)

extern "C" {

// The kernel's paths a block (its grid: ceil(n_paths / it), capped) and
// paths a thread.
int mc_fx_block_paths() { return mc::kFxBlockPaths; }
int mc_fx_paths_per_thread() { return mc::kFxPaths; }

// Resident blocks per SM of a contract's threefry-13 instantiation.
int mc_fx_occupancy(int contract, int* blocks) {
#define MC_CASE(C) \
  case C: return mc::fx_occupancy<C>(blocks);
  switch (contract) {
    MC_FX_CONTRACTS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

// params: the 11 packed floats of pack_fx; partials (n_blocks, 2) f64.
int mc_fx_partials(int contract, int rounds, uint32_t k0, uint32_t k1, const float* params,
                   uint32_t n_paths, uint32_t path_offset, uint32_t bound, double* partials,
                   int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks < 1) return cudaErrorInvalidValue;
#define MC_CASE(C)                                                                      \
  case C:                                                                               \
    return mc::launch_fx<C>(rounds, k0, k1, params, n_paths, path_offset, bound, partials, \
                            n_blocks, s);
  switch (contract) {
    MC_FX_CONTRACTS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
