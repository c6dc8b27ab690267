// The rainbow's partials kernel (#27, replaces mc_tpu/models/rainbow.py
// _rainbow_partials, the Pallas call at :149), for sm_90a: its legs, the
// kernel and one launcher per capacity, instantiated in two sources that
// nvcc compiles in parallel (rainbow_kernels.cu: 4, 8 and the dispatch;
// rainbow32_kernels.cu: 16 and 32).
//
// A path is one exact correlated terminal draw of d assets: the ceil(d/2)
// threefry pairs at counters (id, q) (13 or 20 rounds), the Cholesky mix
// y_i = L_i0 z_0 + L_i1 z_1 + ... in k order, S_i = s0_i * expf(drift_i +
// sqrt_T * y_i), folded by max and min in asset order from asset 0; the
// antithetic leg is the same draw's -y (its y is -y exactly), the pair
// averaged as 0.5*(a + b).  The payoff is a runtime switch on a uniform id,
// once a path; paths at or past `bound` add zeros; each block writes one row
// of f64 [sum pay, sum pay^2] (reduce.cuh).  The twin of
// mc_tpu_torch/models/rainbow.py operation for operation (--fmad=false).
//
// A block sums kRainbowBlockPaths = 256 paths, block b paths b*256 ..
// b*256+255, grid-strided, as the one-path-a-thread kernel it replaced did:
// its 256 / P threads each run P of them in lockstep, thread t paths t, t +
// T, .. t + (P-1)T (T the block's threads), each path's f64 [pay, pay^2] in
// a lane of its own.  The lanes add as that kernel's block tree added its
// threads t + pT (lane p and p + h at its level T*h), and the T threads'
// tree finishes, its last levels in a warp (reduce.cuh
// block_store_moments_warp): every row keeps its bits.  The plain and the
// antithetic kernels are apart (a template parameter, picked on the host).
//
// Capacity kMaxD of d (basket_capacity: 4, 8, 16, 32), picked on the host
// in mc_rainbow_partials: up to 16 the loops over assets unroll to the
// capacity, the normals live in registers and each Cholesky row, drift and
// s0 is a uniform load read once for the thread's P paths.  At 32 a thread
// runs one path, its normals and the pack staged in shared memory, the mix
// by blocks of 8 rows (a block past d skipped), as the basket's kernels do
// (basket_partials.cuh).
//
// What bounds it on the H100: operations.  A path spends ceil(d/2) threefry
// pairs and their Box-Muller, the mix's d(d+1)/2 multiplies and d(d-1)/2
// adds, d expf (2d with the antithetic leg) and ~4d f32 operations more;
// the parameters are 4(10 + 3d + d(d+1)/2) bytes, each block writes 16.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "basket.cuh"
#include "basket_partials.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kRainbowBlockPaths = 256;  // paths a block: the one-path kernel's threads

// Paths a thread at capacity kMaxD (an antithetic path's two legs run as
// one): on the H100 (family_nmc_probe.py --fx, PERF.md) 1, 2 and 4 took
// the best-of call at 1M paths in 0.0185 / 0.0164 / 0.0164 ms at d = 4,
// 0.0355 / 0.0305 / 0.0353 at d = 8 and 0.0411 / 0.0435 / 0.0453 at d = 9
// (capacity 16: 2 and 4 hold 72-166 registers).  Capacity 32 runs one.
__host__ __device__ constexpr int rainbow_paths_per_thread(int kMaxD) {
  return kMaxD <= 8 ? 2 : 1;
}

// Payoff ids of mc_tpu_torch/models/rainbow.py RAINBOW_PAYOFFS.
__device__ __forceinline__ float rainbow_pay(int payoff, float k, float mx, float mn, float s0,
                                             float s1) {
  switch (payoff) {
    case 0: return fmaxf(mx - k, 0.0f);   // call_on_max
    case 1: return fmaxf(mn - k, 0.0f);   // call_on_min
    case 2: return fmaxf(k - mx, 0.0f);   // put_on_max
    case 3: return fmaxf(k - mn, 0.0f);   // put_on_min
    case 4: return fmaxf(s0 - s1, 0.0f);  // exchange
    default: return fmaxf(mx, k);         // best_of_cash
  }
}

// S legs' (the + leg, and the - leg if antithetic) running max and min and
// their first two prices.
template <int S>
struct RainbowFold {
  float mx[S], mn[S], a0[S], a1[S];
};

// Asset a's price on leg s, y its mix (the - leg's y is -y).
template <int S>
__device__ __forceinline__ void rainbow_fold(RainbowFold<S>& f, int a, float s0a, float drift,
                                             float sqrt_t, float y) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float v = s0a * expf(drift + sqrt_t * (s == 0 ? y : -y));
    f.mx[s] = a == 0 ? v : fmaxf(f.mx[s], v);
    f.mn[s] = a == 0 ? v : fminf(f.mn[s], v);
    if (a == 0) f.a0[s] = v;
    if (a == 1) f.a1[s] = v;
  }
}

// The path's payoff from its legs' folds: the pair's mean if antithetic.
template <int S>
__device__ __forceinline__ float rainbow_path_pay(const RainbowFold<S>& f, int payoff, float k) {
  float p = rainbow_pay(payoff, k, f.mx[0], f.mn[0], f.a0[0], f.a1[0]);
  if constexpr (S == 2) p = 0.5f * (p + rainbow_pay(payoff, k, f.mx[1], f.mn[1], f.a0[1], f.a1[1]));
  return p;
}

template <int S>
__device__ __forceinline__ RainbowFold<S> rainbow_fold_init() {
  RainbowFold<S> f;
#pragma unroll
  for (int s = 0; s < S; ++s) f.mx[s] = f.mn[s] = f.a0[s] = f.a1[s] = 0.0f;
  return f;
}

// P paths at capacity kMaxD <= 16: each path's payoff.
template <int kMaxD, int P, int ROUNDS, bool A>
__device__ __forceinline__ void rainbow_paths(const BasketParams<kMaxD>& c, int payoff,
                                              uint32_t k0, uint32_t k1,
                                              const uint32_t (&id)[P], float (&pay)[P]) {
  constexpr int S = A ? 2 : 1;
  float z[P][kMaxD];
#pragma unroll
  for (int p = 0; p < P; ++p) basket_draw<kMaxD, ROUNDS>(c, k0, k1, id[p], 0u, 1.0f, z[p]);
  RainbowFold<S> f[P];
#pragma unroll
  for (int p = 0; p < P; ++p) f[p] = rainbow_fold_init<S>();
#pragma unroll
  for (int a = 0; a < kMaxD; ++a) {
    if (a < c.d) {
      const float* row = c.chol + a * (a + 1) / 2;
      const float r0 = __ldg(row);
      float y[P];
#pragma unroll
      for (int p = 0; p < P; ++p) y[p] = r0 * z[p][0];
#pragma unroll
      for (int k = 1; k <= a; ++k) {
        const float rk = __ldg(row + k);
#pragma unroll
        for (int p = 0; p < P; ++p) y[p] = y[p] + rk * z[p][k];
      }
      const float s0a = __ldg(c.s0s + a), drift = __ldg(c.drift + a);
#pragma unroll
      for (int p = 0; p < P; ++p) rainbow_fold(f[p], a, s0a, drift, c.sqrt_dt, y[p]);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) pay[p] = rainbow_path_pay(f[p], payoff, c.pay.k);
}

// One path at capacity 32, the pack c and the thread's normals (z_k at
// zs[k * kRainbowBlockPaths]) in shared memory.  The mix runs by blocks of 8
// rows, y of the block in registers: the columns below the block's diagonal
// a loop, the diagonal's 8 unrolled; each row's k order is the one-path
// mix's.
template <int ROUNDS, bool A>
__device__ __forceinline__ float rainbow_path32(const BasketParams<32>& c, float* zs, int payoff,
                                                uint32_t k0, uint32_t k1, uint32_t id) {
  constexpr int S = A ? 2 : 1;
  constexpr int T = kRainbowBlockPaths;
  for (int q = 0; q < c.npps; ++q) {
    normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(q), zs[2 * q * T],
                        zs[(2 * q + 1) * T]);
  }
  RainbowFold<S> f = rainbow_fold_init<S>();
#pragma unroll
  for (int lo = 0; lo < 32; lo += 8) {
    if (lo < c.d) {
      float y[8];
      const float z0 = zs[0];
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = c.chol[(lo + i) * (lo + i + 1) / 2] * z0;
      for (int k = 1; k < lo; ++k) {
        const float zk = zs[k * T];
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = y[i] + c.chol[(lo + i) * (lo + i + 1) / 2 + k] * zk;
      }
#pragma unroll
      for (int k = lo > 0 ? lo : 1; k < lo + 8; ++k) {
        if (k < c.d) {
          const float zk = zs[k * T];
#pragma unroll
          for (int i = k - lo; i < 8; ++i)
            y[i] = y[i] + c.chol[(lo + i) * (lo + i + 1) / 2 + k] * zk;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (lo + i < c.d) rainbow_fold(f, lo + i, c.s0s[lo + i], c.drift[lo + i], c.sqrt_dt, y[i]);
      }
    }
  }
  return rainbow_path_pay(f, payoff, c.pay.k);
}

template <int kMaxD, int ROUNDS, bool A>
__global__ void __launch_bounds__(kRainbowBlockPaths / rainbow_paths_per_thread(kMaxD))
rainbow_partials_kernel(int payoff, uint32_t k0, uint32_t k1, const float* __restrict__ params,
                        int d, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                        double* __restrict__ partials) {
  constexpr int P = rainbow_paths_per_thread(kMaxD);
  constexpr int T = kRainbowBlockPaths / P;
  static_assert(kRainbowBlockPaths % P == 0 && T >= 32 && (T & (T - 1)) == 0,
                "a block's threads are a power of two of at least a warp");
  static_assert(kMaxD < 32 || P == 1, "capacity 32 runs one path a thread");
  BasketParams<kMaxD> c;
  float* zs = nullptr;
  if constexpr (kMaxD == 32) {
    __shared__ float pack[kBasketPackMax];
    __shared__ float z_sh[32 * kRainbowBlockPaths];
    const int len = kBasketHead + 3 * d + d * (d + 1) / 2;
    for (int i = threadIdx.x; i < len; i += T) pack[i] = params[i];
    __syncthreads();
    c = load_basket<32>(pack, d);
    zs = z_sh + threadIdx.x;
  } else {
    c = load_basket<kMaxD>(params, d);
  }
  double acc[P][2];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p][0] = acc[p][1] = 0.0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kRainbowBlockPaths;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kRainbowBlockPaths + threadIdx.x;
       i < n_paths; i += stride) {
    uint32_t id[P];
#pragma unroll
    for (int p = 0; p < P; ++p) id[p] = path_offset + static_cast<uint32_t>(i + p * T);
    float pay[P];
    if constexpr (kMaxD == 32) {
      pay[0] = rainbow_path32<ROUNDS, A>(c, zs, payoff, k0, k1, id[0]);
    } else {
      rainbow_paths<kMaxD, P, ROUNDS, A>(c, payoff, k0, k1, id, pay);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float pv[1] = {pay[p]};
      // a lane past the last path adds zeros
      add_moments(acc[p], pv, i + p * T < n_paths && id[p] < bound);
    }
  }
#pragma unroll
  for (int h = P / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int p = 0; p < h; ++p) {
      acc[p][0] += acc[p + h][0];
      acc[p][1] += acc[p + h][1];
    }
  }
  block_store_moments_warp<2, T>(acc[0], partials + 2 * static_cast<size_t>(blockIdx.x));
}

template <int kMaxD, bool A>
cudaError_t launch_rainbow(int payoff, int rounds, uint32_t k0, uint32_t k1, const float* params,
                           int d, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                           double* partials, int n_blocks, cudaStream_t stream) {
  constexpr int T = kRainbowBlockPaths / rainbow_paths_per_thread(kMaxD);
  if (rounds == 13) {
    rainbow_partials_kernel<kMaxD, 13, A><<<n_blocks, T, 0, stream>>>(
        payoff, k0, k1, params, d, n_paths, path_offset, bound, partials);
  } else if (rounds == 20) {
    rainbow_partials_kernel<kMaxD, 20, A><<<n_blocks, T, 0, stream>>>(
        payoff, k0, k1, params, d, n_paths, path_offset, bound, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Each capacity's launcher (the plain or the antithetic kernel, threefry-13
// or -20) and its threefry-13 occupancy, defined in the capacity's source
// (MC_DEFINE_RAINBOW_PARTIALS).
#define MC_RAINBOW_ARGS                                                                    \
  int payoff, int rounds, int antithetic, uint32_t k0, uint32_t k1, const float *params, \
      int d, uint32_t n_paths, uint32_t path_offset, uint32_t bound, double *partials,    \
      int n_blocks, cudaStream_t stream

#define MC_DECLARE_RAINBOW_PARTIALS(CAP)                      \
  cudaError_t rainbow_partials_##CAP(MC_RAINBOW_ARGS);      \
  cudaError_t rainbow_occupancy_##CAP(int antithetic, int* blocks);

#define MC_DEFINE_RAINBOW_PARTIALS(CAP)                                                    \
  cudaError_t rainbow_partials_##CAP(MC_RAINBOW_ARGS) {                                   \
    return antithetic ? launch_rainbow<CAP, true>(payoff, rounds, k0, k1, params, d,      \
                                                  n_paths, path_offset, bound, partials,  \
                                                  n_blocks, stream)                       \
                      : launch_rainbow<CAP, false>(payoff, rounds, k0, k1, params, d,     \
                                                   n_paths, path_offset, bound, partials, \
                                                   n_blocks, stream);                     \
  }                                                                                       \
  cudaError_t rainbow_occupancy_##CAP(int antithetic, int* blocks) {                      \
    constexpr int T = kRainbowBlockPaths / rainbow_paths_per_thread(CAP);                 \
    return antithetic ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
                            blocks, rainbow_partials_kernel<CAP, 13, true>, T, 0)         \
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
                            blocks, rainbow_partials_kernel<CAP, 13, false>, T, 0);       \
  }

MC_DECLARE_RAINBOW_PARTIALS(4)
MC_DECLARE_RAINBOW_PARTIALS(8)
MC_DECLARE_RAINBOW_PARTIALS(16)
MC_DECLARE_RAINBOW_PARTIALS(32)

}  // namespace mc
