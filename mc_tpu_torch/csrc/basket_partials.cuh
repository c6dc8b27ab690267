// The basket's partials kernel (#25, replaces mc_tpu/models/basket.py
// _basket_partials, the Pallas call at :277) and trajectories kernel (#26,
// replaces basket_trajectories_kernel, mc_tpu/models/basket.py:393, the
// Pallas call at :409), for sm_90a: their legs, the kernels and one
// launcher of each per capacity.  Each capacity's instantiations are in a
// source of their own (basket_kernels.cu: 4 and the dispatch;
// basket8_kernels.cu, basket16_kernels.cu, basket32_kernels.cu), so nvcc
// compiles them in parallel.
//
// A block sums kBasketTile = 256 paths, block b paths b*256 .. b*256+255,
// grid-strided, as the one-path-a-thread kernels it replaced did: its
// kBasketTile / P threads each run P of them in lockstep, thread t paths
// t, t + T, .. t + (P-1)T (T the block's threads), and each path's f64
// [pay, pay^2] sums in a lane of its own.  The lanes then add as the old
// block's tree added its threads t + pT (lane p and p + h at its level T*h),
// and the T threads' tree finishes (reduce.cuh): every row keeps its bits.
// The trajectories kernel stores each lane's basket level and payoff state
// word 0 after every step at its own path's entry j*n_paths + i, so a
// warp's stores of a step stay coalesced.
//
// Each path's f32 payoff and levels are the one-path leg's (basket.cuh
// basket_draw, basket_mix and basket_level in turn) bit for bit: the same
// normals (pair q of counter j*ceil(d/2) + q), the mix in k order, the
// increments, the levels and the weighted sum in i order.  The antithetic path runs its two legs in lockstep on one draw:
// the negated normals' mix is the mix negated, bit for bit (round to nearest
// is symmetric), so the - leg takes (w + drift) - sqrt_dt*y where the + leg
// adds it, and the pair still averages as 0.5*(a + b).
//
// Capacity kMaxD of d (basket_capacity: 4, 8, 16, 32): up to 16 the loops
// over assets unroll to the capacity, the arrays live in registers and the
// Cholesky rows, drifts, s0s and weights are uniform loads read once for
// the thread's P paths.  At 32 a thread runs one path, its log-moneyness
// in registers, its normals and the pack staged in shared memory, the mix
// by blocks of 8 rows (a block past d skipped), so neither array falls to
// local memory.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "basket.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kBasketTile = 256;
// The packed vector's length at d = 32 (models/basket.py packed_length).
constexpr int kBasketPackMax = kBasketHead + 3 * 32 + 32 * 33 / 2;

// The capacity that runs d (1..32): the one dispatch point
// (mc_basket_partials, basket_kernels.cu).
__host__ __device__ constexpr int basket_capacity(int d) {
  return d <= 4 ? 4 : d <= 8 ? 8 : d <= 16 ? 16 : 32;
}

// Paths a thread at capacity kMaxD (an antithetic path's two legs run as
// one): the kernel's own choice, measured on the H100.  Only
// family_nmc_probe.py's sweeps define MC_BASKET_PATHS (every capacity up to
// 16).  Capacity 32 runs one.
__host__ __device__ constexpr int basket_paths_per_thread(int kMaxD) {
#ifdef MC_BASKET_PATHS
  return kMaxD == 32 ? 1 : MC_BASKET_PATHS;
#else
  return kMaxD <= 4 ? 2 : 1;
#endif
}

// Paths a thread of the trajectories kernel at capacity kMaxD: on the
// H100 (family_nmc_probe.py --basket, PERF.md) the call at 100,000 x 100,
// d = 4, took 0.188 / 0.176 / 0.295 ms at 1, 2 and 4.  Capacities 8 and 16
// run one, as the partials kernel chose (4 there spilled and ran 1.8-2.5x
// slower at d = 9 and 16), and capacity 32 one.
__host__ __device__ constexpr int basket_grid_paths_per_thread(int kMaxD) {
  return kMaxD <= 4 ? 2 : 1;
}

// A leg's step callback that does nothing: the partials kernel's.
struct NoStep {
  template <class... Args>
  __device__ void operator()(const Args&...) const {}
};

// P paths (S = 2 legs each if antithetic) over n_steps at capacity kMaxD <=
// 16: each path's payoff (the pair's mean); on_step(j, b, st) sees the legs'
// levels and payoff states after each step j.
template <class Payoff, int kMaxD, int P, bool A, class OnStep = NoStep>
__device__ __forceinline__ void basket_paths(const BasketParams<kMaxD>& c, uint32_t k0,
                                             uint32_t k1, const uint32_t (&id)[P], int n_steps,
                                             float (&pay)[P], OnStep on_step = {}) {
  constexpr int S = A ? 2 : 1;  // leg p*S + s: path p, + (s = 0) or - (s = 1)
  float ws[P * S][kMaxD], z[P][kMaxD], b[P * S];
  typename Payoff::State st[P * S];
#pragma unroll
  for (int l = 0; l < P * S; ++l) {
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) ws[l][i] = 0.0f;
    st[l] = Payoff::init(c.pay);
    b[l] = c.pay.s0;
  }
  for (int j = 0; j < n_steps; ++j) {
    const uint32_t base = static_cast<uint32_t>(j) * static_cast<uint32_t>(c.npps);
#pragma unroll
    for (int p = 0; p < P; ++p) basket_draw(c, k0, k1, id[p], base, 1.0f, z[p]);
    // the mix: y_i = L_i0 z_0 + L_i1 z_1 + ... in k order; w_i = (w_i +
    // drift_i) + sqrt_dt y_i (the - leg: - sqrt_dt y_i)
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      if (i < c.d) {
        const float* row = c.chol + i * (i + 1) / 2;
        const float r0 = __ldg(row);
        float y[P];
#pragma unroll
        for (int p = 0; p < P; ++p) y[p] = r0 * z[p][0];
#pragma unroll
        for (int k = 1; k <= i; ++k) {
          const float rk = __ldg(row + k);
#pragma unroll
          for (int p = 0; p < P; ++p) y[p] = y[p] + rk * z[p][k];
        }
        const float drift = __ldg(c.drift + i);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float t = c.sqrt_dt * y[p];
          ws[p * S][i] = (ws[p * S][i] + drift) + t;
          if constexpr (A) ws[p * S + 1][i] = (ws[p * S + 1][i] + drift) - t;
        }
      }
    }
    // basket_levels' sum through __ldg: with its plain loads ptxas held
    // capacity 8 to 48 registers and d = 8 ran 20% slower on the H100
#pragma unroll
    for (int i = 0; i < kMaxD; ++i) {
      if (i < c.d) {
        const float s0 = __ldg(c.s0s + i), wi = __ldg(c.w + i);
#pragma unroll
        for (int l = 0; l < P * S; ++l) {
          const float term = wi * (s0 * expf(ws[l][i]));
          b[l] = i == 0 ? term : b[l] + term;
        }
      }
    }
#pragma unroll
    for (int l = 0; l < P * S; ++l) st[l] = Payoff::update(st[l], b[l], c.pay);
    on_step(j, b, st);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    pay[p] = Payoff::terminal(st[p * S], b[p * S], c.pay);
    if constexpr (A)
      pay[p] = 0.5f * (pay[p] + Payoff::terminal(st[p * S + 1], b[p * S + 1], c.pay));
  }
}

// One path (both legs if antithetic) over n_steps at capacity 32, the pack
// c and the thread's normals (z_k at zs[k * kBasketTile]) in shared memory.
// The mix runs by blocks of 8 rows, y of the block in registers: the
// columns below the block's diagonal a loop, the diagonal's 8 unrolled.
// on_step(j, b, st) sees the legs' levels and states after each step j.
template <class Payoff, bool A, class OnStep = NoStep>
__device__ __forceinline__ float basket_path32(const BasketParams<32>& c, float* zs,
                                               uint32_t k0, uint32_t k1, uint32_t id,
                                               int n_steps, OnStep on_step = {}) {
  constexpr int S = A ? 2 : 1;
  float ws[S][32], b[S];
  typename Payoff::State st[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < 32; ++i) ws[s][i] = 0.0f;
    st[s] = Payoff::init(c.pay);
    b[s] = c.pay.s0;
  }
  for (int j = 0; j < n_steps; ++j) {
    const uint32_t base = static_cast<uint32_t>(j) * static_cast<uint32_t>(c.npps);
    for (int q = 0; q < c.npps; ++q) {
      normal_pair<13>(k0, k1, id, base + static_cast<uint32_t>(q), zs[2 * q * kBasketTile],
                      zs[(2 * q + 1) * kBasketTile]);
    }
#pragma unroll
    for (int lo = 0; lo < 32; lo += 8) {
      if (lo < c.d) {
        float y[8];
        const float z0 = zs[0];
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = c.chol[(lo + i) * (lo + i + 1) / 2] * z0;
        for (int k = 1; k < lo; ++k) {
          const float zk = zs[k * kBasketTile];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            y[i] = y[i] + c.chol[(lo + i) * (lo + i + 1) / 2 + k] * zk;
        }
#pragma unroll
        for (int k = lo > 0 ? lo : 1; k < lo + 8; ++k) {
          if (k < c.d) {
            const float zk = zs[k * kBasketTile];
#pragma unroll
            for (int i = k - lo; i < 8; ++i)
              y[i] = y[i] + c.chol[(lo + i) * (lo + i + 1) / 2 + k] * zk;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (lo + i < c.d) {
            const float t = c.sqrt_dt * y[i];
            const float drift = c.drift[lo + i];
            ws[0][lo + i] = (ws[0][lo + i] + drift) + t;
            if constexpr (A) ws[1][lo + i] = (ws[1][lo + i] + drift) - t;
          }
        }
      }
    }
    // basket_levels' sum, unrolled so ws stays in registers
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i < c.d) {
        const float s0 = c.s0s[i], wi = c.w[i];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float term = wi * (s0 * expf(ws[s][i]));
          b[s] = i == 0 ? term : b[s] + term;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) st[s] = Payoff::update(st[s], b[s], c.pay);
    on_step(j, b, st);
  }
  float pay = Payoff::terminal(st[0], b[0], c.pay);
  if constexpr (A) pay = 0.5f * (pay + Payoff::terminal(st[1], b[1], c.pay));
  return pay;
}

// The partials kernel: block b sums paths b*kBasketTile + .., grid-strided,
// P a thread; paths at or past `bound` add zeros; one f64 row [sum pay, sum
// pay^2] a block.
template <class Payoff, int kMaxD, bool A>
__global__ void __launch_bounds__(kBasketTile / basket_paths_per_thread(kMaxD))
basket_partials_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params, int d,
                       int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                       double* __restrict__ partials) {
  constexpr int P = basket_paths_per_thread(kMaxD);
  constexpr int T = kBasketTile / P;
  static_assert(kMaxD < 32 || P == 1, "capacity 32 runs one path a thread");
  BasketParams<kMaxD> c;
  float* zs = nullptr;
  if constexpr (kMaxD == 32) {
    __shared__ float pack[kBasketPackMax];
    __shared__ float z_sh[32 * kBasketTile];
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
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kBasketTile;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kBasketTile + threadIdx.x; i < n_paths;
       i += stride) {
    uint32_t id[P];
#pragma unroll
    for (int p = 0; p < P; ++p) id[p] = path_offset + static_cast<uint32_t>(i + p * T);
    float pay[P];
    if constexpr (kMaxD == 32) {
      pay[0] = basket_path32<Payoff, A>(c, zs, k0, k1, id[0], n_steps);
    } else {
      basket_paths<Payoff, kMaxD, P, A>(c, k0, k1, id, n_steps, pay);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float pv[1] = {pay[p]};
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
  block_store_moments<2, T>(acc[0], partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Payoff, int kMaxD>
cudaError_t launch_basket_partials(int antithetic, uint32_t k0, uint32_t k1, const float* params,
                                   int d, int n_steps, uint32_t n_paths, uint32_t path_offset,
                                   uint32_t bound, double* partials, int n_blocks,
                                   cudaStream_t stream) {
  if (antithetic) {
    basket_partials_kernel<Payoff, kMaxD, true>
        <<<n_blocks, kBasketTile / basket_paths_per_thread(kMaxD), 0, stream>>>(
            k0, k1, params, d, n_steps, n_paths, path_offset, bound, partials);
  } else {
    basket_partials_kernel<Payoff, kMaxD, false>
        <<<n_blocks, kBasketTile / basket_paths_per_thread(kMaxD), 0, stream>>>(
            k0, k1, params, d, n_steps, n_paths, path_offset, bound, partials);
  }
  return cudaGetLastError();
}

template <class Payoff, int kMaxD>
cudaError_t basket_partials_occupancy(int antithetic, int* blocks) {
  return antithetic ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, basket_partials_kernel<Payoff, kMaxD, true>,
                          kBasketTile / basket_paths_per_thread(kMaxD), 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, basket_partials_kernel<Payoff, kMaxD, false>,
                          kBasketTile / basket_paths_per_thread(kMaxD), 0);
}

template <int kMaxD>
cudaError_t basket_partials_switch(int payoff_id, int antithetic, uint32_t k0, uint32_t k1,
                                   const float* params, int d, int n_steps, uint32_t n_paths,
                                   uint32_t path_offset, uint32_t bound, double* partials,
                                   int n_blocks, cudaStream_t stream) {
#define MC_CASE(ID, PAYOFF)                                                                 \
  case ID:                                                                                  \
    return launch_basket_partials<PAYOFF, kMaxD>(antithetic, k0, k1, params, d, n_steps,   \
                                                 n_paths, path_offset, bound, partials,    \
                                                 n_blocks, stream);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

// The trajectories kernel: the partials kernel's paths and rows (no
// antithetic twin), each lane storing its path's basket level and payoff
// state word 0 after every step j at entry j*n_paths + i of the step-major
// grids (a lane past the last path stores nothing).
template <class Payoff, int kMaxD>
__global__ void __launch_bounds__(kBasketTile / basket_grid_paths_per_thread(kMaxD))
basket_trajectories_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params, int d,
                           int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                           float* __restrict__ b_grid, float* __restrict__ state_grid,
                           double* __restrict__ partials) {
  constexpr int P = basket_grid_paths_per_thread(kMaxD);
  constexpr int T = kBasketTile / P;
  static_assert(kMaxD < 32 || P == 1, "capacity 32 runs one path a thread");
  BasketParams<kMaxD> c;
  float* zs = nullptr;
  if constexpr (kMaxD == 32) {
    __shared__ float pack[kBasketPackMax];
    __shared__ float z_sh[32 * kBasketTile];
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
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kBasketTile;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kBasketTile + threadIdx.x; i < n_paths;
       i += stride) {
    uint32_t id[P];
#pragma unroll
    for (int p = 0; p < P; ++p) id[p] = path_offset + static_cast<uint32_t>(i + p * T);
    const auto store = [&](int j, const float (&b)[P], const typename Payoff::State (&st)[P]) {
      const size_t row = static_cast<size_t>(j) * n_paths + i;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (i + p * T < n_paths) {
          b_grid[row + p * T] = b[p];
          state_grid[row + p * T] = Payoff::kStates ? st[p].w[0] : 0.0f;
        }
      }
    };
    float pay[P];
    if constexpr (kMaxD == 32) {
      pay[0] = basket_path32<Payoff, false>(c, zs, k0, k1, id[0], n_steps, store);
    } else {
      basket_paths<Payoff, kMaxD, P, false>(c, k0, k1, id, n_steps, pay, store);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float pv[1] = {pay[p]};
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
  block_store_moments<2, T>(acc[0], partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <int kMaxD>
cudaError_t basket_trajectories_switch(int payoff_id, uint32_t k0, uint32_t k1,
                                       const float* params, int d, int n_steps, uint32_t n_paths,
                                       uint32_t path_offset, uint32_t bound, float* b_grid,
                                       float* state_grid, double* partials, int n_blocks,
                                       cudaStream_t stream) {
  constexpr int T = kBasketTile / basket_grid_paths_per_thread(kMaxD);
#define MC_CASE(ID, PAYOFF)                                                              \
  case ID:                                                                               \
    basket_trajectories_kernel<PAYOFF, kMaxD><<<n_blocks, T, 0, stream>>>(               \
        k0, k1, params, d, n_steps, n_paths, path_offset, bound, b_grid, state_grid,     \
        partials);                                                                       \
    return cudaGetLastError();
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)  // the grid stores one state word
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

template <int kMaxD>
cudaError_t basket_trajectories_occupancy(int payoff_id, int* blocks) {
  constexpr int T = kBasketTile / basket_grid_paths_per_thread(kMaxD);
#define MC_CASE(ID, PAYOFF) \
  case ID:                  \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(            \
        blocks, basket_trajectories_kernel<PAYOFF, kMaxD>, T, 0);
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

// Each capacity's launcher (every payoff) and its VanillaCall occupancy,
// defined in the capacity's source (MC_DEFINE_BASKET_PARTIALS); the
// trajectories kernel's launcher and occupancy (every one-word payoff),
// likewise (MC_DEFINE_BASKET_TRAJECTORIES).
#define MC_BASKET_PARTIALS_ARGS                                                        \
  int payoff_id, int antithetic, uint32_t k0, uint32_t k1, const float *params, int d, \
      int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,             \
      double *partials, int n_blocks, cudaStream_t stream

#define MC_DECLARE_BASKET_PARTIALS(CAP)                                  \
  cudaError_t basket_partials_##CAP(MC_BASKET_PARTIALS_ARGS);           \
  cudaError_t basket_occupancy_##CAP(int antithetic, int* blocks);

#define MC_DEFINE_BASKET_PARTIALS(CAP)                                               \
  cudaError_t basket_partials_##CAP(MC_BASKET_PARTIALS_ARGS) {                      \
    return basket_partials_switch<CAP>(payoff_id, antithetic, k0, k1, params, d,    \
                                       n_steps, n_paths, path_offset, bound,        \
                                       partials, n_blocks, stream);                 \
  }                                                                                 \
  cudaError_t basket_occupancy_##CAP(int antithetic, int* blocks) {                 \
    return basket_partials_occupancy<VanillaCall, CAP>(antithetic, blocks);         \
  }

#define MC_BASKET_TRAJECTORIES_ARGS                                                     \
  int payoff_id, uint32_t k0, uint32_t k1, const float *params, int d, int n_steps,   \
      uint32_t n_paths, uint32_t path_offset, uint32_t bound, float *b_grid,          \
      float *state_grid, double *partials, int n_blocks, cudaStream_t stream

#define MC_DECLARE_BASKET_TRAJECTORIES(CAP)                                    \
  cudaError_t basket_trajectories_##CAP(MC_BASKET_TRAJECTORIES_ARGS);         \
  cudaError_t basket_trajectories_occupancy_##CAP(int payoff_id, int* blocks);

#define MC_DEFINE_BASKET_TRAJECTORIES(CAP)                                               \
  cudaError_t basket_trajectories_##CAP(MC_BASKET_TRAJECTORIES_ARGS) {                  \
    return basket_trajectories_switch<CAP>(payoff_id, k0, k1, params, d, n_steps,       \
                                           n_paths, path_offset, bound, b_grid,         \
                                           state_grid, partials, n_blocks, stream);     \
  }                                                                                     \
  cudaError_t basket_trajectories_occupancy_##CAP(int payoff_id, int* blocks) {         \
    return basket_trajectories_occupancy<CAP>(payoff_id, blocks);                       \
  }

MC_DECLARE_BASKET_PARTIALS(4)
MC_DECLARE_BASKET_PARTIALS(8)
MC_DECLARE_BASKET_PARTIALS(16)
MC_DECLARE_BASKET_PARTIALS(32)
MC_DECLARE_BASKET_TRAJECTORIES(4)
MC_DECLARE_BASKET_TRAJECTORIES(8)
MC_DECLARE_BASKET_TRAJECTORIES(16)
MC_DECLARE_BASKET_TRAJECTORIES(32)

}  // namespace mc
