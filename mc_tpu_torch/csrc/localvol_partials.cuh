// The local-vol partials kernel (#19, replaces mc_tpu/models/localvol.py
// _localvol_partials, the Pallas call at :275), for sm_90a: its legs, the
// kernel and one launcher per knot capacity.  Each capacity's
// instantiations are in a source of their own (localvol_kernels.cu: the
// runtime-K kernel and the dispatch; localvol10_kernels.cu), so nvcc
// compiles them in parallel.
//
// A block sums kLocalVolTile = 256 paths, block b paths b*256 .. b*256+255,
// grid-strided, as the one-path-a-thread kernel it replaced did: its
// kLocalVolTile / P threads each run P of them in lockstep, thread t paths
// t, t + T, .. t + (P-1)T (T the block's threads), and each path's f64
// [pay, pay^2] sums in a lane of its own.  The lanes then add as the old
// block's tree added its threads t + pT (lane p and p + h at its level
// T*h), and the T threads' tree finishes (reduce.cuh): every row keeps its
// bits.
//
// Each path's f32 payoff is the one-path kernel's bit for bit: pair m of
// counter (id, m) feeds steps 2m and 2m+1, each step's sigma the K-1
// clamped ramps of surface row j added in k order (lv_sigma_at), the step
// and the update in lv_step's association.  An antithetic path's - leg is
// one more lockstep leg on the negated pair; the pair averages as
// 0.5*(a + b).  A surface row's level and slopes are read once for the
// thread's P*S legs.
//
// Knot capacity C (localvol_capacity): up to 10 knots (C = 10, the demo
// surface's 9 with one to spare) the knots x_k and widths dx_k sit in
// registers, loaded once a thread, and the ramp loop unrolls to C-1 with
// the ramps past K-1 skipped (a uniform branch).  Above 10 knots (C = 0)
// the ramp loop runs to the runtime K-1 and reads the knots with the row,
// once for the legs (lv_steps, localvol.cuh).  On the H100 (measured with
// family_nmc_probe.py --partials) capacity 10 ran K = 9 faster than 16 or
// runtime K; a capacity 32 gained 2-3% at K = 25 for a source of 46-61 s of
// nvcc.  The packed surface is read where it lies (every thread of a warp
// reads the same row: one broadcast load from L1).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "localvol.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kLocalVolTile = 256;

// The knot capacity that runs K (>= 2): 10, or 0 (runtime K): the one
// dispatch point is mc_localvol_partials (localvol_kernels.cu).
__host__ __device__ constexpr int localvol_capacity(int n_knots) {
  return n_knots <= 10 ? 10 : 0;
}

// Paths a thread, 4 lockstep legs either way (an antithetic path's two legs
// run as two of them): measured on the H100 against 1, 2 and 8.
__host__ __device__ constexpr int localvol_paths_per_thread(bool antithetic) {
  return antithetic ? 2 : 4;
}

// L legs through step j at capacity C: row j's level and slopes read once,
// each leg's ramps against the knots xr and widths dr held in registers,
// added in lv_sigma_at's k order; then lv_step's drift, diffusion, S and
// update.
template <class Payoff, int C, int L>
__device__ __forceinline__ void lv_steps_held(const LocalVolParams& l, const float (&xr)[C - 1],
                                              const float (&dr)[C - 1], int j,
                                              const float (&z)[L], float (&w)[L],
                                              float (&s)[L], typename Payoff::State (&st)[L]) {
  const int km1 = l.n_knots - 1;
  const float* v0 = l.v + kLvHead + 2 * l.n_knots - 1;
  const float* m = v0 + l.n_steps + static_cast<size_t>(j) * km1;
  float sg[L];
  const float level = v0[j];
#pragma unroll
  for (int i = 0; i < L; ++i) sg[i] = level;
#pragma unroll
  for (int k = 0; k < C - 1; ++k) {
    if (k < km1) {
      const float mk = m[k];
#pragma unroll
      for (int i = 0; i < L; ++i) sg[i] = sg[i] + mk * fminf(fmaxf(w[i] - xr[k], 0.0f), dr[k]);
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const float sgi = fmaxf(sg[i], 1e-4f);
    w[i] = (w[i] + (l.base_drift - ((0.5f * sgi) * sgi) * l.pay.dt)) + (sgi * l.sdt) * z[i];
    s[i] = l.pay.s0 * expf(w[i]);  // log-space: one exp rounding per S_t
    st[i] = Payoff::update(st[i], s[i], l.pay);
  }
}

// The knots and widths a thread holds at capacity C (the slots past K-1
// unused); at C = 0 none.
template <int C>
struct LvKnots {
  float x[C > 0 ? C - 1 : 1], dx[C > 0 ? C - 1 : 1];
};

// P paths (S = 2 legs each if antithetic) over n_steps: each path's payoff
// (the pair's mean).
template <class Payoff, int ROUNDS, int C, int P, bool A>
__device__ __forceinline__ void localvol_paths(const LocalVolParams& l, const LvKnots<C>& kn,
                                               uint32_t k0, uint32_t k1,
                                               const uint32_t (&id)[P], float (&pay)[P]) {
  constexpr int S = A ? 2 : 1;  // leg p*S + s: path p, + (s = 0) or - (s = 1)
  constexpr int L = P * S;
  float w[L], s[L];
  typename Payoff::State st[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    w[i] = 0.0f;
    s[i] = l.pay.s0;
    st[i] = Payoff::init(l.pay);
  }
  for (int m = 0; m < l.n_steps / 2; ++m) {
    float z0[L], z1[L];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      normal_pair<ROUNDS>(k0, k1, id[p], static_cast<uint32_t>(m), z0[p * S], z1[p * S]);
      if constexpr (A) {
        z0[p * S + 1] = -z0[p * S];
        z1[p * S + 1] = -z1[p * S];
      }
    }
    if constexpr (C > 0) {
      lv_steps_held<Payoff, C, L>(l, kn.x, kn.dx, 2 * m, z0, w, s, st);
      lv_steps_held<Payoff, C, L>(l, kn.x, kn.dx, 2 * m + 1, z1, w, s, st);
    } else {
      lv_steps<Payoff, L>(l, 2 * m, z0, w, s, st);
      lv_steps<Payoff, L>(l, 2 * m + 1, z1, w, s, st);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    pay[p] = Payoff::terminal(st[p * S], s[p * S], l.pay);
    if constexpr (A)
      pay[p] = 0.5f * (pay[p] + Payoff::terminal(st[p * S + 1], s[p * S + 1], l.pay));
  }
}

// The partials kernel: block b sums paths b*kLocalVolTile + .., grid-strided,
// P a thread; paths at or past `bound` add zeros; one f64 row [sum pay, sum
// pay^2] a block.
template <class Payoff, int ROUNDS, int C, bool A>
__global__ void __launch_bounds__(kLocalVolTile / localvol_paths_per_thread(A))
localvol_partials_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params,
                         int n_knots, int n_steps, uint32_t n_paths, uint32_t path_offset,
                         uint32_t bound, double* __restrict__ partials) {
  constexpr int P = localvol_paths_per_thread(A);
  constexpr int T = kLocalVolTile / P;
  const LocalVolParams l = load_localvol(params, n_knots, n_steps);
  LvKnots<C> kn;
  if constexpr (C > 0) {
#pragma unroll
    for (int k = 0; k < C - 1; ++k) {
      kn.x[k] = k < n_knots - 1 ? l.v[kLvHead + k] : 0.0f;
      kn.dx[k] = k < n_knots - 1 ? l.v[kLvHead + n_knots + k] : 0.0f;
    }
  }
  double acc[P][2];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p][0] = acc[p][1] = 0.0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kLocalVolTile;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kLocalVolTile + threadIdx.x;
       i < n_paths; i += stride) {
    uint32_t id[P];
#pragma unroll
    for (int p = 0; p < P; ++p) id[p] = path_offset + static_cast<uint32_t>(i + p * T);
    float pay[P];
    localvol_paths<Payoff, ROUNDS, C, P, A>(l, kn, k0, k1, id, pay);
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

template <class Payoff, int ROUNDS, int C, bool A>
cudaError_t launch_localvol_partials(uint32_t k0, uint32_t k1, const float* params, int n_knots,
                                     int n_steps, uint32_t n_paths, uint32_t path_offset,
                                     uint32_t bound, double* partials, int n_blocks,
                                     cudaStream_t stream) {
  localvol_partials_kernel<Payoff, ROUNDS, C, A>
      <<<n_blocks, kLocalVolTile / localvol_paths_per_thread(A), 0, stream>>>(
          k0, k1, params, n_knots, n_steps, n_paths, path_offset, bound, partials);
  return cudaGetLastError();
}

template <class Payoff, int C>
cudaError_t localvol_launch_rounds(int rounds, int antithetic, uint32_t k0, uint32_t k1,
                                   const float* params, int n_knots, int n_steps,
                                   uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                   double* partials, int n_blocks, cudaStream_t stream) {
#define MC_LV_LAUNCH(R, A)                                                               \
  return launch_localvol_partials<Payoff, R, C, A>(k0, k1, params, n_knots, n_steps,    \
                                                   n_paths, path_offset, bound, partials, \
                                                   n_blocks, stream)
  if (rounds == 13) {
    if (antithetic) MC_LV_LAUNCH(13, true);
    MC_LV_LAUNCH(13, false);
  }
  if (rounds == 20) {
    if (antithetic) MC_LV_LAUNCH(20, true);
    MC_LV_LAUNCH(20, false);
  }
#undef MC_LV_LAUNCH
  return cudaErrorInvalidValue;
}

template <int C>
cudaError_t localvol_partials_switch(int payoff_id, int rounds, int antithetic, uint32_t k0,
                                     uint32_t k1, const float* params, int n_knots, int n_steps,
                                     uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                     double* partials, int n_blocks, cudaStream_t stream) {
#define MC_CASE(ID, PAYOFF)                                                                  \
  case ID:                                                                                   \
    return localvol_launch_rounds<PAYOFF, C>(rounds, antithetic, k0, k1, params, n_knots,  \
                                             n_steps, n_paths, path_offset, bound, partials, \
                                             n_blocks, stream);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

// The VanillaCall threefry-13 kernel's resident blocks per SM at capacity C.
template <int C>
cudaError_t localvol_partials_occupancy(int antithetic, int* blocks) {
  return antithetic ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, localvol_partials_kernel<VanillaCall, 13, C, true>,
                          kLocalVolTile / localvol_paths_per_thread(true), 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, localvol_partials_kernel<VanillaCall, 13, C, false>,
                          kLocalVolTile / localvol_paths_per_thread(false), 0);
}

// Each capacity's launcher (every payoff, both rounds) and its occupancy,
// defined in the capacity's source (MC_DEFINE_LOCALVOL_PARTIALS).
#define MC_LOCALVOL_PARTIALS_ARGS                                                            \
  int payoff_id, int rounds, int antithetic, uint32_t k0, uint32_t k1, const float *params, \
      int n_knots, int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,     \
      double *partials, int n_blocks, cudaStream_t stream

#define MC_DECLARE_LOCALVOL_PARTIALS(CAP)                                   \
  cudaError_t localvol_partials_##CAP(MC_LOCALVOL_PARTIALS_ARGS);           \
  cudaError_t localvol_occupancy_##CAP(int antithetic, int* blocks);

#define MC_DEFINE_LOCALVOL_PARTIALS(CAP)                                                    \
  cudaError_t localvol_partials_##CAP(MC_LOCALVOL_PARTIALS_ARGS) {                         \
    return localvol_partials_switch<CAP>(payoff_id, rounds, antithetic, k0, k1, params,    \
                                         n_knots, n_steps, n_paths, path_offset, bound,    \
                                         partials, n_blocks, stream);                      \
  }                                                                                        \
  cudaError_t localvol_occupancy_##CAP(int antithetic, int* blocks) {                     \
    return localvol_partials_occupancy<CAP>(antithetic, blocks);                           \
  }

MC_DECLARE_LOCALVOL_PARTIALS(0)
MC_DECLARE_LOCALVOL_PARTIALS(10)

}  // namespace mc
