// The SABR partials kernel (#17, replaces mc_tpu/models/sabr.py
// _sabr_partials, the Pallas call at :188), for sm_90a: its legs, the
// kernel and one launcher per beta class.  The general-beta instantiations
// are in sabr_kernels.cu beside the dispatch, the unit-beta ones in
// sabr1_kernels.cu, so nvcc compiles them in parallel.
//
// A block sums kSabrTile = 256 paths, block b paths b*256 .. b*256+255,
// grid-strided, as the one-path-a-thread kernel it replaced did: its
// kSabrTile / P threads each run P of them in lockstep, thread t paths t,
// t + T, .. t + (P-1)T (T the block's threads), and each path's f64 [pay,
// pay^2] sums in a lane of its own.  The lanes then add as the old block's
// tree added its threads t + pT (lane p and p + h at its level T*h), and the
// T threads' tree finishes (reduce.cuh): every row keeps its bits.  An
// antithetic path's - leg is one more lockstep leg on the negated pair.
//
// Each path's f32 payoff is the one-path kernel's bit for bit: step j draws
// the pair (id, j) -> (z_vol, z_perp), sabr_step's arithmetic in its
// association, the pair's mean 0.5*(a + b).  Two things the old step
// computed and did not need are gone:
// - at beta = 1 exactly (the demo dynamics; the wrapper reads the packed
//   beta), (beta-1)*lf is +-0 for a finite lf, expf(+-0) is 1 and sig*1 is
//   sig: the unit-beta step takes vol_loc = sig there, and NaN where lf is
//   +-inf or NaN (0*inf is NaN), without the expf;
// - the forward F = expf(lf) is formed only where the payoff reads it
//   (StateRead, barrier.cuh): at each step for a kSpot payoff, at the end
//   for the others; a kBarrier payoff (the bullet, the up-and-out and the
//   down-and-in calls) tests lf <= below_max_all(1, barrier), which thread
//   0 finds once a block.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "barrier.cuh"
#include "heston.cuh"  // MC_HESTON_PAYOFFS: every payoff but the two that read sigma
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"
#include "sabr.cuh"

namespace mc {

constexpr int kSabrTile = 256;

// Paths a thread in lockstep (an antithetic path's two legs each): on the
// H100 (family_nmc_probe.py --sabr, PERF.md) the call at 1M x 100 took
// 0.560 / 0.551 / 0.564 ms at 1 / 2 / 4 paths, antithetic 0.680 / 0.663 at
// 1 / 2.
constexpr int kSabrPaths = 2;

// One SABR step of a leg (sabr_step, without the local vol's expf at beta
// = 1), and its payoff state: F = expf(lf) into update where the payoff
// reads it, or the barrier test on lf.
template <class Payoff, bool kUnitBeta>
__device__ __forceinline__ void sabr_leg_step(const SABRParams& c, float below_max, float z_vol,
                                              float z_perp, float& lf, float& sig,
                                              typename Payoff::State& st) {
  sabr_step<kUnitBeta>(c, z_vol, z_perp, lf, sig);
  if constexpr (kStateRead<Payoff> == StateRead::kSpot) {
    st = Payoff::update(st, expf(lf), c.pay);
  } else if constexpr (kStateRead<Payoff> == StateRead::kBarrier) {
    st = Payoff::update_below(st, lf <= below_max, c.pay);
  }
}

// P paths (S = 2 legs each if antithetic) over n_steps from log(f0) and
// alpha: each path's payoff (the pair's mean).
template <class Payoff, int ROUNDS, bool kUnitBeta, int P, bool A>
__device__ __forceinline__ void sabr_paths(const SABRParams& c, float below_max, uint32_t k0,
                                           uint32_t k1, const uint32_t (&id)[P], int n_steps,
                                           float (&pay)[P]) {
  constexpr int S = A ? 2 : 1;  // leg p*S + s: path p, + (s = 0) or - (s = 1)
  constexpr int L = P * S;
  const float logf0 = logf(c.f0);
  float lf[L], sig[L];
  typename Payoff::State st[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    lf[l] = logf0;
    sig[l] = c.alpha;
    st[l] = Payoff::init(c.pay);
  }
  for (int j = 0; j < n_steps; ++j) {
    float z_vol[L], z_perp[L];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      normal_pair<ROUNDS>(k0, k1, id[p], static_cast<uint32_t>(j), z_vol[p * S],
                          z_perp[p * S]);
      if constexpr (A) {
        z_vol[p * S + 1] = -z_vol[p * S];
        z_perp[p * S + 1] = -z_perp[p * S];
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      sabr_leg_step<Payoff, kUnitBeta>(c, below_max, z_vol[l], z_perp[l], lf[l], sig[l], st[l]);
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    pay[p] = Payoff::terminal(st[p * S], expf(lf[p * S]), c.pay);
    if constexpr (A) {
      pay[p] = 0.5f * (pay[p] + Payoff::terminal(st[p * S + 1], expf(lf[p * S + 1]), c.pay));
    }
  }
}

// The partials kernel: block b sums paths b*kSabrTile + .., grid-strided,
// P a thread; paths at or past `bound` add zeros; one f64 row [sum pay, sum
// pay^2] a block.
template <class Payoff, int ROUNDS, bool kUnitBeta, bool A>
__global__ void __launch_bounds__(kSabrTile / kSabrPaths)
sabr_partials_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params, int n_steps,
                     uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                     double* __restrict__ partials) {
  constexpr int P = kSabrPaths;
  constexpr int T = kSabrTile / P;
  const SABRParams c = load_sabr(params);
  float below_max = 0.0f;
  if constexpr (kStateRead<Payoff> == StateRead::kBarrier) {
    __shared__ float below_max_s;
    if (threadIdx.x == 0) below_max_s = below_max_all(1.0f, c.pay.barrier);
    __syncthreads();
    below_max = below_max_s;
  }
  double acc[P][2];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p][0] = acc[p][1] = 0.0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kSabrTile;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kSabrTile + threadIdx.x; i < n_paths;
       i += stride) {
    uint32_t id[P];
#pragma unroll
    for (int p = 0; p < P; ++p) id[p] = path_offset + static_cast<uint32_t>(i + p * T);
    float pay[P];
    sabr_paths<Payoff, ROUNDS, kUnitBeta, P, A>(c, below_max, k0, k1, id, n_steps, pay);
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

template <class Payoff, int ROUNDS, bool kUnitBeta, bool A>
cudaError_t launch_sabr_partials(uint32_t k0, uint32_t k1, const float* params, int n_steps,
                                 uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                 double* partials, int n_blocks, cudaStream_t stream) {
  sabr_partials_kernel<Payoff, ROUNDS, kUnitBeta, A>
      <<<n_blocks, kSabrTile / kSabrPaths, 0, stream>>>(
          k0, k1, params, n_steps, n_paths, path_offset, bound, partials);
  return cudaGetLastError();
}

template <class Payoff, bool kUnitBeta>
cudaError_t sabr_launch_rounds(int rounds, int antithetic, uint32_t k0, uint32_t k1,
                               const float* params, int n_steps, uint32_t n_paths,
                               uint32_t path_offset, uint32_t bound, double* partials,
                               int n_blocks, cudaStream_t stream) {
#define MC_SABR_LAUNCH(R, A)                                                               \
  return launch_sabr_partials<Payoff, R, kUnitBeta, A>(k0, k1, params, n_steps, n_paths,  \
                                                       path_offset, bound, partials,      \
                                                       n_blocks, stream)
  if (rounds == 13) {
    if (antithetic) MC_SABR_LAUNCH(13, true);
    MC_SABR_LAUNCH(13, false);
  }
  if (rounds == 20) {
    if (antithetic) MC_SABR_LAUNCH(20, true);
    MC_SABR_LAUNCH(20, false);
  }
#undef MC_SABR_LAUNCH
  return cudaErrorInvalidValue;
}

template <bool kUnitBeta>
cudaError_t sabr_partials_switch(int payoff_id, int rounds, int antithetic, uint32_t k0,
                                 uint32_t k1, const float* params, int n_steps,
                                 uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                 double* partials, int n_blocks, cudaStream_t stream) {
#define MC_CASE(ID, PAYOFF)                                                                 \
  case ID:                                                                                  \
    return sabr_launch_rounds<PAYOFF, kUnitBeta>(rounds, antithetic, k0, k1, params,       \
                                                 n_steps, n_paths, path_offset, bound,     \
                                                 partials, n_blocks, stream);
  switch (payoff_id) {
    MC_HESTON_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;  // the bridge barriers read sigma
  }
#undef MC_CASE
}

// The VanillaCall threefry-13 kernel's resident blocks per SM.
template <bool kUnitBeta>
cudaError_t sabr_partials_occupancy(int antithetic, int* blocks) {
  return antithetic ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, sabr_partials_kernel<VanillaCall, 13, kUnitBeta, true>,
                          kSabrTile / kSabrPaths, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, sabr_partials_kernel<VanillaCall, 13, kUnitBeta, false>,
                          kSabrTile / kSabrPaths, 0);
}

// Each beta class's launcher (every payoff, both rounds) and its occupancy,
// defined in the class's source (MC_DEFINE_SABR_PARTIALS).
#define MC_SABR_PARTIALS_ARGS                                                           \
  int payoff_id, int rounds, int antithetic, uint32_t k0, uint32_t k1,                  \
      const float *params, int n_steps, uint32_t n_paths, uint32_t path_offset,         \
      uint32_t bound, double *partials, int n_blocks, cudaStream_t stream

#define MC_DECLARE_SABR_PARTIALS(NAME)                          \
  cudaError_t sabr_partials_##NAME(MC_SABR_PARTIALS_ARGS);      \
  cudaError_t sabr_occupancy_##NAME(int antithetic, int* blocks);

#define MC_DEFINE_SABR_PARTIALS(NAME, UNIT)                                                \
  cudaError_t sabr_partials_##NAME(MC_SABR_PARTIALS_ARGS) {                                \
    return sabr_partials_switch<UNIT>(payoff_id, rounds, antithetic, k0, k1, params,      \
                                      n_steps, n_paths, path_offset, bound, partials,     \
                                      n_blocks, stream);                                  \
  }                                                                                        \
  cudaError_t sabr_occupancy_##NAME(int antithetic, int* blocks) {                        \
    return sabr_partials_occupancy<UNIT>(antithetic, blocks);                             \
  }

MC_DECLARE_SABR_PARTIALS(general)
MC_DECLARE_SABR_PARTIALS(unit_beta)

}  // namespace mc
