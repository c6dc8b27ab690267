// The pathwise-greek kernel, kernel 8 of the port, for sm_90a.
//
// greek_kernel replaces mc_tpu/ops/path_kernels.py simulate_greek_partials
// (the Pallas call at :941): one pass that prices a path and carries the
// forward-mode tangents of its payoff with respect to (s0, sigma, r, q),
// and writes per block the f64 sums and sums of squares of
//   (pay, delta, vega, rho' = d pay/dr - T pay, epsilon),
// ten moments, for greeks(method="pathwise").  Its leg is simulate_kernel's
// (simulate.cuh): the exact terminal draw (the head of pair 0) or the
// log-Euler loop over the same threefry stream and draw schedule, so pay is
// bitwise simulate's pay.  The spot's tangents are closed-form in the
// carried (w, sum_z) (mc_tpu :828-834): after step j+1, t_j = (j + 1) dt,
//   dS/ds0 = S / s0,   dS/dsigma = S (-sigma t_j + sqrt_dt sum_z),
//   dS/dr = S t_j,     dS/dq = -(S t_j),   sqrt_dt = vol_dt / sigma,
// and at maturity the same with t_j = T (sqrt_t = vol_t / sigma and z at
// the terminal draw).  The payoff state's tangents follow the payoff's
// update_tangent after every step and its terminal_tangent at maturity
// (payoffs.cuh), the hand-written jax.jvp of mc_tpu's payoff, so the five
// payoffs with an a.e. derivative (vanilla call and put, best-of-cash,
// Asian, lookback) are the ones it takes.  No antithetic leg, control
// variate, importance sampling or resume, as in mc_tpu.
//
// The terminal draw and the Euler loop are kernels apart (a template
// parameter, picked on the host; the terminal kernel exists for the three
// payoffs without state, the only ones it takes).  Under Euler a payoff
// without state forms S = s0 * expf(w) once, at maturity: nothing reads S
// at the steps (its update and tangents are the identity), and the last
// step's S is that same product; the Asian and the lookback form it at
// every step.  A block sums kGreekBlockPaths = 256 paths, block b paths
// b*256 .. b*256+255, grid-strided, as the one-path-a-thread kernel it
// replaced did: its 256 / P threads each run P of them in lockstep, thread
// t paths t, t + T, .. t + (P-1)T (T the block's threads), each path's ten
// f64 moments in a lane of its own.  The lanes add as that kernel's block
// tree added its threads t + pT (lane p and p + h at its level T*h), and
// the T threads' tree finishes, its last levels in a warp (reduce.cuh
// block_store_moments_warp): every row keeps its bits.
//
// What bounds it on the H100: operations, as for simulate_kernel.  It reads
// 60 bytes of parameters and writes ten f64 per block; per step it adds to
// the pair's threefry share the sum of the normals and, for a payoff with
// state, S's expf, the time t_j, four spot tangents (a division, about ten
// f32 operations) and four state-tangent updates.  Float contraction is off
// in the build (--fmad=false), so each mul and add rounds as in the plain
// version.

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kGreekBlockPaths = 256;  // paths a block: the one-path kernel's threads
constexpr int kGreeks = 4;            // s0, sigma, r, q
constexpr int kGreekValues = 1 + kGreeks;
constexpr int kGreekMoments = 2 * kGreekValues;

// Paths a thread of the Euler or the terminal kernel: on the H100
// (family_nmc_probe.py --greeks, PERF.md) 1, 2 and 4 took the call at 1M
// terminal in 0.0160 / 0.0133 / 0.0137 ms and the Asian at 100,000 x 100
// by Euler in 0.0432 / 0.0470 / 0.0727 (the call 0.0315 / 0.0326 /
// 0.0524): 391 blocks keep 3 an SM busy, and more lanes only lengthen them.
__host__ __device__ constexpr int greek_paths_per_thread(bool euler) {
  return euler ? 1 : 2;
}

// dS/d(s0, sigma, r, q) of S = s0 e^w after elapsed time t_j.
__device__ __forceinline__ void spot_tangents(const Params& p, float s, float t_j,
                                              float sum_z, float sqrt_dt,
                                              float (&ds)[kGreeks]) {
  ds[0] = s / p.s0;
  ds[1] = s * (-p.sigma * t_j + sqrt_dt * sum_z);
  ds[2] = s * t_j;
  ds[3] = -(s * t_j);
}

// A path's payoff and its four tangents at maturity from S, its tangents
// and the payoff state's.
template <class Payoff>
__device__ __forceinline__ void greek_finish(const Params& p, const typename Payoff::State& st,
                                             const typename Payoff::State (&dst)[kGreeks],
                                             float s, const float (&ds)[kGreeks], float& pay,
                                             float (&dpay)[kGreeks]) {
  pay = Payoff::terminal(st, s, p);
#pragma unroll
  for (int g = 0; g < kGreeks; ++g) dpay[g] = Payoff::terminal_tangent(st, dst[g], s, ds[g], p);
}

// P paths' payoffs and tangents: the terminal draw (a payoff without state)
// or the log-Euler loop over for_each_draw's schedule from step 0, the P
// paths in lockstep.  draw(q, m, z0, z1) gives path q's pair m.
template <class Payoff, int P, bool EULER, class Draw>
__device__ __forceinline__ void greek_paths(const Params& p, int n_steps, Draw draw,
                                            float (&pay)[P], float (&dpay)[P][kGreeks]) {
  using State = typename Payoff::State;
  const State st0 = Payoff::init(p);
  if constexpr (!EULER) {
    static_assert(Payoff::kStates == 0, "the terminal draw takes a payoff without state");
    const State dst[kGreeks] = {};
#pragma unroll
    for (int q = 0; q < P; ++q) {
      float z, unused, ds[kGreeks];
      draw(q, 0, z, unused);
      const float s = p.s0 * expf(p.drift_t + p.vol_t * z);
      spot_tangents(p, s, p.t, z, p.vol_t / p.sigma, ds);
      greek_finish<Payoff>(p, st0, dst, s, ds, pay[q], dpay[q]);
    }
  } else {
    const float sqrt_dt = p.vol_dt / p.sigma;
    float w[P], sum_z[P], s[P];
    State st[P], dst[P][kGreeks];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      w[q] = 0.0f;
      sum_z[q] = 0.0f;
      s[q] = p.s0;
      st[q] = st0;
#pragma unroll
      for (int g = 0; g < kGreeks; ++g) dst[q][g] = State{};
    }
    // step j on the P paths' normals z
    const auto step = [&](int j, const float (&z)[P]) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        w[q] = w[q] + (p.drift_dt + p.vol_dt * z[q]);
        sum_z[q] = sum_z[q] + z[q];
        if constexpr (Payoff::kStates > 0) {
          s[q] = p.s0 * expf(w[q]);
          const float t_j = (static_cast<float>(j) + 1.0f) * p.dt;
          float ds[kGreeks];
          spot_tangents(p, s[q], t_j, sum_z[q], sqrt_dt, ds);
#pragma unroll
          for (int g = 0; g < kGreeks; ++g)
            dst[q][g] = Payoff::update_tangent(st[q], dst[q][g], s[q], ds[g], p);
          st[q] = Payoff::update(st[q], s[q], p);
        }
      }
    };
    float z0[P], z1[P];
    for (int m = 0; m < n_steps / 2; ++m) {
#pragma unroll
      for (int q = 0; q < P; ++q) draw(q, m, z0[q], z1[q]);
      step(2 * m, z0);
      step(2 * m + 1, z1);
    }
    if (n_steps & 1) {
#pragma unroll
      for (int q = 0; q < P; ++q) draw(q, n_steps / 2, z0[q], z1[q]);
      step(n_steps - 1, z0);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if constexpr (Payoff::kStates == 0) s[q] = p.s0 * expf(w[q]);
      float ds[kGreeks];
      spot_tangents(p, s[q], p.t, sum_z[q], sqrt_dt, ds);
      greek_finish<Payoff>(p, st[q], dst[q], s[q], ds, pay[q], dpay[q]);
    }
  }
}

template <class Payoff, int ROUNDS, bool EULER>
__global__ void __launch_bounds__(kGreekBlockPaths / greek_paths_per_thread(EULER))
greek_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params, int n_steps,
             uint32_t n_paths, double* __restrict__ partials) {
  constexpr int P = greek_paths_per_thread(EULER);
  constexpr int T = kGreekBlockPaths / P;
  static_assert(kGreekBlockPaths % P == 0 && T >= 32 && (T & (T - 1)) == 0,
                "a block's threads are a power of two of at least a warp");
  const Params p = load_params(params);
  double acc[P][kGreekMoments];
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int m = 0; m < kGreekMoments; ++m) acc[q][m] = 0.0;
  }
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kGreekBlockPaths;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kGreekBlockPaths + threadIdx.x;
       i < n_paths; i += stride) {
    float pay[P], d[P][kGreeks];
    greek_paths<Payoff, P, EULER>(
        p, n_steps,
        [&](int q, int m, float& z0, float& z1) {
          normal_pair<ROUNDS>(k0, k1, static_cast<uint32_t>(i + q * T),
                              static_cast<uint32_t>(m), z0, z1);
        },
        pay, d);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      // rho folds the discount's derivative -T pay; q does not enter e^{-rT}.
      const float v[kGreekValues] = {pay[q], d[q][0], d[q][1], d[q][2] - p.t * pay[q], d[q][3]};
      // a lane past the last path adds zeros
      add_moments(acc[q], v, i + q * T < n_paths);
    }
  }
#pragma unroll
  for (int h = P / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int q = 0; q < h; ++q) {
#pragma unroll
      for (int m = 0; m < kGreekMoments; ++m) acc[q][m] += acc[q + h][m];
    }
  }
  block_store_moments_warp<kGreekMoments, T>(
      acc[0], partials + static_cast<size_t>(kGreekMoments) * blockIdx.x);
}

template <class Payoff, bool EULER>
cudaError_t launch_greek(int rounds, uint32_t k0, uint32_t k1, const float* params,
                         int n_steps, uint32_t n_paths, double* partials, int n_blocks,
                         cudaStream_t stream) {
  constexpr int T = kGreekBlockPaths / greek_paths_per_thread(EULER);
  if (rounds == 13) {
    greek_kernel<Payoff, 13, EULER><<<n_blocks, T, 0, stream>>>(k0, k1, params, n_steps,
                                                                n_paths, partials);
  } else if (rounds == 20) {
    greek_kernel<Payoff, 20, EULER><<<n_blocks, T, 0, stream>>>(k0, k1, params, n_steps,
                                                                n_paths, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The payoff's kernel of the mode: Euler, or the terminal draw for a payoff
// without state (a path-dependent payoff has no terminal kernel).
template <class Payoff>
cudaError_t greek_switch(int rounds, int euler, uint32_t k0, uint32_t k1, const float* params,
                         int n_steps, uint32_t n_paths, double* partials, int n_blocks,
                         cudaStream_t stream) {
  if (euler)
    return launch_greek<Payoff, true>(rounds, k0, k1, params, n_steps, n_paths, partials,
                                      n_blocks, stream);
  if constexpr (Payoff::kStates == 0)
    return launch_greek<Payoff, false>(rounds, k0, k1, params, n_steps, n_paths, partials,
                                       n_blocks, stream);
  return cudaErrorInvalidValue;
}

template <class Payoff>
cudaError_t greek_occupancy(int euler, int* blocks) {
  if (euler)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, greek_kernel<Payoff, 13, true>, kGreekBlockPaths / greek_paths_per_thread(true),
        0);
  if constexpr (Payoff::kStates == 0)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, greek_kernel<Payoff, 13, false>,
        kGreekBlockPaths / greek_paths_per_thread(false), 0);
  return cudaErrorInvalidValue;
}

}  // namespace mc

extern "C" {

// The kernel's paths a block (its grid: ceil(n_paths / it), capped) and
// the paths a thread of the Euler or the terminal kernel.
int mc_greek_block_paths() { return mc::kGreekBlockPaths; }
int mc_greek_paths_per_thread(int euler) { return mc::greek_paths_per_thread(euler != 0); }

// Resident blocks per SM of a payoff's threefry-13 kernel of the mode.
int mc_greek_occupancy(int payoff_id, int euler, int* blocks) {
#define MC_CASE(ID, PAYOFF) \
  case mc::ID:              \
    return mc::greek_occupancy<mc::PAYOFF>(euler, blocks);
  switch (payoff_id) {
    MC_PATHWISE_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

// params: the 15 packed floats of pack_params; partials (n_blocks, 10) f64;
// n_blocks blocks of mc_greek_block_paths() paths, paths 0 .. n_paths - 1.
int mc_greek_partials(int payoff_id, int rounds, int euler, uint32_t k0, uint32_t k1,
                      const float* params, int n_steps, uint32_t n_paths,
                      double* partials, int n_blocks, void* stream) {
  if (n_blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_CASE(ID, PAYOFF)                                                          \
  case mc::ID:                                                                       \
    return mc::greek_switch<mc::PAYOFF>(rounds, euler, k0, k1, params, n_steps,     \
                                        n_paths, partials, n_blocks, s);
  switch (payoff_id) {
    MC_PATHWISE_PAYOFFS(MC_CASE)
    default:  // a payoff without an a.e. derivative has no pathwise greek
      return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
