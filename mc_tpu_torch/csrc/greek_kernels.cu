// The pathwise-greek kernel, kernel 8 of the port, for sm_90a.
//
// greek_kernel replaces mc_tpu/ops/path_kernels.py simulate_greek_partials
// (the Pallas call at :941): one pass that prices a path and carries the
// forward-mode tangents of its payoff with respect to (s0, sigma, r, q),
// and writes per block the f64 sums and sums of squares of
//   (pay, delta, vega, rho' = d pay/dr - T pay, epsilon),
// ten moments, for greeks(method="pathwise").  Its leg is simulate_kernel's
// (path_kernels.cu): the exact terminal draw (the head of pair 0) or the
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
// What bounds it on the H100: operations, as for simulate_kernel.  It reads
// 60 bytes of parameters and writes ten f64 per block; per step it adds to
// simulate's threefry share and expf the sum of the normals, the time t_j
// and, for a payoff with state, four spot tangents (a division, about ten
// f32 operations) and four state-tangent updates.  Everything stays in
// registers: one path per thread over a grid-stride loop (the grid capped
// as simulate's, ops/_cuda.py MAX_BLOCKS), the ten moments summed in
// f64 per thread and tree-reduced once per block (reduce.cuh; 10 x 256 x
// 8 B = 20 KB of shared memory).  Float contraction is off in the build
// (--fmad=false), so each mul and add rounds as in the plain version.

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kGreekThreads = 256;
constexpr int kGreeks = 4;            // s0, sigma, r, q
constexpr int kGreekValues = 1 + kGreeks;
constexpr int kGreekMoments = 2 * kGreekValues;

// dS/d(s0, sigma, r, q) of S = s0 e^w after elapsed time t_j.
__device__ __forceinline__ void spot_tangents(const Params& p, float s, float t_j,
                                              float sum_z, float sqrt_dt,
                                              float (&ds)[kGreeks]) {
  ds[0] = s / p.s0;
  ds[1] = s * (-p.sigma * t_j + sqrt_dt * sum_z);
  ds[2] = s * t_j;
  ds[3] = -(s * t_j);
}

// One path's payoff and its four tangents.
template <class Payoff, class DrawPair>
__device__ __forceinline__ void greek_path(const Params& p, bool euler, int n_steps,
                                           DrawPair draw_pair, float& pay,
                                           float (&dpay)[kGreeks]) {
  using State = typename Payoff::State;
  State st = Payoff::init(p);
  State dst[kGreeks] = {};  // the state's tangents start at zero
  float ds[kGreeks];
  if (!euler) {
    float z, unused;
    draw_pair(0, z, unused);
    const float s = p.s0 * expf(p.drift_t + p.vol_t * z);
    spot_tangents(p, s, p.t, z, p.vol_t / p.sigma, ds);
    pay = Payoff::terminal(st, s, p);
#pragma unroll
    for (int g = 0; g < kGreeks; ++g) dpay[g] = Payoff::terminal_tangent(st, dst[g], s, ds[g], p);
    return;
  }
  const float sqrt_dt = p.vol_dt / p.sigma;
  float w = 0.0f, sum_z = 0.0f, s = p.s0;
  int j = 0;
  for_each_draw(0, n_steps, draw_pair, [&](float z) {
    w = w + (p.drift_dt + p.vol_dt * z);
    sum_z = sum_z + z;
    s = p.s0 * expf(w);
    if constexpr (Payoff::kStates > 0) {
      const float t_j = (static_cast<float>(j) + 1.0f) * p.dt;
      spot_tangents(p, s, t_j, sum_z, sqrt_dt, ds);
#pragma unroll
      for (int g = 0; g < kGreeks; ++g) dst[g] = Payoff::update_tangent(st, dst[g], s, ds[g], p);
    }
    st = Payoff::update(st, s, p);
    ++j;
  });
  spot_tangents(p, s, p.t, sum_z, sqrt_dt, ds);
  pay = Payoff::terminal(st, s, p);
#pragma unroll
  for (int g = 0; g < kGreeks; ++g) dpay[g] = Payoff::terminal_tangent(st, dst[g], s, ds[g], p);
}

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kGreekThreads)
greek_kernel(int euler, uint32_t k0, uint32_t k1, const float* __restrict__ params,
             int n_steps, uint32_t n_paths, double* __restrict__ partials) {
  const Params p = load_params(params);
  double acc[kGreekMoments];
#pragma unroll
  for (int m = 0; m < kGreekMoments; ++m) acc[m] = 0.0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = static_cast<uint32_t>(i);
    float pay, d[kGreeks];
    greek_path<Payoff>(p, euler, n_steps,
                       [&](int m, float& z0, float& z1) {
                         normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
                       },
                       pay, d);
    // rho folds the discount's derivative -T pay; q does not enter e^{-rT}.
    const float v[kGreekValues] = {pay, d[0], d[1], d[2] - p.t * pay, d[3]};
    add_moments(acc, v, true);
  }
  block_store_moments<kGreekMoments, kGreekThreads>(
      acc, partials + static_cast<size_t>(kGreekMoments) * blockIdx.x, kGreekMoments);
}

template <class Payoff>
cudaError_t launch_greek(int rounds, int euler, uint32_t k0, uint32_t k1,
                         const float* params, int n_steps, uint32_t n_paths,
                         double* partials, int n_blocks, cudaStream_t stream) {
  if (rounds == 13) {
    greek_kernel<Payoff, 13><<<n_blocks, kGreekThreads, 0, stream>>>(
        euler, k0, k1, params, n_steps, n_paths, partials);
  } else if (rounds == 20) {
    greek_kernel<Payoff, 20><<<n_blocks, kGreekThreads, 0, stream>>>(
        euler, k0, k1, params, n_steps, n_paths, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_greek_partials(int payoff_id, int rounds, int euler, uint32_t k0, uint32_t k1,
                      const float* params, int n_steps, uint32_t n_paths,
                      double* partials, int n_blocks, void* stream) {
  if (n_blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_CASE(ID, PAYOFF)                                                       \
  case mc::ID:                                                                    \
    return mc::launch_greek<mc::PAYOFF>(rounds, euler, k0, k1, params, n_steps,   \
                                        n_paths, partials, n_blocks, s);
  switch (payoff_id) {
    MC_PATHWISE_PAYOFFS(MC_CASE)
    default:  // a payoff without an a.e. derivative has no pathwise greek
      return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
