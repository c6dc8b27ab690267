// Nested Monte Carlo, kernels 3 and 5 of the port, for sm_90a.
//
// nmc_fused_kernel replaces mc_tpu/ops/nmc_kernels.py nmc_fused_kernel (the
// Pallas call at :283); nmc_inner_kernel replaces nmc_inner_kernel (the
// Pallas call at :351), the grid strategy, which reads each (S_j, count_j)
// from the grids trajectories_kernel stored instead of recomputing the outer
// path.  Both compute the same surface through one device function,
// nmc_point (as mc_tpu shares _nmc_point_tile): for outer path i, step j,
//   surface[j, i] = disc_j * mean_{m < n_inner} payoff(inner path m resumed
//                   from (S_j, count_j) for the remaining n_steps-j-1 steps),
// with inner counter (c0 = path id, c1 = ((j+1)*n_inner + m)*pair_cap + q)
// on the inner key, and the outer moments [sum pay, sum pay^2].  Both take
// the payoffs with at most one state word (mc_tpu's price_nmc refuses the
// others): the six terminal-only ones, bullet, Asian, the three discrete
// barriers and the lookback; the stored state is word 0.
//
// What bounds it on the H100: the inner sweep, n_inner*(n_steps-j-1) steps
// per point, each half a threefry-13 call and half the Box-Muller
// transcendentals; bytes are negligible (one f32 per point).  Under
// --fmad=false and the accurate libm a normal pair is ~140 issued
// instructions (threefry ~47, log1pf ~28, sincosf ~35, sqrtf ~11), so
// instruction issue is the wall (family_nmc_probe.py --gbm, PERF.md).
//
// Design: the TPU kernel parks a tile's whole outer history in VMEM and then
// sweeps it.  A Hopper block has 227 KB of shared memory, room for about 280
// outer paths at 100 steps, and the points of one tile would then run one
// after the other.  Here a block instead takes 128 outer paths at ONE step j
// and recomputes each outer path up to step j+1 in registers from the outer
// stream: j+1 steps against the inner sweep's n_inner*(n_steps-j-1), so
// under 1% extra work at n_inner = 500, and no history anywhere.  Every
// (j, tile) block is independent, so the grid has n_steps*tiles blocks to
// fill the 132 SMs, and all threads of a block share j, so the inner loop
// never diverges.  Work per block falls with j; block b takes step
// j = b / tiles, so the largest blocks are issued first and the short ones
// fill the tail.  The j = n_steps-1 blocks hold the outer terminal states
// and write the outer moment rows.  Inside a point (nmc_point), each thread
// - runs its legs kNmcLegs = 4 at a time (4 independent threefry chains the
//   scheduler interleaves; a ragged last group runs its surplus legs and
//   does not add them, n_groups being the caller's ceil(n_inner / 4)) and
//   adds their payoffs in f64 in leg order, as the plain version does;
// - takes the pairs whose both halves count, then for an odd count the head
//   half of one more pair: the TPU kernel's select of two full half-steps
//   at every pair, without the select;
// - forms S = base * expf(w) only where update reads it: a terminal-only
//   payoff's legs form it once at the end, and the bullet's, the up-and-out
//   and the down-and-in call's (update reads S < B alone) test w against the
//   point's below_max_w, 32 expf once per point in place of one a step.
// __launch_bounds__(128, 1) leaves the registers to ptxas (56-59 for the
// bullet, no spills); with no minimum of blocks ptxas held the bullet to 40
// registers, spilled in the fused kernel and ran 1-2% slower.  kNmcLegs was
// chosen by a sweep, where higher minimums of blocks and 256 threads gained
// nothing (family_nmc_probe.py --gbm; PERF.md section 6).  Two premises of the libm make this bitwise the parent's
// design; mc_nmc_libm_check tests both on every input (chip_smoke.py
// phase 2): expf keeps the order of the floats (below_max_w) and sincosf is
// cosf and sinf bit for bit (rng.cuh).
//
// nmc_inner_kernel keeps that schedule and reads 8 bytes per point where the
// fused kernel recomputes j+1 outer steps; both are negligible beside the
// inner sweep, so the two kernels take about the same time.  Its grids come
// from trajectories_kernel, whose step and draws are Phase A's, so the two
// strategies give bitwise equal surfaces.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "barrier.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kNmcThreads = 128;
constexpr int kNmcRounds = 13;  // NMC streams are threefry-13 (NMCConfig)

// The inner legs a thread runs at once.  Only family_nmc_probe.py --gbm's
// sweeps define MC_NMC_LEGS; the library exports what it was built with
// (mc_nmc_legs), and the wrappers read it.
constexpr int nmc_legs(int own) {
#ifdef MC_NMC_LEGS
  return static_cast<void>(own), MC_NMC_LEGS;
#else
  return own;
#endif
}
constexpr int kNmcLegs = nmc_legs(4);
static_assert(kNmcLegs == 1 || kNmcLegs == 2 || kNmcLegs == 4, "1, 2 or 4 legs");

// kNmcLegs inner legs in lockstep from (s_j, st_j) over `remaining` steps,
// leg l on counters (id, c[l] + q): the pairs whose two halves are taken,
// then, for an odd count, the head half of one more pair.  Their payoffs
// into pay[l].
template <class Payoff>
__device__ __forceinline__ void nmc_legs_run(const Params& p, uint32_t ki0, uint32_t ki1,
                                             uint32_t id, const uint32_t (&c)[kNmcLegs],
                                             int remaining, float s_j, float below_max,
                                             const typename Payoff::State& st_j,
                                             float (&pay)[kNmcLegs]) {
  const int n_full = remaining / 2;
  float w[kNmcLegs], s[kNmcLegs];
  typename Payoff::State st[kNmcLegs];
#pragma unroll
  for (int l = 0; l < kNmcLegs; ++l) {
    w[l] = 0.0f;
    s[l] = s_j;
    st[l] = st_j;
  }
  for (int q = 0; q < n_full; ++q) {
#pragma unroll
    for (int l = 0; l < kNmcLegs; ++l) {
      float z0, z1;
      normal_pair<kNmcRounds>(ki0, ki1, id, c[l] + static_cast<uint32_t>(q), z0, z1);
      leg_step<Payoff>(p, s_j, below_max, z0, w[l], s[l], st[l]);
      leg_step<Payoff>(p, s_j, below_max, z1, w[l], s[l], st[l]);
    }
  }
  if (remaining & 1) {  // block-uniform
#pragma unroll
    for (int l = 0; l < kNmcLegs; ++l) {
      float z0, z1;
      normal_pair<kNmcRounds>(ki0, ki1, id, c[l] + static_cast<uint32_t>(n_full), z0, z1);
      leg_step<Payoff>(p, s_j, below_max, z0, w[l], s[l], st[l]);
    }
  }
#pragma unroll
  for (int l = 0; l < kNmcLegs; ++l) {
    if constexpr (kStateRead<Payoff> != StateRead::kSpot) {
      if (remaining > 0) s[l] = s_j * expf(w[l]);
    }
    pay[l] = Payoff::terminal(st[l], s[l], p);
  }
}

// Phase B: the discounted mean payoff of n_inner inner paths resumed from
// (S_j, count_j), the state of path `id` after step j+1: the f64 sum over
// m = 0..n_inner-1 in that order, leg m on counters (id, ((j+1)*n_inner +
// m)*pair_cap + q), run kNmcLegs at a time (group g holds legs g*kNmcLegs ..
// g*kNmcLegs + kNmcLegs-1, n_groups = ceil(n_inner / kNmcLegs)); the legs
// of a ragged last group past n_inner run and are not added.
template <class Payoff>
__device__ float nmc_point(const Params& p, int discount_remaining, uint32_t ki0,
                           uint32_t ki1, uint32_t id, int j, int n_steps, int n_inner,
                           int n_groups, float s_j, typename Payoff::State st_j) {
  const int remaining = n_steps - j - 1;
  const uint32_t pair_cap = static_cast<uint32_t>((n_steps + 1) / 2);
  uint32_t c[kNmcLegs];
#pragma unroll
  for (int l = 0; l < kNmcLegs; ++l) {
    c[l] = (static_cast<uint32_t>(j + 1) * static_cast<uint32_t>(n_inner) +
            static_cast<uint32_t>(l)) * pair_cap;
  }
  const float below_max = kStateRead<Payoff> == StateRead::kBarrier && remaining > 0
                              ? below_max_w(s_j, p.barrier)
                              : 0.0f;
  double sum = 0.0;
  for (int g = 0; g < n_groups; ++g) {
    float pay[kNmcLegs];
    nmc_legs_run<Payoff>(p, ki0, ki1, id, c, remaining, s_j, below_max, st_j, pay);
#pragma unroll
    for (int l = 0; l < kNmcLegs; ++l) {
      if (g * kNmcLegs + l < n_inner) sum += static_cast<double>(pay[l]);
      c[l] += static_cast<uint32_t>(kNmcLegs) * pair_cap;
    }
  }
  const float disc = discount_remaining
      ? expf(-p.r * (p.t - (static_cast<float>(j) + 1.0f) * p.dt))
      : expf(-p.r * p.t);
  return static_cast<float>(sum / static_cast<double>(n_inner)) * disc;
}

template <class Payoff>
__global__ void __launch_bounds__(kNmcThreads, 1)
nmc_fused_kernel(int discount_remaining, uint32_t ko0, uint32_t ko1, uint32_t ki0,
                 uint32_t ki1, const float* __restrict__ params, int n_steps,
                 int n_inner, int n_groups, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                 int tiles, float* __restrict__ surface,
                 double* __restrict__ outer_partials) {
  const Params p = load_params(params);
  const int j = blockIdx.x / tiles;  // the state after step j+1
  const int tile = blockIdx.x % tiles;
  const uint32_t local = static_cast<uint32_t>(tile) * kNmcThreads + threadIdx.x;
  const bool in_range = local < n_paths;
  const uint32_t id = path_offset + local;
  const bool valid = in_range && id < bound;

  // Phase A: the outer path up to step j+1, on the outer stream.
  float w = 0.0f, s = p.s0;
  typename Payoff::State st = Payoff::init(p);
  float z0, z1;
  const int done = j + 1;
  for (int m = 0; m < done / 2; ++m) {
    normal_pair<kNmcRounds>(ko0, ko1, id, static_cast<uint32_t>(m), z0, z1);
    euler_step<Payoff>(p, p.s0, z0, w, s, st);
    euler_step<Payoff>(p, p.s0, z1, w, s, st);
  }
  if (done & 1) {
    normal_pair<kNmcRounds>(ko0, ko1, id, static_cast<uint32_t>(done / 2), z0, z1);
    euler_step<Payoff>(p, p.s0, z0, w, s, st);
  }

  if (j == n_steps - 1) {  // block-uniform: the outer terminal moments
    const float pay = valid ? Payoff::terminal(st, s, p) : 0.0f;
    const double acc[2] = {static_cast<double>(pay), static_cast<double>(pay * pay)};
    block_store_moments<2, kNmcThreads>(acc, outer_partials + 2 * static_cast<size_t>(tile), 2);
  }

  const float v = nmc_point<Payoff>(p, discount_remaining, ki0, ki1, id, j, n_steps,
                                    n_inner, n_groups, s, st);
  if (in_range) surface[static_cast<size_t>(j) * n_paths + local] = valid ? v : 0.0f;
}

template <class Payoff>
__global__ void __launch_bounds__(kNmcThreads, 1)
nmc_inner_kernel(int discount_remaining, uint32_t ki0, uint32_t ki1,
                 const float* __restrict__ params, int n_steps, int n_inner,
                 int n_groups, uint32_t n_paths, uint32_t path_offset, uint32_t bound, int tiles,
                 const float* __restrict__ s_grid, const float* __restrict__ state_grid,
                 float* __restrict__ surface) {
  const Params p = load_params(params);
  const int j = blockIdx.x / tiles;  // the state after step j+1
  const int tile = blockIdx.x % tiles;
  const uint32_t local = static_cast<uint32_t>(tile) * kNmcThreads + threadIdx.x;
  if (local >= n_paths) return;  // no block-wide step follows
  const uint32_t id = path_offset + local;
  const size_t at = static_cast<size_t>(j) * n_paths + local;
  typename Payoff::State st = Payoff::init(p);
  if (Payoff::kStates) st.w[0] = state_grid[at];
  const float v = nmc_point<Payoff>(p, discount_remaining, ki0, ki1, id, j, n_steps,
                                    n_inner, n_groups, s_grid[at], st);
  surface[at] = id < bound ? v : 0.0f;
}

// The libm premises of the design, one thread per uint32 k, into bad[0]
// and bad[1]: the finite floats of order keys k, k + 1 whose expf are out of
// order, and the thetas Box-Muller can draw (the 2^23 uniforms
// bits_to_unit gives, k < 2^23) where sincosf is not cosf and sinf bit for
// bit.  Integer atomics only; both counts are 0 on a good toolkit.  zero
// (0 at launch) hides from the compiler that cosf and sinf take sincosf's
// theta, so neither call can be folded into the other.
__global__ void nmc_libm_check_kernel(uint32_t zero, unsigned long long* __restrict__ bad) {
  const uint32_t k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= float_order(-FLT_MAX) && k < float_order(FLT_MAX) &&
      expf(order_float(k)) > expf(order_float(k + 1))) {
    atomicAdd(&bad[0], 1ull);
  }
  if (k < (1u << 23)) {
    const float theta = static_cast<float>(6.283185307179586) *
                        (__uint_as_float(k | 0x3F800000u) - 1.0f);
    float sn, cs;
    sincosf(theta, &sn, &cs);
    const float theta_b = __uint_as_float(__float_as_uint(theta) ^ zero);
    if (__float_as_uint(sn) != __float_as_uint(sinf(theta_b)) ||
        __float_as_uint(cs) != __float_as_uint(cosf(theta_b))) {
      atomicAdd(&bad[1], 1ull);
    }
  }
}

// Blocks: one per (step, tile of kNmcThreads outer paths), step-major; 0
// (refused) unless n_groups is the caller's ceil(n_inner / kNmcLegs)
// (ops/nmc_kernels.py nmc_launch).
inline long long nmc_blocks(uint32_t n_paths, int n_steps, int n_inner, int n_groups,
                            int* tiles) {
  if (n_inner < 1 || n_groups != (n_inner + kNmcLegs - 1) / kNmcLegs) return 0;
  *tiles = static_cast<int>((n_paths + kNmcThreads - 1) / kNmcThreads);
  return static_cast<long long>(*tiles) * n_steps;
}

template <class Payoff>
cudaError_t launch_nmc(int discount_remaining, uint32_t ko0, uint32_t ko1,
                       uint32_t ki0, uint32_t ki1, const float* params, int n_steps,
                       int n_inner, int n_groups, uint32_t n_paths, uint32_t path_offset,
                       uint32_t bound, float* surface, double* outer_partials,
                       cudaStream_t stream) {
  int tiles;
  const long long n_blocks = nmc_blocks(n_paths, n_steps, n_inner, n_groups, &tiles);
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  nmc_fused_kernel<Payoff><<<static_cast<unsigned>(n_blocks), kNmcThreads, 0, stream>>>(
      discount_remaining, ko0, ko1, ki0, ki1, params, n_steps, n_inner, n_groups, n_paths,
      path_offset, bound, tiles, surface, outer_partials);
  return cudaGetLastError();
}

template <class Payoff>
cudaError_t launch_nmc_inner(int discount_remaining, uint32_t ki0, uint32_t ki1,
                             const float* params, int n_steps, int n_inner, int n_groups,
                             uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                             const float* s_grid, const float* state_grid,
                             float* surface, cudaStream_t stream) {
  int tiles;
  const long long n_blocks = nmc_blocks(n_paths, n_steps, n_inner, n_groups, &tiles);
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  nmc_inner_kernel<Payoff><<<static_cast<unsigned>(n_blocks), kNmcThreads, 0, stream>>>(
      discount_remaining, ki0, ki1, params, n_steps, n_inner, n_groups, n_paths,
      path_offset, bound, tiles, s_grid, state_grid, surface);
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_nmc_block_threads() { return mc::kNmcThreads; }

int mc_nmc_legs() { return mc::kNmcLegs; }

// bad[2] (zeroed by the caller): the counts of nmc_libm_check_kernel.
int mc_nmc_libm_check(unsigned long long* bad, void* stream) {
  mc::nmc_libm_check_kernel<<<1u << 24, 256, 0, static_cast<cudaStream_t>(stream)>>>(0u, bad);
  return cudaGetLastError();
}

// The resident blocks per SM of the fused (fused = 1) or inner kernel of
// a payoff, on the current device.
int mc_nmc_occupancy(int payoff_id, int fused, int* blocks) {
#define MC_CASE(ID, PAYOFF)                                                          \
  case mc::ID:                                                                       \
    return fused ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
                       blocks, mc::nmc_fused_kernel<mc::PAYOFF>, mc::kNmcThreads, 0) \
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
                       blocks, mc::nmc_inner_kernel<mc::PAYOFF>, mc::kNmcThreads, 0);
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

int mc_nmc_fused(int payoff_id, int discount_remaining, uint32_t ko0, uint32_t ko1,
                 uint32_t ki0, uint32_t ki1, const float* params, int n_steps,
                 int n_inner, int n_groups, uint32_t n_paths, uint32_t path_offset,
                 uint32_t bound, float* surface, double* outer_partials, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_LAUNCH_NMC(PAYOFF)                                                        \
  mc::launch_nmc<PAYOFF>(discount_remaining, ko0, ko1, ki0, ki1, params, n_steps,    \
                         n_inner, n_groups, n_paths, path_offset, bound, surface,    \
                         outer_partials, s)
#define MC_CASE(ID, PAYOFF) \
  case mc::ID: return MC_LAUNCH_NMC(mc::PAYOFF);
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
#undef MC_LAUNCH_NMC
}

int mc_nmc_inner(int payoff_id, int discount_remaining, uint32_t ki0, uint32_t ki1,
                 const float* params, int n_steps, int n_inner, int n_groups,
                 uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                 const float* s_grid, const float* state_grid, float* surface,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_LAUNCH_NMC_INNER(PAYOFF)                                                  \
  mc::launch_nmc_inner<PAYOFF>(discount_remaining, ki0, ki1, params, n_steps, n_inner, \
                               n_groups, n_paths, path_offset, bound, s_grid,         \
                               state_grid, surface, s)
#define MC_CASE(ID, PAYOFF) \
  case mc::ID: return MC_LAUNCH_NMC_INNER(mc::PAYOFF);
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
#undef MC_LAUNCH_NMC_INNER
}

}  // extern "C"
