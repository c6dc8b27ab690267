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
// per point, each half a threefry-13 call, half the Box-Muller
// transcendentals and one expf.  Bytes are negligible (one f32 per point).
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
// and write the outer moment rows.  An odd remaining count drops the second
// half-step of the last pair by a select, as the TPU kernel does.
//
// nmc_inner_kernel keeps that schedule and reads 8 bytes per point where the
// fused kernel recomputes j+1 outer steps; both are negligible beside the
// inner sweep, so the two kernels take about the same time.  Its grids come
// from trajectories_kernel, whose step and draws are Phase A's, so the two
// strategies give bitwise equal surfaces.

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kNmcThreads = 128;
constexpr int kNmcRounds = 13;  // NMC streams are threefry-13 (NMCConfig)

// Phase B: the discounted mean payoff of n_inner inner paths resumed from
// (S_j, count_j), the state of path `id` after step j+1.
template <class Payoff>
__device__ float nmc_point(const Params& p, int discount_remaining, uint32_t ki0,
                           uint32_t ki1, uint32_t id, int j, int n_steps, int n_inner,
                           float s_j, typename Payoff::State st_j) {
  using State = typename Payoff::State;
  const int remaining = n_steps - j - 1;
  const int n_pairs = (remaining + 1) / 2;
  const uint32_t pair_cap = static_cast<uint32_t>((n_steps + 1) / 2);
  const uint32_t t_base = static_cast<uint32_t>(j + 1) * static_cast<uint32_t>(n_inner);
  double sum = 0.0;
  for (int m = 0; m < n_inner; ++m) {
    const uint32_t c1_base = (t_base + static_cast<uint32_t>(m)) * pair_cap;
    float wi = 0.0f, si = s_j;
    State sti = st_j;
    for (int q = 0; q < n_pairs; ++q) {
      float z0, z1;
      normal_pair<kNmcRounds>(ki0, ki1, id, c1_base + static_cast<uint32_t>(q), z0, z1);
      float w1 = wi, s1;
      State st1 = sti;
      euler_step<Payoff>(p, s_j, z0, w1, s1, st1);
      float w2 = w1, s2;
      State st2 = st1;
      euler_step<Payoff>(p, s_j, z1, w2, s2, st2);
      const bool take2 = (2 * q + 1) < remaining;  // drop an overrunning half-step
      wi = take2 ? w2 : w1;
      si = take2 ? s2 : s1;
      sti = take2 ? st2 : st1;
    }
    sum += static_cast<double>(Payoff::terminal(sti, si, p));
  }
  const float disc = discount_remaining
      ? expf(-p.r * (p.t - (static_cast<float>(j) + 1.0f) * p.dt))
      : expf(-p.r * p.t);
  return static_cast<float>(sum / static_cast<double>(n_inner)) * disc;
}

template <class Payoff>
__global__ void __launch_bounds__(kNmcThreads)
nmc_fused_kernel(int discount_remaining, uint32_t ko0, uint32_t ko1, uint32_t ki0,
                 uint32_t ki1, const float* __restrict__ params, int n_steps,
                 int n_inner, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
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
                                    n_inner, s, st);
  if (in_range) surface[static_cast<size_t>(j) * n_paths + local] = valid ? v : 0.0f;
}

template <class Payoff>
__global__ void __launch_bounds__(kNmcThreads)
nmc_inner_kernel(int discount_remaining, uint32_t ki0, uint32_t ki1,
                 const float* __restrict__ params, int n_steps, int n_inner,
                 uint32_t n_paths, uint32_t path_offset, uint32_t bound, int tiles,
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
                                    n_inner, s_grid[at], st);
  surface[at] = id < bound ? v : 0.0f;
}

// Blocks: one per (step, tile of kNmcThreads outer paths), step-major.
inline long long nmc_blocks(uint32_t n_paths, int n_steps, int* tiles) {
  *tiles = static_cast<int>((n_paths + kNmcThreads - 1) / kNmcThreads);
  return static_cast<long long>(*tiles) * n_steps;
}

template <class Payoff>
cudaError_t launch_nmc(int discount_remaining, uint32_t ko0, uint32_t ko1,
                       uint32_t ki0, uint32_t ki1, const float* params, int n_steps,
                       int n_inner, uint32_t n_paths, uint32_t path_offset,
                       uint32_t bound, float* surface, double* outer_partials,
                       cudaStream_t stream) {
  int tiles;
  const long long n_blocks = nmc_blocks(n_paths, n_steps, &tiles);
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  nmc_fused_kernel<Payoff><<<static_cast<unsigned>(n_blocks), kNmcThreads, 0, stream>>>(
      discount_remaining, ko0, ko1, ki0, ki1, params, n_steps, n_inner, n_paths,
      path_offset, bound, tiles, surface, outer_partials);
  return cudaGetLastError();
}

template <class Payoff>
cudaError_t launch_nmc_inner(int discount_remaining, uint32_t ki0, uint32_t ki1,
                             const float* params, int n_steps, int n_inner,
                             uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                             const float* s_grid, const float* state_grid,
                             float* surface, cudaStream_t stream) {
  int tiles;
  const long long n_blocks = nmc_blocks(n_paths, n_steps, &tiles);
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  nmc_inner_kernel<Payoff><<<static_cast<unsigned>(n_blocks), kNmcThreads, 0, stream>>>(
      discount_remaining, ki0, ki1, params, n_steps, n_inner, n_paths, path_offset,
      bound, tiles, s_grid, state_grid, surface);
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_nmc_block_threads() { return mc::kNmcThreads; }

int mc_nmc_fused(int payoff_id, int discount_remaining, uint32_t ko0, uint32_t ko1,
                 uint32_t ki0, uint32_t ki1, const float* params, int n_steps,
                 int n_inner, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                 float* surface, double* outer_partials, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_LAUNCH_NMC(PAYOFF)                                                       \
  mc::launch_nmc<PAYOFF>(discount_remaining, ko0, ko1, ki0, ki1, params, n_steps,   \
                         n_inner, n_paths, path_offset, bound, surface, outer_partials, s)
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
                 const float* params, int n_steps, int n_inner, uint32_t n_paths,
                 uint32_t path_offset, uint32_t bound, const float* s_grid,
                 const float* state_grid, float* surface, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_LAUNCH_NMC_INNER(PAYOFF)                                                  \
  mc::launch_nmc_inner<PAYOFF>(discount_remaining, ki0, ki1, params, n_steps, n_inner, \
                               n_paths, path_offset, bound, s_grid, state_grid,       \
                               surface, s)
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
