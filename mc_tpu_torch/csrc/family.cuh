// The family nested-MC engine on the device: the kernels every model family
// instantiates (family_nmc_kernels.cu for Heston, <family>_nmc_kernels.cu
// for Merton, Bates, CEV, local vol, SABR, term structures, Vasicek, the
// basket and the rainbow), templates over a device-side family whose
// interface mirrors NMCFamily (nmc_engine.py):
//   Params, load(ptr, extras, n_steps) the packed parameters, the family's
//                                      integer extras (Merton's and Bates's
//                                      Poisson scan depth, local vol's knot
//                                      count, the basket's d) and the step
//                                      count (local vol's and term's curve
//                                      length);
//   payoff_params(p)                   the payoffs' view of the contract;
//   kGrids                             market-state grids (S first), or, for
//                                      a family with grid_count(p) (the
//                                      basket), their capacity: the call
//                                      stores grid_count(p) of them;
//   Carry<Payoff>, outer_init(p)       the outer path's carry and its start;
//   OuterDraw, kStepsPerDraw           the words one outer draw unit gives
//                                      (DrawWords), and the steps it feeds
//                                      (2 where a step pair shares a draw);
//   outer_draw(p, k0, k1, id, u, d)    draw unit u of path id on the outer
//                                      stream: a pure function of (key, id,
//                                      u), steps u*kStepsPerDraw on;
//   outer_advance<Payoff>(p, j, d, c)  step j from its unit's draw d (its
//                                      half, for a pair), steps taken j = 0,
//                                      1, 2, ... in order;
//   outer_step<Payoff>(p, k0, k1, id, j, c)
//                                      the two: outer_draw at the first step
//                                      of a unit (a pair's odd half parked
//                                      in the carry), then outer_advance's
//                                      step on the step's half;
//   point(c, g), outer_pay(p, c)       the grid rows of a carry, its payoff;
//   kLegs                              the inner legs a thread runs at once;
//   inner_legs<Payoff>(p, k0, k1, id, c_base, stride, remaining, g, st, pay)
//                                      kLegs inner legs resumed from the rows
//                                      g and payoff state st, `remaining`
//                                      substeps, leg l drawing from counter
//                                      c_base + l*stride on, their payoffs
//                                      into pay[l];
//   point_scale(p, g)                  the factor on the inner mean;
//   counter_stride(p, n_steps)         the counter budget of one inner leg;
//   table_floats(extras), fill_table(p, t), attach_table(p, t)
//                                      optional: a per-block table in shared
//                                      memory (Merton's and Bates's Poisson
//                                      cdf), built by one thread;
//   draw_counts(p, d), outer_advance_counted<Payoff>(p, j, d, c)
//                                      with the table: a draw's Poisson
//                                      uniforms turned into their counts
//                                      against it, and the step on them (the
//                                      scan's counts, bit for bit);
//   draw_words(p)                      optional: the words of OuterDraw a
//                                      call draws (the basket's 2*ceil(d/2));
//   kTrajSplitBlocks                   the blocks an SM up to which the
//                                      trajectories kernel splits its draws
//                                      off (traj_split; 0: never, and no
//                                      split kernel is instantiated).
//
// family_fused_kernel replaces mc_tpu/nmc_engine.py family_fused_kernel (the
// Pallas call at :426) and family_inner_kernel its family_inner_kernel (the
// Pallas call at :331).  family_trajectories_kernel stores a family's outer
// grids: under Heston, Merton, local vol and Vasicek it replaces
// mc_tpu/models/heston.py heston_trajectories_kernel (:527),
// models/merton.py merton_trajectories_kernel (:392),
// models/localvol.py localvol_trajectories_kernel (:406) and
// models/vasicek.py vasicek_trajectories_kernel (:405); under CEV, SABR,
// term, Bates, the basket and the rainbow mc_tpu builds the grids with its
// XLA scan (xla_family_trajectories, nmc_engine.py:445-488), which has no
// Pallas counterpart.
//
// For outer path i and step j, surface[j, i] = point_scale * (1/n_inner) *
// the f32 Kahan sum over m = 0..n_inner-1, in that order, of inner leg m,
// counters c_base = ((j+1)*n_inner + m) * counter_stride: mc_tpu's
// family_point_tile, whose order is part of its bitwise contract.  The
// outer moments [sum pay, sum pay^2] of the fused kernel come from its
// j = n_steps-1 blocks, one f64 row per tile.
//
// What bounds them on the H100: the inner sweep, n_paths * n_inner *
// n_steps(n_steps-1)/2 substeps, each a family step with its threefry draws
// and transcendentals; under --fmad=false and the accurate libm a substep
// is ~100-200 issued instructions (term's pair loop holds ~320 for two),
// so instruction issue, not the SFU count nor bytes, is the wall.  Bytes are
// negligible (the surface, and a few bytes a point of grids for the inner
// kernel); the trajectories kernel writes (kGrids + 1) * 4 bytes a
// path-step, less than its RNG work takes.
//
// Design: one block per (step j, tile of 128 outer paths), step-major, so
// the largest remaining work (j = 0) is issued first and the short blocks
// fill the tail; all threads of a block share j, so the inner loops never
// diverge.  Inside a block:
// - each thread runs its point's legs kLegs at a time (a compile-time
//   constant of the family, 1, 2 or 4 as measured on the H100), kLegs
//   independent chains the scheduler interleaves, whose payoffs are then
//   Kahan-added in leg order; a ragged last group runs its surplus legs and
//   does not add them (the count n_groups is the caller's, checked here);
// - values that are the same for every thread and leg are read once for
//   the kLegs legs of a substep: local vol's row level, knots, widths and
//   slopes, term's curve entries, the basket's Cholesky rows, drifts, s0s
//   and weights; Merton's and Bates's Poisson cdf F(0..kmax-1), which the
//   scan recomputed each substep, is a per-block table built once by one
//   thread in the scan's order, so every count is the scan's, bit for bit;
// - the packed vector is copied once to dynamic shared memory at block
//   start (the inner kernel's grid loads in flight meanwhile) when it fits
//   kFamilySmemBudget beside the table, and read where it lies through the
//   same code when it does not (local vol's surface past ~3,000 floats);
//   the fused kernel's outer steps read it where it lies;
// - __launch_bounds__(128, kFamilyMinBlocks) leaves the registers to ptxas:
//   no family spills at the basket's capacity 8.
// The fused kernel recomputes the outer path up to step j+1 in registers
// through the family's outer step, whose draw and advance the trajectories
// kernel runs apart (below), j+1 steps against the sweep's
// n_inner*(n_steps-j-1), and keeps no history; so the grid and fused
// strategies give bitwise equal surfaces.
//
// The trajectories kernel runs at small outer grids (16,384 paths: 128
// blocks on 132 SMs; nmc --model's 2,048: 16 blocks), where one path a
// thread leaves one warp a scheduler and nothing hides each step's draw, a
// dependent chain of some hundreds of cycles (threefry-13 and Box-Muller:
// Heston's and SABR's pair, Merton's three, the basket's d/2).  The draws
// do not depend on the path's state, so a block of 128 paths splits them
// off: its first 4 warps
// (the advance lanes, one a path) take the steps in order and store the
// grids step-major, coalesced; kTrajDrawWarps further warps fill a shared
// buffer with the draws of the block's next chunk of kChunk units while the
// advance lanes consume the current one (double-buffered, one barrier a
// chunk), Merton's and Bates's jump counts taken there against the block's
// Poisson table.  Each row is folded over the 128 advance lanes by
// block_store_moments' tree of a 128-thread block (unrolled), so the grids, the state
// grid and the rows keep the bits of one path a thread.  A grid of more
// than the family's kTrajSplitBlocks blocks an SM already fills the
// schedulers: there the launcher runs a kernel of its own, blocks of 128
// threads under their own launch bounds, each lane drawing a unit of its
// path and stepping it at once (the split's fewer resident paths lose
// there).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kFamilyThreads = 128;
// The dynamic shared memory a block of the NMC kernels may take for its
// staged pack and table: 12 KB, so the SM's 16 blocks of 128 threads (its
// 2,048 threads) still fit in its 228 KB.  A larger pack is read where it
// lies.
constexpr int kFamilySmemBudget = 12 * 1024;
// The most grids a family stores: the basket's d <= MAX_BASKET_D = 32.
constexpr int kMaxGrids = 32;

enum FamilyId {
  FAMILY_HESTON = 0, FAMILY_MERTON = 1, FAMILY_BATES = 2, FAMILY_CEV = 3,
  FAMILY_LOCALVOL = 4, FAMILY_SABR = 5, FAMILY_TERM = 6, FAMILY_VASICEK = 7,
  FAMILY_BASKET = 8, FAMILY_RAINBOW = 9
};

// A family's integer extras, by value (Merton's and Bates's i[0] = kmax,
// local vol's i[0] = K, the basket's and the rainbow's i[0] = d, the
// rainbow's i[1] its fold: 0 max, 1 min).
struct FamilyExtras {
  int i[4];
};

// The grids a call stores: Family::grid_count(p) where the family has one
// (a runtime count up to its capacity kGrids), else kGrids.
template <class Family, class = void>
struct RuntimeGrids : std::false_type {};
template <class Family>
struct RuntimeGrids<Family, std::void_t<decltype(&Family::grid_count)>> : std::true_type {};

template <class Family>
__device__ __forceinline__ int grid_count(const typename Family::Params& p) {
  if constexpr (RuntimeGrids<Family>::value) {
    return Family::grid_count(p);
  } else {
    return Family::kGrids;
  }
}

struct GridPtrs {
  const float* g[kMaxGrids];
};

struct GridOutPtrs {
  float* g[kMaxGrids];
};

// A family's legs in flight per thread: its own choice, or MC_FAMILY_LEGS
// where a build defines it (family_nmc_probe.py's sweeps).
constexpr int family_legs(int own) {
#ifdef MC_FAMILY_LEGS
  return static_cast<void>(own), MC_FAMILY_LEGS;
#else
  return own;
#endif
}

// The blocks of 128 threads an SM must hold, the register budget of the
// NMC kernels' __launch_bounds__: 1 lets ptxas size the registers to the
// code (under the bare __launch_bounds__(128) it held every family at 40
// to 64 and spilled Heston, SABR, Vasicek, the basket and the rainbow);
// budgets of 8 and 4 blocks were no faster for any family (PERF.md §6,
// family_nmc_probe.py's sweep).
// MC_FAMILY_MIN_BLOCKS sets another in a probe's build.
#ifdef MC_FAMILY_MIN_BLOCKS
constexpr int kFamilyMinBlocks = MC_FAMILY_MIN_BLOCKS;
#else
constexpr int kFamilyMinBlocks = 1;
#endif

// A family with a per-block table in shared memory (Merton's and Bates's
// Poisson cdf): table_floats(extras) floats after the staged pack,
// fill_table(p, table) run by thread 0, attach_table(p, table) on the
// sweep's parameters.
template <class Family, class = void>
struct FamilyTable : std::false_type {};
template <class Family>
struct FamilyTable<Family, std::void_t<decltype(&Family::table_floats)>> : std::true_type {};

template <class Family>
inline int family_table_floats(const FamilyExtras& extras) {
  if constexpr (FamilyTable<Family>::value) {
    return Family::table_floats(extras);
  } else {
    return 0;
  }
}

// The sweep's parameters: the packed vector's first stage_floats floats
// copied to dynamic shared memory and loaded from there (stage_floats = 0:
// the pack is read where it lies, through the same code), then the
// family's table built after them.  Every thread of the block calls it
// (one barrier).
template <class Family>
__device__ __forceinline__ typename Family::Params family_stage(const float* __restrict__ params,
                                                                const FamilyExtras& extras,
                                                                int n_steps, int stage_floats) {
  extern __shared__ float family_smem[];
  for (int i = threadIdx.x; i < stage_floats; i += kFamilyThreads) family_smem[i] = params[i];
  float* table = family_smem + stage_floats;
  if constexpr (FamilyTable<Family>::value) {
    if (threadIdx.x == 0) Family::fill_table(Family::load(params, extras, n_steps), table);
  }
  __syncthreads();
  typename Family::Params p = Family::load(stage_floats > 0 ? family_smem : params, extras,
                                           n_steps);
  if constexpr (FamilyTable<Family>::value) Family::attach_table(p, table);
  return p;
}

// The discounted inner mean at (path id, step j) from the grid rows g and
// payoff state st: the Kahan sum of the n_inner legs in order, run kLegs
// at a time (group q holds legs q*kLegs .. q*kLegs + kLegs-1, each on its
// own counters, n_groups = ceil(n_inner / kLegs)); the legs of a ragged
// last group past n_inner run and are not added (a block-uniform guard).
template <class Family, class Payoff>
__device__ __forceinline__ float family_point(const typename Family::Params& p, uint32_t ki0,
                                              uint32_t ki1, uint32_t id, int j, int n_steps,
                                              int n_inner, int n_groups,
                                              const float (&g)[Family::kGrids],
                                              const typename Payoff::State& st) {
  constexpr int kLegs = Family::kLegs;
  const int remaining = n_steps - j - 1;
  const uint32_t stride = Family::counter_stride(p, n_steps);
  // leg m's counters start at ((j+1)*n_inner + m) * stride
  uint32_t c_base = static_cast<uint32_t>(j + 1) * static_cast<uint32_t>(n_inner) * stride;
  float acc = 0.0f, comp = 0.0f;
  for (int q = 0; q < n_groups; ++q) {
    float pay[kLegs];
    Family::template inner_legs<Payoff>(p, ki0, ki1, id, c_base, stride, remaining, g, st, pay);
#pragma unroll
    for (int l = 0; l < kLegs; ++l) {
      if (q * kLegs + l < n_inner) {
        const float y = pay[l] - comp;
        const float t = acc + y;
        comp = (t - acc) - y;
        acc = t;
      }
    }
    c_base += static_cast<uint32_t>(kLegs) * stride;
  }
  const float inv_n = static_cast<float>(1.0 / static_cast<double>(n_inner));
  return (acc * inv_n) * Family::point_scale(p, g);
}

template <class Family, class Payoff>
__global__ void __launch_bounds__(kFamilyThreads, kFamilyMinBlocks)
family_fused_kernel(uint32_t ko0, uint32_t ko1, uint32_t ki0, uint32_t ki1,
                    const float* __restrict__ params, FamilyExtras extras, int n_steps,
                    int n_inner, int n_groups, int stage_floats, uint32_t n_paths,
                    uint32_t path_offset, uint32_t bound, int tiles,
                    float* __restrict__ surface, double* __restrict__ outer_partials) {
  // the outer steps read the pack where it lies, the sweep its staged copy
  const typename Family::Params po = Family::load(params, extras, n_steps);
  const typename Family::Params p = family_stage<Family>(params, extras, n_steps, stage_floats);
  const int j = blockIdx.x / tiles;  // the state after step j+1
  const int tile = blockIdx.x % tiles;
  const uint32_t local = static_cast<uint32_t>(tile) * kFamilyThreads + threadIdx.x;
  const bool in_range = local < n_paths;
  const uint32_t id = path_offset + local;
  const bool valid = in_range && id < bound;

  // The outer path up to step j+1, on the outer stream, in registers.
  auto c = Family::template outer_init<Payoff>(po);
  for (int i = 0; i <= j; ++i) Family::template outer_step<Payoff>(po, ko0, ko1, id, i, c);

  if (j == n_steps - 1) {  // block-uniform: the outer terminal moments
    const float pay = valid ? Family::template outer_pay<Payoff>(po, c) : 0.0f;
    const double acc[2] = {static_cast<double>(pay), static_cast<double>(pay * pay)};
    block_store_moments<2, kFamilyThreads>(acc,
                                           outer_partials + 2 * static_cast<size_t>(tile), 2);
  }

  float g[Family::kGrids];
  Family::template point<Payoff>(c, g);
  const float v = family_point<Family, Payoff>(p, ki0, ki1, id, j, n_steps, n_inner, n_groups,
                                               g, c.st);
  if (in_range) surface[static_cast<size_t>(j) * n_paths + local] = valid ? v : 0.0f;
}

template <class Family, class Payoff>
__global__ void __launch_bounds__(kFamilyThreads, kFamilyMinBlocks)
family_inner_kernel(uint32_t ki0, uint32_t ki1, const float* __restrict__ params,
                    FamilyExtras extras, int n_steps, int n_inner, int n_groups,
                    int stage_floats, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                    int tiles, GridPtrs grids, const float* __restrict__ state_grid,
                    float* __restrict__ surface) {
  const int j = blockIdx.x / tiles;  // the state after step j+1
  const int tile = blockIdx.x % tiles;
  const uint32_t local = static_cast<uint32_t>(tile) * kFamilyThreads + threadIdx.x;
  const bool in_range = local < n_paths;
  const size_t at = static_cast<size_t>(j) * n_paths + local;
  // the grid rows' loads are in flight while the block stages its pack
  float g[Family::kGrids];
  const int n_grids = grid_count<Family>(Family::load(params, extras, n_steps));
#pragma unroll
  for (int k = 0; k < Family::kGrids; ++k) {
    if (k < n_grids) g[k] = in_range ? grids.g[k][at] : 0.0f;
  }
  const float st0 = in_range && Payoff::kStates ? state_grid[at] : 0.0f;
  const typename Family::Params p = family_stage<Family>(params, extras, n_steps, stage_floats);
  if (!in_range) return;  // no block-wide step follows
  const uint32_t id = path_offset + local;
  typename Payoff::State st = Payoff::init(Family::payoff_params(p));
  if (Payoff::kStates) st.w[0] = st0;
  const float v = family_point<Family, Payoff>(p, ki0, ki1, id, j, n_steps, n_inner, n_groups,
                                               g, st);
  surface[at] = id < bound ? v : 0.0f;
}

// The words of one outer draw unit (a family's OuterDraw), in the family's
// layout.
template <int N>
struct DrawWords {
  float w[N];
};

// A family that draws fewer words than its OuterDraw holds (draw_words(p)).
template <class Family, class = void>
struct FamilyDrawWords : std::false_type {};
template <class Family>
struct FamilyDrawWords<Family, std::void_t<decltype(&Family::draw_words)>> : std::true_type {};

// The trajectories kernel's draw warps (PERF.md §6: 12 beat 4 and none).
// A family splits its draws off on grids of at most Family::kTrajSplitBlocks
// blocks an SM of the card (traj_split), where the blocks' warps leave the
// SMs' schedulers idle; a larger grid fills the SMs with blocks of one
// thread a path, whose more resident paths there beat the split's (the
// crossover lies between 2 and 3 blocks an SM, past 3 where the draw is most
// of a step; 0: never split).
constexpr int kTrajDrawWarps = 12;
static_assert(kTrajDrawWarps > 0, "a split block draws in its draw warps only");
// The shared bytes of the two draw buffers (with the table, up to 1 KB,
// and the fold's 2 KB under the 48 KB a block takes without opting in).
constexpr int kTrajBufferBytes = 40 * 1024;

// The trajectories kernel's launch geometry under Family: kFamilyThreads
// paths a block, one advance lane each, and kDrawWarps draw warps; a chunk
// of kChunk draw units, kWords floats each, a buffer of kBufferFloats
// (both halves) in dynamic shared memory before the family's table.  A
// chunk holds as many units as fit, rounded down to a multiple of
// kDrawWarps/4 (where one fits), so its kChunk*kFamilyThreads draws
// spread evenly over the draw warps' threads.
template <class Family>
struct TrajGeometry {
  using Draw = typename Family::OuterDraw;
  static constexpr int kWords = static_cast<int>(sizeof(Draw) / sizeof(float));
  static constexpr int kDrawWarps = kTrajDrawWarps;
  static constexpr int kThreads = kFamilyThreads + 32 * kDrawWarps;
  static constexpr int kFit = kTrajBufferBytes / (2 * kFamilyThreads * sizeof(Draw));
  static constexpr int kGroup = kDrawWarps >= 8 ? kDrawWarps / 4 : 1;
  static constexpr int kChunk = kFit >= kGroup ? kFit / kGroup * kGroup : (kFit > 1 ? kFit : 1);
  static constexpr int kBufferFloats = 2 * kChunk * kWords * kFamilyThreads;
};

// Draw unit u of path id: the family's draw, its Poisson uniforms turned
// into their counts against the block's table where the family has one.  Out
// of line, one copy in a source serves both trajectories kernels of every
// payoff (the draw is their larger code: inlined, the second kernel a payoff
// cost the build ~40 CPU-seconds, PERF.md §6).
template <class Family>
__device__ __noinline__ typename Family::OuterDraw family_draw(const typename Family::Params& p,
                                                               uint32_t k0, uint32_t k1,
                                                               uint32_t id, int u) {
  typename Family::OuterDraw d;
  Family::outer_draw(p, k0, k1, id, static_cast<uint32_t>(u), d);
  if constexpr (FamilyTable<Family>::value) Family::draw_counts(p, d);
  return d;
}

// The words of OuterDraw a call draws.
template <class Family>
__device__ __forceinline__ int family_draw_words(const typename Family::Params& p) {
  if constexpr (FamilyDrawWords<Family>::value) {
    return Family::draw_words(p);
  } else {
    return TrajGeometry<Family>::kWords;
  }
}

// Unit u's steps j = u*kStepsPerDraw, ... (those below n_steps) of path i
// from its draw d: each advanced on family_draw's words, its grids and
// payoff state word 0 stored at j*n_paths + i.
template <class Family, class Payoff>
__device__ __forceinline__ void traj_advance_unit(const typename Family::Params& p, int u,
                                                  const typename Family::OuterDraw& d,
                                                  typename Family::template Carry<Payoff>& c,
                                                  int n_steps, int n_grids, uint32_t n_paths,
                                                  uint64_t i, const GridOutPtrs& grids,
                                                  float* __restrict__ state_grid) {
  constexpr int S = Family::kStepsPerDraw;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = u * S + s;
    if (S == 1 || j < n_steps) {
      if constexpr (FamilyTable<Family>::value) {
        Family::template outer_advance_counted<Payoff>(p, j, d, c);
      } else {
        Family::template outer_advance<Payoff>(p, j, d, c);
      }
      float g[Family::kGrids];
      Family::template point<Payoff>(c, g);
      const size_t at = static_cast<size_t>(j) * n_paths + i;
#pragma unroll
      for (int k = 0; k < Family::kGrids; ++k) {
        if (k < n_grids) grids.g[k][at] = g[k];
      }
      state_grid[at] = Payoff::kStates ? c.st.w[0] : 0.0f;
    }
  }
}

// The family's outer paths, kFamilyThreads a block over a grid-stride loop
// of rounds (path i = round base + lane): its kGrids grids and payoff state
// word 0 stored after each step, step-major (entry j*n_paths + i), and one
// f64 row of [sum pay, sum pay^2] per block, folded over the advance lanes.
// kSplit (the launcher's choice, traj_split): the block's draw warps run a
// round's units in chunks of kChunk, filling chunk 0, then, a barrier a
// chunk, chunk q+1 into one buffer half (word f of unit ul and lane at
// ((half*kChunk + ul)*kWords + f)*kFamilyThreads + lane) while the advance
// lanes step through chunk q in the other.  Else a block of kFamilyThreads
// runs each path in its thread, a unit at a time, drawn and stepped at once.
template <class Family, class Payoff, bool kSplit>
__global__ void __launch_bounds__(kSplit ? TrajGeometry<Family>::kThreads : kFamilyThreads)
family_trajectories_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params,
                           FamilyExtras extras, int n_steps, uint32_t n_paths,
                           uint32_t path_offset, uint32_t bound, GridOutPtrs grids,
                           float* __restrict__ state_grid, double* __restrict__ partials) {
  using G = TrajGeometry<Family>;
  using Draw = typename Family::OuterDraw;
  extern __shared__ float family_smem[];  // the draw buffer's halves, the table
  typename Family::Params p = Family::load(params, extras, n_steps);
  if constexpr (FamilyTable<Family>::value) {
    float* table = family_smem + (kSplit ? G::kBufferFloats : 0);
    if (threadIdx.x == 0) Family::fill_table(p, table);
    __syncthreads();
    Family::attach_table(p, table);
  }
  const int n_grids = grid_count<Family>(p);
  const int words = family_draw_words<Family>(p);
  const int n_units = (n_steps + Family::kStepsPerDraw - 1) / Family::kStepsPerDraw;
  const int n_chunks = (n_units + G::kChunk - 1) / G::kChunk;
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kFamilyThreads;
  for (uint64_t base = static_cast<uint64_t>(blockIdx.x) * kFamilyThreads; base < n_paths;
       base += stride) {  // block-uniform
    const uint64_t i = base + threadIdx.x;
    const bool mine = threadIdx.x < kFamilyThreads && i < n_paths;
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    typename Family::template Carry<Payoff> c;
    if (mine) c = Family::template outer_init<Payoff>(p);
    if constexpr (kSplit) {
      // iteration q draws chunk q+1 (chunk 0 at q = -1) and steps through
      // chunk q
      for (int q = -1; q < n_chunks; ++q) {
        // a draw thread's items drawer, drawer + 32*kDrawWarps, ... of the
        // chunk's kChunk*kFamilyThreads
        for (int it = static_cast<int>(threadIdx.x) - kFamilyThreads;
             it >= 0 && q + 1 < n_chunks && it < G::kChunk * kFamilyThreads;
             it += 32 * G::kDrawWarps) {
          const int ul = it / kFamilyThreads, lane = it % kFamilyThreads;
          const int u = (q + 1) * G::kChunk + ul;
          const uint64_t at = base + static_cast<uint64_t>(lane);
          if (u < n_units && at < n_paths) {
            const Draw d =
                family_draw<Family>(p, k0, k1, path_offset + static_cast<uint32_t>(at), u);
            float* out = family_smem +
                         static_cast<size_t>((((q + 1) & 1) * G::kChunk + ul) * G::kWords) *
                             kFamilyThreads +
                         lane;
#pragma unroll
            for (int f = 0; f < G::kWords; ++f) {
              if (f < words) out[f * kFamilyThreads] = d.w[f];
            }
          }
        }
        if (q >= 0 && mine) {
          const float* in = family_smem +
                            static_cast<size_t>((q & 1) * G::kChunk * G::kWords) *
                                kFamilyThreads +
                            threadIdx.x;
          for (int ul = 0; ul < G::kChunk; ++ul) {
            const int u = q * G::kChunk + ul;
            if (u >= n_units) break;  // block-uniform
            Draw d;
#pragma unroll
            for (int f = 0; f < G::kWords; ++f) {
              if (f < words) d.w[f] = in[(ul * G::kWords + f) * kFamilyThreads];
            }
            traj_advance_unit<Family, Payoff>(p, u, d, c, n_steps, n_grids, n_paths, i, grids,
                                              state_grid);
          }
        }
        __syncthreads();  // chunk q read, chunk q+1 written
      }
    } else if (mine) {  // the lane's own path
      for (int u = 0; u < n_units; ++u) {
        const Draw d = family_draw<Family>(p, k0, k1, id, u);
        traj_advance_unit<Family, Payoff>(p, u, d, c, n_steps, n_grids, n_paths, i, grids,
                                          state_grid);
      }
    }
    if (mine) {
      const float pv[1] = {Family::template outer_pay<Payoff>(p, c)};
      add_moments(acc, pv, id < bound);
    }
  }
  block_store_moments_unrolled<2, kFamilyThreads>(acc,
                                                  partials + 2 * static_cast<size_t>(blockIdx.x));
}

// Blocks of the NMC kernels: one per (step, tile of kFamilyThreads outer
// paths), step-major.
inline long long family_blocks(uint32_t n_paths, int n_steps, int* tiles) {
  *tiles = static_cast<int>((n_paths + kFamilyThreads - 1) / kFamilyThreads);
  return static_cast<long long>(*tiles) * n_steps;
}

// The dynamic shared memory of a call: the staged pack and the family's
// table, refused past kFamilySmemBudget; and the group count, refused unless
// it is ceil(n_inner / kLegs) (the caller computes both, nmc_engine.py
// family_launch).
template <class Family>
cudaError_t family_geometry(const FamilyExtras& extras, int n_inner, int n_groups,
                            int stage_floats, size_t* smem) {
  const long long floats =
      static_cast<long long>(stage_floats) + family_table_floats<Family>(extras);
  if (stage_floats < 0 || 4 * floats > kFamilySmemBudget || n_inner < 1 ||
      n_groups != (n_inner + Family::kLegs - 1) / Family::kLegs) {
    return cudaErrorInvalidValue;
  }
  *smem = static_cast<size_t>(4 * floats);
  return cudaSuccess;
}

template <class Family, class Payoff>
cudaError_t launch_family_fused(uint32_t ko0, uint32_t ko1, uint32_t ki0, uint32_t ki1,
                                const float* params, FamilyExtras extras, int n_steps,
                                int n_inner, int n_groups, int stage_floats, uint32_t n_paths,
                                uint32_t path_offset, uint32_t bound, float* surface,
                                double* outer_partials, cudaStream_t stream) {
  int tiles;
  size_t smem;
  const long long n_blocks = family_blocks(n_paths, n_steps, &tiles);
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const cudaError_t ok = family_geometry<Family>(extras, n_inner, n_groups, stage_floats, &smem);
  if (ok != cudaSuccess) return ok;
  family_fused_kernel<Family, Payoff>
      <<<static_cast<unsigned>(n_blocks), kFamilyThreads, smem, stream>>>(
          ko0, ko1, ki0, ki1, params, extras, n_steps, n_inner, n_groups, stage_floats,
          n_paths, path_offset, bound, tiles, surface, outer_partials);
  return cudaGetLastError();
}

template <class Family, class Payoff>
cudaError_t launch_family_inner(uint32_t ki0, uint32_t ki1, const float* params,
                                FamilyExtras extras, int n_steps, int n_inner, int n_groups,
                                int stage_floats, uint32_t n_paths, uint32_t path_offset,
                                uint32_t bound, const GridPtrs& grids, const float* state_grid,
                                float* surface, cudaStream_t stream) {
  int tiles;
  size_t smem;
  const long long n_blocks = family_blocks(n_paths, n_steps, &tiles);
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const cudaError_t ok = family_geometry<Family>(extras, n_inner, n_groups, stage_floats, &smem);
  if (ok != cudaSuccess) return ok;
  family_inner_kernel<Family, Payoff>
      <<<static_cast<unsigned>(n_blocks), kFamilyThreads, smem, stream>>>(
          ki0, ki1, params, extras, n_steps, n_inner, n_groups, stage_floats, n_paths,
          path_offset, bound, tiles, grids, state_grid, surface);
  return cudaGetLastError();
}

// The SMs of the current card (read once).
inline int traj_sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

// Whether a grid of n_blocks runs the draw warps (kTrajDrawWarps).
template <class Family>
inline bool traj_split(long long n_blocks) {
  return n_blocks <= static_cast<long long>(Family::kTrajSplitBlocks) * traj_sm_count();
}

// The trajectories kernel's block: its threads, and its dynamic shared
// memory (the draw buffer's two halves where it splits; the family's
// table).
template <class Family>
inline int traj_threads(bool split) {
  return split ? TrajGeometry<Family>::kThreads : kFamilyThreads;
}

template <class Family>
inline size_t traj_smem_bytes(const FamilyExtras& extras, bool split) {
  const long long table = family_table_floats<Family>(extras);
  return sizeof(float) *
         static_cast<size_t>((split ? TrajGeometry<Family>::kBufferFloats : 0) +
                             (table > 0 ? table : 0));
}

// The launch on a grid of n_blocks, and its resident blocks per SM; a
// family whose kTrajSplitBlocks is 0 instantiates no split kernel.
template <class Family, class Payoff>
cudaError_t launch_family_trajectories(uint32_t k0, uint32_t k1, const float* params,
                                       FamilyExtras extras, int n_steps, uint32_t n_paths,
                                       uint32_t path_offset, uint32_t bound,
                                       const GridOutPtrs& grids, float* state_grid,
                                       double* partials, int n_blocks, cudaStream_t stream) {
  if constexpr (Family::kTrajSplitBlocks > 0) {
    if (traj_split<Family>(n_blocks)) {
      family_trajectories_kernel<Family, Payoff, true>
          <<<n_blocks, traj_threads<Family>(true), traj_smem_bytes<Family>(extras, true),
             stream>>>(k0, k1, params, extras, n_steps, n_paths, path_offset, bound, grids,
                       state_grid, partials);
      return cudaGetLastError();
    }
  }
  family_trajectories_kernel<Family, Payoff, false>
      <<<n_blocks, kFamilyThreads, traj_smem_bytes<Family>(extras, false), stream>>>(
          k0, k1, params, extras, n_steps, n_paths, path_offset, bound, grids, state_grid,
          partials);
  return cudaGetLastError();
}

template <class Family, class Payoff>
cudaError_t family_trajectories_occupancy(const FamilyExtras& extras, int n_blocks,
                                          int* blocks) {
  if constexpr (Family::kTrajSplitBlocks > 0) {
    if (traj_split<Family>(n_blocks)) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, family_trajectories_kernel<Family, Payoff, true>, traj_threads<Family>(true),
          traj_smem_bytes<Family>(extras, true));
    }
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, family_trajectories_kernel<Family, Payoff, false>, kFamilyThreads,
      traj_smem_bytes<Family>(extras, false));
}

// The payoff switch of each family's launchers (the one-word payoffs, the
// ones a grid can resume).  A family's source instantiates them through the
// launchers declared below, which the entry points of family_nmc_kernels.cu
// call per family, so each family's kernels compile in its own source.
template <class Family>
cudaError_t family_fused_switch(int payoff_id, uint32_t ko0, uint32_t ko1, uint32_t ki0,
                                uint32_t ki1, const float* params, FamilyExtras extras,
                                int n_steps, int n_inner, int n_groups, int stage_floats,
                                uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                float* surface, double* outer_partials, cudaStream_t stream) {
#define MC_CASE(ID, PAYOFF)                                                              \
  case ID:                                                                               \
    return launch_family_fused<Family, PAYOFF>(ko0, ko1, ki0, ki1, params, extras,       \
                                               n_steps, n_inner, n_groups, stage_floats, \
                                               n_paths, path_offset, bound, surface,     \
                                               outer_partials, stream);
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

template <class Family>
cudaError_t family_inner_switch(int payoff_id, uint32_t ki0, uint32_t ki1, const float* params,
                                FamilyExtras extras, int n_steps, int n_inner, int n_groups,
                                int stage_floats, uint32_t n_paths, uint32_t path_offset,
                                uint32_t bound, const GridPtrs& grids, const float* state_grid,
                                float* surface, cudaStream_t stream) {
#define MC_CASE(ID, PAYOFF)                                                              \
  case ID:                                                                               \
    return launch_family_inner<Family, PAYOFF>(ki0, ki1, params, extras, n_steps,        \
                                               n_inner, n_groups, stage_floats, n_paths, \
                                               path_offset, bound, grids, state_grid,    \
                                               surface, stream);
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

template <class Family>
cudaError_t family_trajectories_switch(int payoff_id, uint32_t k0, uint32_t k1,
                                       const float* params, FamilyExtras extras, int n_steps,
                                       uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                       const GridOutPtrs& grids, float* state_grid,
                                       double* partials, int n_blocks, cudaStream_t stream) {
#define MC_CASE(ID, PAYOFF)                                                              \
  case ID:                                                                               \
    return launch_family_trajectories<Family, PAYOFF>(k0, k1, params, extras, n_steps,   \
                                                      n_paths, path_offset, bound,       \
                                                      grids, state_grid, partials,       \
                                                      n_blocks, stream);
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

template <class Family>
cudaError_t family_trajectories_occupancy_switch(int payoff_id, const FamilyExtras& extras,
                                                 int n_blocks, int* blocks) {
#define MC_CASE(ID, PAYOFF) \
  case ID: return family_trajectories_occupancy<Family, PAYOFF>(extras, n_blocks, blocks);
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

template <class Family>
cudaError_t family_occupancy_switch(int payoff_id, int fused, int smem_bytes, int* blocks) {
#define MC_CASE(ID, PAYOFF)                                                              \
  case ID:                                                                               \
    return fused ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(                        \
                       blocks, family_fused_kernel<Family, PAYOFF>, kFamilyThreads,      \
                       static_cast<size_t>(smem_bytes))                                  \
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(                        \
                       blocks, family_inner_kernel<Family, PAYOFF>, kFamilyThreads,      \
                       static_cast<size_t>(smem_bytes));
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

// Each family's launchers, defined in its own source as calls of the
// switches above on its family struct; PREFIX_occupancy gives the resident
// blocks per SM of the fused (fused = 1) or inner kernel at smem_bytes of
// dynamic shared memory, PREFIX_trajectories_occupancy those of the
// trajectories kernel on a grid of n_blocks and PREFIX_trajectories_geometry
// its threads a block and dynamic shared bytes there.
#define MC_FAMILY_LAUNCHERS(PREFIX)                                                       \
  cudaError_t PREFIX##_fused(int payoff_id, uint32_t ko0, uint32_t ko1, uint32_t ki0,      \
                             uint32_t ki1, const float* params, FamilyExtras extras,       \
                             int n_steps, int n_inner, int n_groups, int stage_floats,     \
                             uint32_t n_paths, uint32_t path_offset, uint32_t bound,       \
                             float* surface, double* outer_partials, cudaStream_t stream); \
  cudaError_t PREFIX##_inner(int payoff_id, uint32_t ki0, uint32_t ki1,                    \
                             const float* params, FamilyExtras extras, int n_steps,        \
                             int n_inner, int n_groups, int stage_floats,                  \
                             uint32_t n_paths, uint32_t path_offset, uint32_t bound,       \
                             const GridPtrs& grids, const float* state_grid,               \
                             float* surface, cudaStream_t stream);                         \
  cudaError_t PREFIX##_trajectories(int payoff_id, uint32_t k0, uint32_t k1,               \
                                    const float* params, FamilyExtras extras, int n_steps, \
                                    uint32_t n_paths, uint32_t path_offset, uint32_t bound,\
                                    const GridOutPtrs& grids, float* state_grid,           \
                                    double* partials, int n_blocks, cudaStream_t stream);  \
  cudaError_t PREFIX##_occupancy(int payoff_id, FamilyExtras extras, int fused,        \
                                 int smem_bytes, int* blocks);                            \
  cudaError_t PREFIX##_trajectories_occupancy(int payoff_id, FamilyExtras extras,         \
                                              int n_blocks, int* blocks);                 \
  cudaError_t PREFIX##_trajectories_geometry(FamilyExtras extras, int n_blocks,           \
                                             int* threads, int* smem_bytes);
MC_FAMILY_LAUNCHERS(heston_family)
MC_FAMILY_LAUNCHERS(merton_family)
MC_FAMILY_LAUNCHERS(bates_family)
MC_FAMILY_LAUNCHERS(cev_family)
MC_FAMILY_LAUNCHERS(localvol_family)
MC_FAMILY_LAUNCHERS(sabr_family)
MC_FAMILY_LAUNCHERS(term_family)
MC_FAMILY_LAUNCHERS(vasicek_family)
MC_FAMILY_LAUNCHERS(basket_family)
MC_FAMILY_LAUNCHERS(basket8_family)
MC_FAMILY_LAUNCHERS(basket32_family)
MC_FAMILY_LAUNCHERS(rainbow_family)
MC_FAMILY_LAUNCHERS(rainbow8_family)
MC_FAMILY_LAUNCHERS(rainbow32_family)
#undef MC_FAMILY_LAUNCHERS

// The definitions of PREFIX's NMC launchers (fused, inner, occupancy) as the
// switches above on FAMILY; MC_DEFINE_FAMILY_LAUNCHERS adds the generic
// trajectories (the launch, its occupancy and geometry).  The basket's and
// the rainbow's come one per capacity, capacity 32 in a source of its own
// (<family>_nmc32_kernels.cu) so the build's heaviest instantiations compile
// in parallel.
#define MC_DEFINE_FAMILY_NMC(PREFIX, FAMILY)                                              \
  cudaError_t PREFIX##_fused(int payoff_id, uint32_t ko0, uint32_t ko1, uint32_t ki0,      \
                             uint32_t ki1, const float* params, FamilyExtras extras,       \
                             int n_steps, int n_inner, int n_groups, int stage_floats,     \
                             uint32_t n_paths, uint32_t path_offset, uint32_t bound,       \
                             float* surface, double* outer_partials,                       \
                             cudaStream_t stream) {                                        \
    return family_fused_switch<FAMILY>(payoff_id, ko0, ko1, ki0, ki1, params, extras,      \
                                      n_steps, n_inner, n_groups, stage_floats, n_paths,  \
                                      path_offset, bound, surface, outer_partials,        \
                                      stream);                                            \
  }                                                                                       \
  cudaError_t PREFIX##_inner(int payoff_id, uint32_t ki0, uint32_t ki1,                    \
                             const float* params, FamilyExtras extras, int n_steps,        \
                             int n_inner, int n_groups, int stage_floats,                  \
                             uint32_t n_paths, uint32_t path_offset, uint32_t bound,       \
                             const GridPtrs& grids, const float* state_grid,               \
                             float* surface, cudaStream_t stream) {                        \
    return family_inner_switch<FAMILY>(payoff_id, ki0, ki1, params, extras, n_steps,       \
                                      n_inner, n_groups, stage_floats, n_paths,           \
                                      path_offset, bound, grids, state_grid, surface,     \
                                      stream);                                            \
  }                                                                                       \
  cudaError_t PREFIX##_occupancy(int payoff_id, FamilyExtras, int fused, int smem_bytes,   \
                                 int* blocks) {                                           \
    return family_occupancy_switch<FAMILY>(payoff_id, fused, smem_bytes, blocks);         \
  }

#define MC_DEFINE_FAMILY_LAUNCHERS(PREFIX, FAMILY)                                        \
  MC_DEFINE_FAMILY_NMC(PREFIX, FAMILY)                                                    \
  cudaError_t PREFIX##_trajectories(int payoff_id, uint32_t k0, uint32_t k1,               \
                                    const float* params, FamilyExtras extras, int n_steps, \
                                    uint32_t n_paths, uint32_t path_offset, uint32_t bound,\
                                    const GridOutPtrs& grids, float* state_grid,           \
                                    double* partials, int n_blocks, cudaStream_t stream) { \
    return family_trajectories_switch<FAMILY>(payoff_id, k0, k1, params, extras, n_steps,  \
                                             n_paths, path_offset, bound, grids,          \
                                             state_grid, partials, n_blocks, stream);     \
  }                                                                                       \
  cudaError_t PREFIX##_trajectories_occupancy(int payoff_id, FamilyExtras extras,         \
                                              int n_blocks, int* blocks) {                \
    return family_trajectories_occupancy_switch<FAMILY>(payoff_id, extras, n_blocks,      \
                                                        blocks);                          \
  }                                                                                       \
  cudaError_t PREFIX##_trajectories_geometry(FamilyExtras extras, int n_blocks,           \
                                             int* threads, int* smem_bytes) {             \
    const bool split = traj_split<FAMILY>(n_blocks);                                      \
    *threads = traj_threads<FAMILY>(split);                                               \
    *smem_bytes = static_cast<int>(traj_smem_bytes<FAMILY>(extras, split));               \
    return cudaSuccess;                                                                   \
  }

}  // namespace mc
