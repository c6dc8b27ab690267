// The family nested-MC kernels of the port, for sm_90a.
//
// family_inner_kernel replaces mc_tpu/nmc_engine.py family_inner_kernel (the
// Pallas call at :331), the grid strategy over a family's stored grids;
// family_fused_kernel replaces family_fused_kernel (the Pallas call at
// :426), which simulates the outer paths itself.  Both are templates over a
// device-side family whose interface mirrors NMCFamily (nmc_engine.py):
//   Params, load(ptr)                  the packed parameters;
//   kGrids                             market-state grids (S first);
//   Carry<Payoff>, outer_init(p)       the outer path's carry and its start;
//   outer_step<Payoff>(p, k0, k1, id, j, c)
//                                      one outer step j on the outer stream;
//   point(c, g), outer_pay(p, c)       the grid rows of a carry, its payoff;
//   inner_leg<Payoff>(p, k0, k1, id, c_base, remaining, g, st)
//                                      an inner leg resumed from the rows g and
//                                      payoff state st, `remaining` substeps,
//                                      substep u on counter c_base + u;
//   point_scale(p, g)                  the factor on the inner mean;
//   counter_stride(n_steps)            the counter budget of one inner leg.
// Heston is the only family so far (its grids S and v); a later family adds
// its struct and a case to the entry points' switch.
//
// For outer path i and step j, surface[j, i] = point_scale * (1/n_inner) *
// the f32 Kahan sum over m = 0..n_inner-1, in that order, of inner leg m,
// counters c_base = ((j+1)*n_inner + m) * counter_stride: mc_tpu's
// family_point_tile, whose order is part of its bitwise contract.  The
// outer moments [sum pay, sum pay^2] of the fused kernel come from its
// j = n_steps-1 blocks, one f64 row per tile.
//
// What bounds it on the H100: the inner sweep, n_paths * n_inner *
// n_steps(n_steps-1)/2 substeps, each one threefry-13 pair, the Box-Muller
// transcendentals, a sqrtf and an expf.  Bytes are negligible (the surface,
// and 12 bytes a point of grids for the inner kernel).
//
// Design (that of nmc_kernels.cu): one block per (step j, tile of 128 outer
// paths), step-major, so the largest remaining work (j = 0) is issued first
// and the short blocks fill the tail; all threads of a block share j, so the
// inner loops never diverge.  The fused kernel recomputes the outer path up
// to step j+1 in registers through the family's outer step (for Heston
// heston_outer_step, the trajectories kernel's step), j+1 steps against
// the sweep's n_inner*(n_steps-j-1), and keeps no history; so the grid and
// fused strategies give bitwise equal surfaces.

#include <cstdint>

#include <cuda_runtime.h>

#include "heston.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kFamilyThreads = 128;
constexpr int kMaxGrids = 8;

enum FamilyId { FAMILY_HESTON = 0 };

struct GridPtrs {
  const float* g[kMaxGrids];
};

// Heston: grids (S, v); the inner legs run full-truncation Euler from
// (S_j, v_j) with w from 0 and S = S_j exp(w), one threefry-13 pair per
// substep (mc_tpu/nmc_heston.py:58-73).
struct HestonFamily {
  using Params = HestonParams;
  static constexpr int kGrids = 2;

  template <class Payoff>
  struct Carry {
    float w, v, s;
    typename Payoff::State st;
  };

  __device__ static Params load(const float* __restrict__ params) {
    return load_heston(params);
  }
  __device__ static const mc::Params& payoff_params(const Params& h) { return h.pay; }

  template <class Payoff>
  __device__ static Carry<Payoff> outer_init(const Params& h) {
    return Carry<Payoff>{0.0f, h.v0, h.pay.s0, Payoff::init(h.pay)};
  }
  template <class Payoff>
  __device__ static void outer_step(const Params& h, uint32_t k0, uint32_t k1, uint32_t id,
                                    int j, Carry<Payoff>& c) {
    heston_outer_step<Payoff>(h, k0, k1, id, j, c.w, c.v, c.s, c.st);
  }
  template <class Payoff>
  __device__ static void point(const Carry<Payoff>& c, float (&g)[kGrids]) {
    g[0] = c.s;
    g[1] = c.v;
  }
  template <class Payoff>
  __device__ static float outer_pay(const Params& h, const Carry<Payoff>& c) {
    return Payoff::terminal(c.st, c.s, h.pay);
  }
  template <class Payoff>
  __device__ static float inner_leg(const Params& h, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t c_base, int remaining, const float (&g)[kGrids],
                                    typename Payoff::State st) {
    float w = 0.0f, v = g[1], s = g[0];
    for (int u = 0; u < remaining; ++u) {
      float z_v, z_perp;
      normal_pair<13>(k0, k1, id, c_base + static_cast<uint32_t>(u), z_v, z_perp);
      heston_euler_step(h, z_v, z_perp, w, v);
      s = g[0] * expf(w);
      st = Payoff::update(st, s, h.pay);
    }
    return Payoff::terminal(st, s, h.pay);
  }
  __device__ static float point_scale(const Params& h, const float (&)[kGrids]) {
    return expf(-h.pay.r * h.pay.t);  // the full e^{-rT}, as nmc.cuh:100-104
  }
  __host__ __device__ static uint32_t counter_stride(int n_steps) {
    return static_cast<uint32_t>(n_steps);
  }
};

// The discounted inner mean at (path id, step j) from the grid rows g and
// payoff state st: the Kahan sum of the n_inner legs in order.
template <class Family, class Payoff>
__device__ float family_point(const typename Family::Params& p, uint32_t ki0, uint32_t ki1,
                              uint32_t id, int j, int n_steps, int n_inner,
                              const float (&g)[Family::kGrids],
                              const typename Payoff::State& st) {
  const int remaining = n_steps - j - 1;
  const uint32_t t_base = static_cast<uint32_t>(j + 1) * static_cast<uint32_t>(n_inner);
  const uint32_t stride = Family::counter_stride(n_steps);
  float acc = 0.0f, comp = 0.0f;
  for (int m = 0; m < n_inner; ++m) {
    const uint32_t c_base = (t_base + static_cast<uint32_t>(m)) * stride;
    const float pay = Family::template inner_leg<Payoff>(p, ki0, ki1, id, c_base, remaining,
                                                         g, st);
    const float y = pay - comp;
    const float t = acc + y;
    comp = (t - acc) - y;
    acc = t;
  }
  const float inv_n = static_cast<float>(1.0 / static_cast<double>(n_inner));
  return (acc * inv_n) * Family::point_scale(p, g);
}

template <class Family, class Payoff>
__global__ void __launch_bounds__(kFamilyThreads)
family_fused_kernel(uint32_t ko0, uint32_t ko1, uint32_t ki0, uint32_t ki1,
                    const float* __restrict__ params, int n_steps, int n_inner,
                    uint32_t n_paths, uint32_t path_offset, uint32_t bound, int tiles,
                    float* __restrict__ surface, double* __restrict__ outer_partials) {
  const typename Family::Params p = Family::load(params);
  const int j = blockIdx.x / tiles;  // the state after step j+1
  const int tile = blockIdx.x % tiles;
  const uint32_t local = static_cast<uint32_t>(tile) * kFamilyThreads + threadIdx.x;
  const bool in_range = local < n_paths;
  const uint32_t id = path_offset + local;
  const bool valid = in_range && id < bound;

  // The outer path up to step j+1, on the outer stream, in registers.
  auto c = Family::template outer_init<Payoff>(p);
  for (int i = 0; i <= j; ++i) Family::template outer_step<Payoff>(p, ko0, ko1, id, i, c);

  if (j == n_steps - 1) {  // block-uniform: the outer terminal moments
    const float pay = valid ? Family::template outer_pay<Payoff>(p, c) : 0.0f;
    const double acc[2] = {static_cast<double>(pay), static_cast<double>(pay * pay)};
    block_store_moments<2, kFamilyThreads>(acc,
                                           outer_partials + 2 * static_cast<size_t>(tile), 2);
  }

  float g[Family::kGrids];
  Family::template point<Payoff>(c, g);
  const float v = family_point<Family, Payoff>(p, ki0, ki1, id, j, n_steps, n_inner, g, c.st);
  if (in_range) surface[static_cast<size_t>(j) * n_paths + local] = valid ? v : 0.0f;
}

template <class Family, class Payoff>
__global__ void __launch_bounds__(kFamilyThreads)
family_inner_kernel(uint32_t ki0, uint32_t ki1, const float* __restrict__ params,
                    int n_steps, int n_inner, uint32_t n_paths, uint32_t path_offset,
                    uint32_t bound, int tiles, GridPtrs grids,
                    const float* __restrict__ state_grid, float* __restrict__ surface) {
  const typename Family::Params p = Family::load(params);
  const int j = blockIdx.x / tiles;  // the state after step j+1
  const int tile = blockIdx.x % tiles;
  const uint32_t local = static_cast<uint32_t>(tile) * kFamilyThreads + threadIdx.x;
  if (local >= n_paths) return;  // no block-wide step follows
  const uint32_t id = path_offset + local;
  const size_t at = static_cast<size_t>(j) * n_paths + local;
  float g[Family::kGrids];
#pragma unroll
  for (int k = 0; k < Family::kGrids; ++k) g[k] = grids.g[k][at];
  typename Payoff::State st = Payoff::init(Family::payoff_params(p));
  if (Payoff::kStates) st.w[0] = state_grid[at];
  const float v = family_point<Family, Payoff>(p, ki0, ki1, id, j, n_steps, n_inner, g, st);
  surface[at] = id < bound ? v : 0.0f;
}

// Blocks: one per (step, tile of kFamilyThreads outer paths), step-major.
inline long long family_blocks(uint32_t n_paths, int n_steps, int* tiles) {
  *tiles = static_cast<int>((n_paths + kFamilyThreads - 1) / kFamilyThreads);
  return static_cast<long long>(*tiles) * n_steps;
}

template <class Family, class Payoff>
cudaError_t launch_family_fused(uint32_t ko0, uint32_t ko1, uint32_t ki0, uint32_t ki1,
                                const float* params, int n_steps, int n_inner,
                                uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                float* surface, double* outer_partials, cudaStream_t stream) {
  int tiles;
  const long long n_blocks = family_blocks(n_paths, n_steps, &tiles);
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  family_fused_kernel<Family, Payoff>
      <<<static_cast<unsigned>(n_blocks), kFamilyThreads, 0, stream>>>(
          ko0, ko1, ki0, ki1, params, n_steps, n_inner, n_paths, path_offset, bound, tiles,
          surface, outer_partials);
  return cudaGetLastError();
}

template <class Family, class Payoff>
cudaError_t launch_family_inner(uint32_t ki0, uint32_t ki1, const float* params, int n_steps,
                                int n_inner, uint32_t n_paths, uint32_t path_offset,
                                uint32_t bound, const GridPtrs& grids, const float* state_grid,
                                float* surface, cudaStream_t stream) {
  int tiles;
  const long long n_blocks = family_blocks(n_paths, n_steps, &tiles);
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  family_inner_kernel<Family, Payoff>
      <<<static_cast<unsigned>(n_blocks), kFamilyThreads, 0, stream>>>(
          ki0, ki1, params, n_steps, n_inner, n_paths, path_offset, bound, tiles, grids,
          state_grid, surface);
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_family_block_threads() { return mc::kFamilyThreads; }

int mc_family_fused(int family_id, int payoff_id, uint32_t ko0, uint32_t ko1, uint32_t ki0,
                    uint32_t ki1, const float* params, int n_steps, int n_inner,
                    uint32_t n_paths, uint32_t path_offset, uint32_t bound, float* surface,
                    double* outer_partials, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (family_id != mc::FAMILY_HESTON) return cudaErrorInvalidValue;
#define MC_CASE(ID, PAYOFF)                                                              \
  case mc::ID:                                                                           \
    return mc::launch_family_fused<mc::HestonFamily, mc::PAYOFF>(                        \
        ko0, ko1, ki0, ki1, params, n_steps, n_inner, n_paths, path_offset, bound,       \
        surface, outer_partials, s);
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

// grids: a host array of n_grids device pointers, each (n_steps, n_paths) f32.
int mc_family_inner(int family_id, int payoff_id, uint32_t ki0, uint32_t ki1,
                    const float* params, int n_steps, int n_inner, uint32_t n_paths,
                    uint32_t path_offset, uint32_t bound, const float* const* grids,
                    int n_grids, const float* state_grid, float* surface, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (family_id != mc::FAMILY_HESTON || n_grids != mc::HestonFamily::kGrids) {
    return cudaErrorInvalidValue;
  }
  mc::GridPtrs g = {};
  for (int k = 0; k < n_grids; ++k) g.g[k] = grids[k];
#define MC_CASE(ID, PAYOFF)                                                              \
  case mc::ID:                                                                           \
    return mc::launch_family_inner<mc::HestonFamily, mc::PAYOFF>(                        \
        ki0, ki1, params, n_steps, n_inner, n_paths, path_offset, bound, g, state_grid,  \
        surface, s);
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
