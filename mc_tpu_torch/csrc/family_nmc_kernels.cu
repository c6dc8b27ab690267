// The family nested-MC kernels of the port, for sm_90a: the entry points and
// the Heston family.
//
// family_inner_kernel replaces mc_tpu/nmc_engine.py family_inner_kernel (the
// Pallas call at :331), the grid strategy over a family's stored grids;
// family_fused_kernel replaces family_fused_kernel (the Pallas call at
// :426), which simulates the outer paths itself; family_trajectories_kernel
// stores the outer grids of every family: Heston's, Merton's, local vol's
// and Vasicek's replace mc_tpu's trajectories kernels (#13, #15, #20, #24),
// the others' mc_tpu builds with its XLA scan.  The templates, their design
// and their bound are in family.cuh.  The entry points switch on the family
// and check n_grids against its kGrids: Heston (its kernels instantiated
// here), Merton (merton_nmc_kernels.cu), Bates (bates_nmc_kernels.cu), CEV
// (cev_nmc_kernels.cu), local vol (localvol_nmc_kernels.cu), SABR
// (sabr_nmc_kernels.cu), term structures (term_nmc_kernels.cu), Vasicek
// (vasicek_nmc_kernels.cu), the basket (basket_nmc_kernels.cu and
// basket_nmc32_kernels.cu, one per capacity, its grid count the call's d)
// and the rainbow (rainbow_nmc_kernels.cu and rainbow_nmc32_kernels.cu, as
// the basket), each family's instantiations compiled in its own source.  A
// later family adds its struct, its launchers and a case.
//
// Heston's trajectories kernel (#13, replacing mc_tpu/models/heston.py
// heston_trajectories_kernel, the Pallas call at :549) is the template's:
// HestonFamily's outer step split into its draw (the threefry-13 pair (id,
// j)) and its advance (the full-truncation Euler step, S = s0 exp(w), the
// payoff's update), the same operations in the same order as the step it
// replaced, so its S, v and state grids are that kernel's bit for bit; its
// rows are the template's, 128 paths a block (the finished sums agree to
// f64 rounding).

#include <cstdint>

#include <cuda_runtime.h>

#include "family.cuh"
#include "heston.cuh"
#include "payoffs.cuh"
#include "rng.cuh"

namespace mc {

// Heston: grids (S, v); outer step j draws the threefry-13 pair (id, j)
// (its draw unit) and takes the full-truncation Euler step from s0; the
// inner legs run full-truncation Euler from (S_j, v_j) with w from 0 and
// S = S_j exp(w), one threefry-13 pair per substep
// (mc_tpu/nmc_heston.py:58-73).  No extras.
struct HestonFamily {
  using Params = HestonParams;
  static constexpr int kGrids = 2;
  static constexpr int kLegs = family_legs(1);
  using OuterDraw = DrawWords<2>;  // step j's pair (z_v, z_perp)
  static constexpr int kStepsPerDraw = 1;
  static constexpr int kTrajSplitBlocks = 2;

  template <class Payoff>
  struct Carry {
    float w, v, s;
    typename Payoff::State st;
  };

  __device__ static Params load(const float* __restrict__ params, const FamilyExtras&, int) {
    return load_heston(params);
  }
  __device__ static const mc::Params& payoff_params(const Params& h) { return h.pay; }

  template <class Payoff>
  __device__ static Carry<Payoff> outer_init(const Params& h) {
    return Carry<Payoff>{0.0f, h.v0, h.pay.s0, Payoff::init(h.pay)};
  }
  __device__ static void outer_draw(const Params&, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t u, OuterDraw& d) {
    normal_pair<13>(k0, k1, id, u, d.w[0], d.w[1]);
  }
  template <class Payoff>
  __device__ static void outer_advance(const Params& h, int, const OuterDraw& d,
                                       Carry<Payoff>& c) {
    heston_euler_step(h, d.w[0], d.w[1], c.w, c.v);
    c.s = h.pay.s0 * expf(c.w);  // log-space: one exp rounding per S_t
    c.st = Payoff::update(c.st, c.s, h.pay);
  }
  // The draw, then the advance.
  template <class Payoff>
  __device__ static void outer_step(const Params& h, uint32_t k0, uint32_t k1, uint32_t id,
                                    int j, Carry<Payoff>& c) {
    OuterDraw d;
    outer_draw(h, k0, k1, id, static_cast<uint32_t>(j), d);
    outer_advance<Payoff>(h, j, d, c);
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
  // kLegs legs from (S_t, v_t), each on its own counters c_base + l*stride.
  template <class Payoff>
  __device__ static void inner_legs(const Params& h, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t c_base, uint32_t stride, int remaining,
                                    const float (&g)[kGrids],
                                    const typename Payoff::State& st0, float (&pay)[kLegs]) {
    float w[kLegs], v[kLegs], s[kLegs];
    typename Payoff::State st[kLegs];
#pragma unroll
    for (int l = 0; l < kLegs; ++l) {
      w[l] = 0.0f;
      v[l] = g[1];
      s[l] = g[0];
      st[l] = st0;
    }
    for (int u = 0; u < remaining; ++u) {
#pragma unroll
      for (int l = 0; l < kLegs; ++l) {
        float z_v, z_perp;
        normal_pair<13>(k0, k1, id, c_base + l * stride + static_cast<uint32_t>(u), z_v,
                        z_perp);
        heston_euler_step(h, z_v, z_perp, w[l], v[l]);
        s[l] = g[0] * expf(w[l]);
        st[l] = Payoff::update(st[l], s[l], h.pay);
      }
    }
#pragma unroll
    for (int l = 0; l < kLegs; ++l) pay[l] = Payoff::terminal(st[l], s[l], h.pay);
  }
  __device__ static float point_scale(const Params& h, const float (&)[kGrids]) {
    return expf(-h.pay.r * h.pay.t);  // the full e^{-rT}, as nmc.cuh:100-104
  }
  __device__ static uint32_t counter_stride(const Params&, int n_steps) {
    return static_cast<uint32_t>(n_steps);
  }
};

MC_DEFINE_FAMILY_LAUNCHERS(heston_family, HestonFamily)

// The market grids each family stores (S first): the basket's d, in [1,
// kMaxGrids], is its extras' i[0].
inline int family_grids(int family_id, const FamilyExtras& extras) {
  switch (family_id) {
    case FAMILY_HESTON: return 2;
    case FAMILY_MERTON: return 1;
    case FAMILY_BATES: return 2;
    case FAMILY_CEV: return 1;
    case FAMILY_LOCALVOL: return 1;
    case FAMILY_SABR: return 2;
    case FAMILY_TERM: return 1;
    case FAMILY_VASICEK: return 3;
    case FAMILY_BASKET:
      return extras.i[0] >= 1 && extras.i[0] <= kMaxGrids ? extras.i[0] : -1;
    case FAMILY_RAINBOW:
      return extras.i[0] >= 1 && extras.i[0] <= kMaxGrids && extras.i[1] >= 0 &&
                     extras.i[1] <= 1
                 ? extras.i[0]
                 : -1;
    default: return -1;
  }
}

}  // namespace mc

extern "C" {

int mc_family_block_threads() { return mc::kFamilyThreads; }

// The outer paths a block of the trajectories kernel (one advance lane
// each; the wrapper sizes its grid and partials by it).
int mc_family_trajectories_block_paths() { return mc::kFamilyThreads; }

// The launcher mc::<family>_family_<WHAT>(...) of family_id.
#define MC_FAMILY_DISPATCH(WHAT, ...)                                                     \
  switch (family_id) {                                                                    \
    case mc::FAMILY_HESTON: return mc::heston_family_##WHAT(__VA_ARGS__);                  \
    case mc::FAMILY_MERTON: return mc::merton_family_##WHAT(__VA_ARGS__);                  \
    case mc::FAMILY_BATES: return mc::bates_family_##WHAT(__VA_ARGS__);                    \
    case mc::FAMILY_CEV: return mc::cev_family_##WHAT(__VA_ARGS__);                        \
    case mc::FAMILY_LOCALVOL: return mc::localvol_family_##WHAT(__VA_ARGS__);              \
    case mc::FAMILY_SABR: return mc::sabr_family_##WHAT(__VA_ARGS__);                      \
    case mc::FAMILY_TERM: return mc::term_family_##WHAT(__VA_ARGS__);                      \
    case mc::FAMILY_VASICEK: return mc::vasicek_family_##WHAT(__VA_ARGS__);                \
    case mc::FAMILY_BASKET: return mc::basket_family_##WHAT(__VA_ARGS__);                  \
    case mc::FAMILY_RAINBOW: return mc::rainbow_family_##WHAT(__VA_ARGS__);                \
    default: return cudaErrorInvalidValue;                                                \
  }

// The resident blocks per SM of family_id's fused (fused = 1) or inner
// kernel for payoff_id at smem_bytes of dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
int mc_family_occupancy(int family_id, int payoff_id, mc::FamilyExtras extras, int fused,
                        int smem_bytes, int* blocks) {
  if (mc::family_grids(family_id, extras) < 0) return cudaErrorInvalidValue;
  MC_FAMILY_DISPATCH(occupancy, payoff_id, extras, fused, smem_bytes, blocks)
}

// extras: the family's integer extras by value (Merton's and Bates's
// i[0] = kmax, local vol's i[0] = K, the basket's i[0] = d, the rainbow's
// i[0] = d and i[1] its fold, 0 max or 1 min; Heston, CEV, SABR, term and
// Vasicek read none).  n_groups = ceil(n_inner / the family's kLegs) and
// stage_floats, the pack's floats staged in shared memory (0: the pack is
// read where it lies), are the caller's launch geometry (nmc_engine.py
// family_launch); the launchers refuse a group count or a staged size
// (with the family's table) that does not fit.
int mc_family_fused(int family_id, int payoff_id, uint32_t ko0, uint32_t ko1, uint32_t ki0,
                    uint32_t ki1, const float* params, mc::FamilyExtras extras, int n_steps,
                    int n_inner, int n_groups, int stage_floats, uint32_t n_paths,
                    uint32_t path_offset, uint32_t bound, float* surface,
                    double* outer_partials, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  MC_FAMILY_DISPATCH(fused, payoff_id, ko0, ko1, ki0, ki1, params, extras, n_steps, n_inner,
                     n_groups, stage_floats, n_paths, path_offset, bound, surface,
                     outer_partials, s)
}

// grids: a host array of n_grids device pointers, each (n_steps, n_paths) f32.
int mc_family_inner(int family_id, int payoff_id, uint32_t ki0, uint32_t ki1,
                    const float* params, mc::FamilyExtras extras, int n_steps, int n_inner,
                    int n_groups, int stage_floats, uint32_t n_paths, uint32_t path_offset,
                    uint32_t bound, const float* const* grids, int n_grids,
                    const float* state_grid, float* surface, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_grids != mc::family_grids(family_id, extras)) return cudaErrorInvalidValue;
  mc::GridPtrs g = {};
  for (int k = 0; k < n_grids; ++k) g.g[k] = grids[k];
  MC_FAMILY_DISPATCH(inner, payoff_id, ki0, ki1, params, extras, n_steps, n_inner, n_groups,
                     stage_floats, n_paths, path_offset, bound, g, state_grid, surface, s)
}

// grids: a host array of n_grids device pointers the kernel writes, each
// (n_steps, n_paths) f32; partials (n_blocks, 2) f64.  Heston (#13's
// kernel), Merton (#15's), Bates, CEV, local vol (#20's), SABR, term,
// Vasicek (#24's) and the basket's and the rainbow's d asset grids.
int mc_family_trajectories(int family_id, int payoff_id, uint32_t k0, uint32_t k1,
                           const float* params, mc::FamilyExtras extras, int n_steps,
                           uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                           float* const* grids, int n_grids, float* state_grid,
                           double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_grids != mc::family_grids(family_id, extras)) return cudaErrorInvalidValue;
  mc::GridOutPtrs g = {};
  for (int k = 0; k < n_grids; ++k) g.g[k] = grids[k];
  MC_FAMILY_DISPATCH(trajectories, payoff_id, k0, k1, params, extras, n_steps, n_paths,
                     path_offset, bound, g, state_grid, partials, n_blocks, s)
}

// The resident blocks per SM of family_id's trajectories kernel for
// payoff_id at its extras on a grid of n_blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
int mc_family_trajectories_occupancy(int family_id, int payoff_id, mc::FamilyExtras extras,
                                     int n_blocks, int* blocks) {
  if (mc::family_grids(family_id, extras) < 0) return cudaErrorInvalidValue;
  MC_FAMILY_DISPATCH(trajectories_occupancy, payoff_id, extras, n_blocks, blocks)
}

// The threads a block of family_id's trajectories kernel on a grid of
// n_blocks (its advance lanes, and its draw warps where the grid has at most
// the family's kTrajSplitBlocks blocks an SM) and its dynamic shared bytes at
// its extras.
int mc_family_trajectories_geometry(int family_id, mc::FamilyExtras extras, int n_blocks,
                                    int* threads, int* smem_bytes) {
  if (mc::family_grids(family_id, extras) < 0) return cudaErrorInvalidValue;
  MC_FAMILY_DISPATCH(trajectories_geometry, extras, n_blocks, threads, smem_bytes)
}

}  // extern "C"
