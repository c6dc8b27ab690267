// The basket instantiations of the family NMC kernels (family.cuh), for
// sm_90a: family_fused_kernel<BasketFamily<kMaxD>> (#30),
// family_inner_kernel<BasketFamily<kMaxD>> (#29) and
// family_trajectories_kernel<BasketFamily<kMaxD>>, which stores the d asset
// price grids of the grid strategy where mc_tpu builds them with its XLA scan
// (no Pallas counterpart).  Its steps are BasketFamily's outer_draw and
// outer_advance (basket.cuh), the draw and the step of the fused kernel's
// outer_step, so the two give the same outer paths bit for bit.  The call's d
// (extras i[0], in [1, 32]) picks the capacity: 8 for d <= 8 (instantiated
// here), 32 above (basket_nmc32_kernels.cu, a source of its own so the two
// capacities compile in parallel).  The twelve one-word payoffs each;
// family_nmc_kernels.cu's entry points call the launchers below.

#include <cstdint>

#include <cuda_runtime.h>

#include "basket.cuh"
#include "family.cuh"

namespace mc {

MC_DEFINE_FAMILY_LAUNCHERS(basket8_family, BasketFamily<8>)

cudaError_t basket_family_fused(int payoff_id, uint32_t ko0, uint32_t ko1, uint32_t ki0,
                                uint32_t ki1, const float* params, FamilyExtras extras,
                                int n_steps, int n_inner, int n_groups, int stage_floats,
                                uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                float* surface, double* outer_partials, cudaStream_t stream) {
  const int d = extras.i[0];
  if (d < 1 || d > 32) return cudaErrorInvalidValue;
  return (d <= 8 ? basket8_family_fused : basket32_family_fused)(
      payoff_id, ko0, ko1, ki0, ki1, params, extras, n_steps, n_inner, n_groups, stage_floats,
      n_paths, path_offset, bound, surface, outer_partials, stream);
}

cudaError_t basket_family_inner(int payoff_id, uint32_t ki0, uint32_t ki1, const float* params,
                                FamilyExtras extras, int n_steps, int n_inner, int n_groups,
                                int stage_floats, uint32_t n_paths, uint32_t path_offset,
                                uint32_t bound, const GridPtrs& grids, const float* state_grid,
                                float* surface, cudaStream_t stream) {
  const int d = extras.i[0];
  if (d < 1 || d > 32) return cudaErrorInvalidValue;
  return (d <= 8 ? basket8_family_inner : basket32_family_inner)(
      payoff_id, ki0, ki1, params, extras, n_steps, n_inner, n_groups, stage_floats, n_paths,
      path_offset, bound, grids, state_grid, surface, stream);
}

cudaError_t basket_family_trajectories(int payoff_id, uint32_t k0, uint32_t k1,
                                       const float* params, FamilyExtras extras, int n_steps,
                                       uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                       const GridOutPtrs& grids, float* state_grid,
                                       double* partials, int n_blocks, cudaStream_t stream) {
  const int d = extras.i[0];
  if (d < 1 || d > 32) return cudaErrorInvalidValue;
  return (d <= 8 ? basket8_family_trajectories : basket32_family_trajectories)(
      payoff_id, k0, k1, params, extras, n_steps, n_paths, path_offset, bound, grids,
      state_grid, partials, n_blocks, stream);
}

cudaError_t basket_family_occupancy(int payoff_id, FamilyExtras extras, int fused, int smem_bytes,
                                  int* blocks) {
  return (extras.i[0] <= 8 ? basket8_family_occupancy : basket32_family_occupancy)(
      payoff_id, extras, fused, smem_bytes, blocks);
}

cudaError_t basket_family_trajectories_occupancy(int payoff_id, FamilyExtras extras,
                                              int n_blocks, int* blocks) {
  const int d = extras.i[0];
  if (d < 1 || d > 32) return cudaErrorInvalidValue;
  return (extras.i[0] <= 8 ? basket8_family_trajectories_occupancy
                           : basket32_family_trajectories_occupancy)(payoff_id, extras,
                                                                     n_blocks, blocks);
}

cudaError_t basket_family_trajectories_geometry(FamilyExtras extras, int n_blocks,
                                             int* threads, int* smem_bytes) {
  const int d = extras.i[0];
  if (d < 1 || d > 32) return cudaErrorInvalidValue;
  return (extras.i[0] <= 8 ? basket8_family_trajectories_geometry
                           : basket32_family_trajectories_geometry)(extras, n_blocks, threads,
                                                                    smem_bytes);
}

}  // namespace mc
