// The rainbow instantiations of the family NMC kernels (family.cuh), for
// sm_90a: family_fused_kernel<RainbowFamily<kMaxD>> (#30 for mc_tpu's
// rainbow), family_inner_kernel<RainbowFamily<kMaxD>> (#29) and
// family_trajectories_kernel<RainbowFamily<kMaxD>>, which stores the d asset
// price grids where mc_tpu builds them with its XLA scan (no Pallas
// counterpart).  RainbowFamily (basket.cuh) is the basket's physics with the
// level folded by max or min; the fold is the call's extras i[1], read at
// run time, so it adds no instantiation.  The call's d (extras i[0], in [1,
// 32]) picks the capacity: 8 for d <= 8 (instantiated here), 32 above
// (rainbow_nmc32_kernels.cu, a source of its own so the two capacities
// compile in parallel).  The twelve one-word payoffs each;
// family_nmc_kernels.cu's entry points call the launchers below.

#include <cstdint>

#include <cuda_runtime.h>

#include "basket.cuh"
#include "family.cuh"

namespace mc {

MC_DEFINE_FAMILY_LAUNCHERS(rainbow8_family, RainbowFamily<8>)

inline bool rainbow_extras_ok(const FamilyExtras& extras) {
  return extras.i[0] >= 1 && extras.i[0] <= 32 && extras.i[1] >= 0 && extras.i[1] <= 1;
}

cudaError_t rainbow_family_fused(int payoff_id, uint32_t ko0, uint32_t ko1, uint32_t ki0,
                                 uint32_t ki1, const float* params, FamilyExtras extras,
                                 int n_steps, int n_inner, int n_groups, int stage_floats,
                                 uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                 float* surface, double* outer_partials, cudaStream_t stream) {
  if (!rainbow_extras_ok(extras)) return cudaErrorInvalidValue;
  return (extras.i[0] <= 8 ? rainbow8_family_fused : rainbow32_family_fused)(
      payoff_id, ko0, ko1, ki0, ki1, params, extras, n_steps, n_inner, n_groups, stage_floats,
      n_paths, path_offset, bound, surface, outer_partials, stream);
}

cudaError_t rainbow_family_inner(int payoff_id, uint32_t ki0, uint32_t ki1, const float* params,
                                 FamilyExtras extras, int n_steps, int n_inner, int n_groups,
                                 int stage_floats, uint32_t n_paths, uint32_t path_offset,
                                 uint32_t bound, const GridPtrs& grids,
                                 const float* state_grid, float* surface, cudaStream_t stream) {
  if (!rainbow_extras_ok(extras)) return cudaErrorInvalidValue;
  return (extras.i[0] <= 8 ? rainbow8_family_inner : rainbow32_family_inner)(
      payoff_id, ki0, ki1, params, extras, n_steps, n_inner, n_groups, stage_floats, n_paths,
      path_offset, bound, grids, state_grid, surface, stream);
}

cudaError_t rainbow_family_trajectories(int payoff_id, uint32_t k0, uint32_t k1,
                                        const float* params, FamilyExtras extras, int n_steps,
                                        uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                        const GridOutPtrs& grids, float* state_grid,
                                        double* partials, int n_blocks, cudaStream_t stream) {
  if (!rainbow_extras_ok(extras)) return cudaErrorInvalidValue;
  return (extras.i[0] <= 8 ? rainbow8_family_trajectories : rainbow32_family_trajectories)(
      payoff_id, k0, k1, params, extras, n_steps, n_paths, path_offset, bound, grids,
      state_grid, partials, n_blocks, stream);
}

cudaError_t rainbow_family_occupancy(int payoff_id, FamilyExtras extras, int fused, int smem_bytes,
                                  int* blocks) {
  return (extras.i[0] <= 8 ? rainbow8_family_occupancy : rainbow32_family_occupancy)(
      payoff_id, extras, fused, smem_bytes, blocks);
}

cudaError_t rainbow_family_trajectories_occupancy(int payoff_id, FamilyExtras extras,
                                              int n_blocks, int* blocks) {
  if (!rainbow_extras_ok(extras)) return cudaErrorInvalidValue;
  return (extras.i[0] <= 8 ? rainbow8_family_trajectories_occupancy
                           : rainbow32_family_trajectories_occupancy)(payoff_id, extras,
                                                                     n_blocks, blocks);
}

cudaError_t rainbow_family_trajectories_geometry(FamilyExtras extras, int n_blocks,
                                             int* threads, int* smem_bytes) {
  if (!rainbow_extras_ok(extras)) return cudaErrorInvalidValue;
  return (extras.i[0] <= 8 ? rainbow8_family_trajectories_geometry
                           : rainbow32_family_trajectories_geometry)(extras, n_blocks, threads,
                                                                    smem_bytes);
}

}  // namespace mc
