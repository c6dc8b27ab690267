// The Vasicek instantiations of the family NMC kernels (family.cuh), for
// sm_90a: family_fused_kernel<VasicekFamily> (#30), family_inner_kernel
// <VasicekFamily> (#29) and family_trajectories_kernel<VasicekFamily>, which
// is vasicek_trajectories and replaces mc_tpu/models/vasicek.py
// vasicek_trajectories_kernel (:405, the Pallas call at :422): it stores S,
// x = r - b, y = int r and payoff state word 0 after every step.  Its step is
// VasicekFamily::outer_step (vasicek.cuh), the fused kernel's, so the two
// give the same outer paths bit for bit, and the partials kernel's
// arithmetic at 13 rounds.  The twelve one-word payoffs each;
// family_nmc_kernels.cu's entry points call the launchers below.  A source
// of their own, so they compile beside vasicek_kernels.cu.

#include <cstdint>

#include <cuda_runtime.h>

#include "family.cuh"
#include "vasicek.cuh"

namespace mc {

cudaError_t vasicek_family_fused(int payoff_id, uint32_t ko0, uint32_t ko1, uint32_t ki0,
                                 uint32_t ki1, const float* params, FamilyExtras extras,
                                 int n_steps, int n_inner, uint32_t n_paths,
                                 uint32_t path_offset, uint32_t bound, float* surface,
                                 double* outer_partials, cudaStream_t stream) {
  return family_fused_switch<VasicekFamily>(payoff_id, ko0, ko1, ki0, ki1, params, extras,
                                            n_steps, n_inner, n_paths, path_offset, bound,
                                            surface, outer_partials, stream);
}

cudaError_t vasicek_family_inner(int payoff_id, uint32_t ki0, uint32_t ki1,
                                 const float* params, FamilyExtras extras, int n_steps,
                                 int n_inner, uint32_t n_paths, uint32_t path_offset,
                                 uint32_t bound, const GridPtrs& grids,
                                 const float* state_grid, float* surface,
                                 cudaStream_t stream) {
  return family_inner_switch<VasicekFamily>(payoff_id, ki0, ki1, params, extras, n_steps,
                                            n_inner, n_paths, path_offset, bound, grids,
                                            state_grid, surface, stream);
}

cudaError_t vasicek_family_trajectories(int payoff_id, uint32_t k0, uint32_t k1,
                                        const float* params, FamilyExtras extras, int n_steps,
                                        uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                        const GridOutPtrs& grids, float* state_grid,
                                        double* partials, int n_blocks, cudaStream_t stream) {
  return family_trajectories_switch<VasicekFamily>(payoff_id, k0, k1, params, extras, n_steps,
                                                   n_paths, path_offset, bound, grids,
                                                   state_grid, partials, n_blocks, stream);
}

}  // namespace mc
