// The term-structure instantiations of the family NMC kernels (family.cuh), for sm_90a:
// family_fused_kernel<TermFamily> (#30), family_inner_kernel<TermFamily> (#29)
// and family_trajectories_kernel<TermFamily>, which stores the S grid of the
// grid strategy where mc_tpu builds it with its XLA scan (no Pallas
// counterpart).  Its step is TermFamily::outer_step (term.cuh), the fused
// kernel's, so the two give the same outer paths bit for bit.  The twelve
// one-word payoffs each; family_nmc_kernels.cu's entry points call the
// launchers below.  A source of their own, so they compile beside
// term_kernels.cu.

#include <cstdint>

#include <cuda_runtime.h>

#include "term.cuh"
#include "family.cuh"

namespace mc {

cudaError_t term_family_fused(int payoff_id, uint32_t ko0, uint32_t ko1, uint32_t ki0,
                             uint32_t ki1, const float* params, FamilyExtras extras,
                             int n_steps, int n_inner, uint32_t n_paths,
                             uint32_t path_offset, uint32_t bound, float* surface,
                             double* outer_partials, cudaStream_t stream) {
  return family_fused_switch<TermFamily>(payoff_id, ko0, ko1, ki0, ki1, params, extras,
                                        n_steps, n_inner, n_paths, path_offset, bound,
                                        surface, outer_partials, stream);
}

cudaError_t term_family_inner(int payoff_id, uint32_t ki0, uint32_t ki1, const float* params,
                             FamilyExtras extras, int n_steps, int n_inner, uint32_t n_paths,
                             uint32_t path_offset, uint32_t bound, const GridPtrs& grids,
                             const float* state_grid, float* surface, cudaStream_t stream) {
  return family_inner_switch<TermFamily>(payoff_id, ki0, ki1, params, extras, n_steps,
                                        n_inner, n_paths, path_offset, bound, grids,
                                        state_grid, surface, stream);
}

cudaError_t term_family_trajectories(int payoff_id, uint32_t k0, uint32_t k1,
                                    const float* params, FamilyExtras extras, int n_steps,
                                    uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                    const GridOutPtrs& grids, float* state_grid,
                                    double* partials, int n_blocks, cudaStream_t stream) {
  return family_trajectories_switch<TermFamily>(payoff_id, k0, k1, params, extras, n_steps,
                                               n_paths, path_offset, bound, grids,
                                               state_grid, partials, n_blocks, stream);
}

}  // namespace mc
