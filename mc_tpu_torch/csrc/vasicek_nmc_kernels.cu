// The Vasicek instantiations of the family NMC kernels (family.cuh), for
// sm_90a: family_fused_kernel<VasicekFamily> (#30), family_inner_kernel
// <VasicekFamily> (#29) and family_trajectories_kernel<VasicekFamily>, which
// is vasicek_trajectories and replaces mc_tpu/models/vasicek.py
// vasicek_trajectories_kernel (:405, the Pallas call at :422): it stores S, x
// = r - b, y = int r and payoff state word 0 after every step.  Its steps are
// VasicekFamily's outer_draw and outer_advance (vasicek.cuh), the draw and
// the step of the fused kernel's outer_step, so the two give the same outer
// paths bit for bit, and the partials kernel's arithmetic at 13 rounds.  The
// twelve one-word payoffs each; family_nmc_kernels.cu's entry points call the
// launchers below.  A source of their own, so they compile beside
// vasicek_kernels.cu.

#include <cstdint>

#include <cuda_runtime.h>

#include "family.cuh"
#include "vasicek.cuh"

namespace mc {

MC_DEFINE_FAMILY_LAUNCHERS(vasicek_family, VasicekFamily)

}  // namespace mc
