// The Bates instantiations of the family NMC kernels (family.cuh), for
// sm_90a: family_fused_kernel<BatesFamily> (#30), family_inner_kernel
// <BatesFamily> (#29) and family_trajectories_kernel<BatesFamily>, which
// stores the S and v grids of the grid strategy where mc_tpu builds them
// with its XLA scan (no Pallas counterpart).  The twelve one-word payoffs
// each; family_nmc_kernels.cu's entry points call the launchers below.  A
// source of their own, so they compile beside bates_kernels.cu.

#include <cstdint>

#include <cuda_runtime.h>

#include "bates.cuh"
#include "family.cuh"

namespace mc {

MC_DEFINE_FAMILY_LAUNCHERS(bates_family, BatesFamily)

}  // namespace mc
