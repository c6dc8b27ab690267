// The CEV instantiations of the family NMC kernels (family.cuh), for sm_90a:
// family_fused_kernel<CEVFamily> (#30), family_inner_kernel<CEVFamily> (#29)
// and family_trajectories_kernel<CEVFamily>, which stores the S grid of the
// grid strategy where mc_tpu builds it with its XLA scan (no Pallas
// counterpart).  Its steps are CEVFamily's outer_draw and outer_advance
// (cev.cuh), the draw and the step of the fused kernel's outer_step, so the
// two give the same outer paths bit for bit.  The twelve one-word payoffs
// each; family_nmc_kernels.cu's entry points call the launchers below.  A
// source of their own, so they compile beside cev_kernels.cu.

#include <cstdint>

#include <cuda_runtime.h>

#include "cev.cuh"
#include "family.cuh"

namespace mc {

MC_DEFINE_FAMILY_LAUNCHERS(cev_family, CEVFamily)

}  // namespace mc
