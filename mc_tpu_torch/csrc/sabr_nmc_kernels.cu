// The SABR instantiations of the family NMC kernels (family.cuh), for sm_90a:
// family_fused_kernel<SABRFamily> (#30), family_inner_kernel<SABRFamily>
// (#29) and family_trajectories_kernel<SABRFamily>, which stores the F and
// sigma grids of the grid strategy where mc_tpu builds them with its XLA scan
// (no Pallas counterpart).  Its steps are SABRFamily's outer_draw and
// outer_advance (sabr.cuh), the draw and the step of the fused kernel's
// outer_step, so the two give the same outer paths bit for bit.  The twelve
// one-word payoffs each; family_nmc_kernels.cu's entry points call the
// launchers below.  A source of their own, so they compile beside
// sabr_kernels.cu.

#include <cstdint>

#include <cuda_runtime.h>

#include "sabr.cuh"
#include "family.cuh"

namespace mc {

MC_DEFINE_FAMILY_LAUNCHERS(sabr_family, SABRFamily)

}  // namespace mc
