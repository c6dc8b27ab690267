// The Merton instantiations of the family NMC kernels (family.cuh), for
// sm_90a: family_fused_kernel<MertonFamily> (#30), family_inner_kernel
// <MertonFamily> (#29) and family_trajectories_kernel<MertonFamily>, which is
// merton_trajectories and replaces mc_tpu/models/merton.py
// merton_trajectories_kernel (:392, the Pallas call at :411).  Its steps are
// MertonFamily's outer_draw and outer_advance (merton.cuh), the draw and the
// step of the fused kernel's outer_step, so the two give the same outer paths
// bit for bit, and the Euler partials kernel's arithmetic at 13 rounds.  The
// twelve one-word payoffs each; family_nmc_kernels.cu's entry points call the
// launchers below.  A source of their own, so they compile beside
// merton_kernels.cu.

#include <cstdint>

#include <cuda_runtime.h>

#include "merton.cuh"
#include "family.cuh"

namespace mc {

MC_DEFINE_FAMILY_LAUNCHERS(merton_family, MertonFamily)

}  // namespace mc
