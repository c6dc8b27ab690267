// The local-vol instantiations of the family NMC kernels (family.cuh), for
// sm_90a: family_fused_kernel<LocalVolFamily> (#30), family_inner_kernel
// <LocalVolFamily> (#29) and family_trajectories_kernel<LocalVolFamily>,
// which is localvol_trajectories and replaces mc_tpu/models/localvol.py
// localvol_trajectories_kernel (:406, the Pallas call at :424).  Its steps
// are LocalVolFamily's outer_draw and outer_advance (localvol.cuh), the draw
// and the step of the fused kernel's outer_step, so the two give the same
// outer paths bit for bit, and the partials kernel's arithmetic at 13 rounds.
// The twelve one-word payoffs each; family_nmc_kernels.cu's entry points call
// the launchers below.  A source of their own, so they compile beside
// localvol_kernels.cu.

#include <cstdint>

#include <cuda_runtime.h>

#include "family.cuh"
#include "localvol.cuh"

namespace mc {

MC_DEFINE_FAMILY_LAUNCHERS(localvol_family, LocalVolFamily)

}  // namespace mc
