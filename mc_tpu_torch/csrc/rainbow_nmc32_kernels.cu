// The rainbow's family NMC kernels at capacity 32 (d in [9, 32]; the
// dispatch and capacity 8 are in rainbow_nmc_kernels.cu), for sm_90a: a
// source of its own, so the two capacities' instantiations compile in
// parallel.

#include <cstdint>

#include <cuda_runtime.h>

#include "basket.cuh"
#include "family.cuh"

namespace mc {

MC_DEFINE_FAMILY_LAUNCHERS(rainbow32_family, RainbowFamily<32>)

}  // namespace mc
