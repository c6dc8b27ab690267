// The basket's partials kernel (#25) and trajectories kernel (#26) at
// capacity 32 (basket_partials.cuh; the dispatch is in basket_kernels.cu),
// for sm_90a: a source of its own, so the capacities' instantiations compile
// in parallel.

#include "basket_partials.cuh"

namespace mc {

MC_DEFINE_BASKET_PARTIALS(32)
MC_DEFINE_BASKET_TRAJECTORIES(32)

}  // namespace mc
