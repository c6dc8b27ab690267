// The SABR partials kernel (#17) at beta = 1 exactly (sabr_partials.cuh;
// the dispatch is in sabr_kernels.cu), for sm_90a: a source of its own, so
// the two beta classes' instantiations compile in parallel.

#include "sabr_partials.cuh"

namespace mc {

MC_DEFINE_SABR_PARTIALS(unit_beta, true)

}  // namespace mc
