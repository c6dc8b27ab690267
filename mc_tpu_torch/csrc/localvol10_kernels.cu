// The local-vol partials kernel (#19) at knot capacity 10
// (localvol_partials.cuh; the dispatch is in localvol_kernels.cu), for
// sm_90a: a source of its own, so the capacities' instantiations compile in
// parallel.

#include "localvol_partials.cuh"

namespace mc {

MC_DEFINE_LOCALVOL_PARTIALS(10)

}  // namespace mc
