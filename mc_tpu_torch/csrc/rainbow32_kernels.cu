// The rainbow's partials kernel (#27) at capacities 16 and 32
// (rainbow_partials.cuh; the dispatch is in rainbow_kernels.cu), for
// sm_90a: a source of its own, so nvcc compiles it beside capacities 4
// and 8.  Two sources, not four: the build's pool is full, so each nvcc
// process's fixed cost (~3 s of a 4-8 s unit on the H100 machine) counts.

#include "rainbow_partials.cuh"

namespace mc {

MC_DEFINE_RAINBOW_PARTIALS(16)
MC_DEFINE_RAINBOW_PARTIALS(32)

}  // namespace mc
