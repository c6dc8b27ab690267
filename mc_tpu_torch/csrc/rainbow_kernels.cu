// The rainbow kernel of the port, for sm_90a.
//
// rainbow_partials_kernel (#27) replaces mc_tpu/models/rainbow.py
// _rainbow_partials (the Pallas call at :149): its legs, kernel and
// launchers are in rainbow_partials.cuh, capacities 4 and 8 here and 16 and
// 32 in rainbow32_kernels.cu; mc_rainbow_partials below picks the capacity of
// d through basket_capacity (basket_partials.cuh), the one place that does,
// and the plain or the antithetic kernel.  A block sums 256 paths, several
// a thread in lockstep up to capacity 16, one f64 row [sum pay, sum pay^2]
// a block (reduce.cuh), no float atomics; threefry-13 or -20; the six
// payoffs of RAINBOW_PAYOFFS, a runtime switch once a path.
//
// The packed vector is the basket's at n_steps = 1 (basket.cuh: the drifts
// span the full horizon, sqrt_dt = sqrt(T)); the weights are not read.

#include <cstdint>

#include <cuda_runtime.h>

#include "basket_partials.cuh"
#include "rainbow_partials.cuh"

namespace mc {

MC_DEFINE_RAINBOW_PARTIALS(4)
MC_DEFINE_RAINBOW_PARTIALS(8)

}  // namespace mc

extern "C" {

// The kernel's paths a block (its grid: ceil(n_paths / it), capped), the
// capacity that runs d and the paths a thread there.
int mc_rainbow_block_paths() { return mc::kRainbowBlockPaths; }
int mc_rainbow_paths_per_thread(int d) {
  return d >= 1 && d <= 32 ? mc::rainbow_paths_per_thread(mc::basket_capacity(d)) : 0;
}

// Resident blocks per SM of the threefry-13 kernel at d, plain or
// antithetic.
int mc_rainbow_occupancy(int d, int antithetic, int* blocks) {
  if (d < 1 || d > 32) return cudaErrorInvalidValue;
  switch (mc::basket_capacity(d)) {
    case 4: return mc::rainbow_occupancy_4(antithetic, blocks);
    case 8: return mc::rainbow_occupancy_8(antithetic, blocks);
    case 16: return mc::rainbow_occupancy_16(antithetic, blocks);
    default: return mc::rainbow_occupancy_32(antithetic, blocks);
  }
}

// params: the basket's packed vector at n_steps = 1, 10 + 3d + d(d+1)/2
// floats (the wrapper checks its length); d in [1, 32] (>= 2 for the
// exchange, payoff 4); n_blocks blocks of mc_rainbow_block_paths() paths.
int mc_rainbow_partials(int payoff, int rounds, int antithetic, uint32_t k0, uint32_t k1,
                        const float* params, int d, uint32_t n_paths, uint32_t path_offset,
                        uint32_t bound, double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 32 || payoff < 0 || payoff > 5 || (payoff == 4 && d < 2) || n_blocks < 1)
    return cudaErrorInvalidValue;
#define MC_RAINBOW_CALL \
  payoff, rounds, antithetic, k0, k1, params, d, n_paths, path_offset, bound, partials, n_blocks, s
  switch (mc::basket_capacity(d)) {
    case 4: return mc::rainbow_partials_4(MC_RAINBOW_CALL);
    case 8: return mc::rainbow_partials_8(MC_RAINBOW_CALL);
    case 16: return mc::rainbow_partials_16(MC_RAINBOW_CALL);
    default: return mc::rainbow_partials_32(MC_RAINBOW_CALL);
  }
#undef MC_RAINBOW_CALL
}

}  // extern "C"
