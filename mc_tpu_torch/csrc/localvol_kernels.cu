// Local-volatility kernel of the port, for sm_90a.
//
// localvol_partials_kernel (#19) replaces mc_tpu/models/localvol.py
// _localvol_partials (the Pallas call at :275): its legs, kernel and
// launchers are in localvol_partials.cuh, the runtime-K kernel (capacity 0)
// here and the knot capacity 10 in localvol10_kernels.cu;
// mc_localvol_partials below picks the capacity of K, the one place that
// does.  A block sums 256 paths, several a thread in lockstep, one f64 row
// [sum pay, sum pay^2] a block (reduce.cuh), no float atomics;
// threefry-13 or -20; every payoff of the registry.  localvol_trajectories
// (#20) and the local-vol instantiations of the family NMC kernels are in
// localvol_nmc_kernels.cu.
//
// What bounds it on the H100: operations.  A step pair spends one threefry
// call and a Box-Muller pair (as GBM's log-Euler step), and per step and
// leg the lookup (K-1 ramps of a subtract, max, min, multiply and add: 5(K-1)
// f32 operations), ~9 f32 operations and an expf; a row's level and K-1
// slopes are loaded once for the thread's legs.  The surface is 3.7 KB at
// K = 9, n_steps = 100; each block writes 16 bytes.

#include <cstdint>

#include <cuda_runtime.h>

#include "localvol_partials.cuh"

namespace mc {

MC_DEFINE_LOCALVOL_PARTIALS(0)

}  // namespace mc

extern "C" {

// The partials kernel's paths a block (its grid: ceil(n_paths / it),
// capped), the knot capacity that runs K (0: runtime K) and the paths a
// thread there.
int mc_localvol_block_paths() { return mc::kLocalVolTile; }
int mc_localvol_capacity(int n_knots) {
  return n_knots >= 2 ? mc::localvol_capacity(n_knots) : -1;
}
int mc_localvol_paths_per_thread(int antithetic) {
  return mc::localvol_paths_per_thread(antithetic != 0);
}

// Resident blocks per SM of the partials kernel (VanillaCall, threefry-13)
// at K knots.
int mc_localvol_occupancy(int payoff_id, int n_knots, int antithetic, int* blocks) {
  if (payoff_id != mc::PAYOFF_VANILLA_CALL || n_knots < 2) return cudaErrorInvalidValue;
  switch (mc::localvol_capacity(n_knots)) {
    case 10: return mc::localvol_occupancy_10(antithetic, blocks);
    default: return mc::localvol_occupancy_0(antithetic, blocks);
  }
}

// params: the packed vector of 11 + 2K - 1 + n_steps*K floats (the wrapper
// checks its length); n_blocks blocks of mc_localvol_block_paths() paths.
int mc_localvol_partials(int payoff_id, int rounds, int antithetic, uint32_t k0, uint32_t k1,
                         const float* params, int n_knots, int n_steps, uint32_t n_paths,
                         uint32_t path_offset, uint32_t bound, double* partials, int n_blocks,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_knots < 2 || n_steps < 2 || n_steps % 2) return cudaErrorInvalidValue;
#define MC_LOCALVOL_ARGS                                                                   \
  payoff_id, rounds, antithetic, k0, k1, params, n_knots, n_steps, n_paths, path_offset, \
      bound, partials, n_blocks, s
  switch (mc::localvol_capacity(n_knots)) {
    case 10: return mc::localvol_partials_10(MC_LOCALVOL_ARGS);
    default: return mc::localvol_partials_0(MC_LOCALVOL_ARGS);
  }
#undef MC_LOCALVOL_ARGS
}

}  // extern "C"
