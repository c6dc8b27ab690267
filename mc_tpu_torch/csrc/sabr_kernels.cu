// SABR kernel of the port, for sm_90a.
//
// sabr_partials_kernel (#17) replaces mc_tpu/models/sabr.py _sabr_partials
// (the Pallas call at :188): its legs, kernel and launchers are in
// sabr_partials.cuh, the general-beta instantiations here and the
// unit-beta ones in sabr1_kernels.cu; mc_sabr_partials below picks the
// class the caller read from the packed beta.  A block sums 256 paths,
// several a thread in lockstep (an antithetic path's twin on the negated
// pair as one more leg), one f64 row [sum pay, sum pay^2] a block
// (reduce.cuh), no float atomics; threefry-13 or -20; every payoff of the
// registry but the two Brownian-bridge barriers (the parameters have no
// sigma).  The SABR instantiations of the family NMC kernels are in
// sabr_nmc_kernels.cu.
//
// What bounds it on the H100: operations.  A step spends a whole threefry
// pair (twice GBM's log-Euler step, Heston's shape), the Box-Muller
// transcendentals, the vol factor's expf and ~17 f32 operations; the local
// vol's expf where beta is not 1, and F = expf(log F) where the payoff
// reads the forward at each step.  The parameters are 68 bytes and each
// block writes 16.

#include <cstdint>

#include <cuda_runtime.h>

#include "sabr_partials.cuh"

namespace mc {

MC_DEFINE_SABR_PARTIALS(general, false)

}  // namespace mc

extern "C" {

// The partials kernel's paths a block (its grid: ceil(n_paths / it),
// capped) and paths a thread.
int mc_sabr_block_paths() { return mc::kSabrTile; }
int mc_sabr_paths_per_thread() { return mc::kSabrPaths; }

// Resident blocks per SM of the partials kernel (VanillaCall, threefry-13)
// of a beta class.
int mc_sabr_occupancy(int unit_beta, int antithetic, int* blocks) {
  return unit_beta ? mc::sabr_occupancy_unit_beta(antithetic, blocks)
                   : mc::sabr_occupancy_general(antithetic, blocks);
}

// unit_beta: the packed beta is 1 (models/sabr.py sabr_unit_beta); the
// unit-beta kernel is wrong for any other.
int mc_sabr_partials(int payoff_id, int rounds, int antithetic, int unit_beta, uint32_t k0,
                     uint32_t k1, const float* params, int n_steps, uint32_t n_paths,
                     uint32_t path_offset, uint32_t bound, double* partials, int n_blocks,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_steps < 1) return cudaErrorInvalidValue;
  return unit_beta ? mc::sabr_partials_unit_beta(payoff_id, rounds, antithetic, k0, k1, params,
                                                 n_steps, n_paths, path_offset, bound, partials,
                                                 n_blocks, s)
                   : mc::sabr_partials_general(payoff_id, rounds, antithetic, k0, k1, params,
                                               n_steps, n_paths, path_offset, bound, partials,
                                               n_blocks, s);
}

}  // extern "C"
