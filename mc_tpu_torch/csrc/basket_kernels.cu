// Basket kernels of the port, for sm_90a.
//
// basket_partials_kernel (#25) replaces mc_tpu/models/basket.py
// _basket_partials (the Pallas call at :277): its legs, kernel and
// launchers are in basket_partials.cuh, capacity 4 here and 8, 16 and 32
// in basket<N>_kernels.cu; mc_basket_partials below picks the capacity of
// d, the one place that does.  A block sums 256 paths, several a thread in
// lockstep, one f64 row [sum pay, sum pay^2] a block (reduce.cuh), no float
// atomics; threefry-13; every payoff of the registry (the bridge barriers
// read sigma = 0, as in mc_tpu's Pallas kernel).
//
// basket_trajectories_kernel (#26) replaces basket_trajectories_kernel
// (mc_tpu/models/basket.py:393, the Pallas call at :409): the same legs and
// blocks (basket_partials.cuh), no antithetic twin, each lane storing its
// path's basket level and payoff state word 0 after every step, step-major
// (entry j*n_paths + i), and the payoff's moment rows; the twelve one-word
// payoffs.  These are the (B, state) grids mc_tpu's basket LSMC regresses
// on; the NMC's per-asset grids come from the family engine
// (basket_nmc_kernels.cu).  mc_basket_trajectories picks the capacity of d,
// as mc_basket_partials does.
//
// What bounds them on the H100: operations.  A step spends ceil(d/2)
// threefry pairs, the mix's d(d+1)/2 multiplies and d(d-1)/2 adds, d expf
// and ~6d f32 operations more (an antithetic path's second leg ~5d and d
// expf on the same draw and mix); the parameters are 4(10 + 3d + d(d+1)/2)
// bytes, each block writes 16.  The trajectories kernel writes 8 bytes a
// path-step besides.

#include <cstdint>

#include <cuda_runtime.h>

#include "basket.cuh"
#include "basket_partials.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

MC_DEFINE_BASKET_PARTIALS(4)
MC_DEFINE_BASKET_TRAJECTORIES(4)

}  // namespace mc

extern "C" {

// The trajectories kernel's paths a block (its grid: ceil(n_paths / it),
// capped), its threads a block at d (kBasketTile over its paths a thread
// there) and its resident blocks per SM (a one-word payoff at d).
int mc_basket_trajectories_block_paths() { return mc::kBasketTile; }
int mc_basket_block_threads(int d) {
  return d >= 1 && d <= 32
             ? mc::kBasketTile / mc::basket_grid_paths_per_thread(mc::basket_capacity(d))
             : 0;
}
int mc_basket_trajectories_occupancy(int payoff_id, int d, int* blocks) {
  if (d < 1 || d > 32) return cudaErrorInvalidValue;
  switch (mc::basket_capacity(d)) {
    case 4: return mc::basket_trajectories_occupancy_4(payoff_id, blocks);
    case 8: return mc::basket_trajectories_occupancy_8(payoff_id, blocks);
    case 16: return mc::basket_trajectories_occupancy_16(payoff_id, blocks);
    default: return mc::basket_trajectories_occupancy_32(payoff_id, blocks);
  }
}

// The partials kernel's paths a block (its grid: ceil(n_paths / it),
// capped), the capacity that runs d and the paths a thread there.
int mc_basket_block_paths() { return mc::kBasketTile; }
int mc_basket_capacity(int d) { return d >= 1 && d <= 32 ? mc::basket_capacity(d) : 0; }
int mc_basket_paths_per_thread(int d) {
  return d >= 1 && d <= 32 ? mc::basket_paths_per_thread(mc::basket_capacity(d)) : 0;
}

// Resident blocks per SM of the partials kernel (VanillaCall) at d.
int mc_basket_occupancy(int payoff_id, int d, int antithetic, int* blocks) {
  if (payoff_id != mc::PAYOFF_VANILLA_CALL || d < 1 || d > 32) return cudaErrorInvalidValue;
  switch (mc::basket_capacity(d)) {
    case 4: return mc::basket_occupancy_4(antithetic, blocks);
    case 8: return mc::basket_occupancy_8(antithetic, blocks);
    case 16: return mc::basket_occupancy_16(antithetic, blocks);
    default: return mc::basket_occupancy_32(antithetic, blocks);
  }
}

// params: the packed vector of 10 + 3d + d(d+1)/2 floats (the wrapper checks
// its length); d in [1, 32]; n_blocks blocks of mc_basket_block_paths()
// paths.
int mc_basket_partials(int payoff_id, int antithetic, uint32_t k0, uint32_t k1,
                       const float* params, int d, int n_steps, uint32_t n_paths,
                       uint32_t path_offset, uint32_t bound, double* partials, int n_blocks,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 32 || n_steps < 1) return cudaErrorInvalidValue;
#define MC_BASKET_ARGS \
  payoff_id, antithetic, k0, k1, params, d, n_steps, n_paths, path_offset, bound, partials, \
      n_blocks, s
  switch (mc::basket_capacity(d)) {
    case 4: return mc::basket_partials_4(MC_BASKET_ARGS);
    case 8: return mc::basket_partials_8(MC_BASKET_ARGS);
    case 16: return mc::basket_partials_16(MC_BASKET_ARGS);
    default: return mc::basket_partials_32(MC_BASKET_ARGS);
  }
#undef MC_BASKET_ARGS
}

// b_grid, state_grid: (n_steps, n_paths) f32; partials (n_blocks, 2) f64;
// n_blocks blocks of mc_basket_trajectories_block_paths() paths.
int mc_basket_trajectories(int payoff_id, uint32_t k0, uint32_t k1, const float* params, int d,
                           int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                           float* b_grid, float* state_grid, double* partials, int n_blocks,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 32 || n_steps < 1) return cudaErrorInvalidValue;
#define MC_BASKET_ARGS                                                                     \
  payoff_id, k0, k1, params, d, n_steps, n_paths, path_offset, bound, b_grid, state_grid, \
      partials, n_blocks, s
  switch (mc::basket_capacity(d)) {
    case 4: return mc::basket_trajectories_4(MC_BASKET_ARGS);
    case 8: return mc::basket_trajectories_8(MC_BASKET_ARGS);
    case 16: return mc::basket_trajectories_16(MC_BASKET_ARGS);
    default: return mc::basket_trajectories_32(MC_BASKET_ARGS);
  }
#undef MC_BASKET_ARGS
}

}  // extern "C"
