// The simulate kernel's (#2, simulate.cuh) threefry-13 instantiations and
// its entry points; the threefry-20 ones compile beside them in
// simulate20_kernels.cu.

#include <cstdint>

#include <cuda_runtime.h>

#include "simulate.cuh"

extern "C" {

// Paths a block (the grid: ceil(n_paths / it), capped).
int mc_simulate_block_paths() { return mc::kSimulatePaths; }

// Resident blocks per SM of the kernel of a launch's modes (threefry-13).
int mc_simulate_occupancy(int payoff_id, int euler, int antithetic, int with_cv,
                          int* blocks) {
  return mc::with_simulate_kernel<13>(
      payoff_id, euler, antithetic, with_cv, [&](auto kernel) {
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                             mc::kSimulatePaths, 0);
      });
}

int mc_simulate_partials(int payoff_id, int rounds, int euler, int antithetic,
                         int with_cv, uint32_t k0, uint32_t k1, const float* params,
                         int n_steps, int start_step, float is_shift, uint32_t n_paths,
                         uint32_t path_offset, uint32_t bound, const float* s_init,
                         const float* state_init, double* partials, int n_mom,
                         int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_mom != (with_cv ? mc::kMaxMoments : 2)) return cudaErrorInvalidValue;
  if (rounds == 13) {
    return mc::launch_simulate<13>(payoff_id, euler, antithetic, with_cv, k0, k1, params,
                                   n_steps, start_step, is_shift, n_paths, path_offset,
                                   bound, s_init, state_init, partials, n_blocks, s);
  }
  if (rounds == 20) {
    return mc::launch_simulate20(payoff_id, euler, antithetic, with_cv, k0, k1, params,
                                 n_steps, start_step, is_shift, n_paths, path_offset,
                                 bound, s_init, state_init, partials, n_blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
