// The simulate kernel's (#2, simulate.cuh) threefry-20 instantiations:
// their own source, so that they compile beside simulate_kernels.cu.

#include <cstdint>

#include <cuda_runtime.h>

#include "simulate.cuh"

namespace mc {

cudaError_t launch_simulate20(int payoff_id, int euler, int antithetic, int with_cv,
                              uint32_t k0, uint32_t k1, const float* params, int n_steps,
                              int start_step, float is_shift, uint32_t n_paths,
                              uint32_t path_offset, uint32_t bound, const float* s_init,
                              const float* state_init, double* partials, int n_blocks,
                              cudaStream_t stream) {
  return launch_simulate<20>(payoff_id, euler, antithetic, with_cv, k0, k1, params, n_steps,
                             start_step, is_shift, n_paths, path_offset, bound, s_init,
                             state_init, partials, n_blocks, stream);
}

}  // namespace mc
