// Path-simulation kernels 1 and 4 of the port, for sm_90a (kernel 2, the
// simulate kernel, is in simulate.cuh).
//
// terminal_pair_kernel replaces mc_tpu/ops/path_kernels.py
// terminal_pair_partials (the Pallas call at :1031): element e draws one
// threefry + Box-Muller pair and prices the two exact GBM terminal paths 2e
// and 2e+1, each masked by pid < n_paths.  It takes the six terminal-only
// payoffs.
//
// trajectories_kernel replaces mc_tpu/ops/path_kernels.py
// simulate_trajectories_kernel (the Pallas call at :543), for the payoffs
// with at most one state word: the plain log-Euler loop (euler_step, S at
// every step) that also stores S and state word 0 after every step into
// step-major (n_steps, n_paths) grids, entry j*n_paths + i, so a warp's
// stores of one step are coalesced.  Its step is the euler_step and its
// draw schedule the outer leg of nmc_fused_kernel, so its grids are bitwise
// the states that kernel recomputes in registers; the simulate kernel's
// leg (simulate.cuh) steps w in the same association, so their paths
// agree.
//
// What bounds them on the H100: terminal_pair reads 60 bytes of parameters
// and writes one row of moments per block, so bytes do not matter;
// trajectories writes 8 bytes per path-step (80 MB at 100,000 x 100, 24 us
// at 3.35 TB/s), less than its RNG work takes.  The cost is the RNG's
// integer work (13 or 20 threefry rounds of add/rotate/xor per pair) and
// the transcendentals (log1pf, sqrtf, sincosf per pair, one expf per step,
// and the payoff's own).  The design keeps all of it in registers: one
// thread per path (per element for the pair kernel) over a grid-stride
// loop, both Box-Muller halves consumed, and f64 moment sums per thread
// reduced once per block (reduce.cuh).  Float contraction is off in the
// build (--fmad=false), so each mul and add rounds as in the plain version.

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kThreads = 256;

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kThreads)
terminal_pair_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params,
                     uint32_t n_elems, uint32_t n_paths_total,
                     double* __restrict__ partials) {
  const Params p = load_params(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t e = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_elems; e += stride) {
    float z0, z1;
    normal_pair<ROUNDS>(k0, k1, static_cast<uint32_t>(e), 0u, z0, z1);
    const uint64_t pid = 2 * e;
    const typename Payoff::State st0 = Payoff::init(p);
    const float pa = pid < n_paths_total
        ? Payoff::terminal(st0, p.s0 * expf(p.drift_t + p.vol_t * z0), p) : 0.0f;
    const float pb = pid + 1 < n_paths_total
        ? Payoff::terminal(st0, p.s0 * expf(p.drift_t + p.vol_t * z1), p) : 0.0f;
    acc[0] += static_cast<double>(pa + pb);
    acc[1] += static_cast<double>(pa * pa + pb * pb);
  }
  block_store_moments<2, kThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kThreads)
trajectories_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params,
                    int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                    float* __restrict__ s_grid, float* __restrict__ state_grid,
                    double* __restrict__ partials) {
  const Params p = load_params(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    float w = 0.0f, s = p.s0;
    typename Payoff::State st = Payoff::init(p);
    auto step = [&](float z, int j) {
      euler_step<Payoff>(p, p.s0, z, w, s, st);
      const size_t at = static_cast<size_t>(j) * n_paths + i;
      s_grid[at] = s;
      state_grid[at] = Payoff::kStates ? st.w[0] : 0.0f;
    };
    float z0, z1;
    for (int m = 0; m < n_steps / 2; ++m) {
      normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
      step(z0, 2 * m);
      step(z1, 2 * m + 1);
    }
    if (n_steps & 1) {  // odd step count: the epilogue takes the head half
      normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(n_steps / 2), z0, z1);
      step(z0, n_steps - 1);
    }
    const float pay = id < bound ? Payoff::terminal(st, s, p) : 0.0f;
    acc[0] += static_cast<double>(pay);
    acc[1] += static_cast<double>(pay * pay);
  }
  block_store_moments<2, kThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Payoff>
cudaError_t launch_terminal_pair(int rounds, uint32_t k0, uint32_t k1,
                                 const float* params, uint32_t n_elems,
                                 uint32_t n_paths_total, double* partials,
                                 int n_blocks, cudaStream_t stream) {
  if (rounds == 13) {
    terminal_pair_kernel<Payoff, 13><<<n_blocks, kThreads, 0, stream>>>(
        k0, k1, params, n_elems, n_paths_total, partials);
  } else if (rounds == 20) {
    terminal_pair_kernel<Payoff, 20><<<n_blocks, kThreads, 0, stream>>>(
        k0, k1, params, n_elems, n_paths_total, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <class Payoff>
cudaError_t launch_trajectories(int rounds, uint32_t k0, uint32_t k1,
                                const float* params, int n_steps, uint32_t n_paths,
                                uint32_t path_offset, uint32_t bound, float* s_grid,
                                float* state_grid, double* partials, int n_blocks,
                                cudaStream_t stream) {
  if (rounds == 13) {
    trajectories_kernel<Payoff, 13><<<n_blocks, kThreads, 0, stream>>>(
        k0, k1, params, n_steps, n_paths, path_offset, bound, s_grid, state_grid,
        partials);
  } else if (rounds == 20) {
    trajectories_kernel<Payoff, 20><<<n_blocks, kThreads, 0, stream>>>(
        k0, k1, params, n_steps, n_paths, path_offset, bound, s_grid, state_grid,
        partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

const char* mc_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int mc_block_threads() { return mc::kThreads; }

int mc_terminal_pair(int payoff_id, int rounds, uint32_t k0, uint32_t k1,
                     const float* params, uint32_t n_elems, uint32_t n_paths_total,
                     double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_CASE(ID, PAYOFF)                                                    \
  case mc::ID:                                                                 \
    return mc::launch_terminal_pair<mc::PAYOFF>(rounds, k0, k1, params, n_elems, \
                                                n_paths_total, partials, n_blocks, s);
  switch (payoff_id) {
    MC_TERMINAL_PAYOFFS(MC_CASE)
    default:  // path-dependent payoffs have no terminal draw
      return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

int mc_trajectories(int payoff_id, int rounds, uint32_t k0, uint32_t k1,
                    const float* params, int n_steps, uint32_t n_paths,
                    uint32_t path_offset, uint32_t bound, float* s_grid,
                    float* state_grid, double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_LAUNCH_TRAJECTORIES(PAYOFF)                                             \
  mc::launch_trajectories<PAYOFF>(rounds, k0, k1, params, n_steps, n_paths,         \
                                  path_offset, bound, s_grid, state_grid, partials, \
                                  n_blocks, s)
#define MC_CASE(ID, PAYOFF) \
  case mc::ID: return MC_LAUNCH_TRAJECTORIES(mc::PAYOFF);
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)  // the grid stores one state word
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
#undef MC_LAUNCH_TRAJECTORIES
}

}  // extern "C"
