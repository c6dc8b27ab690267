// Path-simulation kernels 1 and 4 of the port, for sm_90a (kernel 2, the
// simulate kernel, is in simulate.cuh).
//
// terminal_pair_kernel replaces mc_tpu/ops/path_kernels.py
// terminal_pair_partials (the Pallas call at :1031): element e draws one
// threefry + Box-Muller pair and prices the two exact GBM terminal paths 2e
// and 2e+1, each masked by pid < n_paths.  It takes the six terminal-only
// payoffs.  A block sums kTpBlockElems = 256 elements, block b elements
// b*256 .. b*256+255, grid-strided: its 256 / P threads each run P of them
// in lockstep, thread t elements t, t + T, .. t + (P-1)T (T the block's
// threads), each element's f64 [pa + pb, pa^2 + pb^2] in a lane of its
// own.  The lanes add as the one-element-a-thread kernel's block tree added
// its threads t + pT (lane p and p + h at its level T*h), and the T
// threads' tree finishes, its last levels in a warp (reduce.cuh
// block_store_moments_warp): every row keeps its bits.  The parameters are
// loaded and the payoff's state initialised once a thread, for its P
// elements and every round.
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
// and the payoff's own).  The design keeps all of it in registers (a thread
// per path or P elements over a grid-stride loop, both Box-Muller halves
// consumed, f64 moment sums per thread reduced once per block, reduce.cuh)
// and, in terminal_pair, pays a block's fixed costs (the parameters, the
// tree and its barriers) once for 256 elements in fewer threads.  Float
// contraction is off in the build (--fmad=false), so each mul and add
// rounds as in the plain version.

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kThreads = 256;

constexpr int kTpBlockElems = 256;  // elements a block: the one-element kernel's threads
// Elements a thread in lockstep: on the H100 (family_nmc_probe.py --gbm,
// PERF.md) the call at 2^24 paths took 0.0592 / 0.0574 / 0.0584 ms at 1 / 2
// / 4 elements (at 1M paths, 0.0074 / 0.0070 / 0.0068 ms within the ~10%
// spread of a ~7 us launch).
constexpr int kTpElems = 2;
static_assert(kTpBlockElems % kTpElems == 0 && kTpBlockElems / kTpElems >= 32,
              "a block's threads are a power of two of at least a warp");

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kTpBlockElems / kTpElems)
terminal_pair_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params,
                     uint32_t n_elems, uint32_t n_paths_total,
                     double* __restrict__ partials) {
  constexpr int P = kTpElems;
  constexpr int T = kTpBlockElems / P;
  const Params p = load_params(params);
  const typename Payoff::State st0 = Payoff::init(p);
  double acc[P][2];
#pragma unroll
  for (int q = 0; q < P; ++q) acc[q][0] = acc[q][1] = 0.0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kTpBlockElems;
  for (uint64_t e0 = static_cast<uint64_t>(blockIdx.x) * kTpBlockElems + threadIdx.x;
       e0 < n_elems; e0 += stride) {
    float z0[P], z1[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      normal_pair<ROUNDS>(k0, k1, static_cast<uint32_t>(e0 + q * T), 0u, z0[q], z1[q]);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const uint64_t e = e0 + q * T;
      const uint64_t pid = 2 * e;
      const bool in = e < n_elems;  // a lane past the last element adds zeros
      const float pa = in && pid < n_paths_total
          ? Payoff::terminal(st0, p.s0 * expf(p.drift_t + p.vol_t * z0[q]), p) : 0.0f;
      const float pb = in && pid + 1 < n_paths_total
          ? Payoff::terminal(st0, p.s0 * expf(p.drift_t + p.vol_t * z1[q]), p) : 0.0f;
      acc[q][0] += static_cast<double>(pa + pb);
      acc[q][1] += static_cast<double>(pa * pa + pb * pb);
    }
  }
#pragma unroll
  for (int h = P / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int q = 0; q < h; ++q) {
      acc[q][0] += acc[q + h][0];
      acc[q][1] += acc[q + h][1];
    }
  }
  block_store_moments_warp<2, T>(acc[0], partials + 2 * static_cast<size_t>(blockIdx.x));
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
  constexpr int T = kTpBlockElems / kTpElems;
  if (rounds == 13) {
    terminal_pair_kernel<Payoff, 13><<<n_blocks, T, 0, stream>>>(
        k0, k1, params, n_elems, n_paths_total, partials);
  } else if (rounds == 20) {
    terminal_pair_kernel<Payoff, 20><<<n_blocks, T, 0, stream>>>(
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

// terminal_pair_kernel's elements a block (its grid: ceil(n_elems / it),
// capped), elements a thread, and resident blocks per SM (VanillaCall,
// threefry-13).
int mc_terminal_pair_block_elems() { return mc::kTpBlockElems; }
int mc_terminal_pair_elems_per_thread() { return mc::kTpElems; }
int mc_terminal_pair_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mc::terminal_pair_kernel<mc::VanillaCall, 13>,
      mc::kTpBlockElems / mc::kTpElems, 0);
}

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
