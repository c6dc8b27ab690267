// Heston kernels of the port, for sm_90a.
//
// heston_euler_kernel and heston_qe_kernel replace mc_tpu/models/heston.py
// _heston_partials_pallas (the Pallas call at :342).  The Euler kernel is
// here: one path per thread over a grid-stride loop, step j drawing the
// normal pair (id, j); threefry-13 or -20; the antithetic twin in the same
// thread from the same draws, (z_v, z_2) -> (-z_v, -z_2); paths at or past
// `bound` add zeros.  Every payoff of the registry except the two
// Brownian-bridge barriers (they read the GBM sigma), the multi-word ones
// included.  Each block writes one row of f64 [sum pay, sum pay^2]
// (reduce.cuh), no float atomics.  The QE kernel, its own loop, is in
// heston_qe_kernels.cu; mc_heston_partials launches either.
//
// heston_trajectories_kernel replaces heston_trajectories_kernel (the
// Pallas call at :549): the Euler loop on threefry-13 that also stores S,
// the raw full-truncation v and payoff state word 0 after every step into
// step-major (n_steps, n_paths) grids, entry j*n_paths + i, so a warp's
// stores of one step are coalesced; the one-word payoffs only.  Its step is
// heston_outer_step, the family NMC's outer step (family_nmc_kernels.cu),
// and the Euler kernel's arithmetic at 13 rounds, so the three give the
// same paths bit for bit.
//
// What bounds them on the H100: operations.  A Heston Euler step spends a
// whole threefry pair (the GBM log-Euler step half of one), the Box-Muller
// transcendentals (log1pf, sqrtf, cosf, sinf), a sqrtf of v and one expf.
// The parameters are 68 bytes and each block writes 16; the trajectories
// write 12 bytes per path-step (120 MB at 100,000 x 100, 36 us at 3.35
// TB/s), less than their RNG work takes.  The design keeps everything in
// registers: one thread per path, both legs stepped from the same draws.

#include <cstdint>

#include <cuda_runtime.h>

#include "heston.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

// The Euler scheme as the partials body takes it: draw(j) gives the step's
// (z_v, z_2, u), step() advances (w, v).  The body keeps its scheme
// parameter and runtime antithetic flag so the Euler kernel's code, and so
// its bits and time, stay as they are; the QE kernel has its own loop
// (heston_qe_kernels.cu).
struct EulerScheme {
  template <int ROUNDS>
  __device__ static void draw(uint32_t k0, uint32_t k1, uint32_t id, int j, float& z_v,
                              float& z_2, float& u) {
    normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(j), z_v, z_2);
    u = 0.0f;
  }
  __device__ static void step(const HestonParams& h, const QeConsts&, float z_v, float z_2,
                              float, float& w, float& v) {
    heston_euler_step(h, z_v, z_2, w, v);
  }
};

template <class Payoff, class Scheme, int ROUNDS>
__device__ __forceinline__ void heston_partials_body(
    int antithetic, uint32_t k0, uint32_t k1, const float* __restrict__ params,
    int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
    double* __restrict__ partials) {
  using State = typename Payoff::State;
  const HestonParams h = load_heston(params);
  const QeConsts qc = qe_consts(h);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    float w = 0.0f, v = h.v0, s = h.pay.s0;
    float wn = 0.0f, vn = h.v0, sn = h.pay.s0;
    State st = Payoff::init(h.pay), stn = st;
    for (int j = 0; j < n_steps; ++j) {
      float z_v, z_2, u;
      Scheme::template draw<ROUNDS>(k0, k1, id, j, z_v, z_2, u);
      Scheme::step(h, qc, z_v, z_2, u, w, v);
      s = h.pay.s0 * expf(w);  // log-space: one exp rounding per S_t
      st = Payoff::update(st, s, h.pay);
      if (antithetic) {
        Scheme::step(h, qc, -z_v, -z_2, 1.0f - u, wn, vn);
        sn = h.pay.s0 * expf(wn);
        stn = Payoff::update(stn, sn, h.pay);
      }
    }
    float pay = Payoff::terminal(st, s, h.pay);
    if (antithetic) pay = 0.5f * (pay + Payoff::terminal(stn, sn, h.pay));
    const float pv[1] = {pay};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kHestonThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x),
                                         2);
}

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kHestonThreads)
heston_euler_kernel(int antithetic, uint32_t k0, uint32_t k1, const float* __restrict__ params,
                    int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                    double* __restrict__ partials) {
  heston_partials_body<Payoff, EulerScheme, ROUNDS>(antithetic, k0, k1, params, n_steps,
                                                    n_paths, path_offset, bound, partials);
}

template <class Payoff>
__global__ void __launch_bounds__(kHestonThreads)
heston_trajectories_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params,
                           int n_steps, uint32_t n_paths, uint32_t path_offset,
                           uint32_t bound, float* __restrict__ s_grid,
                           float* __restrict__ v_grid, float* __restrict__ state_grid,
                           double* __restrict__ partials) {
  const HestonParams h = load_heston(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    float w = 0.0f, v = h.v0, s = h.pay.s0;
    typename Payoff::State st = Payoff::init(h.pay);
    for (int j = 0; j < n_steps; ++j) {
      heston_outer_step<Payoff>(h, k0, k1, id, j, w, v, s, st);
      const size_t at = static_cast<size_t>(j) * n_paths + i;
      s_grid[at] = s;
      v_grid[at] = v;
      state_grid[at] = Payoff::kStates ? st.w[0] : 0.0f;
    }
    const float pv[1] = {Payoff::terminal(st, s, h.pay)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kHestonThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x),
                                         2);
}

template <class Payoff>
cudaError_t launch_heston_euler(int rounds, int antithetic, uint32_t k0, uint32_t k1,
                                const float* params, int n_steps, uint32_t n_paths,
                                uint32_t path_offset, uint32_t bound, double* partials,
                                int n_blocks, cudaStream_t stream) {
#define MC_HESTON_LAUNCH(R)                                                          \
  heston_euler_kernel<Payoff, R><<<n_blocks, kHestonThreads, 0, stream>>>(           \
      antithetic, k0, k1, params, n_steps, n_paths, path_offset, bound, partials)
  if (rounds == 13) {
    MC_HESTON_LAUNCH(13);
  } else if (rounds == 20) {
    MC_HESTON_LAUNCH(20);
  } else {
    return cudaErrorInvalidValue;
  }
#undef MC_HESTON_LAUNCH
  return cudaGetLastError();
}

// The QE kernel's launch and occupancy (heston_qe_kernels.cu).
cudaError_t launch_heston_qe(int payoff_id, int rounds, int antithetic, uint32_t k0,
                             uint32_t k1, const float* params, int n_steps, uint32_t n_paths,
                             uint32_t path_offset, uint32_t bound, double* partials,
                             int n_blocks, cudaStream_t stream);
cudaError_t heston_qe_occupancy(int antithetic, int* blocks);

}  // namespace mc

extern "C" {

// The partials and trajectories kernels' paths a block (their grid:
// ceil(n_paths / it), capped).
int mc_heston_block_paths() { return mc::kHestonThreads; }

// Resident blocks per SM of the partials kernel of a scheme (VanillaCall,
// threefry-13).
int mc_heston_occupancy(int qe, int antithetic, int* blocks) {
  if (qe) return mc::heston_qe_occupancy(antithetic, blocks);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mc::heston_euler_kernel<mc::VanillaCall, 13>, mc::kHestonThreads, 0);
}

int mc_heston_partials(int payoff_id, int qe, int rounds, int antithetic, uint32_t k0,
                       uint32_t k1, const float* params, int n_steps, uint32_t n_paths,
                       uint32_t path_offset, uint32_t bound, double* partials, int n_blocks,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qe) {
    return mc::launch_heston_qe(payoff_id, rounds, antithetic, k0, k1, params, n_steps,
                                n_paths, path_offset, bound, partials, n_blocks, s);
  }
#define MC_CASE(ID, PAYOFF)                                                          \
  case mc::ID:                                                                       \
    return mc::launch_heston_euler<mc::PAYOFF>(rounds, antithetic, k0, k1, params,   \
                                               n_steps, n_paths, path_offset, bound, \
                                               partials, n_blocks, s);
  switch (payoff_id) {
    MC_HESTON_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;  // the bridge barriers read sigma
  }
#undef MC_CASE
}

int mc_heston_trajectories(int payoff_id, uint32_t k0, uint32_t k1, const float* params,
                           int n_steps, uint32_t n_paths, uint32_t path_offset,
                           uint32_t bound, float* s_grid, float* v_grid, float* state_grid,
                           double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_CASE(ID, PAYOFF)                                                          \
  case mc::ID:                                                                       \
    mc::heston_trajectories_kernel<mc::PAYOFF>                                       \
        <<<n_blocks, mc::kHestonThreads, 0, s>>>(k0, k1, params, n_steps, n_paths,   \
                                                 path_offset, bound, s_grid, v_grid, \
                                                 state_grid, partials);              \
    return cudaGetLastError();
  switch (payoff_id) {
    MC_ONE_WORD_PAYOFFS(MC_CASE)  // the grid stores one state word
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
