// Heston kernels of the port, for sm_90a.
//
// heston_euler_kernel and heston_qe_kernel replace mc_tpu/models/heston.py
// _heston_partials_pallas (the Pallas call at :342).  The Euler kernel is
// here (the step: mc_tpu's heston_euler_step at :94, on the leg
// _heston_leg at :255): one path per thread over a grid-stride loop,
// kHestonThreads a block, step j drawing the normal pair (id, j);
// threefry-13 or -20; paths at or past `bound` add zeros.  Every payoff of
// the registry except the two Brownian-bridge barriers (they read the GBM
// sigma), the multi-word ones included.  Each block writes one row of f64
// [sum pay, sum pay^2] (reduce.cuh), no float atomics.  The QE kernel, its
// own loop, is in heston_qe_kernels.cu; mc_heston_partials launches either.
//
// Each path's payoff is the kernel's it replaced bit for bit (that kernel
// formed S = s0 * expf(w) at every step and held the antithetic twin in a
// branch of its step loop; the same partials on the H100,
// family_nmc_probe.py --partials --kernels heston_euler):
// - the spot is formed only where the payoff reads it (barrier.cuh): at
//   each step for a payoff whose update reads S (the Asian, the lookback,
//   the down-and-out call, the multi-word payoffs); for the bullet, the
//   up-and-out and the down-and-in calls, whose update reads S only through
//   S < B, the test is w <= below_max_all(s0, B), found once a block (S at
//   each step where s0 is below 0); once, at maturity, for the
//   terminal-only payoffs;
// - the plain and antithetic paths are kernels apart, the twin a second
//   lockstep leg on the negated pair (-z_v, -z_2).
//
// Heston's trajectories kernel (#13, the Pallas call at :549) is the family
// template's, HestonFamily in family_nmc_kernels.cu: its step is this
// kernel's Euler arithmetic at 13 rounds, so their paths agree bit for bit.
//
// What bounds it on the H100: operations.  A Heston Euler step spends a
// whole threefry pair (the GBM log-Euler step half of one), the Box-Muller
// transcendentals (log1pf, sqrtf, sincosf) and a sqrtf of v; the kSpot
// payoffs an expf for S.  The parameters are 68 bytes and each block writes
// 16.  The design keeps everything in registers: one thread per path, both
// legs stepped from the same draws.

#include <cstdint>

#include <cuda_runtime.h>

#include "barrier.cuh"
#include "heston.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

// A path's payoff (the pair's mean if antithetic) over n_steps Euler steps.
template <class Payoff, int ROUNDS, bool A>
__device__ __forceinline__ float heston_euler_pay(const HestonParams& h, float below_max,
                                                  bool by_w, uint32_t k0, uint32_t k1,
                                                  uint32_t id, int n_steps) {
  constexpr int L = A ? 2 : 1;  // leg 0 the path, leg 1 its antithetic twin
  const float s0 = h.pay.s0;
  float w[L], v[L], s[L];
  typename Payoff::State st[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    w[l] = 0.0f;
    v[l] = h.v0;
    s[l] = s0;
    st[l] = Payoff::init(h.pay);
  }
  for (int j = 0; j < n_steps; ++j) {
    float z_v, z_2;
    normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(j), z_v, z_2);
    heston_euler_step(h, z_v, z_2, w[0], v[0]);
    if constexpr (A) heston_euler_step(h, -z_v, -z_2, w[1], v[1]);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      leg_update<Payoff>(h.pay, s0, below_max, by_w, w[l], s[l], st[l]);
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) leg_end_spot<Payoff>(s0, n_steps > 0, w[l], s[l]);
  const float p = Payoff::terminal(st[0], s[0], h.pay);
  if constexpr (A) return 0.5f * (p + Payoff::terminal(st[1], s[1], h.pay));
  return p;
}

// The plain kernel at 6 blocks an SM (40 registers): at ptxas's own
// choice (32 registers, 8 blocks, a spill) it ran 1.6% slower on the H100.
// The antithetic kernel at 5 (48 registers; ptxas takes 40 for the call).
template <class Payoff, int ROUNDS, bool A>
__global__ void __launch_bounds__(kHestonThreads, A ? 5 : 6)
heston_euler_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params, int n_steps,
                    uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                    double* __restrict__ partials) {
  const HestonParams h = load_heston(params);
  bool by_w;
  const float below_max = block_below_max<Payoff>(h.pay, by_w);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kHestonThreads;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kHestonThreads + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {
        heston_euler_pay<Payoff, ROUNDS, A>(h, below_max, by_w, k0, k1, id, n_steps)};
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
#define MC_HESTON_EULER_LAUNCH(R, A)                                                      \
  heston_euler_kernel<Payoff, R, A><<<n_blocks, kHestonThreads, 0, stream>>>(            \
      k0, k1, params, n_steps, n_paths, path_offset, bound, partials);                  \
  return cudaGetLastError()
  if (rounds == 13) {
    if (antithetic) { MC_HESTON_EULER_LAUNCH(13, true); }
    MC_HESTON_EULER_LAUNCH(13, false);
  }
  if (rounds == 20) {
    if (antithetic) { MC_HESTON_EULER_LAUNCH(20, true); }
    MC_HESTON_EULER_LAUNCH(20, false);
  }
#undef MC_HESTON_EULER_LAUNCH
  return cudaErrorInvalidValue;
}

// The QE kernel's launch and occupancy (heston_qe_kernels.cu).
cudaError_t launch_heston_qe(int payoff_id, int rounds, int antithetic, uint32_t k0,
                             uint32_t k1, const float* params, int n_steps, uint32_t n_paths,
                             uint32_t path_offset, uint32_t bound, double* partials,
                             int n_blocks, cudaStream_t stream);
cudaError_t heston_qe_occupancy(int antithetic, int* blocks);

}  // namespace mc

extern "C" {

// The partials kernels' paths a block (their grid: ceil(n_paths / it),
// capped).
int mc_heston_block_paths() { return mc::kHestonThreads; }

// Resident blocks per SM of the partials kernel of a scheme (VanillaCall,
// threefry-13).
int mc_heston_occupancy(int qe, int antithetic, int* blocks) {
  if (qe) return mc::heston_qe_occupancy(antithetic, blocks);
  return antithetic ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, mc::heston_euler_kernel<mc::VanillaCall, 13, true>,
                          mc::kHestonThreads, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, mc::heston_euler_kernel<mc::VanillaCall, 13, false>,
                          mc::kHestonThreads, 0);
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

}  // extern "C"
