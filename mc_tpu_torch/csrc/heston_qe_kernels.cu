// The Heston QE partials kernel of the port, for sm_90a.
//
// heston_qe_kernel replaces the QE scheme of mc_tpu/models/heston.py
// _heston_partials_pallas (the Pallas call at :342; the step is
// _heston_qe_leg, :223-252): one path per thread over a grid-stride loop,
// kHestonThreads a block, step j drawing the normal pair (id, 2j) and, where
// a leg takes the exponential sampler, the uniform of word 0 of (id, 2j+1);
// threefry-13 or -20; paths at or past `bound` add zeros; each block writes
// one row of f64 [sum pay, sum pay^2] (reduce.cuh), no float atomics.
// Every payoff but the two Brownian-bridge barriers (they read the GBM
// sigma).  mc_heston_partials (heston_kernels.cu) launches it.
//
// Each path's payoff is the kernel's it replaced bit for bit (that kernel
// ran both samplers every step and selected; the same partials on the
// H100, family_nmc_probe.py --partials --kernels heston_qe):
// - the QE step is split at psi <= 1.5 and a lane computes only its own
//   sampler and martingale correction (heston.cuh);
// - the exponential sampler's uniform, a whole threefry call, is drawn only
//   where a leg takes that sampler (heston_qe.cuh): never under the demo
//   dynamics, where psi <= 0.5625;
// - the spot is formed only where the payoff reads it (barrier.cuh);
// - the plain and antithetic paths are kernels apart (the replaced kernel's
//   one loop held the twin's branch), the twin a second lockstep leg on
//   the negated pair and 1 - u.
//
// What bounds it on the H100: operations.  A step spends one threefry call
// and its Box-Muller pair (log1pf, sqrtf, sincosf), the quadratic sampler
// (three divisions, two sqrtf) and its correction (a division and a logf),
// w's sqrtf; a kSpot payoff an expf.  The parameters are 68 bytes and each
// block writes 16.

#include <cstdint>

#include <cuda_runtime.h>

#include "heston.cuh"
#include "heston_qe.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

// A path's payoff (the pair's mean if antithetic) over n_steps.
template <class Payoff, int ROUNDS, bool A>
__device__ __forceinline__ float heston_qe_pay(const HestonParams& h, const QeConsts& qc,
                                               float below_max, bool by_w, uint32_t k0,
                                               uint32_t k1, uint32_t id, int n_steps) {
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
    const uint32_t c = 2u * static_cast<uint32_t>(j);
    float z_v[L], z_s[L];
    normal_pair<ROUNDS>(k0, k1, id, c, z_v[0], z_s[0]);
    if constexpr (A) {
      z_v[1] = -z_v[0];
      z_s[1] = -z_s[0];
    }
    qe_legs_step<L>(h, qc, z_v, z_s, [&] { return unit_draw<ROUNDS>(k0, k1, id, c + 1u); },
                    w, v);
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

template <class Payoff, int ROUNDS, bool A>
__global__ void __launch_bounds__(kHestonThreads)
heston_qe_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params, int n_steps,
                 uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                 double* __restrict__ partials) {
  const HestonParams h = load_heston(params);
  const QeConsts qc = qe_consts(h);
  bool by_w;
  const float below_max = block_below_max<Payoff>(h.pay, by_w);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kHestonThreads;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kHestonThreads + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {
        heston_qe_pay<Payoff, ROUNDS, A>(h, qc, below_max, by_w, k0, k1, id, n_steps)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kHestonThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x),
                                         2);
}

template <class Payoff>
cudaError_t launch_heston_qe_payoff(int rounds, int antithetic, uint32_t k0, uint32_t k1,
                                    const float* params, int n_steps, uint32_t n_paths,
                                    uint32_t path_offset, uint32_t bound, double* partials,
                                    int n_blocks, cudaStream_t stream) {
#define MC_HESTON_QE_LAUNCH(R, A)                                                         \
  heston_qe_kernel<Payoff, R, A><<<n_blocks, kHestonThreads, 0, stream>>>(               \
      k0, k1, params, n_steps, n_paths, path_offset, bound, partials);                  \
  return cudaGetLastError()
  if (rounds == 13) {
    if (antithetic) { MC_HESTON_QE_LAUNCH(13, true); }
    MC_HESTON_QE_LAUNCH(13, false);
  }
  if (rounds == 20) {
    if (antithetic) { MC_HESTON_QE_LAUNCH(20, true); }
    MC_HESTON_QE_LAUNCH(20, false);
  }
#undef MC_HESTON_QE_LAUNCH
  return cudaErrorInvalidValue;
}

cudaError_t launch_heston_qe(int payoff_id, int rounds, int antithetic, uint32_t k0,
                             uint32_t k1, const float* params, int n_steps, uint32_t n_paths,
                             uint32_t path_offset, uint32_t bound, double* partials,
                             int n_blocks, cudaStream_t stream) {
#define MC_CASE(ID, PAYOFF)                                                               \
  case ID:                                                                                \
    return launch_heston_qe_payoff<PAYOFF>(rounds, antithetic, k0, k1, params, n_steps,   \
                                           n_paths, path_offset, bound, partials,         \
                                           n_blocks, stream);
  switch (payoff_id) {
    MC_HESTON_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;  // the bridge barriers read sigma
  }
#undef MC_CASE
}

cudaError_t heston_qe_occupancy(int antithetic, int* blocks) {
  return antithetic ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, heston_qe_kernel<VanillaCall, 13, true>, kHestonThreads, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, heston_qe_kernel<VanillaCall, 13, false>, kHestonThreads,
                          0);
}

}  // namespace mc
