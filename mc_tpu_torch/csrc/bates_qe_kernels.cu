// The Bates QE partials kernel of the port, for sm_90a.
//
// bates_qe_kernel replaces the QE scheme of mc_tpu/models/bates.py
// _bates_partials (the Pallas call at :269; the step is _bates_qe_leg,
// :163-200): one path per thread over a grid-stride loop, kBatesThreads a
// block; step j on counters 4j..4j+3: the diffusion pair (id, 4j), the QE
// uniform of word 0 of (id, 4j+1) where a leg takes the exponential
// sampler, the jump-size normal (the first of pair (id, 4j+2)) where a count
// can be nonzero, and the Poisson uniform of word 0 of (id, 4j+3); Heston's
// QE step, then the jump; threefry-13 or -20; paths at or past `bound` add
// zeros; each block writes one row of f64 [sum pay, sum pay^2]
// (reduce.cuh).  Every payoff but the two Brownian-bridge barriers.
// mc_bates_partials (bates_kernels.cu) launches it.
//
// Each path's payoff is the kernel's it replaced bit for bit (that kernel
// drew all four counters and scanned for the count every step; the same
// partials on the H100, family_nmc_probe.py --partials --kernels bates_qe):
// - Heston's branch-split QE step and its lazily drawn uniform, the spot
//   only where the payoff reads it (heston.cuh, barrier.cuh);
// - the Poisson count against the block's cdf table, thread 0 building it
//   and its least entry in shared memory (poisson_cdf_table: the scan's
//   recurrence in its order), bit for bit the scan's (merton.cuh);
// - the jump only where a count can be nonzero: a uniform below the
//   table's least entry counts 0 (the twin's is 1 - u_n), and a count of 0
//   gives the jump n*mu_j + (sigma_j*sqrtf(n))*e = +0 or -0 whatever the
//   finite e is (mu_j and sigma_j finite; else every step draws it).  Where
//   no leg's count can be nonzero the step's jump-size pair is not drawn and
//   w + 0 is added: the scan's w bit for bit because w is never -0 (it
//   starts at +0, and a sum is -0 only when both its terms are).  At
//   lam*dt = 0.003 a thread draws it on ~0.3% of its steps, a warp on ~9%
//   (antithetic ~0.6%, ~17%), as merton_kernels.cu's pairs;
// - the plain and antithetic paths are kernels apart, the twin a second
//   lockstep leg (normals negated, each uniform u -> 1 - u).
//
// What bounds it on the H100: operations.  A step spends two threefry calls
// (the diffusion pair's, with its Box-Muller, and the Poisson uniform's),
// Heston's quadratic QE step, a compare of the uniform with the table's
// least entry; the jump-size pair and the count (kmax compare-adds) where it
// reaches the table; a kSpot payoff an expf.  The parameters are 80 bytes
// and each block writes 16.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "bates.cuh"
#include "heston.cuh"
#include "heston_qe.cuh"
#include "merton.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

// A path's payoff (the pair's mean if antithetic) over n_steps; the counts
// against the block's table `cdf` (kmax entries, their least at cdf[kmax]).
template <class Payoff, int ROUNDS, bool A>
__device__ __forceinline__ float bates_qe_pay(const BatesParams& b, const QeConsts& qc,
                                              const float* cdf, int kmax, float below_max,
                                              bool by_w, uint32_t k0, uint32_t k1, uint32_t id,
                                              int n_steps) {
  constexpr int L = A ? 2 : 1;  // leg 0 the path, leg 1 its antithetic twin
  const float s0 = b.h.pay.s0;
  const float f_min = cdf[kmax];
  const bool always = !(isfinite(b.mu_j) && isfinite(b.sigma_j));
  float w[L], v[L], s[L];
  typename Payoff::State st[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    w[l] = 0.0f;
    v[l] = b.h.v0;
    s[l] = s0;
    st[l] = Payoff::init(b.h.pay);
  }
  for (int j = 0; j < n_steps; ++j) {
    const uint32_t c = 4u * static_cast<uint32_t>(j);
    float z_v[L], z_s[L], u_n[L];
    normal_pair<ROUNDS>(k0, k1, id, c, z_v[0], z_s[0]);
    u_n[0] = unit_draw<ROUNDS>(k0, k1, id, c + 3u);
    if constexpr (A) {
      z_v[1] = -z_v[0];
      z_s[1] = -z_s[0];
      u_n[1] = 1.0f - u_n[0];
    }
    qe_legs_step<L>(b.h, qc, z_v, z_s, [&] { return unit_draw<ROUNDS>(k0, k1, id, c + 1u); },
                    w, v);
    bool jumps = always;
#pragma unroll
    for (int l = 0; l < L; ++l) jumps = jumps || !(u_n[l] < f_min);
    float jump[L];
    if (jumps) {
      float e[L], n[L], unused;
      normal_pair<ROUNDS>(k0, k1, id, c + 2u, e[0], unused);
      if constexpr (A) e[1] = -e[0];
      poisson_counts(cdf, kmax, u_n, n);
#pragma unroll
      for (int l = 0; l < L; ++l) jump[l] = jump_increment(b.mu_j, b.sigma_j, n[l], e[l]);
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) jump[l] = 0.0f;
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      w[l] = w[l] + jump[l];
      leg_update<Payoff>(b.h.pay, s0, below_max, by_w, w[l], s[l], st[l]);
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) leg_end_spot<Payoff>(s0, n_steps > 0, w[l], s[l]);
  const float p = Payoff::terminal(st[0], s[0], b.h.pay);
  if constexpr (A) return 0.5f * (p + Payoff::terminal(st[1], s[1], b.h.pay));
  return p;
}

template <class Payoff, int ROUNDS, bool A>
__global__ void __launch_bounds__(kBatesThreads)
bates_qe_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params, int kmax,
                int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                double* __restrict__ partials) {
  __shared__ float cdf[kBatesMaxKmax + 1];
  const BatesParams b = load_bates(params);
  const QeConsts qc = qe_consts(b.h);
  if (threadIdx.x == 0) {
    poisson_cdf_table(b.lam_dt, kmax, cdf);
    float f_min = cdf[0];
    for (int k = 1; k < kmax; ++k) f_min = fminf(f_min, cdf[k]);
    cdf[kmax] = f_min;
  }
  bool by_w;
  const float below_max = block_below_max<Payoff>(b.h.pay, by_w);
  __syncthreads();
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kBatesThreads;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kBatesThreads + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {bates_qe_pay<Payoff, ROUNDS, A>(b, qc, cdf, kmax, below_max, by_w,
                                                         k0, k1, id, n_steps)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kBatesThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x),
                                        2);
}

template <class Payoff>
cudaError_t launch_bates_qe_payoff(int rounds, int antithetic, uint32_t k0, uint32_t k1,
                                   const float* params, int kmax, int n_steps,
                                   uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                   double* partials, int n_blocks, cudaStream_t stream) {
#define MC_BATES_QE_LAUNCH(R, A)                                                          \
  bates_qe_kernel<Payoff, R, A><<<n_blocks, kBatesThreads, 0, stream>>>(                 \
      k0, k1, params, kmax, n_steps, n_paths, path_offset, bound, partials);            \
  return cudaGetLastError()
  if (rounds == 13) {
    if (antithetic) { MC_BATES_QE_LAUNCH(13, true); }
    MC_BATES_QE_LAUNCH(13, false);
  }
  if (rounds == 20) {
    if (antithetic) { MC_BATES_QE_LAUNCH(20, true); }
    MC_BATES_QE_LAUNCH(20, false);
  }
#undef MC_BATES_QE_LAUNCH
  return cudaErrorInvalidValue;
}

cudaError_t launch_bates_qe(int payoff_id, int rounds, int antithetic, uint32_t k0,
                            uint32_t k1, const float* params, int kmax, int n_steps,
                            uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                            double* partials, int n_blocks, cudaStream_t stream) {
#define MC_CASE(ID, PAYOFF)                                                               \
  case ID:                                                                                \
    return launch_bates_qe_payoff<PAYOFF>(rounds, antithetic, k0, k1, params, kmax,       \
                                          n_steps, n_paths, path_offset, bound, partials, \
                                          n_blocks, stream);
  switch (payoff_id) {
    MC_HESTON_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;  // the bridge barriers read sigma
  }
#undef MC_CASE
}

cudaError_t bates_qe_occupancy(int antithetic, int* blocks) {
  return antithetic ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, bates_qe_kernel<VanillaCall, 13, true>, kBatesThreads, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, bates_qe_kernel<VanillaCall, 13, false>, kBatesThreads, 0);
}

}  // namespace mc
