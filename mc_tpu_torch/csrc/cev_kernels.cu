// CEV kernel of the port, for sm_90a.
//
// cev_partials_kernel replaces mc_tpu/models/cev.py _cev_partials (the Pallas
// call at :161): the level-space Euler loop over step pairs, pair m =
// threefry-13 counter (id, m) feeding substeps 2m and 2m+1 (cev_substep,
// cev.cuh); the antithetic twin on the negated pair, averaged as 0.5*(a+b);
// paths at or past `bound` add zeros; each block writes one row of f64
// [sum pay, sum pay^2] (reduce.cuh), no float atomics.  Every payoff of the
// registry but the two Brownian-bridge barriers (the parameters have no
// sigma).  The CEV instantiations of the family NMC kernels are in
// cev_nmc_kernels.cu.
//
// One path a thread, kCevThreads = 256 a block, grid-strided, as the kernel
// it replaced; its block tree sums the threads, so every row keeps its
// bits.  The plain and antithetic paths are kernels apart (the replaced
// kernel's one loop held the twin's branch); the twin is a second lockstep
// leg on the negated pair.  (2 and 4 paths a thread in lockstep ran no
// faster on the H100: the loop is issue-bound, family_nmc_probe.py
// --partials.)
//
// The substep's S^beta takes its logf from cev_logf (cev.cuh): the
// toolkit's logf on the floats max(S, 1e-12) can be, without the
// subnormal, zero, negative and NaN handling no such float reaches;
// mc_cev_logf_check compares the two on every one of them.
//
// What bounds it on the H100: operations.  A step pair spends one threefry
// call and a Box-Muller pair (GBM's log-Euler step spends the same) and per
// substep a logf and an expf for S^beta and ~8 f32 operations; no expf for S
// (the step is in level space).  The parameters are 52 bytes and each block
// writes 16.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "cev.cuh"
#include "heston.cuh"  // MC_HESTON_PAYOFFS: every payoff but the two that read sigma
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kCevThreads = 256;

// A path's payoff (the pair's mean if antithetic) over n_steps from s0.
template <class Payoff, bool A>
__device__ __forceinline__ float cev_pay(const CEVParams& c, uint32_t k0, uint32_t k1,
                                         uint32_t id, int n_steps) {
  constexpr int L = A ? 2 : 1;  // leg 0 the path, leg 1 its antithetic twin
  float s[L];
  typename Payoff::State st[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    s[l] = c.pay.s0;
    st[l] = Payoff::init(c.pay);
  }
  for (int m = 0; m < n_steps / 2; ++m) {
    float z0[L], z1[L];
    normal_pair<13>(k0, k1, id, static_cast<uint32_t>(m), z0[0], z1[0]);
    if constexpr (A) {
      z0[1] = -z0[0];
      z1[1] = -z1[0];
    }
#pragma unroll
    for (int l = 0; l < L; ++l) cev_substep<Payoff, true>(c, z0[l], s[l], st[l]);
#pragma unroll
    for (int l = 0; l < L; ++l) cev_substep<Payoff, true>(c, z1[l], s[l], st[l]);
  }
  const float p = Payoff::terminal(st[0], s[0], c.pay);
  if constexpr (A) return 0.5f * (p + Payoff::terminal(st[1], s[1], c.pay));
  return p;
}

// The partials kernel: one path a thread, grid-strided; paths at or past
// `bound` add zeros; one f64 row [sum pay, sum pay^2] a block.
template <class Payoff, bool A>
__global__ void __launch_bounds__(kCevThreads)
cev_partials_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params, int n_steps,
                    uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                    double* __restrict__ partials) {
  const CEVParams c = load_cev(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kCevThreads;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kCevThreads + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {cev_pay<Payoff, A>(c, k0, k1, id, n_steps)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kCevThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Payoff, bool A>
cudaError_t launch_cev_partials(uint32_t k0, uint32_t k1, const float* params, int n_steps,
                                uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                double* partials, int n_blocks, cudaStream_t stream) {
  cev_partials_kernel<Payoff, A><<<n_blocks, kCevThreads, 0, stream>>>(
      k0, k1, params, n_steps, n_paths, path_offset, bound, partials);
  return cudaGetLastError();
}

// Counts in bad[0] the floats of [1e-12, FLT_MAX] and +inf (every value
// max(S, 1e-12f) can take) on which cev_logf is not logf bit for bit, and
// keeps the least such float's bits in bad[1] (0 when none).  Integer
// atomics only.
__global__ void cev_logf_check_kernel(uint32_t lo, unsigned long long* __restrict__ bad) {
  const uint64_t k = lo + static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k > 0x7f800000u) return;
  const float a = __uint_as_float(static_cast<uint32_t>(k));
  if (__float_as_uint(cev_logf(a)) != __float_as_uint(logf(a))) {
    atomicAdd(&bad[0], 1ull);
    atomicMin(&bad[1], static_cast<unsigned long long>(k));
  }
}

}  // namespace mc

extern "C" {

// The partials kernel's paths a block (its grid: ceil(n_paths / it),
// capped).
int mc_cev_block_paths() { return mc::kCevThreads; }

// Resident blocks per SM of the partials kernel (VanillaCall).
int mc_cev_occupancy(int antithetic, int* blocks) {
  return antithetic ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, mc::cev_partials_kernel<mc::VanillaCall, true>,
                          mc::kCevThreads, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, mc::cev_partials_kernel<mc::VanillaCall, false>,
                          mc::kCevThreads, 0);
}

// bad[2] = {0, ~0} at the call: cev_logf_check_kernel's count and least
// float.
int mc_cev_logf_check(unsigned long long* bad, void* stream) {
  const float lo_f = 1e-12f;
  uint32_t lo;
  std::memcpy(&lo, &lo_f, sizeof lo);
  const uint64_t n = 0x7f800000ull - lo + 1;
  mc::cev_logf_check_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(lo, bad);
  return cudaGetLastError();
}

int mc_cev_partials(int payoff_id, int antithetic, uint32_t k0, uint32_t k1,
                    const float* params, int n_steps, uint32_t n_paths, uint32_t path_offset,
                    uint32_t bound, double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_steps < 2 || n_steps % 2) return cudaErrorInvalidValue;
#define MC_CASE(ID, PAYOFF)                                                                 \
  case mc::ID:                                                                              \
    return antithetic ? mc::launch_cev_partials<mc::PAYOFF, true>(                          \
                            k0, k1, params, n_steps, n_paths, path_offset, bound, partials, \
                            n_blocks, s)                                                    \
                      : mc::launch_cev_partials<mc::PAYOFF, false>(                         \
                            k0, k1, params, n_steps, n_paths, path_offset, bound, partials, \
                            n_blocks, s);
  switch (payoff_id) {
    MC_HESTON_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;  // the bridge barriers read sigma
  }
#undef MC_CASE
}

}  // extern "C"
