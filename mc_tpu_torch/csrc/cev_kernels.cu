// CEV kernel of the port, for sm_90a.
//
// cev_partials_kernel replaces mc_tpu/models/cev.py _cev_partials (the Pallas
// call at :161): one path per thread over a grid-stride loop; the
// level-space Euler loop over step pairs, pair m = threefry-13 counter
// (id, m) feeding substeps 2m and 2m+1 (cev_substep, cev.cuh); the antithetic
// twin in the same thread on the negated pair, averaged as 0.5*(a+b); paths
// at or past `bound` add zeros; each block writes one row of f64
// [sum pay, sum pay^2] (reduce.cuh), no float atomics.  Every payoff of the
// registry but the two Brownian-bridge barriers (the parameters have no
// sigma).  The CEV instantiations of the family NMC kernels are in
// cev_nmc_kernels.cu.
//
// What bounds it on the H100: operations.  A step pair spends one threefry
// call and a Box-Muller pair (GBM's log-Euler step spends the same) and per
// substep a logf and an expf for S^beta and ~8 f32 operations; no expf for S
// (the step is in level space).  The parameters are 52 bytes and each block
// writes 16.  Everything stays in registers: one thread per path, both legs
// from the same draws.

#include <cstdint>

#include <cuda_runtime.h>

#include "cev.cuh"
#include "heston.cuh"  // MC_HESTON_PAYOFFS: every payoff but the two that read sigma
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kCevThreads = 256;

template <class Payoff>
__device__ float cev_pay(const CEVParams& c, bool antithetic, uint32_t k0, uint32_t k1,
                         uint32_t id, int n_steps) {
  using State = typename Payoff::State;
  float s = c.pay.s0, sn = c.pay.s0;
  State st = Payoff::init(c.pay), stn = st;
  for (int m = 0; m < n_steps / 2; ++m) {
    float z0, z1;
    normal_pair<13>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
    cev_substep<Payoff>(c, z0, s, st);
    cev_substep<Payoff>(c, z1, s, st);
    if (antithetic) {
      cev_substep<Payoff>(c, -z0, sn, stn);
      cev_substep<Payoff>(c, -z1, sn, stn);
    }
  }
  float p = Payoff::terminal(st, s, c.pay);
  if (antithetic) p = 0.5f * (p + Payoff::terminal(stn, sn, c.pay));
  return p;
}

template <class Payoff>
__global__ void __launch_bounds__(kCevThreads)
cev_partials_kernel(int antithetic, uint32_t k0, uint32_t k1, const float* __restrict__ params,
                    int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                    double* __restrict__ partials) {
  const CEVParams c = load_cev(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {cev_pay<Payoff>(c, antithetic != 0, k0, k1, id, n_steps)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kCevThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

}  // namespace mc

extern "C" {

int mc_cev_block_threads() { return mc::kCevThreads; }

int mc_cev_partials(int payoff_id, int antithetic, uint32_t k0, uint32_t k1,
                    const float* params, int n_steps, uint32_t n_paths, uint32_t path_offset,
                    uint32_t bound, double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_steps < 2 || n_steps % 2) return cudaErrorInvalidValue;
#define MC_CASE(ID, PAYOFF)                                                              \
  case mc::ID:                                                                           \
    mc::cev_partials_kernel<mc::PAYOFF><<<n_blocks, mc::kCevThreads, 0, s>>>(            \
        antithetic, k0, k1, params, n_steps, n_paths, path_offset, bound, partials);     \
    return cudaGetLastError();
  switch (payoff_id) {
    MC_HESTON_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;  // the bridge barriers read sigma
  }
#undef MC_CASE
}

}  // extern "C"
