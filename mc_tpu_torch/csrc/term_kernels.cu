// Term-structure kernel of the port, for sm_90a.
//
// term_partials_kernel replaces mc_tpu/models/term.py _term_partials (the
// Pallas call at :189): one path per thread over a grid-stride loop; the
// log-Euler loop over step pairs, pair m = threefry-13 counter (id, m)
// feeding steps 2m and 2m+1 (term_step, term.cuh), each step reading its
// drift_dt[j] and vol_sdt[j]; the antithetic twin in the same thread on the
// negated pair, averaged as 0.5*(a+b); paths at or past `bound` add zeros;
// each block writes one row of f64 [sum pay, sum pay^2] (reduce.cuh), no
// float atomics.  Every payoff of the registry (the bridge barriers read the
// averaged sigma).  The term instantiations of the family NMC kernels are in
// term_nmc_kernels.cu.
//
// What bounds it on the H100: operations.  A step pair spends one threefry
// call and a Box-Muller pair, as GBM's log-Euler step, and per step two
// uniform loads (L1 broadcasts, term.cuh), 3 f32 operations and an expf.
// The curves are 888 bytes at n_steps = 100; each block writes 16.

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"
#include "term.cuh"

namespace mc {

constexpr int kTermThreads = 256;

template <class Payoff>
__device__ float term_pay(const TermParams& c, bool antithetic, uint32_t k0, uint32_t k1,
                          uint32_t id) {
  using State = typename Payoff::State;
  float w = 0.0f, s = c.pay.s0, wn = 0.0f, sn = c.pay.s0;
  State st = Payoff::init(c.pay), stn = st;
  for (int m = 0; m < c.n_steps / 2; ++m) {
    float z0, z1;
    normal_pair<13>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
    term_step<Payoff>(c, 2 * m, z0, w, s, st);
    term_step<Payoff>(c, 2 * m + 1, z1, w, s, st);
    if (antithetic) {
      term_step<Payoff>(c, 2 * m, -z0, wn, sn, stn);
      term_step<Payoff>(c, 2 * m + 1, -z1, wn, sn, stn);
    }
  }
  float p = Payoff::terminal(st, s, c.pay);
  if (antithetic) p = 0.5f * (p + Payoff::terminal(stn, sn, c.pay));
  return p;
}

template <class Payoff>
__global__ void __launch_bounds__(kTermThreads)
term_partials_kernel(int antithetic, uint32_t k0, uint32_t k1, const float* __restrict__ params,
                     int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                     double* __restrict__ partials) {
  const TermParams c = load_term(params, n_steps);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {term_pay<Payoff>(c, antithetic != 0, k0, k1, id)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kTermThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

}  // namespace mc

extern "C" {

int mc_term_block_threads() { return mc::kTermThreads; }

// params: the packed vector of 11 + 2*n_steps floats (the wrapper checks its
// length).
int mc_term_partials(int payoff_id, int antithetic, uint32_t k0, uint32_t k1,
                     const float* params, int n_steps, uint32_t n_paths, uint32_t path_offset,
                     uint32_t bound, double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_steps < 2 || n_steps % 2) return cudaErrorInvalidValue;
#define MC_CASE(ID, PAYOFF)                                                              \
  case mc::ID:                                                                           \
    mc::term_partials_kernel<mc::PAYOFF><<<n_blocks, mc::kTermThreads, 0, s>>>(          \
        antithetic, k0, k1, params, n_steps, n_paths, path_offset, bound, partials);     \
    return cudaGetLastError();
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
