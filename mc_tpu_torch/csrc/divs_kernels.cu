// Cash-dividend kernel of the port, for sm_90a.
//
// divs_partials_kernel replaces mc_tpu/models/dividends.py _divs_partials
// (the Pallas call at :160): one path per thread over a grid-stride loop;
// the level-space loop over step pairs, pair m = threefry-13 counter (id, m)
// feeding steps 2m and 2m+1 (divs_step, divs.cuh: the exact GBM factor,
// then the cash drop D_j floored at 1e-6); the antithetic twin in the same
// thread on the negated pair, averaged as 0.5*(a+b); paths at or past
// `bound` add zeros; each block writes one row of f64 [sum pay, sum pay^2]
// (reduce.cuh), no float atomics.  Every payoff of the registry, on the
// post-dividend path.
//
// What bounds it on the H100: operations.  A step pair spends one threefry
// call and a Box-Muller pair, as GBM's log-Euler step, and per step one
// uniform load (D_j, an L1 broadcast), 4 f32 operations and an expf.  The
// head and amounts are 452 bytes at n_steps = 100; each block writes 16.

#include <cstdint>

#include <cuda_runtime.h>

#include "divs.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kDivsThreads = 256;

template <class Payoff>
__device__ float divs_pay(const DivsParams& c, bool antithetic, uint32_t k0, uint32_t k1,
                          uint32_t id, int n_steps) {
  using State = typename Payoff::State;
  float s = c.pay.s0, sn = c.pay.s0;
  State st = Payoff::init(c.pay), stn = st;
  for (int m = 0; m < n_steps / 2; ++m) {
    float z0, z1;
    normal_pair<13>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
    divs_step<Payoff>(c, 2 * m, z0, s, st);
    divs_step<Payoff>(c, 2 * m + 1, z1, s, st);
    if (antithetic) {
      divs_step<Payoff>(c, 2 * m, -z0, sn, stn);
      divs_step<Payoff>(c, 2 * m + 1, -z1, sn, stn);
    }
  }
  float p = Payoff::terminal(st, s, c.pay);
  if (antithetic) p = 0.5f * (p + Payoff::terminal(stn, sn, c.pay));
  return p;
}

template <class Payoff>
__global__ void __launch_bounds__(kDivsThreads)
divs_partials_kernel(int antithetic, uint32_t k0, uint32_t k1, const float* __restrict__ params,
                     int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                     double* __restrict__ partials) {
  const DivsParams c = load_divs(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {divs_pay<Payoff>(c, antithetic != 0, k0, k1, id, n_steps)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kDivsThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

}  // namespace mc

extern "C" {

int mc_divs_block_threads() { return mc::kDivsThreads; }

// params: the packed vector of 13 + n_steps floats (the wrapper checks its
// length).
int mc_divs_partials(int payoff_id, int antithetic, uint32_t k0, uint32_t k1,
                     const float* params, int n_steps, uint32_t n_paths, uint32_t path_offset,
                     uint32_t bound, double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_steps < 2 || n_steps % 2) return cudaErrorInvalidValue;
#define MC_CASE(ID, PAYOFF)                                                              \
  case mc::ID:                                                                           \
    mc::divs_partials_kernel<mc::PAYOFF><<<n_blocks, mc::kDivsThreads, 0, s>>>(          \
        antithetic, k0, k1, params, n_steps, n_paths, path_offset, bound, partials);     \
    return cudaGetLastError();
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
