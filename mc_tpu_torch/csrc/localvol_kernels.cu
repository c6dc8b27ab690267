// Local-volatility kernel of the port, for sm_90a.
//
// localvol_partials_kernel replaces mc_tpu/models/localvol.py
// _localvol_partials (the Pallas call at :275): one path per thread over a
// grid-stride loop; the log-Euler loop over step pairs, pair m = threefry
// counter (id, m) feeding steps 2m and 2m+1 (lv_step, localvol.cuh), each
// step's sigma looked up as K-1 clamped ramps on surface row j; threefry-13
// or -20; the antithetic twin in the same thread on the negated pair,
// averaged as 0.5*(a+b); paths at or past `bound` add zeros; each block
// writes one row of f64 [sum pay, sum pay^2] (reduce.cuh), no float atomics.
// Every payoff of the registry.  localvol_trajectories (#20) and the
// local-vol instantiations of the family NMC kernels are in
// localvol_nmc_kernels.cu.
//
// What bounds it on the H100: operations.  A step pair spends one threefry
// call and a Box-Muller pair (as GBM's log-Euler step), and per step the
// lookup (K-1 ramps of a subtract, max, min, multiply and add: 5(K-1) f32
// operations and 3(K-1)+1 uniform loads from L1), ~9 f32 operations and an
// expf.  The surface is 3.7 KB at K = 9, n_steps = 100; each block writes 16
// bytes.

#include <cstdint>

#include <cuda_runtime.h>

#include "localvol.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kLocalVolThreads = 256;

template <class Payoff, int ROUNDS>
__device__ float localvol_pay(const LocalVolParams& l, bool antithetic, uint32_t k0,
                              uint32_t k1, uint32_t id) {
  using State = typename Payoff::State;
  float w = 0.0f, s = l.pay.s0, wn = 0.0f, sn = l.pay.s0;
  State st = Payoff::init(l.pay), stn = st;
  for (int m = 0; m < l.n_steps / 2; ++m) {
    float z0, z1;
    normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
    lv_step<Payoff>(l, 2 * m, z0, w, s, st);
    lv_step<Payoff>(l, 2 * m + 1, z1, w, s, st);
    if (antithetic) {
      lv_step<Payoff>(l, 2 * m, -z0, wn, sn, stn);
      lv_step<Payoff>(l, 2 * m + 1, -z1, wn, sn, stn);
    }
  }
  float p = Payoff::terminal(st, s, l.pay);
  if (antithetic) p = 0.5f * (p + Payoff::terminal(stn, sn, l.pay));
  return p;
}

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kLocalVolThreads)
localvol_partials_kernel(int antithetic, uint32_t k0, uint32_t k1,
                         const float* __restrict__ params, int n_knots, int n_steps,
                         uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                         double* __restrict__ partials) {
  const LocalVolParams l = load_localvol(params, n_knots, n_steps);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {localvol_pay<Payoff, ROUNDS>(l, antithetic != 0, k0, k1, id)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kLocalVolThreads>(acc,
                                           partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Payoff>
cudaError_t launch_localvol_partials(int rounds, int antithetic, uint32_t k0, uint32_t k1,
                                     const float* params, int n_knots, int n_steps,
                                     uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                     double* partials, int n_blocks, cudaStream_t stream) {
  if (rounds == 13) {
    localvol_partials_kernel<Payoff, 13><<<n_blocks, kLocalVolThreads, 0, stream>>>(
        antithetic, k0, k1, params, n_knots, n_steps, n_paths, path_offset, bound, partials);
  } else if (rounds == 20) {
    localvol_partials_kernel<Payoff, 20><<<n_blocks, kLocalVolThreads, 0, stream>>>(
        antithetic, k0, k1, params, n_knots, n_steps, n_paths, path_offset, bound, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_localvol_block_threads() { return mc::kLocalVolThreads; }

// params: the packed vector of 11 + 2K - 1 + n_steps*K floats (the wrapper
// checks its length).
int mc_localvol_partials(int payoff_id, int rounds, int antithetic, uint32_t k0, uint32_t k1,
                         const float* params, int n_knots, int n_steps, uint32_t n_paths,
                         uint32_t path_offset, uint32_t bound, double* partials, int n_blocks,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_knots < 2 || n_steps < 2 || n_steps % 2) return cudaErrorInvalidValue;
#define MC_CASE(ID, PAYOFF)                                                              \
  case mc::ID:                                                                           \
    return mc::launch_localvol_partials<mc::PAYOFF>(rounds, antithetic, k0, k1, params,  \
                                                    n_knots, n_steps, n_paths,           \
                                                    path_offset, bound, partials,        \
                                                    n_blocks, s);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
