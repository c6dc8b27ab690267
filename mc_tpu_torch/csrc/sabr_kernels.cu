// SABR kernel of the port, for sm_90a.
//
// sabr_partials_kernel replaces mc_tpu/models/sabr.py _sabr_partials (the
// Pallas call at :188): one path per thread over a grid-stride loop; the
// step loop from log(f0) and alpha, step j drawing the pair (id, j) ->
// (z_vol, z_perp) (sabr_step, sabr.cuh), the payoff updated on F =
// expf(log F); threefry-13 or -20; the antithetic twin in the same thread on
// the negated pair, averaged as 0.5*(a+b); paths at or past `bound` add
// zeros; each block writes one row of f64 [sum pay, sum pay^2] (reduce.cuh),
// no float atomics.  Every payoff of the registry but the two
// Brownian-bridge barriers (the parameters have no sigma).  The SABR
// instantiations of the family NMC kernels are in sabr_nmc_kernels.cu.
//
// What bounds it on the H100: operations.  A step spends a whole threefry
// pair (twice GBM's log-Euler step, Heston's shape), the Box-Muller
// transcendentals and three expf (the local vol, the vol factor and F), and
// ~17 f32 operations.  The parameters are 68 bytes and each block writes 16.
// Everything stays in registers: one thread per path, both legs from the
// same draws.

#include <cstdint>

#include <cuda_runtime.h>

#include "heston.cuh"  // MC_HESTON_PAYOFFS: every payoff but the two that read sigma
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"
#include "sabr.cuh"

namespace mc {

constexpr int kSabrThreads = 256;

template <class Payoff, int ROUNDS>
__device__ float sabr_pay(const SABRParams& c, bool antithetic, uint32_t k0, uint32_t k1,
                          uint32_t id, int n_steps) {
  using State = typename Payoff::State;
  const float logf0 = logf(c.f0);
  float lf = logf0, sig = c.alpha, lfn = logf0, sig_n = c.alpha;
  State st = Payoff::init(c.pay), stn = st;
  for (int j = 0; j < n_steps; ++j) {
    float z_vol, z_perp;
    normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(j), z_vol, z_perp);
    sabr_step(c, z_vol, z_perp, lf, sig);
    st = Payoff::update(st, expf(lf), c.pay);
    if (antithetic) {
      sabr_step(c, -z_vol, -z_perp, lfn, sig_n);
      stn = Payoff::update(stn, expf(lfn), c.pay);
    }
  }
  float p = Payoff::terminal(st, expf(lf), c.pay);
  if (antithetic) p = 0.5f * (p + Payoff::terminal(stn, expf(lfn), c.pay));
  return p;
}

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kSabrThreads)
sabr_partials_kernel(int antithetic, uint32_t k0, uint32_t k1, const float* __restrict__ params,
                     int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                     double* __restrict__ partials) {
  const SABRParams c = load_sabr(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {sabr_pay<Payoff, ROUNDS>(c, antithetic != 0, k0, k1, id, n_steps)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kSabrThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Payoff>
cudaError_t launch_sabr_partials(int rounds, int antithetic, uint32_t k0, uint32_t k1,
                                 const float* params, int n_steps, uint32_t n_paths,
                                 uint32_t path_offset, uint32_t bound, double* partials,
                                 int n_blocks, cudaStream_t stream) {
  if (rounds == 13) {
    sabr_partials_kernel<Payoff, 13><<<n_blocks, kSabrThreads, 0, stream>>>(
        antithetic, k0, k1, params, n_steps, n_paths, path_offset, bound, partials);
  } else if (rounds == 20) {
    sabr_partials_kernel<Payoff, 20><<<n_blocks, kSabrThreads, 0, stream>>>(
        antithetic, k0, k1, params, n_steps, n_paths, path_offset, bound, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_sabr_block_threads() { return mc::kSabrThreads; }

int mc_sabr_partials(int payoff_id, int rounds, int antithetic, uint32_t k0, uint32_t k1,
                     const float* params, int n_steps, uint32_t n_paths, uint32_t path_offset,
                     uint32_t bound, double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_steps < 1) return cudaErrorInvalidValue;
#define MC_CASE(ID, PAYOFF)                                                              \
  case mc::ID:                                                                           \
    return mc::launch_sabr_partials<mc::PAYOFF>(rounds, antithetic, k0, k1, params,      \
                                                n_steps, n_paths, path_offset, bound,    \
                                                partials, n_blocks, s);
  switch (payoff_id) {
    MC_HESTON_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;  // the bridge barriers read sigma
  }
#undef MC_CASE
}

}  // extern "C"
