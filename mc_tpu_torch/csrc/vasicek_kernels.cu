// Vasicek kernel of the port, for sm_90a.
//
// vasicek_partials_kernel replaces mc_tpu/models/vasicek.py _vasicek_partials
// (the Pallas call at :277): one path per thread over a grid-stride loop;
// the loop over step pairs m drawing the pairs (id, 3m), (id, 3m+1), (id,
// 3m+2) -> z0..z5, step 2m on (z0, z1, z2) and step 2m+1 on (z3, z4, z5)
// (vasicek_step, vasicek.cuh), the payoff updated on S and its terminal value
// discounted by the path's own exp(-y_T); threefry-13 or -20; the antithetic
// twin in the same thread on the negated normals, averaged as 0.5*(a+b);
// paths at or past `bound` add zeros; each block writes one row of f64 [sum
// pay, sum pay^2] (reduce.cuh), no float atomics.  Every payoff of the
// registry (the parameters carry sigma_s, which the bridge barriers read).
// vasicek_trajectories (#24) and the Vasicek instantiations of the family
// NMC kernels are in vasicek_nmc_kernels.cu.
//
// What bounds it on the H100: operations.  A step takes one and a half
// threefry pairs (three normals), ~20 f32 operations and an expf; the path
// one more expf.  The parameters are 88 bytes and each block writes 16.
// Everything stays in registers: one thread per path, both legs from the
// same draws.

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"
#include "vasicek.cuh"

namespace mc {

constexpr int kVasicekThreads = 256;

template <class Payoff, int ROUNDS>
__device__ float vasicek_pay(const VasicekParams& c, bool antithetic, uint32_t k0, uint32_t k1,
                             uint32_t id, int n_steps) {
  using State = typename Payoff::State;
  VasicekState g{0.0f, c.x0, 0.0f}, gn = g;
  float s = c.pay.s0, sn = c.pay.s0;
  State st = Payoff::init(c.pay), stn = st;
  for (int m = 0; m < n_steps / 2; ++m) {
    float z[6];
    vasicek_draw6<ROUNDS>(k0, k1, id, m, z);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float za = z[3 * h], zb = z[3 * h + 1], zc = z[3 * h + 2];
      s = vasicek_step(c, za, zb, zc, c.pay.s0, g);
      st = Payoff::update(st, s, c.pay);
      if (antithetic) {
        sn = vasicek_step(c, -za, -zb, -zc, c.pay.s0, gn);
        stn = Payoff::update(stn, sn, c.pay);
      }
    }
  }
  float p = Payoff::terminal(st, s, c.pay) * expf(-g.y);
  if (antithetic) p = 0.5f * (p + Payoff::terminal(stn, sn, c.pay) * expf(-gn.y));
  return p;
}

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kVasicekThreads)
vasicek_partials_kernel(int antithetic, uint32_t k0, uint32_t k1,
                        const float* __restrict__ params, int n_steps, uint32_t n_paths,
                        uint32_t path_offset, uint32_t bound, double* __restrict__ partials) {
  const VasicekParams c = load_vasicek(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float pv[1] = {vasicek_pay<Payoff, ROUNDS>(c, antithetic != 0, k0, k1, id, n_steps)};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kVasicekThreads>(acc,
                                          partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Payoff>
cudaError_t launch_vasicek_partials(int rounds, int antithetic, uint32_t k0, uint32_t k1,
                                    const float* params, int n_steps, uint32_t n_paths,
                                    uint32_t path_offset, uint32_t bound, double* partials,
                                    int n_blocks, cudaStream_t stream) {
  if (rounds == 13) {
    vasicek_partials_kernel<Payoff, 13><<<n_blocks, kVasicekThreads, 0, stream>>>(
        antithetic, k0, k1, params, n_steps, n_paths, path_offset, bound, partials);
  } else if (rounds == 20) {
    vasicek_partials_kernel<Payoff, 20><<<n_blocks, kVasicekThreads, 0, stream>>>(
        antithetic, k0, k1, params, n_steps, n_paths, path_offset, bound, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_vasicek_block_threads() { return mc::kVasicekThreads; }

int mc_vasicek_partials(int payoff_id, int rounds, int antithetic, uint32_t k0, uint32_t k1,
                        const float* params, int n_steps, uint32_t n_paths, uint32_t path_offset,
                        uint32_t bound, double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_steps < 2 || n_steps % 2) return cudaErrorInvalidValue;
#define MC_CASE(ID, PAYOFF)                                                              \
  case mc::ID:                                                                           \
    return mc::launch_vasicek_partials<mc::PAYOFF>(rounds, antithetic, k0, k1, params,   \
                                                   n_steps, n_paths, path_offset, bound, \
                                                   partials, n_blocks, s);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
