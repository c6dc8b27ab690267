// The rainbow kernel of the port, for sm_90a.
//
// rainbow_partials_kernel replaces mc_tpu/models/rainbow.py _rainbow_partials
// (the Pallas call at :149): one path per thread over a grid-stride loop; one
// exact correlated terminal draw of d assets, the ceil(d/2) threefry pairs at
// counters (id, q) (13 or 20 rounds), the Cholesky mix y_i = L_i0 z_0 + L_i1
// z_1 + ... in k order, S_i = s0_i * expf(drift_i + sqrt_T * y_i), folded by
// max and min in asset order; the payoff a runtime switch (the same for
// every thread); the antithetic leg on the negated normals in the same
// thread (its y is -y exactly), averaged as 0.5*(a+b); paths at or past
// `bound` add zeros; each block writes one row of f64 [sum pay, sum pay^2]
// (reduce.cuh).  The twin of mc_tpu_torch/models/rainbow.py operation for
// operation (--fmad=false).
//
// The packed vector is the basket's at n_steps = 1 (basket.cuh: the drifts
// span the full horizon, sqrt_dt = sqrt(T)), d a runtime value in [1, 32]
// through the basket's two capacities: 8 (the loops unrolled and guarded,
// the normals in registers) and 32 (loops, the normals in local memory).
//
// What bounds it on the H100: operations.  A path spends ceil(d/2) threefry
// pairs and their Box-Muller, the mix's d(d+1)/2 multiply-adds (uniform
// loads of L from L1), d expf (2d with the antithetic leg) and ~4d f32
// operations more; the parameters are 4(10 + 3d + d(d+1)/2) bytes, each
// block writes 16.

#include <cstdint>

#include <cuda_runtime.h>

#include "basket.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kRainbowThreads = 256;

// Payoff ids of mc_tpu_torch/models/rainbow.py RAINBOW_PAYOFFS.
__device__ __forceinline__ float rainbow_pay(int payoff, float k, float mx, float mn, float s0,
                                             float s1) {
  switch (payoff) {
    case 0: return fmaxf(mx - k, 0.0f);   // call_on_max
    case 1: return fmaxf(mn - k, 0.0f);   // call_on_min
    case 2: return fmaxf(k - mx, 0.0f);   // put_on_max
    case 3: return fmaxf(k - mn, 0.0f);   // put_on_min
    case 4: return fmaxf(s0 - s1, 0.0f);  // exchange
    default: return fmaxf(mx, k);         // best_of_cash
  }
}

template <int kMaxD, int ROUNDS>
__global__ void __launch_bounds__(kRainbowThreads)
rainbow_partials_kernel(int payoff, int antithetic, uint32_t k0, uint32_t k1,
                        const float* __restrict__ params, int d, uint32_t n_paths,
                        uint32_t path_offset, uint32_t bound, double* __restrict__ partials) {
  const BasketParams<kMaxD> c = load_basket<kMaxD>(params, d);
  const float k = c.pay.k;
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    float z[kMaxD];
    basket_draw<kMaxD, ROUNDS>(c, k0, k1, id, 0u, 1.0f, z);
    // each leg's max, min and first two prices
    float mx = 0.0f, mn = 0.0f, a0 = 0.0f, a1 = 0.0f;
    float nx = 0.0f, nn = 0.0f, b0 = 0.0f, b1 = 0.0f;
#pragma unroll (BasketUnroll<kMaxD>::value)
    for (int a = 0; a < basket_bound<kMaxD>(c.d); ++a) {
      if (a < c.d) {
        const float y = basket_mix_y(c, z, a);
        const float s0a = __ldg(c.s0s + a), drift = __ldg(c.drift + a);
        const float s = s0a * expf(drift + c.sqrt_dt * y);
        mx = a == 0 ? s : fmaxf(mx, s);
        mn = a == 0 ? s : fminf(mn, s);
        if (a == 0) a0 = s;
        if (a == 1) a1 = s;
        if (antithetic) {
          const float sn = s0a * expf(drift + c.sqrt_dt * -y);
          nx = a == 0 ? sn : fmaxf(nx, sn);
          nn = a == 0 ? sn : fminf(nn, sn);
          if (a == 0) b0 = sn;
          if (a == 1) b1 = sn;
        }
      }
    }
    float p = rainbow_pay(payoff, k, mx, mn, a0, a1);
    if (antithetic) p = 0.5f * (p + rainbow_pay(payoff, k, nx, nn, b0, b1));
    const float pv[1] = {p};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kRainbowThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x),
                                          2);
}

template <int kMaxD, int ROUNDS>
cudaError_t launch_rainbow(int payoff, int antithetic, uint32_t k0, uint32_t k1,
                           const float* params, int d, uint32_t n_paths, uint32_t path_offset,
                           uint32_t bound, double* partials, int n_blocks, cudaStream_t stream) {
  rainbow_partials_kernel<kMaxD, ROUNDS><<<n_blocks, kRainbowThreads, 0, stream>>>(
      payoff, antithetic, k0, k1, params, d, n_paths, path_offset, bound, partials);
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_rainbow_block_threads() { return mc::kRainbowThreads; }

// params: the basket's packed vector at n_steps = 1, 10 + 3d + d(d+1)/2
// floats (the wrapper checks its length); d in [1, 32] (>= 2 for the
// exchange, payoff 4).
int mc_rainbow_partials(int payoff, int rounds, int antithetic, uint32_t k0, uint32_t k1,
                        const float* params, int d, uint32_t n_paths, uint32_t path_offset,
                        uint32_t bound, double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 32 || payoff < 0 || payoff > 5 || (payoff == 4 && d < 2) || n_blocks < 1)
    return cudaErrorInvalidValue;
  if (rounds == 13) {
    return d <= 8 ? mc::launch_rainbow<8, 13>(payoff, antithetic, k0, k1, params, d, n_paths,
                                              path_offset, bound, partials, n_blocks, s)
                  : mc::launch_rainbow<32, 13>(payoff, antithetic, k0, k1, params, d, n_paths,
                                               path_offset, bound, partials, n_blocks, s);
  }
  if (rounds == 20) {
    return d <= 8 ? mc::launch_rainbow<8, 20>(payoff, antithetic, k0, k1, params, d, n_paths,
                                              path_offset, bound, partials, n_blocks, s)
                  : mc::launch_rainbow<32, 20>(payoff, antithetic, k0, k1, params, d, n_paths,
                                               path_offset, bound, partials, n_blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
