// Counter-based RNG on the device: threefry2x32 + Box-Muller, and the
// inverse normal CDF of the quasi-Monte Carlo points.
//
// Device twin of mc_tpu_torch/rng.py (and of mc_tpu/rng.py:66-272): the
// normal pair for counter (c0, c1) under key (k0, k1) is a pure function, so
// a kernel, the plain PyTorch version and the JAX package draw one stream.
// Words are uint32_t, so adds wrap and shifts are logical as in the Python
// versions.  The key is injected after every 4th round; ROUNDS = 13 ends
// without an injection, as the Python loops do.
//
// Box-Muller uses the accurate single-precision library calls (log1pf,
// sincosf, sqrtf): the build never passes --use_fast_math, whose __logf/__sinf
// would move the normals far more than the few ulp the parity tests allow.
#pragma once

#include <cstdint>

namespace mc {

// Threefry2x32 rotation schedule (Salmon et al. 2011, table 2).
__host__ __device__ constexpr int threefry_rotation(int i) {
  return i == 0 ? 13 : i == 1 ? 15 : i == 2 ? 26 : i == 3 ? 6
       : i == 4 ? 17 : i == 5 ? 29 : i == 6 ? 16 : 24;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

template <int ROUNDS>
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    x0 += x1;
    x1 = rotl32(x1, threefry_rotation(r % 8));
    x1 ^= x0;
    if ((r + 1) % 4 == 0) {  // key injection after every 4th round (R123)
      const int inj = (r + 1) / 4;
      x0 += ks[inj % 3];
      x1 += ks[(inj + 1) % 3] + static_cast<uint32_t>(inj);
    }
  }
}

// 32 random bits -> float uniform in [0, 1): exponent set to 0, minus 1.
__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

// The uniform of word 0 of counter (c0, c1): mc_tpu's draw_unit.
template <int ROUNDS>
__device__ __forceinline__ float unit_draw(uint32_t k0, uint32_t k1, uint32_t c0,
                                           uint32_t c1) {
  uint32_t x0 = c0, x1 = c1;
  threefry2x32<ROUNDS>(k0, k1, x0, x1);
  return bits_to_unit(x0);
}

template <int ROUNDS>
__device__ __forceinline__ void normal_pair(uint32_t k0, uint32_t k1,
                                            uint32_t c0, uint32_t c1,
                                            float& z0, float& z1) {
  uint32_t x0 = c0, x1 = c1;
  threefry2x32<ROUNDS>(k0, k1, x0, x1);
  const float u1 = bits_to_unit(x0);
  const float u2 = bits_to_unit(x1);
  // 1 - u1 in (0, 1]: log is finite; r = 0 when u1 == 0.
  const float rad = sqrtf(-2.0f * log1pf(-u1));
  const float theta = static_cast<float>(6.283185307179586) * u2;
  // One range reduction for both: sincosf is cosf and sinf bit for bit
  // (mc_nmc_libm_check in nmc_kernels.cu tests every theta this draw can
  // give, chip_smoke.py phase 2), where the two calls each reduced theta.
  float sin_t, cos_t;
  sincosf(theta, &sin_t, &cos_t);
  z0 = rad * cos_t;
  z1 = rad * sin_t;
}


// The inverse normal CDF of mc_tpu_torch/rng.py inv_normal_cdf (mc_tpu/rng.py
// :232-272), operation for operation: u clamped to [1e-6, 1 - 1e-6],
// Acklam's central and tail rationals by Horner (each mul and add rounded,
// --fmad=false), one Newton step against the Abramowitz-Stegun 7.1.26 erf
// where |x| < 3.  Not CUDA's normcdfinvf: a more accurate function, but
// another one.  Each constant is the f32 of its double, as PyTorch rounds
// a Python float.
#define MC_F32(x) static_cast<float>(x)

__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + MC_F32(0.3275911) * ax);
  const float poly = t * (MC_F32(0.254829592) +
                          t * (MC_F32(-0.284496736) +
                               t * (MC_F32(1.421413741) +
                                    t * (MC_F32(-1.453152027) + t * MC_F32(1.061405429)))));
  const float e = 1.0f - poly * expf(-ax * ax);
  const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return sgn * e;
}

__device__ __forceinline__ float inv_normal_cdf(float u) {
  u = fminf(fmaxf(u, MC_F32(1e-6)), MC_F32(1.0 - 1e-6));
  const float q = u - 0.5f;
  const float r = q * q;
  float num = MC_F32(-3.969683028665376e+01) * r + MC_F32(2.209460984245205e+02);
  num = num * r + MC_F32(-2.759285104469687e+02);
  num = num * r + MC_F32(1.383577518672690e+02);
  num = num * r + MC_F32(-3.066479806614716e+01);
  num = num * r + MC_F32(2.506628277459239e+00);
  float den = MC_F32(-5.447609879822406e+01) * r + MC_F32(1.615858368580409e+02);
  den = den * r + MC_F32(-1.556989798598866e+02);
  den = den * r + MC_F32(6.680131188771972e+01);
  den = den * r + MC_F32(-1.328068155288572e+01);
  den = den * r + 1.0f;
  const float central = q * num / den;
  const float u_tail = fminf(u, 1.0f - u);
  const float qt = sqrtf(-2.0f * logf(u_tail));
  float num_t = MC_F32(-7.784894002430293e-03) * qt + MC_F32(-3.223964580411365e-01);
  num_t = num_t * qt + MC_F32(-2.400758277161838e+00);
  num_t = num_t * qt + MC_F32(-2.549732539343734e+00);
  num_t = num_t * qt + MC_F32(4.374664141464968e+00);
  num_t = num_t * qt + MC_F32(2.938163982698783e+00);
  float den_t = MC_F32(7.784695709041462e-03) * qt + MC_F32(3.224671290700398e-01);
  den_t = den_t * qt + MC_F32(2.445134137142996e+00);
  den_t = den_t * qt + MC_F32(3.754408661907416e+00);
  den_t = den_t * qt + 1.0f;
  float tail = num_t / den_t;
  tail = u < 0.5f ? tail : -tail;
  const float p_low = MC_F32(0.02425);
  const float x = (u < p_low || u > 1.0f - p_low) ? tail : central;
  const float cdf = 0.5f * (1.0f + erf_as(x / MC_F32(1.4142135623730951)));
  const float pdf = MC_F32(0.3989422804014327) * expf(-0.5f * x * x);
  const float step = (cdf - u) / fmaxf(pdf, MC_F32(1e-10));
  return fabsf(x) < 3.0f ? x - step : x;
}
#undef MC_F32

}  // namespace mc
