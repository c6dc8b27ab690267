// Counter-based RNG on the device: threefry2x32 + Box-Muller.
//
// Device twin of mc_tpu_torch/rng.py (and of mc_tpu/rng.py:66-176): the
// normal pair for counter (c0, c1) under key (k0, k1) is a pure function, so
// a kernel, the plain PyTorch version and the JAX package draw one stream.
// Words are uint32_t, so adds wrap and shifts are logical as in the Python
// versions.  The key is injected after every 4th round; ROUNDS = 13 ends
// without an injection, as the Python loops do.
//
// Box-Muller uses the accurate single-precision library calls (log1pf, cosf,
// sinf, sqrtf): the build never passes --use_fast_math, whose __logf/__sinf
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
  z0 = rad * cosf(theta);
  z1 = rad * sinf(theta);
}

}  // namespace mc
