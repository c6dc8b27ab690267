// The randomized-QMC point source of the port's QMC kernels: a point's
// coordinate from its id, shared by qmc_kernels.cu (GBM, #31 and #32) and the
// model families' qmc_model_kernel (#33, qmc_model.cuh), so all compute the
// same coordinates bit for bit.
//
// Coordinate j of point i under shift r (qmc_unit):
//   lattice  t = i z_j mod n, exact in int32 by mc_tpu's float-assisted
//            Barrett reduction on the 10-bit split of z_j (every value
//            stays below 2^31 for n <= 2^20), then u = t * f32(1/n) +
//            shift_j and u - floor(u);
//   sobol    the direct Gray-code XOR of the 30 direction numbers of
//            dimension j over the bits of i ^ (i >> 1), XOR the 30-bit
//            digital shift, (x << 2) through bits_to_unit.
// The family is a runtime field, so the point families cost no template
// instantiations.  A dimension past the last reads the last.
#pragma once

#include <cstdint>

#include "rng.cuh"

namespace mc {

constexpr int kSobolBits = 30;

struct QmcPoints {
  int sobol;  // 0: lattice, 1: sobol
  int n, d;
  float inv_n;          // f32(1/n)
  const int* table;     // the generating vector (d) or directions (d*30)
  const float* shift_f;  // lattice shifts (R, d)
  const int* shift_i;    // sobol digital shifts (R, d)
};

// x mod n for 0 <= x < 2^31 (mc_tpu/qmc.py _mod_int): q = floor(x * (1/n))
// in f32 is off by at most one, corrected both ways.
__device__ __forceinline__ int mod_int(int x, int n, float inv_n) {
  const int q = static_cast<int>(floorf(static_cast<float>(x) * inv_n));
  int r = x - q * n;
  r = r < 0 ? r + n : r;
  return r >= n ? r - n : r;
}

__device__ __forceinline__ float qmc_unit(const QmcPoints& q, uint32_t id, int j, int r) {
  j = min(j, q.d - 1);
  if (!q.sobol) {
    const int i = static_cast<int>(id);
    const int z = __ldg(q.table + j);
    int t = mod_int(i * (z >> 10), q.n, q.inv_n);
    t = mod_int((t << 10) + i * (z & 1023), q.n, q.inv_n);
    const float u = static_cast<float>(t) * q.inv_n + __ldg(q.shift_f + r * q.d + j);
    return u - floorf(u);
  }
  const uint32_t gray = id ^ (id >> 1);
  const int* v = q.table + j * kSobolBits;
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < kSobolBits; ++k) {
    if ((gray >> k) & 1u) acc ^= static_cast<uint32_t>(__ldg(v + k));
  }
  acc ^= static_cast<uint32_t>(__ldg(q.shift_i + r * q.d + j));
  return bits_to_unit(acc << 2);
}

inline QmcPoints qmc_points(int family, int n, int d, const int* table, const void* shifts) {
  QmcPoints q;
  q.sobol = family;
  q.n = n;
  q.d = d;
  q.inv_n = static_cast<float>(1.0 / static_cast<double>(n));
  q.table = table;
  q.shift_f = family ? nullptr : static_cast<const float*>(shifts);
  q.shift_i = family ? static_cast<const int*>(shifts) : nullptr;
  return q;
}

inline bool qmc_args_ok(int family, int n, int d, int n_shifts, int n_bx) {
  return (family == 0 || family == 1) && n >= 1 && n <= (1 << 20) && d >= 1 &&
         n_shifts >= 1 && n_shifts < (1 << 16) && n_bx >= 1;
}

}  // namespace mc
