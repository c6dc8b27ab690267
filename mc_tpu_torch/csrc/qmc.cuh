// The randomized-QMC point source of the port's QMC kernels: a point's
// coordinate from its id, shared by qmc_kernels.cu (GBM, #31 and #32) and the
// model families' qmc_model_kernel (#33, qmc_model.cuh), so all compute the
// same coordinates bit for bit.
//
// Coordinate j of point i under shift r, in two parts (qmc_units): the part
// that does not depend on the shift (qmc_base), computed once for a point
// and dimension, and the shift's (qmc_shifted), once for each shift:
//   lattice  t = i z_j mod n, exact in int32 by mc_tpu's float-assisted
//            Barrett reduction on the 10-bit split of z_j (every value
//            stays below 2^31 for n <= 2^20), and t * f32(1/n); then
//            u = that + shift_j and u - floor(u);
//   sobol    the direct Gray-code XOR of the direction numbers of dimension
//            j over the set bits of i ^ (i >> 1); then XOR the 30-bit
//            digital shift, (x << 2) through bits_to_unit.  Ids stay below
//            n <= 2^20 (qmc_args_ok), so the Gray code has no set bit past
//            bit 19 and the XOR runs over kSobolIdBits = 20 bits, the same
//            bits as over all 30.
// The family is a runtime field, so the point families cost no template
// instantiations.  A dimension past the last reads the last.
#pragma once

#include <cstdint>

#include "rng.cuh"

namespace mc {

constexpr int kSobolBits = 30;
constexpr int kSobolIdBits = 20;
constexpr int kQmcMaxPoints = 1 << kSobolIdBits;

// The shifts a thread of a QMC kernel runs at once: the kernel's own
// choice.  Only family_nmc_probe.py's sweeps define MC_QMC_SHIFTS, to build
// every kernel at another count; the library exports what it was built
// with (mc_qmc_shifts, mc_qmc_model_shifts), and qmc.kernel_launch reads it.
constexpr int qmc_shifts(int own) {
#ifdef MC_QMC_SHIFTS
  return static_cast<void>(own), MC_QMC_SHIFTS;
#else
  return own;
#endif
}

struct QmcPoints {
  int sobol;  // 0: lattice, 1: sobol
  int n, d, n_shifts;
  float inv_n;           // f32(1/n)
  const int* table;      // the generating vector (d) or directions (d*30)
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

// The shift-independent part of coordinate j (< d) of point id: the
// lattice's t * f32(1/n) as bits, or the Sobol XOR.  The table is the same
// for every thread of a block but the id: uniform loads, an L1 broadcast.
// On the H100 a copy staged in shared memory measured no faster, and
// __ldg's read-only loads 2-10% slower (ptxas gave the legs more
// registers, an SM a block fewer).
__device__ __forceinline__ uint32_t qmc_base(const QmcPoints& q, uint32_t id, int j) {
  if (!q.sobol) {
    const int i = static_cast<int>(id);
    const int z = q.table[j];
    int t = mod_int(i * (z >> 10), q.n, q.inv_n);
    t = mod_int((t << 10) + i * (z & 1023), q.n, q.inv_n);
    return __float_as_uint(static_cast<float>(t) * q.inv_n);
  }
  const uint32_t gray = id ^ (id >> 1);
  const int* v = q.table + j * kSobolBits;
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < kSobolIdBits; ++k) {
    if ((gray >> k) & 1u) acc ^= static_cast<uint32_t>(v[k]);
  }
  return acc;
}

// Coordinate j (< d) under shift r from its shift-independent part.
__device__ __forceinline__ float qmc_shifted(const QmcPoints& q, uint32_t base, int j, int r) {
  if (!q.sobol) {
    const float u = __uint_as_float(base) + __ldg(q.shift_f + r * q.d + j);
    return u - floorf(u);
  }
  return bits_to_unit((base ^ static_cast<uint32_t>(__ldg(q.shift_i + r * q.d + j))) << 2);
}

// Coordinate j of point id under the K shifts r0 .. r0+K-1 (a shift past
// the last reads the last), its base computed once.
template <int K>
__device__ __forceinline__ void qmc_units(const QmcPoints& q, uint32_t id, int j, int r0,
                                          float (&u)[K]) {
  j = min(j, q.d - 1);
  const uint32_t base = qmc_base(q, id, j);
#pragma unroll
  for (int k = 0; k < K; ++k) u[k] = qmc_shifted(q, base, j, min(r0 + k, q.n_shifts - 1));
}

template <int K>
__device__ __forceinline__ void qmc_normals(const QmcPoints& q, uint32_t id, int j, int r0,
                                            float (&z)[K]) {
  qmc_units<K>(q, id, j, r0, z);
#pragma unroll
  for (int k = 0; k < K; ++k) z[k] = inv_normal_cdf(z[k]);
}

inline QmcPoints qmc_points(int family, int n, int d, int n_shifts, const int* table,
                            const void* shifts) {
  QmcPoints q;
  q.sobol = family;
  q.n = n;
  q.d = d;
  q.n_shifts = n_shifts;
  q.inv_n = static_cast<float>(1.0 / static_cast<double>(n));
  q.table = table;
  q.shift_f = family ? nullptr : static_cast<const float*>(shifts);
  q.shift_i = family ? static_cast<const int*>(shifts) : nullptr;
  return q;
}

inline bool qmc_args_ok(int family, int n, int d, int n_shifts, int n_bx) {
  return (family == 0 || family == 1) && n >= 1 && n <= kQmcMaxPoints && d >= 1 &&
         n_shifts >= 1 && n_shifts < (1 << 16) && n_bx >= 1;
}

// The shift groups of a launch (blockIdx.y), as the caller (qmc.py
// qmc_launch) computed them: ceil(R / K).
inline bool qmc_groups_ok(const QmcPoints& q, int k_shifts, int n_groups) {
  return n_groups == (q.n_shifts + k_shifts - 1) / k_shifts;
}

}  // namespace mc
