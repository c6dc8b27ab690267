// The European swaption tiles of the rates: one per-path payoff each, read
// from a packed f32 vector (ops/fused.py TILES).
//
// Device twins of mc_tpu_torch/models/{swaption,hullwhite,g2pp}.py
// va_swpt_pay, hw_swpt_pay, hw_mc_swpt_pay, g2_swpt_pay and g2_mc_swpt_pay
// (mc_tpu/models/swaption.py:197 _va_swpt_tile, hullwhite.py:323
// _hw_swpt_tile, g2pp.py:284 _g2_swpt_tile, and the classic multi-curve
// arithmetic of hullwhite.py:236-247,373-374 and g2pp.py:191-216) operation
// for operation: each mul and add rounds on its own (--fmad=false), the
// principal rides the last bond as fixed + p, and the sign of a receiver
// multiplies the swap.  The packed vector holds n payments' tables after a
// short header; every thread of the grid reads the same address, so the
// loads are uniform and the tables sit in L1, with no limit on n.
#pragma once

#include <cstdint>

#include "rng.cuh"

namespace mc {

__device__ __forceinline__ float ld(const float* __restrict__ p, int i) { return __ldg(p + i); }

// Vasicek: header x0, e1, B, l11, l21, l22, b*T, K*tau, sign, b; then
// logA_j and B_j.  The exact (x, y) = (r - b, int r) pair at expiry from the
// threefry pair at (id, 0); bonds exp(logA_j - B_j r); pay max(swap, 0) e^-y.
struct VaSwpt {
  static constexpr int kHeader = 10;
  __device__ static float pay(const float* __restrict__ pv, int n, uint32_t k0, uint32_t k1,
                              uint32_t id) {
    float z0, z1;
    normal_pair<13>(k0, k1, id, 0u, z0, z1);
    const float x0 = ld(pv, 0);
    const float x = x0 * ld(pv, 1) + ld(pv, 3) * z0;
    const float y = (ld(pv, 6) + x0 * ld(pv, 2)) + (ld(pv, 4) * z0 + ld(pv, 5) * z1);
    const float r = x + ld(pv, 9);
    const float* loga = pv + kHeader;
    const float* bt = loga + n;
    float fixed = 0.0f, p = 0.0f;
    for (int j = 0; j < n; ++j) {
      p = expf(ld(loga, j) - ld(bt, j) * r);
      fixed = fixed + p;
    }
    const float swap = (1.0f - p - ld(pv, 7) * fixed) * ld(pv, 8);
    return fmaxf(swap, 0.0f) * expf(-y);
  }
};

// Hull-White: header l11, l21, l22, P(0,t0), c0, K*tau, sign; then
// P(0,t_j)/P(0,t0), B_j and corr_j.  x = l11 z0 (x0 = 0), y = int x.
__device__ __forceinline__ void hw_draw(const float* __restrict__ pv, uint32_t k0, uint32_t k1,
                                        uint32_t id, float& x, float& y) {
  float z0, z1;
  normal_pair<13>(k0, k1, id, 0u, z0, z1);
  x = ld(pv, 0) * z0;
  y = ld(pv, 1) * z0 + ld(pv, 2) * z1;
}

__device__ __forceinline__ float hw_bond(const float* __restrict__ pv, int n, int j, float x) {
  const float* t = pv + 7;
  return ld(t, j) * expf(-ld(t, n + j) * x - ld(t, 2 * n + j));
}

__device__ __forceinline__ float hw_discounted(const float* __restrict__ pv, float swap, float y) {
  return fmaxf(swap, 0.0f) * ld(pv, 3) * expf(-y - ld(pv, 4));
}

struct HwSwpt {
  __device__ static float pay(const float* __restrict__ pv, int n, uint32_t k0, uint32_t k1,
                              uint32_t id) {
    float x, y;
    hw_draw(pv, k0, k1, id, x, y);
    const float ktau = ld(pv, 5);
    float fixed = 0.0f, p = 0.0f;
    for (int j = 0; j < n; ++j) {
      p = hw_bond(pv, n, j, x);
      fixed = fixed + ktau * p;
    }
    fixed = fixed + p;  // the principal rides the last bond
    return hw_discounted(pv, (1.0f - fixed) * ld(pv, 6), y);
  }
};

// Multi-curve Hull-White: the single-curve pack, then const_0 and w_1..w_n;
// the swap is const_0 + sum_j w_j p_j.
struct HwSwptMc {
  __device__ static float pay(const float* __restrict__ pv, int n, uint32_t k0, uint32_t k1,
                              uint32_t id) {
    float x, y;
    hw_draw(pv, k0, k1, id, x, y);
    const float* w = pv + 8 + 3 * n;
    float v = ld(pv, 7 + 3 * n);
    for (int j = 0; j < n; ++j) v = v + ld(w, j) * hw_bond(pv, n, j, x);
    return hw_discounted(pv, v * ld(pv, 6), y);
  }
};

// G2++: header ch00, ch10, ch11, ch20, ch21, ch22, P(0,t0), V(t0)/2, K*tau,
// sign; then P(0,t_j)/P(0,t0), A_j, Ba_j and Bb_j.  (x, y, z) from the pair
// at (id, 0) and the inverse-CDF normal of word 0 at (id, 1).
__device__ __forceinline__ void g2_draw(const float* __restrict__ pv, uint32_t k0, uint32_t k1,
                                        uint32_t id, float& x, float& y, float& z) {
  float w0, w1;
  normal_pair<13>(k0, k1, id, 0u, w0, w1);
  const float w2 = inv_normal_cdf(unit_draw<13>(k0, k1, id, 1u));
  x = ld(pv, 0) * w0;
  y = ld(pv, 1) * w0 + ld(pv, 2) * w1;
  z = ld(pv, 3) * w0 + ld(pv, 4) * w1 + ld(pv, 5) * w2;
}

__device__ __forceinline__ float g2_bond(const float* __restrict__ pv, int n, int j, float x,
                                         float y) {
  const float* t = pv + 10;
  return ld(t, j) * expf(ld(t, n + j) - ld(t, 2 * n + j) * x - ld(t, 3 * n + j) * y);
}

__device__ __forceinline__ float g2_discounted(const float* __restrict__ pv, float swap, float z) {
  return fmaxf(swap, 0.0f) * ld(pv, 6) * expf(-z - ld(pv, 7));
}

struct G2Swpt {
  __device__ static float pay(const float* __restrict__ pv, int n, uint32_t k0, uint32_t k1,
                              uint32_t id) {
    float x, y, z;
    g2_draw(pv, k0, k1, id, x, y, z);
    const float ktau = ld(pv, 8);
    float fixed = 0.0f, p = 0.0f;
    for (int j = 0; j < n; ++j) {
      p = g2_bond(pv, n, j, x, y);
      fixed = fixed + ktau * p;
    }
    fixed = fixed + p;  // the principal rides the last bond
    return g2_discounted(pv, (1.0f - fixed) * ld(pv, 9), z);
  }
};

// Multi-curve G2++: the single-curve pack, then const_0 and w_1..w_n.
struct G2SwptMc {
  __device__ static float pay(const float* __restrict__ pv, int n, uint32_t k0, uint32_t k1,
                              uint32_t id) {
    float x, y, z;
    g2_draw(pv, k0, k1, id, x, y, z);
    const float* w = pv + 11 + 4 * n;
    float v = ld(pv, 10 + 4 * n);
    for (int j = 0; j < n; ++j) v = v + ld(w, j) * g2_bond(pv, n, j, x, y);
    return g2_discounted(pv, v * ld(pv, 9), z);
  }
};

}  // namespace mc
