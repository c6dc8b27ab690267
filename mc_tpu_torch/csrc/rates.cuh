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
// multiplies the swap.
//
// The packed vector holds a short header, then each table of the n
// payments in turn (pack, kHeader, entry_offset).  A tile splits a path in
// four: draw (the threefry pair at (id, 0) and the state the bonds read),
// begin (the swap's accumulator), bond (one payment, from its table
// entries) and finish (the swap's discounted positive part).  The kernel
// (rates_kernels.cu) reads the header once a block and a payment's entries
// once for all the paths a thread runs: from shared memory, where the block
// staged them per payment (RatesEntry: up to four in one 128-bit load, a
// fifth beside), or from the pack in place.
#pragma once

#include <cstdint>

#include "rng.cuh"

namespace mc {

// One payment's table entries: q holds up to four, t a fifth.
struct RatesEntry {
  float4 q;
  float t;
};

// Vasicek: header x0, e1, B, l11, l21, l22, b*T, K*tau, sign, b; then
// logA_j and B_j.  The exact (x, y) = (r - b, int r) pair at expiry from the
// threefry pair at (id, 0); bonds exp(logA_j - B_j r); pay max(swap, 0) e^-y.
struct VaSwpt {
  static constexpr int kHeader = 10;  // floats before the tables
  static constexpr int kHead = 10;    // header floats a path reads
  static constexpr int kEntries = 2;  // table entries a payment
  __host__ __device__ static int head_offset(int, int k) { return k; }
  __host__ __device__ static int entry_offset(int n, int e) { return kHeader + e * n; }
  struct Head {
    float x0, e1, b_expiry, l11, l21, l22, bt, ktau, sign, b;
  };
  struct State {
    float r, y;
  };
  struct Acc {
    float fixed, p;
  };
  __device__ static Head head(const float* h) {
    return {h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8], h[9]};
  }
  __device__ static State draw(const Head& h, uint32_t k0, uint32_t k1, uint32_t id) {
    float z0, z1;
    normal_pair<13>(k0, k1, id, 0u, z0, z1);
    const float x = h.x0 * h.e1 + h.l11 * z0;
    const float y = (h.bt + h.x0 * h.b_expiry) + (h.l21 * z0 + h.l22 * z1);
    return {x + h.b, y};
  }
  __device__ static Acc begin(const Head&) { return {0.0f, 0.0f}; }
  __device__ static void bond(const Head&, const RatesEntry& e, const State& s, Acc& a) {
    a.p = expf(e.q.x - e.q.y * s.r);
    a.fixed = a.fixed + a.p;
  }
  __device__ static float finish(const Head& h, const State& s, const Acc& a) {
    const float swap = (1.0f - a.p - h.ktau * a.fixed) * h.sign;
    return fmaxf(swap, 0.0f) * expf(-s.y);
  }
};

// Hull-White: header l11, l21, l22, P(0,t0), c0, K*tau, sign; then
// P(0,t_j)/P(0,t0), B_j and corr_j.  x = l11 z0 (x0 = 0), y = int x.
struct HwHead {
  float l11, l21, l22, p0, c0, ktau, sign, const0;
};
struct HwState {
  float x, y;
};

__device__ __forceinline__ HwHead hw_head(const float* h) {
  return {h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7]};
}

__device__ __forceinline__ HwState hw_draw(const HwHead& h, uint32_t k0, uint32_t k1,
                                           uint32_t id) {
  float z0, z1;
  normal_pair<13>(k0, k1, id, 0u, z0, z1);
  return {h.l11 * z0, h.l21 * z0 + h.l22 * z1};
}

__device__ __forceinline__ float hw_bond(const RatesEntry& e, float x) {
  return e.q.x * expf(-e.q.y * x - e.q.z);
}

__device__ __forceinline__ float hw_discounted(const HwHead& h, float swap, float y) {
  return fmaxf(swap, 0.0f) * h.p0 * expf(-y - h.c0);
}

struct HwSwpt {
  static constexpr int kHeader = 7;
  static constexpr int kHead = 7;
  static constexpr int kEntries = 3;
  __host__ __device__ static int head_offset(int, int k) { return k; }
  __host__ __device__ static int entry_offset(int n, int e) { return kHeader + e * n; }
  using Head = HwHead;
  using State = HwState;
  struct Acc {
    float fixed, p;
  };
  __device__ static Head head(const float* h) { return hw_head(h); }
  __device__ static State draw(const Head& h, uint32_t k0, uint32_t k1, uint32_t id) {
    return hw_draw(h, k0, k1, id);
  }
  __device__ static Acc begin(const Head&) { return {0.0f, 0.0f}; }
  __device__ static void bond(const Head& h, const RatesEntry& e, const State& s, Acc& a) {
    a.p = hw_bond(e, s.x);
    a.fixed = a.fixed + h.ktau * a.p;
  }
  __device__ static float finish(const Head& h, const State& s, const Acc& a) {
    const float fixed = a.fixed + a.p;  // the principal rides the last bond
    return hw_discounted(h, (1.0f - fixed) * h.sign, s.y);
  }
};

// Multi-curve Hull-White: the single-curve pack, then const_0 and w_1..w_n;
// the swap is const_0 + sum_j w_j p_j.
struct HwSwptMc {
  static constexpr int kHeader = 7;
  static constexpr int kHead = 8;  // and const_0, after the tables
  static constexpr int kEntries = 4;
  __host__ __device__ static int head_offset(int n, int k) {
    return k < kHeader ? k : kHeader + 3 * n;
  }
  __host__ __device__ static int entry_offset(int n, int e) {
    return e < 3 ? kHeader + e * n : kHeader + 1 + 3 * n;
  }
  using Head = HwHead;
  using State = HwState;
  struct Acc {
    float v;
  };
  __device__ static Head head(const float* h) { return hw_head(h); }
  __device__ static State draw(const Head& h, uint32_t k0, uint32_t k1, uint32_t id) {
    return hw_draw(h, k0, k1, id);
  }
  __device__ static Acc begin(const Head& h) { return {h.const0}; }
  __device__ static void bond(const Head&, const RatesEntry& e, const State& s, Acc& a) {
    a.v = a.v + e.q.w * hw_bond(e, s.x);
  }
  __device__ static float finish(const Head& h, const State& s, const Acc& a) {
    return hw_discounted(h, a.v * h.sign, s.y);
  }
};

// G2++: header ch00, ch10, ch11, ch20, ch21, ch22, P(0,t0), V(t0)/2, K*tau,
// sign; then P(0,t_j)/P(0,t0), A_j, Ba_j and Bb_j.  (x, y, z) from the pair
// at (id, 0) and the inverse-CDF normal of word 0 at (id, 1).
struct G2Head {
  float ch00, ch10, ch11, ch20, ch21, ch22, p0, half_v, ktau, sign, const0;
};
struct G2State {
  float x, y, z;
};

__device__ __forceinline__ G2Head g2_head(const float* h) {
  return {h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8], h[9], h[10]};
}

__device__ __forceinline__ G2State g2_draw(const G2Head& h, uint32_t k0, uint32_t k1,
                                           uint32_t id) {
  float w0, w1;
  normal_pair<13>(k0, k1, id, 0u, w0, w1);
  const float w2 = inv_normal_cdf(unit_draw<13>(k0, k1, id, 1u));
  return {h.ch00 * w0, h.ch10 * w0 + h.ch11 * w1, h.ch20 * w0 + h.ch21 * w1 + h.ch22 * w2};
}

__device__ __forceinline__ float g2_bond(const RatesEntry& e, float x, float y) {
  return e.q.x * expf(e.q.y - e.q.z * x - e.q.w * y);
}

__device__ __forceinline__ float g2_discounted(const G2Head& h, float swap, float z) {
  return fmaxf(swap, 0.0f) * h.p0 * expf(-z - h.half_v);
}

struct G2Swpt {
  static constexpr int kHeader = 10;
  static constexpr int kHead = 10;
  static constexpr int kEntries = 4;
  __host__ __device__ static int head_offset(int, int k) { return k; }
  __host__ __device__ static int entry_offset(int n, int e) { return kHeader + e * n; }
  using Head = G2Head;
  using State = G2State;
  struct Acc {
    float fixed, p;
  };
  __device__ static Head head(const float* h) { return g2_head(h); }
  __device__ static State draw(const Head& h, uint32_t k0, uint32_t k1, uint32_t id) {
    return g2_draw(h, k0, k1, id);
  }
  __device__ static Acc begin(const Head&) { return {0.0f, 0.0f}; }
  __device__ static void bond(const Head& h, const RatesEntry& e, const State& s, Acc& a) {
    a.p = g2_bond(e, s.x, s.y);
    a.fixed = a.fixed + h.ktau * a.p;
  }
  __device__ static float finish(const Head& h, const State& s, const Acc& a) {
    const float fixed = a.fixed + a.p;  // the principal rides the last bond
    return g2_discounted(h, (1.0f - fixed) * h.sign, s.z);
  }
};

// Multi-curve G2++: the single-curve pack, then const_0 and w_1..w_n.
struct G2SwptMc {
  static constexpr int kHeader = 10;
  static constexpr int kHead = 11;  // and const_0, after the tables
  static constexpr int kEntries = 5;
  __host__ __device__ static int head_offset(int n, int k) {
    return k < kHeader ? k : kHeader + 4 * n;
  }
  __host__ __device__ static int entry_offset(int n, int e) {
    return e < 4 ? kHeader + e * n : kHeader + 1 + 4 * n;
  }
  using Head = G2Head;
  using State = G2State;
  struct Acc {
    float v;
  };
  __device__ static Head head(const float* h) { return g2_head(h); }
  __device__ static State draw(const Head& h, uint32_t k0, uint32_t k1, uint32_t id) {
    return g2_draw(h, k0, k1, id);
  }
  __device__ static Acc begin(const Head& h) { return {h.const0}; }
  __device__ static void bond(const Head&, const RatesEntry& e, const State& s, Acc& a) {
    a.v = a.v + e.t * g2_bond(e, s.x, s.y);
  }
  __device__ static float finish(const Head& h, const State& s, const Acc& a) {
    return g2_discounted(h, a.v * h.sign, s.z);
  }
};

}  // namespace mc
