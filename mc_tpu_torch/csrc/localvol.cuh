// The local-volatility family on the device: the packed surface, the
// clamped-ramp lookup, the log-Euler step and the family NMC struct, the
// twins of mc_tpu_torch/models/localvol.py (and of
// mc_tpu/models/localvol.py:131-213) operation for operation, in the same
// association.  The build passes --fmad=false, so each mul and add rounds as
// it does in the plain PyTorch version.
//
// The packed vector has a variable length, 11 + 2K - 1 + n_steps*K f32:
//   [s0, k, t, barrier, p1, p2, q, dt, inv_n_steps, r, sigma_ref,
//    x_knots(K), dx(K-1), v0(n_steps), slopes(n_steps*(K-1))]
// so the kernels read it by pointer, with K and n_steps runtime integers.
// The payoffs' Params take the head's fields (sigma = sigma_ref, which only
// the Brownian-bridge barriers read); the GBM drift/vol coefficients are NaN.
//
// The partials and trajectories kernels read the surface in global memory
// (every thread of a warp reads the same slope row: one broadcast load from
// L1); the partials kernel (localvol_partials.cuh) reads each row once for
// its lockstep legs.  The family NMC sweep (lv_steps) reads each row once
// for its kLegs legs, from the block's staged copy when the surface fits the
// shared budget (3.7 KB at K = 9, n_steps = 100; 10 KB at K = 25) and where
// it lies when it does not.
#pragma once

#include <cstdint>

#include "family.cuh"
#include "payoffs.cuh"
#include "qmc.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kLvHead = 11;

struct LocalVolParams {
  Params pay;              // the payoff's view of the contract
  const float* v;          // the packed vector
  int n_knots, n_steps;
  float base_drift, sdt;   // (r - q)*dt, sqrt(dt)
};

__device__ __forceinline__ LocalVolParams load_localvol(const float* __restrict__ v,
                                                        int n_knots, int n_steps) {
  const float nan = __int_as_float(0x7fc00000);
  LocalVolParams l;
  l.pay.s0 = v[0]; l.pay.k = v[1]; l.pay.t = v[2]; l.pay.barrier = v[3];
  l.pay.p1 = v[4]; l.pay.p2 = v[5]; l.pay.q = v[6]; l.pay.dt = v[7];
  l.pay.inv_n_steps = v[8]; l.pay.r = v[9]; l.pay.sigma = v[10];
  l.pay.drift_dt = nan; l.pay.vol_dt = nan; l.pay.drift_t = nan; l.pay.vol_t = nan;
  l.v = v;
  l.n_knots = n_knots;
  l.n_steps = n_steps;
  l.base_drift = (l.pay.r - l.pay.q) * l.pay.dt;
  l.sdt = sqrtf(l.pay.dt);  // computed, not packed, as in mc_tpu
  return l;
}

// sigma(w, step j): v0[j] plus the K-1 ramps m_k * min(max(w - x_k, 0),
// dx_k), added in k order, floored at 1e-4.
__device__ __forceinline__ float lv_sigma_at(const LocalVolParams& l, float w, int j) {
  const int km1 = l.n_knots - 1;
  const float* x = l.v + kLvHead;
  const float* dx = x + l.n_knots;
  const float* v0 = dx + km1;
  const float* m = v0 + l.n_steps + static_cast<size_t>(j) * km1;
  float s = v0[j];
  for (int k = 0; k < km1; ++k) s = s + m[k] * fminf(fmaxf(w - x[k], 0.0f), dx[k]);
  return fmaxf(s, 1e-4f);
}

// One log-Euler step on surface row j: w = (w + (base_drift -
// ((0.5*sg)*sg)*dt)) + (sg*sdt)*z, S = s0*exp(w), the payoff state updated.
template <class Payoff>
__device__ __forceinline__ void lv_step(const LocalVolParams& l, int j, float z, float& w,
                                        float& s, typename Payoff::State& st) {
  const float sg = lv_sigma_at(l, w, j);
  w = (w + (l.base_drift - ((0.5f * sg) * sg) * l.pay.dt)) + (sg * l.sdt) * z;
  s = l.pay.s0 * expf(w);  // log-space: one exp rounding per S_t
  st = Payoff::update(st, s, l.pay);
}

// lv_step on L legs at once: row j's level, knots, widths and slopes read
// once for them, each leg's lookup added in lv_sigma_at's k order.
template <class Payoff, int L>
__device__ __forceinline__ void lv_steps(const LocalVolParams& l, int j, const float (&z)[L],
                                         float (&w)[L], float (&s)[L],
                                         typename Payoff::State (&st)[L]) {
  const int km1 = l.n_knots - 1;
  const float* x = l.v + kLvHead;
  const float* dx = x + l.n_knots;
  const float* v0 = dx + km1;
  const float* m = v0 + l.n_steps + static_cast<size_t>(j) * km1;
  float sg[L];
  const float level = v0[j];
#pragma unroll
  for (int i = 0; i < L; ++i) sg[i] = level;
  for (int k = 0; k < km1; ++k) {
    const float xk = x[k], dk = dx[k], mk = m[k];
#pragma unroll
    for (int i = 0; i < L; ++i) sg[i] = sg[i] + mk * fminf(fmaxf(w[i] - xk, 0.0f), dk);
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const float sgi = fmaxf(sg[i], 1e-4f);
    w[i] = (w[i] + (l.base_drift - ((0.5f * sgi) * sgi) * l.pay.dt)) + (sgi * l.sdt) * z[i];
    s[i] = l.pay.s0 * expf(w[i]);  // log-space: one exp rounding per S_t
    st[i] = Payoff::update(st[i], s[i], l.pay);
  }
}

// Local vol for the family NMC engine (mc_tpu/nmc_localvol.py:52-167):
// grid S, extras i[0] = K.  The outer draw unit m is pair (id, m), feeding
// steps 2m and 2m+1 (outer_step draws it at the even step and parks the
// odd half in the carry); the carry holds S, so the outer payoff reads
// the spot the step stored.  The inner leg at row j resumes
// from w0 = log(S_t / s0), recomputes S = s0*exp(w) at every substep and
// pays on it; its substep 2q takes surface row j+1+2q (j+1 = n_steps -
// remaining), pair q of counter c_base + q, the odd one taken only while
// 2q+1 < remaining (block-uniform).
struct LocalVolFamily {
  using Params = LocalVolParams;
  static constexpr int kGrids = 1;
  static constexpr int kLegs = family_legs(4);

  using OuterDraw = DrawWords<2>;  // the pair's normals
  static constexpr int kStepsPerDraw = 2;
  static constexpr int kTrajSplitBlocks = 2;

  template <class Payoff>
  struct Carry {
    float w, s;
    typename Payoff::State st;
    float z_next;  // the odd step's normal, parked by the even step
  };

  __device__ static Params load(const float* __restrict__ params, const FamilyExtras& ex,
                                int n_steps) {
    return load_localvol(params, ex.i[0], n_steps);
  }
  __device__ static const mc::Params& payoff_params(const Params& l) { return l.pay; }

  template <class Payoff>
  __device__ static Carry<Payoff> outer_init(const Params& l) {
    return Carry<Payoff>{0.0f, l.pay.s0, Payoff::init(l.pay), 0.0f};
  }
  __device__ static void outer_draw(const Params&, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t u, OuterDraw& d) {
    normal_pair<13>(k0, k1, id, u, d.w[0], d.w[1]);
  }
  template <class Payoff>
  __device__ static void outer_advance(const Params& l, int j, const OuterDraw& d,
                                       Carry<Payoff>& o) {
    lv_step<Payoff>(l, j, (j & 1) == 0 ? d.w[0] : d.w[1], o.w, o.s, o.st);
  }
  // The draw at an even step, its odd normal parked in the carry, then the
  // step on its half: outer_advance's step.
  template <class Payoff>
  __device__ static void outer_step(const Params& l, uint32_t k0, uint32_t k1, uint32_t id,
                                    int j, Carry<Payoff>& o) {
    float z;
    if ((j & 1) == 0) {
      OuterDraw d;
      outer_draw(l, k0, k1, id, static_cast<uint32_t>(j >> 1), d);
      z = d.w[0];
      o.z_next = d.w[1];
    } else {
      z = o.z_next;
    }
    lv_step<Payoff>(l, j, z, o.w, o.s, o.st);
  }
  template <class Payoff>
  __device__ static void point(const Carry<Payoff>& o, float (&g)[kGrids]) {
    g[0] = o.s;
  }
  template <class Payoff>
  __device__ static float outer_pay(const Params& l, const Carry<Payoff>& o) {
    return Payoff::terminal(o.st, o.s, l.pay);
  }
  template <class Payoff>
  __device__ static void inner_legs(const Params& l, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t c_base, uint32_t stride, int remaining,
                                    const float (&g)[kGrids],
                                    const typename Payoff::State& st0, float (&pay)[kLegs]) {
    const float w0 = logf(g[0] / l.pay.s0);  // the absolute log-moneyness at the point
    const float s0 = l.pay.s0 * expf(w0);
    float w[kLegs], s[kLegs];
    typename Payoff::State st[kLegs];
#pragma unroll
    for (int i = 0; i < kLegs; ++i) {
      w[i] = w0;
      s[i] = s0;
      st[i] = st0;
    }
    const int row = l.n_steps - remaining;  // j + 1
    for (int q = 0; 2 * q < remaining; ++q) {
      float z0[kLegs], z1[kLegs];
#pragma unroll
      for (int i = 0; i < kLegs; ++i) {
        normal_pair<13>(k0, k1, id, c_base + i * stride + static_cast<uint32_t>(q), z0[i],
                        z1[i]);
      }
      lv_steps<Payoff>(l, row + 2 * q, z0, w, s, st);
      if (2 * q + 1 < remaining) lv_steps<Payoff>(l, row + 2 * q + 1, z1, w, s, st);
    }
#pragma unroll
    for (int i = 0; i < kLegs; ++i) pay[i] = Payoff::terminal(st[i], s[i], l.pay);
  }
  __device__ static float point_scale(const Params& l, const float (&)[kGrids]) {
    return expf(-l.pay.r * l.pay.t);  // the full e^{-rT}
  }
  __device__ static uint32_t counter_stride(const Params&, int n_steps) {
    return static_cast<uint32_t>(n_steps + 1) / 2u;  // one pair per two substeps
  }
};

// Local vol's leg on a randomized-QMC draw (qmc_model.cuh, #33): pair m
// feeds steps 2m and 2m+1; extra is the knot count.  kShifts legs in
// lockstep, each surface row read once for them (lv_steps).
struct LocalVolQmcLeg {
  using Params = LocalVolParams;
  static constexpr int kShifts = qmc_shifts(4);
  __device__ static Params load(const float* __restrict__ params, int n_steps, int n_knots) {
    return load_localvol(params, n_knots, n_steps);
  }
  template <class Payoff, class Draw>
  __device__ static void pay(const Params& l, int n_steps, const Draw& draw,
                             float (&pay)[kShifts]) {
    constexpr int K = kShifts;
    float w[K], s[K];
    typename Payoff::State st[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      w[k] = 0.0f;
      s[k] = l.pay.s0;
      st[k] = Payoff::init(l.pay);
    }
    for (int m = 0; m < n_steps / 2; ++m) {
      float z0[K], z1[K];
      draw.pair(m, z0, z1);
      lv_steps<Payoff>(l, 2 * m, z0, w, s, st);
      lv_steps<Payoff>(l, 2 * m + 1, z1, w, s, st);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) pay[k] = Payoff::terminal(st[k], s[k], l.pay);
  }
};

}  // namespace mc
