// The term-structure family on the device: its packed curves, the log-Euler
// step and the family NMC struct, the twins of mc_tpu_torch/models/term.py
// (and of mc_tpu/models/term.py:83-137, mc_tpu/nmc_term.py:36-115) operation
// for operation, in the same association.  The build passes --fmad=false, so
// each mul and add rounds as it does in the plain PyTorch version.
//
// The packed vector is 11 + 2*n_steps f32:
//   [s0, k, t, barrier, p1, p2, q, dt, inv_n_steps, r_bar, sigma_bar,
//    drift_dt(n_steps), vol_sdt(n_steps)]
// so the kernels read it by pointer, with n_steps a runtime integer.  The
// payoffs' Params take the head's fields (r and sigma the averaged curves,
// which the Brownian-bridge barriers read); the GBM drift/vol coefficients
// are NaN.
//
// At step j every thread of a block reads the same two floats, drift_dt[j]
// and vol_sdt[j]: one broadcast load each, from L1 in the partials kernel,
// from the block's staged copy in the family NMC sweep (term_steps), which
// reads them once for its kLegs legs.
#pragma once

#include <cstdint>

#include "family.cuh"
#include "payoffs.cuh"
#include "qmc.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kTermHead = 11;

struct TermParams {
  Params pay;            // the payoff's view of the contract
  const float* drift;    // drift_dt[n_steps]
  const float* vol;      // vol_sdt[n_steps]
  int n_steps;
};

__device__ __forceinline__ TermParams load_term(const float* __restrict__ v, int n_steps) {
  const float nan = __int_as_float(0x7fc00000);
  TermParams c;
  c.pay.s0 = v[0]; c.pay.k = v[1]; c.pay.t = v[2]; c.pay.barrier = v[3];
  c.pay.p1 = v[4]; c.pay.p2 = v[5]; c.pay.q = v[6]; c.pay.dt = v[7];
  c.pay.inv_n_steps = v[8]; c.pay.r = v[9]; c.pay.sigma = v[10];
  c.pay.drift_dt = nan; c.pay.vol_dt = nan; c.pay.drift_t = nan; c.pay.vol_t = nan;
  c.drift = v + kTermHead;
  c.vol = v + kTermHead + n_steps;
  c.n_steps = n_steps;
  return c;
}

// One log-Euler step on the curves' entry j: w = w + (drift_dt[j] +
// vol_sdt[j]*z), S = s0*exp(w), the payoff state updated.
template <class Payoff>
__device__ __forceinline__ void term_step(const TermParams& c, int j, float z, float& w,
                                          float& s, typename Payoff::State& st) {
  w = w + (c.drift[j] + c.vol[j] * z);
  s = c.pay.s0 * expf(w);  // log-space: one exp rounding per S_t
  st = Payoff::update(st, s, c.pay);
}

// term_step on L legs at once: the curves' entry j read once for them.
template <class Payoff, int L>
__device__ __forceinline__ void term_steps(const TermParams& c, int j, const float (&z)[L],
                                           float (&w)[L], float (&s)[L],
                                           typename Payoff::State (&st)[L]) {
  const float drift = c.drift[j], vol = c.vol[j];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    w[l] = w[l] + (drift + vol * z[l]);
    s[l] = c.pay.s0 * expf(w[l]);
    st[l] = Payoff::update(st[l], s[l], c.pay);
  }
}

// Term structures for the family NMC engine (mc_tpu/nmc_term.py:36-115):
// grid S, no extras (the device load gets n_steps).  The outer draw unit m
// is pair (id, m), feeding steps 2m and 2m+1 (outer_step draws it at the
// even step and parks the odd half in the carry); the carry holds the
// rounded S the step stored, which the outer payoff reads.  The
// inner leg at row j resumes from w0 = log(S_t / s0), recomputes S =
// s0*exp(w) at every substep and pays on it (at the last row on
// s0*exp(log(S_T/s0))); its substep 2q takes the curves' entry j+1+2q (j+1 =
// n_steps - remaining), pair q of counter c_base + q, the odd one taken only
// while 2q+1 < remaining (block-uniform: mc_tpu's take2, whose clamped
// overrun entry is never used).
struct TermFamily {
  using Params = TermParams;
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

  __device__ static Params load(const float* __restrict__ params, const FamilyExtras&,
                                int n_steps) {
    return load_term(params, n_steps);
  }
  __device__ static const mc::Params& payoff_params(const Params& c) { return c.pay; }

  template <class Payoff>
  __device__ static Carry<Payoff> outer_init(const Params& c) {
    return Carry<Payoff>{0.0f, c.pay.s0, Payoff::init(c.pay), 0.0f};
  }
  __device__ static void outer_draw(const Params&, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t u, OuterDraw& d) {
    normal_pair<13>(k0, k1, id, u, d.w[0], d.w[1]);
  }
  template <class Payoff>
  __device__ static void outer_advance(const Params& c, int j, const OuterDraw& d,
                                       Carry<Payoff>& o) {
    term_step<Payoff>(c, j, (j & 1) == 0 ? d.w[0] : d.w[1], o.w, o.s, o.st);
  }
  // The draw at an even step, its odd normal parked in the carry, then the
  // step on its half: outer_advance's step.
  template <class Payoff>
  __device__ static void outer_step(const Params& c, uint32_t k0, uint32_t k1, uint32_t id,
                                    int j, Carry<Payoff>& o) {
    float z;
    if ((j & 1) == 0) {
      OuterDraw d;
      outer_draw(c, k0, k1, id, static_cast<uint32_t>(j >> 1), d);
      z = d.w[0];
      o.z_next = d.w[1];
    } else {
      z = o.z_next;
    }
    term_step<Payoff>(c, j, z, o.w, o.s, o.st);
  }
  template <class Payoff>
  __device__ static void point(const Carry<Payoff>& o, float (&g)[kGrids]) {
    g[0] = o.s;
  }
  template <class Payoff>
  __device__ static float outer_pay(const Params& c, const Carry<Payoff>& o) {
    return Payoff::terminal(o.st, o.s, c.pay);
  }
  template <class Payoff>
  __device__ static void inner_legs(const Params& c, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t c_base, uint32_t stride, int remaining,
                                    const float (&g)[kGrids],
                                    const typename Payoff::State& st0, float (&pay)[kLegs]) {
    const float w0 = logf(g[0] / c.pay.s0);  // the absolute log-moneyness at the point
    const float s0 = c.pay.s0 * expf(w0);
    float w[kLegs], s[kLegs];
    typename Payoff::State st[kLegs];
#pragma unroll
    for (int l = 0; l < kLegs; ++l) {
      w[l] = w0;
      s[l] = s0;
      st[l] = st0;
    }
    const int row = c.n_steps - remaining;  // j + 1
    for (int q = 0; 2 * q < remaining; ++q) {
      float z0[kLegs], z1[kLegs];
#pragma unroll
      for (int l = 0; l < kLegs; ++l) {
        normal_pair<13>(k0, k1, id, c_base + l * stride + static_cast<uint32_t>(q), z0[l],
                        z1[l]);
      }
      term_steps<Payoff>(c, row + 2 * q, z0, w, s, st);
      if (2 * q + 1 < remaining) term_steps<Payoff>(c, row + 2 * q + 1, z1, w, s, st);
    }
#pragma unroll
    for (int l = 0; l < kLegs; ++l) pay[l] = Payoff::terminal(st[l], s[l], c.pay);
  }
  __device__ static float point_scale(const Params& c, const float (&)[kGrids]) {
    return expf(-c.pay.r * c.pay.t);  // the full e^{-r_bar T}
  }
  __device__ static uint32_t counter_stride(const Params&, int n_steps) {
    return static_cast<uint32_t>(n_steps + 1) / 2u;  // one pair per two substeps
  }
};

// The term curves' leg on a randomized-QMC draw (qmc_model.cuh, #33): pair
// m feeds steps 2m and 2m+1; kShifts legs in lockstep.
struct TermQmcLeg {
  using Params = TermParams;
  static constexpr int kShifts = qmc_shifts(4);
  __device__ static Params load(const float* __restrict__ params, int n_steps, int) {
    return load_term(params, n_steps);
  }
  template <class Payoff, class Draw>
  __device__ static void pay(const Params& c, int n_steps, const Draw& draw,
                             float (&pay)[kShifts]) {
    constexpr int K = kShifts;
    float w[K], s[K];
    typename Payoff::State st[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      w[k] = 0.0f;
      s[k] = c.pay.s0;
      st[k] = Payoff::init(c.pay);
    }
    for (int m = 0; m < n_steps / 2; ++m) {
      float z0[K], z1[K];
      draw.pair(m, z0, z1);
#pragma unroll
      for (int k = 0; k < K; ++k) term_step<Payoff>(c, 2 * m, z0[k], w[k], s[k], st[k]);
#pragma unroll
      for (int k = 0; k < K; ++k) term_step<Payoff>(c, 2 * m + 1, z1[k], w[k], s[k], st[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) pay[k] = Payoff::terminal(st[k], s[k], c.pay);
  }
};

}  // namespace mc
