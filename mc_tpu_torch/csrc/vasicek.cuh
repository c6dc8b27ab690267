// The Black-Scholes-Vasicek family on the device: its packed parameters, the
// exact OU-triple step and the family NMC struct, the twins of
// mc_tpu_torch/models/vasicek.py and mc_tpu_torch/nmc_vasicek.py (and of
// mc_tpu/models/vasicek.py:168-218, mc_tpu/nmc_vasicek.py:53-175) operation
// for operation, in the same association.  The build passes --fmad=false, so
// each mul and add rounds as it does in the plain PyTorch version.
//
// VasicekParams is the layout of VASICEK_FIELDS (22 f32).  The payoffs'
// Params get the fields a payoff may read (s0, k, r, barrier, p1, p2, t, dt,
// inv_n_steps, and sigma = sigma_s, which the Brownian-bridge barriers
// read); q and the GBM drift/vol coefficients are NaN, so a payoff that
// read them would fail its gate loudly.
#pragma once

#include <cstdint>

#include "family.cuh"
#include "payoffs.cuh"
#include "qmc.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kVasicekFields = 22;

struct VasicekParams {
  Params pay;  // the payoff's view of the contract
  float sqrt_dt, x0, bdt, e1, big_b, drift_adj, l11, l21, l22, l31, l32, l33;
};

__device__ __forceinline__ VasicekParams load_vasicek(const float* __restrict__ v) {
  const float nan = __int_as_float(0x7fc00000);
  VasicekParams c;
  c.pay.s0 = v[0]; c.pay.k = v[1]; c.pay.r = v[2]; c.pay.barrier = v[3];
  c.pay.p1 = v[4]; c.pay.p2 = v[5]; c.pay.t = v[6]; c.pay.dt = v[7];
  c.pay.inv_n_steps = v[8]; c.sqrt_dt = v[9]; c.pay.sigma = v[10];
  c.pay.q = nan; c.pay.drift_dt = nan; c.pay.vol_dt = nan; c.pay.drift_t = nan;
  c.pay.vol_t = nan;
  c.x0 = v[11]; c.bdt = v[12]; c.e1 = v[13]; c.big_b = v[14]; c.drift_adj = v[15];
  c.l11 = v[16]; c.l21 = v[17]; c.l22 = v[18]; c.l31 = v[19]; c.l32 = v[20];
  c.l33 = v[21];
  return c;
}

// The state of a path: w = log S/s0 (of the leg's start), x = r - b, y =
// int r du.
struct VasicekState {
  float w, x, y;
};

// One exact step from three iid normals: eps = l11 za, eta = l21 za + l22 zb,
// u = (l31 za + l32 zb) + l33 zc; dy = (bdt + x B) + eta; w = ((w + dy) -
// drift_adj) + u; y += dy; x = x e1 + eps; S = s0 * expf(w).
__device__ __forceinline__ float vasicek_step(const VasicekParams& c, float za, float zb,
                                              float zc, float s0, VasicekState& g) {
  const float eps = c.l11 * za;
  const float eta = c.l21 * za + c.l22 * zb;
  const float u = (c.l31 * za + c.l32 * zb) + c.l33 * zc;
  const float dy = (c.bdt + g.x * c.big_b) + eta;
  g.w = ((g.w + dy) - c.drift_adj) + u;
  g.y = g.y + dy;
  g.x = g.x * c.e1 + eps;
  return s0 * expf(g.w);  // log-space: one exp rounding per S_t
}

// The normals of the step pair m: pairs 3m, 3m+1, 3m+2 of path id.
template <int ROUNDS>
__device__ __forceinline__ void vasicek_draw6(uint32_t k0, uint32_t k1, uint32_t id, int m,
                                              float (&z)[6]) {
  const uint32_t c = 3u * static_cast<uint32_t>(m);
  normal_pair<ROUNDS>(k0, k1, id, c, z[0], z[1]);
  normal_pair<ROUNDS>(k0, k1, id, c + 1u, z[2], z[3]);
  normal_pair<ROUNDS>(k0, k1, id, c + 2u, z[4], z[5]);
}

// Vasicek for the family NMC engine (mc_tpu/nmc_vasicek.py:53-175): grids
// (S, x, y), no extras.  The outer draw unit m is the step pair m's six
// normals, the even step on (z0, z1, z2) and the odd on (z3, z4, z5)
// (outer_step draws it at the even step and parks the odd half in the
// carry); the carry holds S, so the outer payoff reads the spot the step
// stored, and the outer payoff is discounted by its own exp(-y_T).  The
// inner leg resumes from (S_t, x_t) with w = y = 0, substep u drawing the
// pairs 2(c_base + u) -> (za, zb) and 2(c_base + u) + 1 -> (zc, unused), and
// pays payoff(S_t exp(w)) * exp(-y); the point is scaled by exp(-y_t) of the
// outer path, so every value is discounted to time 0 along its own rates.
struct VasicekFamily {
  using Params = VasicekParams;
  static constexpr int kGrids = 3;
  static constexpr int kLegs = family_legs(2);

  using OuterDraw = DrawWords<6>;  // the pair's six normals
  static constexpr int kStepsPerDraw = 2;
  static constexpr int kTrajSplitBlocks = 4;  // the draw is most of a step

  template <class Payoff>
  struct Carry {
    VasicekState g;
    float s;
    typename Payoff::State st;
    float parked[3];  // the odd step's normals, parked by the even step
  };

  __device__ static Params load(const float* __restrict__ params, const FamilyExtras&, int) {
    return load_vasicek(params);
  }
  __device__ static const mc::Params& payoff_params(const Params& c) { return c.pay; }

  template <class Payoff>
  __device__ static Carry<Payoff> outer_init(const Params& c) {
    return Carry<Payoff>{VasicekState{0.0f, c.x0, 0.0f}, c.pay.s0, Payoff::init(c.pay),
                         {0.0f, 0.0f, 0.0f}};
  }
  __device__ static void outer_draw(const Params&, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t u, OuterDraw& d) {
    vasicek_draw6<13>(k0, k1, id, static_cast<int>(u), d.w);
  }
  // Step j takes (z0, z1, z2) at an even j, (z3, z4, z5) at an odd one.
  template <class Payoff>
  __device__ static void outer_advance(const Params& c, int j, const OuterDraw& d,
                                       Carry<Payoff>& o) {
    const bool even = (j & 1) == 0;
    o.s = vasicek_step(c, even ? d.w[0] : d.w[3], even ? d.w[1] : d.w[4],
                       even ? d.w[2] : d.w[5], c.pay.s0, o.g);
    o.st = Payoff::update(o.st, o.s, c.pay);
  }
  // The draw at an even step, its odd half parked in the carry, then the
  // step on its half: outer_advance's step.
  template <class Payoff>
  __device__ static void outer_step(const Params& c, uint32_t k0, uint32_t k1, uint32_t id,
                                    int j, Carry<Payoff>& o) {
    float za, zb, zc;
    if ((j & 1) == 0) {
      OuterDraw d;
      outer_draw(c, k0, k1, id, static_cast<uint32_t>(j >> 1), d);
      za = d.w[0]; zb = d.w[1]; zc = d.w[2];
      o.parked[0] = d.w[3]; o.parked[1] = d.w[4]; o.parked[2] = d.w[5];
    } else {
      za = o.parked[0]; zb = o.parked[1]; zc = o.parked[2];
    }
    o.s = vasicek_step(c, za, zb, zc, c.pay.s0, o.g);
    o.st = Payoff::update(o.st, o.s, c.pay);
  }
  template <class Payoff>
  __device__ static void point(const Carry<Payoff>& o, float (&g)[kGrids]) {
    g[0] = o.s;
    g[1] = o.g.x;
    g[2] = o.g.y;
  }
  template <class Payoff>
  __device__ static float outer_pay(const Params& c, const Carry<Payoff>& o) {
    return Payoff::terminal(o.st, o.s, c.pay) * expf(-o.g.y);
  }
  template <class Payoff>
  __device__ static void inner_legs(const Params& c, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t c_base, uint32_t stride, int remaining,
                                    const float (&g)[kGrids],
                                    const typename Payoff::State& st0, float (&pay)[kLegs]) {
    VasicekState s[kLegs];
    typename Payoff::State st[kLegs];
#pragma unroll
    for (int l = 0; l < kLegs; ++l) {
      s[l] = VasicekState{0.0f, g[1], 0.0f};
      st[l] = st0;
    }
    for (int u = 0; u < remaining; ++u) {
#pragma unroll
      for (int l = 0; l < kLegs; ++l) {
        const uint32_t cu = 2u * (c_base + l * stride + static_cast<uint32_t>(u));
        float za, zb, zc, unused;
        normal_pair<13>(k0, k1, id, cu, za, zb);
        normal_pair<13>(k0, k1, id, cu + 1u, zc, unused);
        st[l] = Payoff::update(st[l], vasicek_step(c, za, zb, zc, g[0], s[l]), c.pay);
      }
    }
#pragma unroll
    for (int l = 0; l < kLegs; ++l) {
      pay[l] = Payoff::terminal(st[l], g[0] * expf(s[l].w), c.pay) * expf(-s[l].y);
    }
  }
  __device__ static float point_scale(const Params&, const float (&g)[kGrids]) {
    return expf(-g[2]);  // the outer path's own discount to time 0
  }
  __device__ static uint32_t counter_stride(const Params&, int n_steps) {
    return static_cast<uint32_t>(n_steps);  // the leg doubles it: two pairs a substep
  }
};

// Vasicek's discounted leg on a randomized-QMC draw (qmc_model.cuh, #33):
// step pair m reads pairs 3m, 3m+1 and 3m+2, (za, zb, zc) of step 2m the
// first three normals and of step 2m+1 the last three; kShifts legs in
// lockstep.
struct VasicekQmcLeg {
  using Params = VasicekParams;
  static constexpr int kShifts = qmc_shifts(4);
  __device__ static Params load(const float* __restrict__ params, int, int) {
    return load_vasicek(params);
  }
  template <class Payoff, class Draw>
  __device__ static void pay(const Params& c, int n_steps, const Draw& draw,
                             float (&pay)[kShifts]) {
    constexpr int K = kShifts;
    VasicekState g[K];
    float s[K];
    typename Payoff::State st[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      g[k] = VasicekState{0.0f, c.x0, 0.0f};
      s[k] = c.pay.s0;
      st[k] = Payoff::init(c.pay);
    }
    for (int m = 0; m < n_steps / 2; ++m) {
      float z[6][K];
      draw.pair(3 * m, z[0], z[1]);
      draw.pair(3 * m + 1, z[2], z[3]);
      draw.pair(3 * m + 2, z[4], z[5]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          s[k] = vasicek_step(c, z[3 * h][k], z[3 * h + 1][k], z[3 * h + 2][k], c.pay.s0, g[k]);
          st[k] = Payoff::update(st[k], s[k], c.pay);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) pay[k] = Payoff::terminal(st[k], s[k], c.pay) * expf(-g[k].y);
  }
};

}  // namespace mc
