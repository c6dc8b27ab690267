// The SABR family on the device: its packed parameters, the step and the
// family NMC struct, the twins of mc_tpu_torch/models/sabr.py (and of
// mc_tpu/models/sabr.py:70-107, mc_tpu/nmc_sabr.py:36-108) operation for
// operation, in the same association.  The build passes --fmad=false, so
// each mul and add rounds as it does in the plain PyTorch version.
//
// SABRParams is the layout of SABR_FIELDS (17 f32).  The payoffs' Params get
// the fields a payoff may read (s0, k, r, barrier, p1, p2, t, q, dt,
// inv_n_steps); sigma and the GBM drift/vol coefficients are NaN, as under
// Heston, and the entry points refuse the two payoffs that read sigma.
#pragma once

#include <cmath>
#include <cstdint>

#include "family.cuh"
#include "payoffs.cuh"
#include "qmc.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kSabrFields = 17;

struct SABRParams {
  Params pay;  // the payoff's view of the contract
  float sqrt_dt, f0, alpha, beta, nu, rho, rho_perp;
};

__device__ __forceinline__ SABRParams load_sabr(const float* __restrict__ v) {
  const float nan = __int_as_float(0x7fc00000);
  SABRParams c;
  c.pay.s0 = v[0]; c.pay.k = v[1]; c.pay.r = v[2]; c.pay.barrier = v[3];
  c.pay.p1 = v[4]; c.pay.p2 = v[5]; c.pay.t = v[6]; c.pay.q = v[7];
  c.pay.dt = v[8]; c.pay.inv_n_steps = v[9];
  c.pay.sigma = nan; c.pay.drift_dt = nan; c.pay.vol_dt = nan; c.pay.drift_t = nan;
  c.pay.vol_t = nan;
  c.sqrt_dt = v[10]; c.f0 = v[11]; c.alpha = v[12]; c.beta = v[13]; c.nu = v[14];
  c.rho = v[15]; c.rho_perp = v[16];
  return c;
}

// One SABR step: z_f = rho*z_vol + rho_perp*z_perp; the local lognormal vol
// sig*exp((beta-1)*lf) at lf = log F; lf += (vol_loc*sqrt_dt)*z_f, less
// ((0.5*vol_loc)*vol_loc)*dt; sig *= exp((nu*sqrt_dt)*z_vol -
// ((0.5*nu)*nu)*dt), the exact lognormal factor.  kUnitBeta: the caller
// knows beta is 1, where (beta-1)*lf is +-0 for a finite lf, expf(+-0) is 1
// and sig*1 is sig; the step then takes vol_loc = sig without the expf, and
// NaN where lf is +-inf or NaN (0*inf is NaN): bit for bit the same step.
template <bool kUnitBeta = false>
__device__ __forceinline__ void sabr_step(const SABRParams& c, float z_vol, float z_perp,
                                          float& lf, float& sig) {
  const float z_f = c.rho * z_vol + c.rho_perp * z_perp;
  const float vol_loc = kUnitBeta ? (isfinite(lf) ? sig : __int_as_float(0x7fc00000))
                                  : sig * expf((c.beta - 1.0f) * lf);
  lf = (lf + (vol_loc * c.sqrt_dt) * z_f) - ((0.5f * vol_loc) * vol_loc) * c.pay.dt;
  sig = sig * expf((c.nu * c.sqrt_dt) * z_vol - ((0.5f * c.nu) * c.nu) * c.pay.dt);
}

// SABR for the family NMC engine (mc_tpu/nmc_sabr.py:36-108): grids (F,
// sig), no extras.  The outer path starts from log(f0) and alpha (the
// forward, not the spot), step j draws pair (id, j) (its draw unit), and the carry keeps
// the rounded F = exp(log F) the step stored, which the outer payoff reads.
// The inner leg resumes from (log F_t, sig_t), substep u on pair c_base + u,
// and pays on exp(log F) (at the last row on exp(log F_T)).
struct SABRFamily {
  using Params = SABRParams;
  static constexpr int kGrids = 2;
  static constexpr int kLegs = family_legs(1);
  using OuterDraw = DrawWords<2>;  // step j's pair (z_vol, z_perp)
  static constexpr int kStepsPerDraw = 1;
  static constexpr int kTrajSplitBlocks = 2;

  template <class Payoff>
  struct Carry {
    float lf, sig, f;  // log F, the vol, F = exp(log F)
    typename Payoff::State st;
  };

  __device__ static Params load(const float* __restrict__ params, const FamilyExtras&, int) {
    return load_sabr(params);
  }
  __device__ static const mc::Params& payoff_params(const Params& c) { return c.pay; }

  template <class Payoff>
  __device__ static Carry<Payoff> outer_init(const Params& c) {
    return Carry<Payoff>{logf(c.f0), c.alpha, c.f0, Payoff::init(c.pay)};
  }
  __device__ static void outer_draw(const Params&, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t u, OuterDraw& d) {
    normal_pair<13>(k0, k1, id, u, d.w[0], d.w[1]);
  }
  template <class Payoff>
  __device__ static void outer_advance(const Params& c, int, const OuterDraw& d,
                                       Carry<Payoff>& o) {
    sabr_step(c, d.w[0], d.w[1], o.lf, o.sig);
    o.f = expf(o.lf);
    o.st = Payoff::update(o.st, o.f, c.pay);
  }
  template <class Payoff>
  __device__ static void outer_step(const Params& c, uint32_t k0, uint32_t k1, uint32_t id,
                                    int j, Carry<Payoff>& o) {
    OuterDraw d;
    outer_draw(c, k0, k1, id, static_cast<uint32_t>(j), d);
    outer_advance<Payoff>(c, j, d, o);
  }
  template <class Payoff>
  __device__ static void point(const Carry<Payoff>& o, float (&g)[kGrids]) {
    g[0] = o.f;
    g[1] = o.sig;
  }
  template <class Payoff>
  __device__ static float outer_pay(const Params& c, const Carry<Payoff>& o) {
    return Payoff::terminal(o.st, o.f, c.pay);
  }
  template <class Payoff>
  __device__ static void inner_legs(const Params& c, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t c_base, uint32_t stride, int remaining,
                                    const float (&g)[kGrids],
                                    const typename Payoff::State& st0, float (&pay)[kLegs]) {
    const float lf0 = logf(g[0]);
    float lf[kLegs], sig[kLegs];
    typename Payoff::State st[kLegs];
#pragma unroll
    for (int l = 0; l < kLegs; ++l) {
      lf[l] = lf0;
      sig[l] = g[1];
      st[l] = st0;
    }
    for (int u = 0; u < remaining; ++u) {
#pragma unroll
      for (int l = 0; l < kLegs; ++l) {
        float z_vol, z_perp;
        normal_pair<13>(k0, k1, id, c_base + l * stride + static_cast<uint32_t>(u), z_vol,
                        z_perp);
        sabr_step(c, z_vol, z_perp, lf[l], sig[l]);
        st[l] = Payoff::update(st[l], expf(lf[l]), c.pay);
      }
    }
#pragma unroll
    for (int l = 0; l < kLegs; ++l) pay[l] = Payoff::terminal(st[l], expf(lf[l]), c.pay);
  }
  __device__ static float point_scale(const Params& c, const float (&)[kGrids]) {
    return expf(-c.pay.r * c.pay.t);  // the full e^{-rT}
  }
  __device__ static uint32_t counter_stride(const Params&, int n_steps) {
    return static_cast<uint32_t>(n_steps);  // one pair per substep
  }
};

// SABR's leg on a randomized-QMC draw (qmc_model.cuh, #33): step j reads
// pair j as (z_vol, z_perp); kShifts legs in lockstep.
struct SABRQmcLeg {
  using Params = SABRParams;
  static constexpr int kShifts = qmc_shifts(4);
  __device__ static Params load(const float* __restrict__ params, int, int) {
    return load_sabr(params);
  }
  template <class Payoff, class Draw>
  __device__ static void pay(const Params& c, int n_steps, const Draw& draw,
                             float (&pay)[kShifts]) {
    constexpr int K = kShifts;
    const float lf0 = logf(c.f0);
    float lf[K], sig[K];
    typename Payoff::State st[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lf[k] = lf0;
      sig[k] = c.alpha;
      st[k] = Payoff::init(c.pay);
    }
    for (int j = 0; j < n_steps; ++j) {
      float z_vol[K], z_perp[K];
      draw.pair(j, z_vol, z_perp);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sabr_step(c, z_vol[k], z_perp[k], lf[k], sig[k]);
        st[k] = Payoff::update(st[k], expf(lf[k]), c.pay);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) pay[k] = Payoff::terminal(st[k], expf(lf[k]), c.pay);
  }
};

}  // namespace mc
