// The Heston family on the device: its packed parameters and its two
// schemes, the twins of mc_tpu_torch/models/heston.py (and of
// mc_tpu/models/heston.py:94-220) operation for operation, in the same
// association.  The build passes --fmad=false, so each mul and add rounds
// as it does in the plain PyTorch version and the kernels that step with
// these functions give the plain version's values bit for bit.
//
// HestonParams is the layout of HESTON_FIELDS (17 f32).  A payoff reads the
// Params of payoffs.cuh; under Heston it gets one filled with the fields a
// payoff may read (s0, k, r, barrier, p1, p2, t, dt, inv_n_steps), and the
// GBM-only ones (sigma, q and the drift/vol coefficients) are NaN, so a
// payoff that read them would fail its gate loudly rather than price with a
// stale volatility.  The entry points refuse the two payoffs that do
// (the Brownian-bridge barriers).
#pragma once

#include <cstdint>

#include "payoffs.cuh"
#include "qmc.cuh"
#include "rng.cuh"

namespace mc {

struct HestonParams {
  Params pay;  // the payoff's view of the contract
  float v0, kappa, theta, xi, rho, rho_perp, sqrt_dt, growth;
};
constexpr int kHestonFields = 17;

// Paths a block of the Heston partials kernels (one a thread):
// heston_kernels.cu, heston_qe_kernels.cu.
constexpr int kHestonThreads = 256;

__device__ __forceinline__ HestonParams load_heston(const float* __restrict__ v) {
  const float nan = __int_as_float(0x7fc00000);
  HestonParams h;
  h.pay.s0 = v[0]; h.pay.k = v[1]; h.pay.r = v[2]; h.pay.barrier = v[3];
  h.pay.p1 = v[4]; h.pay.p2 = v[5]; h.pay.t = v[6]; h.pay.dt = v[7];
  h.pay.inv_n_steps = v[8];
  h.pay.sigma = nan; h.pay.q = nan; h.pay.drift_dt = nan; h.pay.vol_dt = nan;
  h.pay.drift_t = nan; h.pay.vol_t = nan;
  h.v0 = v[9]; h.kappa = v[10]; h.theta = v[11]; h.xi = v[12]; h.rho = v[13];
  h.rho_perp = v[14]; h.sqrt_dt = v[15]; h.growth = v[16];
  return h;
}

// One full-truncation Euler substep of the log-price accumulator w and the
// variance v: only v+ = max(v, 0) enters the diffusion terms.
__device__ __forceinline__ void heston_euler_step(const HestonParams& h, float z_v,
                                                  float z_perp, float& w, float& v) {
  const float z_s = h.rho * z_v + h.rho_perp * z_perp;
  const float v_plus = fmaxf(v, 0.0f);
  const float sq = (v > 0.0f ? sqrtf(v) : 0.0f) * h.sqrt_dt;
  w = w + ((h.growth - 0.5f * v_plus) * h.pay.dt + sq * z_s);
  v = (v + (h.kappa * (h.theta - v_plus)) * h.pay.dt) + (h.xi * sq) * z_v;
}

// Per-step constants of Andersen's QE scheme, gamma1 = gamma2 = 1/2.
struct QeConsts {
  float emkdt, c1, c2, k0, k1, k2, k3, k4, a_mc, growth_dt;
};

__device__ __forceinline__ QeConsts qe_consts(const HestonParams& h) {
  const float gamma = 0.5f;
  const float dt = h.pay.dt;
  QeConsts c;
  c.emkdt = expf(-h.kappa * dt);
  const float one_m = 1.0f - c.emkdt;
  c.c1 = (((h.xi * h.xi) * c.emkdt) * one_m) / h.kappa;
  c.c2 = ((((h.theta * h.xi) * h.xi) * one_m) * one_m) / (2.0f * h.kappa);
  const float kr = (h.kappa * h.rho) / h.xi - 0.5f;
  c.k0 = ((((-h.rho) * h.kappa) * h.theta) * dt) / h.xi;
  c.k1 = (gamma * dt) * kr - h.rho / h.xi;
  c.k2 = (gamma * dt) * kr + h.rho / h.xi;
  c.k3 = (gamma * dt) * (1.0f - h.rho * h.rho);
  c.k4 = c.k3;
  c.a_mc = c.k2 + 0.5f * c.k4;  // martingale-correction exponent A
  c.growth_dt = h.growth * dt;
  return c;
}

// One QE step (w, v) -> (w', v'), v' >= 0, with the per-step martingale
// correction K0* (Andersen 2008, Prop. 5.1; the plain K0 where its validity
// constraint fails), split at Andersen's switch: qe_moments gives m and
// psi, a lane with psi <= 1.5 takes qe_quadratic_step (its z_v), any other
// (a NaN psi too) qe_exponential_step (its uniform u), and qe_advance moves
// w.  Each branch is the plain version's (mc_tpu_torch/models/heston.py
// heston_qe_step, which evaluates both on domain-safe arguments and
// selects) operation for operation, so a lane that computes only its own
// gets the selected values bit for bit.
struct QeMoments {
  float m, psi;
};

__device__ __forceinline__ QeMoments qe_moments(const HestonParams& h, const QeConsts& c,
                                                float v) {
  const float m = h.theta + (v - h.theta) * c.emkdt;
  const float s2 = v * c.c1 + c.c2;
  return QeMoments{m, s2 / (m * m)};
}

__device__ __forceinline__ bool qe_quadratic(const QeMoments& q) { return q.psi <= 1.5f; }

constexpr float kQeOneMinus = static_cast<float>(1.0 - 1e-6);

// The quadratic sampler v' = a (b + z_v)^2 and k0_eff: K0* where 2 A a <
// 1 - 1e-6, else the plain K0 + K1 v.
__device__ __forceinline__ void qe_quadratic_step(const QeConsts& c, const QeMoments& q,
                                                  float v, float z_v, float& v_next,
                                                  float& k0_eff) {
  const float two_over = 2.0f / fmaxf(q.psi, 1e-12f);
  float b2 = fmaxf(two_over - 1.0f, 0.0f);
  b2 = b2 + sqrtf(two_over * b2);
  const float a = q.m / (1.0f + b2);
  const float bz = sqrtf(b2) + z_v;
  v_next = (a * bz) * bz;
  const float aa = c.a_mc;
  const float two_a_a = (2.0f * aa) * a;
  if (two_a_a < kQeOneMinus) {
    const float safe = 1.0f - two_a_a;
    k0_eff = ((((-aa) * b2) * a) / safe + 0.5f * logf(safe)) - (0.5f * c.k3) * v;
  } else {
    k0_eff = c.k0 + c.k1 * v;
  }
}

// The exponential sampler (mass p_at0 at zero, an exponential tail) on the
// uniform u and k0_eff: K0* where A < beta (1 - 1e-6), else the plain K0 +
// K1 v.
__device__ __forceinline__ void qe_exponential_step(const QeConsts& c, const QeMoments& q,
                                                    float v, float u, float& v_next,
                                                    float& k0_eff) {
  const float p_at0 = (q.psi - 1.0f) / (q.psi + 1.0f);
  const float beta = (1.0f - p_at0) / fmaxf(q.m, 1e-30f);
  const float u_c = fminf(u, 0.99999994f);
  v_next = u_c <= p_at0 ? 0.0f : (log1pf(-p_at0) - log1pf(-u_c)) / beta;
  const float aa = c.a_mc;
  if (aa < beta * kQeOneMinus) {
    const float marg = p_at0 + (beta * (1.0f - p_at0)) / fmaxf(beta - aa, 1e-30f);
    k0_eff = (-logf(marg)) - (0.5f * c.k3) * v;
  } else {
    k0_eff = c.k0 + c.k1 * v;
  }
}

// w' from the step's v, v' and k0_eff and the spot normal z_s.
__device__ __forceinline__ void qe_advance(const QeConsts& c, float v, float v_next,
                                           float k0_eff, float z_s, float& w) {
  const float var_s = fmaxf(c.k3 * v + c.k4 * v_next, 0.0f);
  w = (((w + c.growth_dt) + k0_eff) + c.k2 * v_next) + sqrtf(var_s) * z_s;
}

// Heston's Euler leg on a randomized-QMC draw (qmc_model.cuh, #33): step j
// reads the normals of pair j as (z_v, z_perp) (mc_tpu's QMC hook runs the
// Euler leg only, mc_tpu/models/heston.py:255); kShifts legs in lockstep.
struct HestonQmcLeg {
  using Params = HestonParams;
  static constexpr int kShifts = qmc_shifts(4);
  __device__ static Params load(const float* __restrict__ params, int, int) {
    return load_heston(params);
  }
  template <class Payoff, class Draw>
  __device__ static void pay(const Params& h, int n_steps, const Draw& draw,
                             float (&pay)[kShifts]) {
    constexpr int K = kShifts;
    float w[K], v[K], s[K];
    typename Payoff::State st[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      w[k] = 0.0f;
      v[k] = h.v0;
      s[k] = h.pay.s0;
      st[k] = Payoff::init(h.pay);
    }
    for (int j = 0; j < n_steps; ++j) {
      float z_v[K], z_perp[K];
      draw.pair(j, z_v, z_perp);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        heston_euler_step(h, z_v[k], z_perp[k], w[k], v[k]);
        s[k] = h.pay.s0 * expf(w[k]);  // log-space: one exp rounding per S_t
        st[k] = Payoff::update(st[k], s[k], h.pay);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) pay[k] = Payoff::terminal(st[k], s[k], h.pay);
  }
};

}  // namespace mc

// The payoffs a Heston (or Bates) kernel takes: every one but the two that
// read sigma.
#define MC_HESTON_PAYOFFS(X)                                              \
  MC_ONE_WORD_PAYOFFS(X)                                                  \
  X(PAYOFF_VARIANCE_SWAP, VarianceSwap)                                   \
  X(PAYOFF_FORWARD_START_CALL, ForwardStartCall)                          \
  X(PAYOFF_CLIQUET, Cliquet) X(PAYOFF_ASIAN_CALL_GEO_CV, AsianCallGeoCV)
