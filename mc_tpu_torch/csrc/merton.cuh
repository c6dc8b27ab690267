// The Merton jump-diffusion family on the device: its packed parameters, the
// Poisson inverse-CDF scan, the step and the family NMC struct, the twins of
// mc_tpu_torch/models/merton.py (and of mc_tpu/models/merton.py:82-228)
// operation for operation, in the same association.  The build passes
// --fmad=false, so each mul and add rounds as it does in the plain PyTorch
// version.
//
// MertonParams is the layout of MERTON_FIELDS (19 f32).  Merton packs every
// field of the payoffs' Params (sigma, q, dt and the drift/vol
// coefficients, drift compensated by lam*kappa), so every payoff of the
// registry prices under it, the two Brownian-bridge barriers included
// (their crossing probability reads the diffusion's sigma, as in mc_tpu).
#pragma once

#include <cstdint>

#include "family.cuh"
#include "payoffs.cuh"
#include "qmc.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kMertonFields = 19;

struct MertonParams {
  Params pay;  // the payoff's view of the contract
  float lam_dt, lam_t, mu_j, sigma_j;
};

__device__ __forceinline__ MertonParams load_merton(const float* __restrict__ v) {
  MertonParams m;
  m.pay.s0 = v[0]; m.pay.k = v[1]; m.pay.r = v[2]; m.pay.barrier = v[3];
  m.pay.p1 = v[4]; m.pay.p2 = v[5]; m.pay.t = v[6]; m.pay.q = v[7];
  m.pay.sigma = v[8]; m.pay.dt = v[9]; m.pay.inv_n_steps = v[10];
  m.pay.drift_dt = v[11]; m.pay.vol_dt = v[12]; m.pay.drift_t = v[13];
  m.pay.vol_t = v[14];
  m.lam_dt = v[15]; m.lam_t = v[16]; m.mu_j = v[17]; m.sigma_j = v[18];
  return m;
}

// The branch-free Poisson inverse CDF: N = #{k in 0..kmax-1 : u >= F(k)},
// as an f32 count.  kmax (<= 256, host-chosen so the clipped tail is below
// 1e-12) is a runtime loop bound; the pmf recurrence (pmf*lam)/k and the cdf
// sum run in mc_tpu's order, so a count moves only where u lands within an
// ulp of a cdf step.
__device__ __forceinline__ float poisson_inv_cdf(float u, float lam, int kmax) {
  float pmf = expf(-lam);
  float cdf = pmf;
  float n = 0.0f;
  for (int k = 1; k <= kmax; ++k) {
    n = n + (u >= cdf ? 1.0f : 0.0f);
    pmf = (pmf * lam) / static_cast<float>(k);
    cdf = cdf + pmf;
  }
  return n;
}

// The compound-jump log increment given the count n and one N(0,1) e:
// n*mu_j + (sigma_j*sqrt(n))*e (mc_tpu's _jump_increment).
__device__ __forceinline__ float jump_increment(float mu_j, float sigma_j, float n, float e) {
  return n * mu_j + (sigma_j * sqrtf(n)) * e;
}

// The Poisson cdf values the scan compares against, F(0..kmax-1): the
// recurrence of poisson_inv_cdf in its order, so a count taken against the
// table is the scan's, bit for bit.
__device__ __forceinline__ void poisson_cdf_table(float lam, int kmax, float* cdf_k) {
  float pmf = expf(-lam);
  float cdf = pmf;
  for (int k = 0; k < kmax; ++k) {
    cdf_k[k] = cdf;
    pmf = (pmf * lam) / static_cast<float>(k + 1);
    cdf = cdf + pmf;
  }
}

// The scan's counts for L uniforms against the table: N_l = #{k : u_l >=
// F(k)}, each F(k) read once for the L of them.
template <int L>
__device__ __forceinline__ void poisson_counts(const float* cdf_k, int kmax,
                                               const float (&u)[L], float (&n)[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) n[l] = 0.0f;
  for (int k = 0; k < kmax; ++k) {
    const float f = cdf_k[k];
#pragma unroll
    for (int l = 0; l < L; ++l) n[l] = n[l] + (u[l] >= f ? 1.0f : 0.0f);
  }
}

// One Merton step on the jump count n from the leg's start price `base`
// (s0, or the stored S_t of an inner leg): the exact-in-law log increment
// w = ((w + drift_dt) + vol_dt*z) + jump, S = base*exp(w).
template <class Payoff>
__device__ __forceinline__ void merton_step_n(const MertonParams& m, float n, float z, float e,
                                              float base, float& w, float& s,
                                              typename Payoff::State& st) {
  w = ((w + m.pay.drift_dt) + m.pay.vol_dt * z) + jump_increment(m.mu_j, m.sigma_j, n, e);
  s = base * expf(w);  // log-space: one exp rounding per S_t
  st = Payoff::update(st, s, m.pay);
}

// The same step, its count scanned from the uniform u.
template <class Payoff>
__device__ __forceinline__ void merton_step(const MertonParams& m, int kmax, float z, float e,
                                            float u, float base, float& w, float& s,
                                            typename Payoff::State& st) {
  merton_step_n<Payoff>(m, poisson_inv_cdf(u, m.lam_dt, kmax), z, e, base, w, s, st);
}

// The draws of the step pair (2m, 2m+1): the diffusion normals of pair
// (id, 3m), the jump-size normals of (id, 3m+1) and the Poisson uniforms of
// both words of (id, 3m+2) (mc_tpu's _merton_draw3).
struct MertonDraws {
  float z0, z1, e0, e1, u0, u1;
};

template <int ROUNDS>
__device__ __forceinline__ MertonDraws merton_draw3(uint32_t k0, uint32_t k1, uint32_t id,
                                                    uint32_t m) {
  MertonDraws d;
  const uint32_t base = 3u * m;
  normal_pair<ROUNDS>(k0, k1, id, base, d.z0, d.z1);
  normal_pair<ROUNDS>(k0, k1, id, base + 1u, d.e0, d.e1);
  uint32_t x0 = id, x1 = base + 2u;
  threefry2x32<ROUNDS>(k0, k1, x0, x1);
  d.u0 = bits_to_unit(x0);
  d.u1 = bits_to_unit(x1);
  return d;
}

// Merton for the family NMC engine (mc_tpu/nmc_merton.py:44-166): grid S;
// the inner legs resume from S_t with w from 0, substep u drawing the normal
// pair (z, e) of counter c_base + 2u and the Poisson uniform of word 0 of
// c_base + 2u + 1, its count taken against the block's cdf table (shared
// memory, built once a block) where the outer steps scan.  The carry holds
// s, so outer_pay reads the rounded spot the step stored.
//
// The outer path: draw unit m is the step pair (2m, 2m+1)'s merton_draw3 on
// the threefry-13 stream, OuterDraw [z0, z1, e0, e1, u0, u1]; step j takes
// its half (z, e, u)_{j&1}.  The step of the trajectories kernel (#15) and of
// the fused family kernel's outer paths, both stepping j = 0, 1, 2, ... in
// order, so the grids one stores are bitwise the states the other
// recomputes; the trajectories kernel takes the counts against the block's
// table on its draw side (draw_counts: the scan's counts, bit for bit).
struct MertonFamilyParams {
  MertonParams m;
  int kmax;
  const float* cdf;  // the sweep's table, F(0..kmax-1)
};

struct MertonFamily {
  using Params = MertonFamilyParams;
  static constexpr int kGrids = 1;
  static constexpr int kLegs = family_legs(4);

  using OuterDraw = DrawWords<6>;
  static constexpr int kStepsPerDraw = 2;
  static constexpr int kTrajSplitBlocks = 4;  // the draw is most of a step

  template <class Payoff>
  struct Carry {
    float w, s;
    typename Payoff::State st;
    float next[3];  // the odd step's half (z, e, u), parked by the even step
  };

  __device__ static Params load(const float* __restrict__ params, const FamilyExtras& ex,
                                int) {
    return Params{load_merton(params), ex.i[0], nullptr};
  }
  static int table_floats(const FamilyExtras& ex) { return ex.i[0]; }  // host
  __device__ static void fill_table(const Params& p, float* table) {
    poisson_cdf_table(p.m.lam_dt, p.kmax, table);
  }
  __device__ static void attach_table(Params& p, const float* table) { p.cdf = table; }
  __device__ static const mc::Params& payoff_params(const Params& p) { return p.m.pay; }

  template <class Payoff>
  __device__ static Carry<Payoff> outer_init(const Params& p) {
    return Carry<Payoff>{0.0f, p.m.pay.s0, Payoff::init(p.m.pay), {0.0f, 0.0f, 0.0f}};
  }
  __device__ static void outer_draw(const Params&, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t u, OuterDraw& d) {
    const MertonDraws m = merton_draw3<13>(k0, k1, id, u);
    d = OuterDraw{{m.z0, m.z1, m.e0, m.e1, m.u0, m.u1}};
  }
  // The uniforms' counts against the block's table, in place.
  __device__ static void draw_counts(const Params& p, OuterDraw& d) {
    const float u[2] = {d.w[4], d.w[5]};
    float n[2];
    poisson_counts(p.cdf, p.kmax, u, n);
    d.w[4] = n[0];
    d.w[5] = n[1];
  }
  template <class Payoff>
  __device__ static void outer_advance(const Params& p, int j, const OuterDraw& d,
                                       Carry<Payoff>& c) {
    const bool even = (j & 1) == 0;
    merton_step<Payoff>(p.m, p.kmax, even ? d.w[0] : d.w[1], even ? d.w[2] : d.w[3],
                        even ? d.w[4] : d.w[5], p.m.pay.s0, c.w, c.s, c.st);
  }
  template <class Payoff>
  __device__ static void outer_advance_counted(const Params& p, int j, const OuterDraw& d,
                                               Carry<Payoff>& c) {
    const bool even = (j & 1) == 0;
    merton_step_n<Payoff>(p.m, even ? d.w[4] : d.w[5], even ? d.w[0] : d.w[1],
                          even ? d.w[2] : d.w[3], p.m.pay.s0, c.w, c.s, c.st);
  }
  // The draw at an even step, its odd half parked in the carry, then the
  // step on its half: outer_advance's step.
  template <class Payoff>
  __device__ static void outer_step(const Params& p, uint32_t k0, uint32_t k1, uint32_t id,
                                    int j, Carry<Payoff>& c) {
    float z, e, u;
    if ((j & 1) == 0) {
      OuterDraw d;
      outer_draw(p, k0, k1, id, static_cast<uint32_t>(j >> 1), d);
      z = d.w[0]; e = d.w[2]; u = d.w[4];
      c.next[0] = d.w[1]; c.next[1] = d.w[3]; c.next[2] = d.w[5];
    } else {
      z = c.next[0]; e = c.next[1]; u = c.next[2];
    }
    merton_step<Payoff>(p.m, p.kmax, z, e, u, p.m.pay.s0, c.w, c.s, c.st);
  }
  template <class Payoff>
  __device__ static void point(const Carry<Payoff>& c, float (&g)[kGrids]) {
    g[0] = c.s;
  }
  template <class Payoff>
  __device__ static float outer_pay(const Params& p, const Carry<Payoff>& c) {
    return Payoff::terminal(c.st, c.s, p.m.pay);
  }
  template <class Payoff>
  __device__ static void inner_legs(const Params& p, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t c_base, uint32_t stride, int remaining,
                                    const float (&g)[kGrids],
                                    const typename Payoff::State& st0, float (&pay)[kLegs]) {
    float w[kLegs], s[kLegs];
    typename Payoff::State st[kLegs];
#pragma unroll
    for (int l = 0; l < kLegs; ++l) {
      w[l] = 0.0f;
      s[l] = g[0];
      st[l] = st0;
    }
    for (int u = 0; u < remaining; ++u) {
      float z[kLegs], e[kLegs], uu[kLegs], n[kLegs];
#pragma unroll
      for (int l = 0; l < kLegs; ++l) {
        const uint32_t c = c_base + l * stride + 2u * static_cast<uint32_t>(u);
        normal_pair<13>(k0, k1, id, c, z[l], e[l]);
        uu[l] = unit_draw<13>(k0, k1, id, c + 1u);
      }
      poisson_counts(p.cdf, p.kmax, uu, n);
#pragma unroll
      for (int l = 0; l < kLegs; ++l) {
        merton_step_n<Payoff>(p.m, n[l], z[l], e[l], g[0], w[l], s[l], st[l]);
      }
    }
#pragma unroll
    for (int l = 0; l < kLegs; ++l) pay[l] = Payoff::terminal(st[l], s[l], p.m.pay);
  }
  __device__ static float point_scale(const Params& p, const float (&)[kGrids]) {
    return expf(-p.m.pay.r * p.m.pay.t);  // the full e^{-rT}
  }
  __device__ static uint32_t counter_stride(const Params&, int n_steps) {
    return 2u * static_cast<uint32_t>(n_steps);
  }
};

// Merton's Euler leg on a randomized-QMC draw (qmc_model.cuh, #33),
// mc_tpu's draw3 layout: step pair m reads pairs 3m (diffusion) and 3m+1
// (jump sizes) and the RAW coordinates 6m+4, 6m+5 for the Poisson counts;
// extra is the scan depth kmax.  kShifts legs in lockstep; the counts are
// taken against the block's cdf table (the scan's, bit for bit).
struct MertonQmcLegParams {
  MertonParams m;
  int kmax;
  const float* cdf;  // the block's table, F(0..kmax-1)
};

struct MertonQmcLeg {
  using Params = MertonQmcLegParams;
  static constexpr int kShifts = qmc_shifts(4);
  __device__ static Params load(const float* __restrict__ params, int, int kmax) {
    return Params{load_merton(params), kmax, nullptr};
  }
  static int table_floats(int kmax) { return kmax; }  // host
  __device__ static void fill_table(const Params& p, float* table) {
    poisson_cdf_table(p.m.lam_dt, p.kmax, table);
  }
  template <class Payoff, class Draw>
  __device__ static void pay(const Params& p, int n_steps, const Draw& draw,
                             float (&pay)[kShifts]) {
    constexpr int K = kShifts;
    const float s0 = p.m.pay.s0;
    float w[K], s[K];
    typename Payoff::State st[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      w[k] = 0.0f;
      s[k] = s0;
      st[k] = Payoff::init(p.m.pay);
    }
    for (int m = 0; m < n_steps / 2; ++m) {
      float z0[K], z1[K], e0[K], e1[K], u0[K], u1[K], n0[K], n1[K];
      draw.pair(3 * m, z0, z1);
      draw.pair(3 * m + 1, e0, e1);
      draw.units(6 * m + 4, u0);
      draw.units(6 * m + 5, u1);
      poisson_counts(p.cdf, p.kmax, u0, n0);
      poisson_counts(p.cdf, p.kmax, u1, n1);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        merton_step_n<Payoff>(p.m, n0[k], z0[k], e0[k], s0, w[k], s[k], st[k]);
        merton_step_n<Payoff>(p.m, n1[k], z1[k], e1[k], s0, w[k], s[k], st[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) pay[k] = Payoff::terminal(st[k], s[k], p.m.pay);
  }
};

}  // namespace mc
