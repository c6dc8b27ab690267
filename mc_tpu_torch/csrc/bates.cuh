// The Bates (1996) family on the device: Heston's variance and schemes
// (heston.cuh) plus Merton's compound-Poisson jump (merton.cuh), composed as
// mc_tpu/models/bates.py composes them.  BatesParams is the layout of
// BATES_FIELDS (20 f32): HESTON_FIELDS, whose growth is compensated by
// lam*kbar, then lam_dt, mu_j, sigma_j; load_heston reads the first 17
// unchanged.  The build passes --fmad=false, so each mul and add rounds as
// it does in the plain PyTorch version.
#pragma once

#include <cstdint>

#include "family.cuh"
#include "heston.cuh"
#include "merton.cuh"
#include "payoffs.cuh"
#include "qmc.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kBatesFields = 20;

// Paths a block of the Bates partials kernels (one a thread):
// bates_kernels.cu, bates_qe_kernels.cu.
constexpr int kBatesThreads = 256;
// The deepest Poisson scan a partials kernel takes (BatesConfig's MAX_KMAX).
constexpr int kBatesMaxKmax = 256;

struct BatesParams {
  HestonParams h;
  float lam_dt, mu_j, sigma_j;
};

__device__ __forceinline__ BatesParams load_bates(const float* __restrict__ v) {
  BatesParams b;
  b.h = load_heston(v);
  b.lam_dt = v[17]; b.mu_j = v[18]; b.sigma_j = v[19];
  return b;
}

// The jump half of a Bates step after the diffusion substep moved (w, v),
// on the jump count n: w += jump(n, e), S = base*exp(w), the payoff state
// updated.
template <class Payoff>
__device__ __forceinline__ void bates_jump_n(const BatesParams& b, float n, float e, float base,
                                             float& w, float& s, typename Payoff::State& st) {
  w = w + jump_increment(b.mu_j, b.sigma_j, n, e);
  s = base * expf(w);  // log-space: one exp rounding per S_t
  st = Payoff::update(st, s, b.h.pay);
}

// The same, its count scanned from the uniform u.
template <class Payoff>
__device__ __forceinline__ void bates_jump(const BatesParams& b, int kmax, float e, float u,
                                           float base, float& w, float& s,
                                           typename Payoff::State& st) {
  bates_jump_n<Payoff>(b, poisson_inv_cdf(u, b.lam_dt, kmax), e, base, w, s, st);
}

// The draws of a Bates Euler step from counter c: the diffusion pair
// (z_v, z_perp) of (id, c), the first normal of (id, c+1) for the jump size
// and word 0 of (id, c+2) for the Poisson uniform.
template <int ROUNDS>
__device__ __forceinline__ void bates_euler_draw(uint32_t k0, uint32_t k1, uint32_t id,
                                                 uint32_t c, float& z_v, float& z_perp,
                                                 float& e, float& u) {
  float unused;
  normal_pair<ROUNDS>(k0, k1, id, c, z_v, z_perp);
  normal_pair<ROUNDS>(k0, k1, id, c + 1u, e, unused);
  u = unit_draw<ROUNDS>(k0, k1, id, c + 2u);
}

// One Bates Euler step from counter c (threefry-13): Heston's
// full-truncation step, then the jump.  The outer step (c = 3j) and the
// inner substep (c = c_base + 3u) of the family NMC.
template <class Payoff>
__device__ __forceinline__ void bates_euler_step(const BatesParams& b, int kmax, uint32_t k0,
                                                 uint32_t k1, uint32_t id, uint32_t c,
                                                 float base, float& w, float& v, float& s,
                                                 typename Payoff::State& st) {
  float z_v, z_perp, e, u;
  bates_euler_draw<13>(k0, k1, id, c, z_v, z_perp, e, u);
  heston_euler_step(b.h, z_v, z_perp, w, v);
  bates_jump<Payoff>(b, kmax, e, u, base, w, s, st);
}

// Bates for the family NMC engine (mc_tpu/nmc_bates.py:47-188): grids (S, v);
// outer step j on counters 3j, 3j+1, 3j+2 (price_bates's Euler path: its
// draw unit, bates_euler_draw), the
// inner legs from (S_t, v_t) with w from 0 on c_base + 3u, their jump
// counts taken against the block's cdf table as Merton's.
struct BatesFamilyParams {
  BatesParams b;
  int kmax;
  const float* cdf;  // the sweep's table, F(0..kmax-1)
};

struct BatesFamily {
  using Params = BatesFamilyParams;
  static constexpr int kGrids = 2;
  static constexpr int kLegs = family_legs(2);
  // step j's draw: (z_v, z_perp, e, u), u the Poisson uniform or its count
  using OuterDraw = DrawWords<4>;
  static constexpr int kStepsPerDraw = 1;
  static constexpr int kTrajSplitBlocks = 4;  // the draw is most of a step

  template <class Payoff>
  struct Carry {
    float w, v, s;
    typename Payoff::State st;
  };

  __device__ static Params load(const float* __restrict__ params, const FamilyExtras& ex,
                                int) {
    return Params{load_bates(params), ex.i[0], nullptr};
  }
  static int table_floats(const FamilyExtras& ex) { return ex.i[0]; }  // host
  __device__ static void fill_table(const Params& p, float* table) {
    poisson_cdf_table(p.b.lam_dt, p.kmax, table);
  }
  __device__ static void attach_table(Params& p, const float* table) { p.cdf = table; }
  __device__ static const mc::Params& payoff_params(const Params& p) { return p.b.h.pay; }

  template <class Payoff>
  __device__ static Carry<Payoff> outer_init(const Params& p) {
    return Carry<Payoff>{0.0f, p.b.h.v0, p.b.h.pay.s0, Payoff::init(p.b.h.pay)};
  }
  __device__ static void outer_draw(const Params&, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t u, OuterDraw& d) {
    bates_euler_draw<13>(k0, k1, id, 3u * u, d.w[0], d.w[1], d.w[2], d.w[3]);
  }
  // The uniform's count against the block's table, in place.
  __device__ static void draw_counts(const Params& p, OuterDraw& d) {
    const float u[1] = {d.w[3]};
    float n[1];
    poisson_counts(p.cdf, p.kmax, u, n);
    d.w[3] = n[0];
  }
  template <class Payoff>
  __device__ static void outer_advance(const Params& p, int, const OuterDraw& d,
                                       Carry<Payoff>& c) {
    heston_euler_step(p.b.h, d.w[0], d.w[1], c.w, c.v);
    bates_jump<Payoff>(p.b, p.kmax, d.w[2], d.w[3], p.b.h.pay.s0, c.w, c.s, c.st);
  }
  template <class Payoff>
  __device__ static void outer_advance_counted(const Params& p, int, const OuterDraw& d,
                                               Carry<Payoff>& c) {
    heston_euler_step(p.b.h, d.w[0], d.w[1], c.w, c.v);
    bates_jump_n<Payoff>(p.b, d.w[3], d.w[2], p.b.h.pay.s0, c.w, c.s, c.st);
  }
  // bates_euler_step on counter 3j: the draw, then the advance.
  template <class Payoff>
  __device__ static void outer_step(const Params& p, uint32_t k0, uint32_t k1, uint32_t id,
                                    int j, Carry<Payoff>& c) {
    OuterDraw d;
    outer_draw(p, k0, k1, id, static_cast<uint32_t>(j), d);
    outer_advance<Payoff>(p, j, d, c);
  }
  template <class Payoff>
  __device__ static void point(const Carry<Payoff>& c, float (&g)[kGrids]) {
    g[0] = c.s;
    g[1] = c.v;
  }
  template <class Payoff>
  __device__ static float outer_pay(const Params& p, const Carry<Payoff>& c) {
    return Payoff::terminal(c.st, c.s, p.b.h.pay);
  }
  template <class Payoff>
  __device__ static void inner_legs(const Params& p, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t c_base, uint32_t stride, int remaining,
                                    const float (&g)[kGrids],
                                    const typename Payoff::State& st0, float (&pay)[kLegs]) {
    float w[kLegs], v[kLegs], s[kLegs];
    typename Payoff::State st[kLegs];
#pragma unroll
    for (int l = 0; l < kLegs; ++l) {
      w[l] = 0.0f;
      v[l] = g[1];
      s[l] = g[0];
      st[l] = st0;
    }
    for (int u = 0; u < remaining; ++u) {
      float e[kLegs], uu[kLegs], n[kLegs];
#pragma unroll
      for (int l = 0; l < kLegs; ++l) {
        float z_v, z_perp;
        bates_euler_draw<13>(k0, k1, id, c_base + l * stride + 3u * static_cast<uint32_t>(u),
                             z_v, z_perp, e[l], uu[l]);
        heston_euler_step(p.b.h, z_v, z_perp, w[l], v[l]);
      }
      poisson_counts(p.cdf, p.kmax, uu, n);
#pragma unroll
      for (int l = 0; l < kLegs; ++l) {
        bates_jump_n<Payoff>(p.b, n[l], e[l], g[0], w[l], s[l], st[l]);
      }
    }
#pragma unroll
    for (int l = 0; l < kLegs; ++l) pay[l] = Payoff::terminal(st[l], s[l], p.b.h.pay);
  }
  __device__ static float point_scale(const Params& p, const float (&)[kGrids]) {
    return expf(-p.b.h.pay.r * p.b.h.pay.t);  // the full e^{-rT}
  }
  __device__ static uint32_t counter_stride(const Params&, int n_steps) {
    return 3u * static_cast<uint32_t>(n_steps);
  }
};

// Bates's Euler leg on a randomized-QMC draw (qmc_model.cuh, #33), mc_tpu's
// packed layout of 4 dimensions a step (ROADMAP C4): step j reads pair 2j
// (dimensions 4j, 4j+1) as the diffusion pair, dimension 4j+2 as the
// jump-size normal and the RAW coordinate 4j+3 for the Poisson count (the
// normal of 4j+3, which mc_tpu draws and discards, is not computed).  The
// draw split from the step: Heston's Euler step, then the jump on the count
// taken against the block's cdf table (the scan's, bit for bit); the MC
// kernels' bates_euler_step is untouched.  extra is the scan depth kmax.
// kShifts legs in lockstep.
struct BatesQmcLegParams {
  BatesParams b;
  int kmax;
  const float* cdf;  // the block's table, F(0..kmax-1)
};

struct BatesQmcLeg {
  using Params = BatesQmcLegParams;
  static constexpr int kShifts = qmc_shifts(4);
  __device__ static Params load(const float* __restrict__ params, int, int kmax) {
    return Params{load_bates(params), kmax, nullptr};
  }
  static int table_floats(int kmax) { return kmax; }  // host
  __device__ static void fill_table(const Params& p, float* table) {
    poisson_cdf_table(p.b.lam_dt, p.kmax, table);
  }
  template <class Payoff, class Draw>
  __device__ static void pay(const Params& p, int n_steps, const Draw& draw,
                             float (&pay)[kShifts]) {
    constexpr int K = kShifts;
    const float s0 = p.b.h.pay.s0;
    float w[K], v[K], s[K];
    typename Payoff::State st[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      w[k] = 0.0f;
      v[k] = p.b.h.v0;
      s[k] = s0;
      st[k] = Payoff::init(p.b.h.pay);
    }
    for (int j = 0; j < n_steps; ++j) {
      float z_v[K], z_perp[K], e[K], u[K], n[K];
      draw.pair(2 * j, z_v, z_perp);
      draw.normals(4 * j + 2, e);
      draw.units(4 * j + 3, u);
      poisson_counts(p.cdf, p.kmax, u, n);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        heston_euler_step(p.b.h, z_v[k], z_perp[k], w[k], v[k]);
        bates_jump_n<Payoff>(p.b, n[k], e[k], s0, w[k], s[k], st[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) pay[k] = Payoff::terminal(st[k], s[k], p.b.h.pay);
  }
};

}  // namespace mc
