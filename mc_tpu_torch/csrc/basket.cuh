// The correlated basket on the device: its packed parameters, the step (d
// normals, the Cholesky mix, the log increments), the basket level and the
// family NMC structs (the basket's, and the rainbow's, which folds max or
// min where the basket sums), the twins of mc_tpu_torch/models/basket.py,
// mc_tpu_torch/nmc_basket.py and mc_tpu_torch/nmc_rainbow.py (and of
// mc_tpu/models/basket.py:82-134, mc_tpu/nmc_basket.py:44-245,
// mc_tpu/nmc_rainbow.py:54-72) operation for operation, in the same
// association.  The build passes --fmad=false, so each mul and add rounds as
// it does in the plain PyTorch version.
//
// The packed vector has a variable length, 10 + 3d + d(d+1)/2 f32:
//   [k, r, t, barrier, p1, p2, dt, inv_n_steps, sqrt_dt, b0,
//    s0s(d), weights(d), drifts(d), L's lower triangle row by row]
// so the kernels read it by pointer, d a runtime integer.  Its head is the
// payoffs' view of the contract (s0 = b0, the basket's initial level; sigma
// = k*0, as mc_tpu's Pallas kernel unpacks it, so the Brownian-bridge
// barriers price as their discrete twins); q and the GBM drift/vol
// coefficients are NaN.
//
// d is a runtime value up to a capacity kMaxD, a template parameter (8 and 32
// for the family NMC and the QMC leg; the partials and trajectories kernels
// of basket_partials.cuh and the rainbow's of rainbow_partials.cuh take 4,
// 8, 16 and 32 and their own legs), so every d in [1, 32] runs without a
// rebuild and the build stays a few instantiations per kernel and payoff
// (not 32).  At a capacity up to 16 the loops over assets and normals
// unroll fully, guarded by i < d, and the log-moneyness ws[kMaxD] and the
// normals z[kMaxD] live in registers (the loops run to the capacity, each
// body guarded by i < d, no early exit); at capacity 32 they stay loops to d
// (the 528-term Cholesky mix unrolled would cost minutes of ptxas per
// instantiation) and the two arrays live in local memory.  The Cholesky
// factor, s0s, weights and drifts are uniform loads from the packed vector
// (every thread of a warp reads the same word: one L1 broadcast, __ldg); the
// family NMC sweep (basket_mix_legs, basket_levels) reads each once for its
// kLegs legs, through plain loads, from the block's staged copy in shared
// memory.
#pragma once

#include <cstdint>

#include "family.cuh"
#include "payoffs.cuh"
#include "qmc.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kBasketHead = 10;

// The unroll factor of the loops over assets at capacity kMaxD.
template <int kMaxD>
struct BasketUnroll {
  static constexpr int value = kMaxD <= 16 ? kMaxD : 1;
};

// A loop bound over assets (or normals): the capacity where the loop
// unrolls, so every index is a constant and the arrays stay in registers
// (the body guarded by i < n, no early exit); n itself where it does not.
template <int kMaxD>
__device__ __forceinline__ int basket_bound(int n) {
  return kMaxD <= 16 ? kMaxD : n;
}

template <int kMaxD>
struct BasketParams {
  Params pay;  // the payoff's view of the contract
  float sqrt_dt;
  int d, npps;  // assets, threefry pairs a step (ceil(d/2))
  const float* s0s;
  const float* w;
  const float* drift;
  const float* chol;  // row i at i(i+1)/2
};

template <int kMaxD>
__device__ __forceinline__ BasketParams<kMaxD> load_basket(const float* __restrict__ v, int d) {
  const float nan = __int_as_float(0x7fc00000);
  BasketParams<kMaxD> c;
  c.pay.k = v[0]; c.pay.r = v[1]; c.pay.t = v[2]; c.pay.barrier = v[3];
  c.pay.p1 = v[4]; c.pay.p2 = v[5]; c.pay.dt = v[6]; c.pay.inv_n_steps = v[7];
  c.sqrt_dt = v[8]; c.pay.s0 = v[9];
  c.pay.sigma = c.pay.k * 0.0f;  // mc_tpu's Pallas kernel (basket.py:243)
  c.pay.q = nan; c.pay.drift_dt = nan; c.pay.vol_dt = nan; c.pay.drift_t = nan;
  c.pay.vol_t = nan;
  c.d = d;
  c.npps = (d + 1) / 2;
  c.s0s = v + kBasketHead;
  c.w = c.s0s + d;
  c.drift = c.w + d;
  c.chol = c.drift + d;
  return c;
}

// The step's d normals, pair q of counter base + q giving z_{2q}, z_{2q+1},
// times sign (+1, or -1 for the antithetic leg); threefry-13 (the rainbow's
// terminal draw may take 20 rounds).
template <int kMaxD, int ROUNDS = 13>
__device__ __forceinline__ void basket_draw(const BasketParams<kMaxD>& c, uint32_t k0,
                                            uint32_t k1, uint32_t id, uint32_t base,
                                            float sign, float (&z)[kMaxD]) {
#pragma unroll (BasketUnroll<kMaxD>::value)
  for (int q = 0; q < basket_bound<kMaxD / 2>(c.npps); ++q) {
    if (q < c.npps) {
      float a, b;
      normal_pair<ROUNDS>(k0, k1, id, base + static_cast<uint32_t>(q), a, b);
      z[2 * q] = sign * a;
      z[2 * q + 1] = sign * b;
    }
  }
}

// w_i = (w_i + drift_i) + sqrt_dt * y_i, y_i = L_i0 z_0 + L_i1 z_1 + ...
// added in k order.
template <int kMaxD>
__device__ __forceinline__ void basket_mix(const BasketParams<kMaxD>& c, const float (&z)[kMaxD],
                                           float (&ws)[kMaxD]) {
#pragma unroll (BasketUnroll<kMaxD>::value)
  for (int i = 0; i < basket_bound<kMaxD>(c.d); ++i) {
    if (i < c.d) {
      const float* row = c.chol + i * (i + 1) / 2;
      float y = __ldg(row) * z[0];
#pragma unroll (BasketUnroll<kMaxD>::value)
      for (int k = 1; k < basket_bound<kMaxD>(i + 1); ++k) {
        if (k <= i) y = y + __ldg(row + k) * z[k];
      }
      ws[i] = (ws[i] + __ldg(c.drift + i)) + c.sqrt_dt * y;
    }
  }
}

// B = w_0 S_0 + w_1 S_1 + ... in i order, S_i = s0_i * expf(w_i);
// on_asset(i, S_i) sees each asset's price.
template <int kMaxD, class OnAsset>
__device__ __forceinline__ float basket_level(const BasketParams<kMaxD>& c,
                                              const float (&ws)[kMaxD], OnAsset on_asset) {
  float b = 0.0f;
#pragma unroll (BasketUnroll<kMaxD>::value)
  for (int i = 0; i < basket_bound<kMaxD>(c.d); ++i) {
    if (i < c.d) {
      const float s = __ldg(c.s0s + i) * expf(ws[i]);
      on_asset(i, s);
      const float term = __ldg(c.w + i) * s;
      b = i == 0 ? term : b + term;
    }
  }
  return b;
}

template <int kMaxD>
__device__ __forceinline__ float basket_level(const BasketParams<kMaxD>& c,
                                              const float (&ws)[kMaxD]) {
  return basket_level(c, ws, [](int, float) {});
}

// The family NMC's sweep on L legs at once (basket_mix and basket_level in
// their order, each leg's arithmetic as one path's): the Cholesky rows, the
// drifts, s0s and weights read once for the L legs, through plain loads (the
// sweep's pack may lie in shared memory).
template <int kMaxD, int L>
__device__ __forceinline__ void basket_mix_legs(const BasketParams<kMaxD>& c,
                                                const float (&z)[L][kMaxD],
                                                float (&ws)[L][kMaxD]) {
#pragma unroll (BasketUnroll<kMaxD>::value)
  for (int i = 0; i < basket_bound<kMaxD>(c.d); ++i) {
    if (i < c.d) {
      const float* row = c.chol + i * (i + 1) / 2;
      const float r0 = row[0];
      float y[L];
#pragma unroll
      for (int l = 0; l < L; ++l) y[l] = r0 * z[l][0];
#pragma unroll (BasketUnroll<kMaxD>::value)
      for (int k = 1; k < basket_bound<kMaxD>(i + 1); ++k) {
        if (k <= i) {
          const float rk = row[k];
#pragma unroll
          for (int l = 0; l < L; ++l) y[l] = y[l] + rk * z[l][k];
        }
      }
      const float drift = c.drift[i];
#pragma unroll
      for (int l = 0; l < L; ++l) ws[l][i] = (ws[l][i] + drift) + c.sqrt_dt * y[l];
    }
  }
}

template <int kMaxD, int L>
__device__ __forceinline__ void basket_levels(const BasketParams<kMaxD>& c,
                                              const float (&ws)[L][kMaxD], float (&b)[L]) {
#pragma unroll (BasketUnroll<kMaxD>::value)
  for (int i = 0; i < basket_bound<kMaxD>(c.d); ++i) {
    if (i < c.d) {
      const float s0 = c.s0s[i], wi = c.w[i];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float term = wi * (s0 * expf(ws[l][i]));
        b[l] = i == 0 ? term : b[l] + term;
      }
    }
  }
}

// The basket for the family NMC engine (mc_tpu/nmc_basket.py:44-245): the
// d asset price grids (S_1..S_d), extras i[0] = d.  The outer step j draws
// its pairs j*npps + q (its draw unit); the carry holds the level b the step fed the payoff,
// which the outer payoff reads.  The inner leg resumes each asset from w_i =
// logf(S_i / s0_i), substep u drawing pairs c_base + u*npps + q, and pays on
// the level of its last substep (at the last row on the level of the
// resumed w).  Discounted at e^{-rT}.
template <int kMaxD>
struct BasketFamily {
  using Params = BasketParams<kMaxD>;
  static constexpr int kGrids = kMaxD;
  // capacity 32 keeps one leg a thread: its arrays live in local memory
  static constexpr int kLegs = kMaxD <= 8 ? family_legs(2) : 1;
  // step j's normals z_0 .. z_{2 npps - 1} (basket_draw's), of which the mix
  // reads d
  using OuterDraw = DrawWords<kMaxD>;
  static constexpr int kStepsPerDraw = 1;
  // capacity 32's step is its mix, no draw to hide: it never splits
  static constexpr int kTrajSplitBlocks = kMaxD <= 8 ? 2 : 0;

  template <class Payoff>
  struct Carry {
    float ws[kMaxD], lv[kMaxD];  // log-moneyness, the asset prices
    float b;
    typename Payoff::State st;
  };

  __device__ static Params load(const float* __restrict__ params, const FamilyExtras& ex, int) {
    return load_basket<kMaxD>(params, ex.i[0]);
  }
  __device__ static const mc::Params& payoff_params(const Params& c) { return c.pay; }
  __device__ static int grid_count(const Params& c) { return c.d; }

  template <class Payoff>
  __device__ static Carry<Payoff> outer_init(const Params& c) {
    Carry<Payoff> o;
#pragma unroll (BasketUnroll<kMaxD>::value)
    for (int i = 0; i < kMaxD; ++i) {
      o.ws[i] = 0.0f;
      o.lv[i] = 0.0f;
    }
    o.b = basket_level(c, o.ws, [&](int i, float s) { o.lv[i] = s; });
    o.st = Payoff::init(c.pay);
    return o;
  }
  __device__ static int draw_words(const Params& c) { return 2 * c.npps; }
  __device__ static void outer_draw(const Params& c, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t u, OuterDraw& d) {
    basket_draw(c, k0, k1, id, u * static_cast<uint32_t>(c.npps), 1.0f, d.w);
  }
  template <class Payoff>
  __device__ static void outer_advance(const Params& c, int, const OuterDraw& d,
                                       Carry<Payoff>& o) {
    basket_mix(c, d.w, o.ws);
    o.b = basket_level(c, o.ws, [&](int i, float s) { o.lv[i] = s; });
    o.st = Payoff::update(o.st, o.b, c.pay);
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
    // every slot (the kernels store the first d): a copy the compiler
    // keeps to the slots that are read
#pragma unroll (BasketUnroll<kMaxD>::value)
    for (int i = 0; i < kMaxD; ++i) g[i] = o.lv[i];
  }
  template <class Payoff>
  __device__ static float outer_pay(const Params& c, const Carry<Payoff>& o) {
    return Payoff::terminal(o.st, o.b, c.pay);
  }
  // kLegs legs, each asset resumed from w_i = logf(S_i / s0_i); P is the
  // basket's or the rainbow's parameters, whose basket_levels sums or folds.
  template <class Payoff, class P>
  __device__ static void inner_legs(const P& c, uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t c_base, uint32_t stride, int remaining,
                                    const float (&g)[kGrids],
                                    const typename Payoff::State& st0, float (&pay)[kLegs]) {
    float ws[kLegs][kMaxD], z[kLegs][kMaxD], b[kLegs];
#pragma unroll (BasketUnroll<kMaxD>::value)
    for (int i = 0; i < basket_bound<kMaxD>(c.d); ++i) {
      if (i < c.d) {
        const float w0 = logf(g[i] / c.s0s[i]);
#pragma unroll
        for (int l = 0; l < kLegs; ++l) ws[l][i] = w0;
      }
    }
    if (remaining == 0) {
      basket_levels(c, ws, b);
#pragma unroll
      for (int l = 0; l < kLegs; ++l) pay[l] = Payoff::terminal(st0, b[l], c.pay);
      return;
    }
    typename Payoff::State st[kLegs];
#pragma unroll
    for (int l = 0; l < kLegs; ++l) st[l] = st0;
    for (int u = 0; u < remaining; ++u) {
#pragma unroll
      for (int l = 0; l < kLegs; ++l) {
        basket_draw(c, k0, k1, id,
                    c_base + l * stride +
                        static_cast<uint32_t>(u) * static_cast<uint32_t>(c.npps),
                    1.0f, z[l]);
      }
      basket_mix_legs(c, z, ws);
      basket_levels(c, ws, b);
#pragma unroll
      for (int l = 0; l < kLegs; ++l) st[l] = Payoff::update(st[l], b[l], c.pay);
    }
#pragma unroll
    for (int l = 0; l < kLegs; ++l) pay[l] = Payoff::terminal(st[l], b[l], c.pay);
  }
  __device__ static float point_scale(const Params& c, const float (&)[kGrids]) {
    return expf(-c.pay.r * c.pay.t);  // the full e^{-rT}
  }
  __device__ static uint32_t counter_stride(const Params& c, int n_steps) {
    return static_cast<uint32_t>(n_steps) * static_cast<uint32_t>(c.npps);
  }
};

// The rainbow for the family NMC engine (mc_tpu/nmc_rainbow.py:54-72): the
// basket's physics, grids and counters, with the level the payoff reads
// folded from the asset prices S_i = s0_i * expf(w_i) by max (extras i[1] =
// 0) or min (1) in asset order, where the basket takes the weighted sum.
// The fold is a runtime value, the same for every thread, so one
// instantiation per capacity, payoff and kernel serves both.
template <int kMaxD>
struct RainbowParams : BasketParams<kMaxD> {
  int fold_min;
};

template <int kMaxD, class OnAsset>
__device__ __forceinline__ float rainbow_level(const RainbowParams<kMaxD>& c,
                                               const float (&ws)[kMaxD], OnAsset on_asset) {
  float m = 0.0f;
#pragma unroll (BasketUnroll<kMaxD>::value)
  for (int i = 0; i < basket_bound<kMaxD>(c.d); ++i) {
    if (i < c.d) {
      const float s = __ldg(c.s0s + i) * expf(ws[i]);
      on_asset(i, s);
      m = i == 0 ? s : (c.fold_min ? fminf(m, s) : fmaxf(m, s));
    }
  }
  return m;
}

template <int kMaxD>
__device__ __forceinline__ float rainbow_level(const RainbowParams<kMaxD>& c,
                                               const float (&ws)[kMaxD]) {
  return rainbow_level(c, ws, [](int, float) {});
}

// basket_levels' rainbow twin: the fold of the L legs' asset prices.
template <int kMaxD, int L>
__device__ __forceinline__ void basket_levels(const RainbowParams<kMaxD>& c,
                                              const float (&ws)[L][kMaxD], float (&b)[L]) {
#pragma unroll (BasketUnroll<kMaxD>::value)
  for (int i = 0; i < basket_bound<kMaxD>(c.d); ++i) {
    if (i < c.d) {
      const float s0 = c.s0s[i];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float s = s0 * expf(ws[l][i]);
        b[l] = i == 0 ? s : (c.fold_min ? fminf(b[l], s) : fmaxf(b[l], s));
      }
    }
  }
}

template <int kMaxD>
struct RainbowFamily : BasketFamily<kMaxD> {
  using Base = BasketFamily<kMaxD>;
  using Params = RainbowParams<kMaxD>;
  template <class Payoff>
  using Carry = typename Base::template Carry<Payoff>;

  __device__ static Params load(const float* __restrict__ params, const FamilyExtras& ex, int) {
    Params c;
    static_cast<BasketParams<kMaxD>&>(c) = load_basket<kMaxD>(params, ex.i[0]);
    c.fold_min = ex.i[1];
    return c;
  }

  template <class Payoff>
  __device__ static Carry<Payoff> outer_init(const Params& c) {
    Carry<Payoff> o;
#pragma unroll (BasketUnroll<kMaxD>::value)
    for (int i = 0; i < kMaxD; ++i) {
      o.ws[i] = 0.0f;
      o.lv[i] = 0.0f;
    }
    o.b = rainbow_level(c, o.ws, [&](int i, float s) { o.lv[i] = s; });
    o.st = Payoff::init(c.pay);
    return o;
  }
  // the basket's draw (outer_draw, draw_words), the level folded
  template <class Payoff>
  __device__ static void outer_advance(const Params& c, int, const typename Base::OuterDraw& d,
                                       Carry<Payoff>& o) {
    basket_mix(c, d.w, o.ws);
    o.b = rainbow_level(c, o.ws, [&](int i, float s) { o.lv[i] = s; });
    o.st = Payoff::update(o.st, o.b, c.pay);
  }
  template <class Payoff>
  __device__ static void outer_step(const Params& c, uint32_t k0, uint32_t k1, uint32_t id,
                                    int j, Carry<Payoff>& o) {
    typename Base::OuterDraw d;
    Base::outer_draw(c, k0, k1, id, static_cast<uint32_t>(j), d);
    outer_advance<Payoff>(c, j, d, o);
  }
};

// The basket's leg on a randomized-QMC draw (qmc_model.cuh, #33): step j's
// d normals from pairs j*ceil(d/2) + q (the last pair's second normal
// unused at an odd d), mixed and summed as on the MC stream; extra is d.
// kShifts legs in lockstep at capacity 8; capacity 32 runs one (its arrays
// live in local memory already).
template <int kMaxD>
struct BasketQmcLeg {
  using Params = BasketParams<kMaxD>;
  static constexpr int kShifts = kMaxD <= 8 ? qmc_shifts(2) : 1;
  __device__ static Params load(const float* __restrict__ params, int, int d) {
    return load_basket<kMaxD>(params, d);
  }
  template <class Payoff, class Draw>
  __device__ static void pay(const Params& c, int n_steps, const Draw& draw,
                             float (&pay)[kShifts]) {
    constexpr int K = kShifts;
    float ws[K][kMaxD], z[K][kMaxD], b[K];
    typename Payoff::State st[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll (BasketUnroll<kMaxD>::value)
      for (int i = 0; i < kMaxD; ++i) ws[k][i] = 0.0f;
      st[k] = Payoff::init(c.pay);
      b[k] = c.pay.s0;
    }
    for (int j = 0; j < n_steps; ++j) {
#pragma unroll (BasketUnroll<kMaxD>::value)
      for (int q = 0; q < basket_bound<kMaxD / 2>(c.npps); ++q) {
        if (q < c.npps) {
          float z0[K], z1[K];
          draw.pair(j * c.npps + q, z0, z1);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            z[k][2 * q] = z0[k];
            z[k][2 * q + 1] = z1[k];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        basket_mix(c, z[k], ws[k]);
        b[k] = basket_level(c, ws[k]);
        st[k] = Payoff::update(st[k], b[k], c.pay);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) pay[k] = Payoff::terminal(st[k], b[k], c.pay);
  }
};

}  // namespace mc
