// Packed option parameters, the payoff functors the kernels template on, and
// the log-Euler step and draw schedule every GBM kernel takes.
//
// Params is the layout of ops/path_kernels.py PARAM_FIELDS (15 f32): the
// analogue of the reference's __constant__ OptionData (trajectories.cuh:12).
// Each payoff mirrors its plain PyTorch version in ops/payoffs.py operation
// for operation (same operands, same association: the build passes
// --fmad=false, so each mul and add rounds as it does there).  A payoff is a
// struct with
//   kStates                      its number of f32 state words (0 to 3),
//   State                        those words (Words<kStates>),
//   init(p)                      the state before the first step,
//   update(st, s, p)             the state after a step that ends at s,
//   terminal(st, s, p)           the payoff at maturity,
//   control(st, s, p)            the control variate (s unless the payoff
//                                has its own);
// and the five payoffs greeks(method="pathwise") admits (vanilla call and
// put, best-of-cash, Asian, lookback) carry their forward-mode derivative,
// what jax.jvp computes in mc_tpu's greek kernel (ops/path_kernels.py:
// 843-891), written out by hand:
//   update_tangent(st, dst, s, ds, p)    the tangent of update at (st, s)
//                                        along (dst, ds) (identity for a
//                                        stateless payoff),
//   terminal_tangent(st, dst, s, ds, p)  the tangent of terminal.
// Kernels that keep one state word per path (trajectories, NMC) read and
// write word 0, as mc_tpu stores state[0].
#pragma once

namespace mc {

struct Params {
  float s0, k, r, sigma, barrier, p1, p2, t, q;
  float dt, drift_dt, vol_dt, drift_t, vol_t, inv_n_steps;
};
constexpr int kParamFields = 15;
static_assert(sizeof(Params) == kParamFields * sizeof(float),
              "Params must match PARAM_FIELDS");

__device__ __forceinline__ Params load_params(const float* __restrict__ v) {
  Params p;
  p.s0 = v[0]; p.k = v[1]; p.r = v[2]; p.sigma = v[3]; p.barrier = v[4];
  p.p1 = v[5]; p.p2 = v[6]; p.t = v[7]; p.q = v[8]; p.dt = v[9];
  p.drift_dt = v[10]; p.vol_dt = v[11]; p.drift_t = v[12]; p.vol_t = v[13];
  p.inv_n_steps = v[14];
  return p;
}

// Payoff ids shared with ops/payoffs.py (PathPayoff.cuda_id).
enum PayoffId {
  PAYOFF_VANILLA_CALL = 0, PAYOFF_VANILLA_PUT = 1, PAYOFF_BULLET_CALL = 2,
  PAYOFF_DIGITAL_CALL = 3, PAYOFF_DIGITAL_PUT = 4, PAYOFF_BEST_OF_CASH = 5,
  PAYOFF_ZCB = 6, PAYOFF_ASIAN_CALL = 7, PAYOFF_UP_OUT_CALL = 8,
  PAYOFF_DOWN_OUT_CALL = 9, PAYOFF_DOWN_IN_CALL = 10, PAYOFF_LOOKBACK_CALL = 11,
  PAYOFF_UP_OUT_CALL_BB = 12, PAYOFF_DOWN_OUT_CALL_BB = 13,
  PAYOFF_VARIANCE_SWAP = 14, PAYOFF_FORWARD_START_CALL = 15, PAYOFF_CLIQUET = 16,
  PAYOFF_ASIAN_CALL_GEO_CV = 17
};

// A payoff's state words; a stateless payoff keeps one unused slot, which the
// compiler drops.
template <int N>
struct Words {
  float w[N > 0 ? N : 1];
};

template <int N>
struct PayoffBase {
  static constexpr int kStates = N;
  using State = Words<N>;
  __device__ static State init(const Params&) {
    State st;
#pragma unroll
    for (int q = 0; q < (N > 0 ? N : 1); ++q) st.w[q] = 0.0f;
    return st;
  }
  __device__ static State update(State st, float, const Params&) { return st; }
  __device__ static float control(const State&, float s, const Params&) { return s; }
  __device__ static State update_tangent(const State&, State dst, float, float,
                                         const Params&) {
    return dst;
  }
};

__device__ __forceinline__ float step01(bool c) { return c ? 1.0f : 0.0f; }

// Tangent of max(a, b) along (da, db): jax.jvp's rule for jnp.maximum (the
// max of mc_tpu's payoffs), the larger operand's tangent, and half of each
// at a tie (torch.maximum's derivative splits it the same way).
__device__ __forceinline__ float max_tangent(float a, float b, float da, float db) {
  return a > b ? da : (b > a ? db : 0.5f * da + 0.5f * db);
}

// --- terminal-only payoffs ---------------------------------------------------

struct VanillaCall : PayoffBase<0> {  // max(S_T - K, 0) — trajectories.cuh:76
  __device__ static float terminal(const State&, float s, const Params& p) {
    return fmaxf(s - p.k, 0.0f);
  }
  __device__ static float terminal_tangent(const State&, const State&, float s, float ds,
                                           const Params& p) {
    return max_tangent(s - p.k, 0.0f, ds, 0.0f);
  }
};

struct VanillaPut : PayoffBase<0> {
  __device__ static float terminal(const State&, float s, const Params& p) {
    return fmaxf(p.k - s, 0.0f);
  }
  __device__ static float terminal_tangent(const State&, const State&, float s, float ds,
                                           const Params& p) {
    return max_tangent(p.k - s, 0.0f, -ds, 0.0f);
  }
};

struct DigitalCall : PayoffBase<0> {  // 1 iff S_T > K
  __device__ static float terminal(const State&, float s, const Params& p) {
    return step01(s > p.k);
  }
};

struct DigitalPut : PayoffBase<0> {  // 1 iff S_T < K
  __device__ static float terminal(const State&, float s, const Params& p) {
    return step01(s < p.k);
  }
};

struct BestOfCash : PayoffBase<0> {  // max(S_T, K)
  __device__ static float terminal(const State&, float s, const Params& p) {
    return fmaxf(s, p.k);
  }
  __device__ static float terminal_tangent(const State&, const State&, float s, float ds,
                                           const Params& p) {
    return max_tangent(s, p.k, ds, 0.0f);
  }
};

struct ZeroCouponBond : PayoffBase<0> {  // 1 at maturity
  __device__ static float terminal(const State&, float, const Params&) { return 1.0f; }
};

// --- one state word ----------------------------------------------------------

// Barrier-window call (trajectories.cuh:144-153): count the steps with
// S < B in f32; pay max(S_T - K, 0) iff P1 <= count <= P2.
//
// This payoff, UpOutCall and DownInCall read the spot in update only
// through S < p.barrier: update_below is the state after a step from that
// test alone (the NMC legs take it from the log-price, nmc_kernels.cu).
struct BulletCall : PayoffBase<1> {
  __device__ static State update_below(State st, bool below, const Params&) {
    st.w[0] = st.w[0] + step01(below);
    return st;
  }
  __device__ static State update(State st, float s, const Params& p) {
    return update_below(st, s < p.barrier, p);
  }
  __device__ static float terminal(const State& st, float s, const Params& p) {
    return (st.w[0] >= p.p1 && st.w[0] <= p.p2) ? fmaxf(s - p.k, 0.0f) : 0.0f;
  }
};

struct AsianCall : PayoffBase<1> {  // word 0: running sum of S
  __device__ static State update(State st, float s, const Params&) {
    st.w[0] = st.w[0] + s;
    return st;
  }
  __device__ static float terminal(const State& st, float, const Params& p) {
    return fmaxf(st.w[0] * p.inv_n_steps - p.k, 0.0f);
  }
  __device__ static State update_tangent(const State&, State dst, float, float ds,
                                         const Params&) {
    dst.w[0] = dst.w[0] + ds;
    return dst;
  }
  __device__ static float terminal_tangent(const State& st, const State& dst, float, float,
                                           const Params& p) {
    return max_tangent(st.w[0] * p.inv_n_steps - p.k, 0.0f, dst.w[0] * p.inv_n_steps, 0.0f);
  }
};

struct UpOutCall : PayoffBase<1> {  // word 0: alive flag
  __device__ static State init(const Params&) { return State{{1.0f}}; }
  __device__ static State update_below(State st, bool below, const Params&) {
    st.w[0] = st.w[0] * step01(below);
    return st;
  }
  __device__ static State update(State st, float s, const Params& p) {
    return update_below(st, s < p.barrier, p);
  }
  __device__ static float terminal(const State& st, float s, const Params& p) {
    return st.w[0] * fmaxf(s - p.k, 0.0f);
  }
};

struct DownOutCall : PayoffBase<1> {  // word 0: alive flag
  __device__ static State init(const Params&) { return State{{1.0f}}; }
  __device__ static State update(State st, float s, const Params& p) {
    st.w[0] = st.w[0] * step01(s >= p.barrier);
    return st;
  }
  __device__ static float terminal(const State& st, float s, const Params& p) {
    return st.w[0] * fmaxf(s - p.k, 0.0f);
  }
};

struct DownInCall : PayoffBase<1> {  // word 0: knocked-in flag
  __device__ static State update_below(State st, bool below, const Params&) {
    st.w[0] = fmaxf(st.w[0], step01(below));
    return st;
  }
  __device__ static State update(State st, float s, const Params& p) {
    return update_below(st, s < p.barrier, p);
  }
  __device__ static float terminal(const State& st, float s, const Params& p) {
    return st.w[0] * fmaxf(s - p.k, 0.0f);
  }
};

// Fixed-strike lookback call.  Word 0, the running max, starts at 0 as in
// mc_tpu (whose init returns its zeros argument), so the max is over
// S_1..S_N.
struct LookbackFixedCall : PayoffBase<1> {
  __device__ static State update(State st, float s, const Params&) {
    st.w[0] = fmaxf(st.w[0], s);
    return st;
  }
  __device__ static float terminal(const State& st, float, const Params& p) {
    return fmaxf(st.w[0] - p.k, 0.0f);
  }
  __device__ static State update_tangent(const State& st, State dst, float s, float ds,
                                         const Params&) {
    dst.w[0] = max_tangent(st.w[0], s, dst.w[0], ds);
    return dst;
  }
  __device__ static float terminal_tangent(const State& st, const State& dst, float, float,
                                           const Params& p) {
    return max_tangent(st.w[0] - p.k, 0.0f, dst.w[0], 0.0f);
  }
};

// --- two or three state words -------------------------------------------------

// surv * P(no crossing of the log-price bridge between two steps), the
// exponent associated left to right as mc_tpu writes it:
// ((-2*a)*b) / ((sigma*sigma)*dt).
__device__ __forceinline__ float bridge_survival(float surv, bool inside, float a, float b,
                                                 const Params& p) {
  const float p_cross = expf(((-2.0f * a) * b) / ((p.sigma * p.sigma) * p.dt));
  return surv * (inside ? 1.0f - p_cross : 0.0f);
}

struct UpOutCallBB : PayoffBase<2> {  // words: prev S, survival weight
  __device__ static State init(const Params& p) { return State{{p.s0, 1.0f}}; }
  __device__ static State update(State st, float s, const Params& p) {
    const float a = logf(p.barrier / st.w[0]);
    const float b = logf(p.barrier / s);
    const bool below = st.w[0] < p.barrier && s < p.barrier;
    return State{{s, bridge_survival(st.w[1], below, a, b, p)}};
  }
  __device__ static float terminal(const State& st, float s, const Params& p) {
    return st.w[1] * fmaxf(s - p.k, 0.0f);
  }
};

struct DownOutCallBB : PayoffBase<2> {  // words: prev S, survival weight
  __device__ static State init(const Params& p) { return State{{p.s0, 1.0f}}; }
  __device__ static State update(State st, float s, const Params& p) {
    const float a = logf(st.w[0] / p.barrier);
    const float b = logf(s / p.barrier);
    const bool above = st.w[0] > p.barrier && s > p.barrier;
    return State{{s, bridge_survival(st.w[1], above, a, b, p)}};
  }
  __device__ static float terminal(const State& st, float s, const Params& p) {
    return st.w[1] * fmaxf(s - p.k, 0.0f);
  }
};

// Realized variance: sum((log S_i/S_{i-1})^2)/T - K, K the variance strike.
struct VarianceSwap : PayoffBase<2> {  // words: prev S, sum of squared log returns
  __device__ static State init(const Params& p) { return State{{p.s0, 0.0f}}; }
  __device__ static State update(State st, float s, const Params&) {
    const float lr = logf(s / st.w[0]);
    return State{{s, st.w[1] + lr * lr}};
  }
  __device__ static float terminal(const State& st, float, const Params& p) {
    return st.w[1] / p.t - p.k;
  }
};

// max(S_T - k*S_{t1}, 0): k a ratio, p1 the step after which the strike fixes.
struct ForwardStartCall : PayoffBase<2> {  // words: step count, S at t1
  __device__ static State init(const Params& p) { return State{{0.0f, p.s0}}; }
  __device__ static State update(State st, float s, const Params& p) {
    const float count = st.w[0] + 1.0f;
    return State{{count, count == p.p1 ? s : st.w[1]}};
  }
  __device__ static float terminal(const State& st, float s, const Params& p) {
    return fmaxf(s - p.k * st.w[1], 0.0f);
  }
};

// Sum of period returns clamped to [p1, p2], reset every k steps.  mc_tpu
// tests count % k == 0 with a floor-mod; fmodf truncates instead, and the
// two agree because count and k are positive.
struct Cliquet : PayoffBase<3> {  // words: step count, S at last reset, acc
  __device__ static State init(const Params& p) { return State{{0.0f, p.s0, 0.0f}}; }
  __device__ static State update(State st, float s, const Params& p) {
    const float count = st.w[0] + 1.0f;
    const bool reset = fmodf(count, p.k) == 0.0f;
    const float ret = fminf(fmaxf(s / st.w[1] - 1.0f, p.p1), p.p2);
    return State{{count, reset ? s : st.w[1], reset ? st.w[2] + ret : st.w[2]}};
  }
  __device__ static float terminal(const State& st, float, const Params&) {
    return st.w[2];
  }
};

// Arithmetic Asian call with the geometric-average call as its control.
struct AsianCallGeoCV : PayoffBase<2> {  // words: sum of S, sum of log S
  __device__ static State update(State st, float s, const Params&) {
    return State{{st.w[0] + s, st.w[1] + logf(s)}};
  }
  __device__ static float terminal(const State& st, float, const Params& p) {
    return fmaxf(st.w[0] * p.inv_n_steps - p.k, 0.0f);
  }
  __device__ static float control(const State& st, float, const Params& p) {
    return fmaxf(expf(st.w[1] * p.inv_n_steps) - p.k, 0.0f);
  }
};

// The id lists of the entry points' switch tables: X(id, functor).
#define MC_TERMINAL_PAYOFFS(X)                                            \
  X(PAYOFF_VANILLA_CALL, VanillaCall) X(PAYOFF_VANILLA_PUT, VanillaPut)   \
  X(PAYOFF_DIGITAL_CALL, DigitalCall) X(PAYOFF_DIGITAL_PUT, DigitalPut)   \
  X(PAYOFF_BEST_OF_CASH, BestOfCash) X(PAYOFF_ZCB, ZeroCouponBond)
// The payoffs with pathwise tangents (greek_kernels.cu).
#define MC_PATHWISE_PAYOFFS(X)                                            \
  X(PAYOFF_VANILLA_CALL, VanillaCall) X(PAYOFF_VANILLA_PUT, VanillaPut)   \
  X(PAYOFF_BEST_OF_CASH, BestOfCash) X(PAYOFF_ASIAN_CALL, AsianCall)      \
  X(PAYOFF_LOOKBACK_CALL, LookbackFixedCall)
#define MC_ONE_WORD_PAYOFFS(X)                                            \
  MC_TERMINAL_PAYOFFS(X)                                                  \
  X(PAYOFF_BULLET_CALL, BulletCall) X(PAYOFF_ASIAN_CALL, AsianCall)       \
  X(PAYOFF_UP_OUT_CALL, UpOutCall) X(PAYOFF_DOWN_OUT_CALL, DownOutCall)   \
  X(PAYOFF_DOWN_IN_CALL, DownInCall) X(PAYOFF_LOOKBACK_CALL, LookbackFixedCall)
#define MC_ALL_PAYOFFS(X)                                                 \
  MC_ONE_WORD_PAYOFFS(X)                                                  \
  X(PAYOFF_UP_OUT_CALL_BB, UpOutCallBB)                                   \
  X(PAYOFF_DOWN_OUT_CALL_BB, DownOutCallBB)                               \
  X(PAYOFF_VARIANCE_SWAP, VarianceSwap)                                   \
  X(PAYOFF_FORWARD_START_CALL, ForwardStartCall)                          \
  X(PAYOFF_CLIQUET, Cliquet) X(PAYOFF_ASIAN_CALL_GEO_CV, AsianCallGeoCV)

// One log-Euler step from the leg's start price `base` (p.s0, or the resume
// price): the step of every GBM kernel, so their paths agree bit for bit.
template <class Payoff>
__device__ __forceinline__ void euler_step(const Params& p, float base, float z,
                                           float& w, float& s,
                                           typename Payoff::State& st) {
  w = w + (p.drift_dt + p.vol_dt * z);
  s = base * expf(w);  // log-space: one exp rounding per S_t
  st = Payoff::update(st, s, p);
}

// The draw schedule of a log-Euler leg over steps [start, n_steps): one
// normal pair per two steps, both halves consumed; an odd resume point first
// takes the tail half of its pair, an odd step count ends with the head half
// of one more pair.  draw_pair(m, z0, z1) yields pair m; step(z) takes a step.
template <class DrawPair, class Step>
__device__ __forceinline__ void for_each_draw(int start, int n_steps, DrawPair draw_pair,
                                              Step step) {
  float z0, z1;
  if (start & 1) {
    draw_pair(start / 2, z0, z1);
    step(z1);
    ++start;
  }
  for (int m = start / 2; m < n_steps / 2; ++m) {
    draw_pair(m, z0, z1);
    step(z0);
    step(z1);
  }
  if (n_steps & 1) {
    draw_pair(n_steps / 2, z0, z1);
    step(z0);
  }
}

// One path at maturity: its leg and, if antithetic, the twin leg (n).  w is
// what the importance-sampling weight reads: the Euler leg's sum of log
// increments, or the terminal leg's (shifted) normal.
template <class Payoff>
struct PathEnd {
  float w, s, wn, sn;
  typename Payoff::State st, stn;
};

// The leg of every kernel that prices at maturity (simulate, ladder, book),
// so that their paths agree bit for bit: from base and st0, the exact
// terminal draw (the head of pair 0) or the log-Euler loop over
// [start, n_steps), draw_pair(m, z0, z1) giving pair m.  Each draw moves by
// shift (the terminal draw's is_shift, or theta per Euler step; 0 without
// importance sampling); the twin negates the draw before the shift.
template <class Payoff, class DrawPair>
__device__ __forceinline__ PathEnd<Payoff> simulate_path(
    const Params& p, bool euler, bool antithetic, float base,
    const typename Payoff::State& st0, int start, int n_steps, float shift,
    DrawPair draw_pair) {
  const bool shifted = shift != 0.0f;
  PathEnd<Payoff> e{0.0f, base, 0.0f, base, st0, st0};
  if (!euler) {
    float z, unused;
    draw_pair(0, z, unused);
    e.w = shifted ? z + shift : z;
    e.s = base * expf(p.drift_t + p.vol_t * e.w);
    if (antithetic) {
      e.wn = shifted ? -z + shift : -z;
      e.sn = base * expf(p.drift_t + p.vol_t * e.wn);
    }
  } else {
    for_each_draw(start, n_steps, draw_pair, [&](float z) {
      euler_step<Payoff>(p, base, shifted ? z + shift : z, e.w, e.s, e.st);
      if (antithetic) euler_step<Payoff>(p, base, shifted ? -z + shift : -z, e.wn, e.sn, e.stn);
    });
  }
  return e;
}

// The path's payoff and control at maturity: each leg's times its weight
// (the importance-sampling likelihood ratio, 1 without it), the pair mean
// if antithetic.
template <class Payoff>
__device__ __forceinline__ void path_payoff(const Params& p, const PathEnd<Payoff>& e,
                                            bool antithetic, float wt, float wt_n,
                                            float& pay, float& x) {
  pay = Payoff::terminal(e.st, e.s, p) * wt;
  x = Payoff::control(e.st, e.s, p) * wt;
  if (antithetic) {
    pay = 0.5f * (pay + Payoff::terminal(e.stn, e.sn, p) * wt_n);
    x = 0.5f * (x + Payoff::control(e.stn, e.sn, p) * wt_n);
  }
}

}  // namespace mc
