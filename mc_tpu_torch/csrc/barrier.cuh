// The spot a leg's payoff reads, and the barrier test on the log-price:
// shared by the GBM nested-MC legs (nmc_kernels.cu, #3 and #5), the book
// (batch_kernels.cu, #7), the SABR partials kernel (sabr_partials.cuh,
// #17), the simulate kernel (simulate.cuh, #2) and the Heston and Bates
// partials kernels (heston_kernels.cu, heston_qe_kernels.cu,
// bates_qe_kernels.cu; #12, #16).
//
// A leg that steps its log-price w from a start price base forms the spot
// S = base * expf(w) only where its payoff reads it (StateRead).  A
// payoff whose update reads S only through S < barrier (update_below)
// tests w against a threshold instead, found once for the leg's (base,
// barrier) by a bisection over the floats' order (below_max_w): expf keeps
// the order of the floats, which mc_nmc_libm_check (nmc_kernels.cu) tests
// on every input on each chip_smoke.py run.
#pragma once

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "payoffs.cuh"

namespace mc {

// How a leg moves its payoff state at a step.  kSpot: update reads the spot
// S = base * expf(w) at each step (the Asian, the lookback, the down-and-out
// call).  kNone: no state words (the terminal-only payoffs), so update reads
// nothing.  kBarrier: update reads S only through S < p.barrier (the payoffs
// with update_below: the bullet, the up-and-out and the down-and-in calls),
// and that test is w <= below_max (below_max_w).  The kNone and kBarrier legs
// form S once, at the leg's end, from the last w: the only S terminal reads.
enum class StateRead { kSpot, kNone, kBarrier };

template <class Payoff, class = void>
struct HasUpdateBelow : std::false_type {};
template <class Payoff>
struct HasUpdateBelow<Payoff, std::void_t<decltype(&Payoff::update_below)>>
    : std::true_type {};

template <class Payoff>
constexpr StateRead kStateRead = Payoff::kStates == 0          ? StateRead::kNone
                                 : HasUpdateBelow<Payoff>::value ? StateRead::kBarrier
                                                                 : StateRead::kSpot;

// A float's place in the order of the floats as a uint32 (-0 just below +0),
// and back.
__device__ __forceinline__ uint32_t float_order(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float order_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// The largest finite w with base * expf(w) < barrier: -inf if there is
// none, +inf if every finite w is.  expf is monotone over the floats
// (mc_nmc_libm_check tests each of them) and so is its product with
// base >= 0, so base * expf(w) < barrier exactly when w <= below_max_w: a
// bisection over the floats' order, 32 expf once per point, in place of an
// expf at each of the point's n_inner * remaining steps.  static: each
// source that includes this header compiles its own copy (with external
// linkage the host stubs nvcc emits for it clash when the library links).
static __device__ float below_max_w(float base, float barrier) {
  auto below = [&](uint32_t k) { return base * expf(order_float(k)) < barrier; };
  uint32_t lo = float_order(-FLT_MAX), hi = float_order(FLT_MAX);
  if (!below(lo)) return -INFINITY;
  if (below(hi)) return INFINITY;
  while (hi - lo > 1) {  // below(lo) and not below(hi)
    const uint32_t mid = lo + (hi - lo) / 2;
    if (below(mid)) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return order_float(lo);
}

// One step of a leg from base: w moves as euler_step moves it; a kSpot leg
// forms S and updates its state from it, a kBarrier leg from w <= below_max.
template <class Payoff>
__device__ __forceinline__ void leg_step(const Params& p, float base, float below_max, float z,
                                         float& w, float& s, typename Payoff::State& st) {
  if constexpr (kStateRead<Payoff> == StateRead::kSpot) {
    euler_step<Payoff>(p, base, z, w, s, st);
  } else {
    w = w + (p.drift_dt + p.vol_dt * z);
    if constexpr (kStateRead<Payoff> == StateRead::kBarrier) {
      st = Payoff::update_below(st, w <= below_max, p);
    }
  }
}

// The threshold of below_max_w made exact for every w, +-inf and NaN among
// them: w <= below_max_all(base, barrier) exactly when base * expf(w) <
// barrier, for base not below 0 (+-0, positive, +inf or NaN: base * expf
// is then below the barrier on a prefix of the order of [-inf, +inf]).
// below_max_w's -inf (no finite w) becomes NaN, which no w is at or below:
// expf(-inf) and expf(-FLT_MAX) are both +0, so w = -inf is below exactly
// when some finite w is; and expf(+inf) and expf(FLT_MAX) are both +inf, so
// w = +inf is below exactly when below_max_w is +inf.  A NaN w is never.
__device__ __forceinline__ float below_max_all(float base, float barrier) {
  const float t = below_max_w(base, barrier);
  return t == -INFINITY ? __int_as_float(0x7fc00000) : t;
}

// The threshold of a kBarrier leg that starts from p.s0, for every leg of
// a block: below_max_all(p.s0, p.barrier), found by thread 0 once a block
// (a block-wide barrier: every thread calls it), and whether the legs test
// w against it (by_w: s0 not below 0; else they form S at each step, as
// the book does).  Other payoffs: none.
template <class Payoff>
__device__ __forceinline__ float block_below_max(const Params& p, bool& by_w) {
  by_w = !(p.s0 < 0.0f);
  if constexpr (kStateRead<Payoff> == StateRead::kBarrier) {
    __shared__ float below_max_s;
    if (threadIdx.x == 0) below_max_s = below_max_all(p.s0, p.barrier);
    __syncthreads();
    return below_max_s;
  }
  return 0.0f;
}

// A leg's payoff state after its step moved w (from base): a kSpot leg
// forms S = base * expf(w) and updates from it; a kBarrier leg updates from
// w <= below_max where by_w (else from S, formed here); a kNone leg has no
// state to move.
template <class Payoff>
__device__ __forceinline__ void leg_update(const Params& p, float base, float below_max,
                                           bool by_w, float w, float& s,
                                           typename Payoff::State& st) {
  if constexpr (kStateRead<Payoff> == StateRead::kSpot) {
    s = base * expf(w);  // log-space: one exp rounding per S_t
    st = Payoff::update(st, s, p);
  } else if constexpr (kStateRead<Payoff> == StateRead::kBarrier) {
    if (by_w) {
      st = Payoff::update_below(st, w <= below_max, p);
    } else {
      s = base * expf(w);
      st = Payoff::update(st, s, p);
    }
  }
}

// The spot terminal reads: S of the last step, formed here where the steps
// did not form it (the leg took no step: S is base).
template <class Payoff>
__device__ __forceinline__ void leg_end_spot(float base, bool stepped, float w, float& s) {
  if constexpr (kStateRead<Payoff> != StateRead::kSpot) {
    if (stepped) s = base * expf(w);
  }
}

}  // namespace mc
