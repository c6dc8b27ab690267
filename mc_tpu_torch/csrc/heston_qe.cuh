// The QE legs of the Heston and Bates partials kernels (#12's
// heston_qe_kernel, heston_qe_kernels.cu; #16's bates_qe_kernel,
// bates_qe_kernels.cu): a step of one path's legs in lockstep (the path,
// and its antithetic twin where the kernel is the antithetic one) on the
// branch-split QE step of heston.cuh, and the payoff state a leg keeps.
//
// The uniform of the exponential sampler is drawn only where a leg takes
// that sampler (psi > 1.5 or NaN): once for the path, the twin reading 1 - u,
// as the plain version's twin does.  Under the demo dynamics (xi 0.3, kappa
// 2, theta 0.04) psi never exceeds psi(0) = xi^2 / (2 kappa theta) = 0.5625,
// so no step of the main shape draws it.
//
// The spot S = base * expf(w) is formed only where the payoff reads it
// (StateRead, barrier.cuh): at each step for a kSpot payoff; for a kBarrier
// payoff the test S < barrier is w <= below_max_all(base, barrier), found
// once a block, where base is not below 0 (else S at each step, as the
// book does); once, at the end, for the others.  expf keeps the order of
// the floats (mc_nmc_libm_check, chip_smoke.py phase 2), so the test is the
// plain version's bit for bit.
#pragma once

#include <cstdint>

#include "barrier.cuh"
#include "heston.cuh"
#include "payoffs.cuh"

namespace mc {

// One QE step of L legs from their normals (z_v, z_s); draw_u() gives the
// path's uniform, called only where some leg takes the exponential sampler.
template <int L, class DrawU>
__device__ __forceinline__ void qe_legs_step(const HestonParams& h, const QeConsts& c,
                                             const float (&z_v)[L], const float (&z_s)[L],
                                             DrawU draw_u, float (&w)[L], float (&v)[L]) {
  QeMoments q[L];
  bool exponential = false;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    q[l] = qe_moments(h, c, v[l]);
    exponential = exponential || !qe_quadratic(q[l]);
  }
  float u = 0.0f;
  if (exponential) u = draw_u();
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float v_next, k0_eff;
    if (qe_quadratic(q[l])) {
      qe_quadratic_step(c, q[l], v[l], z_v[l], v_next, k0_eff);
    } else {
      qe_exponential_step(c, q[l], v[l], l == 0 ? u : 1.0f - u, v_next, k0_eff);
    }
    qe_advance(c, v[l], v_next, k0_eff, z_s[l], w[l]);
    v[l] = v_next;
  }
}

// The kBarrier legs' threshold: below_max_all(s0, barrier), by thread 0
// once a block (a block-wide barrier: every thread calls it), and whether
// it is exact (by_w: s0 not below 0).  Other payoffs: none.
template <class Payoff>
__device__ __forceinline__ float qe_below_max(const Params& p, bool& by_w) {
  by_w = !(p.s0 < 0.0f);
  if constexpr (kStateRead<Payoff> == StateRead::kBarrier) {
    __shared__ float below_max_s;
    if (threadIdx.x == 0) below_max_s = below_max_all(p.s0, p.barrier);
    __syncthreads();
    return below_max_s;
  }
  return 0.0f;
}

// A leg's payoff state after its step moved w (from base).
template <class Payoff>
__device__ __forceinline__ void qe_leg_state(const Params& p, float base, float below_max,
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
// did not form it (none formed it at 0 steps: S is base).
template <class Payoff>
__device__ __forceinline__ void qe_leg_end(float base, int n_steps, float w, float& s) {
  if constexpr (kStateRead<Payoff> != StateRead::kSpot) {
    if (n_steps > 0) s = base * expf(w);
  }
}

}  // namespace mc
