// The cash-dividend family on the device: its packed head and amounts and
// the level-space step, the twins of mc_tpu_torch/models/dividends.py (and
// of mc_tpu/models/dividends.py:48-101) operation for operation, in the
// same association.  The build passes --fmad=false, so each mul and add
// rounds as it does in the plain PyTorch version.
//
// The packed vector is 13 + n_steps f32:
//   [s0, k, r, barrier, p1, p2, t, q, sigma, dt, inv_n_steps, drift_dt,
//    vol_dt, D_0, ..., D_{n_steps-1}]
// The payoffs' Params take the head (sigma for the Brownian-bridge
// barriers); drift_t and vol_t, which no step here reads, are NaN.  The
// partials kernel reads the amounts once a block, into its payment table
// (divs_kernels.cu).
#pragma once

#include "payoffs.cuh"

namespace mc {

constexpr int kDivsHead = 13;

struct DivsParams {
  Params pay;       // the payoff's view of the contract
  const float* d;   // the per-step cash amounts
};

__device__ __forceinline__ DivsParams load_divs(const float* __restrict__ v) {
  const float nan = __int_as_float(0x7fc00000);
  DivsParams c;
  c.pay.s0 = v[0]; c.pay.k = v[1]; c.pay.r = v[2]; c.pay.barrier = v[3];
  c.pay.p1 = v[4]; c.pay.p2 = v[5]; c.pay.t = v[6]; c.pay.q = v[7];
  c.pay.sigma = v[8]; c.pay.dt = v[9]; c.pay.inv_n_steps = v[10];
  c.pay.drift_dt = v[11]; c.pay.vol_dt = v[12];
  c.pay.drift_t = nan; c.pay.vol_t = nan;
  c.d = v + kDivsHead;
  return c;
}

// One level-space step of L legs: S = S*exp(drift_dt + vol_dt*z), then the
// cash drop S = max(S - D_j, 1e-6) right after the move (the floor absorbs a
// payment larger than the spot), the payoff state updated on the
// post-dividend S.  At a step that pays no amount (`pays` false: D_j is +0
// or -0) the drop is the floor alone, max(S, 1e-6): max(S - (+-0), 1e-6) is
// that bit for bit for every S (S - (+0) is S; S - (-0) is S + 0, which only
// turns -0 into +0, and both floor to 1e-6).
template <class Payoff, int L>
__device__ __forceinline__ void divs_step(const DivsParams& c, bool pays, float dj,
                                          const float (&z)[L], float (&s)[L],
                                          typename Payoff::State (&st)[L]) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float x = s[l] * expf(c.pay.drift_dt + c.pay.vol_dt * z[l]);
    if (pays) x = x - dj;
    s[l] = fmaxf(x, 1e-6f);
    st[l] = Payoff::update(st[l], s[l], c.pay);
  }
}

}  // namespace mc
