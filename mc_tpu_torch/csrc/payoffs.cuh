// Packed option parameters and the payoff functors the kernels template on.
//
// Params is the layout of ops/path_kernels.py PARAM_FIELDS (15 f32): the
// analogue of the reference's __constant__ OptionData (trajectories.cuh:12).
// Each payoff mirrors its plain PyTorch version in ops/payoffs.py: one f32
// state word (the bullet's step count; unused by the vanillas), updated
// after every step and read at maturity.
#pragma once

namespace mc {

struct Params {
  float s0, k, r, sigma, barrier, p1, p2, t, q;
  float dt, drift_dt, vol_dt, drift_t, vol_t, inv_n_steps;
};
static_assert(sizeof(Params) == 15 * sizeof(float), "Params must match PARAM_FIELDS");

__device__ __forceinline__ Params load_params(const float* __restrict__ v) {
  Params p;
  p.s0 = v[0]; p.k = v[1]; p.r = v[2]; p.sigma = v[3]; p.barrier = v[4];
  p.p1 = v[5]; p.p2 = v[6]; p.t = v[7]; p.q = v[8]; p.dt = v[9];
  p.drift_dt = v[10]; p.vol_dt = v[11]; p.drift_t = v[12]; p.vol_t = v[13];
  p.inv_n_steps = v[14];
  return p;
}

// Payoff ids shared with ops/payoffs.py (PathPayoff.cuda_id).
enum PayoffId { PAYOFF_VANILLA_CALL = 0, PAYOFF_VANILLA_PUT = 1, PAYOFF_BULLET_CALL = 2 };

struct VanillaCall {  // max(S_T - K, 0) — trajectories.cuh:76
  __device__ static float init() { return 0.0f; }
  __device__ static float update(float st, float, const Params&) { return st; }
  __device__ static float terminal(float, float s, const Params& p) {
    return fmaxf(s - p.k, 0.0f);
  }
};

struct VanillaPut {
  __device__ static float init() { return 0.0f; }
  __device__ static float update(float st, float, const Params&) { return st; }
  __device__ static float terminal(float, float s, const Params& p) {
    return fmaxf(p.k - s, 0.0f);
  }
};

// Barrier-window call (trajectories.cuh:144-153): count the steps with
// S < B in f32; pay max(S_T - K, 0) iff P1 <= count <= P2.
struct BulletCall {
  __device__ static float init() { return 0.0f; }
  __device__ static float update(float count, float s, const Params& p) {
    return count + (s < p.barrier ? 1.0f : 0.0f);
  }
  __device__ static float terminal(float count, float s, const Params& p) {
    return (count >= p.p1 && count <= p.p2) ? fmaxf(s - p.k, 0.0f) : 0.0f;
  }
};

}  // namespace mc
