// The simulate kernel (#2) of the port, for sm_90a: its template, its
// legs and its launch, instantiated per threefry round count in
// simulate_kernels.cu (13, with the entry points) and simulate20_kernels.cu
// (20), two sources that compile side by side.
//
// simulate_kernel replaces mc_tpu/ops/path_kernels.py simulate_partials (the
// Pallas call at :450; its leg _simulate_leg at :203), for all 18 payoffs:
// the exact terminal draw (the six terminal-only payoffs) or the log-Euler
// step loop (w += drift_dt + vol_dt*z), one threefry pair per two steps; the
// antithetic leg and the control-variate moments in the same pass; the
// control is Payoff::control (S_T unless the payoff has its own, mc_tpu
// :285).  Resume: each path may start from its own s_init and payoff state
// at step start_step, the state a (kStates, n_paths) block, word q of path i
// at q*n_paths + i (an odd start first takes the tail half of its pair);
// null pointers mean "from p.s0 and Payoff::init".  Importance sampling:
// is_shift moves each draw (by is_shift on the terminal draw, by theta =
// is_shift/sqrt(n_steps) per Euler step) and pay and x carry the likelihood
// ratio; the antithetic leg negates the draw before the shift.  Paths at or
// past `bound` add zeros; each block writes one row of f64 moments, 2 (or 5
// with the control variate), no float atomics.
//
// Each path's moments are the kernel's it replaced bit for bit (that
// kernel took every mode as a runtime flag, formed S = base * expf(w) at
// every step, held the twin in a branch of its step loop and five f64
// accumulators and a five-row block tree at every launch; the same partials
// on the H100, family_nmc_probe.py --gbm):
// - the Euler leg and the terminal draw, the plain and the antithetic path,
//   and the two moment counts are kernels apart (template parameters), the
//   twin a second lockstep leg on the negated draw; the accumulators and the
//   block tree hold the launch's moments; the six terminal-only payoffs
//   share each mode's kernel (TerminalOnly);
// - S is formed only where the payoff reads it (barrier.cuh): at each step
//   for a payoff whose update reads S (the Asian, the lookback, the
//   down-and-out call, the multi-word payoffs); for the bullet, the
//   up-and-out and the down-and-in calls, whose update reads S only through
//   S < B, the test is w <= below_max_all(base, B): found once a block for
//   base = s0, once a path for a resumed path's own base (34 expf in place
//   of an expf at each remaining step; S at each step where base is below
//   0); once, at maturity, for the terminal-only payoffs.
// The leg keeps euler_step's association and for_each_draw's schedule
// (payoffs.cuh), and the finish is path_payoff: the ladder, the book, the
// trajectories and the greek kernel, which share them, keep theirs.
//
// One thread steps a path: 2 and 4 threads a path (each lane drawing every
// L-th pair, the normals passed round by __shfl_sync, every lane stepping
// the path) ran 1.8x to 3.4x slower on the H100 at 100,000 and 1M paths,
// where one thread a path already keeps the SMs issuing (PERF.md).
//
// What bounds it on the H100: operations.  A pair of steps spends a
// threefry call (13 or 20 rounds of add, rotate, xor) and its Box-Muller
// pair (log1pf, sqrtf, sincosf); a step 3 f32 operations, and the payoff's
// update (with an expf where it reads S).  The parameters are 60 bytes
// (and 4 bytes per path and state word on resume) and each block writes
// 16 or 40, so bytes do not matter.  Float contraction is off in the build
// (--fmad=false), so each mul and add rounds as in the plain version.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "barrier.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

// Paths a block, one a thread (its grid: ceil(n_paths / kSimulatePaths),
// capped).
constexpr int kSimulatePaths = 256;

// Importance-sampling likelihood ratio dP/dQ of an Euler leg:
// exp(-theta * sum_eps + n theta^2 / 2), sum_eps * vol_dt = w - n * drift_dt.
__device__ __forceinline__ float euler_is_weight(const Params& p, float w, int n_steps,
                                                 float theta) {
  const float n = static_cast<float>(n_steps);
  const float sum_eps = (w - n * p.drift_dt) / p.vol_dt;
  return expf(-theta * sum_eps + 0.5f * n * theta * theta);
}

// A path's log-Euler legs (the path, and its twin where A) from base and
// st0 over [start, n_steps): each draw moves by shift (theta; 0 without
// importance sampling), the twin's negated first; the payoff state kept by
// leg_update (below_max, by_w: the kBarrier legs' threshold), S formed at
// the end where the steps did not form it.
template <class Payoff, bool A, class DrawPair>
__device__ __forceinline__ PathEnd<Payoff> euler_legs(const Params& p, float base,
                                                      float below_max, bool by_w,
                                                      const typename Payoff::State& st0,
                                                      int start, int n_steps, float shift,
                                                      DrawPair draw_pair) {
  const bool shifted = shift != 0.0f;
  PathEnd<Payoff> e{0.0f, base, 0.0f, base, st0, st0};
  for_each_draw(start, n_steps, draw_pair, [&](float z) {
    e.w = e.w + (p.drift_dt + p.vol_dt * (shifted ? z + shift : z));
    leg_update<Payoff>(p, base, below_max, by_w, e.w, e.s, e.st);
    if constexpr (A) {
      e.wn = e.wn + (p.drift_dt + p.vol_dt * (shifted ? -z + shift : -z));
      leg_update<Payoff>(p, base, below_max, by_w, e.wn, e.sn, e.stn);
    }
  });
  leg_end_spot<Payoff>(base, n_steps > start, e.w, e.s);
  if constexpr (A) leg_end_spot<Payoff>(base, n_steps > start, e.wn, e.sn);
  return e;
}

// The six terminal-only payoffs share a kernel a mode: their legs keep no
// state and form S once, at maturity, so only the payoff tells them apart,
// picked at run time once a path (a sixth of their instantiations).  Their
// control is S_T.
struct TerminalOnly : PayoffBase<0> {};

__device__ __forceinline__ float terminal_only(int payoff_id, float s, const Params& p) {
  const Words<0> none{};
  switch (payoff_id) {
#define MC_CASE(ID, PAYOFF) \
  case ID: return PAYOFF::terminal(none, s, p);
    MC_TERMINAL_PAYOFFS(MC_CASE)
#undef MC_CASE
  }
  return 0.0f;  // the entry point takes these six alone
}

// EULER: the log-Euler loop (else the terminal draw, a terminal-only
// payoff's); A: the antithetic twin; N: the moments, 2 or 5 (the control
// variate's).  payoff_id picks TerminalOnly's payoff.
template <class Payoff, int ROUNDS, bool EULER, bool A, int N>
__global__ void __launch_bounds__(kSimulatePaths)
simulate_kernel(int payoff_id, uint32_t k0, uint32_t k1, const float* __restrict__ params,
                int n_steps,
                int start_step, float is_shift, uint32_t n_paths, uint32_t path_offset,
                uint32_t bound, const float* __restrict__ s_init,
                const float* __restrict__ state_init, double* __restrict__ partials) {
  static_assert(N == 2 || N == kMaxMoments, "the moments: 2, or 5 with the control");
  const Params p = load_params(params);
  const bool shifted = is_shift != 0.0f;
  const float theta = is_shift / static_cast<float>(sqrt(static_cast<double>(n_steps)));
  // The kBarrier legs' threshold: the block's for base = s0; a resumed
  // path's own below.
  bool by_w = false;
  float below_max = 0.0f;
  if (EULER && !s_init) below_max = block_below_max<Payoff>(p, by_w);
  double acc[N];
#pragma unroll
  for (int m = 0; m < N; ++m) acc[m] = 0.0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kSimulatePaths;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kSimulatePaths + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float base = s_init ? s_init[i] : p.s0;
    typename Payoff::State st0 = Payoff::init(p);
    if (state_init) {
#pragma unroll
      for (int q = 0; q < Payoff::kStates; ++q) {
        st0.w[q] = state_init[static_cast<uint64_t>(q) * n_paths + i];
      }
    }
    auto draw_pair = [&](int m, float& z0, float& z1) {
      normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
    };
    PathEnd<Payoff> e;
    if constexpr (EULER) {
      if constexpr (kStateRead<Payoff> == StateRead::kBarrier) {
        if (s_init) {
          by_w = !(base < 0.0f);
          below_max = by_w ? below_max_all(base, p.barrier) : 0.0f;
        }
      }
      e = euler_legs<Payoff, A>(p, base, below_max, by_w, st0, start_step, n_steps, theta,
                                draw_pair);
    } else {
      e = simulate_path<Payoff>(p, false, A, base, st0, start_step, n_steps, is_shift,
                                draw_pair);
    }
    // Under IS pay and x carry each leg's likelihood ratio dP/dQ: at the
    // terminal draw exp(-shift*eps + shift^2/2); 1 when unshifted (exact).
    auto weight = [&](float w_l) {
      if (!shifted) return 1.0f;
      return EULER ? euler_is_weight(p, w_l, n_steps, theta)
                   : expf(-is_shift * w_l + 0.5f * is_shift * is_shift);
    };
    float pay, x;  // x: the control variate X (pair mean if antithetic)
    if constexpr (std::is_same_v<Payoff, TerminalOnly>) {  // path_payoff's arithmetic
      const float wt = weight(e.w);
      pay = terminal_only(payoff_id, e.s, p) * wt;
      x = e.s * wt;
      if constexpr (A) {
        const float wt_n = weight(e.wn);
        pay = 0.5f * (pay + terminal_only(payoff_id, e.sn, p) * wt_n);
        x = 0.5f * (x + e.sn * wt_n);
      }
    } else {
      path_payoff<Payoff>(p, e, A, weight(e.w), A ? weight(e.wn) : 1.0f, pay, x);
    }
    add_moments(acc, pay, x, id < bound, N == kMaxMoments);
  }
  // The 2-moment rows' tree unrolled ran 2-4% faster on the H100; the 5
  // moments' unrolled spilled and ran 3% slower, so they keep the loop.
  double* row = partials + N * static_cast<size_t>(blockIdx.x);
  if constexpr (N == 2) {
    block_store_moments_unrolled<N, kSimulatePaths>(acc, row);
  } else {
    block_store_moments<N, kSimulatePaths>(acc, row, N);
  }
}

// f(kernel) for the instantiation that runs a launch's modes (payoff,
// euler, antithetic, with_cv) at ROUNDS.  The terminal draw exists for the
// terminal-only payoffs alone.
template <class Payoff, int ROUNDS, bool EULER, class F>
cudaError_t with_simulate_modes(int antithetic, int with_cv, F f) {
  if (antithetic) {
    return with_cv ? f(simulate_kernel<Payoff, ROUNDS, EULER, true, kMaxMoments>)
                   : f(simulate_kernel<Payoff, ROUNDS, EULER, true, 2>);
  }
  return with_cv ? f(simulate_kernel<Payoff, ROUNDS, EULER, false, kMaxMoments>)
                 : f(simulate_kernel<Payoff, ROUNDS, EULER, false, 2>);
}

template <class Payoff, int ROUNDS, class F>
cudaError_t with_payoff_kernel(int euler, int antithetic, int with_cv, F f) {
  if constexpr (Payoff::kStates == 0) {
    return euler ? with_simulate_modes<TerminalOnly, ROUNDS, true>(antithetic, with_cv, f)
                 : with_simulate_modes<TerminalOnly, ROUNDS, false>(antithetic, with_cv, f);
  } else {
    if (euler) return with_simulate_modes<Payoff, ROUNDS, true>(antithetic, with_cv, f);
    return cudaErrorInvalidValue;
  }
}

template <int ROUNDS, class F>
cudaError_t with_simulate_kernel(int payoff_id, int euler, int antithetic, int with_cv, F f) {
#define MC_CASE(ID, PAYOFF) \
  case ID: return with_payoff_kernel<PAYOFF, ROUNDS>(euler, antithetic, with_cv, f);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

template <int ROUNDS>
cudaError_t launch_simulate(int payoff_id, int euler, int antithetic, int with_cv,
                            uint32_t k0, uint32_t k1, const float* params, int n_steps,
                            int start_step, float is_shift, uint32_t n_paths,
                            uint32_t path_offset, uint32_t bound, const float* s_init,
                            const float* state_init, double* partials, int n_blocks,
                            cudaStream_t stream) {
  return with_simulate_kernel<ROUNDS>(
      payoff_id, euler, antithetic, with_cv, [&](auto kernel) {
        kernel<<<n_blocks, kSimulatePaths, 0, stream>>>(payoff_id, k0, k1, params, n_steps,
                                                        start_step, is_shift, n_paths,
                                                        path_offset, bound, s_init,
                                                        state_init, partials);
        return cudaGetLastError();
      });
}

// The threefry-20 instantiations' launch (simulate20_kernels.cu).
cudaError_t launch_simulate20(int payoff_id, int euler, int antithetic, int with_cv,
                              uint32_t k0, uint32_t k1, const float* params, int n_steps,
                              int start_step, float is_shift, uint32_t n_paths,
                              uint32_t path_offset, uint32_t bound, const float* s_init,
                              const float* state_init, double* partials, int n_blocks,
                              cudaStream_t stream);

}  // namespace mc
