// Path-simulation kernels 1, 2 and 4 of the port, for sm_90a.
//
// terminal_pair_kernel replaces mc_tpu/ops/path_kernels.py
// terminal_pair_partials (the Pallas call at :1031): element e draws one
// threefry + Box-Muller pair and prices the two exact GBM terminal paths 2e
// and 2e+1, each masked by pid < n_paths.
//
// simulate_kernel replaces mc_tpu/ops/path_kernels.py simulate_partials (the
// Pallas call at :450): the exact terminal draw or the log-Euler step loop
// (w += drift_dt + vol_dt*z; S = base*exp(w)), one threefry per two steps,
// the payoff templated in, the antithetic leg and the control-variate
// moments fused into the same pass.  Resume: each path may start from its
// own (s_init, state_init) at step start_step (an odd start first takes the
// tail half of its pair); null pointers mean "from p.s0".  Importance
// sampling: is_shift moves each draw (by is_shift on the terminal draw, by
// theta = is_shift/sqrt(n_steps) per Euler step) and pay and x carry the
// likelihood ratio; the antithetic leg negates the draw before the shift.
//
// trajectories_kernel replaces mc_tpu/ops/path_kernels.py
// simulate_trajectories_kernel (the Pallas call at :543): the plain
// log-Euler loop of simulate_kernel that also stores S and the payoff state
// after every step into step-major (n_steps, n_paths) grids, entry
// j*n_paths + i, so a warp's stores of one step are coalesced.  Its step is
// the euler_step and its draw schedule the outer leg of nmc_fused_kernel,
// so its grids are bitwise the states that kernel recomputes in registers.
//
// What bounds them on the H100: terminal_pair and simulate read 60 bytes of
// parameters (and 4 or 8 bytes per path on resume) and write one row of
// moments per block, so bytes do not matter; trajectories writes 8 bytes per
// path-step (80 MB at 100,000 x 100, 24 us at 3.35 TB/s), less than its RNG
// work takes.  The cost is the RNG's integer work (13 or 20 threefry rounds
// of add/rotate/xor per pair) and the transcendentals (log1pf, sqrtf, cosf,
// sinf per pair, one expf per step).  The design keeps all of it in
// registers: one thread per path (per element for the pair kernel) over a
// grid-stride loop, both Box-Muller halves consumed, both antithetic legs
// stepped from the same draw, and f64 moment sums per thread reduced once
// per block (reduce.cuh).  Float contraction is off in the build
// (--fmad=false), so each mul and add rounds as in the plain version.

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kThreads = 256;

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kThreads)
terminal_pair_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params,
                     uint32_t n_elems, uint32_t n_paths_total,
                     double* __restrict__ partials) {
  const Params p = load_params(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t e = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_elems; e += stride) {
    float z0, z1;
    normal_pair<ROUNDS>(k0, k1, static_cast<uint32_t>(e), 0u, z0, z1);
    const uint64_t pid = 2 * e;
    const float pa = pid < n_paths_total
        ? Payoff::terminal(0.0f, p.s0 * expf(p.drift_t + p.vol_t * z0), p) : 0.0f;
    const float pb = pid + 1 < n_paths_total
        ? Payoff::terminal(0.0f, p.s0 * expf(p.drift_t + p.vol_t * z1), p) : 0.0f;
    acc[0] += static_cast<double>(pa + pb);
    acc[1] += static_cast<double>(pa * pa + pb * pb);
  }
  block_store_moments<2, kThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

// Importance-sampling likelihood ratio dP/dQ of an Euler leg:
// exp(-theta * sum_eps + n theta^2 / 2), sum_eps * vol_dt = w - n * drift_dt.
__device__ __forceinline__ float euler_is_weight(const Params& p, float w, int n_steps,
                                                 float theta) {
  const float n = static_cast<float>(n_steps);
  const float sum_eps = (w - n * p.drift_dt) / p.vol_dt;
  return expf(-theta * sum_eps + 0.5f * n * theta * theta);
}

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kThreads)
simulate_kernel(int euler, int antithetic, int with_cv, uint32_t k0, uint32_t k1,
                const float* __restrict__ params, int n_steps, int start_step,
                float is_shift, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                const float* __restrict__ s_init, const float* __restrict__ state_init,
                double* __restrict__ partials, int n_mom) {
  const Params p = load_params(params);
  const bool shifted = is_shift != 0.0f;
  const float theta = is_shift / static_cast<float>(sqrt(static_cast<double>(n_steps)));
  double acc[kMaxMoments] = {0.0, 0.0, 0.0, 0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float base = s_init ? s_init[i] : p.s0;
    const float st0 = state_init ? state_init[i] : Payoff::init();
    // pay and x of each leg; under IS both carry the leg's likelihood ratio
    // (a weight of 1 when unshifted: exact).
    float pay, x, pay_n = 0.0f, x_n = 0.0f;
    if (!euler) {
      float z, unused;
      normal_pair<ROUNDS>(k0, k1, id, 0u, z, unused);
      auto leg = [&](float zl, float& pay_l, float& x_l) {
        const float zs = shifted ? zl + is_shift : zl;
        const float s_t = base * expf(p.drift_t + p.vol_t * zs);
        // dP/dQ at the sampled point: exp(-shift*eps + shift^2/2)
        const float wt =
            shifted ? expf(-is_shift * zs + 0.5f * is_shift * is_shift) : 1.0f;
        pay_l = Payoff::terminal(Payoff::init(), s_t, p) * wt;
        x_l = s_t * wt;
      };
      leg(z, pay, x);
      if (antithetic) leg(-z, pay_n, x_n);  // negated before the shift
    } else {
      float w = 0.0f, s = base, st = st0;
      float wn = 0.0f, sn = base, stn = st0;  // antithetic leg
      // Both legs from one draw; the antithetic leg negates it before the shift.
      auto step = [&](float z) {
        euler_step<Payoff>(p, base, shifted ? z + theta : z, w, s, st);
        if (antithetic) euler_step<Payoff>(p, base, shifted ? -z + theta : -z, wn, sn, stn);
      };
      float z0, z1;
      int start = start_step;
      if (start & 1) {  // odd resume point: the tail half of its pair first
        normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(start / 2), z0, z1);
        step(z1);
        ++start;
      }
      for (int m = start / 2; m < n_steps / 2; ++m) {
        normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
        step(z0);
        step(z1);
      }
      if (n_steps & 1) {  // odd step count: the epilogue takes the head half
        normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(n_steps / 2), z0, z1);
        step(z0);
      }
      auto leg = [&](float w_l, float s_l, float st_l, float& pay_l, float& x_l) {
        const float wt = shifted ? euler_is_weight(p, w_l, n_steps, theta) : 1.0f;
        pay_l = Payoff::terminal(st_l, s_l, p) * wt;
        x_l = s_l * wt;
      };
      leg(w, s, st, pay, x);
      if (antithetic) leg(wn, sn, stn, pay_n, x_n);
    }
    if (antithetic) {
      pay = 0.5f * (pay + pay_n);
      x = 0.5f * (x + x_n);
    }
    const bool valid = id < bound;
    pay = valid ? pay : 0.0f;
    acc[0] += static_cast<double>(pay);
    acc[1] += static_cast<double>(pay * pay);
    if (with_cv) {
      // Control variate X = terminal price (pair mean if antithetic).
      x = valid ? x : 0.0f;
      acc[2] += static_cast<double>(x);
      acc[3] += static_cast<double>(x * x);
      acc[4] += static_cast<double>(pay * x);
    }
  }
  block_store_moments<kMaxMoments, kThreads>(
      acc, partials + static_cast<size_t>(n_mom) * blockIdx.x, n_mom);
}

template <class Payoff, int ROUNDS>
__global__ void __launch_bounds__(kThreads)
trajectories_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params,
                    int n_steps, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                    float* __restrict__ s_grid, float* __restrict__ state_grid,
                    double* __restrict__ partials) {
  const Params p = load_params(params);
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    float w = 0.0f, s = p.s0, st = Payoff::init();
    auto step = [&](float z, int j) {
      euler_step<Payoff>(p, p.s0, z, w, s, st);
      const size_t at = static_cast<size_t>(j) * n_paths + i;
      s_grid[at] = s;
      state_grid[at] = st;
    };
    float z0, z1;
    for (int m = 0; m < n_steps / 2; ++m) {
      normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
      step(z0, 2 * m);
      step(z1, 2 * m + 1);
    }
    if (n_steps & 1) {  // odd step count: the epilogue takes the head half
      normal_pair<ROUNDS>(k0, k1, id, static_cast<uint32_t>(n_steps / 2), z0, z1);
      step(z0, n_steps - 1);
    }
    const float pay = id < bound ? Payoff::terminal(st, s, p) : 0.0f;
    acc[0] += static_cast<double>(pay);
    acc[1] += static_cast<double>(pay * pay);
  }
  block_store_moments<2, kThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Payoff>
cudaError_t launch_terminal_pair(int rounds, uint32_t k0, uint32_t k1,
                                 const float* params, uint32_t n_elems,
                                 uint32_t n_paths_total, double* partials,
                                 int n_blocks, cudaStream_t stream) {
  if (rounds == 13) {
    terminal_pair_kernel<Payoff, 13><<<n_blocks, kThreads, 0, stream>>>(
        k0, k1, params, n_elems, n_paths_total, partials);
  } else if (rounds == 20) {
    terminal_pair_kernel<Payoff, 20><<<n_blocks, kThreads, 0, stream>>>(
        k0, k1, params, n_elems, n_paths_total, partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <class Payoff>
cudaError_t launch_simulate(int rounds, int euler, int antithetic, int with_cv,
                            uint32_t k0, uint32_t k1, const float* params,
                            int n_steps, int start_step, float is_shift,
                            uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                            const float* s_init, const float* state_init,
                            double* partials, int n_mom, int n_blocks,
                            cudaStream_t stream) {
  if (rounds == 13) {
    simulate_kernel<Payoff, 13><<<n_blocks, kThreads, 0, stream>>>(
        euler, antithetic, with_cv, k0, k1, params, n_steps, start_step, is_shift,
        n_paths, path_offset, bound, s_init, state_init, partials, n_mom);
  } else if (rounds == 20) {
    simulate_kernel<Payoff, 20><<<n_blocks, kThreads, 0, stream>>>(
        euler, antithetic, with_cv, k0, k1, params, n_steps, start_step, is_shift,
        n_paths, path_offset, bound, s_init, state_init, partials, n_mom);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <class Payoff>
cudaError_t launch_trajectories(int rounds, uint32_t k0, uint32_t k1,
                                const float* params, int n_steps, uint32_t n_paths,
                                uint32_t path_offset, uint32_t bound, float* s_grid,
                                float* state_grid, double* partials, int n_blocks,
                                cudaStream_t stream) {
  if (rounds == 13) {
    trajectories_kernel<Payoff, 13><<<n_blocks, kThreads, 0, stream>>>(
        k0, k1, params, n_steps, n_paths, path_offset, bound, s_grid, state_grid,
        partials);
  } else if (rounds == 20) {
    trajectories_kernel<Payoff, 20><<<n_blocks, kThreads, 0, stream>>>(
        k0, k1, params, n_steps, n_paths, path_offset, bound, s_grid, state_grid,
        partials);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

const char* mc_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

int mc_block_threads() { return mc::kThreads; }

int mc_terminal_pair(int payoff_id, int rounds, uint32_t k0, uint32_t k1,
                     const float* params, uint32_t n_elems, uint32_t n_paths_total,
                     double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (payoff_id) {
    case mc::PAYOFF_VANILLA_CALL:
      return mc::launch_terminal_pair<mc::VanillaCall>(
          rounds, k0, k1, params, n_elems, n_paths_total, partials, n_blocks, s);
    case mc::PAYOFF_VANILLA_PUT:
      return mc::launch_terminal_pair<mc::VanillaPut>(
          rounds, k0, k1, params, n_elems, n_paths_total, partials, n_blocks, s);
    default:  // path-dependent payoffs have no terminal draw
      return cudaErrorInvalidValue;
  }
}

int mc_simulate_partials(int payoff_id, int rounds, int euler, int antithetic,
                         int with_cv, uint32_t k0, uint32_t k1, const float* params,
                         int n_steps, int start_step, float is_shift, uint32_t n_paths,
                         uint32_t path_offset, uint32_t bound, const float* s_init,
                         const float* state_init, double* partials, int n_mom,
                         int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_LAUNCH_SIMULATE(PAYOFF)                                                   \
  mc::launch_simulate<PAYOFF>(rounds, euler, antithetic, with_cv, k0, k1, params,   \
                              n_steps, start_step, is_shift, n_paths, path_offset, \
                              bound, s_init, state_init, partials, n_mom, n_blocks, s)
  switch (payoff_id) {
    case mc::PAYOFF_VANILLA_CALL: return MC_LAUNCH_SIMULATE(mc::VanillaCall);
    case mc::PAYOFF_VANILLA_PUT: return MC_LAUNCH_SIMULATE(mc::VanillaPut);
    case mc::PAYOFF_BULLET_CALL: return MC_LAUNCH_SIMULATE(mc::BulletCall);
    default: return cudaErrorInvalidValue;
  }
#undef MC_LAUNCH_SIMULATE
}

int mc_trajectories(int payoff_id, int rounds, uint32_t k0, uint32_t k1,
                    const float* params, int n_steps, uint32_t n_paths,
                    uint32_t path_offset, uint32_t bound, float* s_grid,
                    float* state_grid, double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_LAUNCH_TRAJECTORIES(PAYOFF)                                             \
  mc::launch_trajectories<PAYOFF>(rounds, k0, k1, params, n_steps, n_paths,         \
                                  path_offset, bound, s_grid, state_grid, partials, \
                                  n_blocks, s)
  switch (payoff_id) {
    case mc::PAYOFF_VANILLA_CALL: return MC_LAUNCH_TRAJECTORIES(mc::VanillaCall);
    case mc::PAYOFF_VANILLA_PUT: return MC_LAUNCH_TRAJECTORIES(mc::VanillaPut);
    case mc::PAYOFF_BULLET_CALL: return MC_LAUNCH_TRAJECTORIES(mc::BulletCall);
    default: return cudaErrorInvalidValue;
  }
#undef MC_LAUNCH_TRAJECTORIES
}

}  // extern "C"
