// Fused nested Monte Carlo, kernel 3 of the port, for sm_90a.
//
// Replaces mc_tpu/ops/nmc_kernels.py nmc_fused_kernel (the Pallas call at
// :283).  It computes the same surface: for every outer path i and step j,
//   surface[j, i] = disc_j * mean_{m < n_inner} payoff(inner path m resumed
//                   from (S_j, count_j) for the remaining n_steps-j-1 steps),
// with inner counter (c0 = path id, c1 = ((j+1)*n_inner + m)*pair_cap + q)
// on the inner key, and the outer moments [sum pay, sum pay^2].
//
// What bounds it on the H100: the inner sweep, n_inner*(n_steps-j-1) steps
// per point, each half a threefry-13 call, half the Box-Muller
// transcendentals and one expf.  Bytes are negligible (one f32 per point).
//
// Design: the TPU kernel parks a tile's whole outer history in VMEM and then
// sweeps it.  A Hopper block has 227 KB of shared memory, room for about 280
// outer paths at 100 steps, and the points of one tile would then run one
// after the other.  Here a block instead takes 128 outer paths at ONE step j
// and recomputes each outer path up to step j+1 in registers from the outer
// stream: j+1 steps against the inner sweep's n_inner*(n_steps-j-1), so
// under 1% extra work at n_inner = 500, and no history anywhere.  Every
// (j, tile) block is independent, so the grid has n_steps*tiles blocks to
// fill the 132 SMs, and all threads of a block share j, so the inner loop
// never diverges.  Work per block falls with j; block b takes step
// j = b / tiles, so the largest blocks are issued first and the short ones
// fill the tail.  The j = n_steps-1 blocks hold the outer terminal states
// and write the outer moment rows.  An odd remaining count drops the second
// half-step of the last pair by a select, as the TPU kernel does.

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kNmcThreads = 128;
constexpr int kNmcRounds = 13;  // NMC streams are threefry-13 (NMCConfig)

template <class Payoff>
__global__ void __launch_bounds__(kNmcThreads)
nmc_fused_kernel(int discount_remaining, uint32_t ko0, uint32_t ko1, uint32_t ki0,
                 uint32_t ki1, const float* __restrict__ params, int n_steps,
                 int n_inner, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                 int tiles, float* __restrict__ surface,
                 double* __restrict__ outer_partials) {
  const Params p = load_params(params);
  const int j = blockIdx.x / tiles;  // the state after step j+1
  const int tile = blockIdx.x % tiles;
  const uint32_t local = static_cast<uint32_t>(tile) * kNmcThreads + threadIdx.x;
  const bool in_range = local < n_paths;
  const uint32_t id = path_offset + local;
  const bool valid = in_range && id < bound;

  // Phase A: the outer path up to step j+1, on the outer stream.
  float w = 0.0f, s = p.s0, st = Payoff::init();
  float z0, z1;
  const int done = j + 1;
  for (int m = 0; m < done / 2; ++m) {
    normal_pair<kNmcRounds>(ko0, ko1, id, static_cast<uint32_t>(m), z0, z1);
    w = w + (p.drift_dt + p.vol_dt * z0);
    s = p.s0 * expf(w);
    st = Payoff::update(st, s, p);
    w = w + (p.drift_dt + p.vol_dt * z1);
    s = p.s0 * expf(w);
    st = Payoff::update(st, s, p);
  }
  if (done & 1) {
    normal_pair<kNmcRounds>(ko0, ko1, id, static_cast<uint32_t>(done / 2), z0, z1);
    w = w + (p.drift_dt + p.vol_dt * z0);
    s = p.s0 * expf(w);
    st = Payoff::update(st, s, p);
  }
  const float s_j = s, st_j = st;

  if (j == n_steps - 1) {  // block-uniform: the outer terminal moments
    const float pay = valid ? Payoff::terminal(st_j, s_j, p) : 0.0f;
    const double acc[2] = {static_cast<double>(pay), static_cast<double>(pay * pay)};
    block_store_moments<2, kNmcThreads>(acc, outer_partials + 2 * static_cast<size_t>(tile), 2);
  }

  // Phase B: n_inner inner paths resumed from (S_j, count_j).
  const int remaining = n_steps - j - 1;
  const int n_pairs = (remaining + 1) / 2;
  const uint32_t pair_cap = static_cast<uint32_t>((n_steps + 1) / 2);
  const uint32_t t_base = static_cast<uint32_t>(j + 1) * static_cast<uint32_t>(n_inner);
  double sum = 0.0;
  for (int m = 0; m < n_inner; ++m) {
    const uint32_t c1_base = (t_base + static_cast<uint32_t>(m)) * pair_cap;
    float wi = 0.0f, si = s_j, sti = st_j;
    for (int q = 0; q < n_pairs; ++q) {
      normal_pair<kNmcRounds>(ki0, ki1, id, c1_base + static_cast<uint32_t>(q), z0, z1);
      const float w1 = wi + (p.drift_dt + p.vol_dt * z0);
      const float s1 = s_j * expf(w1);  // log-space: one exp rounding per S
      const float st1 = Payoff::update(sti, s1, p);
      const float w2 = w1 + (p.drift_dt + p.vol_dt * z1);
      const float s2 = s_j * expf(w2);
      const float st2 = Payoff::update(st1, s2, p);
      const bool take2 = (2 * q + 1) < remaining;  // drop an overrunning half-step
      wi = take2 ? w2 : w1;
      si = take2 ? s2 : s1;
      sti = take2 ? st2 : st1;
    }
    sum += static_cast<double>(Payoff::terminal(sti, si, p));
  }
  const float disc = discount_remaining
      ? expf(-p.r * (p.t - (static_cast<float>(j) + 1.0f) * p.dt))
      : expf(-p.r * p.t);
  const float v = static_cast<float>(sum / static_cast<double>(n_inner)) * disc;
  if (in_range) surface[static_cast<size_t>(j) * n_paths + local] = valid ? v : 0.0f;
}

template <class Payoff>
cudaError_t launch_nmc(int discount_remaining, uint32_t ko0, uint32_t ko1,
                       uint32_t ki0, uint32_t ki1, const float* params, int n_steps,
                       int n_inner, uint32_t n_paths, uint32_t path_offset,
                       uint32_t bound, float* surface, double* outer_partials,
                       cudaStream_t stream) {
  const int tiles = static_cast<int>((n_paths + kNmcThreads - 1) / kNmcThreads);
  const long long n_blocks = static_cast<long long>(tiles) * n_steps;
  if (n_blocks <= 0 || n_blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  nmc_fused_kernel<Payoff><<<static_cast<unsigned>(n_blocks), kNmcThreads, 0, stream>>>(
      discount_remaining, ko0, ko1, ki0, ki1, params, n_steps, n_inner, n_paths,
      path_offset, bound, tiles, surface, outer_partials);
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_nmc_block_threads() { return mc::kNmcThreads; }

int mc_nmc_fused(int payoff_id, int discount_remaining, uint32_t ko0, uint32_t ko1,
                 uint32_t ki0, uint32_t ki1, const float* params, int n_steps,
                 int n_inner, uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                 float* surface, double* outer_partials, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (payoff_id) {
    case mc::PAYOFF_VANILLA_CALL:
      return mc::launch_nmc<mc::VanillaCall>(discount_remaining, ko0, ko1, ki0, ki1,
                                             params, n_steps, n_inner, n_paths,
                                             path_offset, bound, surface,
                                             outer_partials, s);
    case mc::PAYOFF_VANILLA_PUT:
      return mc::launch_nmc<mc::VanillaPut>(discount_remaining, ko0, ko1, ki0, ki1,
                                            params, n_steps, n_inner, n_paths,
                                            path_offset, bound, surface,
                                            outer_partials, s);
    case mc::PAYOFF_BULLET_CALL:
      return mc::launch_nmc<mc::BulletCall>(discount_remaining, ko0, ko1, ki0, ki1,
                                            params, n_steps, n_inner, n_paths,
                                            path_offset, bound, surface,
                                            outer_partials, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
