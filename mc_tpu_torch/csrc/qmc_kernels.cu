// The randomized-QMC kernels of the port (GBM), for sm_90a.
//
// qmc_kernel replaces mc_tpu/qmc.py _pallas_qmc_shift_sum (the Pallas call
// at :469) and qmc_bridge_kernel replaces _pallas_qmc_bridge_shift_sum (the
// Pallas call at :409).  mc_tpu launches one pallas_call per random shift;
// here one launch takes all R shifts: the grid is (path blocks, R), block
// (x, r) runs points x*blockDim + t, grid-strided, under shift r, and writes
// one f64 sum at partials[x*R + r] (reduce.cuh); ops/reduce.finish_sum adds
// the rows, a fixed order, no float atomics.
//
// A point's coordinate j is qmc_unit (qmc.cuh, shared with #33): the exact
// lattice residue under its Cranley-Patterson shift, or the Gray-code Sobol
// XOR under its digital shift.
// Both are the same for every thread of a block but the id, so the table,
// the generating vector and the shifts are uniform loads (an L1 broadcast).
// The normal is rng.cuh inv_normal_cdf (Acklam + one Newton step, as
// mc_tpu), never CUDA's normcdfinvf.  The leg is simulate_path
// (payoffs.cuh), the simulate kernel's: the terminal draw on dimension 0, or
// the log-Euler loop with step pair m on dimensions (2m, 2m+1); an odd step
// count's unused last half reads the last dimension.
//
// The bridge builds each path's W (nodes 0..n_steps, W[0] = 0) from
// dimension k at entry k of the breadth-first schedule (bidx, bcoef:
// W[m] = (c_l W[l] + c_r W[r]) + s z_k), then steps on the increments
// W[2m+1] - W[2m], W[min(2m+2, n)] - W[2m+1].  The indices are data, so W
// cannot live in registers: it lives in dynamic shared memory, node k of
// thread t at k*blockDim + t (no bank conflicts), (n_steps+1)*blockDim*4
// bytes a block, the block 128 threads where that fits (n_steps <= 452),
// else 64 or 32.
//
// What bounds them on the H100: operations.  A coordinate costs the
// residue (~10 int32 and f32 operations) or the Sobol XOR (~4 int32
// operations a bit, 30 bits), and the inverse CDF ~50 f32 operations, two
// divisions and a logf, sqrtf and expf each; a step ~4 f32 and an expf.
// Bytes are a few kB of tables and shifts, read through L1.

#include <cstdint>

#include <cuda_runtime.h>

#include "family.cuh"
#include "payoffs.cuh"
#include "qmc.cuh"
#include "qmc_model.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kQmcThreads = 128;
// A block's shared memory on the H100 (227 KB) less the reduction buffer.
constexpr int kQmcSmemBytes = 232448 - 8 * kQmcThreads;

template <class Payoff>
__global__ void __launch_bounds__(kQmcThreads)
qmc_kernel(int euler, QmcPoints q, const float* __restrict__ params, int n_steps,
           double* __restrict__ partials) {
  const Params p = load_params(params);
  const int r = blockIdx.y;
  double acc[1] = {0.0};
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t id = blockIdx.x * blockDim.x + threadIdx.x; id < static_cast<uint32_t>(q.n);
       id += stride) {
    const auto draw = [&](int m, float& z0, float& z1) {
      if (!euler) {
        z0 = inv_normal_cdf(qmc_unit(q, id, 0, r));
        z1 = 0.0f;
        return;
      }
      z0 = inv_normal_cdf(qmc_unit(q, id, 2 * m, r));
      z1 = inv_normal_cdf(qmc_unit(q, id, 2 * m + 1, r));
    };
    const PathEnd<Payoff> e = simulate_path<Payoff>(p, euler != 0, false, p.s0, Payoff::init(p),
                                                    0, n_steps, 0.0f, draw);
    acc[0] += static_cast<double>(Payoff::terminal(e.st, e.s, p));
  }
  block_store_moments<1, kQmcThreads>(
      acc, partials + static_cast<size_t>(blockIdx.x) * gridDim.y + r, 1);
}

template <class Payoff>
__global__ void __launch_bounds__(kQmcThreads)
qmc_bridge_kernel(QmcPoints q, const float* __restrict__ params, int n_steps,
                  const int* __restrict__ bidx, const float* __restrict__ bcoef,
                  double* __restrict__ partials) {
  extern __shared__ float w_sh[];
  const Params p = load_params(params);
  const int r = blockIdx.y;
  const int nb = blockDim.x;
  float* w = w_sh + threadIdx.x;  // node k at w[k*nb]
  double acc[1] = {0.0};
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t id = blockIdx.x * blockDim.x + threadIdx.x; id < static_cast<uint32_t>(q.n);
       id += stride) {
    w[0] = 0.0f;
    for (int k = 0; k < n_steps; ++k) {
      const float z = inv_normal_cdf(qmc_unit(q, id, k, r));
      const int m = __ldg(bidx + 3 * k), l = __ldg(bidx + 3 * k + 1),
                rr = __ldg(bidx + 3 * k + 2);
      w[m * nb] = (__ldg(bcoef + 3 * k) * w[l * nb] + __ldg(bcoef + 3 * k + 1) * w[rr * nb]) +
                  __ldg(bcoef + 3 * k + 2) * z;
    }
    const auto draw = [&](int m, float& z0, float& z1) {
      const int hi = min(2 * m + 2, n_steps);
      z0 = w[(2 * m + 1) * nb] - w[2 * m * nb];
      z1 = w[hi * nb] - w[(2 * m + 1) * nb];
    };
    const PathEnd<Payoff> e = simulate_path<Payoff>(p, true, false, p.s0, Payoff::init(p), 0,
                                                    n_steps, 0.0f, draw);
    acc[0] += static_cast<double>(Payoff::terminal(e.st, e.s, p));
  }
  block_store_moments<1, kQmcThreads>(
      acc, partials + static_cast<size_t>(blockIdx.x) * gridDim.y + r, 1);
}

// The bridge's block: the most threads (128, 64, 32) whose W buffers fit.
inline int bridge_threads(int n_steps) {
  for (int t = kQmcThreads; t >= 32; t /= 2) {
    if (static_cast<long long>(n_steps + 1) * t * 4 <= kQmcSmemBytes) return t;
  }
  return 0;
}

template <class Payoff>
cudaError_t launch_qmc(int euler, const QmcPoints& q, const float* params, int n_steps,
                       double* partials, dim3 grid, cudaStream_t stream) {
  qmc_kernel<Payoff><<<grid, kQmcThreads, 0, stream>>>(euler, q, params, n_steps, partials);
  return cudaGetLastError();
}

template <class Payoff>
cudaError_t launch_qmc_bridge(const QmcPoints& q, const float* params, int n_steps,
                              const int* bidx, const float* bcoef, double* partials, dim3 grid,
                              cudaStream_t stream) {
  const int threads = bridge_threads(n_steps);
  if (threads == 0) return cudaErrorInvalidValue;
  const int bytes = (n_steps + 1) * threads * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      qmc_bridge_kernel<Payoff>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  qmc_bridge_kernel<Payoff><<<grid, threads, bytes, stream>>>(q, params, n_steps, bidx, bcoef,
                                                             partials);
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_qmc_block_threads() { return mc::kQmcThreads; }

// The bridge kernel's threads per block for n_steps, 0 if its W buffer
// fits no block.
int mc_qmc_bridge_threads(int n_steps) { return mc::bridge_threads(n_steps); }

// family 0 lattice (table: the (d,) int32 generating vector, shifts (R, d)
// f32) or 1 sobol (table: (d*30,) int32 directions, shifts (R, d) int32);
// euler 0: the terminal draw (d = 1), 1: the Euler loop (d = n_steps);
// partials (n_bx, R) f64.
int mc_qmc_sums(int payoff_id, int family, int euler, int n, int d, const int* table,
                const void* shifts, int n_shifts, const float* params, int n_steps,
                double* partials, int n_bx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mc::qmc_args_ok(family, n, d, n_shifts, n_bx) || n_steps < 1)
    return cudaErrorInvalidValue;
  const mc::QmcPoints q = mc::qmc_points(family, n, d, table, shifts);
  const dim3 grid(n_bx, n_shifts);
#define MC_CASE(ID, PAYOFF) \
  case mc::ID:              \
    return mc::launch_qmc<mc::PAYOFF>(euler, q, params, n_steps, partials, grid, s);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

int mc_qmc_model_block_threads() { return mc::kQmcModelThreads; }

// #33: the payoff sums of n points through family_id's leg (a FamilyId of
// family.cuh; params its pack, extra its integer: kmax for Merton and Bates,
// the knot count for local vol, d for the basket) over n_steps, under each
// of the R shifts; partials (n_bx, R) f64.  The point set as mc_qmc_sums',
// its d the family's dimensions.
int mc_qmc_model_sums(int family_id, int payoff_id, int family, int n, int d,
                      const int* table, const void* shifts, int n_shifts,
                      const float* params, int n_steps, int extra, double* partials,
                      int n_bx, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mc::qmc_args_ok(family, n, d, n_shifts, n_bx) || n_steps < 1)
    return cudaErrorInvalidValue;
  const bool even = n_steps % 2 == 0;
  const bool kmax_ok = extra >= 1 && extra <= 256;
  const mc::QmcPoints q = mc::qmc_points(family, n, d, table, shifts);
  const dim3 grid(n_bx, n_shifts);
#define MC_LAUNCH(PREFIX, OK)                                                          \
  return (OK) ? mc::PREFIX##_qmc_model(payoff_id, q, params, n_steps, extra, partials, \
                                       grid, s)                                        \
              : cudaErrorInvalidValue;
  switch (family_id) {
    case mc::FAMILY_HESTON: MC_LAUNCH(heston, d == 2 * n_steps)
    case mc::FAMILY_BATES: MC_LAUNCH(bates, kmax_ok && d == 4 * n_steps)
    case mc::FAMILY_CEV: MC_LAUNCH(cev, even && d == n_steps)
    case mc::FAMILY_SABR: MC_LAUNCH(sabr, d == 2 * n_steps)
    case mc::FAMILY_LOCALVOL: MC_LAUNCH(localvol, even && extra >= 2 && d == n_steps)
    case mc::FAMILY_TERM: MC_LAUNCH(term, even && d == n_steps)
    case mc::FAMILY_VASICEK: MC_LAUNCH(vasicek, even && d == 3 * n_steps)
    case mc::FAMILY_MERTON: MC_LAUNCH(merton, even && kmax_ok && d == 3 * n_steps)
    case mc::FAMILY_BASKET: {
      const bool ok = extra >= 1 && extra <= 32 && d == 2 * ((extra + 1) / 2) * n_steps;
      if (extra <= 8) MC_LAUNCH(basket, ok)
      MC_LAUNCH(basket32, ok)
    }
    default: return cudaErrorInvalidValue;
  }
#undef MC_LAUNCH
}

// As mc_qmc_sums, the Euler increments from the Brownian bridge: bidx
// (n_steps, 3) int32 and bcoef (n_steps, 3) f32 from qmc.bridge_schedule.
int mc_qmc_bridge_sums(int payoff_id, int family, int n, int d, const int* table,
                       const void* shifts, int n_shifts, const float* params, int n_steps,
                       const int* bidx, const float* bcoef, double* partials, int n_bx,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mc::qmc_args_ok(family, n, d, n_shifts, n_bx) || n_steps < 1 || d != n_steps)
    return cudaErrorInvalidValue;
  const mc::QmcPoints q = mc::qmc_points(family, n, d, table, shifts);
  const dim3 grid(n_bx, n_shifts);
#define MC_CASE(ID, PAYOFF)                                                              \
  case mc::ID:                                                                           \
    return mc::launch_qmc_bridge<mc::PAYOFF>(q, params, n_steps, bidx, bcoef, partials,  \
                                             grid, s);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
