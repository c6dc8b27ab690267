// Randomized QMC under the model families on the device: the kernel for
// #33, qmc_model_kernel<Leg, Payoff>, for sm_90a.
//
// It replaces mc_tpu/qmc.py _model_shift_mean_fn (its one_shift's Pallas
// call at :838, the body _make_qmc_model_kernel at :790): one shift's payoff
// mean under a family, point i of the shifted lattice or Sobol net through
// the family's leg.  mc_tpu launches one pallas_call per shift under
// lax.map; here one launch takes all R shifts, kShifts of them a thread:
// the grid is (path blocks, ceil(R / kShifts)), block (x, g) runs points
// x*blockDim + t, grid-strided, under shifts g*kShifts .. g*kShifts +
// kShifts-1 in lockstep (those of a ragged last group past R run on the
// last shift and are not stored), and writes one f64 sum per shift at
// partials[x*R + r] (reduce.cuh); ops/reduce.finish_sum adds the rows in a
// fixed order, no float atomics (mc_tpu's f32 Kahan fold becomes an f64
// sum, ROADMAP C6).  A block adds the same points in the same order under
// each shift as at one shift a thread, so the partials do not depend on
// kShifts, bit for bit.
//
// The draw (QmcDraw) computes a coordinate's shift-independent part once
// for the point (qmc.cuh qmc_base: the lattice residue or the Sobol XOR,
// the point source of the GBM kernels #31 and #32) and then each shift's
// unit: normals(j) the kShifts inverse-CDF normals of dimension j, pair(m)
// those of dimensions (2m, 2m+1), units(j) the raw coordinates (Merton's
// and Bates's Poisson counts).  A Leg is a family's step loop over such a
// draw, its kShifts legs in lockstep, in its own header beside the
// family's step (<family>.cuh, <Family>QmcLeg):
//   Params, load(params, n_steps, extra)  the packed parameters; extra is
//                                         the family's integer (Merton's and
//                                         Bates's Poisson depth, local vol's
//                                         knot count, the basket's d);
//   kShifts                               the shifts a thread runs, 1, 2, 4
//                                         or 8 (measured on the H100);
//   pay<Payoff>(p, n_steps, draw, pay)    the point's kShifts payoffs;
//   table_floats(extra), fill_table(p, t) a per-block table in shared
//                                         memory (Merton's and Bates's
//                                         Poisson cdf), if the leg has one.
// Each family's instantiations, one per payoff it accepts, sit in a source
// of their own (qmc_<family>_kernels.cu, the basket's capacity 32 in
// qmc_basket32_kernels.cu), so nvcc compiles them in parallel; the entry
// point mc_qmc_model_sums (qmc_kernels.cu) dispatches on the FamilyId.
//
// What bounds it on the H100: operations.  Each dimension a point reads
// costs, once for the point, its coordinate's base (the lattice residue,
// ~20 int32 operations, or the Sobol XOR over the Gray code's set bits),
// and for each shift the shift's add or XOR, the unit and the inverse CDF
// (~84 f32 operations and four transcendentals or divisions); then the
// family's step per shift.  Bytes are a few kB of tables, shifts and
// parameters, read as uniform loads.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "qmc.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kQmcModelThreads = 128;

template <int K>
struct QmcVec {
  float v[K];
};

// A dimension's kShifts units or normals, out of line: one copy in each
// kernel, called at every draw of a leg, keeps the 172 instantiations' code
// and their compile time small (inlined, the draws of a Bates or basket
// step unrolled into a few thousand instructions each).
template <int K>
static __device__ __noinline__ QmcVec<K> qmc_model_units(QmcPoints q, uint32_t id, int j,
                                                        int r0) {
  QmcVec<K> u;
  qmc_units<K>(q, id, j, r0, u.v);
  return u;
}

template <int K>
static __device__ __noinline__ QmcVec<K> qmc_model_normals(QmcPoints q, uint32_t id, int j,
                                                          int r0) {
  QmcVec<K> z;
  qmc_normals<K>(q, id, j, r0, z.v);
  return z;
}

// Point `id`'s coordinates under the K shifts r0 .. r0+K-1.
template <int K>
struct QmcDraw {
  QmcPoints q;
  uint32_t id;
  int r0;

  __device__ __forceinline__ void units(int j, float (&u)[K]) const {
    const QmcVec<K> v = qmc_model_units<K>(q, id, j, r0);
#pragma unroll
    for (int k = 0; k < K; ++k) u[k] = v.v[k];
  }
  __device__ __forceinline__ void normals(int j, float (&z)[K]) const {
    const QmcVec<K> v = qmc_model_normals<K>(q, id, j, r0);
#pragma unroll
    for (int k = 0; k < K; ++k) z[k] = v.v[k];
  }
  __device__ __forceinline__ void pair(int m, float (&z0)[K], float (&z1)[K]) const {
    normals(2 * m, z0);
    normals(2 * m + 1, z1);
  }
};

// A leg with a per-block table in shared memory (Merton's and Bates's
// Poisson cdf): table_floats(extra) floats, fill_table(p, table) run by
// thread 0; the leg's Params carry it as cdf.
template <class Leg, class = void>
struct QmcLegTable : std::false_type {};
template <class Leg>
struct QmcLegTable<Leg, std::void_t<decltype(&Leg::table_floats)>> : std::true_type {};

template <class Leg>
inline int qmc_leg_table_floats(int extra) {
  if constexpr (QmcLegTable<Leg>::value) {
    return Leg::table_floats(extra);
  } else {
    return 0;
  }
}

template <class Leg, class Payoff>
__global__ void __launch_bounds__(kQmcModelThreads)
qmc_model_kernel(QmcPoints q, const float* __restrict__ params, int n_steps, int extra,
                 double* __restrict__ partials) {
  constexpr int K = Leg::kShifts;
  typename Leg::Params p = Leg::load(params, n_steps, extra);
  if constexpr (QmcLegTable<Leg>::value) {
    extern __shared__ float qmc_model_table[];
    if (threadIdx.x == 0) Leg::fill_table(p, qmc_model_table);
    __syncthreads();
    p.cdf = qmc_model_table;
  }
  const int r0 = blockIdx.y * K;
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t id = blockIdx.x * blockDim.x + threadIdx.x; id < static_cast<uint32_t>(q.n);
       id += stride) {
    float pay[K];
    Leg::template pay<Payoff>(p, n_steps, QmcDraw<K>{q, id, r0}, pay);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += static_cast<double>(pay[k]);
  }
  block_store_moments<K, kQmcModelThreads>(
      acc, partials + static_cast<size_t>(blockIdx.x) * q.n_shifts + r0, min(K, q.n_shifts - r0));
}

// A launch of n_bx x n_groups blocks (qmc.py qmc_launch computes both; a
// group count that does not fit kShifts is refused).
template <class Leg, class Payoff>
cudaError_t launch_qmc_model(const QmcPoints& q, const float* params, int n_steps, int extra,
                             double* partials, int n_bx, int n_groups, cudaStream_t stream) {
  if (!qmc_groups_ok(q, Leg::kShifts, n_groups)) return cudaErrorInvalidValue;
  const size_t smem = 4 * static_cast<size_t>(qmc_leg_table_floats<Leg>(extra));
  qmc_model_kernel<Leg, Payoff><<<dim3(n_bx, n_groups), kQmcModelThreads, smem, stream>>>(
      q, params, n_steps, extra, partials);
  return cudaGetLastError();
}

template <class Leg, class Payoff>
cudaError_t qmc_model_occupancy(int extra, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, qmc_model_kernel<Leg, Payoff>, kQmcModelThreads,
      4 * static_cast<size_t>(qmc_leg_table_floats<Leg>(extra)));
}

// Each family's launcher (the payoff switch over the payoffs it accepts),
// its kShifts and its kernels' resident blocks per SM, defined in its own
// source by MC_DEFINE_QMC_MODEL_LAUNCHER.
#define MC_QMC_MODEL_LAUNCHER(PREFIX)                                                     \
  cudaError_t PREFIX##_qmc_model(int payoff_id, const QmcPoints& q, const float* params,  \
                                 int n_steps, int extra, double* partials, int n_bx,      \
                                 int n_groups, cudaStream_t stream);                      \
  int PREFIX##_qmc_model_shifts();                                                        \
  cudaError_t PREFIX##_qmc_model_occupancy(int payoff_id, int extra, int* blocks);
MC_QMC_MODEL_LAUNCHER(heston)
MC_QMC_MODEL_LAUNCHER(bates)
MC_QMC_MODEL_LAUNCHER(cev)
MC_QMC_MODEL_LAUNCHER(sabr)
MC_QMC_MODEL_LAUNCHER(localvol)
MC_QMC_MODEL_LAUNCHER(term)
MC_QMC_MODEL_LAUNCHER(vasicek)
MC_QMC_MODEL_LAUNCHER(merton)
MC_QMC_MODEL_LAUNCHER(basket)
MC_QMC_MODEL_LAUNCHER(basket32)
#undef MC_QMC_MODEL_LAUNCHER

#define MC_QMC_MODEL_CASE(ID, PAYOFF)                                                     \
  case ID:                                                                                \
    return launch_qmc_model<MC_QMC_LEG, PAYOFF>(q, params, n_steps, extra, partials, n_bx, \
                                                n_groups, stream);

#define MC_QMC_MODEL_OCCUPANCY_CASE(ID, PAYOFF) \
  case ID:                                      \
    return qmc_model_occupancy<MC_QMC_LEG, PAYOFF>(extra, blocks);

// PREFIX's launcher over the payoffs PAYOFFS (an X-macro of payoffs.cuh or
// heston.cuh) on the leg MC_QMC_LEG, which the source defines first.
#define MC_DEFINE_QMC_MODEL_LAUNCHER(PREFIX, PAYOFFS)                                     \
  cudaError_t PREFIX##_qmc_model(int payoff_id, const QmcPoints& q, const float* params,  \
                                 int n_steps, int extra, double* partials, int n_bx,      \
                                 int n_groups, cudaStream_t stream) {                     \
    switch (payoff_id) {                                                                  \
      PAYOFFS(MC_QMC_MODEL_CASE)                                                          \
      default: return cudaErrorInvalidValue;                                              \
    }                                                                                     \
  }                                                                                       \
  int PREFIX##_qmc_model_shifts() { return MC_QMC_LEG::kShifts; }                         \
  cudaError_t PREFIX##_qmc_model_occupancy(int payoff_id, int extra, int* blocks) {       \
    switch (payoff_id) {                                                                  \
      PAYOFFS(MC_QMC_MODEL_OCCUPANCY_CASE)                                                \
      default: return cudaErrorInvalidValue;                                              \
    }                                                                                     \
  }

}  // namespace mc
