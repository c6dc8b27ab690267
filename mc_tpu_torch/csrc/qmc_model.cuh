// Randomized QMC under the model families on the device: the kernel for
// #33, qmc_model_kernel<Leg, Payoff>, for sm_90a.
//
// It replaces mc_tpu/qmc.py _model_shift_mean_fn (its one_shift's Pallas
// call at :838, the body _make_qmc_model_kernel at :790): one shift's payoff
// mean under a family, point i of the shifted lattice or Sobol net through
// the family's leg.  mc_tpu launches one pallas_call per shift under
// lax.map; here one launch takes all R shifts: the grid is (path blocks, R),
// block (x, r) runs points x*blockDim + t, grid-strided, under shift r, and
// writes one f64 sum at partials[x*R + r] (reduce.cuh); ops/reduce.finish_sum
// adds the rows in a fixed order, no float atomics (mc_tpu's f32 Kahan fold
// becomes an f64 sum, ROADMAP C6).
//
// The draw (QmcDraw) reads the point's coordinates through qmc_unit
// (qmc.cuh), the same point source as the GBM kernels #31 and #32:
// pair(m) the inverse-CDF normals of dimensions (2m, 2m+1), normal(j) one
// dimension's, unit(j) its raw coordinate (Merton's and Bates's Poisson
// counts).  A Leg is a family's step loop over such a draw, in its own
// header beside the family's step (<family>.cuh, <Family>QmcLeg):
//   Params, load(params, n_steps, extra)  the packed parameters; extra is
//                                         the family's integer (Merton's and
//                                         Bates's Poisson depth, local vol's
//                                         knot count, the basket's d);
//   pay<Payoff>(p, n_steps, draw)         one point's payoff.
// Each family's instantiations, one per payoff it accepts, sit in a source
// of their own (qmc_<family>_kernels.cu, the basket's capacity 32 in
// qmc_basket32_kernels.cu), so nvcc compiles them in parallel; the entry
// point mc_qmc_model_sums (qmc_kernels.cu) dispatches on the FamilyId.
//
// What bounds it on the H100: operations.  Each dimension a point reads
// costs its coordinate (the lattice residue, ~20 int32 and 8 f32
// operations, or the Sobol XOR, 30 bits of ~4 int32 operations) and the
// inverse CDF (~84 f32 operations and four transcendentals or divisions);
// then the family's step.  Bytes are a few kB of tables, shifts and
// parameters, read through L1 as uniform loads.  The design is the plain
// one: one thread per point, everything in registers.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "qmc.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kQmcModelThreads = 128;

// A coordinate and its normal, out of line: one copy in each kernel, called
// at every draw of a leg, keeps the 172 instantiations' code and their
// compile time small (inlined, the draws of a Bates or basket step unrolled
// into a few thousand instructions each).
static __device__ __noinline__ float qmc_model_unit(QmcPoints q, uint32_t id, int j, int r) {
  return qmc_unit(q, id, j, r);
}

static __device__ __noinline__ float qmc_model_normal(QmcPoints q, uint32_t id, int j, int r) {
  return inv_normal_cdf(qmc_unit(q, id, j, r));
}

// Point `id`'s coordinates under shift r.
struct QmcDraw {
  QmcPoints q;
  uint32_t id;
  int r;

  __device__ __forceinline__ float unit(int j) const { return qmc_model_unit(q, id, j, r); }
  __device__ __forceinline__ float normal(int j) const {
    return qmc_model_normal(q, id, j, r);
  }
  __device__ __forceinline__ void pair(int m, float& z0, float& z1) const {
    z0 = normal(2 * m);
    z1 = normal(2 * m + 1);
  }
};

template <class Leg, class Payoff>
__global__ void __launch_bounds__(kQmcModelThreads)
qmc_model_kernel(QmcPoints q, const float* __restrict__ params, int n_steps, int extra,
                 double* __restrict__ partials) {
  const typename Leg::Params p = Leg::load(params, n_steps, extra);
  const int r = blockIdx.y;
  double acc[1] = {0.0};
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t id = blockIdx.x * blockDim.x + threadIdx.x; id < static_cast<uint32_t>(q.n);
       id += stride) {
    const QmcDraw draw{q, id, r};
    acc[0] += static_cast<double>(Leg::template pay<Payoff>(p, n_steps, draw));
  }
  block_store_moments<1, kQmcModelThreads>(
      acc, partials + static_cast<size_t>(blockIdx.x) * gridDim.y + r, 1);
}

template <class Leg, class Payoff>
cudaError_t launch_qmc_model(const QmcPoints& q, const float* params, int n_steps, int extra,
                             double* partials, dim3 grid, cudaStream_t stream) {
  qmc_model_kernel<Leg, Payoff>
      <<<grid, kQmcModelThreads, 0, stream>>>(q, params, n_steps, extra, partials);
  return cudaGetLastError();
}

// Each family's launcher: the payoff switch over the payoffs it accepts,
// defined in its own source by MC_DEFINE_QMC_MODEL_LAUNCHER.
#define MC_QMC_MODEL_LAUNCHER(PREFIX)                                                     \
  cudaError_t PREFIX##_qmc_model(int payoff_id, const QmcPoints& q, const float* params,  \
                                 int n_steps, int extra, double* partials, dim3 grid,     \
                                 cudaStream_t stream);
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
    return launch_qmc_model<MC_QMC_LEG, PAYOFF>(q, params, n_steps, extra, partials, grid,\
                                                stream);

// PREFIX's launcher over the payoffs PAYOFFS (an X-macro of payoffs.cuh or
// heston.cuh) on the leg MC_QMC_LEG, which the source defines first.
#define MC_DEFINE_QMC_MODEL_LAUNCHER(PREFIX, PAYOFFS)                                     \
  cudaError_t PREFIX##_qmc_model(int payoff_id, const QmcPoints& q, const float* params,  \
                                 int n_steps, int extra, double* partials, dim3 grid,     \
                                 cudaStream_t stream) {                                   \
    switch (payoff_id) {                                                                  \
      PAYOFFS(MC_QMC_MODEL_CASE)                                                          \
      default: return cudaErrorInvalidValue;                                              \
    }                                                                                     \
  }

}  // namespace mc
