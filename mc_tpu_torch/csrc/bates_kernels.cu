// Bates kernels of the port, for sm_90a.
//
// bates_partials_kernel<P, BatesEuler, R> and bates_qe_kernel replace
// mc_tpu/models/bates.py _bates_partials (the Pallas call at :269).  The
// Euler kernel is here: one path per thread over a grid-stride loop; step j
// draws the diffusion pair (id, 3j), the first normal of (id, 3j+1) for the
// jump size and word 0 of (id, 3j+2) for the Poisson uniform; Heston's step
// (heston.cuh), then the jump (merton.cuh); threefry-13 or -20; the
// antithetic twin in the same thread from the same draws (normals negated,
// each uniform u -> 1-u); paths at or past `bound` add zeros; each block
// writes one row of f64 [sum pay, sum pay^2] (reduce.cuh).  Every payoff
// but the two Brownian-bridge barriers (the Heston parameters have no
// sigma).  The QE kernel, its own loop, is in bates_qe_kernels.cu;
// mc_bates_partials launches either.
//
// The Bates instantiations of the family NMC kernels, the generic
// trajectories among them, are in bates_nmc_kernels.cu.
//
// What bounds it on the H100: operations.  A Bates Euler step spends three
// threefry calls (two Box-Muller pairs and a uniform), Heston's sqrtf and
// Box-Muller transcendentals, the Poisson scan (kmax iterations, kmax = 4 at
// lam*dt = 0.003), a sqrtf and an expf.  The parameters are 80 bytes and
// each block writes 16.

#include <cstdint>

#include <cuda_runtime.h>

#include "bates.cuh"
#include "heston.cuh"
#include "merton.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

// A step's draws: the diffusion normals (z_v, z_2), the jump normal e, the
// QE uniform u_v (unused: this is the Euler kernel's code, kept as it is;
// the QE kernel draws its own in bates_qe_kernels.cu) and the Poisson
// uniform u_n.
struct BatesDraws {
  float z_v, z_2, e, u_v, u_n;
};

struct BatesEuler {
  template <int ROUNDS>
  __device__ static BatesDraws draw(uint32_t k0, uint32_t k1, uint32_t id, int j) {
    BatesDraws d;
    bates_euler_draw<ROUNDS>(k0, k1, id, 3u * static_cast<uint32_t>(j), d.z_v, d.z_2, d.e,
                             d.u_n);
    d.u_v = 0.0f;
    return d;
  }
  __device__ static void step(const BatesParams& b, const QeConsts&, float z_v, float z_2,
                              float, float& w, float& v) {
    heston_euler_step(b.h, z_v, z_2, w, v);
  }
};

template <class Payoff, class Scheme, int ROUNDS>
__global__ void __launch_bounds__(kBatesThreads)
bates_partials_kernel(int antithetic, uint32_t k0, uint32_t k1,
                      const float* __restrict__ params, int kmax, int n_steps,
                      uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                      double* __restrict__ partials) {
  using State = typename Payoff::State;
  const BatesParams b = load_bates(params);
  const QeConsts qc = qe_consts(b.h);
  const float s0 = b.h.pay.s0;
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    float w = 0.0f, v = b.h.v0, s = s0;
    float wn = 0.0f, vn = b.h.v0, sn = s0;
    State st = Payoff::init(b.h.pay), stn = st;
    for (int j = 0; j < n_steps; ++j) {
      const BatesDraws d = Scheme::template draw<ROUNDS>(k0, k1, id, j);
      Scheme::step(b, qc, d.z_v, d.z_2, d.u_v, w, v);
      bates_jump<Payoff>(b, kmax, d.e, d.u_n, s0, w, s, st);
      if (antithetic) {
        Scheme::step(b, qc, -d.z_v, -d.z_2, 1.0f - d.u_v, wn, vn);
        bates_jump<Payoff>(b, kmax, -d.e, 1.0f - d.u_n, s0, wn, sn, stn);
      }
    }
    float pay = Payoff::terminal(st, s, b.h.pay);
    if (antithetic) pay = 0.5f * (pay + Payoff::terminal(stn, sn, b.h.pay));
    const float pv[1] = {pay};
    add_moments(acc, pv, id < bound);
  }
  block_store_moments<2, kBatesThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x),
                                        2);
}

template <class Payoff>
cudaError_t launch_bates_euler(int rounds, int antithetic, uint32_t k0, uint32_t k1,
                               const float* params, int kmax, int n_steps, uint32_t n_paths,
                               uint32_t path_offset, uint32_t bound, double* partials,
                               int n_blocks, cudaStream_t stream) {
#define MC_BATES_LAUNCH(R)                                                                 \
  bates_partials_kernel<Payoff, BatesEuler, R><<<n_blocks, kBatesThreads, 0, stream>>>(    \
      antithetic, k0, k1, params, kmax, n_steps, n_paths, path_offset, bound, partials)
  if (rounds == 13) {
    MC_BATES_LAUNCH(13);
  } else if (rounds == 20) {
    MC_BATES_LAUNCH(20);
  } else {
    return cudaErrorInvalidValue;
  }
#undef MC_BATES_LAUNCH
  return cudaGetLastError();
}

// The QE kernel's launch and occupancy (bates_qe_kernels.cu).
cudaError_t launch_bates_qe(int payoff_id, int rounds, int antithetic, uint32_t k0,
                            uint32_t k1, const float* params, int kmax, int n_steps,
                            uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                            double* partials, int n_blocks, cudaStream_t stream);
cudaError_t bates_qe_occupancy(int antithetic, int* blocks);

}  // namespace mc

extern "C" {

// The partials kernels' paths a block (their grid: ceil(n_paths / it),
// capped).
int mc_bates_block_paths() { return mc::kBatesThreads; }

// Resident blocks per SM of the partials kernel of a scheme (VanillaCall,
// threefry-13).
int mc_bates_occupancy(int qe, int antithetic, int* blocks) {
  if (qe) return mc::bates_qe_occupancy(antithetic, blocks);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mc::bates_partials_kernel<mc::VanillaCall, mc::BatesEuler, 13>,
      mc::kBatesThreads, 0);
}

int mc_bates_partials(int payoff_id, int qe, int rounds, int antithetic, uint32_t k0,
                      uint32_t k1, const float* params, int kmax, int n_steps,
                      uint32_t n_paths, uint32_t path_offset, uint32_t bound, double* partials,
                      int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kmax < 1 || kmax > 256) return cudaErrorInvalidValue;
  if (qe) {
    return mc::launch_bates_qe(payoff_id, rounds, antithetic, k0, k1, params, kmax, n_steps,
                               n_paths, path_offset, bound, partials, n_blocks, s);
  }
#define MC_CASE(ID, PAYOFF)                                                         \
  case mc::ID:                                                                      \
    return mc::launch_bates_euler<mc::PAYOFF>(rounds, antithetic, k0, k1, params,   \
                                              kmax, n_steps, n_paths, path_offset,  \
                                              bound, partials, n_blocks, s);
  switch (payoff_id) {
    MC_HESTON_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;  // the bridge barriers read sigma
  }
#undef MC_CASE
}

}  // extern "C"
