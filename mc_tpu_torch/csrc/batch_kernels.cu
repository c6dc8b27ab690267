// Many payoffs on one set of paths, kernels 6 and 7 of the port, for sm_90a.
//
// ladder_kernel replaces mc_tpu/ops/path_kernels.py simulate_ladder_partials
// (the Pallas call at :648): each path is simulated once (the exact terminal
// draw or the log-Euler loop, both antithetic legs from one draw), then M
// strikes are evaluated by Payoff::terminal with p.k swapped for strikes[m]
// (mc_tpu :606-627).  partials[block, m, :] = [sum pay, sum pay^2].
//
// book_kernel replaces simulate_book_partials (the Pallas call at :778): B
// contracts, each with its own (15,) parameter row, priced on the same draws
// (common random numbers).  As mc_tpu fills a VMEM buffer once per tile and
// replays it for every contract (:688-716), each thread writes its path's
// 2 * n_pairs normals once into dynamic shared memory and replays them for
// every contract, so the book pays the threefry + Box-Muller cost once, not
// B times; only the antithetic leg negates the replayed draws.  The buffer is
// [2*pair + half][thread], so the 32 lanes of a warp touch 32 consecutive
// words (distinct banks).  partials[block, b, :] holds the contract's 2 or 5
// moments (with the control variate: x, x^2, pay*x).
//
// Accumulators: M strikes (or B contracts x 2 or 5 moments) are a runtime
// count, too many for the fixed per-thread register array of the
// grid-stride kernels.  Both kernels therefore take one path per thread,
// cdiv(n_paths, threads) blocks, and after the simulation one block
// reduction per strike or contract (reduce.cuh); the order of every sum is
// fixed by the path count alone.  Both simulate each leg with the simulate
// kernel's simulate_path and finish it with its path_payoff and add_moments
// (payoffs.cuh, reduce.cuh), so a path's payoff is bitwise the same in all
// three.  Up to 2^21 paths (ops/_cuda.py MAX_BLOCKS x 256) simulate_kernel
// does not grid-stride either, its blocks are the ladder's and (at 256
// threads, up to 216 steps) the book's, and strike m's or contract b's rows
// are bitwise those of simulate_partials at that strike or contract; above
// that its threads take several paths each and the sums agree to f64
// rounding.
//
// The book's buffer is 8 * n_pairs bytes per thread: 400 B at 100 steps.  The
// wrapper picks the block (256, 128, 64 or 32 threads) so that the buffer and
// the reduction's 10 KB fit the 227 KB a block may hold; above 48 KB the
// launch raises the kernel's dynamic shared memory limit first.  This is the
// port's counterpart of book_tile_rows (:794-803).
//
// What bounds them on the H100: bytes do not matter (60 bytes of parameters
// per strike or contract in, one row per block out).  The ladder is the
// simulate kernel's work plus M terminal evaluations per path.  The book's
// step loop runs B times per path on replayed draws: one expf (the special
// function unit, 16 lanes per SM per clock) and one shared-memory load per
// contract-step, so the transcendentals bind (1.6 ms for 64 contracts x 2^20
// paths x 100 steps), above the shared-memory reads (0.8 ms) and the RNG
// (about 0.2 ms, paid once).  Float contraction is off in the build
// (--fmad=false), so each mul and add rounds as in the plain version.

#include <cstdint>

#include <cuda_runtime.h>

#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kLadderThreads = 256;
constexpr int kBookMaxThreads = 256;
constexpr int kBatchRounds = 13;  // price_ladder/price_portfolio: threefry-13

template <class Payoff>
__global__ void __launch_bounds__(kLadderThreads)
ladder_kernel(int euler, int antithetic, uint32_t k0, uint32_t k1,
              const float* __restrict__ params, const float* __restrict__ strikes,
              int n_strikes, int n_steps, uint32_t n_paths, uint32_t path_offset,
              uint32_t bound, double* __restrict__ partials) {
  const Params p = load_params(params);
  const uint32_t i = blockIdx.x * kLadderThreads + threadIdx.x;  // one path per thread
  const uint32_t id = path_offset + i;
  const bool valid = i < n_paths && id < bound;
  const PathEnd<Payoff> e = simulate_path<Payoff>(
      p, euler, antithetic, p.s0, Payoff::init(p), 0, n_steps, 0.0f,
      [&](int m, float& z0, float& z1) {
        normal_pair<kBatchRounds>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
      });
  for (int m = 0; m < n_strikes; ++m) {
    Params pm = p;
    pm.k = strikes[m];
    float pay, x;  // x unused: the ladder has no control variate
    path_payoff<Payoff>(pm, e, antithetic, 1.0f, 1.0f, pay, x);
    double acc[2] = {0.0, 0.0};
    add_moments(acc, pay, x, valid, false);
    block_store_moments<2, kLadderThreads>(
        acc, partials + 2 * (static_cast<size_t>(blockIdx.x) * n_strikes + m), 2);
  }
}

template <class Payoff>
__global__ void __launch_bounds__(kBookMaxThreads)
book_kernel(int euler, int antithetic, int with_cv, uint32_t k0, uint32_t k1,
            const float* __restrict__ params_rows, int n_contracts, int n_steps,
            uint32_t n_paths, uint32_t path_offset, uint32_t bound,
            double* __restrict__ partials, int n_mom) {
  extern __shared__ float zbuf[];  // [2 * pair + half][thread]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const uint32_t i = blockIdx.x * nt + tid;  // one path per thread
  const uint32_t id = path_offset + i;
  const bool valid = i < n_paths && id < bound;
  const int n_pairs = euler ? (n_steps + 1) / 2 : 1;
  for (int m = 0; m < n_pairs; ++m) {
    float z0, z1;
    normal_pair<kBatchRounds>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
    zbuf[(2 * m) * nt + tid] = z0;
    zbuf[(2 * m + 1) * nt + tid] = z1;
  }
  // A thread replays only its own column: no barrier needed.
  auto draw_pair = [&](int m, float& z0, float& z1) {
    z0 = zbuf[(2 * m) * nt + tid];
    z1 = zbuf[(2 * m + 1) * nt + tid];
  };
  for (int b = 0; b < n_contracts; ++b) {
    const Params p = load_params(params_rows + static_cast<size_t>(kParamFields) * b);
    const PathEnd<Payoff> e = simulate_path<Payoff>(p, euler, antithetic, p.s0,
                                                    Payoff::init(p), 0, n_steps, 0.0f,
                                                    draw_pair);
    float pay, x;
    path_payoff<Payoff>(p, e, antithetic, 1.0f, 1.0f, pay, x);
    double acc[kMaxMoments] = {0.0, 0.0, 0.0, 0.0, 0.0};
    add_moments(acc, pay, x, valid, with_cv);
    block_store_moments<kMaxMoments, kBookMaxThreads>(
        acc, partials + static_cast<size_t>(n_mom) * (static_cast<size_t>(blockIdx.x) * n_contracts + b),
        n_mom);
  }
}

template <class Payoff>
cudaError_t launch_ladder(int euler, int antithetic, uint32_t k0, uint32_t k1,
                          const float* params, const float* strikes, int n_strikes,
                          int n_steps, uint32_t n_paths, uint32_t path_offset,
                          uint32_t bound, double* partials, int n_blocks,
                          cudaStream_t stream) {
  ladder_kernel<Payoff><<<n_blocks, kLadderThreads, 0, stream>>>(
      euler, antithetic, k0, k1, params, strikes, n_strikes, n_steps, n_paths,
      path_offset, bound, partials);
  return cudaGetLastError();
}

template <class Payoff>
cudaError_t launch_book(int euler, int antithetic, int with_cv, uint32_t k0, uint32_t k1,
                        const float* params_rows, int n_contracts, int n_steps,
                        uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                        int threads, double* partials, int n_mom, int n_blocks,
                        cudaStream_t stream) {
  const int n_pairs = euler ? (n_steps + 1) / 2 : 1;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(n_pairs) * threads;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        book_kernel<Payoff>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  book_kernel<Payoff><<<n_blocks, threads, smem, stream>>>(
      euler, antithetic, with_cv, k0, k1, params_rows, n_contracts, n_steps, n_paths,
      path_offset, bound, partials, n_mom);
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_ladder_block_threads() { return mc::kLadderThreads; }

int mc_ladder_partials(int payoff_id, int euler, int antithetic, uint32_t k0, uint32_t k1,
                       const float* params, const float* strikes, int n_strikes,
                       int n_steps, uint32_t n_paths, uint32_t path_offset,
                       uint32_t bound, double* partials, int n_blocks, void* stream) {
  if (n_strikes < 1 || static_cast<uint64_t>(n_blocks) * mc::kLadderThreads < n_paths) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_CASE(ID, PAYOFF)                                                        \
  case mc::ID:                                                                     \
    return mc::launch_ladder<mc::PAYOFF>(euler, antithetic, k0, k1, params, strikes, \
                                         n_strikes, n_steps, n_paths, path_offset,  \
                                         bound, partials, n_blocks, s);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

int mc_book_partials(int payoff_id, int euler, int antithetic, int with_cv, uint32_t k0,
                     uint32_t k1, const float* params_rows, int n_contracts, int n_steps,
                     uint32_t n_paths, uint32_t path_offset, uint32_t bound, int threads,
                     double* partials, int n_mom, int n_blocks, void* stream) {
  const bool pow2 = threads >= 32 && threads <= mc::kBookMaxThreads &&
                    (threads & (threads - 1)) == 0;
  if (!pow2 || n_contracts < 1 ||
      static_cast<uint64_t>(n_blocks) * threads < n_paths) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_CASE(ID, PAYOFF)                                                         \
  case mc::ID:                                                                      \
    return mc::launch_book<mc::PAYOFF>(euler, antithetic, with_cv, k0, k1,          \
                                       params_rows, n_contracts, n_steps, n_paths,  \
                                       path_offset, bound, threads, partials, n_mom, \
                                       n_blocks, s);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
