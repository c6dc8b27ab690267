// Many payoffs on one set of paths, kernels 6 and 7 of the port, for sm_90a.
//
// ladder_kernel replaces mc_tpu/ops/path_kernels.py simulate_ladder_partials
// (the Pallas call at :648): each path is simulated once (the exact terminal
// draw or the log-Euler loop, both antithetic legs from one draw), then M
// strikes are evaluated by Payoff::terminal with p.k swapped for strikes[m]
// (mc_tpu :606-627).  partials[block, m, :] = [sum pay, sum pay^2].  A block
// sums kLadderBlockPaths = 256 paths, block b paths b*256 .. b*256+255: its
// 256 / P threads each run P of them in lockstep (thread t paths t, t + T,
// .. t + (P-1)T, T the block's threads; P by mode, ladder_paths: a kernel a
// mode, the terminal one for the six payoffs without state only), each
// path's M payoffs evaluated once, the strikes read
// once a block by uniform loads, R a pass (as many as kLadderPassBytes of
// rows hold).  A pass's rows (R strikes x 2 moments) reduce together: the
// lanes add as the one-path-a-thread kernel's 256-thread tree added its
// threads t + pT, then the T threads' levels down to 64 in shared memory,
// one barrier a level for all the pass's rows, and the level of 32 and the
// warp's levels 16 .. 1 (__shfl_down_sync) take the rows a warp each: every
// row keeps the old tree's order, bit for bit, and a block waits at a few
// barriers a pass (3 at 128 threads) where the tree took 9 a strike.
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
// grid-stride kernels.  Both kernels therefore take a block's paths once
// (the ladder 256, P a thread; the book one a thread), cdiv(n_paths, paths a
// block) blocks, and reduce the strikes or contracts a pass at a time, in
// reduce.cuh's tree order; the order of every sum is fixed by the path
// count alone.  A path's payoff is
// bitwise the simulate kernel's (simulate_path, path_payoff, add_moments;
// payoffs.cuh, reduce.cuh).  Up to 2^21 paths (ops/_cuda.py MAX_BLOCKS x
// 256) simulate_kernel does not grid-stride either, its blocks are the
// ladder's and (at 256 threads, up to 216 steps) the book's, and strike m's
// or contract b's rows are bitwise those of simulate_partials at that
// strike or contract; above that its threads take several paths each and
// the sums agree to f64 rounding.
//
// The book's buffer is 8 * n_pairs bytes per thread: 400 B at 100 steps.  The
// wrapper picks the block (256, 128, 64 or 32 threads) so that the buffer and
// the kernel's static 10 KB (the reduction's rows and a chunk's thresholds)
// fit the 227 KB a block may hold; above 48 KB the launch raises the
// kernel's dynamic shared memory limit first.  This is the port's
// counterpart of book_tile_rows (:794-803).  At 100 steps the buffer holds
// the SM to 2 blocks of 256 threads.
//
// What bounds them on the H100: bytes do not matter (60 bytes of parameters
// per strike or contract in, one row per block out).  The ladder is the
// simulate kernel's work plus M terminal evaluations per path: by the
// terminal draw a threefry-13 pair and an expf a path, so at M = 17 the
// one-path-a-thread kernel's 17 trees of 9 barriers were its time; its
// design takes them out (above).  The book's
// step loop runs B times per path on replayed draws, so it is issue-bound
// on that loop; its design takes the work out of it:
// - a payoff that reads S only through S < B (the bullet, the up-and-out
//   and the down-and-in calls) tests the log-price w against the contract's
//   threshold (below_max_all, barrier.cuh: one bisection per contract and
//   block, by the threads of its chunk), and a terminal-only payoff steps w
//   alone; both form S = s0 * expf(w) once, at maturity, bitwise the last
//   step's S.  A step is then ~5 f32 operations, no expf (each step's expf
//   was about half of the loop's issued instructions);
// - a thread steps 8 contracts (4 where the payoff reads S at each step) on
//   each replayed normal, one shared-memory load for them, with their
//   parameters in registers;
// - each group's rows reduce over the book's 2 or 5 moments, up to 3
//   contracts a pass (4 barriers: the halves, then warp 0's shuffles)
//   where one contract of 5 rows took 9.
// The bound is f32 issue: 0.51 ms for 64 contracts x 2^20 paths x 100 steps
// (chip_smoke.py phase 6), the RNG 0.16 ms (int32, paid once).  Float
// contraction is off in the build (--fmad=false), so each mul and add
// rounds as in the plain version.

#include <cstdint>

#include <cuda_runtime.h>

#include "barrier.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kBookMaxThreads = 256;
constexpr int kBatchRounds = 13;  // price_ladder/price_portfolio: threefry-13

// The ladder's paths a block: the one-path-a-thread kernel's threads, so each
// row keeps that kernel's tree.
constexpr int kLadderBlockPaths = 256;
// Paths a thread in lockstep, by the terminal draw (a straight-line path:
// the six payoffs without state) and by the log-Euler loop (swept on the
// H100, family_nmc_probe.py --gbm --kernels ladder, PERF.md §6).
constexpr int kLadderTerminalPaths = 4;
constexpr int kLadderEulerPaths = 1;
__host__ __device__ constexpr int ladder_paths(bool euler) {
  return euler ? kLadderEulerPaths : kLadderTerminalPaths;
}
// The shared bytes of a pass's rows: a pass takes as many strikes as 2 f64
// rows of the block's T threads each fit (8 at 128 threads, 4 at 256).
constexpr int kLadderPassBytes = 16 * 1024;
template <int T>
__host__ __device__ constexpr int ladder_strikes() {
  return kLadderPassBytes / (2 * T * static_cast<int>(sizeof(double)));
}

// Each block: its paths' legs (each lane's simulate_path, payoffs.cuh, the
// simulate kernel's leg: path q of the thread draws id[q]), then per pass
// of R strikes each thread's rows into shared memory, sh[2r + m][t] for
// strike r0 + r and moment m
// (its lanes' f64 [pay, pay^2], each from zero as add_moments adds them,
// folded: lane q holds the tree's thread t + qT, and lanes q and q + h add
// at its level hT), one barrier, then block_store_moments' levels s = T/2
// .. 64 in place (sh[row][c] += sh[row][c + s], the 2R*s adds of a level
// spread over all T threads, a barrier each), and the level of 32 and the
// warp's shuffles a row a warp: lane l of warp w adds sh[row][l] and
// sh[row][l + 32] for rows w, w + T/32, .., then __shfl_down_sync by 16 ..
// 1, lane 0 storing the row.  A pass after the first waits at a barrier of
// its own for the last pass's readers.  Only a pass's strikes are evaluated
// and stored (a ragged last pass is shorter).
template <class Payoff, bool EULER>
__global__ void __launch_bounds__(kLadderBlockPaths / ladder_paths(EULER))
ladder_kernel(int antithetic, uint32_t k0, uint32_t k1, const float* __restrict__ params,
              const float* __restrict__ strikes, int n_strikes, int n_steps,
              uint32_t n_paths, uint32_t path_offset, uint32_t bound,
              double* __restrict__ partials) {
  constexpr int P = ladder_paths(EULER);
  constexpr int T = kLadderBlockPaths / P;
  constexpr int R = ladder_strikes<T>();
  static_assert(T >= 64 && (T & (T - 1)) == 0 && R >= 1,
                "a power of two of at least two warps, a strike a pass");
  __shared__ double sh[2 * R][T];
  const int t = threadIdx.x;
  const Params p = load_params(params);
  uint32_t id[P];
  bool valid[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const uint32_t i = blockIdx.x * kLadderBlockPaths + q * T + t;
    id[q] = path_offset + i;
    valid[q] = i < n_paths && id[q] < bound;
  }
  PathEnd<Payoff> e[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    e[q] = simulate_path<Payoff>(
        p, EULER, antithetic, p.s0, Payoff::init(p), 0, n_steps, 0.0f,
        [&](int m, float& z0, float& z1) {
          normal_pair<kBatchRounds>(k0, k1, id[q], static_cast<uint32_t>(m), z0, z1);
        });
  }
  for (int r0 = 0; r0 < n_strikes; r0 += R) {  // block-uniform
    const int n_pass = min(R, n_strikes - r0);
    if (r0 > 0) __syncthreads();  // the last pass's readers are done
    for (int r = 0; r < n_pass; ++r) {  // a runtime loop: unrolled over R it ran slower
      Params pm = p;
      pm.k = __ldg(strikes + r0 + r);
      double lane[P][2];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float pay, x;  // x unused: the ladder has no control variate
        path_payoff<Payoff>(pm, e[q], antithetic, 1.0f, 1.0f, pay, x);
        lane[q][0] = lane[q][1] = 0.0;
        add_moments(lane[q], pay, x, valid[q], false);
      }
#pragma unroll
      for (int h = P / 2; h >= 1; h /= 2) {
#pragma unroll
        for (int q = 0; q < h; ++q) {
          lane[q][0] += lane[q + h][0];
          lane[q][1] += lane[q + h][1];
        }
      }
      sh[2 * r][t] = lane[0][0];
      sh[2 * r + 1][t] = lane[0][1];
    }
    __syncthreads();
#pragma unroll
    for (int s = T / 2; s >= 64; s /= 2) {
      for (int i = t; i < 2 * n_pass * s; i += T) {
        const int row = i / s, c = i % s;
        sh[row][c] = sh[row][c] + sh[row][c + s];
      }
      __syncthreads();
    }
    double* out = partials + 2 * (static_cast<size_t>(blockIdx.x) * n_strikes + r0);
    const int lane = t & 31;
    for (int row = t >> 5; row < 2 * n_pass; row += T / 32) {
      double x = sh[row][lane] + sh[row][lane + 32];
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) x = x + __shfl_down_sync(0xFFFFFFFFu, x, s);
      if (lane == 0) out[row] = x;
    }
  }
}

// The book's contracts a thread steps in lockstep on each replayed draw:
// 8, or 4 where the payoff reads the spot at each step (at 8 the
// Brownian-bridge barriers' and the cliquet's states took 163-181
// registers, over the 128 that 2 blocks an SM leave).  Swept on the H100
// (family_nmc_probe.py --gbm, PERF.md): book64 bullet 2.91 / 2.24 / 2.22 /
// 1.99 ms at 1 / 2 / 4 / 8.  A last group of
// n_contracts % C runs its missing contracts as copies of the chunk's last
// one, through the same code, and stores no rows for them.
template <class Payoff>
constexpr int kBookContracts = kStateRead<Payoff> == StateRead::kSpot ? 4 : 8;
// The block reduction's rows a pass (contracts of n_mom rows each, 3 or 1)
// and its two ping-pong halves: levels nt/2, nt/8, ... write the first (128
// doubles a row), levels nt/4, nt/16, ... the second (64).  With the
// chunk's thresholds that is 10 KB, the book_block_threads budget
// (ops/path_kernels.py BOOK_REDUCE_BYTES).
constexpr int kBookRows = 6;
constexpr int kBookHalfA = kBookMaxThreads / 2;
constexpr int kBookHalfB = kBookMaxThreads / 4;

// C contracts' legs on the thread's replayed draws, each bitwise the
// simulate kernel's simulate_path (Euler, no shift, no resume): w steps as
// euler_step steps it.  by_w: S = s0 * expf(w) only where the payoff reads
// it (leg_step: a kNone leg steps w alone, a kBarrier leg tests w <=
// below_max[c], a kSpot leg forms S at each step), then once at the end;
// else (a contract with s0 < 0, where the threshold is not exact) euler_step
// at each step.  Per step the C contracts' + legs, then their - legs.
template <class Payoff, int C, bool by_w, class DrawPair>
__device__ __forceinline__ void book_legs(const Params (&p)[C], const float (&below_max)[C],
                                          bool antithetic, int n_steps, DrawPair draw_pair,
                                          PathEnd<Payoff> (&e)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    e[c] = PathEnd<Payoff>{0.0f, p[c].s0, 0.0f, p[c].s0, Payoff::init(p[c]),
                           Payoff::init(p[c])};
  }
  for_each_draw(0, n_steps, draw_pair, [&](float z) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if constexpr (by_w) {
        leg_step<Payoff>(p[c], p[c].s0, below_max[c], z, e[c].w, e[c].s, e[c].st);
      } else {
        euler_step<Payoff>(p[c], p[c].s0, z, e[c].w, e[c].s, e[c].st);
      }
    }
    if (antithetic) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if constexpr (by_w) {
          leg_step<Payoff>(p[c], p[c].s0, below_max[c], -z, e[c].wn, e[c].sn, e[c].stn);
        } else {
          euler_step<Payoff>(p[c], p[c].s0, -z, e[c].wn, e[c].sn, e[c].stn);
        }
      }
    }
  });
  if constexpr (by_w && kStateRead<Payoff> != StateRead::kSpot) {
    if (n_steps > 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        e[c].s = p[c].s0 * expf(e[c].w);
        if (antithetic) e[c].sn = p[c].s0 * expf(e[c].wn);
      }
    }
  }
}

// Store the rows acc[c][0..N) of contracts c < n_valid at out + c*N, each
// the sum over the block's nt threads in block_store_moments' tree (level
// s: thread t < s adds thread t+s's value to its own), kBookRows / N
// contracts a pass.  A level above 16 goes through shared memory (its upper
// half written, its lower half reading), the ping-pong halves alternating
// so that one barrier a level suffices; the levels 16 .. 1 are warp 0's
// __shfl_down_sync adds, the same operands in the same order.  Every
// thread of the block calls it.
template <int C, int N>
__device__ __forceinline__ void book_store(double (&acc)[C][N], int n_valid, double* out) {
  constexpr int kPerPass = kBookRows / N;
  __shared__ double halves[kBookRows][kBookHalfA + kBookHalfB];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
#pragma unroll
  for (int cp = 0; cp < C; cp += kPerPass) {
    if (cp >= n_valid) break;  // block-uniform
    __syncthreads();  // the last pass's readers are done with the halves
    int half = 0;  // the offset of the level's half in a row
    for (int s = nt / 2; s > 16; s /= 2, half = kBookHalfA - half) {
      if (tid >= s && tid < 2 * s) {
#pragma unroll
        for (int c = cp; c < cp + kPerPass && c < C; ++c) {
#pragma unroll
          for (int m = 0; m < N; ++m) halves[(c - cp) * N + m][half + tid - s] = acc[c][m];
        }
      }
      __syncthreads();
      if (tid < s) {
#pragma unroll
        for (int c = cp; c < cp + kPerPass && c < C; ++c) {
#pragma unroll
          for (int m = 0; m < N; ++m) {
            acc[c][m] = acc[c][m] + halves[(c - cp) * N + m][half + tid];
          }
        }
      }
    }
    if (tid < 32) {
#pragma unroll
      for (int s = 16; s > 0; s /= 2) {
#pragma unroll
        for (int c = cp; c < cp + kPerPass && c < C; ++c) {
#pragma unroll
          for (int m = 0; m < N; ++m) {
            acc[c][m] = acc[c][m] + __shfl_down_sync(0xFFFFFFFFu, acc[c][m], s);
          }
        }
      }
      if (tid == 0) {
#pragma unroll
        for (int c = cp; c < cp + kPerPass && c < C; ++c) {
          if (c < n_valid) {
#pragma unroll
            for (int m = 0; m < N; ++m) out[c * N + m] = acc[c][m];
          }
        }
      }
    }
  }
}

template <class Payoff, bool CV>
__global__ void __launch_bounds__(kBookMaxThreads, 2)
book_kernel(int euler, int antithetic, uint32_t k0, uint32_t k1,
            const float* __restrict__ params_rows, int n_contracts, int n_steps,
            uint32_t n_paths, uint32_t path_offset, uint32_t bound,
            double* __restrict__ partials) {
  constexpr int C = kBookContracts<Payoff>;
  constexpr int N = CV ? kMaxMoments : 2;  // [pay, pay^2] (and x, x^2, pay*x)
  constexpr bool kThreshold = kStateRead<Payoff> == StateRead::kBarrier;
  extern __shared__ float zbuf[];  // [2 * pair + half][thread]
  __shared__ float below_max_s[kThreshold ? kBookMaxThreads : 1];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const uint32_t i = blockIdx.x * nt + tid;  // one path per thread
  const uint32_t id = path_offset + i;
  const bool valid = i < n_paths && id < bound;
  const int n_pairs = euler ? (n_steps + 1) / 2 : 1;
  // A chunk's thresholds, one contract a thread: the chunk is the next nt
  // contracts (all of them unless the book has more than nt).  w <= the
  // threshold exactly when s0 * expf(w) < barrier, where s0 is not below 0.
  auto thresholds = [&](int c0) {
    if constexpr (kThreshold) {
      if (tid < n_contracts - c0) {
        const Params p = load_params(params_rows + kParamFields * (c0 + tid));
        below_max_s[tid] = below_max_all(p.s0, p.barrier);
      }
    }
  };
  thresholds(0);
  for (int m = 0; m < n_pairs; ++m) {
    float z0, z1;
    normal_pair<kBatchRounds>(k0, k1, id, static_cast<uint32_t>(m), z0, z1);
    zbuf[(2 * m) * nt + tid] = z0;
    zbuf[(2 * m + 1) * nt + tid] = z1;
  }
  if constexpr (kThreshold) __syncthreads();
  // A thread replays only its own column: no barrier needed.
  auto draw_pair = [&](int m, float& z0, float& z1) {
    z0 = zbuf[(2 * m) * nt + tid];
    z1 = zbuf[(2 * m + 1) * nt + tid];
  };
  for (int c0 = 0; c0 < n_contracts; c0 += nt) {
    const int n_chunk = min(nt, n_contracts - c0);
    if (c0 > 0 && kThreshold) {  // every thread is past the last chunk's reads
      thresholds(c0);
      __syncthreads();
    }
    for (int g = 0; g < n_chunk; g += C) {
      Params p[C];
      float below_max[C];
      bool by_w = true;  // no threshold group holds a contract with s0 < 0
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int local = min(g + c, n_chunk - 1);
        p[c] = load_params(params_rows + static_cast<size_t>(kParamFields) * (c0 + local));
        below_max[c] = kThreshold ? below_max_s[local] : 0.0f;
        by_w = by_w && !(kThreshold && p[c].s0 < 0.0f);
      }
      PathEnd<Payoff> e[C];
      if (!euler) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          e[c] = simulate_path<Payoff>(p[c], false, antithetic, p[c].s0, Payoff::init(p[c]),
                                       0, n_steps, 0.0f, draw_pair);
        }
      } else if (by_w) {
        book_legs<Payoff, C, true>(p, below_max, antithetic, n_steps, draw_pair, e);
      } else if constexpr (kThreshold) {
        book_legs<Payoff, C, false>(p, below_max, antithetic, n_steps, draw_pair, e);
      }
      double acc[C][N];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float pay, x;
        path_payoff<Payoff>(p[c], e[c], antithetic, 1.0f, 1.0f, pay, x);
#pragma unroll
        for (int m = 0; m < N; ++m) acc[c][m] = 0.0;
        add_moments(acc[c], pay, x, valid, CV);
      }
      book_store<C, N>(acc, n_chunk - g,
                       partials + static_cast<size_t>(N) *
                                      (static_cast<size_t>(blockIdx.x) * n_contracts + c0 + g));
    }
  }
}

template <class Payoff, bool EULER>
cudaError_t launch_ladder(int antithetic, uint32_t k0, uint32_t k1, const float* params,
                          const float* strikes, int n_strikes, int n_steps, uint32_t n_paths,
                          uint32_t path_offset, uint32_t bound, double* partials,
                          int n_blocks, cudaStream_t stream) {
  ladder_kernel<Payoff, EULER><<<n_blocks, kLadderBlockPaths / ladder_paths(EULER), 0, stream>>>(
      antithetic, k0, k1, params, strikes, n_strikes, n_steps, n_paths, path_offset, bound,
      partials);
  return cudaGetLastError();
}

// The payoff's kernel of the mode: Euler, or the terminal draw for a payoff
// without state (a path-dependent payoff has no terminal kernel).
template <class Payoff>
cudaError_t ladder_switch(int euler, int antithetic, uint32_t k0, uint32_t k1,
                          const float* params, const float* strikes, int n_strikes,
                          int n_steps, uint32_t n_paths, uint32_t path_offset,
                          uint32_t bound, double* partials, int n_blocks,
                          cudaStream_t stream) {
  if (euler)
    return launch_ladder<Payoff, true>(antithetic, k0, k1, params, strikes, n_strikes,
                                       n_steps, n_paths, path_offset, bound, partials,
                                       n_blocks, stream);
  if constexpr (Payoff::kStates == 0)
    return launch_ladder<Payoff, false>(antithetic, k0, k1, params, strikes, n_strikes,
                                        n_steps, n_paths, path_offset, bound, partials,
                                        n_blocks, stream);
  return cudaErrorInvalidValue;
}

template <class Payoff>
cudaError_t ladder_occupancy(int euler, int* blocks) {
  if (euler)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ladder_kernel<Payoff, true>, kLadderBlockPaths / ladder_paths(true), 0);
  if constexpr (Payoff::kStates == 0)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ladder_kernel<Payoff, false>, kLadderBlockPaths / ladder_paths(false), 0);
  return cudaErrorInvalidValue;
}

// The book kernel's dynamic shared memory (the normal buffer), with the
// kernel's limit raised to it where it is above the default 48 KB.
template <class Payoff, bool CV>
cudaError_t book_smem(int euler, int n_steps, int threads, size_t* smem) {
  const int n_pairs = euler ? (n_steps + 1) / 2 : 1;
  *smem = 2 * sizeof(float) * static_cast<size_t>(n_pairs) * threads;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(book_kernel<Payoff, CV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <class Payoff, bool CV>
cudaError_t launch_book(int euler, int antithetic, uint32_t k0, uint32_t k1,
                        const float* params_rows, int n_contracts, int n_steps,
                        uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                        int threads, double* partials, int n_blocks, cudaStream_t stream) {
  size_t smem;
  const cudaError_t err = book_smem<Payoff, CV>(euler, n_steps, threads, &smem);
  if (err != cudaSuccess) return err;
  book_kernel<Payoff, CV><<<n_blocks, threads, smem, stream>>>(
      euler, antithetic, k0, k1, params_rows, n_contracts, n_steps, n_paths, path_offset,
      bound, partials);
  return cudaGetLastError();
}

// The resident blocks per SM of the book kernel (no control variate) at a
// shape.
template <class Payoff>
cudaError_t book_occupancy(int euler, int n_steps, int threads, int* blocks) {
  size_t smem;
  const cudaError_t err = book_smem<Payoff, false>(euler, n_steps, threads, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, book_kernel<Payoff, false>,
                                                       threads, smem);
}

}  // namespace mc

extern "C" {

// The ladder's paths a block (its grid: ceil(n_paths / it)), and by mode
// (euler 0: the terminal draw, the six payoffs without state; 1) its paths a
// thread and strikes a pass.
int mc_ladder_block_paths() { return mc::kLadderBlockPaths; }
int mc_ladder_paths_per_thread(int euler) { return mc::ladder_paths(euler != 0); }
int mc_ladder_strikes_per_pass(int euler) {
  return euler ? mc::ladder_strikes<mc::kLadderBlockPaths / mc::ladder_paths(true)>()
               : mc::ladder_strikes<mc::kLadderBlockPaths / mc::ladder_paths(false)>();
}

// Resident blocks per SM of a payoff's kernel of the mode.
int mc_ladder_occupancy(int payoff_id, int euler, int* blocks) {
#define MC_CASE(ID, PAYOFF) \
  case mc::ID: return mc::ladder_occupancy<mc::PAYOFF>(euler, blocks);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

int mc_ladder_partials(int payoff_id, int euler, int antithetic, uint32_t k0, uint32_t k1,
                       const float* params, const float* strikes, int n_strikes,
                       int n_steps, uint32_t n_paths, uint32_t path_offset,
                       uint32_t bound, double* partials, int n_blocks, void* stream) {
  if (n_strikes < 1 ||
      static_cast<uint64_t>(n_blocks) * mc::kLadderBlockPaths < n_paths) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_CASE(ID, PAYOFF)                                                        \
  case mc::ID:                                                                     \
    return mc::ladder_switch<mc::PAYOFF>(euler, antithetic, k0, k1, params, strikes, \
                                         n_strikes, n_steps, n_paths, path_offset,  \
                                         bound, partials, n_blocks, s);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

// The contracts a thread steps on each replayed draw, for a payoff.
int mc_book_contracts(int payoff_id) {
#define MC_CASE(ID, PAYOFF) \
  case mc::ID: return mc::kBookContracts<mc::PAYOFF>;
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return -1;
  }
#undef MC_CASE
}

int mc_book_occupancy(int payoff_id, int euler, int n_steps, int threads, int* blocks) {
#define MC_CASE(ID, PAYOFF) \
  case mc::ID: return mc::book_occupancy<mc::PAYOFF>(euler, n_steps, threads, blocks);
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
  if (!pow2 || n_contracts < 1 || n_mom != (with_cv ? mc::kMaxMoments : 2) ||
      static_cast<uint64_t>(n_blocks) * threads < n_paths) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MC_CASE(ID, PAYOFF)                                                               \
  case mc::ID:                                                                            \
    return with_cv ? mc::launch_book<mc::PAYOFF, true>(euler, antithetic, k0, k1,         \
                                                       params_rows, n_contracts, n_steps, \
                                                       n_paths, path_offset, bound,       \
                                                       threads, partials, n_blocks, s)    \
                   : mc::launch_book<mc::PAYOFF, false>(euler, antithetic, k0, k1,        \
                                                        params_rows, n_contracts,         \
                                                        n_steps, n_paths, path_offset,    \
                                                        bound, threads, partials,         \
                                                        n_blocks, s);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
