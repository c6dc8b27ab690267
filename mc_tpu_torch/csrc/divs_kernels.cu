// Cash-dividend kernel of the port, for sm_90a.
//
// divs_partials_kernel replaces mc_tpu/models/dividends.py _divs_partials
// (the Pallas call at :160): the level-space loop over step pairs, pair m =
// threefry-13 counter (id, m) feeding steps 2m and 2m+1 (divs.cuh: the exact
// GBM factor, then the cash drop D_j floored at 1e-6); the antithetic twin
// on the negated pair, averaged as 0.5*(a+b); paths at or past `bound` add
// zeros; each block writes one row of f64 [sum pay, sum pay^2] (reduce.cuh),
// no float atomics.  Every payoff of the registry, on the post-dividend
// path.
//
// A block sums kDivsTile = 256 paths, block b paths b*256 .. b*256+255,
// grid-strided, as the one-path-a-thread kernel it replaced did: its
// kDivsTile / P threads each run P of them in lockstep, thread t paths t,
// t + T, .. t + (P-1)T, each path's f64 sums in a lane of its own, the lanes
// added as the old block's tree added its threads t + pT, then the T
// threads' tree (reduce.cuh): every row keeps its bits.  An antithetic
// path's - leg is one more lockstep leg on the negated pair.
//
// The payment steps from a block table: before its paths the block lists
// in shared memory, ascending, the steps j whose amount is not +0 or -0
// (NaN and negative amounts pay like any other) and their amounts, then
// the sentinel n_steps (divs_table).  The step loop walks it: a step with
// no payment floors S at 1e-6 with no load and no subtract (the same bits:
// divs_step, divs.cuh), a payment step drops D_j as before, its amount read
// once for every leg.  A schedule of more than kDivsTableSteps steps keeps
// the load and the subtract at every step (chosen on the host, the same
// arithmetic).
//
// What bounds it on the H100: operations.  A step pair spends one threefry
// call and a Box-Muller pair, as GBM's log-Euler step, and per step 3 f32
// operations and an expf, 1 more (the drop) at a payment.  The head and
// amounts are 452 bytes at n_steps = 100; each block writes 16.

#include <cstdint>

#include <cuda_runtime.h>

#include "divs.cuh"
#include "payoffs.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kDivsTile = 256;

// Paths a thread in lockstep, plain and antithetic (an antithetic path's
// two legs each).
constexpr int kDivsPaths = 2;
constexpr int kDivsPathsAnti = 2;

// The longest schedule the block table holds: (n_steps + 1) step indices
// and amounts, 16,392 bytes of shared memory at 2,048 steps.
constexpr int kDivsTableSteps = 2048;

template <bool A>
__host__ __device__ constexpr int divs_thread_paths() {
  return A ? kDivsPathsAnti : kDivsPaths;
}

inline size_t divs_table_bytes(int n_steps) {
  return static_cast<size_t>(n_steps + 1) * (sizeof(int) + sizeof(float));
}

// The block's payment table: steps[0..n) the steps j < n_steps whose
// amount d[j] is not +-0, ascending, amounts[0..n) theirs, steps[n] =
// n_steps.  Every thread of the block calls it (blockDim.x a multiple of
// 32); each chunk of blockDim.x steps is compacted by its warps' ballots.
__device__ void divs_table(const float* __restrict__ d, int n_steps, int* steps,
                           float* amounts) {
  __shared__ int warp_n[kDivsTile / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int count = 0;
  for (int base = 0; base < n_steps; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const float dj = j < n_steps ? d[j] : 0.0f;
    const bool pays = (__float_as_uint(dj) << 1) != 0u;
    const unsigned ballot = __ballot_sync(0xffffffffu, pays);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int at = count + __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < n_warps; ++w) {
      at += w < warp ? warp_n[w] : 0;
      count += warp_n[w];
    }
    if (pays) {
      steps[at] = j;
      amounts[at] = dj;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) steps[count] = n_steps;
  __syncthreads();
}

// P paths (S = 2 legs each if antithetic) over n_steps: each path's payoff
// (the pair's mean).  kTable: the payments from the block table (steps,
// amounts); else every step loads D_j and subtracts it.
template <class Payoff, int P, bool A, bool kTable>
__device__ __forceinline__ void divs_paths(const DivsParams& c, const int* steps,
                                           const float* amounts, uint32_t k0, uint32_t k1,
                                           const uint32_t (&id)[P], int n_steps,
                                           float (&pay)[P]) {
  constexpr int S = A ? 2 : 1;  // leg p*S + s: path p, + (s = 0) or - (s = 1)
  constexpr int L = P * S;
  float s[L];
  typename Payoff::State st[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    s[l] = c.pay.s0;
    st[l] = Payoff::init(c.pay);
  }
  int q = 0;                         // the next payment's entry
  int next = kTable ? steps[0] : 0;  // and its step
  for (int m = 0; m < n_steps / 2; ++m) {
    float z[2][L];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      normal_pair<13>(k0, k1, id[p], static_cast<uint32_t>(m), z[0][p * S], z[1][p * S]);
      if constexpr (A) {
        z[0][p * S + 1] = -z[0][p * S];
        z[1][p * S + 1] = -z[1][p * S];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * m + h;
      if constexpr (kTable) {
        const bool pays = j == next;  // the same for every thread of the block
        float dj = 0.0f;
        if (pays) {
          dj = amounts[q];
          next = steps[++q];
        }
        divs_step<Payoff, L>(c, pays, dj, z[h], s, st);
      } else {
        divs_step<Payoff, L>(c, true, c.d[j], z[h], s, st);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    pay[p] = Payoff::terminal(st[p * S], s[p * S], c.pay);
    if constexpr (A) {
      pay[p] = 0.5f * (pay[p] + Payoff::terminal(st[p * S + 1], s[p * S + 1], c.pay));
    }
  }
}

// The partials kernel: block b sums paths b*kDivsTile + .., grid-strided, P
// a thread; paths at or past `bound` add zeros; one f64 row [sum pay, sum
// pay^2] a block.  kTable: the block table in divs_table_bytes(n_steps) of
// dynamic shared memory.
template <class Payoff, bool A, bool kTable>
__global__ void __launch_bounds__(kDivsTile / divs_thread_paths<A>())
divs_partials_kernel(uint32_t k0, uint32_t k1, const float* __restrict__ params, int n_steps,
                     uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                     double* __restrict__ partials) {
  constexpr int P = divs_thread_paths<A>();
  constexpr int T = kDivsTile / P;
  extern __shared__ int divs_smem[];
  const DivsParams c = load_divs(params);
  int* steps = divs_smem;
  float* amounts = reinterpret_cast<float*>(divs_smem + (kTable ? n_steps + 1 : 0));
  if constexpr (kTable) divs_table(c.d, n_steps, steps, amounts);
  double acc[P][2];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p][0] = acc[p][1] = 0.0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kDivsTile;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kDivsTile + threadIdx.x; i < n_paths;
       i += stride) {
    uint32_t id[P];
#pragma unroll
    for (int p = 0; p < P; ++p) id[p] = path_offset + static_cast<uint32_t>(i + p * T);
    float pay[P];
    divs_paths<Payoff, P, A, kTable>(c, steps, amounts, k0, k1, id, n_steps, pay);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float pv[1] = {pay[p]};
      add_moments(acc[p], pv, i + p * T < n_paths && id[p] < bound);
    }
  }
#pragma unroll
  for (int h = P / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int p = 0; p < h; ++p) {
      acc[p][0] += acc[p + h][0];
      acc[p][1] += acc[p + h][1];
    }
  }
  block_store_moments<2, T>(acc[0], partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Payoff, bool A>
cudaError_t launch_divs_partials(uint32_t k0, uint32_t k1, const float* params, int n_steps,
                                 uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                                 double* partials, int n_blocks, cudaStream_t stream) {
  constexpr int T = kDivsTile / divs_thread_paths<A>();
  if (n_steps <= kDivsTableSteps) {
    divs_partials_kernel<Payoff, A, true><<<n_blocks, T, divs_table_bytes(n_steps), stream>>>(
        k0, k1, params, n_steps, n_paths, path_offset, bound, partials);
  } else {
    divs_partials_kernel<Payoff, A, false><<<n_blocks, T, 0, stream>>>(
        k0, k1, params, n_steps, n_paths, path_offset, bound, partials);
  }
  return cudaGetLastError();
}

template <bool A>
cudaError_t divs_occupancy(int n_steps, int* blocks) {
  constexpr int T = kDivsTile / divs_thread_paths<A>();
  return n_steps <= kDivsTableSteps
             ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks, divs_partials_kernel<VanillaCall, A, true>, T,
                   divs_table_bytes(n_steps))
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks, divs_partials_kernel<VanillaCall, A, false>, T, 0);
}

}  // namespace mc

extern "C" {

// The partials kernel's paths a block (its grid: ceil(n_paths / it),
// capped), paths a thread and the longest schedule of its block table.
int mc_divs_block_paths() { return mc::kDivsTile; }
int mc_divs_paths_per_thread(int antithetic) {
  return antithetic ? mc::divs_thread_paths<true>() : mc::divs_thread_paths<false>();
}
int mc_divs_table_steps() { return mc::kDivsTableSteps; }

// Resident blocks per SM of the partials kernel (VanillaCall) at n_steps.
int mc_divs_occupancy(int antithetic, int n_steps, int* blocks) {
  return antithetic ? mc::divs_occupancy<true>(n_steps, blocks)
                    : mc::divs_occupancy<false>(n_steps, blocks);
}

// params: the packed vector of 13 + n_steps floats (the wrapper checks its
// length).
int mc_divs_partials(int payoff_id, int antithetic, uint32_t k0, uint32_t k1,
                     const float* params, int n_steps, uint32_t n_paths, uint32_t path_offset,
                     uint32_t bound, double* partials, int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_steps < 2 || n_steps % 2) return cudaErrorInvalidValue;
#define MC_CASE(ID, PAYOFF)                                                                  \
  case mc::ID:                                                                               \
    return antithetic ? mc::launch_divs_partials<mc::PAYOFF, true>(                          \
                            k0, k1, params, n_steps, n_paths, path_offset, bound, partials,  \
                            n_blocks, s)                                                     \
                      : mc::launch_divs_partials<mc::PAYOFF, false>(                         \
                            k0, k1, params, n_steps, n_paths, path_offset, bound, partials,  \
                            n_blocks, s);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
