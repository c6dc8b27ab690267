// The rates kernel of the port, for sm_90a.
//
// rates_partials_kernel<Tile, P, kStaged> replaces mc_tpu/ops/_pallas.py:107
// fused_moment_partials (the Pallas call at :145) under its five European
// swaption tiles (rates.cuh; ops/fused.py TILES): ids path_offset + i, the
// tile's discounted swap payoff from the packed vector, paths at or past
// `bound` adding zeros; each block writes one row of f64 [sum pay, sum
// pay^2] (reduce.cuh), which ops/reduce.py finish_sum adds in a fixed
// order.  No float atomics.
//
// A block sums kRatesTile = 256 paths, block b paths b*256 .. b*256+255,
// grid-strided: its 256 / P threads each run P of them in lockstep, thread
// t paths t, t + T, .. t + (P-1)T (T the block's threads), each path's f64
// [pay, pay^2] in a lane of its own.  The lanes then add as the
// one-path-a-thread kernel's block tree added its threads t + pT (lane p
// and p + h at its level T*h), and the T threads' tree finishes, its last
// levels in a warp (reduce.cuh block_store_moments_warp): every row keeps
// its bits, and ops/fused.py block_rows, which adds the plain version's
// payoffs in that order, agrees with it bit for bit.
//
// What bounds it on the H100: operations.  A path spends one threefry-13
// pair and its Box-Muller (log1pf, sqrtf, sincosf), n + 1 expf and ~3 f32
// operations a bond (G2++ adds a second threefry and the inverse CDF).  The
// pack is a few hundred bytes that every path reads, so the loads are
// overhead to cut, not bytes to move: the block stages the header once, and
// up to kRatesStagePayments payments the tables per payment in shared
// memory (one 128-bit load gives a bond's entries), each entry read once
// for the P paths of a thread; past that cap (a longer swap than any demo
// or test prices) the tables are read in place, each entry once for the P
// paths.  The launcher picks the path by n.  The bond loop runs kRatesUnroll
// bonds an iteration, the tail of n modulo that apart, each bond's expf and
// adds in the plain version's order.

#include <cstdint>

#include <cuda_runtime.h>

#include "rates.cuh"
#include "reduce.cuh"

namespace mc {

constexpr int kRatesTile = 256;  // paths a block: the one-path kernel's threads
// Paths a thread in lockstep: on the H100 (family_nmc_probe.py --rates,
// PERF.md) 2^24 paths at n = 10 took 0.198 / 0.177 / 0.179 ms (Vasicek) and
// 0.374 / 0.355 / 0.374 ms (G2++) at 1 / 2 / 4 paths.
constexpr int kRatesPaths = 2;
constexpr int kRatesUnroll = 4;  // bonds an iteration of the bond loop
// The longest swap whose tables the block stages: 8 KB of shared memory
// (10 KB for the multi-curve G2++ tile's fifth entry) a block, so that 16
// blocks of 128 threads, an SM's threads at 2 paths a thread, fit in its
// 228 KB whatever the tile (a 256-year semiannual swap; 60 payments, a
// 30-year one, take 1 KB).
constexpr int kRatesStagePayments = 512;
constexpr int kRatesHeadFloats = 16;  // the staged header's slot (kHead <= 16)
static_assert(kRatesTile % kRatesPaths == 0 && kRatesTile / kRatesPaths >= 32,
              "a block's threads are a power of two of at least a warp");

// Dynamic shared memory of a block: the header's slot, then (staged) a
// float4 of entries a payment and a fifth entry a payment.
template <class Tile>
constexpr size_t rates_smem_bytes(int n, bool staged) {
  return sizeof(float) * kRatesHeadFloats +
         (staged ? (sizeof(float4) + (Tile::kEntries > 4 ? sizeof(float) : 0)) *
                       static_cast<size_t>(n)
                 : 0);
}

// Payment j's entries: from the staged float4 (and fifth) or from the pack.
template <class Tile, bool kStaged>
__device__ __forceinline__ RatesEntry rates_entry(const float4* quad, const float* tail,
                                                  const float* __restrict__ pv, int n,
                                                  int j) {
  RatesEntry e;
  if constexpr (kStaged) {
    e.q = quad[j];
    if constexpr (Tile::kEntries > 4) e.t = tail[j];
  } else {
    e.q.x = __ldg(pv + Tile::entry_offset(n, 0) + j);
    e.q.y = __ldg(pv + Tile::entry_offset(n, 1) + j);
    if constexpr (Tile::kEntries > 2) e.q.z = __ldg(pv + Tile::entry_offset(n, 2) + j);
    if constexpr (Tile::kEntries > 3) e.q.w = __ldg(pv + Tile::entry_offset(n, 3) + j);
    if constexpr (Tile::kEntries > 4) e.t = __ldg(pv + Tile::entry_offset(n, 4) + j);
  }
  return e;
}

template <class Tile, int P, bool kStaged>
__global__ void __launch_bounds__(kRatesTile / P)
rates_partials_kernel(int n, uint32_t k0, uint32_t k1, const float* __restrict__ pv,
                      uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                      double* __restrict__ partials) {
  constexpr int T = kRatesTile / P;
  extern __shared__ float4 rates_smem[];
  float* head_s = reinterpret_cast<float*>(rates_smem);
  const float4* quad = rates_smem + kRatesHeadFloats / 4;
  const float* tail = reinterpret_cast<const float*>(quad + n);
  for (int k = threadIdx.x; k < kRatesHeadFloats; k += T) {
    head_s[k] = k < Tile::kHead ? pv[Tile::head_offset(n, k)] : 0.0f;  // a Head reads 11 at most
  }
  if constexpr (kStaged) {
    float* qf = reinterpret_cast<float*>(rates_smem + kRatesHeadFloats / 4);
    float* tf = qf + 4 * n;
    for (int k = threadIdx.x; k < Tile::kEntries * n; k += T) {
      const int e = k / n, j = k - e * n;
      const float v = pv[Tile::entry_offset(n, e) + j];
      if (e < 4) {
        qf[4 * j + e] = v;
      } else {
        tf[j] = v;
      }
    }
  }
  __syncthreads();
  const typename Tile::Head h = Tile::head(head_s);

  double acc[P][2];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p][0] = acc[p][1] = 0.0;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * kRatesTile;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * kRatesTile + threadIdx.x; i < n_paths;
       i += stride) {
    uint32_t id[P];
    typename Tile::State s[P];
    typename Tile::Acc a[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      id[p] = path_offset + static_cast<uint32_t>(i + p * T);
      s[p] = Tile::draw(h, k0, k1, id[p]);
      a[p] = Tile::begin(h);
    }
    auto bond = [&](int j) {
      const RatesEntry e = rates_entry<Tile, kStaged>(quad, tail, pv, n, j);
#pragma unroll
      for (int p = 0; p < P; ++p) Tile::bond(h, e, s[p], a[p]);
    };
    int j = 0;
    for (; j + kRatesUnroll <= n; j += kRatesUnroll) {
#pragma unroll
      for (int u = 0; u < kRatesUnroll; ++u) bond(j + u);
    }
#pragma unroll 1
    for (; j < n; ++j) bond(j);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float v[1] = {Tile::finish(h, s[p], a[p])};
      add_moments(acc[p], v, i + p * T < n_paths && id[p] < bound);
    }
  }
#pragma unroll
  for (int hh = P / 2; hh >= 1; hh /= 2) {
#pragma unroll
    for (int p = 0; p < hh; ++p) {
      acc[p][0] += acc[p + hh][0];
      acc[p][1] += acc[p + hh][1];
    }
  }
  block_store_moments_warp<2, T>(acc[0], partials + 2 * static_cast<size_t>(blockIdx.x));
}

// The tables staged where the swap has at most kRatesStagePayments
// payments, read in place past that.
inline bool rates_staged(int n_pay) { return n_pay <= kRatesStagePayments; }

template <class Tile>
cudaError_t launch_rates(int n_pay, uint32_t k0, uint32_t k1, const float* pv, uint32_t n_paths,
                         uint32_t path_offset, uint32_t bound, double* partials, int n_blocks,
                         cudaStream_t s) {
  constexpr int P = kRatesPaths;
  const bool staged = rates_staged(n_pay);
  const size_t smem = rates_smem_bytes<Tile>(n_pay, staged);
  if (staged) {
    rates_partials_kernel<Tile, P, true><<<n_blocks, kRatesTile / P, smem, s>>>(
        n_pay, k0, k1, pv, n_paths, path_offset, bound, partials);
  } else {
    rates_partials_kernel<Tile, P, false><<<n_blocks, kRatesTile / P, smem, s>>>(
        n_pay, k0, k1, pv, n_paths, path_offset, bound, partials);
  }
  return cudaGetLastError();
}

template <class Tile>
cudaError_t rates_occupancy(int n_pay, int* blocks) {
  constexpr int P = kRatesPaths;
  const bool staged = rates_staged(n_pay);
  const size_t smem = rates_smem_bytes<Tile>(n_pay, staged);
  return staged ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, rates_partials_kernel<Tile, P, true>, kRatesTile / P, smem)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, rates_partials_kernel<Tile, P, false>, kRatesTile / P, smem);
}

}  // namespace mc

extern "C" {

// The kernel's paths a block (its grid: ceil(n_paths / it), capped), paths
// a thread and the longest swap whose tables a block stages.
int mc_rates_block_paths() { return mc::kRatesTile; }
int mc_rates_paths_per_thread() { return mc::kRatesPaths; }
int mc_rates_stage_payments() { return mc::kRatesStagePayments; }

#define MC_RATES_TILES(X) \
  X(0, VaSwpt) X(1, HwSwpt) X(2, HwSwptMc) X(3, G2Swpt) X(4, G2SwptMc)

// Resident blocks per SM of a tile's kernel at n_pay payments.
int mc_rates_occupancy(int tile, int n_pay, int* blocks) {
#define MC_CASE(ID, TILE) \
  case ID: return mc::rates_occupancy<mc::TILE>(n_pay, blocks);
  switch (tile) {
    MC_RATES_TILES(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

// tile: ops/fused.py TILES (0 va, 1 hw, 2 hw_mc, 3 g2, 4 g2_mc); pv: the
// tile's pack for n_pay payments; partials (n_blocks, 2) f64.
int mc_rates_partials(int tile, int n_pay, uint32_t k0, uint32_t k1, const float* pv,
                      uint32_t n_paths, uint32_t path_offset, uint32_t bound, double* partials,
                      int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pay < 1 || n_blocks < 1) return cudaErrorInvalidValue;
#define MC_CASE(ID, TILE)                                                                    \
  case ID:                                                                                   \
    return mc::launch_rates<mc::TILE>(n_pay, k0, k1, pv, n_paths, path_offset, bound,       \
                                      partials, n_blocks, s);
  switch (tile) {
    MC_RATES_TILES(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

}  // extern "C"
