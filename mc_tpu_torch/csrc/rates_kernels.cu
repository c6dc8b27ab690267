// The rates kernel of the port, for sm_90a.
//
// rates_partials_kernel<Tile> replaces mc_tpu/ops/_pallas.py:107
// fused_moment_partials (the Pallas call at :145) under its five European
// swaption tiles (rates.cuh; ops/fused.py TILES): one path per thread over
// a grid-stride loop with ids path_offset + i, the tile's discounted swap
// payoff read from the packed vector, paths at or past `bound` adding
// zeros; each block writes one row of f64 [sum pay, sum pay^2]
// (reduce.cuh), which ops/reduce.py finish_sum adds in a fixed order.  No
// float atomics.  ops/fused.py block_rows adds the plain version's payoffs
// in this kernel's order, so the two agree bit for bit.
//
// What bounds it on the H100: operations.  A path spends one threefry-13
// pair and its Box-Muller (log1pf, sqrtf, cosf, sinf), n + 1 expf and ~3
// f32 operations a bond (G2++ adds a second threefry and the inverse CDF);
// it reads the 4n + 11 packed floats at most (uniform loads, L1) and each
// block writes 16 bytes.

#include <cstdint>

#include <cuda_runtime.h>

#include "rates.cuh"
#include "reduce.cuh"

namespace mc {

constexpr int kRatesThreads = 256;

template <class Tile>
__global__ void __launch_bounds__(kRatesThreads)
rates_partials_kernel(int n_pay, uint32_t k0, uint32_t k1, const float* __restrict__ pv,
                      uint32_t n_paths, uint32_t path_offset, uint32_t bound,
                      double* __restrict__ partials) {
  double acc[2] = {0.0, 0.0};
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_paths; i += stride) {
    const uint32_t id = path_offset + static_cast<uint32_t>(i);
    const float v[1] = {Tile::pay(pv, n_pay, k0, k1, id)};
    add_moments(acc, v, id < bound);
  }
  block_store_moments<2, kRatesThreads>(acc, partials + 2 * static_cast<size_t>(blockIdx.x), 2);
}

template <class Tile>
void launch_rates(int n_pay, uint32_t k0, uint32_t k1, const float* pv, uint32_t n_paths,
                  uint32_t path_offset, uint32_t bound, double* partials, int n_blocks,
                  cudaStream_t s) {
  rates_partials_kernel<Tile><<<n_blocks, kRatesThreads, 0, s>>>(
      n_pay, k0, k1, pv, n_paths, path_offset, bound, partials);
}

}  // namespace mc

extern "C" {

int mc_rates_block_threads() { return mc::kRatesThreads; }

// tile: ops/fused.py TILES (0 va, 1 hw, 2 hw_mc, 3 g2, 4 g2_mc); pv: the
// tile's pack for n_pay payments; partials (n_blocks, 2) f64.
int mc_rates_partials(int tile, int n_pay, uint32_t k0, uint32_t k1, const float* pv,
                      uint32_t n_paths, uint32_t path_offset, uint32_t bound, double* partials,
                      int n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pay < 1 || n_blocks < 1) return cudaErrorInvalidValue;
  switch (tile) {
    case 0:
      mc::launch_rates<mc::VaSwpt>(n_pay, k0, k1, pv, n_paths, path_offset, bound, partials,
                                   n_blocks, s);
      break;
    case 1:
      mc::launch_rates<mc::HwSwpt>(n_pay, k0, k1, pv, n_paths, path_offset, bound, partials,
                                   n_blocks, s);
      break;
    case 2:
      mc::launch_rates<mc::HwSwptMc>(n_pay, k0, k1, pv, n_paths, path_offset, bound, partials,
                                     n_blocks, s);
      break;
    case 3:
      mc::launch_rates<mc::G2Swpt>(n_pay, k0, k1, pv, n_paths, path_offset, bound, partials,
                                   n_blocks, s);
      break;
    case 4:
      mc::launch_rates<mc::G2SwptMc>(n_pay, k0, k1, pv, n_paths, path_offset, bound, partials,
                                     n_blocks, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
