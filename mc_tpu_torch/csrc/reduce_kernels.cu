// The standalone reductions, kernels 9 and 10 of the port, for sm_90a.
//
// sum_kernel<false> replaces mc_tpu/ops/reduce.py tile_partials (the Pallas
// call at :89) and sum_kernel<true> the Pallas call of sum_sumsq_pallas
// (:204): the sum, or the sum and the sum of squares, of an f32 array in
// device memory, the analogue of the reference's reduce3..reduce6
// (inc/reduce.cuh:9-227).  The TPU kernel walks its grid in order and
// Kahan-adds every (tile_rows, 128) tile into one revisited (8, 128) f32
// slab; blocks on the H100 run concurrently and in no order, so each block
// writes one row of f64 sums instead, and ops/reduce.py finish_sum adds the
// rows in f64.  No float atomics: their order, and so their bits, would
// change from run to run.
//
// Each thread reads its grid-stride share as float4 loads where the array
// is 16-byte aligned (a sliced view may not be; then, and for the last
// n % 4 elements, as single floats) and adds each element, and its square
// taken in f32 (as mc_tpu and the path kernels' moments take it), in f64.
// The block then adds its 256 threads' sums with the path kernels' fixed
// shared-memory tree (reduce.cuh block_store_moments).  The grid is capped
// (ops/_cuda.py MAX_BLOCKS) so a large array grid-strides; the rows' order
// then depends on nothing but n and the array's alignment.
//
// What bounds them on the H100: bytes.  Each reads 4 bytes an element once
// and does one f64 add (two, and an f32 square) per 4 bytes, far below the
// f64 rate, so the bound is n * 4 bytes at 3.35 TB/s (80 us at 2^26); the
// float4 loads and 2M threads in flight at the cap are what keep enough
// loads outstanding to approach it.

#include <cstdint>

#include <cuda_runtime.h>

#include "reduce.cuh"

namespace mc {

constexpr int kReduceThreads = 256;

template <bool kSquares>
__global__ void __launch_bounds__(kReduceThreads)
sum_kernel(const float* __restrict__ x, uint64_t n, double* __restrict__ partials) {
  constexpr int N = kSquares ? 2 : 1;
  double acc[N];
#pragma unroll
  for (int m = 0; m < N; ++m) acc[m] = 0.0;
  auto add = [&](float v) {
    acc[0] += static_cast<double>(v);
    if constexpr (kSquares) acc[N - 1] += static_cast<double>(v * v);
  };
  const uint64_t tid = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  uint64_t head = 0;  // elements the float4 loop covers
  if ((reinterpret_cast<uintptr_t>(x) & 15u) == 0) {
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
    const uint64_t n4 = n / 4;
    for (uint64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      add(v.x);
      add(v.y);
      add(v.z);
      add(v.w);
    }
    head = 4 * n4;
  }
  for (uint64_t i = head + tid; i < n; i += stride) add(x[i]);
  block_store_moments<N, kReduceThreads>(acc, partials + static_cast<size_t>(N) * blockIdx.x,
                                         N);
}

template <bool kSquares>
cudaError_t launch_sum(const float* x, uint64_t n, double* partials, int n_blocks,
                       cudaStream_t stream) {
  if (n_blocks < 1) return cudaErrorInvalidValue;
  sum_kernel<kSquares><<<n_blocks, kReduceThreads, 0, stream>>>(x, n, partials);
  return cudaGetLastError();
}

}  // namespace mc

extern "C" {

int mc_reduce_block_threads() { return mc::kReduceThreads; }

int mc_tile_partials(const float* x, uint64_t n, double* partials, int n_blocks,
                     void* stream) {
  return mc::launch_sum<false>(x, n, partials, n_blocks,
                               static_cast<cudaStream_t>(stream));
}

int mc_sum_sumsq_partials(const float* x, uint64_t n, double* partials, int n_blocks,
                          void* stream) {
  return mc::launch_sum<true>(x, n, partials, n_blocks,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
