// Deterministic per-block moment partials.
//
// Blocks on the H100 run concurrently and in no order, so the TPU's
// revisited Kahan slab has no counterpart.  Each block tree-reduces its
// threads' f64 moment sums in shared memory, always in the same order, and
// writes one row; ops/reduce.py finish_sum adds the rows in f64.  No float
// atomics: their order, and so their bits, would change from run to run.
#pragma once

namespace mc {

constexpr int kMaxMoments = 5;

// Reduce acc[0..N) over the block and store the result at out[0..n_store).
// Every thread of the block must call it.
template <int N, int THREADS>
__device__ void block_store_moments(const double (&acc)[N], double* out, int n_store) {
  __shared__ double sh[N][THREADS];
#pragma unroll
  for (int m = 0; m < N; ++m) sh[m][threadIdx.x] = acc[m];
  __syncthreads();
#pragma unroll
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int m = 0; m < N; ++m) sh[m][threadIdx.x] += sh[m][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int m = 0; m < n_store; ++m) out[m] = sh[m][0];
  }
}

}  // namespace mc
