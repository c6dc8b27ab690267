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

// Add one path's K values and their squares to acc[0..2K) as [v_0, v_0^2,
// v_1, v_1^2, ...], a path past the bound adding zeros.
template <int N, int K>
__device__ __forceinline__ void add_moments(double (&acc)[N], const float (&v)[K],
                                            bool valid) {
  static_assert(2 * K <= N, "acc holds a value and its square per value");
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float x = valid ? v[k] : 0.0f;
    acc[2 * k] += static_cast<double>(x);
    acc[2 * k + 1] += static_cast<double>(x * x);
  }
}

// Add one path's moments to acc, a path past the bound adding zeros:
// [pay, pay^2] and, with the control variate, [x, x^2, pay*x].
template <int N>
__device__ __forceinline__ void add_moments(double (&acc)[N], float pay, float x,
                                            bool valid, bool with_cv) {
  const float pv[1] = {pay};
  add_moments(acc, pv, valid);
  if constexpr (N == kMaxMoments) {
    if (with_cv) {
      pay = valid ? pay : 0.0f;
      x = valid ? x : 0.0f;
      acc[2] += static_cast<double>(x);
      acc[3] += static_cast<double>(x * x);
      acc[4] += static_cast<double>(pay * x);
    }
  }
}

// Reduce acc[0..N) over the block of blockDim.x threads, a power of two of
// at most MAX_THREADS, and store the result at out[0..n_store).  The tree's
// order is fixed by blockDim.x.  Every thread of the block must call it.
template <int N, int MAX_THREADS>
__device__ void block_store_moments(const double (&acc)[N], double* out, int n_store) {
  __shared__ double sh[N][MAX_THREADS];
#pragma unroll
  for (int m = 0; m < N; ++m) sh[m][threadIdx.x] = acc[m];
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
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
