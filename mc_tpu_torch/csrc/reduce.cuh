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

// block_store_moments over the first THREADS threads (a power of two) of a
// block of THREADS or more, storing all N: the tree of a block of THREADS,
// the same adds, its levels unrolled (a loop bound the compiler knows); the
// threads past THREADS add nothing and take its barriers.  Every thread of
// the block must call it.
template <int N, int THREADS>
__device__ void block_store_moments_unrolled(const double (&acc)[N], double* out) {
  __shared__ double sh[N][THREADS];
  if (threadIdx.x < THREADS) {
#pragma unroll
    for (int m = 0; m < N; ++m) sh[m][threadIdx.x] = acc[m];
  }
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
#pragma unroll
    for (int m = 0; m < N; ++m) out[m] = sh[m][0];
  }
}

// block_store_moments for a block of exactly THREADS threads (a power of
// two, at least a warp), storing all N: the same tree and the same adds,
// its levels above 32 in shared memory, then warp 0 takes the level of 32
// (thread t's sum and t + 32's, read from shared memory) and the last five
// by __shfl_down_sync, thread t with t + s for s = 16 .. 1, as the tree
// pairs them: the row keeps its bits, with two barriers fewer (none in a
// block of one warp).  Every thread of the block must call it.
template <int N, int THREADS>
__device__ void block_store_moments_warp(const double (&acc)[N], double* out) {
  static_assert(THREADS >= 32 && (THREADS & (THREADS - 1)) == 0,
                "a power of two of at least a warp");
  double v[N];
  if constexpr (THREADS == 32) {
#pragma unroll
    for (int m = 0; m < N; ++m) v[m] = acc[m];
  } else {
    __shared__ double sh[N][THREADS];
#pragma unroll
    for (int m = 0; m < N; ++m) sh[m][threadIdx.x] = acc[m];
    __syncthreads();
#pragma unroll
    for (int s = THREADS / 2; s > 32; s >>= 1) {
      if (threadIdx.x < s) {
#pragma unroll
        for (int m = 0; m < N; ++m) sh[m][threadIdx.x] += sh[m][threadIdx.x + s];
      }
      __syncthreads();
    }
    if (threadIdx.x >= 32) return;
#pragma unroll
    for (int m = 0; m < N; ++m) v[m] = sh[m][threadIdx.x] + sh[m][threadIdx.x + 32];
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int m = 0; m < N; ++m) v[m] += __shfl_down_sync(0xffffffffu, v[m], s);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int m = 0; m < N; ++m) out[m] = v[m];
  }
}

}  // namespace mc
