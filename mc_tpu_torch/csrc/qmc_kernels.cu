// The randomized-QMC kernels of the port (GBM), for sm_90a.
//
// qmc_kernel replaces mc_tpu/qmc.py _pallas_qmc_shift_sum (the Pallas call
// at :469) and qmc_bridge_kernel replaces _pallas_qmc_bridge_shift_sum (the
// Pallas call at :409).  mc_tpu launches one pallas_call per random shift;
// here one launch takes all R shifts.  The bridge's grid is (path blocks,
// R): block (x, r) runs points x*blockDim + t, grid-strided, under shift r.
// qmc_kernel's is (path blocks, ceil(R / kQmcShifts)): block (x, g) runs
// the same points under shifts g*kQmcShifts .. g*kQmcShifts + kQmcShifts-1
// in lockstep (a ragged last group's shifts past R run on the last and are
// not stored), each coordinate's shift-independent part computed once for
// them.  Each writes one f64 sum per shift at partials[x*R + r]
// (reduce.cuh), the same bits at any kQmcShifts; ops/reduce.finish_sum
// adds the rows, a fixed order, no float atomics.
//
// A point's coordinate j comes from qmc.cuh (shared with #33): the exact
// lattice residue under its Cranley-Patterson shift, or the Gray-code Sobol
// XOR under its digital shift.  Both are the same for every thread of a
// block but the id, so the table, the generating vector and the shifts are
// uniform loads (an L1 broadcast).
// The normal is rng.cuh inv_normal_cdf (Acklam + one Newton step, as
// mc_tpu), never CUDA's normcdfinvf.  qmc_kernel's leg is the simulate
// kernel's (payoffs.cuh simulate_path, whose euler_step it runs per shift):
// the terminal draw on dimension 0, or the log-Euler loop with step pair m
// on dimensions (2m, 2m+1) and an odd step count's last half step on the
// head of one more pair.
//
// The bridge builds each path's W (nodes 0..n_steps, W[0] = 0) from
// dimension k at entry k of the breadth-first schedule (qmc.bridge_schedule:
// W[m] = (c_l W[l] + c_r W[r]) + s z_k), and steps on the increments
// W[2m+1] - W[2m], W[min(2m+2, n)] - W[2m+1].  qmc_bridge_kernel runs the
// same entries depth first (qmc.bridge_stream): W then comes in time order,
// and step pair m runs as soon as the entries before it have set its nodes,
// so a thread keeps only the nodes still to be read, in a few numbered
// slots (8 at 100 steps, 11 at 1,023; kBridgeSlots at most) of a small
// shared slab, slot s of shift k of thread t at (s*K + k)*blockDim + t (no
// bank conflicts; the slot is the same for the whole block).  Each node is
// the same f32 expression on the same operands, and dimension k's normal
// the same in any order, so W, each increment and each payoff keep their
// bits whatever the order.  Its grid is qmc_kernel's, kBridgeShifts
// shifts a thread; its block keeps the threads of the W-buffer kernel it
// replaced (bridge_threads), so each block sums the same points.
//
// What bounds them on the H100: operations.  A coordinate costs, once per
// point, the residue (~20 int32 and a few f32 operations) or the Sobol XOR
// over the Gray code's set bits, and per shift its add or XOR and the
// inverse CDF (~84 f32 operations, two divisions and a logf, sqrtf and
// expf each); a step ~4 f32 and an expf.  Bytes are a few kB of tables and
// shifts, read through L1.

#include <cstdint>

#include <cuda_runtime.h>

#include "family.cuh"
#include "payoffs.cuh"
#include "qmc.cuh"
#include "qmc_model.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace mc {

constexpr int kQmcThreads = 128;
// A block's shared memory on the H100 (227 KB) less the reduction buffer.
constexpr int kQmcSmemBytes = 232448 - 8 * kQmcThreads;
// The shifts a thread of qmc_kernel runs at once (measured on the H100).
constexpr int kQmcShifts = qmc_shifts(4);

// simulate_path's leg (no antithetic, no importance shift, from step 0) on
// the K shifts r0 .. r0+K-1 of point id: the terminal draw S_T = s0
// exp(drift_t + vol_t z), or euler_step over the pairs' normals.
template <class Payoff, int K>
__device__ __forceinline__ void qmc_path(const Params& p, bool euler, const QmcPoints& q,
                                         uint32_t id, int r0, int n_steps, float (&pay)[K]) {
  float w[K], s[K];
  typename Payoff::State st[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = 0.0f;
    s[k] = p.s0;
    st[k] = Payoff::init(p);
  }
  if (!euler) {
    float z[K];
    qmc_normals<K>(q, id, 0, r0, z);
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = p.s0 * expf(p.drift_t + p.vol_t * z[k]);
  } else {
    for (int j = 0; j < n_steps; ++j) {
      float z[K];
      qmc_normals<K>(q, id, j, r0, z);
#pragma unroll
      for (int k = 0; k < K; ++k) euler_step<Payoff>(p, p.s0, z[k], w[k], s[k], st[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) pay[k] = Payoff::terminal(st[k], s[k], p);
}

template <class Payoff>
__global__ void __launch_bounds__(kQmcThreads)
qmc_kernel(int euler, QmcPoints q, const float* __restrict__ params, int n_steps,
           double* __restrict__ partials) {
  constexpr int K = kQmcShifts;
  const Params p = load_params(params);
  const int r0 = blockIdx.y * K;
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t id = blockIdx.x * blockDim.x + threadIdx.x; id < static_cast<uint32_t>(q.n);
       id += stride) {
    float pay[K];
    qmc_path<Payoff, K>(p, euler != 0, q, id, r0, n_steps, pay);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += static_cast<double>(pay[k]);
  }
  block_store_moments<K, kQmcThreads>(
      acc, partials + static_cast<size_t>(blockIdx.x) * q.n_shifts + r0, min(K, q.n_shifts - r0));
}

// The bridge's entries in stream order, 16 bytes each (qmc.bridge_stream):
// code = dimension | out << 16 | l << 20 | r << 24 (the slots of W[m], W[l],
// W[r]), then c_l, c_r and s as f32 bits; pair m's code = the entries run
// before it | slot of W[2m+1] << 16 | slot of W[min(2m+2, n)] << 20.
constexpr int kBridgeSlots = 16;
// The shifts a thread of qmc_bridge_kernel runs at once (measured on the
// H100).
constexpr int kBridgeShifts = qmc_shifts(4);

template <class Payoff>
__global__ void __launch_bounds__(kQmcThreads)
qmc_bridge_kernel(QmcPoints q, const float* __restrict__ params, int n_steps,
                  const int4* __restrict__ entries, const int* __restrict__ pairs,
                  double* __restrict__ partials) {
  constexpr int K = kBridgeShifts;
  extern __shared__ float slab[];
  const Params p = load_params(params);
  const int r0 = blockIdx.y * K;
  const int nb = blockDim.x;
  float* w = slab + threadIdx.x;  // slot s, shift k at w[(s*K + k)*nb]
  const int n_pairs = (n_steps + 1) / 2;
  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t id = blockIdx.x * blockDim.x + threadIdx.x; id < static_cast<uint32_t>(q.n);
       id += stride) {
    float wa[K], x[K], s[K];  // W[2m], the log-spot, the spot
    typename Payoff::State st[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      w[k * nb] = 0.0f;  // W[0] in slot 0
      wa[k] = 0.0f;
      x[k] = 0.0f;
      s[k] = p.s0;
      st[k] = Payoff::init(p);
    }
    int e = 0;
    for (int m = 0; m < n_pairs; ++m) {
      const int pc = __ldg(pairs + m);
      for (const int end = pc & 0xffff; e < end; ++e) {
        const int4 en = __ldg(entries + e);
        const int so = (en.x >> 16) & 15, sl = (en.x >> 20) & 15, sr = (en.x >> 24) & 15;
        const float cl = __int_as_float(en.y), cr = __int_as_float(en.z),
                    sc = __int_as_float(en.w);
        float z[K];
        qmc_normals<K>(q, id, en.x & 0xffff, r0, z);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          w[(so * K + k) * nb] =
              (cl * w[(sl * K + k) * nb] + cr * w[(sr * K + k) * nb]) + sc * z[k];
        }
      }
      const int sa = (pc >> 16) & 15, sh = (pc >> 20) & 15;
      const bool second = 2 * m + 1 < n_steps;  // an odd count's last pair: one step
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float w1 = w[(sa * K + k) * nb], w2 = w[(sh * K + k) * nb];
        euler_step<Payoff>(p, p.s0, w1 - wa[k], x[k], s[k], st[k]);
        if (second) euler_step<Payoff>(p, p.s0, w2 - w1, x[k], s[k], st[k]);
        wa[k] = w2;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += static_cast<double>(Payoff::terminal(st[k], s[k], p));
  }
  block_store_moments<K, kQmcThreads>(
      acc, partials + static_cast<size_t>(blockIdx.x) * q.n_shifts + r0, min(K, q.n_shifts - r0));
}

// The bridge's block: the threads (128, 64, 32) of the W-buffer kernel it
// replaced, the most whose (n_steps+1)-node buffers fitted a block's shared
// memory, so each block sums the same points; 0 past 1,807 steps.
inline int bridge_threads(int n_steps) {
  for (int t = kQmcThreads; t >= 32; t /= 2) {
    if (static_cast<long long>(n_steps + 1) * t * 4 <= kQmcSmemBytes) return t;
  }
  return 0;
}

inline int bridge_slab_bytes(int n_slots, int threads) {
  return n_slots * kBridgeShifts * threads * 4;
}

template <class Payoff>
cudaError_t launch_qmc(int euler, const QmcPoints& q, const float* params, int n_steps,
                       double* partials, int n_bx, int n_groups, cudaStream_t stream) {
  if (!qmc_groups_ok(q, kQmcShifts, n_groups)) return cudaErrorInvalidValue;
  qmc_kernel<Payoff><<<dim3(n_bx, n_groups), kQmcThreads, 0, stream>>>(euler, q, params,
                                                                      n_steps, partials);
  return cudaGetLastError();
}

template <class Payoff>
cudaError_t launch_qmc_bridge(const QmcPoints& q, const float* params, int n_steps,
                              const int4* entries, const int* pairs, int n_slots,
                              double* partials, int n_bx, int n_groups, cudaStream_t stream) {
  const int threads = bridge_threads(n_steps);
  if (threads == 0 || !qmc_groups_ok(q, kBridgeShifts, n_groups)) return cudaErrorInvalidValue;
  const int bytes = bridge_slab_bytes(n_slots, threads);
  const cudaError_t err = cudaFuncSetAttribute(
      qmc_bridge_kernel<Payoff>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  qmc_bridge_kernel<Payoff><<<dim3(n_bx, n_groups), threads, bytes, stream>>>(
      q, params, n_steps, entries, pairs, partials);
  return cudaGetLastError();
}

// Whether #33's point set fits family_id's leg: d its dimensions over
// n_steps, extra its integer (kmax for Merton and Bates, the knot count for
// local vol, d for the basket).
inline bool qmc_model_shape_ok(int family_id, int d, int n_steps, int extra) {
  const bool even = n_steps % 2 == 0;
  const bool kmax_ok = extra >= 1 && extra <= 256;
  switch (family_id) {
    case FAMILY_HESTON: return d == 2 * n_steps;
    case FAMILY_BATES: return kmax_ok && d == 4 * n_steps;
    case FAMILY_CEV: return even && d == n_steps;
    case FAMILY_SABR: return d == 2 * n_steps;
    case FAMILY_LOCALVOL: return even && extra >= 2 && d == n_steps;
    case FAMILY_TERM: return even && d == n_steps;
    case FAMILY_VASICEK: return even && d == 3 * n_steps;
    case FAMILY_MERTON: return even && kmax_ok && d == 3 * n_steps;
    case FAMILY_BASKET:
      return extra >= 1 && extra <= 32 && d == 2 * ((extra + 1) / 2) * n_steps;
    default: return false;
  }
}

}  // namespace mc

extern "C" {

int mc_qmc_block_threads() { return mc::kQmcThreads; }

// The bridge kernel's threads per block for n_steps, 0 past the steps it
// takes.
int mc_qmc_bridge_threads(int n_steps) { return mc::bridge_threads(n_steps); }

// The shifts a thread of qmc_bridge_kernel runs (its launch's groups are
// ceil(R / it)), and the most slots of its stream.
int mc_qmc_bridge_shifts() { return mc::kBridgeShifts; }
int mc_qmc_bridge_slots() { return mc::kBridgeSlots; }

// The shifts a thread of qmc_kernel runs (the launch's groups are
// ceil(R / it)).
int mc_qmc_shifts() { return mc::kQmcShifts; }

// family 0 lattice (table: the (d,) int32 generating vector, shifts (R, d)
// f32) or 1 sobol (table: (d*30,) int32 directions, shifts (R, d) int32);
// euler 0: the terminal draw (d = 1), 1: the Euler loop (d = n_steps);
// partials (n_bx, R) f64; the grid n_bx x n_groups (ceil(R / kQmcShifts),
// qmc.py qmc_launch).
int mc_qmc_sums(int payoff_id, int family, int euler, int n, int d, const int* table,
                const void* shifts, int n_shifts, const float* params, int n_steps,
                double* partials, int n_bx, int n_groups, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mc::qmc_args_ok(family, n, d, n_shifts, n_bx) || n_steps < 1)
    return cudaErrorInvalidValue;
  const mc::QmcPoints q = mc::qmc_points(family, n, d, n_shifts, table, shifts);
#define MC_CASE(ID, PAYOFF) \
  case mc::ID:              \
    return mc::launch_qmc<mc::PAYOFF>(euler, q, params, n_steps, partials, n_bx, n_groups, s);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

int mc_qmc_model_block_threads() { return mc::kQmcModelThreads; }

// The family's switch over its launcher prefixes: the basket's capacity 8
// for d <= 8, 32 above.
#define MC_QMC_FAMILIES(X, BASKET_D)                                     \
  case mc::FAMILY_HESTON: X(heston)                                     \
  case mc::FAMILY_BATES: X(bates)                                       \
  case mc::FAMILY_CEV: X(cev)                                           \
  case mc::FAMILY_SABR: X(sabr)                                         \
  case mc::FAMILY_LOCALVOL: X(localvol)                                 \
  case mc::FAMILY_TERM: X(term)                                         \
  case mc::FAMILY_VASICEK: X(vasicek)                                   \
  case mc::FAMILY_MERTON: X(merton)                                     \
  case mc::FAMILY_BASKET:                                               \
    if ((BASKET_D) <= 8) X(basket)                                      \
    X(basket32)

// #33's shifts a thread under family_id (extra: the basket's d), 0 for an
// unknown family.
int mc_qmc_model_shifts(int family_id, int extra) {
#define MC_SHIFTS(PREFIX) return mc::PREFIX##_qmc_model_shifts();
  switch (family_id) {
    MC_QMC_FAMILIES(MC_SHIFTS, extra)
    default: return 0;
  }
#undef MC_SHIFTS
}

// Resident blocks per SM of a QMC kernel: #33's under family_id (extra:
// its integer, which sizes Merton's and Bates's table), qmc_kernel's for
// family_id -1, or qmc_bridge_kernel's (128 threads) for -2 (extra: its
// stream's slots).
int mc_qmc_occupancy(int family_id, int payoff_id, int extra, int* blocks) {
  if (family_id == -2) {
    if (extra < 1 || extra > mc::kBridgeSlots) return cudaErrorInvalidValue;
    const int bytes = mc::bridge_slab_bytes(extra, mc::kQmcThreads);
#define MC_CASE(ID, PAYOFF)                                                               \
  case mc::ID:                                                                            \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                 \
        blocks, mc::qmc_bridge_kernel<mc::PAYOFF>, mc::kQmcThreads, bytes);
    switch (payoff_id) {
      MC_ALL_PAYOFFS(MC_CASE)
      default: return cudaErrorInvalidValue;
    }
#undef MC_CASE
  }
  if (family_id == -1) {
#define MC_CASE(ID, PAYOFF)                                                              \
  case mc::ID:                                                                           \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mc::qmc_kernel<mc::PAYOFF>, \
                                                         mc::kQmcThreads, 0);
    switch (payoff_id) {
      MC_ALL_PAYOFFS(MC_CASE)
      default: return cudaErrorInvalidValue;
    }
#undef MC_CASE
  }
#define MC_OCCUPANCY(PREFIX) return mc::PREFIX##_qmc_model_occupancy(payoff_id, extra, blocks);
  switch (family_id) {
    MC_QMC_FAMILIES(MC_OCCUPANCY, extra)
    default: return cudaErrorInvalidValue;
  }
#undef MC_OCCUPANCY
}

// #33: the payoff sums of n points through family_id's leg (a FamilyId of
// family.cuh; params its pack, extra its integer: kmax for Merton and Bates,
// the knot count for local vol, d for the basket) over n_steps, under each
// of the R shifts; partials (n_bx, R) f64.  The point set as mc_qmc_sums',
// its d the family's dimensions; the grid n_bx x n_groups (ceil(R /
// mc_qmc_model_shifts)).
int mc_qmc_model_sums(int family_id, int payoff_id, int family, int n, int d,
                      const int* table, const void* shifts, int n_shifts,
                      const float* params, int n_steps, int extra, double* partials,
                      int n_bx, int n_groups, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mc::qmc_args_ok(family, n, d, n_shifts, n_bx) || n_steps < 1 ||
      !mc::qmc_model_shape_ok(family_id, d, n_steps, extra))
    return cudaErrorInvalidValue;
  const mc::QmcPoints q = mc::qmc_points(family, n, d, n_shifts, table, shifts);
#define MC_LAUNCH(PREFIX) \
  return mc::PREFIX##_qmc_model(payoff_id, q, params, n_steps, extra, partials, n_bx, n_groups, s);
  switch (family_id) {
    MC_QMC_FAMILIES(MC_LAUNCH, extra)
    default: return cudaErrorInvalidValue;
  }
#undef MC_LAUNCH
}

// As mc_qmc_sums, the Euler increments from the Brownian bridge in stream
// order (qmc.bridge_stream): entries (n_steps, 4) int32 and pairs
// (ceil(n_steps/2),) int32 as qmc_bridge_kernel reads them, n_slots its
// slots (at most kBridgeSlots); the grid n_bx x n_groups (ceil(R /
// kBridgeShifts)) of blocks of mc_qmc_bridge_threads(n_steps).
int mc_qmc_bridge_sums(int payoff_id, int family, int n, int d, const int* table,
                       const void* shifts, int n_shifts, const float* params, int n_steps,
                       const int* entries, const int* pairs, int n_slots, double* partials,
                       int n_bx, int n_groups, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mc::qmc_args_ok(family, n, d, n_shifts, n_bx) || n_steps < 1 || d != n_steps ||
      n_steps > 0xffff || n_slots < 2 || n_slots > mc::kBridgeSlots)
    return cudaErrorInvalidValue;
  const mc::QmcPoints q = mc::qmc_points(family, n, d, n_shifts, table, shifts);
  const int4* ent = reinterpret_cast<const int4*>(entries);
#define MC_CASE(ID, PAYOFF)                                                              \
  case mc::ID:                                                                           \
    return mc::launch_qmc_bridge<mc::PAYOFF>(q, params, n_steps, ent, pairs, n_slots,    \
                                             partials, n_bx, n_groups, s);
  switch (payoff_id) {
    MC_ALL_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef MC_CASE
}

#undef MC_QMC_FAMILIES

}  // extern "C"
