"""Randomized quasi-Monte Carlo: rank-1 lattices and Sobol nets under GBM
and under nine model families (port of ``mc_tpu/qmc.py``).

For a smooth integrand a randomized-QMC estimator converges near O(1/N)
instead of O(1/sqrt(N)).  Two point-set families, each generated from the
path id inside the kernel (no point matrix exists in memory):

* ``lattice`` (default): a rank-1 lattice of the largest prime n <= the
  path count (capped below 2^20), its generating vector from the fast
  component-by-component construction (``lattice_vector``, numpy FFTs,
  ``mc_tpu``'s code as it is); coordinate j of point i is
  frac(i z_j / n + shift_j), the residue i z_j mod n exact in integers and
  the shift a Cranley-Patterson rotation;
* ``sobol``: a Joe-Kuo Sobol net of 2^m points (scipy's direction numbers,
  ``sobol_directions``), point i by the direct Gray-code formula, XORed with
  a 30-bit random digital shift.

Normals come from the inverse CDF (``rng.inv_normal_cdf``); the step loop
and every payoff are ``price``'s (``ops/path_kernels._payoff_leg``), only
the draw source differs: the terminal draw reads dimension 0, Euler step
pair m dimensions (2m, 2m+1), and the Brownian bridge (``bridge=True``)
builds each path's W from dimension k at bridge entry k
(``bridge_schedule``, breadth-first bisection), so the best-distributed
dimensions set the coarsest levels.  The error estimate comes from R
independent randomizations (shifts from ``derive_key(seed, stream,
0x51AC)``): stderr = e^{-rT} std(R shift means) / sqrt(R).

``price_qmc_model`` runs the same point sets through a model family's
step loop (Heston's and Bates's Euler legs, the basket, CEV, SABR, local
vol, Vasicek, Merton, term curves): pair m of the point set feeds what the
family draws as pair m on its MC stream, so each family's dimensions are
its draws a path (``QMCModel.dims``); Merton and Bates read the Poisson
counts' uniforms as raw coordinates, and Bates packs 4 dimensions a step.

Three kernels, each taking all R shifts in one launch, one f64 sum per
path block and shift, several shifts a thread (the library's own count,
each point's coordinate computed once for them), on the grid
``kernel_launch`` (``bridge_launch``) computes:

* ``qmc_sums`` (replaces ``_pallas_qmc_shift_sum``, ``mc_tpu/qmc.py:463``;
  ``csrc/qmc_kernels.cu``): the payoff sum per shift, terminal or Euler,
  either point family;
* ``qmc_bridge_sums`` (replaces ``_pallas_qmc_bridge_shift_sum``,
  ``mc_tpu/qmc.py:403``): the same with the bridge's increments, its
  entries run depth first (``bridge_stream``), so a thread keeps only the
  few nodes still to be read;
* ``qmc_model_sums`` (replaces ``_model_shift_mean_fn``'s Pallas call,
  ``mc_tpu/qmc.py:824``; ``csrc/qmc_model.cuh``, one source a family):
  the payoff sum per shift through a family's leg.

Each wrapper takes its plain PyTorch version below only when the parameter
tensor lies on the CPU; for a CUDA tensor it launches the kernel or raises.
The shift-sharded ``price_qmc_model_sharded`` waits for the multi-card port
(ROADMAP item 20).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
import math
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_OUTER, resolve_device
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PathPayoff, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum
from mc_tpu_torch.models import (basket, bates, cev, heston, localvol,
                                 merton, sabr, term, vasicek)
from mc_tpu_torch.models.heston import SIGMA_PAYOFFS

__all__ = ["MAX_LATTICE_N", "SOBOL_BITS", "SOBOL_ID_BITS", "QMC_TAG",
           "QMC_THREADS", "QmcLaunch", "qmc_launch", "kernel_launch",
           "prev_prime",
           "lattice_vector", "bridge_schedule", "BridgeStream", "bridge_stream",
           "bridge_launch", "sobol_directions",
           "QMCPointSet", "lattice_residue", "point_units", "point_unit",
           "qmc_draw_pair",
           "bridge_draw_pair", "qmc_pointset", "qmc_sums", "qmc_sums_plain",
           "finish_qmc", "price_qmc", "QMC_MODELS", "QMCModel",
           "qmc_model_dynamics", "qmc_model_pointset", "qmc_model_discount",
           "qmc_model_sums", "qmc_model_sums_plain", "qmc_model_payoffs",
           "price_qmc_model"]

MAX_LATTICE_N = 1 << 20  # the exact int32 residue's bound
SOBOL_BITS = 30          # scipy's Joe-Kuo direction numbers are scaled to 2^30
SOBOL_ID_BITS = 20       # ids < 2^20: the bits of the Gray code that can be set
QMC_TAG = 0x51AC         # rng.derive_key stream tag of the shifts
FAMILIES = {"lattice": 0, "sobol": 1}
# Elements (paths x shifts) per chunk of the plain versions.
PLAIN_ELEMS = {"cpu": 1 << 16, "cuda": 1 << 22}

# The qmc_sums and qmc_model_sums kernels' block (csrc/qmc_kernels.cu,
# csrc/qmc_model.cuh); their shifts a thread are the library's own
# (kernel_launch).
QMC_THREADS = 128


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(math.isqrt(n)) + 1):
        if n % p == 0:
            return False
    return True


def prev_prime(n: int) -> int:
    """The largest prime <= n (and < MAX_LATTICE_N)."""
    n = min(n, MAX_LATTICE_N - 1)
    while not _is_prime(n):
        n -= 1
    return n


def _primitive_root(n: int) -> int:
    """The smallest primitive root modulo the prime n."""
    phi = n - 1
    factors = []
    m = phi
    p = 2
    while p * p <= m:
        if m % p == 0:
            factors.append(p)
            while m % p == 0:
                m //= p
        p += 1
    if m > 1:
        factors.append(m)
    for g in range(2, n):
        if all(pow(g, phi // f, n) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root for {n}")


def lattice_vector(n: int, d: int, gamma: float = 0.1) -> np.ndarray:
    """The (d,) uint32 generating vector of a rank-1 lattice mod the prime
    n by fast CBC (Nuyens-Cools): candidates enumerated as powers of a
    primitive root g turn each dimension's error E(z = g^j) into one
    circular correlation, done with FFTs; omega is the Bernoulli-B2
    (Korobov alpha = 2) kernel, ``gamma`` the product weight.  Cached per
    process by value (2^20 points x 100 dimensions take tens of seconds of
    host numpy)."""
    return _lattice_vector(int(n), int(d), float(gamma))


@functools.lru_cache(maxsize=16)
def _lattice_vector(n: int, d: int, gamma: float) -> np.ndarray:
    if not _is_prime(n):
        raise ValueError(f"lattice size must be prime, got {n}")
    if d < 1:
        raise ValueError("d must be >= 1")
    g = _primitive_root(n)
    m = n - 1
    perm = np.empty(m, np.int64)
    perm[0] = 1
    for j in range(1, m):
        perm[j] = perm[j - 1] * g % n

    def omega(x):
        return 2.0 * math.pi ** 2 * (x * x - x + 1.0 / 6.0)

    psi = omega(perm / n)                       # psi[l] = omega({g^l / n})
    fft_psi = np.fft.rfft(psi)
    prod = np.ones(n)                           # running product over points
    z = np.empty(d, np.int64)
    for s in range(d):
        q = prod[perm]                          # product at points i = g^l
        # errors[j] = sum_l q[l] psi[(l + j) mod m]  (circular correlation)
        errors = np.fft.irfft(np.conj(np.fft.rfft(q)) * fft_psi, m)
        j_star = int(np.argmin(errors))
        z[s] = perm[j_star]
        upd = 1.0 + gamma * np.roll(psi, -j_star)  # omega({g^{l+j*} / n})
        prod[perm] *= upd
        prod[0] *= 1.0 + gamma * omega(0.0)
    return z.astype(np.uint32)


@functools.lru_cache(maxsize=32)
def bridge_schedule(n_steps: int):
    """The Brownian bridge's construction order, breadth-first bisection:
    ``(idx, coef)``, entry k setting node idx[k] = (m, l, r) of the W buffer
    (nodes 0..n_steps, W[0] = 0) to c_l W[l] + c_r W[r] + s Z_k with coef[k]
    = (c_l, c_r, s); entry 0 sets W[n] = sqrt(n) Z_0."""
    n = n_steps
    idx = [(n, 0, 0)]
    coef = [(0.0, 0.0, math.sqrt(n))]
    dq = deque([(0, n)])
    while dq:
        l, r = dq.popleft()
        if r - l <= 1:
            continue
        m = (l + r) // 2
        span = r - l
        idx.append((m, l, r))
        coef.append(((r - m) / span, (m - l) / span,
                     math.sqrt((m - l) * (r - m) / span)))
        dq.append((l, m))
        dq.append((m, r))
    if len(idx) != n:
        raise RuntimeError(f"bridge schedule has {len(idx)} entries for "
                           f"{n} steps")
    return np.asarray(idx, np.int32), np.asarray(coef, np.float32)


@dataclasses.dataclass(frozen=True)
class BridgeStream:
    """``bridge_schedule``'s entries in depth-first order, as the bridge
    kernel runs them: ``order[i]`` the schedule entry run i-th (its
    dimension), ``slots[i]`` the slots (out, l, r) of its nodes W[m], W[l],
    W[r]; ``pair_end[m]`` the entries run before step pair m, and
    ``pair_slots[m]`` the slots of W[2m+1] and W[min(2m+2, n)]; W[0] = 0
    starts in slot 0, and ``n_slots`` slots hold every node still to be
    read."""
    order: np.ndarray       # (n,) int32
    slots: np.ndarray       # (n, 3) int32
    pair_end: np.ndarray    # (ceil(n/2),) int32
    pair_slots: np.ndarray  # (ceil(n/2), 2) int32
    n_slots: int

    def tables(self):
        """The kernel's two int32 tables: (n, 4) entries [dimension | out
        << 16 | l << 20 | r << 24, c_l, c_r, s as f32 bits] and the
        (ceil(n/2),) pairs [entries run before | W[2m+1]'s slot << 16 |
        W[hi]'s slot << 20]."""
        n_steps = self.order.shape[0]
        _, coef = bridge_schedule(n_steps)
        s = self.slots.astype(np.int64)
        entries = np.empty((n_steps, 4), np.int32)
        entries[:, 0] = (self.order | (s[:, 0] << 16) | (s[:, 1] << 20)
                         | (s[:, 2] << 24))
        entries[:, 1:] = coef[self.order].view(np.int32)
        ps = self.pair_slots.astype(np.int64)
        pairs = self.pair_end | (ps[:, 0] << 16) | (ps[:, 1] << 20)
        return entries, pairs.astype(np.int32)


@functools.lru_cache(maxsize=32)
def bridge_stream(n_steps: int) -> BridgeStream:
    """The streamed bridge (``BridgeStream``): ``bridge_schedule``'s entries
    in depth-first order (each interval bisected, then its left half, then
    its right), so W comes in time order; step pair m runs once W[2m+1] and
    W[min(2m+2, n)] are set, and a node's slot is freed after its last
    read (the lowest free slot taken first).  At most ~ceil(log2 n) + 2
    nodes are live: 8 slots at 100 steps, 11 at 1,023."""
    n = n_steps
    idx, _ = bridge_schedule(n)
    entry_of = {int(m): k for k, (m, _, _) in enumerate(idx)}
    order, stack = [0], [(0, n)]
    while stack:
        lo, hi = stack.pop()
        if hi - lo > 1:
            mid = (lo + hi) // 2
            order.append(entry_of[mid])
            stack += [(mid, hi), (lo, mid)]
    done = {0: -1} | {int(idx[k][0]): i for i, k in enumerate(order)}
    n_pairs = (n + 1) // 2
    pair_end, end = [], 0
    for m in range(n_pairs):
        end = max(end, done[2 * m + 1] + 1, done[min(2 * m + 2, n)] + 1)
        pair_end.append(end)
    # the events: entries, then each pair once its entries have run
    events, start = [], 0
    for m in range(n_pairs):
        events += [("entry", i) for i in range(start, pair_end[m])]
        events.append(("pair", m))
        start = pair_end[m]
    reads = {}
    for t, (kind, i) in enumerate(events):
        nodes = (idx[order[i]][1:] if kind == "entry"
                 else (2 * i + 1, min(2 * i + 2, n)))
        for j in nodes:
            reads[int(j)] = t
    slot, free, n_slots = {0: 0}, [], 1
    slots = np.zeros((n, 3), np.int32)
    pair_slots = np.zeros((n_pairs, 2), np.int32)
    for t, (kind, i) in enumerate(events):
        if kind == "entry":
            m, lo, hi = (int(v) for v in idx[order[i]])
            if free:
                slot[m] = heapq.heappop(free)
            else:
                slot[m], n_slots = n_slots, n_slots + 1
            slots[i] = (slot[m], slot[lo], slot[hi])
            read = (lo, hi)
        else:
            read = (2 * i + 1, min(2 * i + 2, n))
            pair_slots[i] = (slot[read[0]], slot[read[1]])
        for j in set(read):
            if reads[j] == t:
                heapq.heappush(free, slot.pop(j))
    return BridgeStream(order=np.asarray(order, np.int32), slots=slots,
                        pair_end=np.asarray(pair_end, np.int32),
                        pair_slots=pair_slots, n_slots=n_slots)


@functools.lru_cache(maxsize=8)
def sobol_directions(d: int) -> np.ndarray:
    """(d, 30) uint32 Joe-Kuo direction numbers (values < 2^30): scipy's
    Sobol direction-number matrix (the new-Joe-Kuo-6 table), read as
    ``mc_tpu`` reads it."""
    from scipy.stats import qmc as _sqmc

    sv = np.asarray(_sqmc.Sobol(d=d, scramble=False)._sv, np.uint32)
    if sv.shape != (d, SOBOL_BITS):
        raise RuntimeError(f"unexpected scipy Sobol table {sv.shape}")
    return sv


# ---------------------------------------------------------------------------
# Point sets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QMCPointSet:
    """A randomized point set on a device: ``family`` "lattice" or
    "sobol", ``n`` points in ``d`` dimensions, ``table`` int32 (the
    generating vector (d,), or the flattened Sobol directions (d*30,)) and
    ``shifts`` (R, d) (f32 uniforms, or int32 30-bit digital shifts)."""

    family: str
    n: int
    d: int
    table: torch.Tensor
    shifts: torch.Tensor

    @property
    def n_shifts(self) -> int:
        return int(self.shifts.shape[0])

    def check(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown QMC family {self.family!r}")
        want = self.d * (SOBOL_BITS if self.family == "sobol" else 1)
        dtype = torch.int32 if self.family == "sobol" else torch.float32
        if (self.table.dtype != torch.int32 or self.table.shape != (want,)
                or not self.table.is_contiguous()
                or self.shifts.dtype != dtype or self.shifts.dim() != 2
                or self.shifts.shape[1] != self.d
                or not self.shifts.is_contiguous()
                or self.table.device != self.shifts.device):
            raise ValueError(
                f"a {self.family} point set needs an int32 ({want},) table "
                f"and contiguous {dtype} (R, {self.d}) shifts on one device")
        if not (0 < self.n <= MAX_LATTICE_N and 0 < self.n_shifts < 1 << 16):
            raise ValueError(f"n must be in [1, 2^20] and R in [1, 2^16); "
                             f"got n={self.n}, R={self.n_shifts}")

    def shifted(self, shifts: torch.Tensor) -> "QMCPointSet":
        """The same points under other shifts (a subset, say)."""
        return dataclasses.replace(self, shifts=shifts.contiguous())


def lattice_residue(ids, z, n: int):
    """i z mod n for int64 ids and an int (or int64 tensor) z, exact (the
    integer ``mc_tpu``'s float-assisted Barrett reduction computes in
    int32)."""
    return (ids * z) % n


def point_units(ps: QMCPointSet, ids, dims):
    """Coordinates ``dims`` (a sequence of dimensions) of points ``ids``
    (int64, (chunk,)) under every shift: (len(dims), R, chunk) f32 in [0,
    1).  A dimension past the last reads the last (the second half of an
    odd step count's last pair, never used)."""
    dev = ids.device
    jt = torch.tensor([min(j, ps.d - 1) for j in dims], dtype=torch.int64,
                      device=dev)
    shifts = ps.shifts.T[jt][:, :, None]  # (D, R, 1)
    if ps.family == "lattice":
        t = lattice_residue(ids[None, :],
                            ps.table.to(torch.int64)[jt][:, None], ps.n)
        inv_n = torch.tensor(1.0 / ps.n, dtype=torch.float32, device=dev)
        u = t.to(torch.float32)[:, None, :] * inv_n + shifts
        return u - torch.floor(u)
    # the XOR of the direction numbers v_k over the set bits k of the Gray
    # code, bit b of it the parity of sum_k bit_k(gray) * bit_b(v_k): one
    # small product (exact in f32: the sums are at most 30)
    bit = torch.arange(SOBOL_BITS, dtype=torch.int64, device=dev)
    gray = ids ^ (ids >> 1)
    g_bits = ((gray[:, None] >> bit) & 1).to(torch.float32)  # (chunk, 30)
    v = ps.table.view(ps.d, SOBOL_BITS)[jt].to(torch.int64)  # (D, 30)
    v_bits = ((v[:, :, None] >> bit) & 1).to(torch.float32)  # (D, 30, 30)
    parity = (g_bits[None] @ v_bits).to(torch.int64) & 1  # (D, chunk, 30)
    acc = (parity << bit).sum(dim=2)[:, None, :] ^ shifts.to(torch.int64)
    return rng.bits_to_unit((acc << 2) & 0xFFFFFFFF)


def point_unit(ps: QMCPointSet, ids, j: int):
    """Coordinate j of points ``ids`` under every shift: (R, chunk)."""
    return point_units(ps, ids, [j])[0]


class _Normals:
    """``normals(j)``: the inverse-CDF normals of dimension j, (R, chunk),
    computed ``block`` dimensions at a time (the same values, fewer
    launches; the draws ask for j in order)."""

    def __init__(self, ps: QMCPointSet, ids, block: int = 8):
        self.ps, self.ids, self.block = ps, ids, block
        self.first, self.z = None, None

    def __call__(self, j: int):
        j = min(j, self.ps.d - 1)
        if self.first is None or not 0 <= j - self.first < self.z.shape[0]:
            self.first = j - j % self.block
            dims = range(self.first, min(self.first + self.block, self.ps.d))
            self.z = rng.inv_normal_cdf(point_units(self.ps, self.ids, dims))
        return self.z[j - self.first]


def qmc_draw_pair(ps: QMCPointSet, ids, method: str):
    """draw_pair(m) -> inverse-CDF normals of dimensions (2m, 2m+1) (the
    terminal draw: dimension 0 and zeros), each (R, chunk); ``.unit(j)``
    gives the raw coordinate of dimension j."""
    normals = _Normals(ps, ids)

    def draw_pair(m):
        if method == "terminal":
            z0 = normals(0)
            return z0, torch.zeros_like(z0)
        return normals(2 * m), normals(2 * m + 1)

    draw_pair.unit = lambda j: point_unit(ps, ids, j)
    return draw_pair


def bridge_draw_pair(ps: QMCPointSet, ids, n_steps: int):
    """draw_pair(m) -> the bridge's increments (W[2m+1] - W[2m], W[hi] -
    W[2m+1]), hi = min(2m+2, n_steps) (the clamp of an odd step count's
    unused last half), W built from dimension k at entry k."""
    bidx, bcoef = bridge_schedule(n_steps)
    dev = ids.device
    coef = torch.from_numpy(bcoef).to(dev)
    normals = _Normals(ps, ids)
    w = [None] * (n_steps + 1)
    w[0] = torch.zeros((ps.n_shifts, ids.shape[0]), dtype=torch.float32,
                       device=dev)
    for k in range(n_steps):
        z = normals(k)
        m, l, r = (int(v) for v in bidx[k])
        w[m] = (coef[k, 0] * w[l] + coef[k, 1] * w[r]) + coef[k, 2] * z

    def draw_pair(m):
        hi = min(2 * m + 2, n_steps)
        return w[2 * m + 1] - w[2 * m], w[hi] - w[2 * m + 1]

    return draw_pair


# ---------------------------------------------------------------------------
# The kernels' launch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QmcLaunch:
    """How one call of the qmc_sums or qmc_model_sums kernel runs: ``n_bx``
    path blocks of ``threads`` threads (grid-strided over the points) by
    ``groups`` = ceil(R / k_shifts) shift groups, group g holding shifts
    g*k_shifts .. g*k_shifts + k_shifts-1 (a ragged last group's past R run
    and are not stored)."""
    threads: int
    n_bx: int
    groups: int
    k_shifts: int

    def point_blocks(self, ids):
        """The path block that sums each point of ``ids``: point i runs in
        block (i // threads) mod n_bx, thread i mod threads."""
        return (ids // self.threads) % self.n_bx


def qmc_launch(n: int, n_shifts: int, k_shifts: int,
               threads: int = QMC_THREADS) -> QmcLaunch:
    """The launch of ``n`` points under ``n_shifts`` shifts, ``k_shifts`` a
    thread: n_bx = min(ceil(n / threads), 8192) (the cap grid-strides, so
    the rows' order depends on n alone)."""
    if k_shifts not in (1, 2, 4, 8):
        raise ValueError(f"k_shifts must be 1, 2, 4 or 8; got {k_shifts}")
    return QmcLaunch(threads=threads,
                     n_bx=min(_cuda.cdiv(n, threads), _cuda.MAX_BLOCKS),
                     groups=_cuda.cdiv(n_shifts, k_shifts), k_shifts=k_shifts)


def kernel_launch(ps: QMCPointSet, model: str | None = None,
                  extra: int = 0) -> QmcLaunch:
    """qmc_launch of ``ps`` on the kernel library's own block and shifts a
    thread: qmc_kernel's (``model`` None) or #33's under ``model``
    (``extra``: its integer; the basket's d picks its capacity)."""
    lib = _cuda.load()
    if model is None:
        return qmc_launch(ps.n, ps.n_shifts, lib.mc_qmc_shifts(),
                          lib.mc_qmc_block_threads())
    return qmc_launch(ps.n, ps.n_shifts, lib.mc_qmc_model_shifts(
        QMC_MODELS[model].family_id, extra), lib.mc_qmc_model_block_threads())


def bridge_launch(ps: QMCPointSet, n_steps: int) -> QmcLaunch:
    """qmc_launch of ``ps`` for the bridge kernel over ``n_steps`` on the
    library's own block for that step count and shifts a thread."""
    lib = _cuda.load()
    threads = lib.mc_qmc_bridge_threads(n_steps)
    if threads <= 0:
        raise ValueError(f"the bridge kernel takes at most 1,807 steps; got "
                         f"{n_steps}")
    return qmc_launch(ps.n, ps.n_shifts, lib.mc_qmc_bridge_shifts(), threads)


def qmc_occupancy(family_id: int, payoff: PathPayoff, extra: int) -> int:
    """Resident blocks per SM of #33's kernel under ``family_id`` (extra:
    its integer), of qmc_kernel for family_id -1, or of the bridge kernel
    at 128 threads for -2 (extra: its stream's slots), for ``payoff`` on the
    current card (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _cuda.load()
    blocks = ctypes.c_int(0)
    _cuda.check(lib.mc_qmc_occupancy(family_id, payoff.cuda_id, extra,
                                     ctypes.addressof(blocks)),
                "qmc_occupancy")
    return blocks.value


# ---------------------------------------------------------------------------
# Plain version and wrapper
# ---------------------------------------------------------------------------


def _check(payoff: PathPayoff, cfg: pk.KernelConfig, ps: QMCPointSet,
           params: torch.Tensor, bridge: bool) -> None:
    ps.check()
    pk._check_params(params)
    if ps.table.device != params.device:
        raise ValueError("the point set and params must share a device")
    if cfg.n_paths != ps.n:
        raise ValueError(f"cfg.n_paths ({cfg.n_paths}) must be the point "
                         f"count ({ps.n})")
    need = 1 if cfg.method == "terminal" else cfg.n_steps
    if ps.d != need:
        raise ValueError(f"{cfg.method} over {cfg.n_steps} steps reads {need} "
                         f"dimensions; the point set has {ps.d}")
    if cfg.antithetic or cfg.with_cv or cfg.is_shift or cfg.start_step:
        raise ValueError("QMC runs the plain leg: no antithetic, control "
                         "variate, importance shift or resume")
    if bridge and cfg.method != "euler":
        raise ValueError("bridge=True requires method='euler'")


def qmc_sums_plain(payoff: PathPayoff, cfg: pk.KernelConfig,
                   ps: QMCPointSet, params: torch.Tensor,
                   bridge: bool = False):
    """Plain version of the qmc_sums and qmc_bridge_sums kernels: (chunks,
    R, 1) f64, row c the payoff sums of chunk c's points under each shift."""
    p = pk.unpack_params(params)
    per = max(1, PLAIN_ELEMS[params.device.type] // ps.n_shifts)
    rows = []
    for start in range(0, ps.n, per):
        ids = torch.arange(start, min(start + per, ps.n), dtype=torch.int64,
                           device=params.device)
        draw_pair = (bridge_draw_pair(ps, ids, cfg.n_steps) if bridge
                     else qmc_draw_pair(ps, ids, cfg.method))
        s0 = p.s0.expand(ps.n_shifts, ids.shape[0])
        pay, _ = pk._payoff_leg(payoff, cfg, p, s0, draw_pair)
        rows.append(pay.double().sum(dim=1, keepdim=True))
    return torch.stack(rows)


def qmc_sums(payoff: PathPayoff, cfg: pk.KernelConfig, ps: QMCPointSet,
             params: torch.Tensor, bridge: bool = False):
    """(rows, R, 1) f64: the payoff sums of the ``ps.n`` points under each
    of the R shifts (``finish_sum`` gives the (R, 1) sums); ``cfg`` holds
    the step count and the method (terminal or Euler), ``params`` from
    ``pack_params``; ``bridge`` builds the Euler increments by the
    Brownian bridge."""
    _check(payoff, cfg, ps, params, bridge)
    if params.device.type == "cpu":
        return qmc_sums_plain(payoff, cfg, ps, params, bridge)
    lib = _cuda.load()
    r_shifts = ps.n_shifts
    with torch.cuda.device(params.device):
        stream = _cuda.stream_handle(params.device)
        if bridge:
            geo = bridge_launch(ps, cfg.n_steps)
            stream_ = bridge_stream(cfg.n_steps)
            entries, pairs = (torch.from_numpy(t).to(params.device)
                              for t in stream_.tables())
            partials = torch.empty((geo.n_bx, r_shifts, 1), dtype=torch.float64,
                                   device=params.device)
            status = lib.mc_qmc_bridge_sums(
                payoff.cuda_id, FAMILIES[ps.family], ps.n, ps.d,
                ps.table.data_ptr(), ps.shifts.data_ptr(), r_shifts,
                params.data_ptr(), cfg.n_steps, entries.data_ptr(),
                pairs.data_ptr(), stream_.n_slots, partials.data_ptr(),
                geo.n_bx, geo.groups, stream)
            _cuda.check(status, "qmc_bridge_sums kernel")
            _cuda.count_launch("qmc_bridge_sums")
            return partials
        geo = kernel_launch(ps)
        partials = torch.empty((geo.n_bx, r_shifts, 1), dtype=torch.float64,
                               device=params.device)
        status = lib.mc_qmc_sums(
            payoff.cuda_id, FAMILIES[ps.family],
            int(cfg.method == "euler"), ps.n, ps.d, ps.table.data_ptr(),
            ps.shifts.data_ptr(), r_shifts, params.data_ptr(), cfg.n_steps,
            partials.data_ptr(), geo.n_bx, geo.groups, stream)
    _cuda.check(status, "qmc_sums kernel")
    _cuda.count_launch("qmc_sums")
    return partials


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def qmc_pointset(po: PathPayoff, sim: SimParams, n_shifts: int,
                 method: Optional[str], family: str, bridge: bool,
                 gamma: float, stream: int, seed: int, device):
    """``mc_tpu``'s validated point-set construction (``_qmc_pointset``,
    the same checks raising where it raises): ``(method, QMCPointSet)``.
    The shifts are word 0 of threefry-20 at counters (k, 0), k over R*d,
    under ``derive_key(seed, stream, 0x51AC)``: ``bits_to_unit`` for the
    lattice, ``bits >> 2`` for Sobol."""
    if family not in FAMILIES:
        raise ValueError(f"unknown QMC family {family!r}")
    if method is None:
        method = "terminal" if po.terminal_only else "euler"
    if po.n_state > 0 and method == "terminal":
        raise ValueError(f"{po.name} is path-dependent; method='terminal' "
                         "invalid")
    if n_shifts < 2:
        raise ValueError("n_shifts >= 2 required for an error estimate")
    if bridge and method != "euler":
        raise ValueError("bridge=True requires method='euler'")
    n = _point_count(family, sim.n_paths)
    d = 1 if method == "terminal" else sim.n_steps
    if bridge and (8192 // (sim.n_steps + 1)) // 8 * 8 < 8:
        # mc_tpu's limit (its kernel's (n_steps+1, 8, 128) f32 VMEM
        # scratch), kept so the same calls raise in both packages
        raise ValueError(
            f"bridge=True needs a (n_steps+1, 8, 128) VMEM scratch; "
            f"n_steps={sim.n_steps} exceeds the budget (max ~1023)")
    return method, _pointset(family, n, d, n_shifts, gamma, stream, seed,
                             device)


def _pointset(family: str, n: int, d: int, n_shifts: int, gamma: float,
              stream: int, seed: int, device) -> QMCPointSet:
    """The point set of n points in d dimensions under R = n_shifts shifts:
    word 0 of threefry-20 at counters (k, 0), k over R*d, under
    ``derive_key(seed, stream, 0x51AC)``, ``bits_to_unit`` for the lattice
    (its generating vector by CBC), ``bits >> 2`` for Sobol."""
    key = rng.derive_key(seed, stream, QMC_TAG)
    sidx = torch.arange(n_shifts * d, dtype=torch.int64)
    bits, _ = rng.threefry2x32(int(key[0]), int(key[1]), sidx,
                               torch.zeros_like(sidx), rounds=20)
    if family == "sobol":
        table = torch.from_numpy(
            sobol_directions(d).reshape(-1).astype(np.int32))
        shifts = (bits >> 2).to(torch.int32).reshape(n_shifts, d)
    else:
        table = torch.from_numpy(lattice_vector(n, d, gamma).astype(np.int32))
        shifts = rng.bits_to_unit(bits).reshape(n_shifts, d)
    return QMCPointSet(family=family, n=n, d=d, table=table.to(device),
                       shifts=shifts.contiguous().to(device))


def _point_count(family: str, n_paths: int) -> int:
    """Sobol: the largest power of two <= n_paths, at most 2^20; the
    lattice: the largest prime <= n_paths (below 2^20)."""
    if family == "sobol":
        return 1 << min(int(math.log2(max(n_paths, 2))), 20)
    return prev_prime(n_paths)


def price_qmc(option: OptionParams = DEMO_OPTION,
              sim: SimParams = DEMO_SIM,
              payoff="vanilla_call",
              *,
              n_shifts: int = 16,
              method: Optional[str] = None,
              family: str = "lattice",
              gamma: float = 0.1,
              bridge: bool = False,
              stream: int = STREAM_OUTER,
              device="cuda") -> PriceResult:
    """Randomized-QMC price under GBM with ``n_shifts`` independent
    randomizations on ``device``.  ``family="lattice"``: a rank-1 lattice
    of the largest prime <= sim.n_paths (below 2^20), Cranley-Patterson
    shifts; ``family="sobol"``: a Sobol net of the largest power of two <=
    sim.n_paths (at most 2^20), 30-bit digital shifts.  ``method``: None
    (terminal for a terminal-only payoff, else Euler), "terminal" or
    "euler"; ``bridge`` (Euler) builds the increments by the Brownian
    bridge.  Total samples n * n_shifts; the stderr comes from the spread
    of the shift means.  The shift sums finish in f64."""
    po = get_payoff(payoff)
    dev = resolve_device(device)
    method, ps = qmc_pointset(po, sim, n_shifts, method, family, bridge,
                              gamma, stream, sim.seed, dev)
    cfg = pk.KernelConfig(n_paths=ps.n, n_steps=sim.n_steps, method=method)
    params = pk.pack_params(option, sim.n_steps, dev)
    sums = finish_sum(qmc_sums(po, cfg, ps, params, bridge))[:, 0]
    return finish_qmc(sums, ps.n, option)


def finish_qmc(sums: torch.Tensor, n: int, option: OptionParams,
               discount: Optional[float] = None) -> PriceResult:
    """The price from the (R,) f64 payoff sums of n points per shift: the
    mean and the sample variance of the R shift means, discounted at
    ``discount`` (default e^{-rT} in f32, as ``finish_price``)."""
    r_shifts = sums.shape[0]
    means = sums / n
    mean = means.mean()
    var = ((means - mean) ** 2).sum() / max(r_shifts - 1, 1)
    if discount is None:
        r = torch.tensor(float(option.r), dtype=torch.float32)
        t = torch.tensor(float(option.t), dtype=torch.float32)
        discount = float(torch.exp(-r * t))
    disc = discount
    return PriceResult(price=disc * mean,
                       stderr=disc * torch.sqrt(var / r_shifts),
                       n_paths=torch.tensor(float(n * r_shifts),
                                            dtype=torch.float64),
                       payoff_mean=mean, payoff_var=var)


# ---------------------------------------------------------------------------
# The model half: the same point sets under the model families
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QMCModel:
    """A family that prices on a QMC point set: its FamilyId
    (``csrc/family.cuh``), its demo dynamics at a step count, the dimensions
    a step count takes (``dims(n_steps, extra)``), its pack, its params'
    check and unpack, and its leg on a QMC draw (``models/<family>.qmc_pay``).
    ``extra`` is the family's integer: the Poisson scan depth (Merton, Bates;
    the unpacked ``p.kmax``), the knot count (local vol), d (the basket),
    else 0."""

    family_id: int
    demo: Callable[[int], object]
    dims: Callable[[int, int], int]
    pack: Callable
    check_params: Callable[[torch.Tensor, int, int], None]
    unpack: Callable[[torch.Tensor, int], object]
    leg: Callable
    refuses_sigma: bool  # the packs without sigma: no bridge barriers
    even_steps: bool     # the step loop consumes its draws in step pairs


def _fixed(check):
    """A params check that reads neither the step count nor the extra."""
    return lambda params, n_steps, extra: check(params)


def _with_kmax(unpack):
    """An unpack that adds the Poisson scan depth as ``p.kmax``."""
    def with_kmax(params, kmax):
        p = unpack(params)
        p.kmax = kmax
        return p
    return with_kmax


def _qmc_term_demo(n_steps: int) -> term.TermStructure:
    """``mc_tpu``'s model-QMC term curves: the knots 10%, 5% and 15%, 30%."""
    return term.TermStructure.from_knots([0.10, 0.05], [0.15, 0.30], n_steps)


QMC_MODELS = {
    "heston": QMCModel(heston.FAMILY_HESTON, lambda n: heston.DEMO_HESTON,
                       lambda n, e: 2 * n, heston.pack_heston,
                       _fixed(heston.check_heston_params),
                       lambda prm, e: heston.unpack_heston(prm),
                       heston.qmc_pay, True, False),
    "bates": QMCModel(bates.FAMILY_BATES, lambda n: bates.DEMO_BATES,
                      lambda n, e: 4 * n, bates.pack_bates,
                      _fixed(bates.check_bates_params),
                      _with_kmax(bates.unpack_bates), bates.qmc_pay, True,
                      False),
    "basket": QMCModel(basket.FAMILY_BASKET, lambda n: basket.DEMO_BASKET,
                       lambda n, d: 2 * ((d + 1) // 2) * n,
                       basket.pack_basket,
                       lambda prm, n, d: basket.check_basket_params(prm, d),
                       basket.unpack_basket, basket.qmc_pay, False, False),
    "cev": QMCModel(cev.FAMILY_CEV, lambda n: cev.DEMO_CEV, lambda n, e: n,
                    cev.pack_cev, _fixed(cev.check_cev_params),
                    lambda prm, e: cev.unpack_cev(prm), cev.qmc_pay, True,
                    True),
    "sabr": QMCModel(sabr.FAMILY_SABR, lambda n: sabr.DEMO_SABR,
                     lambda n, e: 2 * n, sabr.pack_sabr,
                     _fixed(sabr.check_sabr_params),
                     lambda prm, e: sabr.unpack_sabr(prm), sabr.qmc_pay,
                     True, False),
    "localvol": QMCModel(localvol.FAMILY_LOCALVOL,
                         localvol.LocalVolSurface.demo, lambda n, e: n,
                         localvol.pack_localvol,
                         lambda prm, n, k: localvol.check_localvol_params(
                             prm, k, n),
                         localvol.unpack_localvol, localvol.qmc_pay, False,
                         True),
    "vasicek": QMCModel(vasicek.FAMILY_VASICEK,
                        lambda n: vasicek.DEMO_VASICEK, lambda n, e: 3 * n,
                        vasicek.pack_vasicek,
                        _fixed(vasicek.check_vasicek_params),
                        lambda prm, e: vasicek.unpack_vasicek(prm),
                        vasicek.qmc_pay, False, True),
    "merton": QMCModel(merton.FAMILY_MERTON, lambda n: merton.DEMO_MERTON,
                       lambda n, e: 3 * n, merton.pack_merton,
                       _fixed(merton.check_merton_params),
                       _with_kmax(merton.unpack_merton), merton.qmc_pay,
                       False, True),
    "term": QMCModel(term.FAMILY_TERM, _qmc_term_demo, lambda n, e: n,
                     term.pack_term,
                     lambda prm, n, e: term.check_term_params(prm, n),
                     lambda prm, e: term.unpack_term(prm), term.qmc_pay,
                     False, True),
}
_MODEL_ERROR = ("QMC model must be one of 'heston', 'bates', 'basket', 'cev', "
                "'sabr', 'localvol', 'vasicek', 'merton', 'term'; got {!r}")


def _model(model: str) -> QMCModel:
    if model not in QMC_MODELS:
        raise ValueError(_MODEL_ERROR.format(model))
    return QMC_MODELS[model]


def _check_model(model: str, payoff: PathPayoff, ps: QMCPointSet,
                 params: torch.Tensor, n_steps: int, extra: int) -> QMCModel:
    m = _model(model)
    ps.check()
    m.check_params(params, n_steps, extra)
    if ps.table.device != params.device:
        raise ValueError("the point set and params must share a device")
    need = m.dims(n_steps, extra)
    if ps.d != need:
        raise ValueError(f"{model} over {n_steps} steps reads {need} "
                         f"dimensions; the point set has {ps.d}")
    if m.refuses_sigma and payoff.name in SIGMA_PAYOFFS:
        raise ValueError(
            f"{payoff.name} corrects for crossings with the GBM bridge "
            f"probability, which reads sigma; the {model} parameters have no "
            "sigma (mc_tpu fails on it too)")
    return m


def qmc_model_sums_plain(model: str, payoff: PathPayoff, ps: QMCPointSet,
                         params: torch.Tensor, n_steps: int, extra: int = 0,
                         ids: Optional[torch.Tensor] = None):
    """Plain version of the qmc_model_sums kernel: (chunks, R, 1) f64, row c
    the payoff sums of chunk c's points through ``model``'s leg under each
    shift.  ``ids``: the (int64) point ids to sum, by default all ``ps.n``."""
    _check_model(model, payoff, ps, params, n_steps, extra)
    if ids is None:
        ids = torch.arange(ps.n, dtype=torch.int64, device=params.device)
    per = max(1, PLAIN_ELEMS[params.device.type] // ps.n_shifts)
    rows = []
    for chunk in ids.split(per):
        pay = qmc_model_payoffs(model, payoff, ps, params, n_steps, extra,
                                chunk)
        rows.append(pay.double().sum(dim=1, keepdim=True))
    return torch.stack(rows)


def qmc_model_payoffs(model: str, payoff: PathPayoff, ps: QMCPointSet,
                      params: torch.Tensor, n_steps: int, extra: int,
                      ids: torch.Tensor) -> torch.Tensor:
    """(R, len(ids)) f32: the payoffs of the points ``ids`` (int64) through
    ``model``'s leg under each shift, the plain version's per-point values."""
    m = _check_model(model, payoff, ps, params, n_steps, extra)
    like = torch.zeros((ps.n_shifts, ids.shape[0]), dtype=torch.float32,
                       device=params.device)
    return m.leg(payoff, m.unpack(params, extra), n_steps, like,
                 qmc_draw_pair(ps, ids, "euler"))


def qmc_model_sums(model: str, payoff: PathPayoff, ps: QMCPointSet,
                   params: torch.Tensor, n_steps: int, extra: int = 0):
    """(rows, R, 1) f64: the payoff sums of the ``ps.n`` points through
    ``model``'s leg (``params`` from its pack) over ``n_steps`` under each
    of the R shifts (``finish_sum`` gives the (R, 1) sums); ``extra`` the
    family's integer (``QMCModel``).  One launch of the qmc_model kernel for
    all R shifts on the card, on ``kernel_launch``'s grid."""
    m = _check_model(model, payoff, ps, params, n_steps, extra)
    if params.device.type == "cpu":
        return qmc_model_sums_plain(model, payoff, ps, params, n_steps, extra)
    lib = _cuda.load()
    geo = kernel_launch(ps, model, extra)
    partials = torch.empty((geo.n_bx, ps.n_shifts, 1), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_qmc_model_sums(
            m.family_id, payoff.cuda_id, FAMILIES[ps.family], ps.n, ps.d,
            ps.table.data_ptr(), ps.shifts.data_ptr(), ps.n_shifts,
            params.data_ptr(), n_steps, extra, partials.data_ptr(), geo.n_bx,
            geo.groups, _cuda.stream_handle(params.device))
    _cuda.check(status, f"qmc_model_sums kernel ({model})")
    _cuda.count_launch("qmc_model_sums")
    return partials


def _even_steps(name: str, n_steps: int) -> None:
    if n_steps % 2:
        raise ValueError(f"{name} requires an even n_steps "
                         "(pair-consuming step loop)")


def qmc_model_dynamics(model: str, dyn, n_steps: int):
    """``mc_tpu``'s per-model checks of ``_qmc_model_pointset``, raising
    where it raises: ``(dyn as f32, extra)``, the family's demo dynamics for
    None (``QMCModel.demo``); ``extra`` is d for the basket, the knot count
    for local vol, else 0 (Merton's and Bates's kmax comes with the
    maturity, ``qmc_model_pointset``)."""
    m = _model(model)
    if dyn is None:
        dyn = m.demo(n_steps)
    if model == "localvol":
        dyn = localvol.validate_surface(dyn, n_steps)
    else:
        dyn = dyn.as_f32()
    if model == "term" and dyn.n_steps != n_steps:
        raise ValueError("term structure must carry one knot per step")
    if m.even_steps:
        _even_steps("CEV" if model == "cev" else model, n_steps)
    extra = (dyn.d if model == "basket" else
             dyn.n_knots if model == "localvol" else 0)
    return dyn, extra


def qmc_model_pointset(model: str, option: OptionParams, dyn, sim: SimParams,
                       payoff="vanilla_call", *, n_shifts: int = 16,
                       family: str = "sobol", gamma: float = 0.1,
                       stream: int = STREAM_OUTER, device):
    """``mc_tpu``'s validated model point-set construction
    (``_qmc_model_pointset``, the same checks raising where it raises):
    ``(payoff, dyn as f32, extra, QMCPointSet)``.  n is the largest power of
    two <= sim.n_paths (at most 2^20) for Sobol, the largest prime for the
    lattice; the dimensions are the family's (2 n_steps for Heston and
    SABR, n_steps for CEV, local vol and term, 3 n_steps for Vasicek and
    Merton, 4 n_steps for Bates, 2 ceil(d/2) n_steps for the basket); the
    shifts are ``qmc_pointset``'s."""
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    dyn, extra = qmc_model_dynamics(model, dyn, sim.n_steps)
    if family not in FAMILIES:
        raise ValueError(f"unknown QMC family {family!r}")
    if n_shifts < 2:
        raise ValueError("n_shifts >= 2 required for an error estimate")
    if model in ("merton", "bates"):
        extra = merton.poisson_kmax(float(dyn.lam) * float(option.t)
                                    / sim.n_steps)
    n = _point_count(family, sim.n_paths)
    d = _model(model).dims(sim.n_steps, extra)
    return po, dyn, extra, _pointset(family, n, d, n_shifts, gamma, stream,
                                     sim.seed, device)


def qmc_model_discount(model: str, option: OptionParams, dyn) -> float:
    """The date-0 discount of a family's payoff mean (``mc_tpu``'s
    ``_model_qmc_discount``): 1 for Vasicek, whose leg discounts pathwise;
    e^{-mean(rates) T} for term, the mean in XLA's f32 reduction order
    (``term.mean_f32``); e^{-rT} otherwise; in f32."""
    t = torch.tensor(float(option.t), dtype=torch.float32)
    if model == "vasicek":
        return 1.0
    if model == "term":
        rates = torch.from_numpy(np.asarray(dyn.rates, np.float32))
        return float(torch.exp(-term.mean_f32(rates) * t))
    r = torch.tensor(float(option.r), dtype=torch.float32)
    return float(torch.exp(-r * t))


def price_qmc_model(model: str,
                    option: OptionParams = DEMO_OPTION,
                    dyn=None,
                    sim: SimParams = DEMO_SIM,
                    payoff="vanilla_call",
                    *,
                    n_shifts: int = 16,
                    family: str = "sobol",
                    gamma: float = 0.1,
                    stream: int = STREAM_OUTER,
                    device="cuda") -> PriceResult:
    """Randomized-QMC price under a model family on ``device``: "heston"
    (the Euler leg), "bates" (Euler), "basket", "cev", "sabr", "localvol",
    "vasicek", "merton" or "term"; ``dyn`` the family's dynamics (None: its
    demo, ``qmc_model_dynamics``).  Pair m of the point set feeds what the
    family's step loop draws as pair m (Merton's and Bates's Poisson counts
    read raw coordinates); ``family="sobol"`` (default) or "lattice".  The
    stderr comes from the spread of the ``n_shifts`` shift means; the sums
    finish in f64, discounted by ``qmc_model_discount``."""
    po, dyn32, extra, ps = qmc_model_pointset(
        model, option, dyn, sim, payoff, n_shifts=n_shifts, family=family,
        gamma=gamma, stream=stream, device=resolve_device(device))
    params = _model(model).pack(option, dyn32, sim.n_steps, ps.table.device)
    sums = finish_sum(qmc_model_sums(model, po, ps, params, sim.n_steps,
                                     extra))[:, 0]
    return finish_qmc(sums, ps.n, option,
                      qmc_model_discount(model, option, dyn32))
