"""The book kernel #7 (book_kernel, ``csrc/batch_kernels.cu``): the barrier
test on the log-price against a per-contract threshold (``below_max_w``,
``csrc/barrier.cuh``), several contracts a replayed draw, and the block
reduction of their rows.

No card is needed.  A numpy f32 mirror of ``below_max_w``'s bisection over
the floats' order holds ``w <= threshold`` to a brute-force ``s0 * exp(w) <
B`` around the threshold and at +-inf and NaN, barriers 0, +-inf and NaN, a
spot of 0; a torch mirror of the kernel's legs (w stepped alone, the
barrier payoffs' state from ``w <= threshold``, S formed once at maturity)
holds each path's payoff and control to the plain version's leg, and the
book's rows to ``simulate_book_partials_plain``'s, bit for bit; a numpy
mirror of the kernel's reduction (ping-pong halves, then warp 0's shuffles)
holds its rows to reduce.cuh's block tree; the contracts a thread steps and
the reduction's shared bytes are read from the source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops import payoffs
from mc_tpu_torch.ops.payoffs import get_payoff

CSRC = Path(pk.__file__).resolve().parents[1] / "csrc"
SRC = (CSRC / "batch_kernels.cu").read_text()
BARRIER = (CSRC / "barrier.cuh").read_text()
F32 = np.float32
FLT_MAX = np.finfo(F32).max
NAN = F32(np.nan)

# The payoffs whose update reads S only through S < B (update_below), and
# those that read nothing (the terminal-only ones).
BARRIER_PAYOFFS = ("bullet_call", "up_out_call", "down_in_call")


# --- below_max_w ------------------------------------------------------------


def float_order(x) -> np.ndarray:
    """float_order: a float's place in the order of the floats as a uint32
    (-0 just below +0)."""
    b = np.asarray(x, F32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def order_float(k) -> np.ndarray:
    k = np.asarray(k, np.uint32)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(
        np.uint32).view(F32)


def expf(x) -> np.ndarray:
    """A monotone f32 exp: the f64 exp rounded to f32."""
    with np.errstate(over="ignore", under="ignore"):
        return np.exp(np.asarray(x, F32).astype(np.float64)).astype(F32)


def below(base, w, barrier) -> np.ndarray:
    with np.errstate(invalid="ignore", over="ignore"):
        return (F32(base) * expf(w)).astype(F32) < F32(barrier)


def below_max_w(base, barrier) -> F32:
    """below_max_w: the largest finite w with base * expf(w) < barrier, by
    bisection over the floats' order; -inf if none is, +inf if all are."""
    lo, hi = int(float_order(-FLT_MAX)), int(float_order(FLT_MAX))
    if not below(base, order_float(lo), barrier):
        return F32(-np.inf)
    if below(base, order_float(hi), barrier):
        return F32(np.inf)
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        if below(base, order_float(mid), barrier):
            lo = mid
        else:
            hi = mid
    return F32(order_float(lo))


def below_max_all(base, barrier) -> F32:
    """below_max_all: below_max_w's -inf (no finite w) as NaN."""
    t = below_max_w(base, barrier)
    return NAN if t == -np.inf else t


def test_order_round_trips():
    x = np.array([-np.inf, -FLT_MAX, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0,
                  FLT_MAX, np.inf], F32)
    k = float_order(x)
    assert (np.diff(k.astype(np.int64)) > 0).all()
    assert order_float(k).tobytes() == x.tobytes()


CASES = [(100.0, 120.0), (100.0, 90.0), (100.0, 100.0), (1.0, 1.0),
         (1.0, 1e-30), (1e-30, 1e30), (3e38, 1e-30), (0.0, 1.0),
         (0.0, 0.0), (0.0, -1.0), (-0.0, 1.0), (100.0, 0.0),
         (100.0, -1.0), (100.0, np.inf), (100.0, -np.inf),
         (100.0, np.nan), (np.inf, 100.0), (np.nan, 100.0),
         (np.inf, np.inf), (1.0, np.inf), (1.0, 0.0), (1.0, np.nan)]


@pytest.mark.parametrize("base,barrier", CASES)
def test_threshold_is_the_barrier_test_bitwise(base, barrier):
    """w <= below_max_all(base, barrier) exactly when base * expf(w) <
    barrier: on the threshold's 64 f32 neighbours each side, a grid of w, the
    extremes, +-0, +-inf and NaN (base not below 0)."""
    t = below_max_all(base, barrier)
    w = [np.linspace(-120.0, 120.0, 4001, dtype=F32),
         np.array([-np.inf, -FLT_MAX, -0.0, 0.0, FLT_MAX, np.inf, np.nan,
                   88.0, 88.7, 88.8, -103.0, -104.0], F32)]
    if np.isfinite(t):
        k = int(float_order(t))
        w.append(order_float(np.arange(max(k - 64, 0), min(k + 65, 2**32),
                                       dtype=np.int64).astype(np.uint32)))
    w = np.concatenate(w)
    with np.errstate(invalid="ignore"):
        got = w <= t
    want = below(base, w, barrier)
    assert (got == want).all(), w[got != want][:8]


@pytest.mark.parametrize("base,barrier", [(0.0, 1.0), (0.0, 0.0),
                                          (100.0, 0.0), (100.0, -np.inf),
                                          (100.0, np.nan), (np.nan, 1.0),
                                          (np.inf, 100.0)])
def test_no_finite_w_is_below_gives_nan_or_the_prefix(base, barrier):
    """Where no finite w is below, below_max_w is -inf and the exact
    threshold NaN (w = -inf, at or below -inf, is not below either); a spot
    of 0 is below a positive barrier up to the last w whose expf is
    finite."""
    t = below_max_w(base, barrier)
    if not below(base, F32(-FLT_MAX), barrier):
        assert t == -np.inf and np.isnan(below_max_all(base, barrier))
        assert not below(base, F32(-np.inf), barrier)
    else:
        assert np.isfinite(expf(t)) and not np.isfinite(expf(
            order_float(float_order(t) + 1)))


def test_kernel_threshold_source():
    """The kernel's threshold is below_max_all (barrier.cuh): below_max_w's
    bisection from -FLT_MAX to FLT_MAX, its -inf turned into NaN, for a spot
    not below 0 (the book's other contracts step S itself)."""
    assert "t == -INFINITY ? __int_as_float(0x7fc00000) : t" in BARRIER
    assert "float_order(-FLT_MAX), hi = float_order(FLT_MAX)" in BARRIER
    assert "below_max_s[tid] = below_max_all(p.s0, p.barrier);" in SRC
    assert "by_w = by_w && !(kThreshold && p[c].s0 < 0.0f);" in SRC


# --- the legs ------------------------------------------------------------------


def state_read(po) -> str:
    if po.name in BARRIER_PAYOFFS:
        return "barrier"
    return "none" if po.n_state == 0 else "spot"


def update_below(po, state, below_w, p):
    """update_below of the barrier payoffs (payoffs.cuh): their update with
    the test S < B given."""
    (v,) = state
    step = payoffs._step(below_w, v)
    if po.name == "bullet_call":
        return (v + step,)
    if po.name == "up_out_call":
        return (v * step,)
    return (torch.maximum(v, step),)


def threshold_t(p) -> torch.Tensor:
    """The contract's threshold by bisection over torch's own f32 exp (what
    the plain version's S < B goes through), each probe in a full vector."""
    base, barrier = p.s0.reshape(1), p.barrier.reshape(1)

    def is_below(k):
        w = torch.from_numpy(np.full(64, order_float(k), F32))
        return bool((base * torch.exp(w) < barrier)[0])

    lo, hi = int(float_order(-FLT_MAX)), int(float_order(FLT_MAX))
    if not is_below(lo):
        return torch.tensor(float("nan"))
    if is_below(hi):
        return torch.tensor(float("inf"))
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        lo, hi = (mid, hi) if is_below(mid) else (lo, mid)
    return torch.tensor(float(order_float(lo)))


def mirror_leg(po, cfg, p, s0, draw_pair, below_max):
    """The kernel's leg (book_legs, by_w): w steps as euler_step steps it; a
    barrier payoff's state from w <= below_max, a spot payoff's from S at
    each step; S = s0 * exp(w) once, at maturity."""
    read = state_read(po)
    state = po.init(p, torch.zeros_like(s0))
    w = torch.zeros_like(s0)
    for _, z in pk.step_normals(cfg, draw_pair):
        w = w + (p.drift_dt + p.vol_dt * z)
        if read == "spot":
            state = po.update(state, s0 * torch.exp(w), p)
        elif read == "barrier":
            state = update_below(po, state, w <= below_max, p)
    s_t = s0 * torch.exp(w)
    pay = po.terminal(state, s_t, p)
    x = po.control(state, s_t, p) if po.has_control else s_t
    return pay, x


def book(n: int, seed: int, **fix):
    gen = np.random.default_rng(seed)
    f = dict(s0=gen.uniform(80, 120, n), t=np.full(n, 1.0),
             k=gen.uniform(80, 120, n), r=np.full(n, 0.05),
             sigma=gen.uniform(0.1, 0.4, n), barrier=gen.uniform(85, 125, n),
             p1=np.full(n, 5.0), p2=np.full(n, 30.0), q=np.full(n, 0.01))
    f.update({k: np.full(n, v) for k, v in fix.items()})
    return OptionParams(**{k: v.astype(F32) for k, v in f.items()})


@pytest.mark.parametrize("cv", [False, True])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("name", BARRIER_PAYOFFS + ("vanilla_call",
                                                    "asian_call"))
def test_legs_are_the_plain_leg_bitwise(name, antithetic, cv):
    """Each contract's per-path payoff and control through the kernel's leg
    equal the plain version's leg (S < B at every step) bit for bit, and the
    book's rows assembled from them equal simulate_book_partials_plain's."""
    po = get_payoff(name)
    n_steps = 40
    cfg = pk.KernelConfig(n_paths=4096, n_steps=n_steps, antithetic=antithetic,
                          with_cv=cv)
    rows = pk.pack_params_rows(book(5, 3), n_steps)
    key = (1234, 5678)
    want = pk.simulate_book_partials_plain(po, cfg, key, rows)
    (_, _, ids, valid, draw_pair), = pk.path_chunks(
        cfg, key, rows, 0, cfg.n_paths, pk.PLAIN_CHUNK)
    draws = [draw_pair(m) for m in range(pk._n_pairs(cfg))]
    got = []
    for row in rows:
        p = pk.unpack_params(row)
        s0 = p.s0.expand(ids.shape)
        t = threshold_t(p)
        pay, x = mirror_leg(po, cfg, p, s0, draws.__getitem__, t)
        pay_p, x_p = pk._payoff_leg(po, cfg, p, s0, draws.__getitem__)
        assert torch.equal(pay.view(torch.int32), pay_p.view(torch.int32))
        assert torch.equal(x.view(torch.int32), x_p.view(torch.int32))
        if antithetic:
            neg = pk._negated(draws.__getitem__)
            pay_n, x_n = mirror_leg(po, cfg, p, s0, neg, t)
            pay, x = 0.5 * (pay + pay_n), 0.5 * (x + x_n)
        pay = torch.where(valid, pay, 0.0)
        vals = [pay, pay * pay]
        if cv:
            x = torch.where(valid, x, 0.0)
            vals += [x, x * x, pay * x]
        got.append(pk.moment_row(vals))
    got = torch.stack(got)[None]
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


# --- the contract groups and the reduction -----------------------------------


def contracts(read: str) -> int:
    """kBookContracts of a payoff that reads the spot as ``read``."""
    expr = re.search(r"constexpr int kBookContracts = ([^;]+);", SRC).group(1)
    m = re.fullmatch(r"kStateRead<Payoff> == StateRead::kSpot \? (\d+) : (\d+)",
                     " ".join(expr.split()))
    return int(m.group(1)) if read == "spot" else int(m.group(2))


@pytest.mark.parametrize("read", ["spot", "none", "barrier"])
def test_contracts_a_thread(read):
    """8 contracts a replayed draw; 4 where the leg reads S at each step."""
    assert contracts(read) == (4 if read == "spot" else 8)


def test_static_shared_fits_the_sizing_budget():
    """The reduction's rows (128 + 64 doubles each) and the chunk's
    thresholds are the 10 KB book_block_threads reserves beside the normal
    buffer (BOOK_REDUCE_BYTES): the sizing keeps its block for every step
    count."""
    rows = int(re.search(r"constexpr int kBookRows = (\d+);", SRC).group(1))
    assert "kBookHalfA = kBookMaxThreads / 2;" in SRC
    assert "kBookHalfB = kBookMaxThreads / 4;" in SRC
    assert rows * 8 * (128 + 64) + 4 * 256 == pk.BOOK_REDUCE_BYTES == 10_240
    for n_steps, threads in ((100, 256), (216, 256), (217, 128), (434, 128),
                             (435, 64)):
        cfg = pk.KernelConfig(n_paths=10, n_steps=n_steps)
        assert pk.book_block_threads(cfg) == threads


def groups(n_contracts: int, nt: int, c: int):
    """The kernel's (chunk, group) walk: for each group, the contracts its c
    lanes run (a missing one as the chunk's last) and the rows it stores."""
    out = []
    for c0 in range(0, n_contracts, nt):
        n_chunk = min(nt, n_contracts - c0)
        for g in range(0, n_chunk, c):
            lanes = [c0 + min(g + i, n_chunk - 1) for i in range(c)]
            out.append((lanes, [c0 + g + i for i in range(min(c, n_chunk - g))]))
    return out


@pytest.mark.parametrize("c", [4, 8])
@pytest.mark.parametrize("nt", [32, 256])
@pytest.mark.parametrize("n_contracts", [1, 3, 5, 8, 13, 64, 255, 256, 257,
                                         300, 513])
def test_groups_store_each_contract_once(n_contracts, nt, c):
    stored = [b for _, rows in groups(n_contracts, nt, c) for b in rows]
    assert stored == list(range(n_contracts))
    for lanes, rows in groups(n_contracts, nt, c):
        assert lanes[:len(rows)] == rows
        assert all(lanes[0] // nt == b // nt for b in lanes)  # one chunk


def book_store(acc: np.ndarray) -> np.ndarray:
    """book_store over one pass's rows: acc (nt, rows) f64.  Levels above
    16: the upper half of the live threads writes its values into a half
    (alternating), the lower half adds them; then warp 0's shuffle levels
    16 .. 1, each lane adding its lane + s (its own value past 31)."""
    v = acc.copy()
    nt = v.shape[0]
    s = nt // 2
    while s > 16:
        half = v[s:2 * s].copy()
        v[:s] = v[:s] + half
        s //= 2
    lane = v[:32].copy()
    for s in (16, 8, 4, 2, 1):
        other = np.concatenate([lane[s:], lane[32 - s:]])  # past 31: own
        lane = lane + other
    return lane[0]


@pytest.mark.parametrize("nt", [32, 64, 128, 256])
@pytest.mark.parametrize("n_rows", [2, 5, 6])
def test_reduction_is_the_block_tree_bitwise(nt, n_rows):
    """The kernel's rows equal reduce.cuh's block tree (level s: thread t < s
    adds thread t + s) bit for bit, for every block size the sizing picks,
    on values that do not associate (and with an inf and a NaN row)."""
    rs = np.random.default_rng(nt * 7 + n_rows)
    acc = rs.standard_normal((nt, n_rows)) * 10.0 ** rs.integers(
        -6, 9, (nt, n_rows))
    acc[rs.integers(nt), n_rows - 1] = np.inf
    if n_rows > 2:
        acc[rs.integers(nt), 1] = np.nan
    want = acc.copy()
    s = nt // 2
    while s:
        want[:s] += want[s:2 * s]
        s //= 2
    got = book_store(acc)
    assert got.tobytes() == want[0].tobytes()


def test_reduction_source_levels():
    """The source's levels: the shared ones while s > 16, alternating
    halves; then warp 0's __shfl_down_sync from 16, own value first."""
    assert "for (int s = nt / 2; s > 16; s /= 2, half = kBookHalfA - half)" in SRC
    assert "for (int s = 16; s > 0; s /= 2)" in SRC
    assert ("acc[c][m] = acc[c][m] + __shfl_down_sync(0xFFFFFFFFu, acc[c][m], s);"
            in SRC)
    assert "acc[c][m] = acc[c][m] + halves[(c - cp) * N + m][half + tid];" in SRC
