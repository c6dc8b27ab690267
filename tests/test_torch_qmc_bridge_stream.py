"""The streamed Brownian bridge of the QMC bridge kernel #31
(qmc_bridge_kernel): ``qmc.bridge_stream`` runs ``bridge_schedule``'s
entries depth first, so W comes in time order and a thread keeps only the
nodes still to be read, in a few slots; ``qmc.bridge_launch`` sizes the
kernel's grid from the library's block and shifts a thread.

No card is needed.  The stream is a permutation of the schedule whose every
entry finds its operands set; its slots never hold two live nodes and stay
within the kernel's bound; a numpy f32 mirror of the kernel's order (each
node (c_l W[l] + c_r W[r]) + s z, its slot in a slab) gives W and each step
pair's increments bit for bit as the breadth-first order and
``qmc.bridge_draw_pair`` do; the tables' fields decode to the stream; and
the launch keeps each block's point set with a ragged last shift group.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_tpu_torch import qmc
from mc_tpu_torch.ops import _cuda

CSRC = Path(qmc.__file__).resolve().parent / "csrc"
STEPS = (1, 2, 3, 4, 5, 7, 8, 63, 64, 65, 100, 101, 255, 256, 452, 453,
         1000, 1023)


def _source_int(name: str) -> int:
    text = (CSRC / "qmc_kernels.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _events(st: qmc.BridgeStream, n: int):
    """The kernel's order: ("entry", i) for the i-th streamed entry, ("pair",
    m) once pair_end[m] entries have run."""
    out, start = [], 0
    for m, end in enumerate(st.pair_end):
        out += [("entry", i) for i in range(start, int(end))]
        out.append(("pair", m))
        start = int(end)
    return out


@pytest.mark.parametrize("n", STEPS)
def test_stream_is_the_schedule_depth_first(n):
    """A permutation of the schedule's entries, entry 0 (W[n]) first; each
    entry runs after those that set W[l] and W[r], each step pair after those
    that set W[2m+1] and W[min(2m+2, n)], and every entry runs."""
    idx, _ = qmc.bridge_schedule(n)
    st = qmc.bridge_stream(n)
    assert sorted(st.order.tolist()) == list(range(n))
    assert st.order[0] == 0
    set_at = {0: -1}
    for i, k in enumerate(st.order):
        m, lo, hi = (int(v) for v in idx[k])
        assert lo in set_at and hi in set_at, (n, i, k)
        set_at[m] = i
    assert sorted(set_at) == list(range(n + 1))
    ends = st.pair_end.tolist()
    assert ends == sorted(ends) and ends[-1] == n
    assert len(ends) == (n + 1) // 2
    for m, end in enumerate(ends):
        for j in (2 * m + 1, min(2 * m + 2, n)):
            assert set_at[j] < end


@pytest.mark.parametrize("n", STEPS)
def test_live_slots_within_the_kernels_bound(n):
    """Replaying the kernel's order, a slot is written only when the node it
    held has had its last read, every read finds the node it asks for, and
    the slots number at most ceil(log2 n) + 2 and the kernel's kBridgeSlots
    (and fit the tables' 4-bit fields)."""
    idx, _ = qmc.bridge_schedule(n)
    st = qmc.bridge_stream(n)
    events = _events(st, n)
    last = {}
    for t, (kind, i) in enumerate(events):
        reads = (idx[st.order[i]][1:] if kind == "entry"
                 else (2 * i + 1, min(2 * i + 2, n)))
        for j in reads:
            last[int(j)] = t
    held = {0: 0}  # slot -> node
    for t, (kind, i) in enumerate(events):
        if kind == "entry":
            m, lo, hi = (int(v) for v in idx[st.order[i]])
            out, sl, sr = (int(v) for v in st.slots[i])
            assert held[sl] == lo and held[sr] == hi
            if out in held and held[out] not in (lo, hi):
                assert last[held[out]] < t, (n, t)
            held[out] = m
        else:
            a, b = (int(v) for v in st.pair_slots[i])
            assert held[a] == 2 * i + 1 and held[b] == min(2 * i + 2, n)
    bound = _source_int("kBridgeSlots")
    assert bound <= 16
    assert max(held) + 1 == st.n_slots <= bound
    assert st.n_slots <= math.ceil(math.log2(max(n, 2))) + 2


def _breadth_first(n, z):
    """W in the schedule's order (f32): nodes (n+1, ...)."""
    idx, coef = qmc.bridge_schedule(n)
    w = np.zeros((n + 1,) + z.shape[1:], np.float32)
    for k in range(n):
        m, lo, hi = idx[k]
        w[m] = (coef[k, 0] * w[lo] + coef[k, 1] * w[hi]) + coef[k, 2] * z[k]
    return w


def _streamed(n, z):
    """The kernel's order in numpy f32: a slab of n_slots nodes, W[0] = 0 in
    slot 0, each pair's increments from its slots and the carried W[2m]:
    (W as each node was set, [(z0, z1) per pair])."""
    idx, coef = qmc.bridge_schedule(n)
    st = qmc.bridge_stream(n)
    slab = np.zeros((st.n_slots,) + z.shape[1:], np.float32)
    w = np.full((n + 1,) + z.shape[1:], np.nan, np.float32)
    w[0] = 0.0
    wa = np.zeros(z.shape[1:], np.float32)
    pairs, e = [], 0
    for m, end in enumerate(st.pair_end):
        for e in range(e, int(end)):
            k = st.order[e]
            out, sl, sr = st.slots[e]
            c = coef[k]
            slab[out] = (c[0] * slab[sl] + c[1] * slab[sr]) + c[2] * z[k]
            w[idx[k][0]] = slab[out]
        e = int(end)
        a, b = st.pair_slots[m]
        w1, w2 = slab[a].copy(), slab[b].copy()
        pairs.append((w1 - wa, w2 - w1))
        wa = w2
    return w, pairs


@pytest.mark.parametrize("n", STEPS)
def test_streamed_mirror_is_the_breadth_first_bridge(n):
    z = np.random.default_rng(n).standard_normal((n, 3, 5)).astype(np.float32)
    want = _breadth_first(n, z)
    got, pairs = _streamed(n, z)
    assert got.tobytes() == want.tobytes()
    for m, (z0, z1) in enumerate(pairs):
        hi = min(2 * m + 2, n)
        assert (z0.tobytes() == (want[2 * m + 1] - want[2 * m]).tobytes()
                and z1.tobytes() == (want[hi] - want[2 * m + 1]).tobytes())


@pytest.mark.parametrize("family", ("lattice", "sobol"))
@pytest.mark.parametrize("n", (1, 3, 8, 65, 100))
def test_streamed_mirror_is_bridge_draw_pair(family, n):
    """On the point set's own normals, the streamed increments are
    bridge_draw_pair's (the plain version's) bit for bit."""
    po = qmc.get_payoff("asian_call")
    sim = qmc.SimParams(n_paths=64, n_steps=n)
    _, ps = qmc.qmc_pointset(po, sim, 3, "euler", family, True, 0.1, 0, 11,
                             "cpu")
    ids = torch.arange(ps.n, dtype=torch.int64)
    normals = qmc._Normals(ps, ids)
    z = np.stack([normals(k).numpy() for k in range(n)])
    _, pairs = _streamed(n, z)
    draw = qmc.bridge_draw_pair(ps, ids, n)
    for m, (z0, z1) in enumerate(pairs):
        w0, w1 = draw(m)
        assert z0.tobytes() == w0.numpy().tobytes()
        assert z1.tobytes() == w1.numpy().tobytes()


@pytest.mark.parametrize("n", (1, 5, 100, 1023))
def test_tables_decode_to_the_stream(n):
    """The kernel's fields: entries [dim | out << 16 | l << 20 | r << 24,
    c_l, c_r, s], pairs [end | W[2m+1]'s slot << 16 | W[hi]'s << 20]."""
    _, coef = qmc.bridge_schedule(n)
    st = qmc.bridge_stream(n)
    ent, pairs = st.tables()
    assert ent.dtype == pairs.dtype == np.int32
    assert ent.shape == (n, 4) and pairs.shape == ((n + 1) // 2,)
    code = ent[:, 0].astype(np.int64)
    assert (code & 0xFFFF).tolist() == st.order.tolist()
    got = np.stack([(code >> s) & 15 for s in (16, 20, 24)], axis=1)
    assert got.tolist() == st.slots.tolist()
    assert ent[:, 1:].view(np.float32).tobytes() == coef[st.order].tobytes()
    pc = pairs.astype(np.int64)
    assert (pc & 0xFFFF).tolist() == st.pair_end.tolist()
    got = np.stack([(pc >> s) & 15 for s in (16, 20)], axis=1)
    assert got.tolist() == st.pair_slots.tolist()


def test_bridge_shifts_match_the_source():
    text = (CSRC / "qmc_kernels.cu").read_text()
    k = int(re.search(r"kBridgeShifts = qmc_shifts\((\d+)\);", text).group(1))
    assert k in (1, 2, 4, 8)
    assert "int mc_qmc_bridge_shifts() { return mc::kBridgeShifts; }" in text


class _Library:
    """The bridge kernel's launch exports, for bridge_launch off the card:
    the W-buffer kernel's blocks (128 threads to 451 steps, 64 to 903, 32
    to 1,807)."""

    def __init__(self, k):
        self.k = k

    def mc_qmc_bridge_shifts(self):
        return self.k

    @staticmethod
    def mc_qmc_bridge_threads(n_steps):
        for t in (128, 64, 32):
            if (n_steps + 1) * t * 4 <= 232448 - 8 * 128:
                return t
        return 0


@pytest.mark.parametrize("k", (1, 2, 4, 8))
@pytest.mark.parametrize("r", (1, 3, 16, 17))
@pytest.mark.parametrize("n_steps", (100, 452, 1000))
def test_bridge_launch_reads_the_library(monkeypatch, k, r, n_steps):
    """The grid's shifts a thread and block come from the library: ceil(R /
    k) shift groups, each block's points those of the one-shift kernel."""
    monkeypatch.setattr(_cuda, "load", lambda: _Library(k))
    ps = qmc.QMCPointSet(family="lattice", n=1_048_573, d=n_steps,
                         table=torch.ones(n_steps, dtype=torch.int32),
                         shifts=torch.zeros(r, n_steps))
    geo = qmc.bridge_launch(ps, n_steps)
    threads = _Library.mc_qmc_bridge_threads(n_steps)
    assert (geo.k_shifts, geo.groups, geo.threads) == (k, -(-r // k), threads)
    assert geo.n_bx == min(-(-ps.n // threads), _cuda.MAX_BLOCKS)


@pytest.mark.parametrize("n_steps", (100, 452, 1000))
def test_bridge_blocks_keep_their_points(monkeypatch, n_steps):
    """Block x sums points x*threads + t + c*n_bx*threads (grid-strided at
    64 and 32 threads), as the one-shift kernel's block x did."""
    monkeypatch.setattr(_cuda, "load", lambda: _Library(4))
    n = 1_048_573
    ps = qmc.QMCPointSet(family="lattice", n=n, d=n_steps,
                         table=torch.ones(n_steps, dtype=torch.int32),
                         shifts=torch.zeros(17, n_steps))
    geo = qmc.bridge_launch(ps, n_steps)
    ids = torch.arange(n, dtype=torch.int64)
    blocks = geo.point_blocks(ids)
    stride = geo.n_bx * geo.threads
    for x in (0, 1, geo.n_bx - 1):
        want = np.sort(np.concatenate([
            np.arange(x * geo.threads + t, n, stride)
            for t in range(geo.threads)]))
        assert ids[blocks == x].numpy().tolist() == want.tolist()


def test_bridge_launch_refuses_past_the_kernels_steps(monkeypatch):
    monkeypatch.setattr(_cuda, "load", lambda: _Library(4))
    ps = qmc.QMCPointSet(family="lattice", n=4099, d=1808,
                         table=torch.ones(1808, dtype=torch.int32),
                         shifts=torch.zeros(2, 1808))
    with pytest.raises(ValueError, match="1,807 steps"):
        qmc.bridge_launch(ps, 1808)


def test_library_threads_rule_is_the_sources():
    """The mirror above is the kernel's bridge_threads: the W buffer's rule
    on kQmcSmemBytes, kept so each block sums the same points."""
    text = (CSRC / "qmc_kernels.cu").read_text()
    assert "constexpr int kQmcSmemBytes = 232448 - 8 * kQmcThreads;" in text
    assert re.search(r"static_cast<long long>\(n_steps \+ 1\) \* t \* 4 <= "
                     r"kQmcSmemBytes", text)
