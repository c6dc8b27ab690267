"""The launch of the QMC kernels #32 (qmc_kernel) and #33
(qmc_model_kernel), computed on the host by ``qmc.qmc_launch`` from the
library's own block and shifts a thread (``qmc.kernel_launch``) and passed
to the entry points: each kernel's shifts a thread (read from the CUDA
sources), the shift groups with a ragged last group, the path blocks and
which points each block sums.

No card is needed.  The kernels split a coordinate into its
shift-independent part, computed once for a point and dimension (the
lattice residue times 1/n, or the Sobol XOR over the 20 bits an id below
2^20 can set), and each shift's add or XOR; a numpy mirror of that order is
held bit for bit to ``point_units`` (the plain version's coordinates) on
ragged ids across [0, 2^20) and every dimension of a 400-dimension Sobol
table and lattice vector.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_tpu_torch import qmc
from mc_tpu_torch.ops import _cuda

CSRC = Path(qmc.__file__).resolve().parent / "csrc"
LEG_SOURCES = {"heston": ("heston.cuh", "HestonQmcLeg"),
               "bates": ("bates.cuh", "BatesQmcLeg"),
               "basket": ("basket.cuh", "BasketQmcLeg"),
               "cev": ("cev.cuh", "CEVQmcLeg"),
               "sabr": ("sabr.cuh", "SABRQmcLeg"),
               "localvol": ("localvol.cuh", "LocalVolQmcLeg"),
               "vasicek": ("vasicek.cuh", "VasicekQmcLeg"),
               "merton": ("merton.cuh", "MertonQmcLeg"),
               "term": ("term.cuh", "TermQmcLeg")}
RAGGED_R = (1, 2, 3, 5, 16, 17)


def _source_shifts(source: str, struct: str) -> str:
    """The kShifts expression of ``struct`` in ``source``."""
    text = (CSRC / source).read_text()
    body = text[text.index(f"struct {struct} {{"):]
    return re.search(r"static constexpr int kShifts = ([^;]+);", body).group(1)


def _own(expr: str) -> int:
    """The own choice N of ``qmc_shifts(N)`` in a kShifts expression."""
    return int(re.search(r"qmc_shifts\((\d+)\)", expr).group(1))


@pytest.mark.parametrize("model", sorted(qmc.QMC_MODELS))
def test_model_shifts_match_the_sources(model):
    """Each leg's kShifts is 1, 2, 4 or 8, and the library exports the
    leg's own: its family's launcher (MC_QMC_FAMILIES) instantiates it."""
    source, struct = LEG_SOURCES[model]
    assert _own(_source_shifts(source, struct)) in (1, 2, 4, 8)
    kernels = (CSRC / "qmc_kernels.cu").read_text()
    assert "return mc::PREFIX##_qmc_model_shifts();" in kernels
    if model != "basket":  # its two capacities: the next test
        assert f"case mc::FAMILY_{model.upper()}: X({model})" in kernels
    unit = (CSRC / f"qmc_{model}_kernels.cu").read_text()
    assert re.search(rf"#define MC_QMC_LEG {struct}\b", unit)


def test_basket_capacity_32_runs_one_shift():
    expr = _source_shifts("basket.cuh", "BasketQmcLeg")
    assert re.match(r"kMaxD <= 8 \? qmc_shifts\(\d+\) : 1$", expr)
    kernels = (CSRC / "qmc_kernels.cu").read_text()
    assert re.search(r"case mc::FAMILY_BASKET:\s*\\\s*"
                     r"if \(\(BASKET_D\) <= 8\) X\(basket\)\s*\\\s*"
                     r"X\(basket32\)", kernels)


def test_gbm_shifts_and_threads_match_the_sources():
    kernels = (CSRC / "qmc_kernels.cu").read_text()
    k = int(re.search(r"kQmcShifts = qmc_shifts\((\d+)\);",
                      kernels).group(1))
    assert k in (1, 2, 4, 8)
    header = (CSRC / "qmc.cuh").read_text()
    assert f"kSobolIdBits = {qmc.SOBOL_ID_BITS};" in header
    for name in ("kQmcThreads", "kQmcModelThreads"):
        text = kernels + (CSRC / "qmc_model.cuh").read_text()
        assert f"constexpr int {name} = {qmc.QMC_THREADS};" in text


class _Library:
    """A kernel library's launch exports, for kernel_launch off the card."""

    def __init__(self, k_gbm, k_model, threads=128):
        self.k_gbm, self.k_model, self.threads = k_gbm, k_model, threads
        self.asked = []

    def mc_qmc_shifts(self):
        return self.k_gbm

    def mc_qmc_model_shifts(self, family_id, extra):
        self.asked.append((family_id, extra))
        return self.k_model

    def mc_qmc_block_threads(self):
        return self.threads

    mc_qmc_model_block_threads = mc_qmc_block_threads


@pytest.mark.parametrize("model", (None, "heston", "basket"))
@pytest.mark.parametrize("k", (1, 2, 8))
def test_kernel_launch_reads_the_library(monkeypatch, model, k):
    """The wrappers' grid takes its shifts a thread and block from the
    library, so they cannot drift from the kernels'."""
    lib = _Library(k_gbm=k, k_model=k)
    monkeypatch.setattr(_cuda, "load", lambda: lib)
    ps = qmc.QMCPointSet(family="lattice", n=4099, d=2,
                         table=torch.ones(2, dtype=torch.int32),
                         shifts=torch.zeros(5, 2))
    geo = qmc.kernel_launch(ps, model, 9)
    assert (geo.k_shifts, geo.groups, geo.threads, geo.n_bx) == (
        k, -(-5 // k), 128, 33)
    want = [] if model is None else [(qmc.QMC_MODELS[model].family_id, 9)]
    assert lib.asked == want


def test_kernel_launch_refuses_an_unknown_family(monkeypatch):
    monkeypatch.setattr(_cuda, "load", lambda: _Library(4, 0))
    ps = qmc.QMCPointSet(family="lattice", n=128, d=1,
                         table=torch.ones(1, dtype=torch.int32),
                         shifts=torch.zeros(1, 1))
    with pytest.raises(ValueError, match="k_shifts"):
        qmc.kernel_launch(ps, "term", 0)


@pytest.mark.parametrize("k", (1, 2, 4, 8))
@pytest.mark.parametrize("r", RAGGED_R)
def test_shift_groups(r, k):
    geo = qmc.qmc_launch(4099, r, k)
    assert geo.groups == -(-r // k)
    assert geo.k_shifts == k
    # every shift in exactly one group, the last group's surplus past R
    held = [g * k + j for g in range(geo.groups) for j in range(k)]
    assert held[:r] == list(range(r))
    assert len(held) - r == geo.groups * k - r < k


@pytest.mark.parametrize("n", (1, 127, 128, 129, 4099, 1 << 19,
                               1_048_573, 1 << 20))
def test_path_blocks_unchanged(n):
    geo = qmc.qmc_launch(n, 16, 4)
    assert geo.threads == 128
    assert geo.n_bx == min(-(-n // 128), _cuda.MAX_BLOCKS)


@pytest.mark.parametrize("n_bx", (1, 3, 8))
def test_point_blocks_are_the_kernels(n_bx):
    """Block x sums ids x*128 + t + c*n_bx*128, grid-strided: the map
    point_blocks returns and chip_smoke.py's main-shape check sums by."""
    n = 2_000
    geo = qmc.QmcLaunch(threads=128, n_bx=n_bx, groups=4, k_shifts=4)
    ids = torch.arange(n, dtype=torch.int64)
    blocks = geo.point_blocks(ids)
    stride = n_bx * 128
    for x in range(n_bx):
        visited = sorted(i for t in range(128)
                         for i in range(x * 128 + t, n, stride))
        assert ids[blocks == x].tolist() == visited


def test_main_shape_point_blocks():
    geo = qmc.qmc_launch(1 << 20, 16, 4)
    ids = torch.arange(1 << 20, dtype=torch.int64)
    blocks = geo.point_blocks(ids)
    assert geo.n_bx == 8192
    for x in (0, 1, 8191):
        want = list(range(x * 128, (x + 1) * 128))
        assert ids[blocks == x].tolist() == want


def test_launch_refuses_other_shift_counts():
    for k in (0, 3, 16):
        with pytest.raises(ValueError, match="k_shifts"):
            qmc.qmc_launch(1024, 16, k)


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _mirror_units(family, table, shifts, n, ids, d):
    """The kernels' coordinate order in numpy: each (point, dimension)'s
    shift-independent part once, then each shift's; (d, R, len(ids))."""
    if family == "sobol":
        gray = ids ^ (ids >> 1)
        v = table.reshape(d, qmc.SOBOL_BITS).astype(np.int64)
        base = np.zeros((d, ids.size), np.int64)
        for k in range(qmc.SOBOL_ID_BITS):  # the bounded loop
            base ^= np.where((gray >> k) & 1, v[:, k:k + 1], 0)
        bits = (base[:, None, :] ^ shifts.T.astype(np.int64)[:, :, None]) << 2
        as_int = ((bits & 0xFFFFFFFF) >> 9) | 0x3F800000
        return as_int.astype(np.uint32).view(np.float32) - _f32(1.0)
    inv_n = _f32(1.0 / n)
    i = ids.astype(np.int64)

    def mod_int(x):  # the float-assisted Barrett step of qmc.cuh mod_int
        q = np.floor(_f32(x) * inv_n).astype(np.int64)
        r = x - q * n
        r = np.where(r < 0, r + n, r)
        return np.where(r >= n, r - n, r)

    z = table.astype(np.int64)[:, None]
    t = mod_int(i[None, :] * (z >> 10))
    t = mod_int((t << 10) + i[None, :] * (z & 1023))
    base = _f32(t) * inv_n  # once per (point, dimension)
    u = base[:, None, :] + shifts.T[:, :, None]
    return u - np.floor(u)


@pytest.mark.parametrize("family", ("sobol", "lattice"))
def test_coordinate_order_mirror_is_point_units(family):
    rs = np.random.default_rng(20)
    d, n_shifts = 400, 3
    n = 1 << 20 if family == "sobol" else 1_048_573
    if family == "sobol":
        table = qmc.sobol_directions(d).reshape(-1).astype(np.int32)
        shifts = rs.integers(0, 1 << 30, (n_shifts, d)).astype(np.int32)
    else:  # any vector of residues below n: the split arithmetic is the same
        table = rs.integers(1, n, d).astype(np.int32)
        shifts = rs.random((n_shifts, d), dtype=np.float32)
    ids = np.unique(np.concatenate([
        [0, 1, 2, 31, 32, 127, 128, 129, n - 2, n - 1],
        rs.integers(0, n, 1500)])).astype(np.int64)
    ps = qmc.QMCPointSet(family=family, n=n, d=d,
                         table=torch.from_numpy(table),
                         shifts=torch.from_numpy(shifts))
    ps.check()
    want = qmc.point_units(ps, torch.from_numpy(ids), range(d)).numpy()
    got = _mirror_units(family, table, shifts, n, ids, d)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
