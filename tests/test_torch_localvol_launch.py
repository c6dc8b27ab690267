"""The local-vol partials kernel #19 (localvol_partials_kernel,
``csrc/localvol_partials.cuh``): its lookup against the knots a thread
holds, the knot capacity each K runs at and the paths a thread (read from
the CUDA sources), the grid the wrapper computes from the library's paths a
block, and the order its f64 rows add in.

No card is needed.  A numpy f32 mirror of the kernel's lookup (a row's level
and slopes read once for the thread's lockstep legs, each leg's ramps
against the held knots added in k order, the floor) holds it to mc_tpu's
``_make_sigma_at`` bit for bit on the demo surface (K = 9) and the K = 25
CEV surface, at w on a grid, at each knot x_k and ramp end x_k + dx_k and
their f32 neighbours; the rows add as the one-path-a-thread kernel's block
tree added its threads, with ragged counts, a bound and grid-strided
blocks.
"""

import contextlib
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import localvol as jl

from mc_tpu_torch.models import localvol as tl
from mc_tpu_torch.ops import _cuda, payoffs
from test_torch_basket_launch import _ternary, _thread_sums, _tree

CSRC = Path(tl.__file__).resolve().parents[1] / "csrc"
HEADER = (CSRC / "localvol_partials.cuh").read_text()
MAIN = (CSRC / "localvol_kernels.cu").read_text()
CAPACITIES = (10,)
F32 = np.float32


def _consts() -> dict:
    head = int(re.search(r"constexpr int kLvHead = (\d+);",
                         (CSRC / "localvol.cuh").read_text()).group(1))
    return {"kLvHead": head}


def _expr(name: str) -> str:
    """The return expression of the constexpr function ``name``."""
    text = HEADER[HEADER.index(f"constexpr int {name}("):]
    text = text[:text.index("\n}\n")]
    expr = re.search(r"return ([^;]+);", text).group(1)
    return " ".join(expr.split())


def capacity(n_knots: int) -> int:
    return _ternary(_expr("localvol_capacity"), {"n_knots": n_knots})


def paths(antithetic: bool) -> int:
    return _ternary(_expr("localvol_paths_per_thread"),
                    {"antithetic": antithetic})


def _tile() -> int:
    return int(re.search(r"constexpr int kLocalVolTile = (\d+);",
                         HEADER).group(1))


def sigma_held(params: np.ndarray, n_knots: int, n_steps: int, cap: int,
               w: np.ndarray, j: int) -> np.ndarray:
    """The kernel's lookup at capacity ``cap`` (0: runtime K) for the legs
    ``w`` on row j: the knots and widths held (the slots past K-1 unused),
    the row's level and slopes read once, each ramp m_k * min(max(w - x_k,
    0), dx_k) added in k order, then the floor."""
    h, km1 = _consts()["kLvHead"], n_knots - 1
    slots = cap - 1 if cap else km1
    x = np.zeros(slots, F32)
    dx = np.zeros(slots, F32)
    x[:km1] = params[h:h + km1]
    dx[:km1] = params[h + n_knots:h + n_knots + km1]
    v0 = params[h + 2 * n_knots - 1:]
    m = v0[n_steps + j * km1:n_steps + (j + 1) * km1]
    sg = np.full(w.shape, v0[j], F32)
    for k in range(slots):
        if k < km1:
            ramp = np.minimum(np.maximum((w - x[k]).astype(F32), F32(0.0)),
                              dx[k])
            sg = (sg + (m[k] * ramp).astype(F32)).astype(F32)
    return np.maximum(sg, F32(1e-4))


def _cev_surface(n_steps):
    """chip_smoke.py's and tests/test_localvol.py's CEV-shaped surface:
    0.2 (S/S0)^-0.3, K = 25 on [-1.5, 1.5]."""
    return jl.LocalVolSurface.from_function(
        lambda x, t: 0.2 * math.exp(-0.3 * x), n_steps, x_lo=-1.5, x_hi=1.5,
        n_knots=25)


def _ws(x: np.ndarray, dx: np.ndarray) -> np.ndarray:
    """A grid of w past both ends, each knot and ramp end, and their f32
    neighbours."""
    ends = np.concatenate([x, (x[:-1] + dx).astype(F32)])
    near = np.concatenate([ends, np.nextafter(ends, F32(-np.inf)),
                           np.nextafter(ends, F32(np.inf))])
    return np.concatenate([np.linspace(-2.5, 2.5, 2001, dtype=F32),
                           near, np.array([0.0, -0.0], F32)]).astype(F32)


@pytest.mark.parametrize("surface", ["demo", "cev"])
def test_held_lookup_is_mc_tpu_bitwise(surface):
    """The kernel's lookup at the capacity K runs at, and at every capacity
    that holds K and at runtime K, against mc_tpu's _make_sigma_at on the
    same packed vector, bit for bit, on every row."""
    n_steps = 100
    jsurf = (jl.LocalVolSurface.demo(n_steps) if surface == "demo"
             else _cev_surface(n_steps))
    k = jsurf.n_knots
    params = np.asarray(jl._pack_localvol(mc_tpu.OptionParams().as_f32(),
                                          jsurf.as_f32(), n_steps))
    h = _consts()["kLvHead"]
    w = _ws(params[h:h + k], params[h + k:h + 2 * k - 1])
    jsig = jl._make_sigma_at(jnp.asarray(params), n_steps, k)
    caps = [0, capacity(k)] + [c for c in CAPACITIES if c >= k]
    assert capacity(k) == (10 if k == 9 else 0)
    for j in range(0, n_steps, 7):
        want = np.asarray(jsig(jnp.asarray(w), j))
        for cap in caps:
            got = sigma_held(params, k, n_steps, cap, w, j)
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


@pytest.mark.parametrize("n_knots", range(2, 70))
def test_capacity_holds_k(n_knots):
    """K runs at the least capacity that holds its K knots, and above the
    largest at runtime K (0): every K >= 2 prices."""
    fits = [c for c in CAPACITIES if c >= n_knots]
    assert capacity(n_knots) == (min(fits) if fits else 0)


def test_one_dispatch_point_and_a_source_a_capacity():
    """mc_localvol_partials picks the capacity of K (and nothing else does);
    runtime K is defined beside it, each capacity in localvol<N>_kernels.cu."""
    body = MAIN[MAIN.index("int mc_localvol_partials("):]
    body = body[:body.index("\n}\n")]
    assert "switch (mc::localvol_capacity(n_knots))" in body
    for cap in CAPACITIES:
        assert f"case {cap}: return mc::localvol_partials_{cap}(" in body
        unit = (CSRC / f"localvol{cap}_kernels.cu").read_text()
        assert f"MC_DEFINE_LOCALVOL_PARTIALS({cap})" in unit
    assert "default: return mc::localvol_partials_0(" in body
    assert "MC_DEFINE_LOCALVOL_PARTIALS(0)" in MAIN
    py = Path(tl.__file__).read_text()
    wrapper = py.split("def localvol_partials(")[1].split(
        "def localvol_trajectories(")[0]
    assert "capacity" not in wrapper


@pytest.mark.parametrize("antithetic", [False, True])
def test_paths_a_thread_divide_the_tile(antithetic):
    """4 lockstep legs a thread: 4 paths, or 2 antithetic paths' two legs."""
    p = paths(antithetic)
    assert p == (2 if antithetic else 4) and _tile() % p == 0


def launch_blocks(monkeypatch, model, name: str, tile: int, call) -> int:
    """The n_blocks a partials wrapper passes to its kernel when the
    library's paths a block (``mc_<name>_block_paths``) is ``tile``: its
    card path run against a stand-in library, on a meta tensor.  Checks
    that the wrapper counts the one launch."""
    seen = []

    class Lib:
        def __getattr__(self, attr):
            if attr == f"mc_{name}_block_paths":
                return lambda: tile
            if attr == f"mc_{name}_partials":
                return lambda *args: seen.append(args[-2]) or 0
            raise AttributeError(attr)

    monkeypatch.setattr(_cuda, "load", Lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_cuda, "launch_counts", dict(_cuda.launch_counts))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(model, f"check_{name}_params", lambda *args: None)
    rows = call()
    assert len(seen) == 1 and rows.shape == (seen[0], 2)
    assert _cuda.launch_counts[f"{name}_partials"] == 1
    return seen[0]


@pytest.mark.parametrize("tile", [256, 128])
@pytest.mark.parametrize("n_paths", [1, 255, 256, 257, 1_000_000,
                                     (1 << 32) - 1])
def test_wrapper_reads_the_librarys_paths_a_block(monkeypatch, n_paths, tile):
    """The grid is ceil(n_paths / the library's paths a block), capped at
    MAX_BLOCKS (the kernel grid-strides past it)."""
    cfg = tl.LocalVolConfig(n_paths=n_paths, n_steps=100, n_knots=9)
    params = torch.empty(tl.packed_length(9, 100), device="meta")
    got = launch_blocks(
        monkeypatch, tl, "localvol", tile,
        lambda: tl.localvol_partials(payoffs.get_payoff("vanilla_call"), cfg,
                                     (1, 2), params))
    assert got == min(-(-n_paths // tile), _cuda.MAX_BLOCKS)


@pytest.mark.parametrize("n,n_blocks", ((1_000, 4), (1_000, 3), (5_003, 2),
                                        (77, 1), (1_000_000, 8)))
@pytest.mark.parametrize("antithetic", [False, True])
def test_lanes_keep_the_block_sums(antithetic, n, n_blocks):
    """The kernel's P lanes a thread, added pairwise as the one-path tree's
    first levels, then its T threads' tree: each block's row bit for bit,
    with a ragged last block, paths past a bound adding zeros and blocks
    grid-strided."""
    tile = _tile()
    p = paths(antithetic)
    rs = np.random.default_rng(n + n_blocks + p)
    pay = (rs.standard_normal(n) * 23.0).astype(F32)
    bound = n - n // 11
    valid = np.arange(n) < bound
    acc = _thread_sums(pay, valid, n_blocks, tile).reshape(n_blocks, tile, 2)
    want = _tree(acc)
    lanes = acc.reshape(n_blocks, p, tile // p, 2).copy()
    h = p // 2
    while h:
        lanes[:, :h] += lanes[:, h:2 * h]
        h //= 2
    got = _tree(lanes[:, 0])
    assert got.tobytes() == want.tobytes()
