"""The launch of the basket's partials kernel #25 (basket_partials_kernel,
``csrc/basket_partials.cuh``): the capacity each d runs at and the paths a
thread there (read from the CUDA sources), the grid the wrapper computes
from the library's paths a block, and the order its f64 rows add in.

No card is needed.  A block sums the 256 paths the one-path-a-thread
kernel's block summed, P a thread (thread t paths t, t + T, ...); a numpy
mirror holds its rows, the lanes added as the old block's tree added its
threads and then the T threads' tree, bit for bit to that kernel's, with
ragged path counts, a bound and grid-strided blocks.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from mc_tpu_torch.models import basket as bm
from mc_tpu_torch.ops import _cuda

CSRC = Path(bm.__file__).resolve().parents[1] / "csrc"
HEADER = (CSRC / "basket_partials.cuh").read_text()
CAPACITIES = (4, 8, 16, 32)


def _body(name: str) -> str:
    """The return expression of the constexpr function ``name``."""
    text = HEADER[HEADER.index(f"constexpr int {name}("):]
    text = text[:text.index("\n}") + 2]
    text = re.sub(r"#ifdef MC_BASKET_PATHS.*?#else", "", text, flags=re.S)
    return re.search(r"return ([^;]+);", text).group(1)


def _ternary(expr: str, env: dict) -> int:
    """Evaluate a C expression of ?: , <= , == and integers in ``env``."""
    expr = expr.strip()
    while expr.startswith("(") and _close(expr, 0) == len(expr) - 1:
        expr = expr[1:-1].strip()
    depth, q = 0, None
    for i, ch in enumerate(expr):
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0 and ch == "?":
            q = i
            break
    if q is None:
        return int(eval(expr, {}, env))
    depth, nest = 0, 0
    for i in range(q + 1, len(expr)):
        ch = expr[i]
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0 and ch == "?":
            nest += 1
        elif depth == 0 and ch == ":":
            if nest == 0:
                cond = _ternary(expr[:q], env)
                return _ternary(expr[q + 1:i] if cond else expr[i + 1:], env)
            nest -= 1
    raise ValueError(expr)


def _close(expr: str, start: int) -> int:
    depth = 0
    for i in range(start, len(expr)):
        depth += expr[i] == "("
        depth -= expr[i] == ")"
        if depth == 0:
            return i
    return -1


def capacity(d: int) -> int:
    return _ternary(_body("basket_capacity"), {"d": d})


def paths(cap: int) -> int:
    return _ternary(_body("basket_paths_per_thread"), {"kMaxD": cap})


def _tile() -> int:
    return int(re.search(r"constexpr int kBasketTile = (\d+);",
                         HEADER).group(1))


@pytest.mark.parametrize("d", range(1, 33))
def test_capacity_is_the_least_that_holds_d(d):
    assert capacity(d) == min(c for c in CAPACITIES if c >= d)


def test_one_dispatch_point_and_a_source_a_capacity():
    """mc_basket_partials picks the capacity of d (and nothing else does);
    capacity 4 is defined beside it, each other in basket<N>_kernels.cu."""
    main = (CSRC / "basket_kernels.cu").read_text()
    body = main[main.index("int mc_basket_partials("):]
    body = body[:body.index("\n}\n")]
    assert "switch (mc::basket_capacity(d))" in body
    for cap in CAPACITIES[:-1]:
        assert f"case {cap}: return mc::basket_partials_{cap}(" in body
    assert f"default: return mc::basket_partials_{CAPACITIES[-1]}(" in body
    assert "MC_DEFINE_BASKET_PARTIALS(4)" in main
    for cap in CAPACITIES[1:]:
        unit = (CSRC / f"basket{cap}_kernels.cu").read_text()
        assert f"MC_DEFINE_BASKET_PARTIALS({cap})" in unit
    py = Path(bm.__file__).read_text()
    assert "capacity" not in py.split("def basket_partials(")[1].split(
        "def basket_trajectories(")[0]


@pytest.mark.parametrize("cap", CAPACITIES)
def test_paths_a_thread_divide_the_tile(cap):
    p = paths(cap)
    assert p in (1, 2, 4, 8) and _tile() % p == 0
    if cap == 32:
        assert p == 1  # one path's 32 log-moneyness values in registers


def test_wrapper_reads_the_librarys_paths_a_block():
    main = (CSRC / "basket_kernels.cu").read_text()
    assert "int mc_basket_block_paths() { return mc::kBasketTile; }" in main
    assert _tile() == 256
    src = Path(bm.__file__).read_text()
    assert "partials_blocks(cfg.n_paths, lib.mc_basket_block_paths())" in src


@pytest.mark.parametrize("n", (1, 255, 256, 257, 1_000_000, 2_097_152,
                               2_100_001))
def test_partials_blocks(n):
    assert bm.partials_blocks(n, 256) == min(-(-n // 256), _cuda.MAX_BLOCKS)


def _thread_sums(pay, valid, n_blocks, tile=256):
    """Each one-path-a-thread kernel thread's f64 [sum, sum of squares] in
    its grid-stride order: (n_blocks * tile, 2)."""
    n = pay.size
    stride = n_blocks * tile
    acc = np.zeros((stride, 2))
    for c in range(0, n, stride):
        x = np.zeros(stride, np.float32)
        m = min(stride, n - c)
        x[:m] = np.where(valid[c:c + m], pay[c:c + m], np.float32(0.0))
        acc[:, 0] += x.astype(np.float64)
        acc[:, 1] += (x * x).astype(np.float64)
    return acc


def _tree(rows):
    """reduce.cuh's block tree over the last-but-one axis (a power of 2)."""
    sh = rows.copy()
    s = sh.shape[-2] // 2
    while s:
        sh[..., :s, :] += sh[..., s:2 * s, :]
        s //= 2
    return sh[..., 0, :]


@pytest.mark.parametrize("p", (1, 2, 4, 8))
@pytest.mark.parametrize("n,n_blocks", ((1_000, 4), (1_000, 3), (5_003, 2),
                                        (77, 1)))
def test_lanes_keep_the_block_sums(p, n, n_blocks):
    """P lanes a thread, added pairwise as the one-path tree's first levels
    (lane p and p + h), then the T threads' tree: each block's row bit for
    bit, with a ragged last block, paths past a bound adding zeros and
    blocks grid-strided."""
    rs = np.random.default_rng(p * n + n_blocks)
    pay = (rs.standard_normal(n) * 37.0).astype(np.float32)
    bound = n - n // 7
    valid = np.arange(n) < bound
    acc = _thread_sums(pay, valid, n_blocks).reshape(n_blocks, 256, 2)
    want = _tree(acc)
    t = 256 // p
    lanes = acc.reshape(n_blocks, p, t, 2).copy()  # lane q: threads q*T + t
    h = p // 2
    while h:
        lanes[:, :h] += lanes[:, h:2 * h]
        h //= 2
    got = _tree(lanes[:, 0])
    assert got.tobytes() == want.tobytes()
