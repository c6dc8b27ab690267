"""The launch of the basket's trajectories kernel #26
(basket_trajectories_kernel, ``csrc/basket_partials.cuh``): the capacity
each d runs at (the partials kernel's one dispatch point), the paths a
thread there (read from the CUDA sources), the grid entries each lane
stores, the order its f64 rows add in and the grid the wrapper passes.

No card is needed.  A block runs the 256 paths the one-path-a-thread
kernel's block ran, P a thread (thread t paths t, t + T, ...); a mirror of
the lanes' store index covers every (step, path) entry of the step-major
grids exactly once, and a numpy mirror of the rows (the lanes added as the
old block's tree added its threads, then the T threads' tree) gives that
kernel's rows bit for bit.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_tpu_torch.models import basket as bm
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff
from test_torch_basket_launch import (CAPACITIES, _body, _ternary, _thread_sums,
                                      _tree, capacity)

CSRC = Path(bm.__file__).resolve().parents[1] / "csrc"
HEADER = (CSRC / "basket_partials.cuh").read_text()
MAIN = (CSRC / "basket_kernels.cu").read_text()
ONE_WORD = sorted(n for n, po in PAYOFFS.items() if po.n_state <= 1)


def grid_paths(cap: int) -> int:
    """basket_grid_paths_per_thread(cap), read from the source."""
    text = HEADER[HEADER.index("constexpr int basket_grid_paths_per_thread("):]
    text = text[:text.index("\n}") + 2]
    return _ternary(re.search(r"return ([^;]+);", text).group(1),
                    {"kMaxD": cap})


def stored_entries(n: int, steps: int, n_blocks: int, p: int, tile=256):
    """How many times the kernel stores each entry j*n + i of a (steps, n)
    grid: thread t of block b, grid-stride round r, lane q runs path i =
    b*tile + t + r*stride + q*(tile/p) and, where i < n, stores entry
    j*n + i after each step j."""
    t_ = tile // p
    stride = n_blocks * tile
    count = np.zeros(steps * n, np.int64)
    base = (np.arange(n_blocks)[:, None] * tile + np.arange(t_)[None, :])
    for r0 in range(0, max(n, 1), stride):
        for q in range(p):
            i = (base + r0 + q * t_).ravel()
            i = i[i < n]
            for j in range(steps):
                np.add.at(count, j * n + i, 1)
    return count


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("n,n_blocks", [(1, 1), (255, 1), (256, 1), (257, 2),
                                        (1_000, 4), (1_000, 3), (5_003, 2),
                                        (100_001, 391)])
def test_store_index_covers_the_grid_once(p, n, n_blocks):
    """Each (step, path) entry is stored exactly once, by ragged blocks,
    lanes past the last path and blocks that grid-stride."""
    count = stored_entries(n, 3, n_blocks, p)
    assert count.min() == 1 and count.max() == 1


def test_store_is_the_lanes_own_entry():
    """The store lambda writes lane p's level and state word 0 at its own
    path's column, row + p*T (row = j*n_paths + i), only where i + p*T <
    n_paths; every one-word payoff stores its word (0 for the terminal
    ones)."""
    body = HEADER[HEADER.index("basket_trajectories_kernel(uint32_t k0"):]
    body = " ".join(body[:body.index("\n}\n")].split())
    assert "const size_t row = static_cast<size_t>(j) * n_paths + i;" in body
    assert "if (i + p * T < n_paths) {" in body
    assert "b_grid[row + p * T] = b[p];" in body
    assert ("state_grid[row + p * T] = Payoff::kStates ? st[p].w[0] : 0.0f;"
            in body)
    assert "add_moments(acc[p], pv, i + p * T < n_paths && id[p] < bound);" \
        in body
    assert "id[p] = path_offset + static_cast<uint32_t>(i + p * T);" in body


@pytest.mark.parametrize("p", (1, 2, 4))
@pytest.mark.parametrize("n,n_blocks", ((1_000, 4), (1_000, 3), (5_003, 2),
                                        (77, 1), (600_001, 2)))
def test_lanes_keep_the_block_rows(p, n, n_blocks):
    """P lanes a thread, added pairwise as the one-path tree's first levels,
    then the T threads' shared tree: each block's row bit for bit, with a
    ragged last block, paths past a bound adding zeros and blocks
    grid-strided."""
    rs = np.random.default_rng(p * n + n_blocks + 26)
    pay = (rs.lognormal(0.0, 2.5, n) * rs.choice([-1, 1], n)).astype(
        np.float32)
    pay[::11] = 0.0
    valid = np.arange(n) < n - n // 5
    acc = _thread_sums(pay, valid, n_blocks).reshape(n_blocks, 256, 2)
    want = _tree(acc)
    lanes = acc.reshape(n_blocks, p, 256 // p, 2).copy()
    h = p // 2
    while h:
        lanes[:, :h] += lanes[:, h:2 * h]
        h //= 2
    assert _tree(lanes[:, 0]).tobytes() == want.tobytes()
    body = HEADER[HEADER.index("basket_trajectories_kernel(uint32_t k0"):]
    body = body[:body.index("\n}\n")]
    assert ("block_store_moments<2, T>(acc[0], partials + 2 * "
            "static_cast<size_t>(blockIdx.x), 2);") in body


@pytest.mark.parametrize("cap", CAPACITIES)
def test_paths_a_thread_divide_the_tile(cap):
    """The trajectories kernel's paths a thread at each capacity divide the
    256 paths of a block into a power of two of at least a warp; capacity
    32 runs one (its normals and pack staged in shared memory)."""
    p = grid_paths(cap)
    assert p in (1, 2, 4, 8) and 256 % p == 0 and 256 // p >= 32
    if cap == 32:
        assert p == 1
    body = HEADER[HEADER.index("basket_trajectories_kernel(uint32_t k0"):]
    body = body[:body.index("\n}\n")]
    assert "__shared__ float z_sh[32 * kBasketTile];" in body
    assert "basket_path32<Payoff, false>(c, zs, k0, k1, id[0], n_steps, " \
        "store)" in body


def test_one_dispatch_point_and_a_source_a_capacity():
    """mc_basket_trajectories picks the capacity of d through
    basket_capacity, as mc_basket_partials does; capacity 4 is defined
    beside it, each other in basket<N>_kernels.cu beside its partials."""
    body = MAIN[MAIN.index("int mc_basket_trajectories("):]
    body = body[:body.index("\n}\n")]
    assert "switch (mc::basket_capacity(d))" in body
    for cap in CAPACITIES[:-1]:
        assert f"case {cap}: return mc::basket_trajectories_{cap}(" in body
    assert f"default: return mc::basket_trajectories_{CAPACITIES[-1]}(" in body
    assert "MC_DEFINE_BASKET_TRAJECTORIES(4)" in MAIN
    for cap in CAPACITIES[1:]:
        unit = (CSRC / f"basket{cap}_kernels.cu").read_text()
        assert f"MC_DEFINE_BASKET_PARTIALS({cap})" in unit
        assert f"MC_DEFINE_BASKET_TRAJECTORIES({cap})" in unit
    assert "__global__" not in MAIN  # no kernel of its own


@pytest.mark.parametrize("d", range(1, 33))
def test_capacity_holds_d(d):
    """d runs at the least capacity that holds it (d = 5 at 8, not 4),
    whose unrolled loops reach every asset."""
    cap = capacity(d)
    assert cap >= d and cap == min(c for c in CAPACITIES if c >= d)
    assert _ternary(_body("basket_capacity"), {"d": d}) == cap


def test_one_word_payoffs_and_no_twin():
    """The trajectories kernel takes the twelve one-word payoffs and runs
    no antithetic twin."""
    assert len(ONE_WORD) == 12
    sw = HEADER[HEADER.index("cudaError_t basket_trajectories_switch("):]
    sw = sw[:sw.index("\n}\n")]
    assert "MC_ONE_WORD_PAYOFFS(MC_CASE)" in sw
    assert "basket_trajectories_kernel<PAYOFF, kMaxD><<<n_blocks, T, 0, " \
        "stream>>>(" in sw
    body = HEADER[HEADER.index("basket_trajectories_kernel(uint32_t k0"):]
    body = body[:body.index("\n}\n")]
    assert "basket_paths<Payoff, kMaxD, P, false>(" in body


@pytest.mark.parametrize("payoff", ONE_WORD)
@pytest.mark.parametrize("d", [1, 4, 5, 9, 17, 32])
@pytest.mark.parametrize("n_paths,block_paths", [(1, 256), (255, 256),
                                                 (257, 256), (100_000, 256),
                                                 (3_000_000, 256),
                                                 (1_000, 128)])
def test_wrapper_passes_the_grid(monkeypatch, payoff, d, n_paths,
                                 block_paths):
    """The wrapper passes the payoff's id, d and ceil(n_paths / the
    library's trajectories paths a block) blocks, capped at MAX_BLOCKS
    (never mc_basket_block_threads), and counts the one launch."""
    seen = []

    class Lib:
        def __getattr__(self, attr):
            if attr == "mc_basket_trajectories_block_paths":
                return lambda: block_paths
            if attr == "mc_basket_trajectories":
                return lambda *args: seen.append(args) or 0
            raise AttributeError(attr)

    monkeypatch.setattr(_cuda, "load", Lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_cuda, "launch_counts",
                        dict.fromkeys(_cuda.KERNELS, 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(bm, "check_basket_params", lambda *args: None)
    params = torch.empty(bm.packed_length(d), device="meta")
    cfg = bm.BasketConfig(n_paths=n_paths, n_steps=3, d=d)
    b, st, rows = bm.basket_trajectories(get_payoff(payoff), cfg, (1, 2),
                                         params)
    assert len(seen) == 1
    args = seen[0]
    assert args[0] == get_payoff(payoff).cuda_id and args[4] == d
    assert args[5] == 3 and args[6] == n_paths
    assert args[-2] == min(-(-n_paths // block_paths), _cuda.MAX_BLOCKS)
    assert rows.shape == (args[-2], 2) and b.shape == (3, n_paths)
    assert _cuda.launch_counts["basket_trajectories"] == 1
