"""The terminal-pair kernel #1 (terminal_pair_kernel,
``csrc/path_kernels.cu``): its lanes and their fold over the element rows,
the trailing odd path's mask, the elements a thread (read from the CUDA
source), the kernels that keep the 256-thread grid, and the grid the
wrapper passes.

No card is needed.  A numpy mirror of the kernel's order (P elements a
thread in lockstep over the grid-stride rounds, each element's f64 [pa +
pb, pa^2 + pb^2] in a lane, the lanes folded as the one-element kernel's
tree's top levels, then the warp's levels) gives the one-element kernel's
rows bit for bit, and its sum, on the plain version's per-element values,
the plain version's sum.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_tpu_torch import engines, rng
from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.ops import _cuda, payoffs
from mc_tpu_torch.ops import path_kernels as pk
from test_torch_rates_launch import shared_tree, warp_levels

CSRC = Path(pk.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "path_kernels.cu").read_text()
PAYOFFS_SRC = (CSRC / "payoffs.cuh").read_text()
F32 = np.float32
TERMINAL = ("vanilla_call", "vanilla_put", "digital_call", "digital_put",
            "best_of_cash", "zcb")


def elems_a_thread() -> int:
    return int(re.search(r"constexpr int kTpElems = (\d+);", SOURCE).group(1))


def one_element_rows(v0, v1, n_blocks, tile=256):
    """The one-element-a-thread kernel: thread t of block b adds elements
    b*tile + t, + stride, ... (v0 = pa + pb, v1 = pa^2 + pb^2, each f32)
    in f64, then reduce.cuh's 256-wide tree."""
    n = v0.size
    stride = n_blocks * tile
    acc = np.zeros((stride, 2))
    for c in range(0, n, stride):
        m = min(stride, n - c)
        acc[:m, 0] += v0[c:c + m].astype(np.float64)
        acc[:m, 1] += v1[c:c + m].astype(np.float64)
    return shared_tree(acc.reshape(n_blocks, tile, 2))


def lane_rows(v0, v1, n_blocks, p, tile=256):
    """The kernel's rows, mirrored: lane q of thread t adds element b*tile
    + t + q*T + r*stride (T = tile/p; an element past the end adds zeros);
    the lanes fold (q and q + h at the tree's level T*h), then the T
    threads' tree with its warp levels."""
    n = v0.size
    t_ = tile // p
    stride = n_blocks * tile
    acc = np.zeros((n_blocks, p, t_, 2))
    for c in range(0, n, stride):
        x = np.zeros((2, stride), F32)
        m = min(stride, n - c)
        x[0, :m], x[1, :m] = v0[c:c + m], v1[c:c + m]
        acc[..., 0] += x[0].reshape(n_blocks, p, t_).astype(np.float64)
        acc[..., 1] += x[1].reshape(n_blocks, p, t_).astype(np.float64)
    h = p // 2
    while h:
        acc[:, :h] += acc[:, h:2 * h]
        h //= 2
    return warp_levels(acc[:, 0])


def element_values(payoff: str, n_elems: int, total: int, rounds: int = 13,
                   **opt):
    """The plain version's per-element f32 [pa + pb, pa^2 + pb^2] on the
    engines' key (pk._terminal_pair_vals: path 2e + 1 masked at total)."""
    params = pk.pack_params(OptionParams(**opt), 100, "cpu")
    p = pk.unpack_params(params)
    k0, k1 = (int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER))
    ids = torch.arange(n_elems, dtype=torch.int64)
    z0, z1 = rng.normal_pair(k0, k1, ids, torch.zeros_like(ids),
                             rounds=rounds)
    v = pk._terminal_pair_vals(payoffs.get_payoff(payoff), p, ids, total,
                               z0, z1)
    return v[0].numpy(), v[1].numpy(), params, (k0, k1)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("n,n_blocks", [(1, 1), (255, 1), (256, 1),
                                        (257, 2), (4_099, 3), (50_001, 8)])
def test_lanes_keep_the_one_element_rows(p, n, n_blocks):
    """P lanes a thread, folded as the tree's top levels, then the warp's
    levels: the one-element kernel's rows bit for bit over ragged element
    counts and several grid-stride rounds."""
    rs = np.random.default_rng(p * 100 + n)
    v0 = (rs.lognormal(0.0, 2.0, n) * rs.choice([-1, 1], n)).astype(F32)
    v1 = rs.lognormal(0.0, 3.0, n).astype(F32)
    v0[::5] = 0.0
    want = one_element_rows(v0, v1, n_blocks)
    assert lane_rows(v0, v1, n_blocks, p).tobytes() == want.tobytes()


@pytest.mark.parametrize("payoff", TERMINAL)
@pytest.mark.parametrize("n,total", [(257, 513), (4_099, 8_197),
                                     (4_099, 8_198), (1, 1)])
def test_rows_sum_to_the_plain_version(payoff, n, total):
    """On the plain version's per-element values, the kernel's rows
    (mirrored at the source's elements a thread) add to the plain
    version's sums, an odd path count masking the last element's second
    path: f64 rounding apart."""
    v0, v1, params, key = element_values(payoff, n, total)
    n_blocks = min(-(-n // 256), _cuda.MAX_BLOCKS)
    rows = lane_rows(v0, v1, n_blocks, elems_a_thread())
    cfg = pk.KernelConfig(n_paths=n, n_steps=100, method="terminal")
    plain = pk.terminal_pair_partials_plain(payoffs.get_payoff(payoff), cfg,
                                            key, params, total).sum(0)
    np.testing.assert_allclose(rows.sum(0), plain.numpy(), rtol=1e-12,
                               atol=1e-300)


def test_odd_total_masks_the_last_path():
    """With an odd path count the last element prices path 2e only: its
    value is pa alone, the pair's pb (> 0, a call struck at 1) dropped."""
    v0, v1, _, _ = element_values("vanilla_call", 4_099, 8_197, k=1.0)
    w0, w1, _, _ = element_values("vanilla_call", 4_099, 8_198, k=1.0)
    assert v0[:-1].tobytes() == w0[:-1].tobytes()
    assert v0[-1] < w0[-1] and v1[-1] < w1[-1]
    flat = " ".join(SOURCE.split())
    assert "const float pa = in && pid < n_paths_total" in flat
    assert "const float pb = in && pid + 1 < n_paths_total" in flat


def test_elements_a_thread_divide_the_block():
    """The elements a thread divide the block's 256 elements into a power
    of two of at least a warp's threads."""
    p = elems_a_thread()
    assert re.search(r"constexpr int kTpBlockElems = 256;", SOURCE)
    assert 256 % p == 0 and 256 // p >= 32
    assert (256 // p) & (256 // p - 1) == 0


def test_kernel_structure_in_source():
    """The lanes draw in lockstep at elements e0 + q*T, the parameters and
    the payoff's state once a thread, the lanes fold before the warp
    helper; every element past the end adds zeros."""
    body = SOURCE[SOURCE.index("terminal_pair_kernel(uint32_t k0"):]
    body = " ".join(body[:body.index("\n}\n")].split())
    assert "normal_pair<ROUNDS>(k0, k1, static_cast<uint32_t>(e0 + q * T), 0u" in body
    assert body.index("load_params(params)") < body.index("for (uint64_t e0")
    assert body.index("Payoff::init(p)") < body.index("for (uint64_t e0")
    assert "const bool in = e < n_elems;" in body
    assert ("block_store_moments_warp<2, T>(acc[0], partials + 2 * "
            "static_cast<size_t>(blockIdx.x));") in body


def test_other_kernels_keep_the_thread_grid():
    """trajectories_kernel (in the same source) keeps 256 threads a block
    and the wrapper's mc_block_threads grid; #1 takes its own count of
    elements a block, and the greek kernel (greek_kernels.cu) its own count
    of paths a block."""
    traj = SOURCE[SOURCE.index("cudaError_t launch_trajectories("):]
    traj = traj[:traj.index("\n}\n")]
    assert traj.count("<<<n_blocks, kThreads, 0, stream>>>") == 2
    assert "block_store_moments<2, kThreads>(" in SOURCE
    wrap = Path(pk.__file__).read_text()
    for fn, grid_fn in (("simulate_trajectories", "_grid"),
                        ("simulate_greek_partials", "greek_grid")):
        body = wrap[wrap.index(f"def {fn}("):]
        body = body[:body.index("\ndef ")]
        assert f"n_blocks = {grid_fn}(lib, cfg.n_paths)" in body
    grid = wrap[wrap.index("def _grid("):]
    assert "lib.mc_block_threads()" in grid[:grid.index("\ndef ")]
    grid = wrap[wrap.index("def greek_grid("):]
    assert "lib.mc_greek_block_paths()" in grid[:grid.index("\ndef ")]
    tp = wrap[wrap.index("def terminal_pair_partials("):]
    tp = tp[:tp.index("\ndef ")]
    assert "n_blocks = terminal_pair_grid(lib, cfg.n_paths)" in tp


def test_six_payoffs_two_rounds():
    """The six terminal-only payoffs under threefry-13 and -20: twelve
    instantiations, as before."""
    m = re.search(r"#define MC_TERMINAL_PAYOFFS\(X\)(.*?)\n//", PAYOFFS_SRC,
                  re.S)
    assert len(re.findall(r"X\(PAYOFF_", m.group(1))) == 6
    launch = SOURCE[SOURCE.index("cudaError_t launch_terminal_pair("):]
    launch = launch[:launch.index("\n}\n")]
    assert "terminal_pair_kernel<Payoff, 13><<<" in launch
    assert "terminal_pair_kernel<Payoff, 20><<<" in launch
    assert "MC_TERMINAL_PAYOFFS(MC_CASE)" in SOURCE


@pytest.mark.parametrize("n_elems", [1, 255, 256, 257, 500_000, 1 << 23,
                                     (1 << 31) - 1])
@pytest.mark.parametrize("block_elems", [256, 128])
def test_wrapper_passes_its_own_grid(monkeypatch, n_elems, block_elems):
    """The wrapper passes ceil(n_elems / the library's elements a block)
    blocks, capped at MAX_BLOCKS, and never reads mc_block_threads; it
    counts the one launch."""
    seen = []

    class Lib:
        def __getattr__(self, attr):
            if attr == "mc_terminal_pair_block_elems":
                return lambda: block_elems
            if attr == "mc_terminal_pair":
                return lambda *args: seen.append(args) or 0
            raise AttributeError(attr)

    monkeypatch.setattr(_cuda, "load", Lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_cuda, "launch_counts",
                        dict.fromkeys(_cuda.KERNELS, 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(pk, "_check_params", lambda params: None)
    params = torch.empty(len(pk.PARAM_FIELDS), device="meta")
    cfg = pk.KernelConfig(n_paths=n_elems, n_steps=100, method="terminal")
    rows = pk.terminal_pair_partials(payoffs.get_payoff("vanilla_call"), cfg,
                                     (1, 2), params, 2 * n_elems - 1)
    assert len(seen) == 1 and rows.shape == (seen[0][-2], 2)
    assert seen[0][-2] == min(-(-n_elems // block_elems), _cuda.MAX_BLOCKS)
    assert seen[0][5:7] == (n_elems, 2 * n_elems - 1)
    assert _cuda.launch_counts["terminal_pair"] == 1
