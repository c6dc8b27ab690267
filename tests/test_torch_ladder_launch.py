"""The strike-ladder kernel #6 (ladder_kernel, ``csrc/batch_kernels.cu``):
256 paths a block, P a thread in lockstep, each path's M payoffs evaluated
once, the rows of R strikes a pass reduced together (the lanes folded as the
one-path-a-thread kernel's tree's top levels, the levels down to 64 through
shared halves, the level of 32 and the warp's shuffles a row a warp), the
parameters read from the CUDA source, and the grid the wrapper passes.

No card is needed.  A numpy mirror of the kernel's order, on the plain
version's per-path payoffs, gives the one-path-a-thread kernel's rows (each
thread's f64 [pay, pay^2] from zero, reduce.cuh's 256-wide tree a strike)
bit for bit, and their sums are the plain version's to f64 rounding.
"""

import contextlib
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mc_tpu_torch import engines, rng
from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.ops import _cuda, payoffs
from mc_tpu_torch.ops import path_kernels as pk
from test_torch_rates_launch import shared_tree, warp_levels

CSRC = Path(pk.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "batch_kernels.cu").read_text()
F32 = np.float32
MASK = 0xFFFFFFFF
KEY = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER))


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def block_paths() -> int:
    return _const("kLadderBlockPaths")


def paths_a_thread(euler: bool, n_state: int) -> int:
    """The lanes a launch takes (ladder_paths): the Euler count, or the
    terminal count by the terminal draw, which only a payoff without state
    takes (ladder_switch)."""
    assert ("return euler ? kLadderEulerPaths : kLadderTerminalPaths;"
            in SOURCE)
    switch = SOURCE[SOURCE.index("cudaError_t ladder_switch("):]
    switch = " ".join(switch[:switch.index("\n}\n")].split())
    assert ("if constexpr (Payoff::kStates == 0) return "
            "launch_ladder<Payoff, false>(") in switch
    if euler:
        return _const("kLadderEulerPaths")
    assert n_state == 0
    return _const("kLadderTerminalPaths")


def strikes_a_pass(p: int) -> int:
    """ladder_strikes<T>(): as many strikes as 2 f64 rows of the block's T
    threads each fit in kLadderPassBytes."""
    assert ("return kLadderPassBytes / (2 * T * static_cast<int>(sizeof("
            "double)));") in SOURCE
    m = re.search(r"constexpr int kLadderPassBytes = (\d+) \* 1024;", SOURCE)
    return int(m.group(1)) * 1024 // (2 * (block_paths() // p) * 8)


def path_pays(payoff, cfg, params, strikes, offset=0, n_valid=None):
    """(n_paths, M) f32: each path's payoff at each strike on the plain
    version's legs (the pair's mean if antithetic), zero past the bound."""
    p = pk.unpack_params(params)
    bound = pk._bound(offset, cfg.n_paths, n_valid)
    out = []
    for _, _, ids, valid, draw_pair in pk.path_chunks(cfg, KEY, params,
                                                      offset, bound):
        s0 = p.s0.expand(ids.shape)
        s_t, state, _ = pk.simulate_leg(payoff, cfg, p, s0, draw_pair)
        if cfg.antithetic:
            s_n, state_n, _ = pk.simulate_leg(payoff, cfg, p, s0,
                                              pk._negated(draw_pair))
        cols = []
        for k in strikes:
            pm = SimpleNamespace(**{**vars(p), "k": k})
            pay = payoff.terminal(state, s_t, pm)
            if cfg.antithetic:
                pay = 0.5 * (pay + payoff.terminal(state_n, s_n, pm))
            cols.append(torch.where(valid, pay, 0.0))
        out.append(torch.stack(cols, 1))
    return torch.cat(out).numpy()


def thread_values(pays, n_blocks):
    """Each path's f64 [0 + pay, 0 + pay^2] (add_moments on a zeroed
    accumulator: a -0.0 payoff adds as +0.0), (n_blocks * 256, M, 2), paths
    past the run adding zeros."""
    tile = block_paths()
    x = np.zeros((n_blocks * tile, pays.shape[1]), F32)
    x[:pays.shape[0]] = pays
    v = np.empty(x.shape + (2,))
    v[..., 0] = 0.0 + x.astype(np.float64)
    v[..., 1] = 0.0 + (x * x).astype(np.float64)
    return v


def one_path_rows(pays, n_blocks):
    """The one-path-a-thread kernel: thread t of block b holds path b*256 +
    t, and each strike's rows go through reduce.cuh's 256-wide tree."""
    v = thread_values(pays, n_blocks)
    v = v.reshape(n_blocks, block_paths(), -1, 2).transpose(0, 2, 1, 3)
    return shared_tree(v)  # (n_blocks, M, 2)


def lane_rows(pays, n_blocks, p, r):
    """The kernel's rows, mirrored: thread t of block b runs paths b*256 +
    t + q*T (T = 256/P) in lanes q; a pass of R strikes evaluates strikes
    r0 .. r0+n_pass-1 (a ragged last pass fewer); each row's lanes fold (q
    and q + h at the tree's level T*h) into sh[row][t], then the T threads'
    levels down to 64 in place, the level of 32 and the warp's shuffles
    (warp_levels)."""
    tile = block_paths()
    t_ = tile // p
    v = thread_values(pays, n_blocks).reshape(n_blocks, p, t_, -1, 2)
    m = pays.shape[1]
    rows = np.full((n_blocks, m, 2), np.nan)
    for r0 in range(0, m, r):
        n_pass = min(r, m - r0)
        acc = v[..., r0:r0 + n_pass, :].copy()  # (n_blocks, P, T, n_pass, 2)
        h = p // 2
        while h:
            acc[:, :h] += acc[:, h:2 * h]
            h //= 2
        sh = acc[:, 0].transpose(0, 2, 1, 3)  # (n_blocks, n_pass, T, 2)
        rows[:, r0:r0 + n_pass] = warp_levels(sh)
    assert not np.isnan(rows).any()
    return rows


# (n_paths, offset, n_valid): ragged blocks, ids past 2^32, a bound below the
# run's end
PATH_CASES = ((1, 0, None), (255, 0, None), (256, 0, None), (257, 0, None),
              (4_099, 0, None), (4_099, (1 << 32) - 1_000, None),
              (4_099, 1_000, 1_000 + 2_500))
M_CASES = (1, 3, 17, 64)


def ladder_case(payoff, method, n, m, antithetic=False, offset=0,
                n_valid=None, n_steps=7):
    """(payoff, cfg, params, strikes, pays) of a small ladder."""
    po = payoffs.get_payoff(payoff)
    cfg = pk.KernelConfig(n_paths=n, n_steps=n_steps, method=method,
                          antithetic=antithetic)
    params = pk.pack_params(OptionParams(p1=1.0, p2=6.0), n_steps, "cpu")
    strikes = torch.tensor(np.linspace(60.0, 140.0, m), dtype=torch.float32)
    with np.errstate(all="ignore"):
        pays = path_pays(po, cfg, params, strikes, offset, n_valid)
    return po, cfg, params, strikes, pays


@pytest.mark.parametrize("n,offset,n_valid", PATH_CASES, ids=str)
@pytest.mark.parametrize("m", M_CASES)
@pytest.mark.parametrize("payoff,method,anti", [
    ("vanilla_call", "terminal", False), ("vanilla_put", "terminal", True),
    ("bullet_call", "euler", False), ("asian_call", "euler", True)])
def test_mirror_gives_the_one_path_rows(payoff, method, anti, m, n, offset,
                                        n_valid):
    """At the source's paths a thread (by mode) and strikes a pass, the
    mirror's rows are the one-path-a-thread kernel's bit for bit: M = 1, 3,
    17 and 64 (ragged last passes), ragged blocks, offsets and bounds; and
    they add to the plain version's sums to f64 rounding."""
    po, cfg, params, strikes, pays = ladder_case(payoff, method, n, m, anti,
                                                 offset, n_valid)
    n_blocks = -(-n // block_paths())
    p = paths_a_thread(method == "euler", po.n_state)
    got = lane_rows(pays, n_blocks, p, strikes_a_pass(p))
    want = one_path_rows(pays, n_blocks)
    assert got.tobytes() == want.tobytes()
    plain = pk.simulate_ladder_partials_plain(po, cfg, KEY, params, strikes,
                                              offset, n_valid).sum(0)
    np.testing.assert_allclose(got.sum(0), plain.numpy(), rtol=1e-12,
                               atol=1e-300)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("r", [1, 4, 8, 16])
@pytest.mark.parametrize("m", [1, 17, 64])
def test_every_lane_and_pass_count_keeps_the_rows(p, r, m):
    """Any of the swept paths a thread (1, 2, 4) and strikes a pass keep the
    rows, on payoffs of mixed sign and magnitude with -0.0 among them (where
    another pairing, or a lane's sum not started from zero, rounds
    otherwise)."""
    rs = np.random.default_rng(p * 1000 + r * 10 + m)
    n = 4_099
    pays = (rs.lognormal(0.0, 3.0, (n, m)) * rs.choice([-1, 1], (n, m))
            ).astype(F32)
    pays[::7] = -0.0
    n_blocks = -(-n // block_paths())
    want = one_path_rows(pays, n_blocks)
    assert lane_rows(pays, n_blocks, p, r).tobytes() == want.tobytes()


def test_mirror_catches_a_misordered_fold():
    """The mirror is no tautology: lanes folded in order (q with q + 1)
    rather than as the tree's levels move a row."""
    rs = np.random.default_rng(5)
    n = 1_024
    pays = (rs.lognormal(0.0, 6.0, (n, 3)) * rs.choice([-1, 1], (n, 3))
            ).astype(F32)
    want = one_path_rows(pays, 4)
    v = thread_values(pays, 4).reshape(4, 4, 64, 3, 2)
    seq = ((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3]
    bad = warp_levels(seq.transpose(0, 2, 1, 3))
    assert bad.tobytes() != want.tobytes()


def test_parameters_in_source():
    """The block's 256 paths (the one-path kernel's threads), the lanes a
    power-of-two divisor leaving 64, 128 or 256 threads, the pass size; the
    kernel draws lane q's path at b*256 + q*T + t, folds the lanes before
    the store, reads the strikes uniformly (a ragged pass reading its last),
    and the store finishes a row a warp with the tree's level of 32 and its
    shuffles."""
    assert block_paths() == 256
    for p in (_const("kLadderTerminalPaths"), _const("kLadderEulerPaths")):
        assert 256 % p == 0 and 256 // p in (64, 128, 256)
        assert strikes_a_pass(p) >= 1
    body = SOURCE[SOURCE.index("ladder_kernel(int antithetic"):]
    body = " ".join(body[:body.index("\n}\n")].split())
    assert "constexpr int R = ladder_strikes<T>();" in body
    assert "__shared__ double sh[2 * R][T];" in body
    assert ("const uint32_t i = blockIdx.x * kLadderBlockPaths + q * T + t;"
            in body)
    assert "valid[q] = i < n_paths && id[q] < bound;" in body
    assert "for (int r = 0; r < n_pass; ++r) {" in body
    assert "pm.k = __ldg(strikes + r0 + r);" in body
    assert "lane[q][0] = lane[q][1] = 0.0;" in body
    assert "add_moments(lane[q], pay, x, valid[q], false);" in body
    assert "for (int h = P / 2; h >= 1; h /= 2) {" in body
    assert "lane[q][0] += lane[q + h][0];" in body
    assert "sh[2 * r][t] = lane[0][0]; sh[2 * r + 1][t] = lane[0][1];" in body
    assert "if (r0 > 0) __syncthreads();" in body
    assert "for (int s = T / 2; s >= 64; s /= 2) {" in body
    assert "for (int i = t; i < 2 * n_pass * s; i += T) {" in body
    assert "sh[row][c] = sh[row][c] + sh[row][c + s];" in body
    assert "for (int row = t >> 5; row < 2 * n_pass; row += T / 32) {" in body
    assert "double x = sh[row][lane] + sh[row][lane + 32];" in body
    assert ("for (int s = 16; s > 0; s >>= 1) x = x + "
            "__shfl_down_sync(0xFFFFFFFFu, x, s);") in body
    assert ("double* out = partials + 2 * (static_cast<size_t>(blockIdx.x) * "
            "n_strikes + r0);") in body
    # the legs: each lane's simulate_path, the simulate kernel's leg
    assert ("e[q] = simulate_path<Payoff>( p, EULER, antithetic, p.s0, "
            "Payoff::init(p), 0, n_steps, 0.0f, [&](int m, float& z0, "
            "float& z1) { normal_pair<kBatchRounds>(k0, k1, id[q], "
            "static_cast<uint32_t>(m), z0, z1); });") in body
    assert "ladder_legs" not in SOURCE


def test_ladder_alone_leaves_the_book_and_simulate_kernels():
    """The book kernel keeps its own block and book_store; the ladder's old
    one-tree-a-strike loop is gone."""
    assert "block_store_moments<2, kLadderThreads>" not in SOURCE
    assert "kLadderThreads" not in SOURCE
    assert "book_store<C, N>(acc, n_chunk - g," in SOURCE
    assert "int mc_ladder_block_paths() { return mc::kLadderBlockPaths; }" in SOURCE


@pytest.mark.parametrize("n_paths", [1, 255, 256, 257, 1_000_000,
                                     (1 << 31) + 5])
@pytest.mark.parametrize("tile", [256, 128])
@pytest.mark.parametrize("m", [1, 17])
def test_wrapper_passes_the_grid(monkeypatch, n_paths, tile, m):
    """ceil(n_paths / the library's paths a block) blocks (uncapped: the
    kernel takes each block's paths once), a (blocks, M, 2) row each, one
    launch counted; mc_ladder_block_threads is no longer read."""
    seen = []

    class Lib:
        def __getattr__(self, attr):
            if attr == "mc_ladder_block_paths":
                return lambda: tile
            if attr == "mc_ladder_partials":
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
    strikes = torch.empty(m, dtype=torch.float32, device="meta")
    cfg = pk.KernelConfig(n_paths=n_paths, n_steps=100, method="terminal")
    rows = pk.simulate_ladder_partials(payoffs.get_payoff("vanilla_call"),
                                       cfg, (1, 2), params, strikes)
    blocks = -(-n_paths // tile)
    assert len(seen) == 1 and seen[0][-2] == blocks
    assert seen[0][7] == m and rows.shape == (blocks, m, 2)
    assert _cuda.launch_counts["ladder"] == 1
