"""The pathwise-greek kernel #8 (greek_kernel, ``csrc/greek_kernels.cu``): a
kernel per mode, S formed once at maturity under Euler for a payoff without
state, P paths a thread in lockstep and their lanes' fold over the
ten-moment block rows, the paths a thread (read from the CUDA source) and
the grid, mode and payoff the wrapper passes.

No card is needed.  A numpy mirror of the kernel's order (P paths a thread
over the grid-stride rounds, each path's ten f64 moments in a lane, the
lanes folded as the one-path kernel's tree's top levels, then the warp's
levels) gives the one-path kernel's rows bit for bit, and its sum, on the
plain version's per-path values, the plain version's sum.  The Euler leg
that forms S once at maturity has the bits of the one that forms it at
every step, on seeded draws through the plain leg's arithmetic.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PATHWISE, get_payoff
from test_torch_basket_launch import _tree
from test_torch_rates_launch import warp_levels

torch.set_num_threads(1)

CSRC = Path(pk.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "greek_kernels.cu").read_text()
F32 = np.float32
INF, NAN = float("inf"), float("nan")
KEY = (0x1234ABCD, 0x5A97)


def paths_a_thread(euler: bool) -> int:
    """greek_paths_per_thread of the source."""
    m = re.search(r"int greek_paths_per_thread\(bool euler\) \{\n  return "
                  r"euler \? (\d+) : (\d+);", SOURCE)
    return int(m.group(1) if euler else m.group(2))


def block_paths() -> int:
    return int(re.search(r"constexpr int kGreekBlockPaths = (\d+);",
                         SOURCE).group(1))


def _body(name: str) -> str:
    """The source of the function ``name``, one line of
    whitespace-collapsed text."""
    body = SOURCE[SOURCE.index(name):]
    return " ".join(body[:body.index("\n}\n")].split())


def thread_moments(vals, valid, n_blocks, tile=256):
    """Each one-path-a-thread kernel thread's f64 [v_0, v_0^2, v_1, v_1^2,
    ...] in its grid-stride order: (n_blocks * tile, 2K) for vals (n, K)."""
    n, k = vals.shape
    stride = n_blocks * tile
    acc = np.zeros((stride, 2 * k))
    for c in range(0, n, stride):
        x = np.zeros((stride, k), np.float32)
        m = min(stride, n - c)
        x[:m] = np.where(valid[c:c + m, None], vals[c:c + m], np.float32(0.0))
        acc[:, 0::2] += x.astype(np.float64)
        acc[:, 1::2] += (x * x).astype(np.float64)
    return acc


def lane_rows(vals, valid, n_blocks, p, tile=256):
    """The kernel's rows, mirrored: lane q of thread t adds path b*tile + t
    + q*T + r*stride (T = tile/p; a path past the end adds zeros); the
    lanes fold (q and q + h at the tree's level T*h), then the T threads'
    tree with its warp levels."""
    acc = thread_moments(vals, valid, n_blocks, tile)
    acc = acc.reshape(n_blocks, p, tile // p, acc.shape[-1])
    h = p // 2
    while h:
        acc[:, :h] += acc[:, h:2 * h]
        h //= 2
    return warp_levels(acc[:, 0])


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("n,n_blocks", [(1, 1), (255, 1), (256, 1), (257, 2),
                                        (4_099, 3), (20_001, 8)])
def test_lanes_keep_the_one_path_rows(p, n, n_blocks):
    """P lanes a thread, folded as the tree's top levels, then the warp's
    levels: the one-path kernel's ten-column rows (its 256-wide shared
    tree) bit for bit over ragged path counts and several grid-stride
    rounds."""
    rs = np.random.default_rng(p * 11 + n)
    vals = (rs.standard_normal((n, 5)) * [30.0, 1.0, 40.0, 50.0, 60.0]
            ).astype(F32)
    vals[::5, 0] = 0.0
    valid = np.ones(n, bool)
    want = _tree(thread_moments(vals, valid, n_blocks).reshape(n_blocks, 256,
                                                               10))
    got = lane_rows(vals, valid, n_blocks, p)
    assert got.shape == (n_blocks, 10)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("euler", [False, True])
def test_paths_a_thread_divide_the_block(euler):
    """Each mode's paths a thread divide the block's 256 paths into a power
    of two of at least a warp's threads."""
    p = paths_a_thread(euler)
    t = block_paths() // p
    assert block_paths() == 256 and 256 % p == 0 and t >= 32
    assert t & (t - 1) == 0


def test_no_runtime_mode_test_in_the_path_loop():
    """The mode is a template parameter picked on the host: the kernel takes
    no euler argument and its path loop tests no flag; the entry point
    sends Euler to the Euler kernel and the terminal draw, for a payoff
    without state alone, to the terminal one."""
    kernel = _body("greek_kernel(uint32_t k0")
    assert "euler" not in kernel and "if (EULER)" not in kernel
    legs = _body("void greek_paths(")
    assert "if constexpr (!EULER)" in legs and "euler" not in legs
    switch = _body("cudaError_t greek_switch(")
    assert "if (euler) return launch_greek<Payoff, true>(" in switch
    assert ("if constexpr (Payoff::kStates == 0) return launch_greek<Payoff, "
            "false>(") in switch
    assert "int mc_greek_partials(int payoff_id, int rounds, int euler," \
        in SOURCE


def test_kernel_structure_in_source():
    """The lanes draw paths i + q*T at pair m, the parameters once a thread
    before the loop, a lane past the last path adds zeros, the ten moments
    fold before the warp helper; S once at maturity for a payoff without
    state, at each step for one with state."""
    body = _body("greek_kernel(uint32_t k0")
    assert ("normal_pair<ROUNDS>(k0, k1, static_cast<uint32_t>(i + q * T), "
            "static_cast<uint32_t>(m), z0, z1);") in body
    assert body.index("const Params p = load_params(params);") < body.index(
        "for (uint64_t i")
    assert "add_moments(acc[q], v, i + q * T < n_paths);" in body
    assert ("block_store_moments_warp<kGreekMoments, T>( acc[0], partials + "
            "static_cast<size_t>(kGreekMoments) * blockIdx.x);") in body
    legs = _body("void greek_paths(")
    step = legs[legs.index("const auto step"):legs.index("float z0[P]")]
    assert step.count("expf(") == 1
    assert step.index("if constexpr (Payoff::kStates > 0) {") < step.index(
        "s[q] = p.s0 * expf(w[q]);")
    end = legs[legs.index("if (n_steps & 1)"):]
    assert ("if constexpr (Payoff::kStates == 0) s[q] = p.s0 * expf(w[q]);"
            in end)
    assert "block_store_moments<" not in SOURCE


def _s_once_leg(payoff, cfg, p, draw_pair, like):
    """The kernel's Euler leg for a payoff without state: w and sum_z each
    step, S = s0 expf(w) once at maturity, then the tangents at T."""
    zero = torch.zeros_like(like)
    state = payoff.init(p, zero)
    dstates = [tuple(torch.zeros_like(a) for a in state)] * 4
    sqrt_dt = p.vol_dt / p.sigma
    w, sum_z = zero, zero
    for _, z in pk.step_normals(cfg, draw_pair):
        w = w + (p.drift_dt + p.vol_dt * z)
        sum_z = sum_z + z
    s = p.s0 * torch.exp(w)
    ds = pk._spot_tangents(p, s, p.t, sum_z, sqrt_dt)
    return payoff.terminal(state, s, p), [
        payoff.terminal_jvp(state, dst, s, d, p) for dst, d in zip(dstates, ds)]


def _bits(t):
    t = t.contiguous()
    return t.isnan(), torch.where(t.isnan(), 0.0, t).view(torch.int32)


STATELESS = [n for n in PATHWISE if get_payoff(n).n_state == 0]
EDGE_OPTIONS = [{}, dict(sigma=0.0), dict(s0=INF), dict(s0=0.0), dict(r=80.0),
                dict(k=NAN), dict(t=0.0)]


@pytest.mark.parametrize("name", STATELESS)
@pytest.mark.parametrize("n_steps", [1, 2, 99, 100])
@pytest.mark.parametrize("fields", EDGE_OPTIONS,
                         ids=[str(f) for f in EDGE_OPTIONS])
def test_euler_s_once_keeps_the_bits(name, n_steps, fields):
    """For the call, the put and best-of-cash under Euler, S formed once at
    maturity gives the payoff and its four tangents of S formed at every
    step bit for bit (the last step's S is that same product; nothing reads
    the others), on seeded threefry-13 draws, at sigma = 0, s0 of +inf or
    0, a drift past expf's range, a NaN strike and T = 0 too."""
    payoff = get_payoff(name)
    cfg = pk.KernelConfig(n_paths=601, n_steps=n_steps)
    params = pk.pack_params(OptionParams(**fields), n_steps, "cpu")
    p = pk.unpack_params(params)
    (_, _, ids, _, draw_pair), = pk.path_chunks(cfg, KEY, params)
    like = torch.zeros_like(ids, dtype=torch.float32)
    want_pay, want_d = pk._greek_leg(payoff, cfg, p, draw_pair, like)
    got_pay, got_d = _s_once_leg(payoff, cfg, p, draw_pair, like)
    for got, want in zip([got_pay, *got_d], [want_pay, *want_d]):
        g_nan, g = _bits(got)
        w_nan, w = _bits(want)
        assert torch.equal(g_nan, w_nan) and torch.equal(g, w)


def _values(name, cfg, params):
    """(per-path (pay, d_s0, d_sigma, d_r - T pay, d_q), valid) of the plain
    version's arithmetic."""
    p = pk.unpack_params(params)
    (_, _, ids, valid, draw_pair), = pk.path_chunks(cfg, KEY, params)
    pay, (d0, d1, d2, d3) = pk._greek_leg(
        get_payoff(name), cfg, p, draw_pair,
        torch.zeros_like(ids, dtype=torch.float32))
    vals = torch.stack([pay, d0, d1, d2 - p.t * pay, d3], dim=1)
    return vals.numpy(), valid.numpy()


CASES = [(n, "terminal", 100) for n in STATELESS] + [
    (n, "euler", s) for n in PATHWISE for s in (2, 17)]


@pytest.mark.parametrize("name,method,n_steps", CASES)
@pytest.mark.parametrize("n", [257, 2_049])
def test_rows_sum_to_the_plain_version(name, method, n_steps, n):
    """On the plain version's per-path values, the kernel's rows (mirrored
    at the source's paths a thread for the mode, the grid capped at 3 blocks
    so blocks stride) add to the plain version's sums: f64 rounding
    apart."""
    cfg = pk.KernelConfig(n_paths=n, n_steps=n_steps, method=method)
    params = pk.pack_params(OptionParams(), n_steps, "cpu")
    vals, valid = _values(name, cfg, params)
    rows = lane_rows(vals, valid, min(-(-n // 256), 3),
                     paths_a_thread(method == "euler"))
    plain = pk.simulate_greek_partials_plain(get_payoff(name), cfg, KEY,
                                             params).sum(0)
    np.testing.assert_allclose(rows.sum(0), plain.numpy(), rtol=1e-12,
                               atol=1e-300)


@pytest.mark.parametrize("name,method", [(n, m) for n in PATHWISE
                                         for m in ("terminal", "euler")
                                         if m == "euler"
                                         or get_payoff(n).n_state == 0])
@pytest.mark.parametrize("n_paths", [1, 257, 1_000_000, (1 << 32) - 1])
def test_wrapper_passes_the_grid_and_mode(monkeypatch, name, method,
                                          n_paths):
    """The wrapper passes the payoff's id, the rounds, the mode (its
    kernel), the steps and paths, and ceil(n_paths / the library's paths a
    block) blocks, capped at MAX_BLOCKS, and counts the one launch."""
    seen = []

    class Lib:
        def __getattr__(self, attr):
            if attr == "mc_greek_block_paths":
                return lambda: 256
            if attr == "mc_greek_partials":
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
    cfg = pk.KernelConfig(n_paths=n_paths, n_steps=37, method=method,
                          rng_source="threefry")
    rows = pk.simulate_greek_partials(get_payoff(name), cfg, (1, 2), params)
    assert len(seen) == 1 and rows.shape == (seen[0][-2], 10)
    args = seen[0]
    assert args[:3] == (get_payoff(name).cuda_id, 20, int(method == "euler"))
    assert args[3:5] == (1, 2) and args[6:8] == (37, n_paths)
    assert args[-2] == min(-(-n_paths // 256), _cuda.MAX_BLOCKS)
    assert _cuda.launch_counts["greek_partials"] == 1
