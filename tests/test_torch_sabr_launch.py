"""The SABR partials kernel #17 (sabr_partials_kernel,
``csrc/sabr_partials.cuh``): its unit-beta step, the wrapper's choice of
instantiation from the packed beta, the forward formed only where the
payoff reads it, the paths a thread (read from the CUDA sources), the grid
the wrapper computes, and the order its f64 rows add in.

No card is needed.  A torch f32 mirror of the unit-beta step (vol_loc = sig
where log F is finite, NaN where it is not) holds it to the port's
``sabr_step`` and to mc_tpu's at beta = 1 bit for bit on edge log-forwards
(+-0, +-inf, NaN, +-1e38) and vols (+-0, inf, NaN); the barrier test on log
F against ``below_max_all(1, B)`` holds to ``exp(log F) < B``; the rows add
as the one-path-a-thread kernel's block tree added its threads.
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_tpu.models import sabr as js

from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.models import sabr as tm
from mc_tpu_torch.ops import _cuda, payoffs
from test_torch_basket_launch import _thread_sums, _tree
from test_torch_book_launch import below_max_all, expf, float_order, order_float

CSRC = Path(tm.__file__).resolve().parents[1] / "csrc"
HEADER = (CSRC / "sabr_partials.cuh").read_text()
MAIN = (CSRC / "sabr_kernels.cu").read_text()
UNIT = (CSRC / "sabr1_kernels.cu").read_text()
STEP = (CSRC / "sabr.cuh").read_text()
F32 = np.float32
EDGE_LF = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e38, -1e38, 4.6,
                    -4.6, 1e-38, -1e-45], F32)
EDGE_SIG = np.array([0.0, -0.0, np.inf, np.nan, 0.2, 3e38, 1e-40], F32)


def unit_step(p, logf, sig, z_vol, z_perp):
    """The unit-beta step: sabr_step with vol_loc = sig where log F is
    finite and NaN where it is not (0 * inf is NaN), no local-vol exp."""
    z_f = p.rho * z_vol + p.rho_perp * z_perp
    vol_loc = torch.where(torch.isfinite(logf), sig,
                          torch.tensor(float("nan")))
    logf = logf + vol_loc * p.sqrt_dt * z_f - 0.5 * vol_loc * vol_loc * p.dt
    sig = sig * torch.exp(p.nu * p.sqrt_dt * z_vol - 0.5 * p.nu * p.nu * p.dt)
    return logf, sig


def same_bits(a, b) -> bool:
    """Bit for bit, but that a NaN may carry another payload."""
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all()
                and (a[~nan].view(np.uint32) == b[~nan].view(np.uint32)).all())


@pytest.mark.parametrize("nu", [0.4, 0.0, 60.0])
@pytest.mark.parametrize("rho", [-0.4, 1.0, -1.0])
def test_unit_step_is_sabr_step_bitwise(rho, nu):
    """At beta = 1 the unit step gives sabr_step's (log F, sig) bit for bit,
    the port's on every pair of edge log-forward and vol and normals that
    include +-0; and mc_tpu's log F where no input or output is subnormal
    (XLA on the CPU flushes subnormals to zero; the card and PyTorch keep
    them).  The vol factor is the same code in both steps: its exp is the
    only place the two libraries' libm meet (the port's parity contract)."""
    dyn = tm.SABRDynamics(alpha=0.2, beta=1.0, nu=nu, rho=rho)
    params = tm.pack_sabr(OptionParams(), dyn, 100, "cpu")
    p = tm.unpack_sabr(params)
    lf, sig = (x.ravel() for x in np.meshgrid(EDGE_LF, EDGE_SIG))
    rs = np.random.default_rng(3)
    n = lf.size
    z = rs.standard_normal((2, n)).astype(F32)
    z[:, ::5] = F32(-0.0)
    z[0, 1::5] = F32(0.0)
    args = [torch.from_numpy(v.copy()) for v in (lf, sig, z[0], z[1])]
    got = unit_step(p, *args)
    want = tm.sabr_step(p, *args)
    jp = js._unpack_sabr(jnp.asarray(params.numpy()))
    ref = js.sabr_step(jp, *(jnp.asarray(v) for v in (lf, sig, z[0], z[1])))
    def sub(x):
        x = np.asarray(x)
        return (np.abs(x) < np.finfo(F32).tiny) & (x != 0)

    normal = ~(sub(lf) | sub(sig) | sub(got[0]))
    assert normal.sum() > n // 2
    for g, w in zip(got, want):
        assert same_bits(g.numpy(), w.numpy())
    assert same_bits(got[0].numpy()[normal], np.asarray(ref[0])[normal])


def test_unit_exp_is_one():
    """The premise: (beta - 1) * lf is +-0 at beta = 1 for a finite lf, and
    exp(+-0) is 1, so sig * it is sig; for lf +-inf or NaN it is NaN."""
    lf = torch.from_numpy(EDGE_LF)
    e = torch.exp((torch.tensor(1.0) - 1.0) * lf)
    fin = torch.isfinite(lf)
    assert (e[fin] == 1.0).all() and e[~fin].isnan().all()
    sig = torch.from_numpy(EDGE_SIG)
    assert same_bits((sig * torch.tensor(1.0)).numpy(), sig.numpy())


@pytest.mark.parametrize("beta,unit", [(1.0, True), (0.5, False),
                                       (0.0, False), (1.0000001, False),
                                       (0.99999999, True), (0.9999999, False),
                                       (float("nan"), False),
                                       (float("inf"), False)])
def test_wrapper_reads_unit_beta_from_the_packed_beta(beta, unit):
    """The unit-beta kernel where the PACKED (f32) beta is 1: c.beta - 1.0f
    == 0 (1 - 1e-8 rounds to 1 in f32; 1 + 1e-7 does not)."""
    dyn = tm.SABRDynamics(beta=beta)
    params = tm.pack_sabr(OptionParams(), dyn, 100, "cpu")
    assert tm.sabr_unit_beta(params) is unit
    assert unit == (F32(beta) - F32(1.0) == 0)


@pytest.mark.parametrize("barrier", [120.0, 100.0, 90.0, 110.51709, 0.0,
                                     -1.0, np.inf, -np.inf, np.nan, 1e-45])
def test_barrier_test_on_log_forward(barrier):
    """A barrier payoff's S < B on F = exp(log F) is log F <=
    below_max_all(1, B), on log F around the threshold, a grid, +-inf and
    NaN."""
    t = below_max_all(1.0, barrier)
    lf = [np.linspace(-110.0, 110.0, 8001, dtype=F32),
          np.array([-np.inf, np.inf, np.nan, -0.0, 0.0], F32)]
    if np.isfinite(t):
        k = int(float_order(t))
        lf.append(order_float(np.arange(k - 64, k + 65, dtype=np.int64)
                              .astype(np.uint32)))
    lf = np.concatenate(lf)
    with np.errstate(invalid="ignore"):
        got = lf <= t
        want = expf(lf) < F32(barrier)
    assert (got == want).all()


def test_state_read_in_source():
    """The leg forms F only where the payoff reads it: each step for a spot
    payoff, the barrier test on log F, else F once at the end; the
    threshold is found once a block by thread 0."""
    assert "st = Payoff::update(st, expf(lf), c.pay);" in HEADER
    assert "st = Payoff::update_below(st, lf <= below_max, c.pay);" in HEADER
    assert ("if (threadIdx.x == 0) below_max_s = below_max_all(1.0f, "
            "c.pay.barrier);") in HEADER
    assert ("kUnitBeta ? (isfinite(lf) ? sig : __int_as_float(0x7fc00000))"
            in " ".join(STEP.split()))


def test_one_dispatch_point_and_a_source_a_beta_class():
    """mc_sabr_partials picks the class from its unit_beta argument (and
    nothing else does); the general class is defined beside it, the unit
    one in sabr1_kernels.cu."""
    body = MAIN[MAIN.index("int mc_sabr_partials("):]
    body = body[:body.index("\n}\n")]
    assert "return unit_beta ? mc::sabr_partials_unit_beta(" in body
    assert ": mc::sabr_partials_general(" in body
    assert "MC_DEFINE_SABR_PARTIALS(general, false)" in MAIN
    assert "MC_DEFINE_SABR_PARTIALS(unit_beta, true)" in UNIT
    assert "MC_DEFINE_SABR_PARTIALS" not in UNIT.replace(
        "MC_DEFINE_SABR_PARTIALS(unit_beta, true)", "")


def paths() -> int:
    return int(re.search(r"constexpr int kSabrPaths = (\d+);", HEADER)
               .group(1))


def tile() -> int:
    return int(re.search(r"constexpr int kSabrTile = (\d+);", HEADER)
               .group(1))


def test_paths_a_thread_divide_the_tile():
    """2 paths a thread in lockstep (an antithetic path's two legs each), a
    block of 256 paths, the one-path kernel's."""
    assert paths() == 2 and tile() == 256 and tile() % paths() == 0


def launch_args(monkeypatch, unit: bool, tile_: int, cfg):
    """The arguments the wrapper passes to mc_sabr_partials (its card path
    run against a stand-in library on a meta tensor, the packed beta's
    reading stubbed to ``unit``).  Checks that it counts the one launch."""
    seen = []

    class Lib:
        def __getattr__(self, attr):
            if attr == "mc_sabr_block_paths":
                return lambda: tile_
            if attr == "mc_sabr_partials":
                return lambda *args: seen.append(args) or 0
            raise AttributeError(attr)

    monkeypatch.setattr(_cuda, "load", Lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_cuda, "launch_counts", dict(_cuda.launch_counts))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tm, "check_sabr_params", lambda *args: None)
    monkeypatch.setattr(tm, "sabr_unit_beta", lambda params: unit)
    params = torch.empty(len(tm.SABR_FIELDS), device="meta")
    rows = tm.sabr_partials(payoffs.get_payoff("vanilla_call"), cfg, (1, 2),
                            params)
    assert len(seen) == 1 and rows.shape == (seen[0][-2], 2)
    assert _cuda.launch_counts["sabr_partials"] == 1
    return seen[0]


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_paths", [1, 255, 256, 257, 1_000_000,
                                     (1 << 32) - 1])
def test_wrapper_passes_the_class_and_grid(monkeypatch, n_paths, antithetic,
                                           unit):
    """The wrapper passes the packed beta's class (the fourth argument) and
    ceil(n_paths / the library's paths a block) blocks, capped at
    MAX_BLOCKS (the kernel grid-strides past it)."""
    cfg = tm.SABRConfig(n_paths=n_paths, n_steps=100, antithetic=antithetic)
    args = launch_args(monkeypatch, unit, 256, cfg)
    assert args[2] == int(antithetic) and args[3] == int(unit)
    assert args[-2] == min(-(-n_paths // 256), _cuda.MAX_BLOCKS)


@pytest.mark.parametrize("n,n_blocks", ((1_000, 4), (1_000, 3), (5_003, 2),
                                        (77, 1), (1_000_000, 8)))
def test_lanes_keep_the_block_sums(n, n_blocks):
    """The kernel's 2 lanes a thread (paths t and t + 128), added as the
    one-path tree's first level, then its 128 threads' tree: each block's
    row bit for bit, with a ragged last block, paths past a bound adding
    zeros and blocks grid-strided."""
    t, p = tile(), paths()
    rs = np.random.default_rng(n + n_blocks)
    pay = (rs.standard_normal(n) * 19.0).astype(F32)
    bound = n - n // 13
    valid = np.arange(n) < bound
    acc = _thread_sums(pay, valid, n_blocks, t).reshape(n_blocks, t, 2)
    want = _tree(acc)
    lanes = acc.reshape(n_blocks, p, t // p, 2).copy()
    h = p // 2
    while h:
        lanes[:, :h] += lanes[:, h:2 * h]
        h //= 2
    got = _tree(lanes[:, 0])
    assert got.tobytes() == want.tobytes()
