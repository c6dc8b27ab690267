"""The simulate kernel #2 (simulate_kernel, ``csrc/simulate.cuh``): its leg
on ``StateRead`` (S only where the payoff reads it; the barrier payoffs'
test on the log-price against the block's threshold, or a resumed path's
own), its modes as kernels apart and the grid the wrapper computes from the
library's paths a block.

No card is needed.  A torch mirror of the kernel's leg (w stepped alone, a
barrier payoff's state from ``w <= below_max_all(base, B)`` where base is
not below 0, S at each step otherwise or where the payoff reads it, once
at maturity else) equals the plain version's leg (S at each step) bit for
bit over edge bases and barriers, resumed bases among them; the source
keeps S and the twin's branch out of the step loop; and the
plain version stays held to mc_tpu's engine="xla" dual (its Pallas kernel
in interpret mode for a resume) in every mode the kernels split on, at
1e-5 relative (0.05 stderr for the bullet's barrier flips).
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu import engines as jeng
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

from mc_tpu_torch import convert
from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum
from test_torch_book_launch import (BARRIER_PAYOFFS, F32, state_read,
                                    threshold_t, update_below)

torch.set_num_threads(1)

CSRC = Path(pk.__file__).resolve().parents[1] / "csrc"
SRC = (CSRC / "simulate.cuh").read_text()
BARRIER = (CSRC / "barrier.cuh").read_text()
INF, NAN = float("inf"), float("nan")
VANILLA_RTOL = 1e-5
BULLET_SE = 0.05

# (s0, barrier, strike) edges of the threshold: a spot +-0, below 0 (under a
# barrier below it, struck below), +inf and NaN; barriers +-0, -1, +-inf
# and NaN.
EDGES = [(100.0, 120.0, 100.0), (100.0, 0.0, 100.0), (100.0, -0.0, 100.0),
         (100.0, -1.0, 100.0), (100.0, INF, 100.0), (100.0, -INF, 100.0),
         (100.0, NAN, 100.0), (0.0, 120.0, 100.0), (-0.0, 120.0, 100.0),
         (-50.0, -60.0, -100.0), (INF, 120.0, 100.0), (NAN, 120.0, 100.0)]


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN's payload aside."""
    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan())
                and torch.equal(_bits(a)[~nan], _bits(b)[~nan]))


def _threshold(p, base: float, barrier: float):
    """below_max_all(base, barrier) over torch's own f32 exp (what the plain
    version's S < B goes through), and by_w: base not below 0."""
    q = type(p)(**{**vars(p), "s0": torch.tensor(base, dtype=torch.float32),
                   "barrier": torch.tensor(barrier, dtype=torch.float32)})
    return threshold_t(q), not base < 0.0


def mirror_leg(po, cfg, p, base, draw_pair, thresholds, state_init=None):
    """simulate.cuh euler_legs for one leg: w steps as euler_step steps it
    (the draw shifted by theta where importance sampling); a barrier
    payoff's state from w <= its path's threshold where by_w, from S
    otherwise; a spot payoff's from S at each step; S formed once, at the
    end, where the steps did not form it.  Returns (S_T, state, w)."""
    read = state_read(po)
    below_max, by_w = thresholds
    state = (po.init(p, torch.zeros_like(base)) if state_init is None
             else state_init)
    theta = torch.tensor(cfg.is_shift, dtype=torch.float32) / torch.tensor(
        float(np.sqrt(cfg.n_steps)), dtype=torch.float32)
    w = torch.zeros_like(base)
    s = base
    for _, z in pk.step_normals(cfg, draw_pair):
        if cfg.is_shift:
            z = z + theta
        w = w + (p.drift_dt + p.vol_dt * z)
        if read == "spot":
            s = base * torch.exp(w)
            state = po.update(state, s, p)
        elif read == "barrier":
            s_w = base * torch.exp(w)
            st_w = update_below(po, state, w <= below_max, p)
            st_s = po.update(state, s_w, p)
            state = tuple(torch.where(by_w, a, b) for a, b in zip(st_w, st_s))
    if cfg.n_steps > cfg.start_step and read != "spot":
        s = base * torch.exp(w)
    return s, state, w


def _path_thresholds(po, p, base):
    """Each path's (threshold, by_w) from its own base, as a resumed launch
    finds them (the block's, for a common base, is the same value)."""
    if state_read(po) != "barrier":
        return torch.zeros_like(base), torch.zeros_like(base, dtype=torch.bool)
    found = {}
    t, by_w = [], []
    for b in base.tolist():
        key = np.float32(b).tobytes()
        if key not in found:
            found[key] = _threshold(p, b, float(p.barrier))
        t.append(float(found[key][0]))
        by_w.append(found[key][1])
    return torch.tensor(t, dtype=torch.float32), torch.tensor(by_w)


def _resume_bases(n: int, edge: float):
    gen = np.random.default_rng(3)
    s = gen.uniform(60.0, 140.0, n).astype(F32)
    s[::5] = edge
    return torch.from_numpy(s)


@pytest.mark.parametrize("resumed", [False, True])
@pytest.mark.parametrize("edge", EDGES, ids=str)
@pytest.mark.parametrize("name", BARRIER_PAYOFFS + ("vanilla_call",
                                                    "asian_call"))
def test_threshold_leg_is_the_spot_leg_bitwise(name, edge, resumed):
    """Each path's S_T, state and w through the kernel's leg equal the plain
    version's leg (S at every step) bit for bit: a launch's block
    threshold at base s0, or a resumed path's own at its s_init (resume
    at the odd step 5 of 17, the spots U(60, 140) with every fifth the
    edge's)."""
    s0, barrier, k = edge
    po = get_payoff(name)
    n, n_steps = 300, 17
    start = 5 if resumed else 0
    cfg = pk.KernelConfig(n_paths=n, n_steps=n_steps, start_step=start)
    opt = OptionParams(s0=s0, barrier=barrier, k=k)
    params = pk.pack_params(opt, n_steps)
    p = pk.unpack_params(params)
    (_, _, _, _, draw_pair), = pk.path_chunks(cfg, (11, 22), params)
    base = (_resume_bases(n, s0) if resumed
            else p.s0.expand(n).contiguous())
    st0 = None
    if resumed and po.n_state:
        st0 = (torch.from_numpy(np.random.default_rng(4).integers(
            0, 2, n).astype(F32)),)
    with np.errstate(all="ignore"):
        got = mirror_leg(po, cfg, p, base, draw_pair,
                         _path_thresholds(po, p, base), st0)
        want = pk.simulate_leg(po, cfg, p, base, draw_pair, st0)
    assert _same(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert _same(a, b)


@pytest.mark.parametrize("name", ["bullet_call", "up_out_call"])
@pytest.mark.parametrize("is_shift", [0.0, 0.7])
@pytest.mark.parametrize("antithetic", [False, True])
def test_shifted_and_twin_legs_are_the_plain_leg_bitwise(name, is_shift,
                                                         antithetic):
    """Under importance sampling (theta a step) and on the twin's negated
    draw, the threshold leg's w and state equal the plain leg's: the twin
    negates the draw before the shift, the pair's payoff mean follows."""
    po = get_payoff(name)
    cfg = pk.KernelConfig(n_paths=500, n_steps=24, is_shift=is_shift,
                          antithetic=antithetic)
    params = pk.pack_params(OptionParams(barrier=105.0), 24)
    p = pk.unpack_params(params)
    (_, _, _, _, draw_pair), = pk.path_chunks(cfg, (5, 6), params)
    base = p.s0.expand(cfg.n_paths).contiguous()
    thr = _path_thresholds(po, p, base)
    legs = [draw_pair] + ([pk._negated(draw_pair)] if antithetic else [])
    for leg in legs:
        s_t, state, w = mirror_leg(po, cfg, p, base, leg, thr)
        s_p, state_p, _ = pk.simulate_leg(po, cfg, p, base, leg)
        assert _same(s_t, s_p) and _same(state[0], state_p[0])


# --- the loop's source ----------------------------------------------------------


def _body(src: str, start: str) -> str:
    """The braced block that opens at the first ``start``."""
    i = src.index(start)
    j = src.index("{", i)
    depth = 0
    for k in range(j, len(src)):
        depth += {"{": 1, "}": -1}.get(src[k], 0)
        if depth == 0:
            return src[j:k + 1]
    raise AssertionError(start)


def test_step_loop_forms_no_spot_and_holds_no_branch_of_the_twin():
    """The Euler leg's step takes w alone and leaves the payoff state to
    leg_update, which forms S only for a kSpot payoff or a kBarrier leg
    whose base is below 0; no kNone or kBarrier leg forms S in the loop;
    the twin is a compile-time leg (if constexpr (A)), no runtime flag."""
    step = _body(SRC, "for_each_draw(start, n_steps, draw_pair, [&](float z)")
    assert "expf" not in step and "antithetic" not in step
    assert "if constexpr (A)" in step
    assert step.count("leg_update<Payoff>(") == 2
    assert "shifted ? -z + shift : -z" in step
    upd = _body(BARRIER, "__device__ __forceinline__ void leg_update(")
    assert re.search(r"if constexpr \(kStateRead<Payoff> == StateRead::kSpot\)"
                     r" \{\s+s = base \* expf\(w\);", upd)
    assert re.search(r"if \(by_w\) \{\s+st = Payoff::update_below\(st, w <= "
                     r"below_max, p\);\s+\} else \{\s+s = base \* expf\(w\);",
                     upd)
    end = _body(BARRIER, "__device__ __forceinline__ void leg_end_spot(")
    assert "if constexpr (kStateRead<Payoff> != StateRead::kSpot)" in end
    assert "if (stepped) s = base * expf(w);" in end


def test_modes_are_kernels_apart_and_the_moments_sized():
    """Euler or terminal, antithetic and the moment count are template
    parameters; the terminal draw only for the terminal-only payoffs; the
    accumulators and the block tree (reduce.cuh's, one path a thread, so
    the rows keep the parent's order) hold N moments; the threshold once a
    block, or a resumed path's own."""
    assert re.search(r"template <class Payoff, int ROUNDS, bool EULER, bool A, "
                     r"int N>\s+__global__ void __launch_bounds__"
                     r"\(kSimulatePaths\)", SRC)
    assert "double acc[N];" in SRC
    assert re.search(r"if constexpr \(N == 2\) \{\s+block_store_moments_unrolled"
                     r"<N, kSimulatePaths>\(acc, row\);\s+\} else \{\s+"
                     r"block_store_moments<N, kSimulatePaths>\(acc, row, N\);",
                     SRC)
    assert "add_moments(acc, pay, x, id < bound, N == kMaxMoments);" in SRC
    assert re.search(r"if constexpr \(Payoff::kStates == 0\) \{\s+return euler \? "
                     r"with_simulate_modes<TerminalOnly, ROUNDS, true>", SRC)
    assert ("if (euler) return with_simulate_modes<Payoff, ROUNDS, true>"
            "(antithetic, with_cv, f);\n    return cudaErrorInvalidValue;") in SRC
    assert ("if (EULER && !s_init) below_max = "
            "block_below_max<Payoff>(p, by_w);") in SRC
    assert "below_max = by_w ? below_max_all(base, p.barrier) : 0.0f;" in SRC
    assert "n_mom != (with_cv ? mc::kMaxMoments : 2)" in (
        CSRC / "simulate_kernels.cu").read_text()
    # the unrolled tree adds in block_store_moments' order (reduce.cuh)
    red = (CSRC / "reduce.cuh").read_text()
    rolled = _body(red, "__device__ void block_store_moments(")
    unrolled = _body(red, "__device__ void block_store_moments_unrolled(")
    assert "for (int s = blockDim.x / 2; s > 0; s >>= 1)" in rolled
    assert "for (int s = THREADS / 2; s > 0; s >>= 1)" in unrolled
    for body in (rolled, unrolled):
        assert "sh[m][threadIdx.x] += sh[m][threadIdx.x + s];" in body
        assert "sh[m][threadIdx.x] = acc[m];" in body
    # the shared finish and step of the ladder, the book, the trajectories
    # and the greek kernel stay as they were
    pay = (CSRC / "payoffs.cuh").read_text()
    assert "s = base * expf(w);  // log-space: one exp rounding per S_t" in pay
    assert "if (antithetic) euler_step<Payoff>(p, base, shifted ? -z + shift : -z" in pay


# --- the wrapper ------------------------------------------------------------------


def test_terminal_only_payoffs_share_a_kernel_and_path_payoffs_finish():
    """TerminalOnly's kernel picks the six terminal-only payoffs at run time
    (MC_TERMINAL_PAYOFFS, each its own terminal) and finishes as
    path_payoff does: pay and x = S_T (their control) times each leg's
    weight, the pair's mean."""
    assert "struct TerminalOnly : PayoffBase<0> {};" in SRC
    assert "case ID: return PAYOFF::terminal(none, s, p);" in SRC
    assert "MC_TERMINAL_PAYOFFS(MC_CASE)" in SRC
    fin = _body(SRC, "if constexpr (std::is_same_v<Payoff, TerminalOnly>)")
    for line in ("pay = terminal_only(payoff_id, e.s, p) * wt;",
                 "x = e.s * wt;",
                 "pay = 0.5f * (pay + terminal_only(payoff_id, e.sn, p) * wt_n);",
                 "x = 0.5f * (x + e.sn * wt_n);"):
        assert line in fin
    pay = (CSRC / "payoffs.cuh").read_text()
    shared = _body(pay, "__device__ __forceinline__ void path_payoff(")
    for line in ("pay = Payoff::terminal(e.st, e.s, p) * wt;",
                 "x = Payoff::control(e.st, e.s, p) * wt;",
                 "pay = 0.5f * (pay + Payoff::terminal(e.stn, e.sn, p) * wt_n);",
                 "x = 0.5f * (x + Payoff::control(e.stn, e.sn, p) * wt_n);"):
        assert line in shared
    terminal = {po.cuda_id for po in (get_payoff(n) for n in (
        "vanilla_call", "vanilla_put", "digital_call", "digital_put",
        "best_of_cash", "zcb"))}
    assert all(po.terminal_only == (po.cuda_id in terminal)
               for po in PAYOFFS.values())


def _launch(monkeypatch, tile: int, cfg, payoff="bullet_call"):
    """The arguments simulate_partials passes to mc_simulate_partials when
    the library's paths a block is ``tile``: its card path run against a
    stand-in library, on a meta tensor; one launch counted."""
    seen = []

    class Lib:
        def mc_simulate_block_paths(self):
            return tile

        def mc_simulate_partials(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(_cuda, "load", Lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_cuda, "launch_counts", dict(_cuda.launch_counts))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(pk, "_check_params", lambda params: None)
    params = torch.empty(len(pk.PARAM_FIELDS), device="meta")
    rows = pk.simulate_partials(get_payoff(payoff), cfg, (1, 2), params)
    assert len(seen) == 1 and rows.shape == (seen[0][-2], cfg.n_moments)
    assert _cuda.launch_counts["simulate_partials"] == 1
    return seen[0]


@pytest.mark.parametrize("tile", [256, 128])
@pytest.mark.parametrize("n_paths", [1, 255, 256, 257, 100_000, 1_000_000,
                                     (1 << 32) - 1])
def test_wrapper_reads_the_librarys_paths_a_block(monkeypatch, n_paths, tile):
    """The grid is ceil(n_paths / the library's paths a block), capped at
    MAX_BLOCKS (the kernel grid-strides past it), whatever a path's
    threads."""
    args = _launch(monkeypatch, tile,
                   pk.KernelConfig(n_paths=n_paths, n_steps=100))
    assert args[-2] == min(-(-n_paths // tile), _cuda.MAX_BLOCKS)


@pytest.mark.parametrize("kw", [dict(), dict(method="terminal"),
                                dict(antithetic=True, with_cv=True),
                                dict(method="terminal", antithetic=True)])
def test_wrapper_passes_the_modes(monkeypatch, kw):
    """The modes the entry point picks its kernel by: Euler, antithetic,
    the control variate and its moment count (2, or 5 with it)."""
    cfg = pk.KernelConfig(n_paths=1000, n_steps=10, **kw)
    args = _launch(monkeypatch, 256, cfg, "vanilla_call")
    assert args[2:5] == (int(cfg.method == "euler"), int(cfg.antithetic),
                         int(cfg.with_cv))
    assert args[-3] == cfg.n_moments == (5 if cfg.with_cv else 2)


# --- the plain version against mc_tpu ------------------------------------------


J_KEY = np.asarray(mc_tpu.rng.derive_key(1234, 0), np.uint32)
KEY = convert.key(J_KEY)
# Each mode the kernels split on: Euler and terminal, antithetic, the
# control variate, importance sampling (K = 180 at the auto shift's size).
MODES = [
    ("vanilla_call", dict()), ("vanilla_call", dict(method="terminal")),
    ("vanilla_call", dict(antithetic=True)),
    ("vanilla_call", dict(method="terminal", antithetic=True,
                          with_cv=True)),
    ("vanilla_call", dict(antithetic=True, with_cv=True)),
    ("vanilla_call", dict(is_shift=2.9)),
    ("vanilla_call", dict(method="terminal", is_shift=2.9, antithetic=True)),
    ("bullet_call", dict()), ("bullet_call", dict(antithetic=True)),
    ("bullet_call", dict(antithetic=True, with_cv=True)),
    ("asian_call", dict(antithetic=True, with_cv=True)),
    ("up_out_call", dict(rng_source="threefry")),
    ("down_in_call", dict(is_shift=0.5)),
]


def _close(name, got, want, n_moments):
    if name == "bullet_call" or name in BARRIER_PAYOFFS:
        # a barrier count can flip where S lands within an ulp of B
        se = float(np.sqrt(max(got[1] / 4096 - (got[0] / 4096) ** 2, 0.0)
                           / 4096))
        assert abs(got[0] - want[0]) / 4096 <= BULLET_SE * se
        return
    np.testing.assert_allclose(got[:n_moments], want[:n_moments],
                               rtol=VANILLA_RTOL)


@pytest.mark.parametrize("name,kw", MODES, ids=lambda x: str(x))
def test_plain_modes_match_mc_tpu_xla(name, kw):
    """simulate_partials' plain version (the kernels' contract) against
    mc_tpu's engine="xla" partials on the same key, 4,096 x 16, at 1e-5
    relative (the barrier payoffs at 0.05 stderr)."""
    n_paths, n_steps = 4096, 16
    k = 180.0 if kw.get("is_shift", 0.0) > 1.0 else 100.0
    jopt = mc_tpu.OptionParams(p1=1.0, p2=6.0, k=k, barrier=115.0)
    opt = convert.option_params(jopt)
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8,
                            **kw)
    parts = jeng._xla_partials(jget_payoff(name), jcfg, J_KEY, jopt.as_f32(),
                               jnp.uint32(0))
    want = np.array([float(jfinish_sum(x)) for x in parts])
    cfg = pk.KernelConfig(n_paths=n_paths, n_steps=n_steps, **kw)
    got = finish_sum(pk.simulate_partials(
        get_payoff(name), cfg, KEY, pk.pack_params(opt, n_steps))).numpy()
    assert got.shape == want.shape == (cfg.n_moments,)
    _close(name, got, want, cfg.n_moments)


@pytest.mark.parametrize("start", [4, 5])
@pytest.mark.parametrize("name", ["bullet_call", "vanilla_call",
                                  "down_in_call"])
def test_plain_resume_matches_mc_tpu(name, start):
    """A resumed launch (each path its own base, spots 0, -0 and -50 among
    them: the per-path threshold's edges) against mc_tpu's kernel in
    interpret mode on the same arrays, at an even and an odd start."""
    n_paths, n_steps = 1024, 8
    rs = np.random.default_rng(start)
    s_init = (100.0 * np.exp(0.1 * rs.standard_normal(n_paths))).astype(F32)
    s_init[::9] = np.resize(np.array([0.0, -0.0, -50.0], F32),
                            s_init[::9].shape)
    po = get_payoff(name)
    state = ([rs.integers(0, start, n_paths).astype(F32)] if po.n_state
             else [])
    jopt = mc_tpu.OptionParams(p1=1.0, p2=6.0, barrier=110.0)
    opt = convert.option_params(jopt)
    cfg = pk.KernelConfig(n_paths=n_paths, n_steps=n_steps, start_step=start)
    got = finish_sum(pk.simulate_partials(
        po, cfg, KEY, pk.pack_params(opt, n_steps),
        s_init=torch.from_numpy(s_init),
        state_init=tuple(torch.from_numpy(a) for a in state) or None))
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8,
                            start_step=start)
    parts = jpk.simulate_partials(
        jget_payoff(name), jcfg, J_KEY, jpk.pack_params(jopt.as_f32(), n_steps),
        s_init=jnp.asarray(s_init.reshape(8, 128)),
        state_init=tuple(jnp.asarray(a.reshape(8, 128)) for a in state)
        or None)
    want = np.array([float(jfinish_sum(x)) for x in parts])
    assert abs(want[0]) > 0.0
    _close(name, got.numpy(), want, 2)
