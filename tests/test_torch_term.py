"""mc_tpu_torch's term-structure GBM against mc_tpu on the CPU.

The port runs its kernel's plain PyTorch version here (device="cpu");
mc_tpu runs its engine="xla" dual, bitwise equal to its Pallas kernel.  Both
draw the threefry-13 pair (id, m) for steps 2m and 2m+1 and read the step's
curve entries.

Tolerances (the parity contract):
* the packed vector: bitwise, but sigma_bar within 1 ulp (r_bar is bitwise:
  ``mean_f32`` adds in XLA's CPU order; XLA's f32 sqrt rounds a near-halfway
  root the other way at times).  mc_tpu's jitted ``price_term`` compiles
  the pack with n_steps folded in, some fields an ulp off the eager
  ``_pack_term``: the prices below absorb it;
* the leg on the same normals: 2e-6 relative plus 4 ulp of the largest S;
* smooth payoffs: price 1e-5 relative, stderr 1e-5 plus the bound of
  mc_tpu's f32 finish; payoffs where a path can flip at K or B: 0.05 stderr.

The cases of tests/test_term.py run at its sizes and tolerances.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import term as jt
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import term as tt
from mc_tpu_torch.oracle import bs_call, bs_forward_start_call
from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

VANILLA_RTOL = 1e-5
FLIP_SE = 0.05
EPS32 = 2.0 ** -24
FLIPS = {"digital_call", "digital_put", "bullet_call", "up_out_call",
         "down_out_call", "down_in_call"}
J_OPTIONS = {
    "bullet_call": dict(p1=1.0, p2=6.0),
    "down_out_call": dict(barrier=90.0),
    "down_in_call": dict(barrier=90.0),
    "down_out_call_bb": dict(barrier=90.0),
    "variance_swap": dict(k=0.03),
    "forward_start_call": dict(k=1.0, p1=6.0),
    "cliquet": dict(k=4.0, p1=-0.02, p2=0.04),
}
J_SIM = mc_tpu.SimParams(n_paths=3001, n_steps=16)  # odd: a partial tile
SIM = convert.sim_params(J_SIM)
# Steep curves: the drift and the vol both move step by step.
J_CURVE = jt.TermStructure.from_knots([0.12, 0.08, 0.04, 0.02],
                                      [0.1, 0.2, 0.3, 0.4], 16)
CURVE = convert.term_structure(J_CURVE)
SIM_T = mt.SimParams(n_paths=200_000, n_steps=20)  # tests/test_term.py's


def _options(name):
    jopt = mc_tpu.OptionParams(**J_OPTIONS.get(name, {}))
    return jopt, convert.option_params(jopt)


def _f32_finish_rtol(res):
    mean, var = float(res.payoff_mean), float(res.payoff_var)
    if var == 0.0:
        return VANILLA_RTOL
    return VANILLA_RTOL + 0.5 * 8 * EPS32 * (var + 2 * mean * mean) / var


def _assert_close(name, got, want):
    gp, wp, ws = float(got.price), float(want.price), float(want.stderr)
    if name in FLIPS:
        assert abs(gp - wp) <= FLIP_SE * ws, (gp, wp, ws)
        assert abs(float(got.stderr) - ws) <= FLIP_SE * ws
    else:
        assert gp == pytest.approx(wp, rel=VANILLA_RTOL, abs=1e-9)
        assert float(got.stderr) == pytest.approx(
            ws, rel=_f32_finish_rtol(got), abs=1e-9)


def _term(rates, sigmas, n=20):
    return tt.TermStructure.from_knots(rates, sigmas, n)


# --- packing -----------------------------------------------------------------


@pytest.mark.parametrize("n", [4, 20, 33, 38, 64, 100, 200, 1000])
def test_mean_f32_is_xlas_mean(n):
    rs = np.random.default_rng(n)
    for _ in range(8):
        x = rs.uniform(0.01, 0.5, n).astype(np.float32)
        want = np.asarray(jnp.mean(jnp.asarray(x)))
        got = tt.mean_f32(torch.from_numpy(x)).numpy()
        assert got.view(np.uint32) == want.view(np.uint32)


@pytest.mark.parametrize("seed,n", [(1, 100), (2, 38), (3, 8), (4, 200)])
def test_pack_term_matches_mc_tpu(seed, n):
    rs = np.random.default_rng(seed)
    jopt = mc_tpu.OptionParams(s0=float(rs.uniform(80, 120)),
                               t=float(rs.uniform(0.3, 2.0)),
                               q=float(rs.uniform(0.0, 0.05)),
                               barrier=97.0, p1=2.0, p2=5.0)
    term = jt.TermStructure(rates=rs.uniform(-0.01, 0.12, n).astype(np.float32),
                            sigmas=rs.uniform(0.05, 0.6, n).astype(np.float32))
    want = np.asarray(jt._pack_term(jopt.as_f32(), term.as_f32(), n))
    got = tt.pack_term(convert.option_params(jopt),
                       convert.term_structure(term), n, "cpu").numpy()
    assert got.shape == (11 + 2 * n,) and got.dtype == np.float32
    ulps = got.view(np.int32).astype(np.int64) - want.view(np.int32)
    sigma_bar = tt.HEAD_FIELDS.index("sigma")
    assert abs(ulps[sigma_bar]) <= 1
    ulps[sigma_bar] = 0
    np.testing.assert_array_equal(ulps, 0)
    np.testing.assert_array_equal(
        convert.term_params(want, n).numpy().view(np.uint32),
        want.view(np.uint32))
    p = tt.unpack_term(torch.from_numpy(got))
    assert p.n_steps == n and p.drift_dt.shape == p.vol_sdt.shape == (n,)


def test_demo_curves_and_convert():
    np.testing.assert_array_equal(tt.DEMO_TERM.rates, jt.DEMO_TERM.rates)
    np.testing.assert_array_equal(tt.DEMO_TERM.sigmas,
                                  np.asarray(jt.DEMO_TERM.sigmas))
    t = convert.term_structure(J_CURVE)
    assert t.rates.dtype == np.float32 and t.n_steps == 16
    with pytest.raises(ValueError, match="rates and sigmas"):
        convert.term_structure(dict(rates=np.zeros(4), sigmas=np.zeros(5)))
    with pytest.raises(ValueError, match="11"):
        convert.term_params(np.zeros(11, np.float32), 4)


def test_leg_matches_mc_tpu():
    """Two steps on the same f32 normals through mc_tpu's _term_leg and the
    port's term_step (the Asian's state too)."""
    rs = np.random.default_rng(23)
    z = rs.standard_normal((2, 4096)).astype(np.float32) * 2
    jopt = mc_tpu.OptionParams()
    jparams = jt._pack_term(jopt.as_f32(), J_CURVE.as_f32(), 16)
    jp = jt._unpack_term_head(jparams)
    for name in ("vanilla_call", "asian_call"):
        jpo = jget_payoff(name)
        want = jt._term_leg(
            jpo, 2, jp, jnp.full((4096,), jp.s0),
            lambda m: (jnp.asarray(z[0]), jnp.asarray(z[1])),
            lambda j: jparams[11 + j], lambda j: jparams[11 + 16 + j])
        p = tt.unpack_term(tt.pack_term(mt.OptionParams(), CURVE, 16, "cpu"))
        po = get_payoff(name)
        zero = torch.zeros(4096)
        w, s, st = zero, zero + p.s0, po.init(p, zero)
        for j in range(2):
            w, s, st = tt.term_step(po, p, w, st, torch.from_numpy(z[j]), j)
        # an ulp or two of S apart where the two libms' exp differ
        np.testing.assert_allclose(po.terminal(st, s, p).numpy(),
                                   np.asarray(want), rtol=2e-6,
                                   atol=4 * EPS32 * float(s.max()))


# --- price_term against mc_tpu.price_term ------------------------------------


@pytest.mark.parametrize("antithetic", [False, True])
def test_vanilla_matches_mc_tpu(antithetic):
    want = jt.price_term(mc_tpu.OptionParams(), J_CURVE, J_SIM,
                         antithetic=antithetic, engine="xla")
    got = tt.price_term(mt.OptionParams(), CURVE, SIM, antithetic=antithetic,
                        device="cpu")
    _assert_close("vanilla_call", got, want)


@pytest.mark.parametrize("name", sorted(PAYOFFS))
def test_every_payoff_matches_mc_tpu(name):
    """All 18 payoffs (the bridge barriers read the averaged sigma)."""
    jopt, opt = _options(name)
    want = jt.price_term(jopt, J_CURVE, J_SIM, name, engine="xla")
    got = tt.price_term(opt, CURVE, SIM, name, device="cpu")
    _assert_close(name, got, want)


def test_matches_mc_tpu_pallas_kernel():
    """tests/test_term.py's engines case at 16,384 x 20: the port against
    mc_tpu's Pallas kernel in interpret mode."""
    jsim = mc_tpu.SimParams(n_paths=16_384, n_steps=20)
    jterm = jt.TermStructure.from_knots([0.10, 0.07, 0.05],
                                        [0.15, 0.22, 0.30], 20)
    want = jt.price_term(mc_tpu.OptionParams(), jterm, jsim, engine="pallas",
                         tile_rows=8, interpret=True)
    got = tt.price_term(mt.OptionParams(), convert.term_structure(jterm),
                        convert.sim_params(jsim), device="cpu")
    _assert_close("vanilla_call", got, want)


def test_flat_fields_are_ignored():
    """The curves replace the option's r and sigma: the price is the same
    bit for bit."""
    a = tt.price_term(mt.OptionParams(), CURVE, SIM, device="cpu")
    b = tt.price_term(mt.OptionParams(r=0.5, sigma=0.9), CURVE, SIM,
                      device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.stderr) == float(b.stderr)


def test_path_offset_and_bound_match_mc_tpu():
    jcfg = jpk.KernelConfig(n_paths=1000, n_steps=16, tile_rows=8)
    jparams = jt._pack_term(mc_tpu.OptionParams().as_f32(),
                            J_CURVE.as_f32(), 16)
    key = rng.derive_key(5, 0, tt.TERM_TAG)
    s, sq = jt._term_partials(jget_payoff("vanilla_call"), jcfg,
                              jnp.asarray(key, jnp.uint32), jparams, 1500,
                              2300, engine="xla")
    want = np.array([float(jfinish_sum(s)), float(jfinish_sum(sq))])
    prm = convert.term_params(np.asarray(jparams), 16)
    got = finish_sum(tt.term_partials(get_payoff("vanilla_call"),
                                      tt.TermConfig(n_paths=1000, n_steps=16),
                                      key, prm, path_offset=1500,
                                      n_valid=2300)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    head = finish_sum(tt.term_partials(
        get_payoff("vanilla_call"), tt.TermConfig(n_paths=800, n_steps=16),
        key, prm, path_offset=1500)).numpy()
    np.testing.assert_array_equal(got, head)


def test_guards():
    with pytest.raises(ValueError, match="even"):
        tt.TermConfig(n_paths=8, n_steps=3)
    with pytest.raises(ValueError, match="params"):
        tt.term_partials(get_payoff("vanilla_call"),
                         tt.TermConfig(n_paths=8, n_steps=4), (1, 2),
                         tt.pack_term(mt.OptionParams(), _term([0.1], [0.2], 6),
                                      6, "cpu"))


def test_default_key_is_mc_tpus_term_stream():
    sim = mt.SimParams(n_paths=512, n_steps=4, seed=21)
    term = _term([0.1], [0.2], 4)
    a = tt.price_term(mt.OptionParams(), term, sim, device="cpu")
    b = tt.price_term(mt.OptionParams(), term, sim,
                      key=rng.derive_key(21, 0, 0x7E53), device="cpu")
    c = tt.price_term(mt.OptionParams(), term, sim,
                      key=rng.derive_key(21, 0), device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.price) != float(c.price)


# --- the cases of tests/test_term.py -----------------------------------------


def _gate(res, want, n_se=3.5):
    assert abs(float(res.price) - want) <= n_se * float(res.stderr), (
        float(res.price), want, float(res.stderr))


def test_flat_curves_match_bs():
    res = tt.price_term(mt.OptionParams(), _term([0.1], [0.2]), SIM_T,
                        antithetic=True, device="cpu")
    _gate(res, bs_call(100.0, 100.0, 1.0, 0.1, 0.2))


def test_varying_curves_match_averaged_bs():
    """Steep curves: BS at (mean r, rms sigma), exact in law."""
    term = _term([0.12, 0.08, 0.04, 0.02], [0.1, 0.2, 0.3, 0.4])
    res = tt.price_term(mt.OptionParams(), term, SIM_T, antithetic=True,
                        device="cpu")
    rs = np.asarray(term.rates, np.float64)
    sg = np.asarray(term.sigmas, np.float64)
    _gate(res, bs_call(100.0, 100.0, 1.0, float(rs.mean()),
                       float(np.sqrt((sg ** 2).mean()))))


def test_forward_start_sees_only_late_vol():
    """The strike fixes at step 10 (t1 = 0.5): the curves before t1 cancel,
    so wildly different early vol leaves the price at the [t1, T] BS."""
    late_r, late_sg = 0.04, 0.35
    quiet = _term([0.10, late_r], [0.10, late_sg])
    wild = _term([0.25, late_r], [0.60, late_sg])
    opt = mt.OptionParams(k=1.0, p1=10.0)
    want = bs_forward_start_call(100.0, 1.0, 0.5, 1.0, late_r, late_sg)
    for term in (quiet, wild):
        _gate(tt.price_term(opt, term, SIM_T, "forward_start_call",
                            antithetic=True, device="cpu"), want)


def test_asian_really_sees_the_curve():
    """A back-loaded vol makes the Asian cheaper than its flat-rms twin."""
    back = _term([0.1], [0.1, 0.4])
    rms = float(np.sqrt(np.mean(np.asarray(back.sigmas) ** 2)))
    a = tt.price_term(mt.OptionParams(), back, SIM_T, "asian_call",
                      antithetic=True, device="cpu")
    b = tt.price_term(mt.OptionParams(), _term([0.1], [rms]), SIM_T,
                      "asian_call", antithetic=True, device="cpu")
    se = math.hypot(float(a.stderr), float(b.stderr))
    assert float(a.price) < float(b.price) - 3 * se


def test_from_knots_spread():
    t = tt.TermStructure.from_knots([1.0, 2.0], [0.1], 10)
    assert np.asarray(t.rates).tolist() == [1.0] * 5 + [2.0] * 5
    np.testing.assert_allclose(np.asarray(t.sigmas), 0.1, rtol=1e-6)


def test_validation():
    with pytest.raises(ValueError, match="term structure has"):
        tt.price_term(term=_term([0.1], [0.2], n=10),
                      sim=mt.SimParams(n_paths=1024, n_steps=20),
                      device="cpu")
    with pytest.raises(ValueError, match="even n_steps"):
        tt.price_term(term=_term([0.1], [0.2], n=7),
                      sim=mt.SimParams(n_paths=1024, n_steps=7),
                      device="cpu")
