"""mc_tpu_torch's Bates SVJ family against mc_tpu on the CPU.

The port runs its kernel's plain PyTorch version here (device="cpu").
mc_tpu runs its engine="xla" dual, or its Pallas kernel in interpret mode
for the 20-round stream (its XLA dual draws threefry-13 whatever rng_source
says).  Both draw the same threefry stream on the same key.

Tolerances (the parity contract): the packed parameters bitwise; the CF
oracle 1e-12 relative (the same f64 numpy code); smooth payoffs price 1e-5
relative, stderr 1e-5 plus the bound of mc_tpu's f32 finish; payoffs where
a path can flip at K or B, and any path whose Poisson count moves where u
lands within an ulp of a cdf step: 0.05 stderr.

The cases of tests/test_bates.py run at mc_tpu's sizes and tolerances.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import bates as jb
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import bates as tb
from mc_tpu_torch.models import heston as th
from mc_tpu_torch.models import merton as tm
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
    "variance_swap": dict(k=0.03),
    "forward_start_call": dict(k=1.0, p1=6.0),
    "cliquet": dict(k=4.0, p1=-0.02, p2=0.04),
}
BATES_PAYOFFS = sorted(n for n in PAYOFFS if n not in th.SIGMA_PAYOFFS)
J_SIM = mc_tpu.SimParams(n_paths=3001, n_steps=16)  # odd: a partial tile
SIM = convert.sim_params(J_SIM)
# Feller-violating variance with frequent large jumps.
J_STRESS = jb.BatesDynamics(v0=0.09, kappa=1.0, theta=0.09, xi=1.0, rho=-0.9,
                            lam=1.5, mu_j=-0.2, sigma_j=0.3)
STRESS = convert.bates_dynamics(J_STRESS)

# tests/test_bates.py's configuration.
ST_SIM = mt.SimParams(n_paths=100_000, n_steps=50)
NO_JUMP = tb.BatesDynamics(lam=0.0)


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


# --- packing, the oracle -------------------------------------------------------


@pytest.mark.parametrize("dyn,opt,n_steps", [
    (jb.DEMO_BATES, mc_tpu.OptionParams(), 100),
    (J_STRESS, mc_tpu.OptionParams(s0=97.3, k=101.7, r=0.031, q=0.017, t=0.7),
     37),
])
def test_pack_bates_is_bitwise_mc_tpu(dyn, opt, n_steps):
    want = np.asarray(jb._pack_bates(opt.as_f32(), dyn.as_f32(), n_steps))
    got = tb.pack_bates(convert.option_params(opt),
                        convert.bates_dynamics(dyn), n_steps, "cpu")
    assert got.dtype == torch.float32 and got.shape == (20,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert tb.BATES_FIELDS == jb._BATES_FIELDS
    assert tb.BATES_FIELDS[:17] == th.HESTON_FIELDS
    np.testing.assert_array_equal(
        convert.bates_params(want).numpy().view(np.uint32),
        want.view(np.uint32))


@pytest.mark.parametrize("q", [0.0, 0.03])
def test_bates_call_cf_matches_mc_tpu(q):
    args = (100.0, 95.0, 0.8, 0.05, 0.05, 1.5, 0.04, 0.5, -0.6, 0.7, -0.15,
            0.2)
    assert tb.bates_call_cf(*args, q=q) == pytest.approx(
        jb.bates_call_cf(*args, q=q), rel=1e-12)


# --- price_bates against mc_tpu.price_bates -----------------------------------


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("rng_source", ["threefry13", "threefry"])
@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_vanilla_matches_mc_tpu(scheme, rng_source, antithetic):
    kw = dict(scheme=scheme, antithetic=antithetic, rng_source=rng_source)
    jkw = (dict(engine="xla") if rng_source == "threefry13"
           else dict(engine="pallas", interpret=True, tile_rows=8))
    want = jb.price_bates(mc_tpu.OptionParams(), J_STRESS, J_SIM, **kw, **jkw)
    got = tb.price_bates(mt.OptionParams(), STRESS, SIM, **kw, device="cpu")
    _assert_close("vanilla_call", got, want)


@pytest.mark.parametrize("name", BATES_PAYOFFS)
def test_every_payoff_matches_mc_tpu_euler(name):
    jopt, opt = _options(name)
    want = jb.price_bates(jopt, jb.DEMO_BATES, J_SIM, name, engine="xla")
    got = tb.price_bates(opt, tb.DEMO_BATES, SIM, name, device="cpu")
    _assert_close(name, got, want)


@pytest.mark.parametrize("name", ["asian_call", "lookback_call",
                                  "bullet_call", "down_out_call",
                                  "digital_call", "cliquet"])
def test_payoffs_match_mc_tpu_qe_antithetic(name):
    jopt, opt = _options(name)
    want = jb.price_bates(jopt, J_STRESS, J_SIM, name, engine="xla",
                          scheme="qe", antithetic=True)
    got = tb.price_bates(opt, STRESS, SIM, name, scheme="qe",
                         antithetic=True, device="cpu")
    _assert_close(name, got, want)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_path_offset_and_bound_match_mc_tpu(scheme):
    jcfg = jpk.KernelConfig(n_paths=1000, n_steps=8, tile_rows=8)
    jparams = jb._pack_bates(mc_tpu.OptionParams().as_f32(),
                             J_STRESS.as_f32(), 8)
    kmax = tm.poisson_kmax(J_STRESS.lam / 8)
    key = rng.derive_key(5, 0, tb.BATES_TAG)
    s, sq = jb._bates_partials(jget_payoff("vanilla_call"), jcfg, kmax,
                               jnp.asarray(key, jnp.uint32), jparams, 1500,
                               2300, engine="xla", scheme=scheme)
    want = np.array([float(jfinish_sum(s)), float(jfinish_sum(sq))])
    prm = convert.bates_params(np.asarray(jparams))
    cfg = tb.BatesConfig(n_paths=1000, n_steps=8, kmax=kmax, scheme=scheme)
    got = finish_sum(tb.bates_partials(get_payoff("vanilla_call"), cfg, key,
                                       prm, path_offset=1500,
                                       n_valid=2300)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    head = finish_sum(tb.bates_partials(
        get_payoff("vanilla_call"),
        tb.BatesConfig(n_paths=800, n_steps=8, kmax=kmax, scheme=scheme),
        key, prm, path_offset=1500)).numpy()
    np.testing.assert_array_equal(got, head)


def test_bridge_barriers_are_refused_as_in_mc_tpu():
    """The Bates parameters have no sigma: the port refuses the two
    Brownian-bridge barriers, and mc_tpu fails on them while tracing."""
    for name in th.SIGMA_PAYOFFS:
        with pytest.raises(ValueError, match="sigma"):
            tb.price_bates(sim=SIM, payoff=name, device="cpu")
        with pytest.raises(AttributeError, match="sigma"):
            jb.price_bates(sim=mc_tpu.SimParams(n_paths=256, n_steps=2),
                           payoff=name, engine="xla")


def test_guards():
    with pytest.raises(ValueError, match="scheme"):
        tb.price_bates(sim=mt.SimParams(n_paths=1024, n_steps=2),
                       scheme="milstein", device="cpu")
    with pytest.raises(ValueError, match="hardware PRNG"):
        tb.price_bates(sim=SIM, rng_source="hw", device="cpu")
    with pytest.raises(ValueError, match="params"):
        tb.bates_partials(get_payoff("vanilla_call"),
                          tb.BatesConfig(n_paths=8, n_steps=2, kmax=4),
                          (1, 2), torch.zeros(17))
    with pytest.raises(ValueError, match="scan depth"):
        tb.price_bates(mt.OptionParams(), tb.BatesDynamics(lam=2000.0),
                       mt.SimParams(n_paths=8, n_steps=2), device="cpu")


def test_default_key_is_mc_tpus_bates_stream():
    sim = mt.SimParams(n_paths=512, n_steps=4, seed=21)
    a = tb.price_bates(sim=sim, device="cpu")
    b = tb.price_bates(sim=sim, key=rng.derive_key(21, 0, 0xBA7E),
                       device="cpu")
    c = tb.price_bates(sim=sim, key=rng.derive_key(21, 0, 0x4E57),
                       device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.price) != float(c.price)


def test_no_jumps_steps_as_heston_bitwise():
    """lam = 0: the packed Heston fields are pack_heston's (growth = r - q)
    and every count is 0, so a Bates Euler step is the Heston Euler step
    on the same draws, bit for bit."""
    p_b = tb.unpack_bates(tb.pack_bates(mt.OptionParams(), NO_JUMP, 4, "cpu"))
    p_h = th.unpack_heston(th.pack_heston(mt.OptionParams(), th.DEMO_HESTON,
                                          4, "cpu"))
    for f in th.HESTON_FIELDS:
        assert torch.equal(getattr(p_b, f), getattr(p_h, f)), f
    g = np.random.default_rng(2)
    w, v, z_v, z_p, e = (torch.from_numpy(x.astype(np.float32)) for x in (
        g.normal(0.0, 0.05, 5000), g.uniform(-0.02, 0.2, 5000),
        g.standard_normal(5000), g.standard_normal(5000),
        g.standard_normal(5000)))
    u = torch.from_numpy(g.random(5000, dtype=np.float32))
    call = get_payoff("vanilla_call")
    wb, vb, sb, _ = tb.bates_euler_step(call, p_b, 1, p_b.s0, w, v, (), z_v,
                                        z_p, e, u)
    wh, vh = th.heston_euler_step(p_h, w, v, z_v, z_p, p_h.dt, p_h.sqrt_dt)
    assert torch.equal(wb, wh) and torch.equal(vb, vh)
    assert torch.equal(sb, p_h.s0 * torch.exp(wh))


# --- the cases of tests/test_bates.py -----------------------------------------


def test_cf_heston_limit_exact():
    b = tb.bates_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 0.3, -0.7,
                         0.0, -0.1, 0.15)
    h = th.heston_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 0.3, -0.7)
    assert b == h


def test_cf_merton_limit():
    b = tb.bates_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 1e-6, 0.0,
                         0.3, -0.1, 0.15)
    m = tm.merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2, 0.3, -0.1,
                                   0.15)
    assert b == pytest.approx(m, abs=2e-4)


@pytest.mark.parametrize("q", [0.0, 0.03])
def test_cf_bs_limit_and_dividend(q):
    b = tb.bates_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 1e-6, 0.0,
                         0.0, -0.1, 0.15, q=q)
    assert b == pytest.approx(mt.oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2,
                                                q), rel=1e-4)


def test_cf_jumps_add_convexity_value():
    base = dict(s0=100.0, t=1.0, r=0.05, v0=0.04, kappa=2.0, theta=0.04,
                xi=0.3, rho=-0.7)
    for k in (80.0, 100.0, 120.0):
        assert tb.bates_call_cf(k=k, lam=0.5, mu_j=-0.2, sigma_j=0.2,
                                **base) > tb.bates_call_cf(
            k=k, lam=0.0, mu_j=-0.2, sigma_j=0.2, **base), k


def _cf(dyn):
    return tb.bates_call_cf(100.0, 100.0, 1.0, 0.1, *dyn.astuple())


def test_mc_matches_cf_oracle_euler():
    """Full-truncation Euler carries O(dt) bias: 4 se + 0.5%."""
    ref = _cf(tb.DEMO_BATES)
    res = tb.price_bates(sim=ST_SIM, antithetic=True, device="cpu")
    assert abs(float(res.price) - ref) <= 4.0 * float(res.stderr) + 0.005 * ref


def test_mc_matches_cf_oracle_qe():
    ref = _cf(tb.DEMO_BATES)
    res = tb.price_bates(sim=ST_SIM, scheme="qe", antithetic=True,
                         device="cpu")
    assert abs(float(res.price) - ref) <= 4.0 * float(res.stderr)


def test_mc_heston_limit():
    ref = th.heston_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 0.3,
                            -0.7)
    res = tb.price_bates(mt.OptionParams(), NO_JUMP, ST_SIM, antithetic=True,
                         device="cpu")
    assert abs(float(res.price) - ref) <= 4.0 * float(res.stderr) + 0.005 * ref


def test_mc_martingale():
    res = tb.price_bates(mt.OptionParams(k=0.0),
                         sim=mt.SimParams(n_paths=200_000, n_steps=20),
                         scheme="qe", antithetic=True, device="cpu")
    assert abs(float(res.price) - 100.0) <= 4.0 * float(res.stderr)


def test_chunk_invariance():
    """Counter-based draws (mc_tpu's tiling invariance): the sums of two
    path ranges are the sums of the whole run."""
    cfg = tb.BatesConfig(n_paths=20_000, n_steps=10, kmax=4)
    prm = tb.pack_bates(mt.OptionParams(), tb.DEMO_BATES, 10, "cpu")
    key = rng.derive_key(1234, 0, tb.BATES_TAG)
    call = get_payoff("vanilla_call")
    whole = finish_sum(tb.bates_partials(call, cfg, key, prm))
    parts = sum(finish_sum(tb.bates_partials(
        call, tb.BatesConfig(n_paths=10_000, n_steps=10, kmax=4), key, prm,
        path_offset=off)) for off in (0, 10_000))
    torch.testing.assert_close(whole, parts, rtol=1e-12, atol=0.0)


def test_path_dependent_payoffs_work():
    sim = mt.SimParams(n_paths=50_000, n_steps=20)
    vanilla = tb.price_bates(sim=sim, device="cpu")
    for name in ("asian_call", "up_out_call"):
        res = tb.price_bates(sim=sim, payoff=name, device="cpu")
        assert 0.0 < float(res.price) < float(vanilla.price), name


def test_antithetic_reduces_stderr():
    sim = mt.SimParams(n_paths=50_000, n_steps=20)
    plain = tb.price_bates(sim=sim, device="cpu")
    anti = tb.price_bates(sim=sim, antithetic=True, device="cpu")
    assert float(anti.stderr) < float(plain.stderr)


def test_market_params_move_the_price():
    """mc_tpu's test_market_params_traced: new jump sizes reprice (the
    port's parameters are plain tensors, nothing to recompile)."""
    sim = mt.SimParams(n_paths=20_000, n_steps=10)
    prices = {float(tb.price_bates(dyn=tb.BatesDynamics(mu_j=mu_j), sim=sim,
                                   device="cpu").price)
              for mu_j in (-0.15, -0.10, -0.05)}
    assert len(prices) == 3
    assert all(math.isfinite(p) for p in prices)
