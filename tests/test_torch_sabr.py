"""mc_tpu_torch's SABR family against mc_tpu on the CPU.

The port runs its kernel's plain PyTorch version here (device="cpu").
mc_tpu's engine="xla" dual is bitwise equal to its Pallas kernel at
threefry-13 but ignores ``rng_source``, so threefry-20 is held to mc_tpu's
Pallas kernel in interpret mode.  Both draw the pair (id, j) at step j.

Tolerances (the parity contract):
* the packed parameters: bitwise;
* the step on the same f32 inputs: 2e-6 relative plus 4 ulp of the largest
  output (three exps, each framework's libm);
* smooth payoffs: price 1e-5 relative, stderr 1e-5 plus the bound of
  mc_tpu's f32 finish; payoffs where a path can flip at K or B (digitals,
  discrete barriers, the bullet's window): 0.05 stderr.

The statistical cases of tests/test_sabr.py run at its tolerances, the
Monte Carlo ones at 50,000 x 100 (antithetic) instead of 200,000 x 100: the
gates are in stderrs (plus the expansion's documented 1%), so they hold at
either size.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import sabr as js
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import sabr as ts
from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
from mc_tpu_torch.oracle import bs_call, bs_implied_vol
from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

VANILLA_RTOL = 1e-5
FLIP_SE = 0.05
EPS32 = 2.0 ** -24
FLIPS = {"digital_call", "digital_put", "bullet_call", "up_out_call",
         "down_out_call", "down_in_call"}
# Options that make each payoff live at 16 steps (mc_tpu's field names).
J_OPTIONS = {
    "bullet_call": dict(p1=1.0, p2=6.0),
    "down_out_call": dict(barrier=90.0),
    "down_in_call": dict(barrier=90.0),
    "variance_swap": dict(k=0.03),
    "forward_start_call": dict(k=1.0, p1=6.0),
    "cliquet": dict(k=4.0, p1=-0.02, p2=0.04),
}
J_SIM = mc_tpu.SimParams(n_paths=3001, n_steps=16)  # odd: a partial tile
SIM = convert.sim_params(J_SIM)
# A CEV backbone, a strong vol-of-vol and a positive correlation: every
# term of the step matters.
J_SKEW = js.SABRDynamics(alpha=0.3 * 100.0 ** 0.4, beta=0.6, nu=0.8, rho=0.3)
SKEW = convert.sabr_dynamics(J_SKEW)
NAMES = sorted(n for n in PAYOFFS if n not in SIGMA_PAYOFFS)
# tests/test_sabr.py's option, at a smaller Monte Carlo size.
ST_SIM = mt.SimParams(n_paths=50_000, n_steps=100)


def _options(name):
    jopt = mc_tpu.OptionParams(**J_OPTIONS.get(name, {}))
    return jopt, convert.option_params(jopt)


def _f32_finish_rtol(res):
    """The stderr's tolerance where mc_tpu forms var = E[p^2] - E[p]^2 from
    f32 moments (8 units of roundoff each): half of var's relative error."""
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


# --- packing and the step ----------------------------------------------------


@pytest.mark.parametrize("dyn,opt,n_steps", [
    (js.DEMO_SABR, mc_tpu.OptionParams(), 100),
    (J_SKEW, mc_tpu.OptionParams(s0=97.3, k=101.7, r=0.031, q=0.017, t=0.7),
     37),
    (js.SABRDynamics(alpha=0.2, beta=1.0, nu=1e-6, rho=-1.0),
     mc_tpu.OptionParams(t=2.5, r=0.0), 8),
])
def test_pack_sabr_is_bitwise_mc_tpu(dyn, opt, n_steps):
    want = np.asarray(js._pack_sabr(opt.as_f32(), dyn.as_f32(), n_steps))
    got = ts.pack_sabr(convert.option_params(opt), convert.sabr_dynamics(dyn),
                       n_steps, "cpu")
    assert got.dtype == torch.float32 and got.shape == (17,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert ts.SABR_FIELDS == js._SABR_FIELDS
    np.testing.assert_array_equal(
        convert.sabr_params(want).numpy().view(np.uint32),
        want.view(np.uint32))


def test_step_matches_mc_tpu():
    """One step on the same f32 inputs (log F from deep below to far above
    log f0, sigma from tiny to large, both normals to +-4.5) through
    mc_tpu's sabr_step and the port's."""
    rs = np.random.default_rng(17)
    n = 4000
    logf = rs.uniform(2.0, 7.0, n).astype(np.float32)
    sig = np.exp(rs.uniform(-5.0, 0.5, n)).astype(np.float32)
    z_vol, z_perp = (rs.standard_normal(n).astype(np.float32) * 1.5
                     for _ in range(2))
    jopt = mc_tpu.OptionParams()
    jp = js._unpack_sabr(js._pack_sabr(jopt.as_f32(), J_SKEW.as_f32(), 16))
    want = js.sabr_step(jp, jnp.asarray(logf), jnp.asarray(sig),
                        jnp.asarray(z_vol), jnp.asarray(z_perp))
    p = ts.unpack_sabr(ts.pack_sabr(mt.OptionParams(), SKEW, 16, "cpu"))
    got = ts.sabr_step(p, *(torch.from_numpy(a)
                            for a in (logf, sig, z_vol, z_perp)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-6,
                                   atol=4 * EPS32 * np.abs(w).max())


# --- price_sabr against mc_tpu.price_sabr ------------------------------------


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("dyn", ["demo", "skew"])
def test_vanilla_matches_mc_tpu(dyn, antithetic):
    jdyn, tdyn = (js.DEMO_SABR, ts.DEMO_SABR) if dyn == "demo" else (J_SKEW,
                                                                      SKEW)
    want = js.price_sabr(mc_tpu.OptionParams(), jdyn, J_SIM,
                         antithetic=antithetic, engine="xla")
    got = ts.price_sabr(mt.OptionParams(), tdyn, SIM, antithetic=antithetic,
                        device="cpu")
    _assert_close("vanilla_call", got, want)


@pytest.mark.parametrize("name", NAMES)
def test_every_payoff_matches_mc_tpu(name):
    """The 16 payoffs mc_tpu prices under SABR, on the skewed dynamics."""
    jopt, opt = _options(name)
    want = js.price_sabr(jopt, J_SKEW, J_SIM, name, engine="xla")
    got = ts.price_sabr(opt, SKEW, SIM, name, device="cpu")
    _assert_close(name, got, want)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("name", ["vanilla_call", "asian_call"])
def test_threefry20_matches_pallas_interpret(name, antithetic):
    """rng_source="threefry" (20 rounds): mc_tpu's XLA dual ignores it, so
    the reference is its Pallas kernel in interpret mode."""
    jopt, opt = _options(name)
    jsim = mc_tpu.SimParams(n_paths=1024, n_steps=8)
    want = js.price_sabr(jopt, J_SKEW, jsim, name, engine="pallas",
                         antithetic=antithetic, tile_rows=8,
                         rng_source="threefry", interpret=True)
    got = ts.price_sabr(opt, SKEW, convert.sim_params(jsim), name,
                        antithetic=antithetic, rng_source="threefry",
                        device="cpu")
    _assert_close(name, got, want)
    got13 = ts.price_sabr(opt, SKEW, convert.sim_params(jsim), name,
                          antithetic=antithetic, device="cpu")
    assert float(got13.price) != float(got.price)


def test_matches_mc_tpu_pallas_kernel():
    """tests/test_sabr.py's pallas == xla case at 16,384 x 10: the port
    against mc_tpu's Pallas kernel (interpret mode), threefry-13."""
    jsim = mc_tpu.SimParams(n_paths=16_384, n_steps=10)
    want = js.price_sabr(mc_tpu.OptionParams(), js.DEMO_SABR, jsim,
                         engine="pallas", tile_rows=8, interpret=True)
    got = ts.price_sabr(sim=convert.sim_params(jsim), device="cpu")
    _assert_close("vanilla_call", got, want)


@pytest.mark.parametrize("name", sorted(SIGMA_PAYOFFS))
def test_bridge_barriers_refused_while_mc_tpu_fails(name):
    """ROADMAP C10: the SABR parameters have no sigma.  mc_tpu fails with an
    AttributeError while tracing; the port raises a ValueError that says
    why."""
    jopt, opt = _options(name)
    with pytest.raises(AttributeError, match="sigma"):
        js.price_sabr(jopt, sim=mc_tpu.SimParams(n_paths=256, n_steps=4),
                      payoff=name, engine="xla")
    with pytest.raises(ValueError, match="no sigma"):
        ts.price_sabr(opt, sim=mt.SimParams(n_paths=256, n_steps=4),
                      payoff=name, device="cpu")


def test_path_offset_and_bound_match_mc_tpu():
    """sabr_partials over a slice of the global ids, masked at n_valid: the
    (path_offset, n_valid) pair mc_tpu's sharded callers pass."""
    jcfg = jpk.KernelConfig(n_paths=1000, n_steps=7, tile_rows=8)
    jparams = js._pack_sabr(mc_tpu.OptionParams().as_f32(),
                            J_SKEW.as_f32(), 7)
    key = rng.derive_key(5, 0, ts.SABR_TAG)
    s, sq = js._sabr_partials(jget_payoff("vanilla_call"), jcfg,
                              jnp.asarray(key, jnp.uint32), jparams, 1500,
                              2300, engine="xla")
    want = np.array([float(jfinish_sum(s)), float(jfinish_sum(sq))])
    prm = convert.sabr_params(np.asarray(jparams))
    got = finish_sum(ts.sabr_partials(get_payoff("vanilla_call"),
                                      ts.SABRConfig(n_paths=1000, n_steps=7),
                                      key, prm, path_offset=1500,
                                      n_valid=2300)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    head = finish_sum(ts.sabr_partials(
        get_payoff("vanilla_call"), ts.SABRConfig(n_paths=800, n_steps=7),
        key, prm, path_offset=1500)).numpy()
    np.testing.assert_array_equal(got, head)


def test_guards():
    with pytest.raises(ValueError, match="positive"):
        ts.SABRConfig(n_paths=8, n_steps=0)
    with pytest.raises(ValueError, match="hw"):
        ts.SABRConfig(n_paths=8, n_steps=4, rng_source="hw")
    with pytest.raises(ValueError, match="params"):
        ts.sabr_partials(get_payoff("vanilla_call"),
                         ts.SABRConfig(n_paths=8, n_steps=2), (1, 2),
                         torch.zeros(13))
    with pytest.raises(ValueError, match="17"):
        convert.sabr_params(np.zeros(15, np.float32))


def test_default_key_is_mc_tpus_sabr_stream():
    sim = mt.SimParams(n_paths=512, n_steps=5, seed=21)  # odd steps: fine
    a = ts.price_sabr(sim=sim, device="cpu")
    b = ts.price_sabr(sim=sim, key=rng.derive_key(21, 0, 0x5AB4),
                      device="cpu")
    c = ts.price_sabr(sim=sim, key=rng.derive_key(21, 0), device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.price) != float(c.price)


@pytest.mark.parametrize("args,kw", [
    ((100.0, 100.0, 1.0, 0.1, 0.2, 1.0, 0.4, -0.4), {}),
    ((100.0, 85.0, 0.5, 0.03, 0.3 * 100 ** 0.4, 0.6, 0.8, 0.3),
     dict(q=0.02)),
    ((100.0, 125.0, 2.0, 0.0, 0.2, 0.5, 0.5, -0.7), {}),
])
def test_oracles_match_mc_tpu(args, kw):
    assert ts.sabr_call_hagan(*args, **kw) == pytest.approx(
        js.sabr_call_hagan(*args, **kw), rel=1e-14)
    f = args[0] * math.exp((args[3] - kw.get("q", 0.0)) * args[2])
    iv = (f, args[1], args[2], *args[4:])
    assert ts.sabr_implied_vol(*iv) == js.sabr_implied_vol(*iv)
    assert ts.DEMO_SABR == convert.sabr_dynamics(js.DEMO_SABR)


# --- the cases of tests/test_sabr.py -----------------------------------------


def test_hagan_black_limit():
    """nu -> 0, beta = 1: SABR is Black-Scholes at vol alpha."""
    iv = ts.sabr_implied_vol(100.0, 110.0, 1.0, alpha=0.2, beta=1.0,
                             nu=1e-8, rho=0.0)
    assert iv == pytest.approx(0.2, abs=1e-6)
    p = ts.sabr_call_hagan(100.0, 100.0, 1.0, 0.1, alpha=0.2, beta=1.0,
                           nu=1e-8, rho=0.0)
    assert p == pytest.approx(bs_call(100.0, 100.0, 1.0, 0.1, 0.2), rel=1e-5)


def test_hagan_atm_continuity():
    lo = ts.sabr_implied_vol(100.0, 99.999, 1.0, 0.2, 0.7, 0.4, -0.4)
    at = ts.sabr_implied_vol(100.0, 100.0, 1.0, 0.2, 0.7, 0.4, -0.4)
    hi = ts.sabr_implied_vol(100.0, 100.001, 1.0, 0.2, 0.7, 0.4, -0.4)
    assert lo == pytest.approx(at, rel=1e-4)
    assert hi == pytest.approx(at, rel=1e-4)


def test_mc_lognormal_limit_matches_bs():
    """beta = 1, nu tiny: exact lognormal stepping, BS within 4 stderr."""
    dyn = ts.SABRDynamics(alpha=0.2, beta=1.0, nu=1e-6, rho=0.0)
    res = ts.price_sabr(mt.OptionParams(), dyn, ST_SIM, antithetic=True,
                        device="cpu")
    bs = bs_call(100.0, 100.0, 1.0, 0.1, 0.2)
    assert abs(float(res.price) - bs) <= 4.0 * float(res.stderr)


@pytest.fixture(scope="module")
def smile():
    """The demo dynamics on tests/test_sabr.py's strike ladder."""
    return {k: ts.price_sabr(mt.OptionParams(k=k), ts.DEMO_SABR, ST_SIM,
                             antithetic=True, device="cpu")
            for k in (85.0, 100.0, 115.0)}


def test_mc_matches_hagan_within_expansion_error(smile):
    """Full SABR vs Hagan: MC noise + the expansion's ~1% O(T) accuracy."""
    ref = ts.sabr_call_hagan(100.0, 100.0, 1.0, 0.1, alpha=0.2, beta=1.0,
                             nu=0.4, rho=-0.4)
    res = smile[100.0]
    assert abs(float(res.price) - ref) <= 4.0 * float(res.stderr) + 0.01 * ref


def test_mc_smile_slope_matches_hagan(smile):
    """MC prices inverted to implied vols: rho < 0 slopes the smile down,
    each point near Hagan's."""
    f = 100.0 * math.exp(0.1)
    ivs_mc = [bs_implied_vol(float(smile[k].price), 100.0, k, 1.0, 0.1)
              for k in sorted(smile)]
    ivs_hagan = [ts.sabr_implied_vol(f, k, 1.0, 0.2, 1.0, 0.4, -0.4)
                 for k in sorted(smile)]
    assert ivs_mc[0] > ivs_mc[1] > ivs_mc[2]
    for a, b in zip(ivs_mc, ivs_hagan):
        assert a == pytest.approx(b, abs=0.01)


def test_beta_backbone():
    """beta < 1 at matched ATM vol: the OTM-put wing is rich."""
    f = 100.0 * math.exp(0.1)
    lo = ts.sabr_implied_vol(f, 80.0, 1.0, 0.2 * f ** 0.5, 0.5, 1e-8, 0.0)
    hi = ts.sabr_implied_vol(f, 125.0, 1.0, 0.2 * f ** 0.5, 0.5, 1e-8, 0.0)
    assert lo > hi


def test_path_payoff_on_forward(smile):
    """An Asian on the forward path: positive, below 1.5x the vanilla."""
    asian = ts.price_sabr(mt.OptionParams(), ts.DEMO_SABR, ST_SIM,
                          payoff="asian_call", antithetic=True, device="cpu")
    assert 0.0 < float(asian.price) < 1.5 * float(smile[100.0].price)


def test_price_sabr_validates_payoff():
    """A cliquet with floor > cap raises, in both packages."""
    jopt = mc_tpu.OptionParams(k=10.0, p1=0.5, p2=0.1)
    with pytest.raises(ValueError, match="floor"):
        js.price_sabr(jopt, js.DEMO_SABR,
                      mc_tpu.SimParams(n_paths=2048, n_steps=10),
                      payoff="cliquet", engine="xla")
    with pytest.raises(ValueError, match="floor"):
        ts.price_sabr(convert.option_params(jopt), ts.DEMO_SABR,
                      mt.SimParams(n_paths=2048, n_steps=10),
                      payoff="cliquet", device="cpu")
