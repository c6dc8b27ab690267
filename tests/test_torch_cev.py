"""mc_tpu_torch's CEV local-vol family against mc_tpu on the CPU.

The port runs its kernel's plain PyTorch version here (device="cpu"); mc_tpu
runs its engine="xla" dual, bitwise equal to its Pallas kernel.  Both draw
the threefry-13 pair (id, m) for substeps 2m and 2m+1 on the same key
(mc_tpu's price_cev has no rng_source).

Tolerances (the parity contract):
* the packed parameters: bitwise;
* the substep on the same f32 inputs: 2e-6 relative plus 4 ulp of the
  largest output (S^beta is exp(beta*log S), each framework's libm);
* smooth payoffs: price 1e-5 relative, stderr 1e-5 plus the bound of
  mc_tpu's f32 finish; payoffs where a path can flip at K or B (digitals,
  discrete barriers, the bullet's window): 0.05 stderr.

The statistical cases of tests/test_cev.py run at mc_tpu's sizes and
tolerances.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import cev as jc
from mc_tpu.nmc_cev import CEVNMC as JCEVNMC
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import cev as tc
from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
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
# A steeper skew than the demo, so paths reach zero: the absorbing boundary
# matters.
J_STEEP = jc.CEVDynamics.from_atm_vol(0.6, 0.3, 100.0)
STEEP = convert.cev_dynamics(J_STEEP)
NAMES = sorted(n for n in PAYOFFS if n not in SIGMA_PAYOFFS)

# tests/test_cev.py's configuration.
ST_SIM = mt.SimParams(n_paths=200_000, n_steps=100)


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


# --- packing and the substep -------------------------------------------------


@pytest.mark.parametrize("dyn,opt,n_steps", [
    (jc.DEMO_CEV, mc_tpu.OptionParams(), 100),
    (J_STEEP, mc_tpu.OptionParams(s0=97.3, k=101.7, r=0.031, q=0.017, t=0.7),
     38),
])
def test_pack_cev_is_bitwise_mc_tpu(dyn, opt, n_steps):
    want = np.asarray(jc._pack_cev(opt.as_f32(), dyn.as_f32(), n_steps))
    got = tc.pack_cev(convert.option_params(opt), convert.cev_dynamics(dyn),
                      n_steps, "cpu")
    assert got.dtype == torch.float32 and got.shape == (13,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert tc.CEV_FIELDS == jc._CEV_FIELDS
    np.testing.assert_array_equal(
        convert.cev_params(want).numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", ["vanilla_call", "asian_call"])
def test_substep_matches_mc_tpu(name):
    """One substep on the same f32 inputs: S (absorbed at 0, near 0, up to
    well above S0) and z, through mc_tpu's CEV substep (nmc_cev's, which
    its _cev_leg repeats) and the port's."""
    rs = np.random.default_rng(11)
    s = np.concatenate([[0.0, 1e-13, 1e-6, 0.3],
                        rs.uniform(0.0, 300.0, 4000)]).astype(np.float32)
    z = rs.standard_normal(s.shape).astype(np.float32) * 3
    st = rs.uniform(0.0, 50.0, s.shape).astype(np.float32)
    jopt = mc_tpu.OptionParams()
    jp = jc._unpack_cev(jc._pack_cev(jopt.as_f32(), J_STEEP.as_f32(), 16))
    jpo = jget_payoff(name)
    jstate = (jnp.asarray(st),) if jpo.n_state else ()
    js, jst = JCEVNMC._substep(jpo, jp, jnp.asarray(s), jstate,
                               jnp.asarray(z))
    p = tc.unpack_cev(tc.pack_cev(mt.OptionParams(), STEEP, 16, "cpu"))
    po = get_payoff(name)
    state = (torch.from_numpy(st),) if po.n_state else ()
    got_s, got_st = tc.cev_substep(po, p, torch.from_numpy(s), state,
                                   torch.from_numpy(z))
    for g, w in zip((got_s,) + tuple(got_st),
                    (js,) + tuple(jst)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-6,
                                   atol=4 * EPS32 * np.abs(w).max())
    assert float(got_s[0]) == 0.0 and bool((got_s >= 0).all())
    assert bool((got_s == 0).any() & (torch.from_numpy(s) > 0).any())


# --- price_cev against mc_tpu.price_cev --------------------------------------


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("dyn", ["demo", "steep"])
def test_vanilla_matches_mc_tpu(dyn, antithetic):
    jdyn, tdyn = (jc.DEMO_CEV, tc.DEMO_CEV) if dyn == "demo" else (J_STEEP,
                                                                    STEEP)
    want = jc.price_cev(mc_tpu.OptionParams(), jdyn, J_SIM,
                        antithetic=antithetic, engine="xla")
    got = tc.price_cev(mt.OptionParams(), tdyn, SIM, antithetic=antithetic,
                       device="cpu")
    _assert_close("vanilla_call", got, want)


@pytest.mark.parametrize("name", NAMES)
def test_every_payoff_matches_mc_tpu(name):
    """The 16 payoffs mc_tpu prices under CEV."""
    jopt, opt = _options(name)
    want = jc.price_cev(jopt, jc.DEMO_CEV, J_SIM, name, engine="xla")
    got = tc.price_cev(opt, tc.DEMO_CEV, SIM, name, device="cpu")
    _assert_close(name, got, want)


@pytest.mark.parametrize("name", ["cliquet", "variance_swap"])
def test_absorbed_paths_give_the_return_payoffs_nan_as_in_mc_tpu(name):
    """Under the steep skew some paths sit at 0, so the payoffs of a return
    S/S' (the cliquet's periods, the variance swap's log returns) are NaN
    on them, in both packages."""
    jopt, opt = _options(name)
    want = jc.price_cev(jopt, J_STEEP, J_SIM, name, engine="xla")
    got = tc.price_cev(opt, STEEP, SIM, name, device="cpu")
    assert math.isnan(float(want.price)) and math.isnan(float(got.price))


@pytest.mark.parametrize("name", sorted(SIGMA_PAYOFFS))
def test_bridge_barriers_refused_while_mc_tpu_fails(name):
    """ROADMAP C10: the CEV parameters have no sigma.  mc_tpu fails with an
    AttributeError while tracing; the port raises a ValueError that says
    why."""
    jopt, opt = _options(name)
    with pytest.raises(AttributeError, match="sigma"):
        jc.price_cev(jopt, sim=mc_tpu.SimParams(n_paths=256, n_steps=4),
                     payoff=name, engine="xla")
    with pytest.raises(ValueError, match="no sigma"):
        tc.price_cev(opt, sim=mt.SimParams(n_paths=256, n_steps=4),
                     payoff=name, device="cpu")


def test_payoff_is_not_validated_as_in_mc_tpu():
    """ROADMAP C13: price_cev calls no payoff validate, in either package:
    a cliquet whose 16-step period exceeds 8 steps prices exactly 0 (the
    local-vol entry point refuses it)."""
    jopt = mc_tpu.OptionParams(k=16.0, p1=-0.02, p2=0.04)
    jsim = mc_tpu.SimParams(n_paths=512, n_steps=8)
    want = jc.price_cev(jopt, sim=jsim, payoff="cliquet", engine="xla")
    got = tc.price_cev(convert.option_params(jopt),
                       sim=convert.sim_params(jsim), payoff="cliquet",
                       device="cpu")
    assert float(want.price) == 0.0 and float(got.price) == 0.0


def test_path_offset_and_bound_match_mc_tpu():
    """cev_partials over a slice of the global ids, masked at n_valid: the
    (path_offset, n_valid) pair mc_tpu's sharded callers pass."""
    jcfg = jpk.KernelConfig(n_paths=1000, n_steps=8, tile_rows=8)
    jparams = jc._pack_cev(mc_tpu.OptionParams().as_f32(),
                           J_STEEP.as_f32(), 8)
    key = rng.derive_key(5, 0, tc.CEV_TAG)
    s, sq = jc._cev_partials(jget_payoff("vanilla_call"), jcfg,
                             jnp.asarray(key, jnp.uint32), jparams, 1500, 2300,
                             engine="xla")
    want = np.array([float(jfinish_sum(s)), float(jfinish_sum(sq))])
    prm = convert.cev_params(np.asarray(jparams))
    got = finish_sum(tc.cev_partials(get_payoff("vanilla_call"),
                                     tc.CEVConfig(n_paths=1000, n_steps=8),
                                     key, prm, path_offset=1500,
                                     n_valid=2300)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    head = finish_sum(tc.cev_partials(
        get_payoff("vanilla_call"), tc.CEVConfig(n_paths=800, n_steps=8),
        key, prm, path_offset=1500)).numpy()
    np.testing.assert_array_equal(got, head)


def test_guards():
    with pytest.raises(ValueError, match="even"):
        tc.price_cev(sim=mt.SimParams(n_paths=1024, n_steps=7), device="cpu")
    with pytest.raises(ValueError, match="even"):
        tc.CEVConfig(n_paths=8, n_steps=3)
    with pytest.raises(ValueError, match="params"):
        tc.cev_partials(get_payoff("vanilla_call"),
                        tc.CEVConfig(n_paths=8, n_steps=2), (1, 2),
                        torch.zeros(15))
    with pytest.raises(ValueError, match="13"):
        convert.cev_params(np.zeros(15, np.float32))


def test_default_key_is_mc_tpus_cev_stream():
    sim = mt.SimParams(n_paths=512, n_steps=4, seed=21)
    a = tc.price_cev(sim=sim, device="cpu")
    b = tc.price_cev(sim=sim, key=rng.derive_key(21, 0, 0xCE4), device="cpu")
    c = tc.price_cev(sim=sim, key=rng.derive_key(21, 0), device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.price) != float(c.price)


def test_closed_form_and_dynamics_match_mc_tpu():
    for args, kw in (((100.0, 100.0, 1.0, 0.1, 2.0, 0.5), {}),
                     ((100.0, 90.0, 0.5, 0.03, 0.6 * 100 ** 0.7, 0.3),
                      dict(q=0.02)),
                     ((100.0, 110.0, 2.0, 0.0, 1.0, 0.8), {})):
        assert tc.cev_call_closed_form(*args, **kw) == pytest.approx(
            jc.cev_call_closed_form(*args, **kw), rel=1e-14)
    with pytest.raises(ValueError, match="0 < beta < 1"):
        tc.cev_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2, 1.0)
    d = tc.CEVDynamics.from_atm_vol(0.25, 0.6, 90.0)
    jd = jc.CEVDynamics.from_atm_vol(0.25, 0.6, 90.0)
    assert d == convert.cev_dynamics(jd)
    assert d.as_f32().sigma_lv == float(np.float32(jd.sigma_lv))


# --- the cases of tests/test_cev.py ------------------------------------------


def test_closed_form_gbm_limit():
    cf = tc.cev_call_closed_form(100.0, 100.0, 1.0, 0.1,
                                 sigma_lv=0.2 * 100.0 ** 0.01, beta=0.99)
    assert cf == pytest.approx(mt.oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2),
                               rel=5e-3)


def test_mc_matches_closed_form():
    """Level-space Euler carries O(dt) bias: 4 se + 0.5%, as mc_tpu's."""
    cev = tc.CEVDynamics.from_atm_vol(0.2, 0.5, 100.0)
    ref = tc.cev_call_closed_form(100.0, 100.0, 1.0, 0.1, cev.sigma_lv, 0.5)
    res = tc.price_cev(mt.OptionParams(), cev, ST_SIM, antithetic=True,
                       device="cpu")
    assert abs(float(res.price) - ref) <= 4.0 * float(res.stderr) + 0.005 * ref


def test_skew_direction():
    """beta < 1 at matched ATM vol: ITM calls (OTM puts by parity) above
    Black-Scholes, OTM calls below."""
    cev = tc.CEVDynamics.from_atm_vol(0.2, 0.5, 100.0)
    bs = mt.oracle.bs_call
    assert (tc.cev_call_closed_form(100.0, 80.0, 1.0, 0.1, cev.sigma_lv, 0.5)
            > bs(100.0, 80.0, 1.0, 0.1, 0.2))
    assert (tc.cev_call_closed_form(100.0, 125.0, 1.0, 0.1, cev.sigma_lv, 0.5)
            < bs(100.0, 125.0, 1.0, 0.1, 0.2))


def test_path_dependent_payoffs():
    sim = mt.SimParams(n_paths=50_000, n_steps=20)
    cev = tc.CEVDynamics.from_atm_vol(0.2, 0.7, 100.0)
    vanilla = tc.price_cev(mt.OptionParams(), cev, sim, device="cpu")
    asian = tc.price_cev(mt.OptionParams(), cev, sim, payoff="asian_call",
                         device="cpu")
    assert 0.0 < float(asian.price) < float(vanilla.price)


def test_absorbed_paths_reach_zero_and_stay():
    """Under a steep skew some paths hit 0; the zero-coupon payoff still
    prices e^{-rT} exactly and a digital call + put is e^{-rT}."""
    sim = mt.SimParams(n_paths=4096, n_steps=20)
    disc = math.exp(-float(np.float32(0.1)))
    zcb = tc.price_cev(mt.OptionParams(), STEEP, sim, "zcb", device="cpu")
    dc = tc.price_cev(mt.OptionParams(), STEEP, sim, "digital_call",
                      device="cpu")
    dp = tc.price_cev(mt.OptionParams(), STEEP, sim, "digital_put",
                      device="cpu")
    assert float(zcb.price) == pytest.approx(disc, rel=1e-7)
    assert float(dc.price) + float(dp.price) == pytest.approx(disc, rel=1e-6)
    put = tc.price_cev(mt.OptionParams(k=1e-3), STEEP, sim, "vanilla_put",
                       device="cpu")
    assert float(put.price) > 0.0  # S_T = 0 on some paths
