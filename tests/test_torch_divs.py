"""mc_tpu_torch's cash-dividend GBM against mc_tpu on the CPU.

The port runs its kernel's plain PyTorch version here (device="cpu");
mc_tpu runs its engine="xla" dual, bitwise equal to its Pallas kernel.  Both
draw the threefry-13 pair (id, m) for steps 2m and 2m+1; the step is the
level-space GBM factor, then the cash drop floored at 1e-6.

Tolerances (the parity contract):
* the packed vector: bitwise;
* the step on the same f32 inputs: 2e-6 relative plus 4 ulp of the largest
  S (each framework's exp);
* smooth payoffs: price 1e-5 relative, stderr 1e-5 plus the bound of
  mc_tpu's f32 finish; payoffs where a path can flip at K or B: 0.05 stderr;
* the oracles: the forward bitwise (the same f64 numpy arithmetic), the
  one-dividend call 1e-5 relative (mc_tpu's inner Black-Scholes runs in
  f32).

The cases of tests/test_dividends_cash.py run at its sizes and tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import dividends as jd
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import dividends as td
from mc_tpu_torch.oracle import bs_call
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
# Two payments, the second larger than some spots: the floor binds.
DIVS = jd.div_schedule(16, [3, 9], [3.0, 90.0])
SIM_D = mt.SimParams(n_paths=400_000, n_steps=50)  # tests/..._cash.py's


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


# --- packing and the step ----------------------------------------------------


@pytest.mark.parametrize("opt,n,steps,amounts", [
    (mc_tpu.OptionParams(), 100, [24, 61], [3.0, 4.5]),
    (mc_tpu.OptionParams(s0=97.3, k=101.7, r=0.031, q=0.017, t=0.7,
                         sigma=0.31), 38, [0, 37], [0.25, 7.0]),
    (mc_tpu.OptionParams(), 16, [], []),
])
def test_pack_divs_is_bitwise_mc_tpu(opt, n, steps, amounts):
    divs = jd.div_schedule(n, steps, amounts)
    want = np.asarray(jd._pack_divs(opt.as_f32(), divs, n))
    got = td.pack_divs(convert.option_params(opt),
                       td.div_schedule(n, steps, amounts), n, "cpu")
    assert got.dtype == torch.float32 and got.shape == (13 + n,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert td.HEAD_FIELDS == jd._HDR_FIELDS
    np.testing.assert_array_equal(
        convert.divs_params(want, n).numpy().view(np.uint32),
        want.view(np.uint32))
    with pytest.raises(ValueError, match=f"are {13 + n} float32"):
        convert.divs_params(want[:-1], n)


def test_step_matches_mc_tpu():
    """Two steps on the same f32 normals through mc_tpu's _divs_leg and the
    port's divs_step: a payment of 90 at step 1 takes some paths to the
    floor."""
    rs = np.random.default_rng(29)
    z = rs.standard_normal((2, 4096)).astype(np.float32) * 2
    jopt = mc_tpu.OptionParams()
    divs = jd.div_schedule(16, [1], [90.0])
    jparams = jd._pack_divs(jopt.as_f32(), divs, 16)
    jp = jd._unpack_divs_head(jparams)
    p = td.unpack_divs(td.pack_divs(mt.OptionParams(), divs, 16, "cpu"))
    for name in ("vanilla_put", "asian_call"):
        jpo = jget_payoff(name)
        want = jd._divs_leg(
            jpo, 2, jp, lambda j: jparams[13 + j], jnp.full((4096,), jp.s0),
            lambda m: (jnp.asarray(z[0]), jnp.asarray(z[1])))
        po = get_payoff(name)
        zero = torch.zeros(4096)
        s, st = zero + p.s0, po.init(p, zero)
        for j in range(2):
            s, st = td.divs_step(po, p, s, st, torch.from_numpy(z[j]), j)
        assert bool((s == np.float32(td.DIV_FLOOR)).any())
        np.testing.assert_allclose(po.terminal(st, s, p).numpy(),
                                   np.asarray(want), rtol=2e-6,
                                   atol=4 * EPS32 * float(s.max()))


# --- price_divs against mc_tpu.price_divs ------------------------------------


@pytest.mark.parametrize("antithetic", [False, True])
def test_vanilla_matches_mc_tpu(antithetic):
    want = jd.price_divs(mc_tpu.OptionParams(), DIVS, J_SIM,
                         antithetic=antithetic, engine="xla")
    got = td.price_divs(mt.OptionParams(), DIVS, SIM, antithetic=antithetic,
                        device="cpu")
    _assert_close("vanilla_call", got, want)


@pytest.mark.parametrize("name", sorted(PAYOFFS))
def test_every_payoff_matches_mc_tpu(name):
    """All 18 payoffs on the post-dividend path."""
    jopt, opt = _options(name)
    divs = jd.div_schedule(16, [3, 9], [3.0, 4.0])
    want = jd.price_divs(jopt, divs, J_SIM, name, engine="xla")
    got = td.price_divs(opt, divs, SIM, name, device="cpu")
    _assert_close(name, got, want)


def test_matches_mc_tpu_pallas_kernel():
    """tests/test_dividends_cash.py's engines case at 16,384 x 10: the port
    against mc_tpu's Pallas kernel in interpret mode."""
    jsim = mc_tpu.SimParams(n_paths=16_384, n_steps=10)
    divs = jd.div_schedule(10, [4], [5.0])
    want = jd.price_divs(divs=divs, sim=jsim, engine="pallas", tile_rows=8,
                         interpret=True)
    got = td.price_divs(divs=divs, sim=convert.sim_params(jsim),
                        device="cpu")
    _assert_close("vanilla_call", got, want)


def test_path_offset_and_bound_match_mc_tpu():
    jcfg = jpk.KernelConfig(n_paths=1000, n_steps=16, tile_rows=8)
    jparams = jd._pack_divs(mc_tpu.OptionParams().as_f32(), DIVS, 16)
    key = rng.derive_key(5, 0, td.DIVS_TAG)
    s, sq = jd._divs_partials(jget_payoff("vanilla_call"), jcfg,
                              jnp.asarray(key, jnp.uint32), jparams, 1500,
                              2300, engine="xla")
    want = np.array([float(jfinish_sum(s)), float(jfinish_sum(sq))])
    prm = convert.divs_params(np.asarray(jparams), 16)
    got = finish_sum(td.divs_partials(get_payoff("vanilla_call"),
                                      td.DivsConfig(n_paths=1000, n_steps=16),
                                      key, prm, path_offset=1500,
                                      n_valid=2300)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    head = finish_sum(td.divs_partials(
        get_payoff("vanilla_call"), td.DivsConfig(n_paths=800, n_steps=16),
        key, prm, path_offset=1500)).numpy()
    np.testing.assert_array_equal(got, head)


def test_guards_and_default_key():
    with pytest.raises(ValueError, match="even"):
        td.DivsConfig(n_paths=8, n_steps=3)
    with pytest.raises(ValueError, match="params"):
        td.divs_partials(get_payoff("vanilla_call"),
                         td.DivsConfig(n_paths=8, n_steps=4), (1, 2),
                         torch.zeros(13))
    sim = mt.SimParams(n_paths=512, n_steps=4, seed=21)
    a = td.price_divs(sim=sim, device="cpu")
    b = td.price_divs(sim=sim, key=rng.derive_key(21, 0, 0xD1F),
                      device="cpu")
    c = td.price_divs(sim=sim, key=rng.derive_key(21, 0), device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.price) != float(c.price)


def test_oracles_match_mc_tpu():
    divs = jd.div_schedule(50, [12, 37], [3.0, 60.0])
    assert td.cash_div_forward(100.0, 1.0, 0.1, 0.2, divs, 50) == (
        jd.cash_div_forward(100.0, 1.0, 0.1, 0.2, divs, 50))
    for args in ((100.0, 100.0, 1.0, 0.1, 0.2, 5.0, 0.5),
                 (90.0, 110.0, 2.0, 0.03, 0.35, 12.0, 0.3)):
        assert td.bs_call_cash_div(*args) == pytest.approx(
            jd.bs_call_cash_div(*args), rel=1e-5)


# --- the cases of tests/test_dividends_cash.py --------------------------------


def test_zero_schedule_is_gbm():
    r = td.price_divs(sim=SIM_D, device="cpu")
    bs = bs_call(100.0, 100.0, 1.0, 0.1, 0.2)
    assert abs(float(r.price) - bs) <= 3.5 * float(r.stderr)


def test_one_dividend_matches_quadrature_oracle():
    divs = td.div_schedule(50, [24], [5.0])
    r = td.price_divs(divs=divs, sim=SIM_D, device="cpu")
    want = td.bs_call_cash_div(100.0, 100.0, 1.0, 0.1, 0.2, 5.0, 0.5)
    assert abs(float(r.price) - want) <= 3.5 * float(r.stderr)


def test_put_call_parity_two_dividends():
    """C - P = e^{-rT}(E[S_T] - K) with the scheme's exact forward."""
    divs = td.div_schedule(50, [12, 37], [3.0, 4.0])
    opt = mt.OptionParams()
    c = td.price_divs(opt, divs, SIM_D, "vanilla_call", device="cpu")
    p = td.price_divs(opt, divs, SIM_D, "vanilla_put", device="cpu")
    fwd = td.cash_div_forward(100.0, 1.0, 0.1, 0.2, divs, 50)
    lhs = float(c.price) - float(p.price)
    rhs = float(np.exp(-0.1) * (fwd - 100.0))
    joint = (float(c.stderr) ** 2 + float(p.stderr) ** 2) ** 0.5
    assert abs(lhs - rhs) <= 3.5 * joint


def test_dividends_lower_calls_raise_puts():
    divs = td.div_schedule(50, [24], [5.0])
    sim = mt.SimParams(n_paths=100_000, n_steps=50)
    opt = mt.OptionParams()
    c0 = td.price_divs(opt, None, sim, "vanilla_call", device="cpu")
    cd = td.price_divs(opt, divs, sim, "vanilla_call", device="cpu")
    p0 = td.price_divs(opt, None, sim, "vanilla_put", device="cpu")
    pd = td.price_divs(opt, divs, sim, "vanilla_put", device="cpu")
    assert float(cd.price) < float(c0.price)
    assert float(pd.price) > float(p0.price)


def test_path_dependent_payoffs_see_post_div_path():
    divs = td.div_schedule(50, [12, 37], [3.0, 4.0])
    sim = mt.SimParams(n_paths=50_000, n_steps=50)
    r = td.price_divs(divs=divs, sim=sim, payoff="asian_call", device="cpu")
    r0 = td.price_divs(sim=sim, payoff="asian_call", device="cpu")
    assert 0.0 < float(r.price) < float(r0.price)


def test_validation():
    with pytest.raises(ValueError, match="even n_steps"):
        td.price_divs(sim=mt.SimParams(n_paths=1024, n_steps=9),
                      device="cpu")
    with pytest.raises(ValueError, match="shaped"):
        td.price_divs(divs=np.zeros(4, np.float32),
                      sim=mt.SimParams(n_paths=1024, n_steps=10),
                      device="cpu")
    with pytest.raises(ValueError, match="outside"):
        td.div_schedule(10, [10], [1.0])
    with pytest.raises(ValueError, match="negative"):
        td.div_schedule(10, [3], [-1.0])
    with pytest.raises(ValueError, match="tau"):
        td.bs_call_cash_div(100, 100, 1.0, 0.1, 0.2, 5.0, 1.5)
