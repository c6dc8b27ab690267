"""mc_tpu_torch's Black-Scholes-Vasicek family against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here (device="cpu").
mc_tpu's engine="xla" dual is bitwise equal to its Pallas kernel at
threefry-13 but ignores ``rng_source``, so threefry-20 is held to mc_tpu's
Pallas kernel in interpret mode, as are the trajectories (#24).  Both draw
the pairs (id, 3m), (id, 3m+1), (id, 3m+2) for the step pair (2m, 2m+1).

Tolerances (the parity contract):
* the packed parameters: bitwise, but the seven fields that go through exp,
  expm1 or tanh, pinned within the ulp counts of PIN_ULP (XLA's CPU
  approximations of those functions are not PyTorch's; ROADMAP C17);
* the step on the same f32 inputs: 2e-6 relative plus 4 ulp of the largest
  output;
* smooth payoffs: price 1e-5 relative, stderr 1e-5 plus the bound of
  mc_tpu's f32 finish; payoffs where a path can flip at K or B (digitals,
  discrete barriers, the bullet's window): 0.05 stderr;
* the trajectories: S, x, y to 2e-6 relative (absolute 2e-6 of the largest
  where x and y cross zero), a barrier count equal on >= 99.9% of paths.

The cases of tests/test_vasicek.py run at its sizes and tolerances.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import vasicek as jv
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import vasicek as tv
from mc_tpu_torch.oracle import bs_call, bsv_call, vasicek_zcb
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
    "down_out_call_bb": dict(barrier=90.0),
    "variance_swap": dict(k=0.03),
    "forward_start_call": dict(k=1.0, p1=6.0),
    "cliquet": dict(k=4.0, p1=-0.02, p2=0.04),
}
J_SIM = mc_tpu.SimParams(n_paths=3001, n_steps=16)  # odd: a partial tile
SIM = convert.sim_params(J_SIM)
# Strong, fast rates and a positive correlation: every term of the step
# matters.
J_FAST = jv.VasicekDynamics(a=1.0, b=0.03, sigma_r=0.05, rho=0.5)
FAST = convert.vasicek_dynamics(J_FAST)
# The largest ulp distance of each pinned field from mc_tpu's jitted pack
# (measured at most 5, 1, 3, 8, 4 on the series branch, and 43 and 52 for
# l22 and l32 on the tanh branch, where G = x - 2 tanh(x/2) cancels).
PIN_ULP = {"e1": 2, "big_b": 8, "l11": 4, "l21": 12, "l31": 8, "l22": 64,
           "l32": 64}


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
    (jv.DEMO_VASICEK, mc_tpu.OptionParams(), 2),     # x = 0.15: the series
    (jv.DEMO_VASICEK, mc_tpu.OptionParams(), 100),
    (J_FAST, mc_tpu.OptionParams(t=0.7, r=0.03, q=0.02, sigma=0.3), 8),
    (J_FAST, mc_tpu.OptionParams(), 1),              # x = 1: tanh
    (jv.VasicekDynamics(a=3.0, b=0.04, sigma_r=0.02, rho=-0.9),
     mc_tpu.OptionParams(t=2.0), 4),                 # x = 1.5: tanh
    (jv.VasicekDynamics(rho=1.0), mc_tpu.OptionParams(), 20),  # rank 2
])
def test_pack_vasicek_matches_mc_tpu(dyn, opt, n_steps):
    """Against the pack price_vasicek runs (jitted: XLA turns t / n into t *
    (1/n) and contracts a*b + c into fused multiply-adds, which pack_vasicek
    reproduces): every field bitwise but PIN_ULP's, those within their
    pins."""
    pack = jax.jit(jv._pack_vasicek, static_argnums=2)
    want = np.asarray(pack(opt.as_f32(), dyn.as_f32(), n_steps))
    got = tv.pack_vasicek(convert.option_params(opt),
                          convert.vasicek_dynamics(dyn), n_steps, "cpu")
    assert got.dtype == torch.float32 and got.shape == (22,)
    assert tv.VASICEK_FIELDS == jv._VAS_FIELDS
    ulp = np.abs(got.numpy().view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    for i, f in enumerate(tv.VASICEK_FIELDS):
        assert ulp[i] <= PIN_ULP.get(f, 0), (f, int(ulp[i]))
    np.testing.assert_array_equal(
        convert.vasicek_params(want).numpy().view(np.uint32),
        want.view(np.uint32))


def test_ou_gap_matches_mc_tpu_on_both_branches():
    """G(x) on f32 scalars across the switch at 0.5: the series bitwise
    (Horner in fused multiply-adds, as XLA contracts it), the tanh form
    within the pin of l22 (XLA's tanh is not PyTorch's)."""
    g = jax.jit(jv.ou_gap)
    for x in np.geomspace(1e-4, 4.0, 200).astype(np.float32):
        want = np.asarray(g(jnp.float32(x)))
        got = tv.ou_gap(torch.tensor(x)).numpy()
        d = abs(int(got.view(np.int32)) - int(want.view(np.int32)))
        assert d <= (0 if x < 0.5 else PIN_ULP["l22"]), (x, d)


def test_step_matches_mc_tpu():
    """One step on the same f32 inputs and the same packed parameters
    (mc_tpu's, carried across by convert) through mc_tpu's vasicek_step and
    the port's."""
    rs = np.random.default_rng(23)
    n = 4000
    w, x, y = (rs.uniform(lo, hi, n).astype(np.float32) for lo, hi in
               ((-1.0, 1.0), (-0.1, 0.1), (-0.05, 0.3)))
    za, zb, zc = (rs.standard_normal(n).astype(np.float32) * 1.5
                  for _ in range(3))
    s0 = rs.uniform(50.0, 150.0, n).astype(np.float32)
    jparams = jv._pack_vasicek(mc_tpu.OptionParams().as_f32(),
                               J_FAST.as_f32(), 16)
    (jw, jx, jy), js = jv.vasicek_step(
        jv._unpack_vasicek(jparams), tuple(map(jnp.asarray, (w, x, y))),
        *map(jnp.asarray, (za, zb, zc, s0)))
    p = tv.unpack_vasicek(convert.vasicek_params(np.asarray(jparams)))
    (tw, tx, ty), ts = tv.vasicek_step(
        p, tuple(map(torch.from_numpy, (w, x, y))),
        *map(torch.from_numpy, (za, zb, zc, s0)))
    for g, wv in ((tw, jw), (tx, jx), (ty, jy), (ts, js)):
        wv = np.asarray(wv)
        np.testing.assert_allclose(g.numpy(), wv, rtol=2e-6,
                                   atol=4 * EPS32 * np.abs(wv).max())


# --- price_vasicek against mc_tpu.price_vasicek ------------------------------


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("dyn", ["demo", "fast"])
def test_vanilla_matches_mc_tpu(dyn, antithetic):
    jdyn, tdyn = ((jv.DEMO_VASICEK, tv.DEMO_VASICEK) if dyn == "demo"
                  else (J_FAST, FAST))
    want = jv.price_vasicek(mc_tpu.OptionParams(), jdyn, J_SIM,
                            antithetic=antithetic, engine="xla")
    got = tv.price_vasicek(mt.OptionParams(), tdyn, SIM,
                           antithetic=antithetic, device="cpu")
    _assert_close("vanilla_call", got, want)


@pytest.mark.parametrize("name", sorted(PAYOFFS))
def test_every_payoff_matches_mc_tpu(name):
    """All 18 payoffs (the zero-coupon bond among them) under the fast
    rates, each discounted pathwise."""
    jopt, opt = _options(name)
    want = jv.price_vasicek(jopt, J_FAST, J_SIM, name, engine="xla")
    got = tv.price_vasicek(opt, FAST, SIM, name, device="cpu")
    _assert_close(name, got, want)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("name", ["vanilla_call", "asian_call"])
def test_threefry20_matches_pallas_interpret(name, antithetic):
    """rng_source="threefry" (20 rounds): mc_tpu's XLA dual ignores it
    (ROADMAP C11), so the reference is its Pallas kernel in interpret
    mode."""
    jopt, opt = _options(name)
    jsim = mc_tpu.SimParams(n_paths=1024, n_steps=8)
    want = jv.price_vasicek(jopt, J_FAST, jsim, name, engine="pallas",
                            antithetic=antithetic, tile_rows=8,
                            rng_source="threefry", interpret=True)
    got = tv.price_vasicek(opt, FAST, convert.sim_params(jsim), name,
                           antithetic=antithetic, rng_source="threefry",
                           device="cpu")
    _assert_close(name, got, want)
    got13 = tv.price_vasicek(opt, FAST, convert.sim_params(jsim), name,
                             antithetic=antithetic, device="cpu")
    assert float(got13.price) != float(got.price)


def test_matches_mc_tpu_pallas_kernel():
    """tests/test_vasicek.py's engines case: the port against mc_tpu's
    Pallas kernel (interpret mode), threefry-13, the bond and the call."""
    jsim = mc_tpu.SimParams(n_paths=4096, n_steps=8)
    for name in ("zcb", "vanilla_call"):
        want = jv.price_vasicek(mc_tpu.OptionParams(), jv.DEMO_VASICEK, jsim,
                                name, engine="pallas", tile_rows=8,
                                interpret=True)
        got = tv.price_vasicek(sim=convert.sim_params(jsim), payoff=name,
                               device="cpu")
        _assert_close(name, got, want)


@pytest.mark.parametrize("name", ["vanilla_call", "bullet_call",
                                  "asian_call", "lookback_call"])
def test_trajectories_match_pallas_interpret(name):
    """#24's plain version against mc_tpu's vasicek_trajectories_kernel in
    interpret mode: the S, x and y grids, the state word and the
    discounted payoff sums."""
    jopt, opt = _options(name)
    n_paths, n_steps = 1000, 8
    key = rng.derive_key(4, 0, tv.VASICEK_TAG)
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    jparams = jv._pack_vasicek(jopt.as_f32(), J_FAST.as_f32(), n_steps)
    js, jx, jy, jst, jsum, jsq = jv.vasicek_trajectories_kernel(
        jget_payoff(name), jcfg, np.asarray(key, np.uint32), jparams,
        interpret=True)
    prm = convert.vasicek_params(np.asarray(jparams))
    s, x, y, st, partials = tv.vasicek_trajectories(
        get_payoff(name), tv.VasicekConfig(n_paths=n_paths, n_steps=n_steps),
        key, prm)
    for got, want in ((s, js), (x, jx), (y, jy)):
        want = convert.surface_matrix(want, n_paths)
        np.testing.assert_allclose(got.T.numpy(), want, rtol=2e-6,
                                   atol=2e-6 * np.abs(want).max())
    want_st = convert.surface_matrix(jst, n_paths)
    if name == "bullet_call":
        assert (st.T.numpy() == want_st).all(axis=1).mean() >= 0.999
    else:
        np.testing.assert_allclose(st.T.numpy(), want_st, rtol=2e-6)
    sums = finish_sum(partials).numpy()
    want = np.array([float(jfinish_sum(jsum)), float(jfinish_sum(jsq))])
    if name != "bullet_call":
        np.testing.assert_allclose(sums, want, rtol=1e-5)
    own = finish_sum(tv.vasicek_partials(
        get_payoff(name), tv.VasicekConfig(n_paths=n_paths, n_steps=n_steps),
        key, prm))
    np.testing.assert_allclose(sums, own.numpy(), rtol=1e-12)


def test_path_offset_and_bound_match_mc_tpu():
    """vasicek_partials over a slice of the global ids, masked at n_valid:
    the (path_offset, n_valid) pair mc_tpu's sharded callers pass."""
    jcfg = jpk.KernelConfig(n_paths=1000, n_steps=6, tile_rows=8)
    jparams = jv._pack_vasicek(mc_tpu.OptionParams().as_f32(),
                               J_FAST.as_f32(), 6)
    key = rng.derive_key(5, 0, tv.VASICEK_TAG)
    s, sq = jv._vasicek_partials(jget_payoff("vanilla_call"), jcfg,
                                 jnp.asarray(key, jnp.uint32), jparams, 1500,
                                 2300, engine="xla")
    want = np.array([float(jfinish_sum(s)), float(jfinish_sum(sq))])
    prm = convert.vasicek_params(np.asarray(jparams))
    got = finish_sum(tv.vasicek_partials(
        get_payoff("vanilla_call"), tv.VasicekConfig(n_paths=1000, n_steps=6),
        key, prm, path_offset=1500, n_valid=2300)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    head = finish_sum(tv.vasicek_partials(
        get_payoff("vanilla_call"), tv.VasicekConfig(n_paths=800, n_steps=6),
        key, prm, path_offset=1500)).numpy()
    np.testing.assert_array_equal(got, head)


def test_guards():
    with pytest.raises(ValueError, match="even n_steps"):
        tv.VasicekConfig(n_paths=8, n_steps=3)
    with pytest.raises(ValueError, match="hw"):
        tv.VasicekConfig(n_paths=8, n_steps=4, rng_source="hw")
    with pytest.raises(ValueError, match="hw"):
        tv.price_vasicek(sim=mt.SimParams(n_paths=64, n_steps=4),
                         rng_source="hw", device="cpu")
    with pytest.raises(ValueError, match="params"):
        tv.vasicek_partials(get_payoff("vanilla_call"),
                            tv.VasicekConfig(n_paths=8, n_steps=2), (1, 2),
                            torch.zeros(17))
    with pytest.raises(ValueError, match="antithetic"):
        tv.vasicek_trajectories(
            get_payoff("vanilla_call"),
            tv.VasicekConfig(n_paths=8, n_steps=2, antithetic=True), (1, 2),
            tv.pack_vasicek(mt.OptionParams(), tv.DEMO_VASICEK, 2, "cpu"))
    with pytest.raises(ValueError, match="22"):
        convert.vasicek_params(np.zeros(17, np.float32))


def test_default_key_is_mc_tpus_vasicek_stream():
    sim = mt.SimParams(n_paths=512, n_steps=4, seed=21)
    a = tv.price_vasicek(sim=sim, device="cpu")
    b = tv.price_vasicek(sim=sim, key=rng.derive_key(21, 0, 0x7A51),
                         device="cpu")
    c = tv.price_vasicek(sim=sim, key=rng.derive_key(21, 0), device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.price) != float(c.price)


@pytest.mark.parametrize("args", [
    (0.1, 0.3, 0.05, 0.015, 1.0), (0.02, 1.0, 0.06, 0.03, 5.0),
    (0.08, 0.05, 0.04, 0.01, 0.25)])
def test_oracles_match_mc_tpu(args):
    from mc_tpu import oracle as jo
    assert vasicek_zcb(*args) == pytest.approx(jo.vasicek_zcb(*args),
                                               rel=1e-14)
    r0, a, b, sr, t = args
    for rho in (-0.5, 0.0, 0.7):
        assert bsv_call(100.0, 95.0, t, r0, 0.25, a, b, sr, rho, 0.01) == (
            pytest.approx(jo.bsv_call(100.0, 95.0, t, r0, 0.25, a, b, sr,
                                      rho, 0.01), rel=1e-14))


# --- the cases of tests/test_vasicek.py --------------------------------------

GATE_SIM = mt.SimParams(n_paths=200_000, n_steps=8)


def _gate(res, want, n_se=3.5):
    assert abs(float(res.price) - want) <= n_se * float(res.stderr), (
        float(res.price), want, float(res.stderr))


@pytest.mark.parametrize("n_steps", [2, 20])
def test_zcb_exact_at_any_step_count(n_steps):
    """E[exp(-int r)] against the affine closed form: exact in law, so a
    covariance error would show at any step count."""
    res = tv.price_vasicek(sim=mt.SimParams(n_paths=200_000,
                                            n_steps=n_steps),
                           payoff="zcb", device="cpu")
    _gate(res, vasicek_zcb(0.1, 0.3, 0.05, 0.015, 1.0))


def test_zcb_high_vol_gate():
    dyn = tv.VasicekDynamics(a=1.0, b=0.03, sigma_r=0.05, rho=0.0)
    res = tv.price_vasicek(mt.OptionParams(), dyn, GATE_SIM, "zcb",
                           device="cpu")
    _gate(res, vasicek_zcb(0.1, 1.0, 0.03, 0.05, 1.0))


@pytest.mark.parametrize("rho", [-0.3, 0.5])
def test_equity_call_merton73_gate(rho):
    res = tv.price_vasicek(mt.OptionParams(), tv.VasicekDynamics(rho=rho),
                           GATE_SIM, antithetic=True, device="cpu")
    _gate(res, bsv_call(100.0, 100.0, 1.0, 0.1, 0.2, 0.3, 0.05, 0.015, rho))


def test_degenerate_reduces_to_bs():
    """sigma_r ~ 0 and b = r0: constant rates, plain Black-Scholes."""
    dyn = tv.VasicekDynamics(a=0.3, b=0.1, sigma_r=1e-7, rho=0.0)
    res = tv.price_vasicek(mt.OptionParams(), dyn, GATE_SIM, antithetic=True,
                           device="cpu")
    _gate(res, bs_call(100.0, 100.0, 1.0, 0.1, 0.2))


def test_put_call_parity_pathwise():
    """C - P on the same key is the discounted forward, S0 - K P(0,T),
    within the MC error of the forward."""
    c = tv.price_vasicek(sim=GATE_SIM, device="cpu")
    p = tv.price_vasicek(sim=GATE_SIM, payoff="vanilla_put", device="cpu")
    want = 100.0 - 100.0 * vasicek_zcb(0.1, 0.3, 0.05, 0.015, 1.0)
    se = math.hypot(float(c.stderr), float(p.stderr))
    assert abs(float(c.price) - float(p.price) - want) <= 3.5 * se


def test_rho_monotonicity():
    """The equity/rate correlation feeds the forward's variance: the call
    rises with rho by Merton's spread."""
    kw = dict(sim=GATE_SIM, antithetic=True, device="cpu")
    lo = tv.price_vasicek(mt.OptionParams(), tv.VasicekDynamics(rho=-0.9),
                          **kw)
    hi = tv.price_vasicek(mt.OptionParams(), tv.VasicekDynamics(rho=0.9),
                          **kw)
    want = (bsv_call(100, 100, 1, 0.1, 0.2, 0.3, 0.05, 0.015, 0.9)
            - bsv_call(100, 100, 1, 0.1, 0.2, 0.3, 0.05, 0.015, -0.9))
    se = math.hypot(float(hi.stderr), float(lo.stderr))
    assert float(hi.price) > float(lo.price)
    assert abs(float(hi.price) - float(lo.price) - want) <= 4 * se


def test_path_dependent_payoffs_run():
    sim = mt.SimParams(n_paths=20_000, n_steps=8)
    b = tv.price_vasicek(mt.OptionParams(p1=1.0, p2=6.0), sim=sim,
                         payoff="bullet_call", device="cpu")
    a = tv.price_vasicek(sim=sim, payoff="asian_call", device="cpu")
    assert float(b.price) > 0 and float(a.price) > 0
    assert float(b.stderr) > 0 and float(a.stderr) > 0


def test_odd_steps_rejected():
    with pytest.raises(ValueError, match="even n_steps"):
        tv.price_vasicek(sim=mt.SimParams(n_paths=1024, n_steps=7),
                         device="cpu")
