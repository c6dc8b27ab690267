"""mc_tpu_torch's Heston family against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here (device="cpu").
mc_tpu runs its engine="xla" dual, or its Pallas kernels in interpret mode
where the dual cannot stand in: its XLA dual draws the threefry-13 stream
whatever rng_source says (``_heston_partials_xla`` does not pass it on), so
the 20-round stream is held to the Pallas kernel; and the trajectories have
no dual.  Both draw the same threefry stream on the same key.

Tolerances (the parity contract):
* the packed parameters: bitwise;
* each step on the same f32 inputs: rtol 1e-6, and an absolute 4 ulp of
  the largest output (w' and v' are sums of terms up to that size that
  cancel, and the frameworks' f32 sqrt/log/log1p/exp differ by an ulp);
* the CF oracle: 1e-12 relative (the same f64 numpy code);
* smooth payoffs: price 1e-5 relative, stderr 1e-5 plus the bound of
  mc_tpu's f32 finish; payoffs where a path can flip at K or B (digitals,
  discrete barriers, the bullet's window): 0.05 stderr;
* trajectories: S 2e-6 relative; v 2e-6 of the grid's largest |v| (v
  crosses zero, so its error is absolute, set by the terms that cancel in
  it); a count or flag state equal on >= 99.9% of paths, the Asian's
  running sum 2e-6 relative; the payoff sums 1e-5.

The statistical cases of tests/test_heston.py and test_heston_qe.py run at
mc_tpu's sizes and tolerances (each under ~5 s on one CPU thread).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import heston as jh
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import heston as th
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
HESTON_PAYOFFS = sorted(n for n in PAYOFFS if n not in th.SIGMA_PAYOFFS)
J_SIM = mc_tpu.SimParams(n_paths=3001, n_steps=16)  # odd: a partial tile
SIM = convert.sim_params(J_SIM)
# Feller-violating stress regime of tests/test_heston_qe.py.
J_STRESS = jh.HestonDynamics(v0=0.09, kappa=1.0, theta=0.09, xi=1.0, rho=-0.9)
STRESS = convert.heston_dynamics(J_STRESS)


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


# --- packing and the step functions -----------------------------------------


@pytest.mark.parametrize("dyn,opt,n_steps", [
    (jh.DEMO_HESTON, mc_tpu.OptionParams(), 100),
    (J_STRESS, mc_tpu.OptionParams(s0=97.3, k=101.7, r=0.031, q=0.017,
                                   t=0.7), 37),
])
def test_pack_heston_is_bitwise_mc_tpu(dyn, opt, n_steps):
    want = np.asarray(jh._pack_heston(opt.as_f32(), dyn.as_f32(), n_steps))
    got = th.pack_heston(convert.option_params(opt),
                         convert.heston_dynamics(dyn), n_steps, "cpu")
    assert got.dtype == torch.float32 and got.shape == (17,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert th.HESTON_FIELDS == jh._HESTON_FIELDS
    # and convert.heston_params carries mc_tpu's vector bit for bit
    np.testing.assert_array_equal(
        convert.heston_params(want).numpy().view(np.uint32),
        want.view(np.uint32))


def _both_params(dyn, n_steps, opt=mc_tpu.OptionParams()):
    jp = jh._unpack_heston(jh._pack_heston(opt.as_f32(), dyn.as_f32(),
                                           n_steps))
    tp = th.unpack_heston(th.pack_heston(convert.option_params(opt),
                                         convert.heston_dynamics(dyn),
                                         n_steps, "cpu"))
    return jp, tp


def _inputs(n, v_lo, v_hi, seed):
    g = np.random.default_rng(seed)
    return (g.normal(0.0, 0.05, n).astype(np.float32),
            g.uniform(v_lo, v_hi, n).astype(np.float32),
            g.standard_normal(n).astype(np.float32),
            g.standard_normal(n).astype(np.float32),
            g.random(n).astype(np.float32))


def _assert_step(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                   atol=8 * EPS32 * np.abs(w).max())


def test_euler_step_matches_mc_tpu_with_negative_variance():
    jp, tp = _both_params(jh.DEMO_HESTON, 4)
    w, v, z_v, z_p, _ = _inputs(20_000, -0.05, 0.3, 1)
    assert (v < 0).mean() > 0.1  # the truncated branch is exercised
    want = jh.heston_euler_step(jp, *map(jnp.asarray, (w, v, z_v, z_p)),
                                jp.dt, jp.sqrt_dt)
    got = th.heston_euler_step(tp, *map(torch.from_numpy, (w, v, z_v, z_p)),
                               tp.dt, tp.sqrt_dt)
    _assert_step(got, want)


@pytest.mark.parametrize("rho,v_hi", [(-0.9, 1.0), (0.9, 3.0)])
def test_qe_step_matches_mc_tpu_in_both_branches(rho, v_hi):
    """Coarse steps (dt = 0.5) in the stress regime: psi spans both
    samplers; rho > 0 with large v reaches the plain-K0 fall-backs."""
    dyn = jh.HestonDynamics(v0=0.09, kappa=1.0, theta=0.09, xi=1.0, rho=rho)
    jp, tp = _both_params(dyn, 2)
    jq, tq = jh.qe_consts(jp), th.qe_consts(tp)
    for f in ("emkdt", "c1", "c2", "k0", "k1", "k2", "k3", "k4", "a_mc",
              "growth_dt"):
        assert float(getattr(tq, f)) == pytest.approx(
            float(getattr(jq, f)), rel=1e-6), f
    w, v, z_v, z_s, u = _inputs(20_000, 0.0, v_hi, 2)
    m = float(tp.theta) + (v - float(tp.theta)) * float(tq.emkdt)
    psi = (v * float(tq.c1) + float(tq.c2)) / (m * m)
    assert (psi <= 1.5).mean() > 0.05 and (psi > 1.5).mean() > 0.05
    want = jh.heston_qe_step(jp, jq, *map(jnp.asarray, (w, v, z_v, z_s, u)))
    got = th.heston_qe_step(tp, tq, *map(torch.from_numpy,
                                         (w, v, z_v, z_s, u)))
    _assert_step(got, want)
    assert bool((got[1] >= 0).all())


@pytest.mark.parametrize("q", [0.0, 0.03])
def test_heston_call_cf_matches_mc_tpu(q):
    args = (100.0, 95.0, 0.8, 0.05, 0.05, 1.5, 0.04, 0.5, -0.6)
    assert th.heston_call_cf(*args, q=q) == pytest.approx(
        jh.heston_call_cf(*args, q=q), rel=1e-12)


# --- price_heston against mc_tpu.price_heston -------------------------------


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("rng_source", ["threefry13", "threefry"])
@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_vanilla_matches_mc_tpu(scheme, rng_source, antithetic):
    kw = dict(scheme=scheme, antithetic=antithetic, rng_source=rng_source)
    jkw = (dict(engine="xla") if rng_source == "threefry13"
           else dict(engine="pallas", interpret=True, tile_rows=8))
    want = jh.price_heston(mc_tpu.OptionParams(), J_STRESS, J_SIM, **kw,
                           **jkw)
    got = th.price_heston(mt.OptionParams(), STRESS, SIM, **kw, device="cpu")
    _assert_close("vanilla_call", got, want)


@pytest.mark.parametrize("name", HESTON_PAYOFFS)
def test_every_payoff_matches_mc_tpu_euler(name):
    jopt, opt = _options(name)
    want = jh.price_heston(jopt, jh.DEMO_HESTON, J_SIM, name, engine="xla")
    got = th.price_heston(opt, th.DEMO_HESTON, SIM, name, device="cpu")
    _assert_close(name, got, want)


@pytest.mark.parametrize("name", ["asian_call", "lookback_call",
                                  "bullet_call", "down_out_call",
                                  "digital_call", "cliquet"])
def test_payoffs_match_mc_tpu_qe_antithetic(name):
    jopt, opt = _options(name)
    want = jh.price_heston(jopt, J_STRESS, J_SIM, name, engine="xla",
                           scheme="qe", antithetic=True)
    got = th.price_heston(opt, STRESS, SIM, name, scheme="qe",
                          antithetic=True, device="cpu")
    _assert_close(name, got, want)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_path_offset_and_bound_match_mc_tpu(scheme):
    """heston_partials over a slice of the global ids, masked at n_valid:
    the (path_offset, n_valid) pair mc_tpu's sharded and chunked callers
    pass to _heston_partials_xla."""
    jcfg = jpk.KernelConfig(n_paths=1000, n_steps=8, tile_rows=8)
    jopt = mc_tpu.OptionParams()
    jparams = jh._pack_heston(jopt.as_f32(), J_STRESS.as_f32(), 8)
    key = rng.derive_key(5, 0, th.HESTON_TAG)
    s, sq = jh._heston_partials_xla(jget_payoff("vanilla_call"), jcfg,
                                    jnp.asarray(key, jnp.uint32), jparams,
                                    1500, 2300, scheme=scheme)
    want = np.array([float(jfinish_sum(s)), float(jfinish_sum(sq))])
    got = finish_sum(th.heston_partials(
        get_payoff("vanilla_call"),
        th.HestonConfig(n_paths=1000, n_steps=8, scheme=scheme),
        key, convert.heston_params(np.asarray(jparams)),
        path_offset=1500, n_valid=2300)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # 800 of the 1000 paths are below the bound: the rest add nothing
    head = finish_sum(th.heston_partials(
        get_payoff("vanilla_call"),
        th.HestonConfig(n_paths=800, n_steps=8, scheme=scheme),
        key, convert.heston_params(np.asarray(jparams)),
        path_offset=1500)).numpy()
    np.testing.assert_array_equal(got, head)


def test_bridge_barriers_are_refused_as_in_mc_tpu():
    for name in th.SIGMA_PAYOFFS:
        with pytest.raises(ValueError, match="sigma"):
            th.price_heston(sim=SIM, payoff=name, device="cpu")
        # mc_tpu fails on them too, while tracing (no sigma field)
        with pytest.raises(AttributeError, match="sigma"):
            jh.price_heston(sim=mc_tpu.SimParams(n_paths=256, n_steps=2),
                            payoff=name, engine="xla")


def test_guards():
    with pytest.raises(ValueError, match="scheme"):
        th.price_heston(sim=mt.SimParams(n_paths=1024, n_steps=2),
                        scheme="milstein", device="cpu")
    with pytest.raises(ValueError, match="hardware PRNG"):
        th.price_heston(sim=SIM, rng_source="hw", device="cpu")
    with pytest.raises(ValueError, match="params"):
        th.heston_partials(get_payoff("vanilla_call"),
                           th.HestonConfig(n_paths=8, n_steps=2), (1, 2),
                           torch.zeros(15))
    cfg = th.HestonConfig(n_paths=8, n_steps=2)
    prm = th.pack_heston(mt.OptionParams(), th.DEMO_HESTON, 2, "cpu")
    with pytest.raises(ValueError, match="one state array"):
        th.heston_trajectories(get_payoff("cliquet"), cfg, (1, 2), prm)
    with pytest.raises(ValueError, match="Euler loop"):
        th.heston_trajectories(get_payoff("bullet_call"),
                               th.HestonConfig(n_paths=8, n_steps=2,
                                               scheme="qe"), (1, 2), prm)


def test_default_key_is_mc_tpus_heston_stream():
    """The default key is derive_key(seed, stream, 0x4E57), as mc_tpu's: a
    given key reproduces the default bit for bit, and the GBM stream at
    the same seed is another."""
    sim = mt.SimParams(n_paths=512, n_steps=4, seed=21)
    a = th.price_heston(sim=sim, device="cpu")
    b = th.price_heston(sim=sim, key=rng.derive_key(21, 0, 0x4E57),
                        device="cpu")
    c = th.price_heston(sim=sim, key=rng.derive_key(21, 0), device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.price) != float(c.price)


# --- the cases of tests/test_heston.py and tests/test_heston_qe.py ----------


def test_mc_matches_cf_oracle():
    """tests/test_heston.py:31-37: 4 se + 0.5% (Euler's O(dt) bias)."""
    ref = th.heston_call_cf(100.0, 100.0, 1.0, 0.1,
                            *th.DEMO_HESTON.astuple())
    res = th.price_heston(sim=mt.SimParams(n_paths=200_000, n_steps=100),
                          antithetic=True, device="cpu")
    assert abs(float(res.price) - ref) <= 4.0 * float(res.stderr) + 0.005 * ref


def test_mc_gbm_limit():
    flat = th.HestonDynamics(v0=0.04, kappa=1.0, theta=0.04, xi=1e-7,
                             rho=0.0)
    res = th.price_heston(mt.OptionParams(), flat,
                          mt.SimParams(n_paths=100_000, n_steps=50),
                          antithetic=True, device="cpu")
    bs = mt.oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2)
    assert abs(float(res.price) - bs) <= 4.0 * float(res.stderr)


@pytest.mark.parametrize("scheme", ["euler", "qe"])
def test_antithetic_reduces_stderr(scheme):
    sim = mt.SimParams(n_paths=50_000, n_steps=16, seed=3)
    plain = th.price_heston(mt.OptionParams(r=0.03), STRESS, sim,
                            scheme=scheme, device="cpu")
    anti = th.price_heston(mt.OptionParams(r=0.03), STRESS, sim,
                           scheme=scheme, antithetic=True, device="cpu")
    assert float(anti.stderr) < float(plain.stderr)


def test_qe_martingale_exact():
    opt0 = mt.OptionParams(s0=100.0, t=1.0, k=0.0, r=0.03)
    res = th.price_heston(opt0, STRESS,
                          mt.SimParams(n_paths=1 << 19, n_steps=4, seed=11),
                          scheme="qe", device="cpu")
    assert abs(float(res.price) - 100.0) <= 3.0 * float(res.stderr)


def test_qe_coarse_bias_beats_euler():
    cf = th.heston_call_cf(100.0, 100.0, 1.0, 0.03, *STRESS.astuple())
    opt = mt.OptionParams(r=0.03)
    sim = mt.SimParams(n_paths=1 << 18, n_steps=8, seed=7)
    eu = th.price_heston(opt, STRESS, sim, scheme="euler", device="cpu")
    qe = th.price_heston(opt, STRESS, sim, scheme="qe", device="cpu")
    err_eu, err_qe = abs(float(eu.price) - cf), abs(float(qe.price) - cf)
    assert err_eu > 0.5
    assert err_qe < err_eu / 5.0, (err_qe, err_eu)
    assert err_qe < 0.01 * cf


def test_qe_matches_cf_moderate_steps():
    """tests/test_heston_qe.py:102-108: 4 se + 0.3%."""
    cf = th.heston_call_cf(100.0, 100.0, 1.0, 0.03, *STRESS.astuple())
    res = th.price_heston(mt.OptionParams(r=0.03), STRESS,
                          mt.SimParams(n_paths=1 << 19, n_steps=32, seed=5),
                          scheme="qe", antithetic=True, device="cpu")
    assert abs(float(res.price) - cf) <= 4.0 * float(res.stderr) + 0.003 * cf


def test_qe_and_euler_streams_are_disjoint():
    sim = mt.SimParams(n_paths=50_000, n_steps=64, seed=9)
    opt = mt.OptionParams(r=0.03)
    eu = th.price_heston(opt, STRESS, sim, scheme="euler", device="cpu")
    qe = th.price_heston(opt, STRESS, sim, scheme="qe", device="cpu")
    assert float(eu.price) != float(qe.price)


def test_path_dependent_payoffs_order():
    sim = mt.SimParams(n_paths=50_000, n_steps=20)
    vanilla = th.price_heston(sim=sim, device="cpu")
    for name in ("asian_call", "up_out_call"):
        res = th.price_heston(sim=sim, payoff=name, device="cpu")
        assert 0.0 < float(res.price) < float(vanilla.price), name


# --- trajectories -------------------------------------------------------------


@pytest.mark.parametrize("name", ["bullet_call", "asian_call", "vanilla_call",
                                  "down_out_call"])
def test_trajectories_match_mc_tpu_interpret(name):
    jopt, opt = _options(name)
    n_paths, n_steps = 1500, 12
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    key = rng.derive_key(3, 0, th.HESTON_TAG)
    jparams = jh._pack_heston(jopt.as_f32(), jh.DEMO_HESTON.as_f32(), n_steps)
    js, jv, jst, jsum, jsq = jh.heston_trajectories_kernel(
        jget_payoff(name), jcfg, jnp.asarray(key, jnp.uint32), jparams,
        interpret=True)
    prm = th.pack_heston(opt, th.DEMO_HESTON, n_steps, "cpu")
    cfg = th.HestonConfig(n_paths=n_paths, n_steps=n_steps)
    s, v, st, partials = th.heston_trajectories(get_payoff(name), cfg, key,
                                                prm)
    want_s = convert.surface_matrix(js, n_paths)
    want_v = convert.surface_matrix(jv, n_paths)
    want_st = convert.surface_matrix(jst, n_paths)
    np.testing.assert_allclose(s.T.numpy(), want_s, rtol=2e-6)
    np.testing.assert_allclose(v.T.numpy(), want_v, rtol=0,
                               atol=2e-6 * np.abs(want_v).max())
    if name in FLIPS:  # a count or a flag: equal but where a path flips
        same = (st.T.numpy() == want_st).all(axis=1).mean()
        assert same >= 0.999, same
    else:  # the Asian's running sum of S: S's tolerance
        np.testing.assert_allclose(st.T.numpy(), want_st, rtol=2e-6)
    sums = finish_sum(partials).numpy()
    want = np.array([float(jfinish_sum(jsum)), float(jfinish_sum(jsq))])
    if name in FLIPS:
        se = np.sqrt(want[1] / n_paths - (want[0] / n_paths) ** 2)
        assert abs(sums[0] - want[0]) / n_paths <= FLIP_SE * se / np.sqrt(
            n_paths)
    else:
        np.testing.assert_allclose(sums, want, rtol=1e-5)
    # the port's own sums are price_heston's Euler threefry-13 sums
    own = finish_sum(th.heston_partials(get_payoff(name), cfg, key, prm))
    np.testing.assert_allclose(sums, own.numpy(), rtol=1e-12)


def test_trajectories_state_is_the_payoff_of_the_grid():
    """The port's grids carry their own payoff: state == cumsum(S < B),
    v the raw full-truncation state (it can go negative)."""
    opt = mt.OptionParams(p1=1.0, p2=6.0)
    cfg = th.HestonConfig(n_paths=2048, n_steps=16)
    prm = th.pack_heston(opt, STRESS, 16, "cpu")
    s, v, st, _ = th.heston_trajectories(get_payoff("bullet_call"), cfg,
                                         (7, 9), prm)
    assert torch.equal(st, torch.cumsum((s < opt.barrier).float(), dim=0))
    assert bool((v < 0).any())
