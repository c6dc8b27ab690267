"""mc_tpu_torch's local-volatility family against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here (device="cpu").
mc_tpu runs its engine="xla" dual, or its Pallas kernels in interpret mode
where the dual cannot stand in: its XLA dual draws the threefry-13 stream
whatever rng_source says (``_localvol_partials`` does not pass it on,
ROADMAP C11), so the 20-round stream is held to the Pallas kernel; and the
trajectories have no dual.  Both draw the same threefry stream on the same
key.

Tolerances (the parity contract):
* the packed vector: bitwise but for sigma_ref, the one reduction of the
  pack (XLA's sum over the steps adds in its own blocking): within 2 ulp;
* the clamped-ramp lookup on the same f32 inputs: bitwise (no libm);
* a step on the same f32 inputs: 2e-6 relative plus 4 ulp of the largest
  output (exp is each framework's libm);
* smooth payoffs: price 1e-5 relative, stderr 1e-5 plus the bound of
  mc_tpu's f32 finish; payoffs where a path can flip at K or B: 0.05
  stderr;
* trajectories: S 2e-6 relative; a count or flag state equal on >= 99.9%
  of paths, the Asian's running sum 2e-6 relative; the payoff sums 1e-5.

The cases of tests/test_localvol.py (but the two American ones, LSMC, item
17) run at mc_tpu's sizes and tolerances.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import localvol as jl
from mc_tpu.models.cev import cev_call_closed_form
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import localvol as tl
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
# A steep, asymmetric smile on an asymmetric grid, so the ramps, the flat
# ends and the time dependence all matter.
J_SMILE = jl.LocalVolSurface.from_function(
    lambda x, t: 0.25 + 0.4 * x * x - 0.15 * x + 0.1 * t, 16, x_lo=-0.7,
    x_hi=1.1, n_knots=11)
SMILE = convert.localvol_surface(J_SMILE)


def _cev_surface(n_steps, beta=0.7, sigma_atm=0.2):
    """tests/test_localvol.py's CEV-shaped surface, K = 25 on [-1.5, 1.5]."""
    return jl.LocalVolSurface.from_function(
        lambda x, t: sigma_atm * math.exp((beta - 1.0) * x), n_steps,
        x_lo=-1.5, x_hi=1.5, n_knots=25)


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


# --- packing, the lookup and the step ----------------------------------------


@pytest.mark.parametrize("jsurf,opt,n_steps", [
    (jl.DEMO_LOCALVOL, mc_tpu.OptionParams(), 100),
    (J_SMILE, mc_tpu.OptionParams(s0=97.3, k=101.7, r=0.031, q=0.017, t=0.7),
     16),
    (_cev_surface(100), mc_tpu.OptionParams(), 100),
    (jl.LocalVolSurface.flat(0.2, 20), mc_tpu.OptionParams(), 20),
    (jl.LocalVolSurface.from_function(lambda x, t: 0.3 - 0.1 * x, 6,
                                      n_knots=2), mc_tpu.OptionParams(), 6),
])
def test_pack_localvol_matches_mc_tpu(jsurf, opt, n_steps):
    want = np.asarray(jl._pack_localvol(opt.as_f32(), jsurf.as_f32(),
                                        n_steps))
    got = tl.pack_localvol(convert.option_params(opt),
                           convert.localvol_surface(jsurf), n_steps, "cpu")
    k = jsurf.n_knots
    assert got.dtype == torch.float32
    assert got.shape == (tl.packed_length(k, n_steps),) == want.shape
    ulp = np.abs(got.numpy().view(np.int32).astype(np.int64)
                 - want.view(np.int32))
    assert ulp[10] <= 2, ulp[10]  # sigma_ref
    assert (np.delete(ulp, 10) == 0).all()
    np.testing.assert_array_equal(
        convert.localvol_params(want, k, n_steps).numpy().view(np.uint32),
        want.view(np.uint32))
    assert tl.HEAD_FIELDS == ("s0", "k", "t", "barrier", "p1", "p2", "q",
                              "dt", "inv_n_steps", "r", "sigma")
    p = tl.unpack_localvol(got, k)
    assert p.n_steps == n_steps and p.slopes.shape == (n_steps, k - 1)


@pytest.mark.parametrize("jsurf,n_steps", [(J_SMILE, 16),
                                           (_cev_surface(4), 4)])
def test_sigma_at_is_bitwise_mc_tpu(jsurf, n_steps):
    """The clamped-ramp lookup on a grid of w reaching past both ends,
    against mc_tpu's _make_sigma_at on the same packed vector, bitwise; and
    against numpy's piecewise-linear interpolation with flat ends
    (test_localvol.py's test_interpolation_matches_numpy)."""
    params = jl._pack_localvol(mc_tpu.OptionParams().as_f32(),
                               jsurf.as_f32(), n_steps)
    k = jsurf.n_knots
    jsig = jl._make_sigma_at(params, n_steps, k)
    p = tl.unpack_localvol(convert.localvol_params(np.asarray(params), k,
                                                   n_steps), k)
    w = np.linspace(-2.5, 2.5, 1001).astype(np.float32)
    for j in (0, n_steps // 2, n_steps - 1):
        want = np.asarray(jsig(jnp.asarray(w), j))
        got = tl.sigma_at(p, torch.from_numpy(w), j).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        interp = np.interp(w, np.asarray(jsurf.x_knots),
                           np.asarray(jsurf.vols)[j])
        np.testing.assert_allclose(got, np.maximum(interp, 1e-4), rtol=2e-5,
                                   atol=2e-6)


def test_two_steps_match_mc_tpu():
    """Two steps of mc_tpu's _localvol_leg on given normals (its on_step
    hook reads w and S after each) against the port's localvol_step."""
    rs = np.random.default_rng(5)
    n = 4000
    z = rs.standard_normal((2, n)).astype(np.float32) * 2
    jsurf = jl.LocalVolSurface.from_function(
        lambda x, t: 0.25 + 0.8 * x * x - 0.3 * x, 2, x_lo=-0.5, x_hi=0.5,
        n_knots=7)
    jparams = jl._pack_localvol(mc_tpu.OptionParams().as_f32(),
                                jsurf.as_f32(), 2)
    jp = jl._unpack_localvol_head(jparams)
    seen = {}

    def on_step(j, s, carry):
        seen[int(j)] = (np.asarray(carry[0]), np.asarray(s))

    with jax.disable_jit():  # the loop in Python: on_step sees values
        jl._localvol_leg(jget_payoff("vanilla_call"), 2, jp,
                         jnp.full((n,), jp.s0),
                         lambda m: (jnp.asarray(z[0]), jnp.asarray(z[1])),
                         jl._make_sigma_at(jparams, 2, 7), on_step=on_step)
    p = tl.unpack_localvol(convert.localvol_params(np.asarray(jparams), 7, 2),
                           7)
    w, state = torch.zeros(n), ()
    for j in range(2):
        w, s, state = tl.localvol_step(get_payoff("vanilla_call"), p, w,
                                       state, torch.from_numpy(z[j]), j)
        for g, want in zip((w, s), seen[j]):
            np.testing.assert_allclose(g.numpy(), want, rtol=2e-6,
                                       atol=4 * EPS32 * np.abs(want).max())


# --- price_localvol against mc_tpu.price_localvol ----------------------------


@pytest.mark.parametrize("name", sorted(PAYOFFS))
def test_every_payoff_matches_mc_tpu(name):
    """All 18, the bridge barriers on sigma_ref."""
    jopt, opt = _options(name)
    want = jl.price_localvol(jopt, J_SMILE, J_SIM, name, engine="xla")
    got = tl.price_localvol(opt, SMILE, SIM, name, device="cpu")
    _assert_close(name, got, want)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("rng_source", ["threefry13", "threefry"])
@pytest.mark.parametrize("name", ["vanilla_call", "bullet_call"])
def test_streams_match_mc_tpu(name, rng_source, antithetic):
    """threefry-13 against the XLA dual, threefry-20 against the Pallas
    kernel in interpret mode (the dual ignores rng_source, C11)."""
    jopt, opt = _options(name)
    jkw = (dict(engine="xla") if rng_source == "threefry13"
           else dict(engine="pallas", interpret=True, tile_rows=8))
    want = jl.price_localvol(jopt, J_SMILE, J_SIM, name,
                             antithetic=antithetic, rng_source=rng_source,
                             **jkw)
    got = tl.price_localvol(opt, SMILE, SIM, name, antithetic=antithetic,
                            rng_source=rng_source, device="cpu")
    _assert_close(name, got, want)


def test_cev_surface_k25_matches_mc_tpu():
    jsurf = _cev_surface(16)
    want = jl.price_localvol(mc_tpu.OptionParams(), jsurf, J_SIM,
                             engine="xla")
    got = tl.price_localvol(mt.OptionParams(),
                            convert.localvol_surface(jsurf), SIM,
                            device="cpu")
    _assert_close("vanilla_call", got, want)


def test_path_offset_and_bound_match_mc_tpu():
    jcfg = jpk.KernelConfig(n_paths=1000, n_steps=16, tile_rows=8)
    jparams = jl._pack_localvol(mc_tpu.OptionParams().as_f32(),
                                J_SMILE.as_f32(), 16)
    key = rng.derive_key(5, 0, tl.LOCALVOL_TAG)
    s, sq = jl._localvol_partials(jget_payoff("vanilla_call"), jcfg, 11,
                                  jnp.asarray(key, jnp.uint32), jparams, 1500,
                                  2300, engine="xla")
    want = np.array([float(jfinish_sum(s)), float(jfinish_sum(sq))])
    prm = convert.localvol_params(np.asarray(jparams), 11, 16)
    got = finish_sum(tl.localvol_partials(
        get_payoff("vanilla_call"),
        tl.LocalVolConfig(n_paths=1000, n_steps=16, n_knots=11), key, prm,
        path_offset=1500, n_valid=2300)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    head = finish_sum(tl.localvol_partials(
        get_payoff("vanilla_call"),
        tl.LocalVolConfig(n_paths=800, n_steps=16, n_knots=11), key, prm,
        path_offset=1500)).numpy()
    np.testing.assert_array_equal(got, head)


def test_guards():
    sim = mt.SimParams(n_paths=1024, n_steps=20)
    with pytest.raises(ValueError, match="surface has"):
        tl.price_localvol(surf=tl.LocalVolSurface.flat(0.2, 10), sim=sim,
                          device="cpu")
    with pytest.raises(ValueError, match="even n_steps"):
        tl.price_localvol(surf=tl.LocalVolSurface.flat(0.2, 7),
                          sim=mt.SimParams(n_paths=1024, n_steps=7),
                          device="cpu")
    bad = tl.LocalVolSurface(x_knots=np.array([0.5, -0.5], np.float32),
                             vols=np.full((20, 2), 0.2, np.float32))
    with pytest.raises(ValueError, match="ascending"):
        tl.price_localvol(surf=bad, sim=sim, device="cpu")
    with pytest.raises(ValueError, match="2 knots"):
        tl.price_localvol(surf=tl.LocalVolSurface.flat(0.2, 20, n_knots=1),
                          sim=sim, device="cpu")
    with pytest.raises(ValueError, match="hardware PRNG"):
        tl.price_localvol(surf=tl.LocalVolSurface.flat(0.2, 20), sim=sim,
                          rng_source="hw", device="cpu")
    with pytest.raises(ValueError, match="cliquet"):
        tl.price_localvol(mt.OptionParams(k=30.0), tl.LocalVolSurface.flat(
            0.2, 20), sim, "cliquet", device="cpu")
    cfg = tl.LocalVolConfig(n_paths=8, n_steps=4, n_knots=9)
    prm = tl.pack_localvol(mt.OptionParams(), tl.LocalVolSurface.demo(4), 4,
                           "cpu")
    with pytest.raises(ValueError, match="params"):
        tl.localvol_partials(get_payoff("vanilla_call"),
                             tl.LocalVolConfig(n_paths=8, n_steps=6,
                                               n_knots=9), (1, 2), prm)
    with pytest.raises(ValueError, match="one state array"):
        tl.localvol_trajectories(get_payoff("cliquet"), cfg, (1, 2), prm)
    with pytest.raises(ValueError, match="threefry-13"):
        tl.localvol_trajectories(
            get_payoff("bullet_call"),
            tl.LocalVolConfig(n_paths=8, n_steps=4, n_knots=9,
                              antithetic=True), (1, 2), prm)
    with pytest.raises(ValueError, match="K=9"):
        convert.localvol_params(np.zeros(10, np.float32), 9, 4)


def test_default_key_is_mc_tpus_localvol_stream():
    sim = mt.SimParams(n_paths=512, n_steps=4, seed=21)
    surf = tl.LocalVolSurface.demo(4)
    a = tl.price_localvol(surf=surf, sim=sim, device="cpu")
    b = tl.price_localvol(surf=surf, sim=sim,
                          key=rng.derive_key(21, 0, 0x10CA), device="cpu")
    c = tl.price_localvol(surf=surf, sim=sim, key=rng.derive_key(21, 0),
                          device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.price) != float(c.price)


def test_surfaces_match_mc_tpu():
    for mine, theirs in ((tl.DEMO_LOCALVOL, jl.DEMO_LOCALVOL),
                         (tl.LocalVolSurface.flat(0.3, 6, n_knots=4),
                          jl.LocalVolSurface.flat(0.3, 6, n_knots=4))):
        np.testing.assert_array_equal(mine.x_knots, theirs.x_knots)
        np.testing.assert_array_equal(mine.vols, theirs.vols)


# --- trajectories ------------------------------------------------------------


@pytest.mark.parametrize("name", ["bullet_call", "asian_call", "vanilla_call",
                                  "down_out_call"])
def test_trajectories_match_mc_tpu_interpret(name):
    jopt, opt = _options(name)
    n_paths, n_steps = 1500, 12
    jsurf = jl.LocalVolSurface.from_function(
        lambda x, t: 0.25 + 0.4 * x * x - 0.15 * x + 0.1 * t, n_steps,
        x_lo=-0.7, x_hi=1.1, n_knots=11)
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    key = rng.derive_key(3, 0, tl.LOCALVOL_TAG)
    jparams = jl._pack_localvol(jopt.as_f32(), jsurf.as_f32(), n_steps)
    js, jst, jsum, jsq = jl.localvol_trajectories_kernel(
        jget_payoff(name), jcfg, 11, jnp.asarray(key, jnp.uint32), jparams,
        interpret=True)
    prm = tl.pack_localvol(opt, convert.localvol_surface(jsurf), n_steps,
                           "cpu")
    cfg = tl.LocalVolConfig(n_paths=n_paths, n_steps=n_steps, n_knots=11)
    s, st, partials = tl.localvol_trajectories(get_payoff(name), cfg, key,
                                               prm)
    np.testing.assert_allclose(s.T.numpy(),
                               convert.surface_matrix(js, n_paths), rtol=2e-6)
    want_st = convert.surface_matrix(jst, n_paths)
    if name in FLIPS:
        assert (st.T.numpy() == want_st).all(axis=1).mean() >= 0.999
    else:
        np.testing.assert_allclose(st.T.numpy(), want_st, rtol=2e-6)
    sums = finish_sum(partials).numpy()
    want = np.array([float(jfinish_sum(jsum)), float(jfinish_sum(jsq))])
    if name in FLIPS:
        se = np.sqrt(want[1] / n_paths - (want[0] / n_paths) ** 2)
        assert abs(sums[0] - want[0]) / n_paths <= FLIP_SE * se / np.sqrt(
            n_paths)
    else:
        np.testing.assert_allclose(sums, want, rtol=1e-5)
    # the grids' own sums are price_localvol's threefry-13 sums
    own = finish_sum(tl.localvol_partials(get_payoff(name), cfg, key, prm))
    np.testing.assert_allclose(sums, own.numpy(), rtol=1e-12)


def test_trajectories_state_is_the_payoff_of_the_grid():
    opt = mt.OptionParams(p1=1.0, p2=6.0)
    cfg = tl.LocalVolConfig(n_paths=2048, n_steps=16, n_knots=11)
    prm = tl.pack_localvol(opt, SMILE, 16, "cpu")
    s, st, _ = tl.localvol_trajectories(get_payoff("bullet_call"), cfg,
                                        (7, 9), prm)
    assert torch.equal(st, torch.cumsum((s < opt.barrier).float(), dim=0))


# --- the cases of tests/test_localvol.py -------------------------------------

ST_SIM = mt.SimParams(n_paths=200_000, n_steps=20)


def _gate(res, want, n_se=3.5, bias=0.0):
    assert abs(float(res.price) - want) <= n_se * float(res.stderr) + bias, (
        float(res.price), want, float(res.stderr))


def test_flat_surface_is_bs_exact():
    res = tl.price_localvol(mt.OptionParams(),
                            tl.LocalVolSurface.flat(0.2, 20), ST_SIM,
                            antithetic=True, device="cpu")
    _gate(res, mt.oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2))


def test_time_only_surface_is_averaged_bs():
    surf = tl.LocalVolSurface.from_function(lambda x, t: 0.1 + 0.3 * t, 20)
    sg = np.asarray(surf.vols)[:, 0].astype(np.float64)
    res = tl.price_localvol(mt.OptionParams(), surf, ST_SIM, antithetic=True,
                            device="cpu")
    _gate(res, mt.oracle.bs_call(100.0, 100.0, 1.0, 0.1,
                                 float(np.sqrt((sg ** 2).mean()))))


def test_cev_cross_model_gate():
    """The CEV-shaped surface against the CEV closed form, through log-Euler
    and the knot interpolation: 3.5 se + 0.02, as mc_tpu's (at 400,000 x
    100, its size)."""
    beta, sigma_atm, s0 = 0.7, 0.2, 100.0
    surf = convert.localvol_surface(_cev_surface(100, beta, sigma_atm))
    res = tl.price_localvol(mt.OptionParams(), surf,
                            mt.SimParams(n_paths=400_000, n_steps=100),
                            antithetic=True, device="cpu")
    want = cev_call_closed_form(s0, 100.0, 1.0, 0.1,
                                sigma_atm * s0 ** (1.0 - beta), beta)
    _gate(res, want, bias=0.02)


def test_smile_raises_otm_wings():
    smile = tl.LocalVolSurface.from_function(lambda x, t: 0.2 + 0.3 * x * x,
                                             20)
    res = tl.price_localvol(mt.OptionParams(k=130.0), smile, ST_SIM,
                            antithetic=True, device="cpu")
    flat_bs = mt.oracle.bs_call(100.0, 130.0, 1.0, 0.1, 0.2)
    assert float(res.price) > flat_bs + 3 * float(res.stderr)


def test_path_dependent_payoffs_run():
    sim = mt.SimParams(n_paths=20_000, n_steps=20)
    surf = tl.LocalVolSurface.from_function(lambda x, t: 0.2 + 0.1 * x * x,
                                            20)
    a = tl.price_localvol(mt.OptionParams(), surf, sim, payoff="asian_call",
                          device="cpu")
    b = tl.price_localvol(mt.OptionParams(p1=1.0, p2=18.0), surf, sim,
                          payoff="bullet_call", device="cpu")
    assert float(a.price) > 0 and float(b.price) > 0
