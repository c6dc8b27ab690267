"""mc_tpu_torch's Merton jump-diffusion family against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here (device="cpu").
mc_tpu runs its engine="xla" dual, or its Pallas kernels in interpret mode
where the dual cannot stand in: its XLA dual draws the threefry-13 stream
whatever rng_source says (``_merton_partials`` does not pass it on), so the
20-round stream is held to the Pallas kernel; and the trajectories have no
dual.  Both draw the same threefry stream on the same key.

Tolerances (the parity contract):
* the packed parameters, ``poisson_kmax`` and the Poisson scan on a grid of
  uniforms: bitwise;
* smooth payoffs: price 1e-5 relative, stderr 1e-5 plus the bound of
  mc_tpu's f32 finish; payoffs where a path can flip at K or B (digitals,
  discrete barriers, the bullet's window): 0.05 stderr.  A Poisson count
  moves only where u lands within an ulp of a cdf step, and then moves a
  path by a whole jump: a flip, inside the same 0.05 stderr;
* trajectories: S 2e-6 relative; a count or flag state equal on >= 99.9%
  of paths, the Asian's running sum 2e-6 relative; the payoff sums 1e-5.

The statistical cases of tests/test_merton.py run at mc_tpu's sizes and
tolerances.
"""

import math

import jax.numpy as jnp
import numpy as np
from jax import lax
import pytest
import torch

import mc_tpu
from mc_tpu.models import merton as jm
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import merton as tm
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
# More and larger jumps than the demo: the scan and the jump term matter.
J_JUMPY = jm.MertonDynamics(lam=1.5, mu_j=0.05, sigma_j=0.25)
JUMPY = convert.merton_dynamics(J_JUMPY)
TERMINAL = sorted(n for n, po in PAYOFFS.items() if po.terminal_only)

# tests/test_merton.py's configuration.
ST_SIM = mt.SimParams(n_paths=200_000, n_steps=50)
ORACLE = tm.merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2, lam=0.3,
                                    mu_j=-0.10, sigma_j=0.15)


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


# --- packing, the scan and the draws ----------------------------------------


@pytest.mark.parametrize("dyn,opt,n_steps", [
    (jm.DEMO_MERTON, mc_tpu.OptionParams(), 100),
    (J_JUMPY, mc_tpu.OptionParams(s0=97.3, k=101.7, r=0.031, q=0.017, t=0.7,
                                  sigma=0.33), 37),
])
def test_pack_merton_is_bitwise_mc_tpu(dyn, opt, n_steps):
    want = np.asarray(jm._pack_merton(opt.as_f32(), dyn.as_f32(), n_steps))
    got = tm.pack_merton(convert.option_params(opt),
                         convert.merton_dynamics(dyn), n_steps, "cpu")
    assert got.dtype == torch.float32 and got.shape == (19,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert tm.MERTON_FIELDS == jm._MERTON_FIELDS
    np.testing.assert_array_equal(
        convert.merton_params(want).numpy().view(np.uint32),
        want.view(np.uint32))


@pytest.mark.parametrize("lam", [0.0, 1e-4, 0.003, 0.3, 1.0, 17.0, 100.0])
def test_poisson_kmax_matches_mc_tpu(lam):
    assert tm.poisson_kmax(lam) == jm.poisson_kmax(lam)


@pytest.mark.parametrize("lam", [0.003, 0.05, 0.3, 2.0, 17.0])
def test_poisson_inv_cdf_is_bitwise_on_a_uniform_grid(lam):
    u = np.concatenate([np.linspace(0.0, 1.0, 200_001, dtype=np.float32),
                        np.float32(0.99999994)[None]])
    kmax = tm.poisson_kmax(lam)
    want = np.asarray(jm._poisson_inv_cdf(jnp.asarray(u), jnp.float32(lam),
                                          kmax))
    got = tm.poisson_inv_cdf(torch.from_numpy(u),
                             torch.tensor(lam, dtype=torch.float32), kmax)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() <= kmax


def test_draw3_and_jump_increment_match_mc_tpu():
    ids = np.arange(5000, dtype=np.uint32)
    key = rng.derive_key(4, 0, tm.MERTON_TAG)
    want = jm._merton_draw3(jnp.uint32(key[0]), jnp.uint32(key[1]),
                            jnp.asarray(ids), 7, lax.bitcast_convert_type)
    got = tm.merton_draw3(int(key[0]), int(key[1]),
                          torch.from_numpy(ids.astype(np.int64)), 7)
    for q, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        if q >= 4:  # the uniforms: exact bit arithmetic
            np.testing.assert_array_equal(g.numpy(), w)
        else:  # the normals: the frameworks' log1p/cos/sin, a few ulp
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=8 * EPS32 * np.abs(w).max())
    p = tm.unpack_merton(tm.pack_merton(mt.OptionParams(), JUMPY, 16, "cpu"))
    jp = jm._unpack_merton(jm._pack_merton(mc_tpu.OptionParams().as_f32(),
                                           J_JUMPY.as_f32(), 16))
    n = np.array([0, 1, 2, 3, 7], np.float32)
    e = np.array([0.3, -1.2, 2.5, 0.0, -0.7], np.float32)
    np.testing.assert_allclose(
        tm.jump_increment(p, torch.from_numpy(n), torch.from_numpy(e)).numpy(),
        np.asarray(jm._jump_increment(jp, jnp.asarray(n), jnp.asarray(e))),
        rtol=1e-6)


# --- price_merton against mc_tpu.price_merton --------------------------------


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("rng_source", ["threefry13", "threefry"])
@pytest.mark.parametrize("method", ["euler", "terminal"])
def test_vanilla_matches_mc_tpu(method, rng_source, antithetic):
    kw = dict(method=method, antithetic=antithetic, rng_source=rng_source)
    jkw = (dict(engine="xla") if rng_source == "threefry13"
           else dict(engine="pallas", interpret=True, tile_rows=8))
    want = jm.price_merton(mc_tpu.OptionParams(), J_JUMPY, J_SIM, **kw, **jkw)
    got = tm.price_merton(mt.OptionParams(), JUMPY, SIM, **kw, device="cpu")
    _assert_close("vanilla_call", got, want)


@pytest.mark.parametrize("name", sorted(PAYOFFS))
def test_every_payoff_matches_mc_tpu_euler(name):
    """All 18, the two Brownian-bridge barriers included: Merton packs the
    diffusion's sigma, which their crossing probability reads."""
    jopt, opt = _options(name)
    want = jm.price_merton(jopt, jm.DEMO_MERTON, J_SIM, name, engine="xla")
    got = tm.price_merton(opt, tm.DEMO_MERTON, SIM, name, device="cpu")
    _assert_close(name, got, want)


@pytest.mark.parametrize("name", TERMINAL)
def test_terminal_payoffs_match_mc_tpu(name):
    jopt, opt = _options(name)
    want = jm.price_merton(jopt, J_JUMPY, J_SIM, name, method="terminal",
                           antithetic=True, engine="xla")
    got = tm.price_merton(opt, JUMPY, SIM, name, method="terminal",
                          antithetic=True, device="cpu")
    _assert_close(name, got, want)


def test_terminal_draw_keeps_mc_tpus_layout():
    """ROADMAP C12: mc_tpu's terminal draw unpacks its draw3 as (z, e, _, _,
    u, _), so z and e are the two halves of the diffusion pair (id, 0) and
    u is word 0 of (id, 2); the jump-size pair (id, 1) goes unused.  The
    port keeps it: the price from those draws by hand is price_merton's."""
    n = 4096
    key = rng.derive_key(1234, 0, tm.MERTON_TAG)
    ids = torch.arange(n, dtype=torch.int64)
    z, e = rng.normal_pair(int(key[0]), int(key[1]), ids, torch.zeros_like(ids))
    b0, _ = rng.threefry2x32(int(key[0]), int(key[1]), ids,
                             torch.full_like(ids, 2), rounds=13)
    u = rng.bits_to_unit(b0)
    p = tm.unpack_merton(tm.pack_merton(mt.OptionParams(), JUMPY, 4, "cpu"))
    kmax = tm.poisson_kmax(JUMPY.lam * 1.0)
    cnt = tm.poisson_inv_cdf(u, p.lam_t, kmax)
    s_t = p.s0 * torch.exp(p.drift_t + p.vol_t * z
                           + tm.jump_increment(p, cnt, e))
    pay = torch.clamp(s_t - p.k, min=0.0).double()
    res = tm.price_merton(mt.OptionParams(), JUMPY,
                          mt.SimParams(n_paths=n, n_steps=4), method="terminal",
                          device="cpu")
    assert float(res.payoff_mean) == pytest.approx(float(pay.mean()),
                                                   rel=1e-12)
    assert float((cnt > 0).double().mean()) > 0.5  # lam*T = 1.5: jumps drawn


@pytest.mark.parametrize("method", ["euler", "terminal"])
def test_path_offset_and_bound_match_mc_tpu(method):
    """merton_partials over a slice of the global ids, masked at n_valid:
    the (path_offset, n_valid) pair mc_tpu's sharded callers pass."""
    jcfg = jpk.KernelConfig(n_paths=1000, n_steps=8, tile_rows=8,
                            method=method)
    jparams = jm._pack_merton(mc_tpu.OptionParams().as_f32(),
                              J_JUMPY.as_f32(), 8)
    kmax = tm.poisson_kmax(J_JUMPY.lam * (1.0 if method == "terminal"
                                          else 1.0 / 8))
    key = rng.derive_key(5, 0, tm.MERTON_TAG)
    s, sq = jm._merton_partials(jget_payoff("vanilla_call"), jcfg, kmax,
                                jnp.asarray(key, jnp.uint32), jparams, 1500,
                                2300, engine="xla")
    want = np.array([float(jfinish_sum(s)), float(jfinish_sum(sq))])
    prm = convert.merton_params(np.asarray(jparams))
    cfg = tm.MertonConfig(n_paths=1000, n_steps=8, kmax=kmax, method=method)
    got = finish_sum(tm.merton_partials(get_payoff("vanilla_call"), cfg, key,
                                        prm, path_offset=1500,
                                        n_valid=2300)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    head = finish_sum(tm.merton_partials(
        get_payoff("vanilla_call"),
        tm.MertonConfig(n_paths=800, n_steps=8, kmax=kmax, method=method),
        key, prm, path_offset=1500)).numpy()
    np.testing.assert_array_equal(got, head)


def test_guards():
    sim = mt.SimParams(n_paths=1024, n_steps=9)
    with pytest.raises(ValueError, match="even n_steps"):
        tm.price_merton(sim=sim, device="cpu")
    with pytest.raises(ValueError, match="path-dependent"):
        tm.price_merton(sim=SIM, payoff="asian_call", method="terminal",
                        device="cpu")
    with pytest.raises(ValueError, match="method"):
        tm.price_merton(sim=SIM, method="milstein", device="cpu")
    with pytest.raises(ValueError, match="hardware PRNG"):
        tm.price_merton(sim=SIM, rng_source="hw", device="cpu")
    with pytest.raises(ValueError, match="params"):
        tm.merton_partials(get_payoff("vanilla_call"),
                           tm.MertonConfig(n_paths=8, n_steps=2, kmax=4),
                           (1, 2), torch.zeros(17))
    with pytest.raises(ValueError, match="kmax"):
        tm.MertonConfig(n_paths=8, n_steps=2, kmax=257)
    prm = tm.pack_merton(mt.OptionParams(), tm.DEMO_MERTON, 2, "cpu")
    cfg = tm.MertonConfig(n_paths=8, n_steps=2, kmax=4)
    with pytest.raises(ValueError, match="one state array"):
        tm.merton_trajectories(get_payoff("cliquet"), cfg, (1, 2), prm)
    with pytest.raises(ValueError, match="Euler loop"):
        tm.merton_trajectories(
            get_payoff("bullet_call"),
            tm.MertonConfig(n_paths=8, n_steps=2, kmax=4, antithetic=True),
            (1, 2), prm)


def test_default_key_is_mc_tpus_merton_stream():
    sim = mt.SimParams(n_paths=512, n_steps=4, seed=21)
    a = tm.price_merton(sim=sim, device="cpu")
    b = tm.price_merton(sim=sim, key=rng.derive_key(21, 0, 0x3E44),
                        device="cpu")
    c = tm.price_merton(sim=sim, key=rng.derive_key(21, 0), device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.price) != float(c.price)


def test_series_oracle_matches_mc_tpu():
    for args, kw in (((100.0, 100.0, 1.0, 0.1, 0.2, 0.3, -0.1, 0.15), {}),
                     ((100.0, 90.0, 0.5, 0.03, 0.25, 2.0, 0.05, 0.3),
                      dict(q=0.02))):
        assert tm.merton_call_closed_form(*args, **kw) == pytest.approx(
            jm.merton_call_closed_form(*args, **kw), rel=1e-14)


# --- the cases of tests/test_merton.py ----------------------------------------


def test_series_oracle_gbm_limit():
    cf = tm.merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2, lam=0.0,
                                    mu_j=-0.1, sigma_j=0.15)
    assert cf == pytest.approx(mt.oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2),
                               rel=1e-6)


def test_series_oracle_jumps_raise_otm_price():
    otm_m = tm.merton_call_closed_form(100.0, 160.0, 0.25, 0.05, 0.2,
                                       lam=1.0, mu_j=0.0, sigma_j=0.3)
    assert otm_m > 2.0 * mt.oracle.bs_call(100.0, 160.0, 0.25, 0.05, 0.2)


@pytest.mark.parametrize("method", ["terminal", "euler"])
def test_matches_series(method):
    """The per-step log increment is exact in law: no discretization bias,
    only MC noise, even at 50 steps (3.5 se, as mc_tpu's)."""
    res = tm.price_merton(sim=ST_SIM, method=method, device="cpu")
    assert abs(float(res.price) - ORACLE) <= 3.5 * float(res.stderr)


def test_martingale_compensation():
    res = tm.price_merton(mt.OptionParams(k=0.0), sim=ST_SIM,
                          method="terminal", device="cpu")
    assert abs(float(res.price) - 100.0) <= 3.5 * float(res.stderr)


def test_antithetic_unbiased_and_tighter():
    plain = tm.price_merton(sim=ST_SIM, device="cpu")
    anti = tm.price_merton(sim=ST_SIM, antithetic=True, device="cpu")
    joint = math.hypot(float(plain.stderr), float(anti.stderr))
    assert abs(float(plain.price) - float(anti.price)) <= 4.0 * joint
    assert float(anti.stderr) < float(plain.stderr)


def test_path_dependent_payoff_under_jumps():
    asian = tm.price_merton(sim=ST_SIM, payoff="asian_call", device="cpu")
    vanilla = tm.price_merton(sim=ST_SIM, device="cpu")
    assert 0.0 < float(asian.price) < float(vanilla.price)


def test_poisson_inv_cdf_moments():
    u = torch.from_numpy(np.random.default_rng(0).random(200_000,
                                                         dtype=np.float32))
    for lam in (0.05, 0.5, 2.0):
        n = tm.poisson_inv_cdf(u, torch.tensor(lam, dtype=torch.float32),
                               tm.poisson_kmax(lam)).double()
        se_mean = math.sqrt(lam / n.numel())
        assert abs(float(n.mean()) - lam) < 4.0 * se_mean, lam
        assert abs(float(n.var()) - lam) < 0.02 * lam + 4.0 * se_mean, lam
    n0 = tm.poisson_inv_cdf(u, torch.tensor(0.0), tm.poisson_kmax(0.0))
    assert bool((n0 == 0.0).all())


def test_poisson_kmax_tail_and_depth_overflow():
    assert tm.poisson_kmax(0.0) == 1
    assert tm.poisson_kmax(1.0) >= 12
    assert tm.poisson_kmax(100.0) < 256
    with pytest.raises(ValueError, match="scan depth"):
        tm.poisson_kmax(250.0)


def test_price_merton_validates_payoff():
    with pytest.raises(ValueError, match="determination step"):
        tm.price_merton(mt.OptionParams(p1=999.0), sim=ST_SIM,
                        payoff="forward_start_call", device="cpu")


def test_dividend_yield_through_merton():
    opt = mt.OptionParams(q=0.03)
    ref = tm.merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2, lam=0.3,
                                     mu_j=-0.10, sigma_j=0.15, q=0.03)
    res = tm.price_merton(opt, sim=ST_SIM, method="terminal", device="cpu")
    assert abs(float(res.price) - ref) <= 3.5 * float(res.stderr)


# --- trajectories -------------------------------------------------------------


@pytest.mark.parametrize("name", ["bullet_call", "asian_call", "vanilla_call",
                                  "down_out_call"])
def test_trajectories_match_mc_tpu_interpret(name):
    jopt, opt = _options(name)
    n_paths, n_steps = 1500, 12
    kmax = tm.poisson_kmax(J_JUMPY.lam / n_steps)
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    key = rng.derive_key(3, 0, tm.MERTON_TAG)
    jparams = jm._pack_merton(jopt.as_f32(), J_JUMPY.as_f32(), n_steps)
    js, jst, jsum, jsq = jm.merton_trajectories_kernel(
        jget_payoff(name), jcfg, kmax, jnp.asarray(key, jnp.uint32), jparams,
        interpret=True)
    prm = tm.pack_merton(opt, JUMPY, n_steps, "cpu")
    cfg = tm.MertonConfig(n_paths=n_paths, n_steps=n_steps, kmax=kmax)
    s, st, partials = tm.merton_trajectories(get_payoff(name), cfg, key, prm)
    want_s = convert.surface_matrix(js, n_paths)
    want_st = convert.surface_matrix(jst, n_paths)
    np.testing.assert_allclose(s.T.numpy(), want_s, rtol=2e-6)
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
    # the port's own sums are price_merton's Euler threefry-13 sums
    own = finish_sum(tm.merton_partials(get_payoff(name), cfg, key, prm))
    np.testing.assert_allclose(sums, own.numpy(), rtol=1e-12)


def test_trajectories_state_is_the_payoff_of_the_grid():
    opt = mt.OptionParams(p1=1.0, p2=6.0)
    cfg = tm.MertonConfig(n_paths=2048, n_steps=16, kmax=4)
    prm = tm.pack_merton(opt, JUMPY, 16, "cpu")
    s, st, _ = tm.merton_trajectories(get_payoff("bullet_call"), cfg, (7, 9),
                                      prm)
    assert torch.equal(st, torch.cumsum((s < opt.barrier).float(), dim=0))
    # jumps: some one-step log returns far beyond the diffusion's 4 sd
    lr = torch.log(s[1:] / s[:-1])
    assert float(lr.abs().max()) > 4 * 0.2 * math.sqrt(1 / 16)
