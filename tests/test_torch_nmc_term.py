"""mc_tpu_torch's nested MC under term structures (the family engine, fused
and grid, the grid's S outer grid from the generic trajectories kernel)
against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here; mc_tpu runs its
engine="xla" dual, bitwise equal to its grid and fused Pallas kernels (its
grid strategy builds the outer grid with its XLA scan).  Both draw the same
outer (pair j/2 per step) and inner (pair c_base + q per two substeps, the
trailing odd one dropped) threefry-13 streams, read the curves by the
absolute move j+1+u and Kahan-sum the inner legs in the same order.

Tolerances (parity contract): the smooth payoffs' surfaces to rtol = atol =
1e-5 on at least 99.9% of points and their mean and the outer price to 1e-5
relative; the bullet's surface within 1e-4 on 99.9% of points and its outer
price and surface mean within 0.05 outer stderr; the outer grid to 2e-6; one
inner leg on the same inputs to 2e-6 relative plus 16 ulp of the largest
spot.  Inside the port, grid == fused bitwise, and the outer price is
price_term's on the outer key to f64 rounding.  The inner legs restart from
w = log(S_t/s0) and pay on s0*exp(w): the last row is the discounted payoff
of s0*exp(log(S_T/s0)), not of S_T.  The statistical cases of
tests/test_nmc_term.py run at its sizes and tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import term as jt
from mc_tpu.nmc_engine import xla_family_trajectories
from mc_tpu.nmc_term import TermNMC as JTermNMC
from mc_tpu.nmc_term import price_nmc_term as jprice
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import term as tt
from mc_tpu_torch.nmc_engine import (NMC_FAMILIES, NMC_FAMILY_BUILDERS,
                                     FamilyConfig, ensure_family,
                                     family_rows_plain, family_trajectories,
                                     price_nmc_family)
from mc_tpu_torch.nmc_term import TermNMC, price_nmc_term
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
OPT = convert.option_params(J_OPT)
FLIP_SE, FLIP_TOL, SMOOTH_TOL, SURF_FRAC = 0.05, 1e-4, 1e-5, 0.999
EPS32 = 2.0 ** -24


def _curve(n):
    """Steep curves: the drift and the vol move step by step."""
    return jt.TermStructure.from_knots([0.12, 0.05, 0.02], [0.1, 0.35, 0.2],
                                       n)


def _assert_matches(got, want, n_paths, payoff):
    g = got.surface_matrix().numpy()
    w = convert.surface_matrix(want.surface, n_paths)
    assert g.shape == w.shape
    flip = payoff == "bullet_call"
    tol = FLIP_TOL if flip else SMOOTH_TOL
    close = np.isclose(g, w, rtol=tol, atol=tol).mean()
    assert close >= SURF_FRAC, close
    ws = float(want.outer.stderr)
    if flip:
        assert abs(float(got.outer.price) - float(want.outer.price)) <= (
            FLIP_SE * ws)
        assert abs(float(got.surface_mean) - float(want.surface_mean)) <= (
            FLIP_SE * ws)
    else:
        assert float(got.outer.price) == pytest.approx(
            float(want.outer.price), rel=SMOOTH_TOL)
        assert float(got.surface_mean) == pytest.approx(
            float(want.surface_mean), rel=SMOOTH_TOL)


@pytest.mark.parametrize("n_paths", [512, 300])  # 300: a partial tile
@pytest.mark.parametrize("strategy", ["fused", "grid"])
@pytest.mark.parametrize("payoff", ["vanilla_call", "bullet_call",
                                    "asian_call"])
def test_matches_mc_tpu(payoff, strategy, n_paths):
    jsim = mc_tpu.SimParams(n_paths=n_paths, n_steps=8, n_paths_inner=8)
    got = price_nmc_term(OPT, convert.term_structure(_curve(8)),
                         convert.sim_params(jsim), payoff, strategy=strategy,
                         device="cpu")
    want = jprice(J_OPT, _curve(8), jsim, payoff, engine="xla")
    _assert_matches(got, want, jsim.n_paths, payoff)


def test_default_curves_match_mc_tpu():
    jsim = mc_tpu.SimParams(n_paths=512, n_steps=8, n_paths_inner=8)
    got = price_nmc_term(sim=convert.sim_params(jsim), device="cpu")
    want = jprice(sim=jsim, engine="xla")
    _assert_matches(got, want, jsim.n_paths, "vanilla_call")


@pytest.mark.parametrize("name", ["vanilla_call", "asian_call",
                                  "bullet_call"])
def test_family_trajectories_match_mc_tpu_scan(name):
    """The generic trajectories under term (the plain version here) against
    mc_tpu's XLA outer scan: S to 2e-6, the Asian's sum to 2e-6, a count
    equal on >= 99.9% of paths; the payoff sums are price_term's."""
    n_paths, n_steps = 1500, 12
    key = rng.derive_key(3, 0, tt.TERM_TAG)
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    jparams = JTermNMC().pack(J_OPT.as_f32(), _curve(n_steps).as_f32(),
                              n_steps)
    js, jst, jsum, jsq = xla_family_trajectories(
        JTermNMC(), jget_payoff(name), jcfg, jparams,
        np.asarray(key, np.uint32))
    cfg = FamilyConfig(n_paths=n_paths, n_steps=n_steps, n_inner=1)
    prm = tt.pack_term(OPT, convert.term_structure(_curve(n_steps)), n_steps,
                       "cpu")
    s, st, partials = family_trajectories(TermNMC(), get_payoff(name), cfg,
                                          key, prm)
    np.testing.assert_allclose(s.T.numpy(), convert.surface_matrix(js, n_paths),
                               rtol=2e-6)
    want_st = convert.surface_matrix(jst, n_paths)
    if name == "bullet_call":
        assert (st.T.numpy() == want_st).all(axis=1).mean() >= 0.999
    else:
        np.testing.assert_allclose(st.T.numpy(), want_st, rtol=2e-6)
    sums = finish_sum(partials).numpy()
    want = np.array([float(jfinish_sum(jsum)), float(jfinish_sum(jsq))])
    if name != "bullet_call":
        np.testing.assert_allclose(sums, want, rtol=1e-5)
    own = finish_sum(tt.term_partials(
        get_payoff(name), tt.TermConfig(n_paths=n_paths, n_steps=n_steps),
        key, prm))
    np.testing.assert_allclose(sums, own.numpy(), rtol=1e-12)


@pytest.mark.parametrize("j", [1, 2])  # odd and even remaining substeps
def test_leg_matches_mc_tpu(j):
    """An inner leg from the same (S_t, Asian sum) at row j of 6 through
    mc_tpu's TermNMC.leg and the port's, on the same counters and curves."""
    rs = np.random.default_rng(37 + j)
    n, n_steps = 2048, 6
    s_t = rs.uniform(60.0, 180.0, n).astype(np.float32)
    acc = rs.uniform(0.0, 500.0, n).astype(np.float32)
    ids = np.arange(n, dtype=np.uint32) + 7
    jparams = jt._pack_term(J_OPT.as_f32(), _curve(n_steps).as_f32(),
                            n_steps)
    fam = JTermNMC()
    remaining = n_steps - j - 1
    want = fam.leg(jget_payoff("asian_call"), jt._unpack_term_head(jparams),
                   fam.make_ctx(jparams, n_steps), jnp.uint32(11),
                   jnp.uint32(12), jnp.asarray(ids), jnp.uint32(96), j,
                   remaining, (jnp.asarray(s_t),), (jnp.asarray(acc),),
                   jax.lax.bitcast_convert_type, n_steps)
    p = tt.unpack_term(tt.pack_term(OPT, convert.term_structure(
        _curve(n_steps)), n_steps, "cpu"))
    got = TermNMC().leg(get_payoff("asian_call"), p, 11, 12,
                        torch.from_numpy(ids.astype(np.int64))[None],
                        torch.tensor([[96]]), remaining,
                        (torch.from_numpy(s_t)[None],),
                        (torch.from_numpy(acc)[None],))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=16 * EPS32 * float(s_t.max()))


@pytest.fixture(scope="module")
def both():
    sim = mt.SimParams(n_paths=512, n_steps=8, n_paths_inner=8, seed=3)
    curve = convert.term_structure(_curve(8))
    return sim, curve, {s: price_nmc_term(OPT, curve, sim, strategy=s,
                                          device="cpu")
                        for s in ("fused", "grid")}


def test_grid_equals_fused_bitwise(both):
    _, _, res = both
    assert torch.equal(res["grid"].surface, res["fused"].surface)
    assert float(res["grid"].outer.price) == float(res["fused"].outer.price)
    assert float(res["grid"].outer.stderr) == float(res["fused"].outer.stderr)
    assert res["fused"].spot_surface is None
    assert res["grid"].spot_matrix().shape == (512, 8)


def test_outer_is_price_term_on_the_outer_key(both):
    sim, curve, res = both
    pt = tt.price_term(OPT, curve, sim, device="cpu")
    for r in res.values():
        assert float(r.outer.price) == pytest.approx(float(pt.price),
                                                     rel=1e-12)
        assert float(r.outer.stderr) == pytest.approx(float(pt.stderr),
                                                      rel=1e-12)


def test_last_step_pays_on_the_recomputed_spot(both):
    _, curve, res = both
    g = res["grid"]
    prm = tt.pack_term(OPT, curve, 8, "cpu")
    p = tt.unpack_term(prm)
    s = p.s0 * torch.exp(torch.log(g.spot_surface[-1] / p.s0))
    disc = torch.exp(-p.r * p.t)  # r = r_bar
    assert torch.equal(g.surface[-1], disc * torch.clamp(s - p.k, min=0.0))
    # On a last row of spots that the round trip moves, the plain leg pays
    # on s0*exp(log(x/s0)), not on x.
    x = torch.linspace(101.0, 200.0, 1 << 16, dtype=torch.float32)
    rt = p.s0 * torch.exp(torch.log(x / p.s0))
    off = rt != x
    assert bool(off.any())
    x, rt = x[off], rt[off]
    grid = x.expand(8, -1).contiguous()
    row = family_rows_plain(
        TermNMC(), get_payoff("vanilla_call"),
        FamilyConfig(n_paths=x.numel(), n_steps=8, n_inner=1), (3, 4), prm,
        (grid,), torch.zeros_like(grid), [7])[0]
    assert torch.equal(row, disc * torch.clamp(rt - p.k, min=0.0))
    assert not torch.equal(row, disc * torch.clamp(x - p.k, min=0.0))


def test_guards():
    with pytest.raises(ValueError, match="counter"):
        price_nmc_term(sim=mt.SimParams(n_paths=256, n_steps=4096,
                                        n_paths_inner=1024), device="cpu")
    with pytest.raises(ValueError, match="params"):
        family_trajectories(TermNMC(), get_payoff("vanilla_call"),
                            FamilyConfig(n_paths=8, n_steps=4, n_inner=2),
                            (1, 2), torch.zeros(17))


def test_registry_and_builder():
    """tests/test_nmc_family_fused.py's term case: the builder's family
    (mc_tpu's default curves at the run's steps), fused == grid bitwise."""
    ensure_family("term")
    assert NMC_FAMILIES["term"] is price_nmc_term
    sim = mt.SimParams(n_paths=512, n_steps=4, n_paths_inner=8)
    fam, dyn = NMC_FAMILY_BUILDERS["term"](mt.OptionParams(), None, sim)
    assert isinstance(fam, TermNMC)
    np.testing.assert_array_equal(dyn.rates, tt.demo_term(4).rates)
    np.testing.assert_array_equal(
        dyn.sigmas, np.asarray(jt.TermStructure.from_knots(
            [0.10, 0.07, 0.05], [0.15, 0.22, 0.30], 4).sigmas))
    g, f = (price_nmc_family(fam, mt.OptionParams(), dyn, sim, "vanilla_call",
                             strategy=s, device="cpu")
            for s in ("grid", "fused"))
    assert torch.equal(g.surface, f.surface)
    assert float(g.outer.price) == float(f.outer.price)
    assert float(g.surface_mean) == float(f.surface_mean)


def test_keys_are_the_family_streams():
    sim = mt.SimParams(n_paths=128, n_steps=4, n_paths_inner=4, seed=8)
    a = price_nmc_term(sim=sim, strategy="fused", device="cpu")
    b = price_nmc_term(sim=sim, strategy="fused", stream_outer=1,
                       stream_inner=0, device="cpu")
    assert not torch.equal(a.surface, b.surface)
    pt = tt.price_term(mt.OptionParams(), tt.demo_term(4), sim,
                       key=rng.derive_key(8, 0, tt.TERM_TAG), device="cpu")
    assert float(a.outer.price) == pytest.approx(float(pt.price), rel=1e-12)


# --- the cases of tests/test_nmc_term.py -------------------------------------


def _dyn(n):
    return tt.TermStructure.from_knots([0.10, 0.07, 0.05], [0.15, 0.22, 0.30],
                                       n)


def test_ee_flat_at_term_price():
    """e^{-r_bar T} discounting makes the conditional call value a
    martingale: EE flat at the time-0 term price."""
    sim = mt.SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    opt = mt.OptionParams()
    res = price_nmc_term(opt, _dyn(8), sim, device="cpu")
    ref = tt.price_term(opt, _dyn(8), mt.SimParams(n_paths=400_000,
                                                   n_steps=8), device="cpu")
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(ee.numpy(), float(ref.price), rtol=0.04)
    assert bool((pfe >= ee - 1e-5).all())
    assert float(res.surface_mean) == pytest.approx(float(ref.price),
                                                    rel=0.03)


def test_flat_curves_match_gbm_nmc_stats():
    dyn = tt.TermStructure.from_knots([0.1, 0.1], [0.2, 0.2], 8)
    sim = mt.SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_term(mt.OptionParams(), dyn, sim, device="cpu")
    want = mt.oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2)
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_validation():
    opt = mt.OptionParams()
    with pytest.raises(ValueError, match="term structure has"):
        price_nmc_term(opt, _dyn(4), mt.SimParams(n_paths=256, n_steps=8,
                                                  n_paths_inner=4),
                       device="cpu")
    with pytest.raises(ValueError, match="even n_steps"):
        price_nmc_term(opt, _dyn(5), mt.SimParams(n_paths=256, n_steps=5,
                                                  n_paths_inner=4),
                       device="cpu")
