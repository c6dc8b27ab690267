"""mc_tpu_torch's nested MC on a correlated basket (the family engine, fused
and grid, the grid's d asset grids from the generic trajectories kernel)
against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here; mc_tpu runs its
engine="xla" dual, bitwise equal to its grid and fused Pallas kernels (its
grid strategy builds the d asset grids with its XLA scan).  Both draw the
same outer (pairs j*ceil(d/2) + q at step j) and inner (pairs c_base +
u*ceil(d/2) + q, c_base = ((j+1)*n_inner + m)*n_steps*ceil(d/2)) threefry-13
streams and Kahan-sum the inner legs in the same order.

Tolerances (parity contract): the smooth payoffs' surfaces to rtol = atol =
1e-5 on at least 99.9% of points and their mean and the outer price to 1e-5
relative; the bullet's surface within 1e-4 on 99.9% of points and its outer
price and surface mean within 0.05 outer stderr; the outer grids on the
same key to 2e-6 relative; one inner leg on the same inputs to 2e-6
relative plus 16 ulp of the largest value.  Inside the port, grid == fused
bitwise, and the outer price is price_basket's on the outer key to f64
rounding.  The statistical cases of tests/test_nmc_basket.py run at its
sizes and tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import basket as jb
from mc_tpu.nmc_basket import BasketNMC as JBasketNMC
from mc_tpu.nmc_basket import price_nmc_basket as jprice
from mc_tpu.nmc_engine import xla_family_trajectories
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import basket as tb
from mc_tpu_torch.nmc_basket import BasketNMC, price_nmc_basket
from mc_tpu_torch.nmc_engine import (NMC_FAMILIES, NMC_FAMILY_BUILDERS,
                                     FamilyConfig, ensure_family,
                                     family_inner, family_trajectories,
                                     price_nmc_family)
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
OPT = convert.option_params(J_OPT)
FLIP_SE, FLIP_TOL, SMOOTH_TOL, SURF_FRAC = 0.05, 1e-4, 1e-5, 0.999
EPS32 = 2.0 ** -24
# Uneven spots and vols, signed weights, a random correlation, d = 3 (odd:
# the last pair's second normal is dropped).
J_B3 = jb.BasketDynamics(
    s0s=np.array([100.0, 90.0, 110.0], np.float32),
    sigmas=np.array([0.2, 0.35, 0.15], np.float32),
    weights=np.array([0.6, 0.3, 0.4], np.float32),
    corr=np.array([[1.0, 0.3, -0.2], [0.3, 1.0, 0.5], [-0.2, 0.5, 1.0]],
                  np.float32))
B3 = convert.basket_dynamics(J_B3)


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


@pytest.mark.parametrize("basket", ["demo", "d3"])
@pytest.mark.parametrize("n_paths,n_steps", [(512, 8), (300, 7)])
@pytest.mark.parametrize("strategy", ["fused", "grid"])
@pytest.mark.parametrize("payoff", ["vanilla_call", "bullet_call",
                                    "asian_call"])
def test_matches_mc_tpu(payoff, strategy, n_paths, n_steps, basket):
    """300 x 7: a partial tile and an odd step count (one step a block)."""
    jdyn, dyn = ((jb.DEMO_BASKET, tb.DEMO_BASKET) if basket == "demo"
                 else (J_B3, B3))
    jsim = mc_tpu.SimParams(n_paths=n_paths, n_steps=n_steps,
                            n_paths_inner=8)
    got = price_nmc_basket(OPT, dyn, convert.sim_params(jsim), payoff,
                           strategy=strategy, device="cpu")
    want = jprice(J_OPT, jdyn, jsim, payoff, engine="xla")
    _assert_matches(got, want, jsim.n_paths, payoff)


@pytest.mark.parametrize("name", ["vanilla_call", "asian_call",
                                  "bullet_call"])
def test_family_trajectories_match_mc_tpu_scan(name):
    """The generic trajectories of the d asset grids (the plain version
    here) against mc_tpu's XLA outer scan: every asset to 2e-6, the Asian's
    sum to 2e-6, a count equal on >= 99.9% of paths; the payoff sums are
    price_basket's."""
    n_paths, n_steps = 1500, 12
    key = rng.derive_key(3, 0, tb.BASKET_TAG)
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    jfam = JBasketNMC(extras=(3,))
    jparams = jfam.pack(J_OPT.as_f32(), J_B3.as_f32(), n_steps)
    *jgrids, jst, jsum, jsq = xla_family_trajectories(
        jfam, jget_payoff(name), jcfg, jparams, np.asarray(key, np.uint32))
    cfg = FamilyConfig(n_paths=n_paths, n_steps=n_steps, n_inner=1)
    prm = tb.pack_basket(OPT, B3, n_steps, "cpu")
    *grids, st, partials = family_trajectories(BasketNMC(extras=(3,)),
                                               get_payoff(name), cfg, key, prm)
    assert len(grids) == 3
    for got, want in zip(grids, jgrids):
        want = convert.surface_matrix(want, n_paths)
        np.testing.assert_allclose(got.T.numpy(), want, rtol=2e-6)
    want_st = convert.surface_matrix(jst, n_paths)
    if name == "bullet_call":
        assert (st.T.numpy() == want_st).all(axis=1).mean() >= 0.999
    else:
        np.testing.assert_allclose(st.T.numpy(), want_st, rtol=2e-6)
    sums = finish_sum(partials).numpy()
    want = np.array([float(jfinish_sum(jsum)), float(jfinish_sum(jsq))])
    if name != "bullet_call":
        np.testing.assert_allclose(sums, want, rtol=1e-5)
    own = finish_sum(tb.basket_partials(
        get_payoff(name), tb.BasketConfig(n_paths=n_paths, n_steps=n_steps,
                                          d=3), key, prm))
    np.testing.assert_allclose(sums, own.numpy(), rtol=1e-12)


def test_leg_matches_mc_tpu():
    """Three inner substeps from the same asset prices and Asian sum
    through mc_tpu's BasketNMC.leg and the port's, on the same counters."""
    rs = np.random.default_rng(31)
    n = 2048
    g = [rs.uniform(60.0, 180.0, n).astype(np.float32) for _ in range(3)]
    acc = rs.uniform(0.0, 500.0, n).astype(np.float32)
    ids = np.arange(n, dtype=np.uint32) + 7
    jfam = JBasketNMC(extras=(3,))
    jparams = jfam.pack(J_OPT.as_f32(), J_B3.as_f32(), 8)
    want = jfam.leg(jget_payoff("asian_call"), jfam.unpack(jparams), None,
                    jnp.uint32(11), jnp.uint32(12), jnp.asarray(ids),
                    jnp.uint32(96), 4, 3, tuple(map(jnp.asarray, g)),
                    (jnp.asarray(acc),), jax.lax.bitcast_convert_type, 8)
    fam = BasketNMC(extras=(3,))
    p = fam.unpack(convert.basket_params(np.asarray(jparams), 3))
    got = fam.leg(get_payoff("asian_call"), p, 11, 12,
                  torch.from_numpy(ids.astype(np.int64))[None],
                  torch.tensor([[96]]), 3,
                  tuple(torch.from_numpy(a)[None] for a in g),
                  (torch.from_numpy(acc)[None],))[0]
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6,
                               atol=16 * EPS32 * np.abs(want).max())


@pytest.fixture(scope="module")
def both():
    sim = mt.SimParams(n_paths=512, n_steps=7, n_paths_inner=8, seed=3)
    return sim, {s: price_nmc_basket(OPT, B3, sim, strategy=s, device="cpu")
                 for s in ("fused", "grid")}


def test_grid_equals_fused_bitwise(both):
    _, res = both
    assert torch.equal(res["grid"].surface, res["fused"].surface)
    assert float(res["grid"].outer.price) == float(res["fused"].outer.price)
    assert float(res["grid"].outer.stderr) == float(res["fused"].outer.stderr)
    assert res["fused"].spot_surface is None
    assert res["grid"].spot_matrix().shape == (512, 7)


def test_outer_is_price_basket_on_the_outer_key(both):
    sim, res = both
    pb = tb.price_basket(OPT, B3, sim, device="cpu")
    for r in res.values():
        assert float(r.outer.price) == pytest.approx(float(pb.price),
                                                     rel=1e-12)
        assert float(r.outer.stderr) == pytest.approx(float(pb.stderr),
                                                      rel=1e-12)


def test_last_row_pays_on_the_recomputed_level(both):
    """No substep remains at the last row: each point is e^{-rT} times the
    payoff of the level sum_i w_i s0_i exp(log(S_i / s0_i)) recomputed from
    the d asset grids."""
    _, res = both
    cfg = FamilyConfig(n_paths=512, n_steps=7, n_inner=8)
    prm = tb.pack_basket(OPT, B3, 7, "cpu")
    *grids, _, _ = BasketNMC(extras=(3,)).trajectories(
        get_payoff("vanilla_call"), cfg, rng.derive_key(3, 0, tb.BASKET_TAG),
        prm)
    p = tb.unpack_basket(prm, 3)
    ws = torch.stack([torch.log(g[-1] / p.s0s[i])
                      for i, g in enumerate(grids)])
    level = tb.basket_of(p, tb.levels(p, ws))
    want = torch.exp(-p.r * p.t) * torch.clamp(level - p.k, min=0.0)
    assert torch.equal(res["grid"].surface[-1], want)
    assert torch.equal(res["grid"].spot_surface, grids[0])


def test_guards():
    with pytest.raises(ValueError, match="counter"):
        price_nmc_basket(sim=mt.SimParams(n_paths=256, n_steps=4096,
                                          n_paths_inner=256), device="cpu")
    with pytest.raises(ValueError, match="4 market grids"):
        cfg = FamilyConfig(n_paths=8, n_steps=4, n_inner=2)
        z = torch.zeros(4, 8)
        family_inner(BasketNMC(extras=(4,)), get_payoff("vanilla_call"), cfg,
                     (1, 2), tb.pack_basket(OPT, tb.DEMO_BASKET, 4, "cpu"),
                     (z, z, z), z)
    with pytest.raises(ValueError, match="params"):
        family_trajectories(BasketNMC(extras=(3,)), get_payoff("vanilla_call"),
                            FamilyConfig(n_paths=8, n_steps=4, n_inner=2),
                            (1, 2), tb.pack_basket(OPT, tb.DEMO_BASKET, 4,
                                                   "cpu"))
    with pytest.raises(ValueError, match="MAX_BASKET_D"):
        d = 33
        price_nmc_basket(basket=tb.BasketDynamics(
            np.full(d, 100.0), np.full(d, 0.2), np.full(d, 1.0 / d),
            np.eye(d)), sim=mt.SimParams(n_paths=8, n_steps=2,
                                          n_paths_inner=2), device="cpu")


def test_registry_and_builder():
    """tests/test_nmc_family_fused.py's basket case: the builder's family
    carries d, fused == grid bitwise."""
    ensure_family("basket")
    assert NMC_FAMILIES["basket"] is price_nmc_basket
    sim = mt.SimParams(n_paths=512, n_steps=4, n_paths_inner=8)
    fam, dyn = NMC_FAMILY_BUILDERS["basket"](mt.OptionParams(), B3, sim)
    assert isinstance(fam, BasketNMC) and fam.extras == (3,)
    assert fam.n_grids == 3 and fam.counter_stride(4) == 8
    fam4, _ = NMC_FAMILY_BUILDERS["basket"](mt.OptionParams(), None, sim)
    assert fam4.extras == (4,)
    g, f = (price_nmc_family(fam, mt.OptionParams(), dyn, sim, "vanilla_call",
                             strategy=s, device="cpu")
            for s in ("grid", "fused"))
    assert torch.equal(g.surface, f.surface)
    assert float(g.outer.price) == float(f.outer.price)


def test_keys_are_the_family_streams():
    sim = mt.SimParams(n_paths=128, n_steps=4, n_paths_inner=4, seed=8)
    a = price_nmc_basket(sim=sim, strategy="fused", device="cpu")
    b = price_nmc_basket(sim=sim, strategy="fused", stream_outer=1,
                         stream_inner=0, device="cpu")
    assert not torch.equal(a.surface, b.surface)
    pb = tb.price_basket(sim=sim, key=rng.derive_key(8, 0, tb.BASKET_TAG),
                         device="cpu")
    assert float(a.outer.price) == pytest.approx(float(pb.price), rel=1e-12)


# --- the cases of tests/test_nmc_basket.py -----------------------------------

CASE_SIM = mt.SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)


def test_ee_flat_at_basket_call_price():
    """The fully discounted conditional basket-call value is a martingale:
    EE flat at the time-0 basket price."""
    res = price_nmc_basket(sim=CASE_SIM, strategy="fused", device="cpu")
    ref = tb.price_basket(sim=mt.SimParams(n_paths=400_000, n_steps=8),
                          device="cpu")
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(ee.numpy(), float(ref.price), rtol=0.04)
    assert bool((pfe >= ee - 1e-5).all())


def test_margrabe_exposure_flat_at_closed_form():
    """Weights (1, -1) and k = 0 make vanilla_call the exchange option: EE
    flat at Margrabe's (1978) closed form at every step."""
    dyn = tb.BasketDynamics(
        s0s=np.array([100.0, 95.0], np.float32),
        sigmas=np.array([0.25, 0.2], np.float32),
        weights=np.array([1.0, -1.0], np.float32),
        corr=np.array([[1.0, 0.4], [0.4, 1.0]], np.float32))
    res = price_nmc_basket(mt.OptionParams(k=0.0), dyn, CASE_SIM,
                           strategy="fused", device="cpu")
    want = mt.margrabe(100.0, 95.0, 1.0, 0.25, 0.2, 0.4)
    ee, _ = res.exposure_profile()
    np.testing.assert_allclose(ee.numpy(), want, rtol=0.04)
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_d1_degenerates_to_gbm():
    """A one-asset basket is GBM in law (its stream is one pair a step, not
    the GBM kernels' layout): the surface mean near Black-Scholes."""
    dyn = tb.BasketDynamics(np.array([100.0], np.float32),
                            np.array([0.2], np.float32),
                            np.array([1.0], np.float32),
                            np.eye(1, dtype=np.float32))
    res = price_nmc_basket(mt.OptionParams(), dyn, CASE_SIM, strategy="fused",
                           device="cpu")
    want = mt.oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2)
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_path_dependent_state_resumes():
    sim = mt.SimParams(n_paths=4096, n_steps=8, n_paths_inner=16)
    res = price_nmc_basket(mt.OptionParams(p1=1.0, p2=6.0), sim=sim,
                           payoff="bullet_call", device="cpu")
    assert bool(torch.isfinite(res.surface_matrix()).all())
    assert float(res.outer.stderr) > 0


def test_correlation_moves_exposure_tail():
    """More correlation, a wider conditional basket: the last step's PFE
    rises with rho (EE pinned by the martingale)."""
    def pfe_last(rho):
        corr = np.full((3, 3), rho, np.float32)
        np.fill_diagonal(corr, 1.0)
        dyn = tb.BasketDynamics(np.full(3, 100.0, np.float32),
                                np.full(3, 0.2, np.float32),
                                np.full(3, 1 / 3, np.float32), corr)
        r = price_nmc_basket(mt.OptionParams(), dyn,
                             mt.SimParams(n_paths=4096, n_steps=8,
                                          n_paths_inner=16),
                             strategy="fused", device="cpu")
        return float(r.exposure_profile()[1][-1])
    assert pfe_last(0.8) > pfe_last(0.0)
