"""mc_tpu_torch's rainbow nested MC (the basket's family engine with an
order-statistic level) against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here; mc_tpu runs its
engine="xla" dual, which mc_tpu holds bitwise to its grid and fused Pallas
kernels.  Both draw the basket's outer and inner threefry-13 streams under
the rainbow tag (0x4A13) and fold the level by max or min in asset order.

Tolerances (parity contract, as tests/test_torch_nmc_basket.py): smooth
payoffs' surfaces to rtol = atol = 1e-5 on at least 99.9% of points, their
mean and the outer price to 1e-5 relative; the bullet's surface within 1e-4
on 99.9% of points and its prices within 0.05 outer stderr.  Inside the
port, grid == fused bitwise and, at d = 1, max == min bitwise.  The
statistical cases of tests/test_nmc_rainbow.py (its sharded case waits for
ROADMAP item 20) run at its sizes and tolerances.
"""

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import basket as jb
from mc_tpu.nmc_rainbow import price_nmc_rainbow as jprice

import mc_tpu_torch as mt
from mc_tpu_torch import convert
from mc_tpu_torch.models import basket as tb
from mc_tpu_torch.nmc_engine import (NMC_FAMILIES, NMC_FAMILY_BUILDERS,
                                     FamilyConfig, ensure_family,
                                     family_fused)
from mc_tpu_torch.nmc_rainbow import (FAMILY_RAINBOW, RAINBOW_NMC_PAYOFFS,
                                      RainbowNMC, price_nmc_rainbow)
from mc_tpu_torch.oracle import bs_call, stulz_max_call, stulz_min_put
from mc_tpu_torch.ops.payoffs import get_payoff

torch.set_num_threads(1)

J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
OPT = convert.option_params(J_OPT)
FLIP_SE, FLIP_TOL, SMOOTH_TOL, SURF_FRAC = 0.05, 1e-4, 1e-5, 0.999
SIM = mt.SimParams(n_paths=512, n_steps=8, n_paths_inner=8)
STAT_SIM = mt.SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
J_B3 = jb.BasketDynamics(
    s0s=np.array([100.0, 90.0, 110.0], np.float32),
    sigmas=np.array([0.2, 0.35, 0.15], np.float32),
    weights=np.array([0.6, 0.3, 0.4], np.float32),
    corr=np.array([[1.0, 0.3, -0.2], [0.3, 1.0, 0.5], [-0.2, 0.5, 1.0]],
                  np.float32))


def _two_asset(rho=0.4):
    return tb.BasketDynamics(
        s0s=np.array([100.0, 100.0], np.float32),
        sigmas=np.array([0.25, 0.2], np.float32),
        weights=np.array([0.5, 0.5], np.float32),
        corr=np.array([[1.0, rho], [rho, 1.0]], np.float32))


def _assert_matches(got, want, n_paths, flip):
    g = got.surface_matrix().numpy()
    w = convert.surface_matrix(want.surface, n_paths)
    assert g.shape == w.shape
    tol = FLIP_TOL if flip else SMOOTH_TOL
    assert np.isclose(g, w, rtol=tol, atol=tol).mean() >= SURF_FRAC
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
@pytest.mark.parametrize("payoff", ["call_on_max", "put_on_min",
                                    "bullet_call"])
def test_matches_mc_tpu(payoff, strategy, n_paths, n_steps, basket):
    """Both folds and a barrier on the running max; 300 x 7: a partial
    tile and an odd step count."""
    jdyn = jb.DEMO_BASKET if basket == "demo" else J_B3
    jsim = mc_tpu.SimParams(n_paths=n_paths, n_steps=n_steps,
                            n_paths_inner=8)
    got = price_nmc_rainbow(OPT, convert.basket_dynamics(jdyn),
                            convert.sim_params(jsim), payoff,
                            strategy=strategy, device="cpu")
    want = jprice(J_OPT, jdyn, jsim, payoff, engine="xla")
    _assert_matches(got, want, n_paths, payoff == "bullet_call")


@pytest.mark.parametrize("payoff", sorted(RAINBOW_NMC_PAYOFFS) + [
    "asian_call", "down_out_call"])
def test_grid_equals_fused_bitwise(payoff):
    """Every rainbow contract and two registry payoffs on the running max:
    the grid strategy (the generic trajectories of the d asset grids, then
    the inner kernel's plain version) equals the fused one bit for bit."""
    opt = mt.OptionParams(p1=1.0, p2=6.0, barrier=90.0)
    g = price_nmc_rainbow(opt, sim=SIM, payoff=payoff, strategy="grid",
                          device="cpu")
    f = price_nmc_rainbow(opt, sim=SIM, payoff=payoff, strategy="fused",
                          device="cpu")
    assert torch.equal(g.surface, f.surface)
    assert float(g.outer.price) == float(f.outer.price)
    assert float(g.outer.stderr) == float(f.outer.stderr)


def test_d1_max_equals_min_bitwise():
    """With one asset the order statistic is the asset: both folds run the
    same arithmetic on the same stream (and mc_tpu's agree)."""
    dyn = tb.demo_basket(d=1)
    a = price_nmc_rainbow(OPT, dyn, SIM, "call_on_max", device="cpu")
    b = price_nmc_rainbow(OPT, dyn, SIM, "call_on_min", device="cpu")
    assert float(a.outer.price) == float(b.outer.price)
    assert torch.equal(a.surface, b.surface)


def test_ee_flat_at_stulz_max_call():
    """The fully discounted conditional call-on-max value is a martingale:
    EE_j flat at the Stulz closed form at every step (4%)."""
    res = price_nmc_rainbow(mt.OptionParams(), _two_asset(), STAT_SIM,
                            "call_on_max", device="cpu")
    want = stulz_max_call(100.0, 100.0, 100.0, 1.0, 0.1, 0.25, 0.2, 0.4)
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(ee.double().numpy(), want, rtol=0.04)
    assert bool((pfe >= ee - 1e-5).all())
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_put_on_min_vs_stulz():
    res = price_nmc_rainbow(mt.OptionParams(), _two_asset(), STAT_SIM,
                            "put_on_min", device="cpu")
    want = stulz_min_put(100.0, 100.0, 100.0, 1.0, 0.1, 0.25, 0.2, 0.4)
    assert float(res.surface_mean) == pytest.approx(want, rel=0.05)


def test_d1_degenerates_to_bs():
    dyn = tb.BasketDynamics(s0s=np.array([100.0], np.float32),
                            sigmas=np.array([0.2], np.float32),
                            weights=np.array([1.0], np.float32),
                            corr=np.eye(1, dtype=np.float32))
    res = price_nmc_rainbow(mt.OptionParams(), dyn, STAT_SIM, "call_on_max",
                            device="cpu")
    assert float(res.surface_mean) == pytest.approx(
        bs_call(100.0, 100.0, 1.0, 0.1, 0.2), rel=0.03)


def test_correlation_orders_best_of():
    """Lower correlation raises the best-of call (more dispersion in the
    maximum)."""
    def mean(rho):
        return float(price_nmc_rainbow(mt.OptionParams(), _two_asset(rho),
                                       SIM, "call_on_max",
                                       device="cpu").surface_mean)
    assert mean(0.0) > mean(0.9)


def test_builder_and_guards():
    """The registered builder (d from the dynamics, the max fold), the
    entry points' checks of the extras against the params, the family id
    the kernels switch on."""
    ensure_family("rainbow")
    assert NMC_FAMILIES["rainbow"] is price_nmc_rainbow
    fam, dyn = NMC_FAMILY_BUILDERS["rainbow"](OPT, None, SIM)
    assert isinstance(fam, RainbowNMC) and fam.extras == (4, 0)
    assert fam.cuda_id == FAMILY_RAINBOW and fam.tag == 0x4A13
    assert fam.n_grids == 4 and dyn.d == 4
    with pytest.raises(ValueError, match="agg"):
        RainbowNMC(extras=(4, 2))
    with pytest.raises(ValueError, match="agg"):
        RainbowNMC(extras=(4,))
    prm = tb.pack_basket(OPT, tb.demo_basket(3), 8, "cpu")
    cfg = FamilyConfig(n_paths=8, n_steps=8, n_inner=2)
    with pytest.raises(ValueError, match="params"):
        family_fused(RainbowNMC(extras=(4, 0)), get_payoff("vanilla_call"),
                     cfg, (1, 2), (3, 4), prm)
    with pytest.raises(ValueError, match="MAX_BASKET_D"):
        price_nmc_rainbow(basket=tb.demo_basket(33), sim=SIM, device="cpu")
