"""mc_tpu_torch's nested MC under Merton jumps (the family engine, fused and
grid) against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here; mc_tpu runs its
engine="xla" dual, bitwise equal to its grid and fused Pallas kernels.  Both
draw the same outer (draw3 per step pair) and inner ((z, e) pair and
Poisson uniform per substep) threefry-13 streams and Kahan-sum the inner
legs in the same order.

Tolerances (parity contract): the smooth payoffs' surfaces to rtol = atol =
1e-5 on at least 99.9% of points (a few points sit where an inner S_T lands
within an ulp of K, or a Poisson uniform within an ulp of a cdf step) and
their mean and the outer price to 1e-5 relative; the bullet's surface within
1e-4 on 99.9% of points and its outer price and surface mean within 0.05
outer stderr.  Inside the port, grid == fused bitwise, and the outer price
is price_merton's Euler price on the outer key to f64 rounding.
"""

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models.merton import DEMO_MERTON as J_DEMO
from mc_tpu.nmc_merton import price_nmc_merton as jprice

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import merton as tm
from mc_tpu_torch.nmc_engine import (NMC_FAMILIES, NMC_FAMILY_BUILDERS,
                                     FamilyConfig, ensure_family,
                                     family_fused, family_inner,
                                     price_nmc_family)
from mc_tpu_torch.nmc_merton import MertonNMC, price_nmc_merton
from mc_tpu_torch.ops.payoffs import get_payoff

torch.set_num_threads(1)

J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
OPT = convert.option_params(J_OPT)
FLIP_SE, FLIP_TOL, SMOOTH_TOL, SURF_FRAC = 0.05, 1e-4, 1e-5, 0.999
# tests/test_nmc_merton.py's configuration.
ST_SIM = mt.SimParams(n_paths=4096, n_steps=10, n_paths_inner=64)
JUMPY = tm.MertonDynamics(lam=1.0, mu_j=0.05, sigma_j=0.25)


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


@pytest.mark.parametrize("strategy", ["fused", "grid"])
@pytest.mark.parametrize("payoff", ["vanilla_call", "bullet_call",
                                    "asian_call"])
def test_matches_mc_tpu(payoff, strategy):
    jsim = mc_tpu.SimParams(n_paths=512, n_steps=8, n_paths_inner=8)
    got = price_nmc_merton(OPT, tm.DEMO_MERTON, convert.sim_params(jsim),
                           payoff, strategy=strategy, device="cpu")
    want = jprice(J_OPT, J_DEMO, jsim, payoff, engine="xla")
    _assert_matches(got, want, jsim.n_paths, payoff)


@pytest.fixture(scope="module")
def both():
    sim = mt.SimParams(n_paths=512, n_steps=8, n_paths_inner=8, seed=3)
    return sim, {s: price_nmc_merton(OPT, JUMPY, sim, strategy=s,
                                     device="cpu")
                 for s in ("fused", "grid")}


def test_grid_equals_fused_bitwise(both):
    _, res = both
    assert torch.equal(res["grid"].surface, res["fused"].surface)
    assert float(res["grid"].outer.price) == float(res["fused"].outer.price)
    assert float(res["grid"].outer.stderr) == float(res["fused"].outer.stderr)
    assert res["fused"].spot_surface is None
    assert res["grid"].spot_matrix().shape == (512, 8)


def test_outer_is_price_merton_on_the_outer_key(both):
    sim, res = both
    pm = tm.price_merton(OPT, JUMPY, sim, device="cpu")
    for r in res.values():
        assert float(r.outer.price) == pytest.approx(float(pm.price),
                                                     rel=1e-12)
        assert float(r.outer.stderr) == pytest.approx(float(pm.stderr),
                                                      rel=1e-12)


def test_grid_is_price_merton_s_trajectories(both):
    """The spot grid is merton_trajectories' on the outer key."""
    sim, res = both
    cfg = tm.MertonConfig(n_paths=512, n_steps=8,
                          kmax=tm.poisson_kmax(JUMPY.lam / 8))
    key = rng.derive_key(3, 0, tm.MERTON_TAG)
    s, _, _ = tm.merton_trajectories(
        get_payoff("vanilla_call"), cfg, key,
        tm.pack_merton(OPT, JUMPY.as_f32(), 8, "cpu"))
    assert torch.equal(res["grid"].spot_surface, s)


def test_last_step_is_the_discounted_terminal_payoff(both):
    _, res = both
    g = res["grid"]
    p = tm.unpack_merton(tm.pack_merton(OPT, JUMPY, 8, "cpu"))
    want = torch.exp(-p.r * p.t) * torch.clamp(g.spot_surface[-1] - p.k,
                                               min=0.0)
    assert torch.equal(g.surface[-1], want)


def test_tower_property():
    """tests/test_nmc_merton.py: the surface mean within 5% of the series
    price, the outer estimate within 4 of its stderrs."""
    res = price_nmc_merton(sim=ST_SIM, strategy="fused", device="cpu")
    ref = tm.merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2, lam=0.3,
                                     mu_j=-0.10, sigma_j=0.15)
    assert float(res.surface_mean) == pytest.approx(ref, rel=0.05)
    assert abs(float(res.outer.price) - ref) <= 4.0 * float(res.outer.stderr)


@pytest.fixture(scope="module")
def jumps_and_none():
    return (price_nmc_merton(sim=ST_SIM, dyn=tm.MertonDynamics(lam=0.0),
                             device="cpu"),
            price_nmc_merton(sim=ST_SIM, dyn=JUMPY, device="cpu"))


def test_jumps_fatten_the_exposure_tail(jumps_and_none):
    nj, wj = jumps_and_none

    def pfe(res):
        ee = torch.clamp(res.surface, min=0.0).double()
        return float(torch.quantile(ee, 0.975, dim=1).mean())

    assert pfe(wj) > pfe(nj)


def test_cva_under_jumps_exceeds_no_jump(jumps_and_none):
    nj, wj = jumps_and_none
    assert float(wj.cva(0.02, 0.4)) > float(nj.cva(0.02, 0.4)) > 0.0


def test_guards():
    with pytest.raises(ValueError, match="even n_steps"):
        price_nmc_merton(sim=mt.SimParams(n_paths=64, n_steps=9,
                                          n_paths_inner=8), device="cpu")
    with pytest.raises(ValueError, match="counter space"):
        price_nmc_merton(sim=mt.SimParams(n_paths=64, n_steps=40_000,
                                          n_paths_inner=4000), device="cpu")
    with pytest.raises(ValueError, match="at most one state array"):
        price_nmc_merton(sim=mt.SimParams(n_paths=8, n_steps=4,
                                          n_paths_inner=2),
                         payoff="variance_swap", device="cpu")
    fam = MertonNMC(extras=(4,))
    cfg = FamilyConfig(n_paths=8, n_steps=4, n_inner=2)
    prm = tm.pack_merton(OPT, tm.DEMO_MERTON, 4, "cpu")
    grid = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="market grids"):
        family_inner(fam, get_payoff("vanilla_call"), cfg, (1, 2), prm,
                     (grid, grid), grid)
    with pytest.raises(ValueError, match="params"):
        family_fused(fam, get_payoff("vanilla_call"), cfg, (1, 2), (3, 4),
                     torch.zeros(17))


def test_registry_and_builder():
    ensure_family("merton")
    assert NMC_FAMILIES["merton"] is price_nmc_merton
    sim = mt.SimParams(n_paths=64, n_steps=10, n_paths_inner=4)
    fam, dyn = NMC_FAMILY_BUILDERS["merton"](OPT, JUMPY, sim)
    assert isinstance(fam, MertonNMC) and dyn == JUMPY.as_f32()
    assert fam.extras == (tm.poisson_kmax(JUMPY.lam / 10),)
    a = price_nmc_family(fam, OPT, dyn, sim, "vanilla_call",
                         strategy="fused", device="cpu")
    b = price_nmc_merton(OPT, JUMPY, sim, strategy="fused", device="cpu")
    assert torch.equal(a.surface, b.surface)


def test_keys_are_the_family_streams():
    sim = mt.SimParams(n_paths=128, n_steps=4, n_paths_inner=4, seed=8)
    a = price_nmc_merton(sim=sim, strategy="fused", device="cpu")
    b = price_nmc_merton(sim=sim, strategy="fused", stream_outer=1,
                         stream_inner=0, device="cpu")
    assert not torch.equal(a.surface, b.surface)
    pm = tm.price_merton(sim=sim, key=rng.derive_key(8, 0, tm.MERTON_TAG),
                         device="cpu")
    assert float(a.outer.price) == pytest.approx(float(pm.price), rel=1e-12)


def test_convert_merton_dynamics():
    from mc_tpu.models.merton import MertonDynamics
    jd = MertonDynamics(lam=0.7, mu_j=-0.2, sigma_j=0.3)
    assert convert.merton_dynamics(jd) == tm.MertonDynamics(0.7, -0.2, 0.3)
    assert convert.merton_dynamics(dict(lam=0.1, mu_j=0.0,
                                        sigma_j=0.2)).lam == 0.1
    with pytest.raises(ValueError, match="19"):
        convert.merton_params(np.zeros(17, np.float32))
