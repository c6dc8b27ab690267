"""mc_tpu_torch's nested MC under Vasicek rates (the family engine, fused and
grid, the grid's (S, x, y) outer grids from the Vasicek trajectories
kernel) against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here; mc_tpu runs its
engine="xla" dual, bitwise equal to its grid and fused Pallas kernels.  Both
draw the same outer (the pairs 3m, 3m+1, 3m+2 per step pair) and inner
(pairs 2(c_base + u) and 2(c_base + u) + 1 per substep, c_base = ((j+1)*
n_inner + m)*n_steps) threefry-13 streams, discount every point by its own
exp(-y_j) and every inner leg by its own exp(-y), and Kahan-sum the inner
legs in the same order.

Tolerances (parity contract): the smooth payoffs' surfaces to rtol = atol =
1e-5 on at least 99.9% of points and their mean and the outer price to 1e-5
relative; the bullet's surface within 1e-4 on 99.9% of points and its outer
price and surface mean within 0.05 outer stderr; one inner leg on the same
inputs to 2e-6 relative plus 16 ulp of the largest value.  Inside the port,
grid == fused bitwise, and the outer price is price_vasicek's on the outer
key to f64 rounding.  The statistical cases of tests/test_nmc_vasicek.py run
at its sizes and tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import vasicek as jv
from mc_tpu.nmc_vasicek import VasicekNMC as JVasicekNMC
from mc_tpu.nmc_vasicek import price_nmc_vasicek as jprice
from mc_tpu.ops.payoffs import get_payoff as jget_payoff

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import vasicek as tv
from mc_tpu_torch.nmc_engine import (NMC_FAMILIES, NMC_FAMILY_BUILDERS,
                                     FamilyConfig, ensure_family,
                                     family_inner, price_nmc_family)
from mc_tpu_torch.nmc_vasicek import VasicekNMC, price_nmc_vasicek
from mc_tpu_torch.ops.payoffs import get_payoff

torch.set_num_threads(1)

J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
OPT = convert.option_params(J_OPT)
FLIP_SE, FLIP_TOL, SMOOTH_TOL, SURF_FRAC = 0.05, 1e-4, 1e-5, 0.999
EPS32 = 2.0 ** -24
J_FAST = jv.VasicekDynamics(a=1.0, b=0.03, sigma_r=0.05, rho=0.5)
FAST = convert.vasicek_dynamics(J_FAST)


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


@pytest.mark.parametrize("n_paths,n_steps", [(512, 8), (300, 6)])
@pytest.mark.parametrize("strategy", ["fused", "grid"])
@pytest.mark.parametrize("payoff", ["vanilla_call", "bullet_call",
                                    "asian_call", "zcb"])
def test_matches_mc_tpu(payoff, strategy, n_paths, n_steps):
    """300 x 6: a partial tile and a step count that is no multiple of 4."""
    jsim = mc_tpu.SimParams(n_paths=n_paths, n_steps=n_steps,
                            n_paths_inner=8)
    got = price_nmc_vasicek(OPT, FAST, convert.sim_params(jsim), payoff,
                            strategy=strategy, device="cpu")
    want = jprice(J_OPT, J_FAST, jsim, payoff, engine="xla")
    _assert_matches(got, want, jsim.n_paths, payoff)


def test_leg_matches_mc_tpu():
    """Three inner substeps from the same (S_t, x_t, Asian sum) through
    mc_tpu's VasicekNMC.leg and the port's, on the same counters: the
    discounted payoff."""
    rs = np.random.default_rng(31)
    n = 2048
    s_t = rs.uniform(60.0, 180.0, n).astype(np.float32)
    x_t = rs.uniform(-0.1, 0.1, n).astype(np.float32)
    y_t = rs.uniform(0.0, 0.2, n).astype(np.float32)
    acc = rs.uniform(0.0, 500.0, n).astype(np.float32)
    ids = np.arange(n, dtype=np.uint32) + 7
    jparams = jv._pack_vasicek(J_OPT.as_f32(), J_FAST.as_f32(), 8)
    jp = jv._unpack_vasicek(jparams)
    want = JVasicekNMC().leg(jget_payoff("asian_call"), jp, None,
                             jnp.uint32(11), jnp.uint32(12), jnp.asarray(ids),
                             jnp.uint32(96), 4, 3,
                             tuple(map(jnp.asarray, (s_t, x_t, y_t))),
                             (jnp.asarray(acc),),
                             jax.lax.bitcast_convert_type, 8)
    p = tv.unpack_vasicek(convert.vasicek_params(np.asarray(jparams)))
    got = VasicekNMC().leg(get_payoff("asian_call"), p, 11, 12,
                           torch.from_numpy(ids.astype(np.int64))[None],
                           torch.tensor([[96]]), 3,
                           tuple(torch.from_numpy(a)[None]
                                 for a in (s_t, x_t, y_t)),
                           (torch.from_numpy(acc)[None],))[0]
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6,
                               atol=16 * EPS32 * np.abs(want).max())


@pytest.fixture(scope="module")
def both():
    sim = mt.SimParams(n_paths=512, n_steps=8, n_paths_inner=8, seed=3)
    return sim, {s: price_nmc_vasicek(OPT, FAST, sim, strategy=s,
                                      device="cpu")
                 for s in ("fused", "grid")}


def test_grid_equals_fused_bitwise(both):
    _, res = both
    assert torch.equal(res["grid"].surface, res["fused"].surface)
    assert float(res["grid"].outer.price) == float(res["fused"].outer.price)
    assert float(res["grid"].outer.stderr) == float(res["fused"].outer.stderr)
    assert res["fused"].spot_surface is None
    assert res["grid"].spot_matrix().shape == (512, 8)


def test_outer_is_price_vasicek_on_the_outer_key(both):
    sim, res = both
    pv = tv.price_vasicek(OPT, FAST, sim, device="cpu")
    for r in res.values():
        assert float(r.outer.price) == pytest.approx(float(pv.price),
                                                     rel=1e-12)
        assert float(r.outer.stderr) == pytest.approx(float(pv.stderr),
                                                      rel=1e-12)


def test_last_row_is_the_discounted_payoff_on_the_stored_state(both):
    """No substep remains at the last row: each point is exp(-y_T) times
    the payoff of S_T exp(0), from the outer grids."""
    sim, res = both
    cfg = FamilyConfig(n_paths=512, n_steps=8, n_inner=8)
    prm = tv.pack_vasicek(OPT, FAST, 8, "cpu")
    s, x, y, st, _ = VasicekNMC().trajectories(
        get_payoff("vanilla_call"), cfg, rng.derive_key(3, 0, tv.VASICEK_TAG),
        prm)
    p = tv.unpack_vasicek(prm)
    want = torch.clamp(s[-1] * torch.exp(torch.zeros(())) - p.k, min=0.0)
    want = want * torch.exp(-y[-1])
    assert torch.equal(res["grid"].surface[-1], want)
    assert torch.equal(res["grid"].spot_surface, s)


def test_guards():
    with pytest.raises(ValueError, match="even n_steps"):
        price_nmc_vasicek(sim=mt.SimParams(n_paths=256, n_steps=3,
                                           n_paths_inner=4), device="cpu")
    # tests/test_nmc_vasicek.py's counter case: 2*(4097)*256*4096 >= 2^32
    with pytest.raises(ValueError, match="counter"):
        price_nmc_vasicek(sim=mt.SimParams(n_paths=256, n_steps=4096,
                                           n_paths_inner=256), device="cpu")
    with pytest.raises(ValueError, match="counter"):
        jprice(sim=mc_tpu.SimParams(n_paths=256, n_steps=4096,
                                    n_paths_inner=256))
    with pytest.raises(ValueError, match="3 market grids"):
        cfg = FamilyConfig(n_paths=8, n_steps=4, n_inner=2)
        z = torch.zeros(4, 8)
        family_inner(VasicekNMC(), get_payoff("vanilla_call"), cfg, (1, 2),
                     tv.pack_vasicek(OPT, FAST, 4, "cpu"), (z, z), z)
    with pytest.raises(ValueError, match="params"):
        VasicekNMC().trajectories(get_payoff("vanilla_call"),
                                  FamilyConfig(n_paths=8, n_steps=4,
                                               n_inner=2), (1, 2),
                                  torch.zeros(13))


def test_registry_and_builder():
    ensure_family("vasicek")
    assert NMC_FAMILIES["vasicek"] is price_nmc_vasicek
    sim = mt.SimParams(n_paths=512, n_steps=4, n_paths_inner=8)
    fam, dyn = NMC_FAMILY_BUILDERS["vasicek"](mt.OptionParams(), None, sim)
    assert isinstance(fam, VasicekNMC) and dyn == tv.DEMO_VASICEK.as_f32()
    g, f = (price_nmc_family(fam, mt.OptionParams(), dyn, sim, "vanilla_call",
                             strategy=s, device="cpu")
            for s in ("grid", "fused"))
    assert torch.equal(g.surface, f.surface)
    assert float(g.outer.price) == float(f.outer.price)


def test_keys_are_the_family_streams():
    sim = mt.SimParams(n_paths=128, n_steps=4, n_paths_inner=4, seed=8)
    a = price_nmc_vasicek(sim=sim, strategy="fused", device="cpu")
    b = price_nmc_vasicek(sim=sim, strategy="fused", stream_outer=1,
                          stream_inner=0, device="cpu")
    assert not torch.equal(a.surface, b.surface)
    pv = tv.price_vasicek(sim=sim, key=rng.derive_key(8, 0, tv.VASICEK_TAG),
                          device="cpu")
    assert float(a.outer.price) == pytest.approx(float(pv.price), rel=1e-12)


# --- the cases of tests/test_nmc_vasicek.py ----------------------------------

CASE_SIM = mt.SimParams(n_paths=4096, n_steps=8, n_paths_inner=16)


def test_zcb_exposure_flat_at_closed_form():
    """The bond's time-0-discounted conditional value is a martingale: EE
    flat at P(0,T) at every step."""
    res = price_nmc_vasicek(sim=CASE_SIM, payoff="zcb", device="cpu")
    want = mt.vasicek_zcb(0.1, 0.3, 0.05, 0.015, 1.0)
    ee, _ = res.exposure_profile()
    assert float((ee.double() - want).abs().max()) < 5e-4
    assert float(res.surface_mean) == pytest.approx(want, abs=5e-4)


def test_tower_property_vanilla():
    """Surface mean == outer price == Merton's (1973) closed form."""
    sim = mt.SimParams(n_paths=16_384, n_steps=8, n_paths_inner=32)
    res = price_nmc_vasicek(sim=sim, strategy="fused", device="cpu")
    want = mt.bsv_call(100.0, 100.0, 1.0, 0.1, 0.2, 0.3, 0.05, 0.015, -0.3)
    assert abs(float(res.outer.price) - want) <= 4 * float(res.outer.stderr)
    assert float(res.surface_mean) == pytest.approx(want, rel=0.05)


def test_rate_vol_fattens_exposure_tail():
    """More rate volatility widens the discounted bond's distribution."""
    def gap(sigma_r):
        r = price_nmc_vasicek(mt.OptionParams(),
                              tv.VasicekDynamics(sigma_r=sigma_r), CASE_SIM,
                              payoff="zcb", device="cpu")
        ee, pfe = r.exposure_profile()
        return float((pfe - ee).max())
    assert gap(0.05) > 4 * gap(0.002)


def test_cva_under_stochastic_discounting():
    res = price_nmc_vasicek(sim=CASE_SIM, device="cpu")
    cva = float(res.cva(0.02, 0.4))
    assert 0.0 < cva < 0.6 * 0.02 * 1.0 * 25.0
    assert float(res.t_horizon) == 1.0


def test_path_dependent_state_resumes():
    sim = mt.SimParams(n_paths=2048, n_steps=8, n_paths_inner=4)
    res = price_nmc_vasicek(mt.OptionParams(p1=1.0, p2=6.0), sim=sim,
                            payoff="bullet_call", device="cpu")
    assert float(res.outer.stderr) > 0
    assert bool(torch.isfinite(res.surface_matrix()).all())
