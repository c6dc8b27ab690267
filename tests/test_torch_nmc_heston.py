"""mc_tpu_torch's nested MC under Heston (the family engine, fused and grid)
against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here; mc_tpu runs its
engine="xla" dual, bitwise equal to its grid and fused Pallas kernels.  Both
draw the same outer and inner threefry-13 streams and Kahan-sum the inner
legs in the same order.

Tolerances (parity contract): the smooth payoffs' surfaces to rtol = atol =
1e-5 on at least 99.9% of points (a few points sit where an inner S_T lands
within an ulp of K) and their mean to 1e-5 relative, the outer price to 1e-5
relative; the bullet's surface within 1e-4 on 99.9% of points (a barrier
count flips where an S lands within an ulp of B) and its outer price and
surface mean within 0.05 outer stderr.  Inside the port, grid == fused
bitwise, and the outer price is price_heston's on the outer key to f64
rounding.
"""

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models.heston import DEMO_HESTON as J_DEMO
from mc_tpu.nmc_heston import price_nmc_heston as jprice

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import heston as th
from mc_tpu_torch.nmc_engine import (FamilyConfig, NMC_FAMILIES,
                                     ensure_family, family_fused,
                                     family_inner, family_trajectories_plain,
                                     price_nmc_family)
from mc_tpu_torch.nmc_heston import HestonNMC, price_nmc_heston
from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff

torch.set_num_threads(1)

J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
OPT = convert.option_params(J_OPT)
FLIP_SE, FLIP_TOL, SMOOTH_TOL, SURF_FRAC = 0.05, 1e-4, 1e-5, 0.999


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
@pytest.mark.parametrize("payoff,n_steps", [
    ("vanilla_call", 8), ("vanilla_call", 7),  # odd: remaining = 0 rows
    ("bullet_call", 8), ("asian_call", 7)])
def test_matches_mc_tpu(payoff, n_steps, strategy):
    jsim = mc_tpu.SimParams(n_paths=512, n_steps=n_steps, n_paths_inner=8)
    got = price_nmc_heston(OPT, th.DEMO_HESTON, convert.sim_params(jsim),
                           payoff, strategy=strategy, device="cpu")
    want = jprice(J_OPT, J_DEMO, jsim, payoff, engine="xla")
    _assert_matches(got, want, jsim.n_paths, payoff)


@pytest.fixture(scope="module")
def both():
    sim = mt.SimParams(n_paths=512, n_steps=7, n_paths_inner=8, seed=3)
    return sim, {s: price_nmc_heston(OPT, sim=sim, strategy=s, device="cpu")
                 for s in ("fused", "grid")}


def test_grid_equals_fused_bitwise(both):
    _, res = both
    assert torch.equal(res["grid"].surface, res["fused"].surface)
    assert float(res["grid"].outer.price) == float(res["fused"].outer.price)
    assert float(res["grid"].outer.stderr) == float(res["fused"].outer.stderr)
    assert float(res["grid"].surface_mean) == float(res["fused"].surface_mean)
    assert res["fused"].spot_surface is None
    assert res["grid"].spot_matrix().shape == (512, 7)


def test_outer_is_price_heston_on_the_outer_key(both):
    sim, res = both
    ph = mt.price_heston(OPT, sim=sim, device="cpu")
    for r in res.values():
        assert float(r.outer.price) == pytest.approx(float(ph.price),
                                                     rel=1e-12)
        assert float(r.outer.stderr) == pytest.approx(float(ph.stderr),
                                                      rel=1e-12)


def test_last_step_is_the_discounted_terminal_payoff(both):
    """remaining = 0 at the last step: every inner leg IS the stored state,
    so the point is e^{-rT} * payoff(S_T) of the grid's outer path."""
    _, res = both
    g = res["grid"]
    p = th.unpack_heston(th.pack_heston(OPT, th.DEMO_HESTON, 7, "cpu"))
    want = torch.exp(-p.r * p.t) * torch.clamp(g.spot_surface[-1] - p.k,
                                               min=0.0)
    assert torch.equal(g.surface[-1], want)


def test_tower_property_against_cf():
    """tests/test_nmc.py:136-151: with the full e^{-rT} discount the mean
    surface value at every step, and the outer estimate, are unbiased for
    the European Heston price; Euler bias at 8 steps + noise."""
    sim = mt.SimParams(n_paths=16384, n_steps=8, n_paths_inner=32)
    r = price_nmc_heston(sim=sim, strategy="fused", device="cpu")
    cf = th.heston_call_cf(100.0, 100.0, 1.0, 0.1, *th.DEMO_HESTON.astuple())
    assert abs(float(r.surface_mean) - cf) < 0.02 * cf + 4 * 0.15
    assert abs(float(r.outer.price) - cf) <= (4.0 * float(r.outer.stderr)
                                              + 0.02 * cf)


def test_exposure_profile():
    sim = mt.SimParams(n_paths=4096, n_steps=8, n_paths_inner=16)
    r = price_nmc_heston(sim=sim, device="cpu")
    ee, pfe = r.exposure_profile()
    assert bool((ee > 0).all()) and bool(torch.isfinite(ee).all())
    assert bool((pfe >= ee - 1e-5).all())
    assert float(r.cva(0.02)) > 0.0
    # spot-linked WWR reads grid 0, the spot (strategy="grid")
    assert float(r.cva_wwr_spot(0.02, 2.0)) > float(r.cva(0.02))


def test_guards():
    with pytest.raises(ValueError, match="counter"):
        price_nmc_heston(sim=mt.SimParams(n_paths=64, n_steps=4096,
                                          n_paths_inner=1024), device="cpu")
    with pytest.raises(ValueError, match="at most one state array"):
        price_nmc_heston(sim=mt.SimParams(n_paths=8, n_steps=4,
                                          n_paths_inner=2),
                         payoff="cliquet", device="cpu")
    with pytest.raises(ValueError, match="strategy"):
        price_nmc_heston(sim=mt.SimParams(n_paths=8, n_steps=4,
                                          n_paths_inner=2),
                         strategy="vmem", device="cpu")
    with pytest.raises(ValueError, match="nested-MC adapter"):
        ensure_family("divs")  # mc_tpu has no NMC adapter for it either
    ensure_family("heston")
    assert NMC_FAMILIES["heston"] is price_nmc_heston
    fam = HestonNMC()
    cfg = FamilyConfig(n_paths=8, n_steps=4, n_inner=2)
    prm = th.pack_heston(OPT, th.DEMO_HESTON, 4, "cpu")
    grid = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="market grids"):
        family_inner(fam, get_payoff("vanilla_call"), cfg, (1, 2), prm,
                     (grid,), grid)
    with pytest.raises(ValueError, match="grids"):
        family_inner(fam, get_payoff("vanilla_call"), cfg, (1, 2), prm,
                     (grid, torch.zeros((4, 7))), grid)
    with pytest.raises(ValueError, match="params"):
        family_fused(fam, get_payoff("vanilla_call"), cfg, (1, 2), (3, 4),
                     torch.zeros(15))


def test_discount_is_refused_under_heston(capsys):
    from mc_tpu_torch import cli
    with pytest.raises(SystemExit, match="discount"):
        cli.main(["nmc", "--model", "heston", "--discount", "remaining",
                  "--device", "cpu", "--n-paths", "8", "--n-steps", "4",
                  "--n-inner", "2"])
    with pytest.raises(SystemExit, match="discount"):
        cli.main(["nmc", "--model", "rainbow", "--discount", "remaining",
                  "--device", "cpu", "--n-paths", "8", "--n-steps", "4",
                  "--n-inner", "2"])


# --- tests/test_nmc_family_fused.py for heston -------------------------------


@pytest.mark.parametrize("payoff", ["vanilla_call", "asian_call"])
def test_family_fused_equals_grid(payoff):
    sim = mt.SimParams(n_paths=512, n_steps=4, n_paths_inner=8)
    fam, dyn = HestonNMC(), th.DEMO_HESTON.as_f32()
    g = price_nmc_family(fam, mt.OptionParams(), dyn, sim, payoff,
                         strategy="grid", device="cpu")
    f = price_nmc_family(fam, mt.OptionParams(), dyn, sim, payoff,
                         strategy="fused", device="cpu")
    assert torch.equal(g.surface, f.surface)
    assert float(g.outer.price) == float(f.outer.price)
    assert float(g.outer.stderr) == float(f.outer.stderr)
    assert float(g.surface_mean) == float(f.surface_mean)


def test_keys_are_the_family_streams():
    """derive_key(seed, 0|1, 0x4E57): the outer stream is price_heston's
    default, and swapping the stream tags changes the surface."""
    sim = mt.SimParams(n_paths=128, n_steps=4, n_paths_inner=4, seed=8)
    a = price_nmc_heston(sim=sim, strategy="fused", device="cpu")
    b = price_nmc_heston(sim=sim, strategy="fused", stream_outer=1,
                         stream_inner=0, device="cpu")
    assert not torch.equal(a.surface, b.surface)
    key = rng.derive_key(8, 0, th.HESTON_TAG)
    ph = mt.price_heston(sim=sim, key=key, device="cpu")
    assert float(a.outer.price) == pytest.approx(float(ph.price), rel=1e-12)


# --- convert -------------------------------------------------------------------


def test_convert_heston_dynamics_and_params():
    from mc_tpu.models.heston import HestonDynamics, _pack_heston
    jd = HestonDynamics(v0=0.05, kappa=1.5, theta=0.06, xi=0.4, rho=-0.5)
    d = convert.heston_dynamics(jd)
    assert d == th.HestonDynamics(0.05, 1.5, 0.06, 0.4, -0.5)
    assert convert.heston_dynamics(dict(v0=0.1, kappa=1.0, theta=0.1, xi=0.2,
                                        rho=0.0)).v0 == 0.1
    packed = np.asarray(_pack_heston(J_OPT.as_f32(), jd.as_f32(), 16))
    t = convert.heston_params(packed)
    np.testing.assert_array_equal(
        t.numpy().view(np.uint32),
        th.pack_heston(OPT, d, 16, "cpu").numpy().view(np.uint32))
    with pytest.raises(ValueError, match="17"):
        convert.heston_params(packed[:15])
    with pytest.raises(ValueError, match="17"):
        convert.heston_params(packed.astype(np.float64))


ONE_WORD = sorted(n for n, po in PAYOFFS.items() if po.n_state <= 1)


@pytest.mark.parametrize("n_paths,n_steps,offset,n_valid",
                         [(300, 9, 0, None), (129, 16, (1 << 32) - 100, None),
                          (257, 7, 1_000, 1_000 + 200)])
@pytest.mark.parametrize("payoff", ONE_WORD)
def test_engine_hooks_give_heston_trajectories_plain_bitwise(
        payoff, n_paths, n_steps, offset, n_valid):
    """HestonNMC's plain outer hooks through the engine's generic plain
    trajectories (the family template's order: a unit's pair, then its
    step) give heston_trajectories_plain's S, v and state grids and rows bit
    for bit, for every one-word payoff, offsets past 2^32 and a bound below
    the run's end."""
    po = get_payoff(payoff)
    prm = th.pack_heston(OPT, th.DEMO_HESTON, n_steps, "cpu")
    key = (0x12345678, 0x9ABCDEF0)
    got = family_trajectories_plain(
        HestonNMC(), po, FamilyConfig(n_paths=n_paths, n_steps=n_steps,
                                      n_inner=1), key, prm, offset, n_valid)
    want = th.heston_trajectories_plain(
        po, th.HestonConfig(n_paths=n_paths, n_steps=n_steps), key, prm,
        offset, n_valid)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.numpy().tobytes() == w.numpy().tobytes()

