"""mc_tpu_torch's nested MC under a local-vol surface (the family engine,
fused and grid, the grid's outer paths from the local-vol trajectories
kernel #20) against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here; mc_tpu runs its
engine="xla" dual, bitwise equal to its grid and fused Pallas kernels.  Both
draw the same outer (pair j/2 per step) and inner (pair c_base + q per two
substeps, the trailing odd one dropped) threefry-13 streams, read the same
surface rows and Kahan-sum the inner legs in the same order.

Tolerances: those of tests/test_torch_nmc_cev.py.  Inside the port, grid ==
fused bitwise and the outer price is price_localvol's on the outer key to
f64 rounding.  The inner legs pay on a spot recomputed from its log, so the
last row is the discounted payoff of s0*exp(log(S_T/s0)), not of S_T
(``mc_tpu/nmc_localvol.py:87,112``); the test holds the plain leg to that
on spots whose round trip this host's exp/log moves.  The statistical cases of
tests/test_nmc_localvol.py run at mc_tpu's sizes and tolerances.
"""

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import localvol as jl
from mc_tpu.nmc_localvol import price_nmc_localvol as jprice

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import localvol as tl
from mc_tpu_torch.nmc_engine import (NMC_FAMILIES, NMC_FAMILY_BUILDERS,
                                     FamilyConfig, ensure_family,
                                     family_fused, family_rows_plain,
                                     price_nmc_family)
from mc_tpu_torch.nmc_localvol import LocalVolNMC, price_nmc_localvol
from mc_tpu_torch.ops.payoffs import get_payoff

torch.set_num_threads(1)

J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
OPT = convert.option_params(J_OPT)
FLIP_SE, FLIP_TOL, SMOOTH_TOL, SURF_FRAC = 0.05, 1e-4, 1e-5, 0.999
SIM = mt.SimParams(n_paths=4096, n_steps=8, n_paths_inner=16)


def _smile(n_steps):
    """A steep, asymmetric smile: the ramps, the flat ends and the step
    rows all matter."""
    return jl.LocalVolSurface.from_function(
        lambda x, t: 0.25 + 0.6 * x * x - 0.2 * x + 0.1 * t, n_steps,
        x_lo=-0.6, x_hi=0.8, n_knots=11)


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
    jsurf = _smile(8)
    got = price_nmc_localvol(OPT, convert.localvol_surface(jsurf),
                             convert.sim_params(jsim), payoff,
                             strategy=strategy, device="cpu")
    want = jprice(J_OPT, jsurf, jsim, payoff, engine="xla")
    _assert_matches(got, want, jsim.n_paths, payoff)


def test_default_surface_matches_mc_tpu():
    jsim = mc_tpu.SimParams(n_paths=512, n_steps=8, n_paths_inner=8)
    got = price_nmc_localvol(sim=convert.sim_params(jsim), device="cpu")
    want = jprice(sim=jsim, engine="xla")
    _assert_matches(got, want, jsim.n_paths, "vanilla_call")


@pytest.fixture(scope="module")
def both():
    sim = mt.SimParams(n_paths=512, n_steps=8, n_paths_inner=8, seed=3)
    surf = convert.localvol_surface(_smile(8))
    return sim, surf, {s: price_nmc_localvol(OPT, surf, sim, strategy=s,
                                             device="cpu")
                       for s in ("fused", "grid")}


def test_grid_equals_fused_bitwise(both):
    _, _, res = both
    assert torch.equal(res["grid"].surface, res["fused"].surface)
    assert float(res["grid"].outer.price) == float(res["fused"].outer.price)
    assert float(res["grid"].outer.stderr) == float(res["fused"].outer.stderr)
    assert res["fused"].spot_surface is None
    assert res["grid"].spot_matrix().shape == (512, 8)


def test_outer_is_price_localvol_on_the_outer_key(both):
    sim, surf, res = both
    pl = tl.price_localvol(OPT, surf, sim, device="cpu")
    for r in res.values():
        assert float(r.outer.price) == pytest.approx(float(pl.price),
                                                     rel=1e-12)
        assert float(r.outer.stderr) == pytest.approx(float(pl.stderr),
                                                      rel=1e-12)


def test_grid_is_localvol_trajectories(both):
    sim, surf, res = both
    cfg = tl.LocalVolConfig(n_paths=512, n_steps=8, n_knots=11)
    key = rng.derive_key(3, 0, tl.LOCALVOL_TAG)
    s, _, _ = tl.localvol_trajectories(get_payoff("vanilla_call"), cfg, key,
                                       tl.pack_localvol(OPT, surf, 8, "cpu"))
    assert torch.equal(res["grid"].spot_surface, s)


def round_trip_spots(s0: float, lo: float = 101.0, hi: float = 200.0):
    """Spots x in the money whose f32 round trip s0*exp(log(x/s0)) differs
    from x on this host (its exp/log), with that round trip: ``(x, rt)``.
    A dense grid over [lo, hi] gives some on any host."""
    x = torch.linspace(lo, hi, 1 << 16, dtype=torch.float32)
    rt = s0 * torch.exp(torch.log(x / s0))
    off = rt != x
    assert bool(off.any()), "no spot of the grid is off after its round trip"
    return x[off], rt[off]


def test_last_step_pays_on_the_recomputed_spot(both):
    _, surf, res = both
    g = res["grid"]
    p = tl.unpack_localvol(tl.pack_localvol(OPT, surf, 8, "cpu"), 11)
    s = p.s0 * torch.exp(torch.log(g.spot_surface[-1] / p.s0))
    want = torch.exp(-p.r * p.t) * torch.clamp(s - p.k, min=0.0)
    assert torch.equal(g.surface[-1], want)
    # The plain inner leg on a last row of spots that the round trip moves:
    # it pays on the round-tripped spot, not on the stored one.
    x, rt = round_trip_spots(float(p.s0))
    cfg = FamilyConfig(n_paths=x.numel(), n_steps=8, n_inner=1)
    grid = x.expand(8, -1).contiguous()
    row = family_rows_plain(LocalVolNMC(extras=(11,)),
                            get_payoff("vanilla_call"), cfg, (3, 4),
                            tl.pack_localvol(OPT, surf, 8, "cpu"), (grid,),
                            torch.zeros_like(grid), [7])[0]
    disc = torch.exp(-p.r * p.t)
    assert torch.equal(row, disc * torch.clamp(rt - p.k, min=0.0))
    assert not torch.equal(row, disc * torch.clamp(x - p.k, min=0.0))


def test_guards():
    with pytest.raises(ValueError, match="surface has"):
        price_nmc_localvol(surf=tl.LocalVolSurface.flat(0.2, 4),
                           sim=mt.SimParams(n_paths=256, n_steps=8,
                                            n_paths_inner=4), device="cpu")
    with pytest.raises(ValueError, match="counter"):
        price_nmc_localvol(surf=tl.LocalVolSurface.flat(0.2, 4096),
                           sim=mt.SimParams(n_paths=256, n_steps=4096,
                                            n_paths_inner=512), device="cpu")
    bad = tl.LocalVolSurface(x_knots=np.array([0.5, -0.5], np.float32),
                             vols=np.full((8, 2), 0.2, np.float32))
    with pytest.raises(ValueError, match="ascending"):
        price_nmc_localvol(surf=bad, sim=SIM, device="cpu")
    with pytest.raises(ValueError, match="even n_steps"):
        price_nmc_localvol(surf=tl.LocalVolSurface.flat(0.2, 7),
                           sim=mt.SimParams(n_paths=64, n_steps=7,
                                            n_paths_inner=4), device="cpu")
    prm = tl.pack_localvol(OPT, tl.LocalVolSurface.demo(4), 4, "cpu")
    with pytest.raises(ValueError, match="params"):  # packed for 4 steps
        family_fused(LocalVolNMC(extras=(9,)), get_payoff("vanilla_call"),
                     FamilyConfig(n_paths=8, n_steps=6, n_inner=2), (1, 2),
                     (3, 4), prm)


def test_registry_and_builder():
    """tests/test_nmc_family_fused.py's localvol case: the builder's family
    (the demo surface at the run's steps), fused == grid bitwise."""
    ensure_family("localvol")
    assert NMC_FAMILIES["localvol"] is price_nmc_localvol
    sim = mt.SimParams(n_paths=512, n_steps=4, n_paths_inner=8)
    fam, dyn = NMC_FAMILY_BUILDERS["localvol"](mt.OptionParams(), None, sim)
    assert isinstance(fam, LocalVolNMC) and fam.extras == (9,)
    np.testing.assert_array_equal(dyn.vols, tl.LocalVolSurface.demo(4).vols)
    g, f = (price_nmc_family(fam, mt.OptionParams(), dyn, sim, "vanilla_call",
                             strategy=s, device="cpu")
            for s in ("grid", "fused"))
    assert torch.equal(g.surface, f.surface)
    assert float(g.outer.price) == float(f.outer.price)
    assert float(g.surface_mean) == float(f.surface_mean)
    fam100, _ = NMC_FAMILY_BUILDERS["localvol"](
        mt.OptionParams(), None, mt.SimParams(n_steps=100))
    assert fam100.extras == (9,)


def test_keys_are_the_family_streams():
    sim = mt.SimParams(n_paths=128, n_steps=4, n_paths_inner=4, seed=8)
    a = price_nmc_localvol(sim=sim, strategy="fused", device="cpu")
    b = price_nmc_localvol(sim=sim, strategy="fused", stream_outer=1,
                           stream_inner=0, device="cpu")
    assert not torch.equal(a.surface, b.surface)
    pl = tl.price_localvol(surf=tl.LocalVolSurface.demo(4), sim=sim,
                           key=rng.derive_key(8, 0, tl.LOCALVOL_TAG),
                           device="cpu")
    assert float(a.outer.price) == pytest.approx(float(pl.price), rel=1e-12)


# --- the cases of tests/test_nmc_localvol.py ---------------------------------


def test_flat_surface_ee_flat_at_bs():
    sim = mt.SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_localvol(mt.OptionParams(),
                             tl.LocalVolSurface.flat(0.2, 8), sim,
                             device="cpu")
    want = mt.oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2)
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(ee.numpy(), want, rtol=0.04)
    assert bool((pfe >= ee - 1e-5).all())
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_tower_property_under_smile():
    sim = mt.SimParams(n_paths=16_384, n_steps=8, n_paths_inner=32)
    res = price_nmc_localvol(mt.OptionParams(), tl.LocalVolSurface.demo(8),
                             sim, device="cpu")
    assert float(res.surface_mean) == pytest.approx(float(res.outer.price),
                                                    rel=0.05)
    assert float(res.outer.stderr) > 0


def test_smile_widens_exposure_quantiles():
    def gap(surface):
        ee, pfe = price_nmc_localvol(mt.OptionParams(), surface, SIM,
                                     device="cpu").exposure_profile()
        return float(pfe[-1] - ee[-1])

    strong = tl.LocalVolSurface.from_function(lambda x, t: 0.2 + 0.6 * x * x,
                                              8)
    assert gap(strong) > gap(tl.LocalVolSurface.flat(0.2, 8))


def test_path_dependent_state_resumes():
    sim = mt.SimParams(n_paths=2048, n_steps=8, n_paths_inner=4)
    res = price_nmc_localvol(mt.OptionParams(p1=1.0, p2=6.0),
                             tl.LocalVolSurface.demo(8), sim,
                             payoff="bullet_call", device="cpu")
    assert bool(torch.isfinite(res.surface_matrix()).all())
    assert float(res.outer.stderr) > 0
