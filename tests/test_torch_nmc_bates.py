"""mc_tpu_torch's nested MC under Bates SVJ (the family engine, fused and
grid, the grid's outer paths from the generic trajectories kernel) against
mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here; mc_tpu runs its
engine="xla" dual, bitwise equal to its grid and fused Pallas kernels (its
grid strategy builds the Bates outer grids with its XLA scan).  Both draw
the same outer (counters 3j, 3j+1, 3j+2) and inner (c_base + 3u, +1, +2)
threefry-13 streams and Kahan-sum the inner legs in the same order.

Tolerances: those of tests/test_torch_nmc_merton.py.  The step count 7 is
odd, so the surface has a row with no remaining steps.
"""

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models.bates import DEMO_BATES as J_DEMO
from mc_tpu.nmc_bates import price_nmc_bates as jprice
from mc_tpu.nmc_engine import xla_family_trajectories
from mc_tpu.nmc_bates import BatesNMC as JBatesNMC
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import bates as tb
from mc_tpu_torch.models import heston as th
from mc_tpu_torch.models import merton as tm
from mc_tpu_torch.nmc_bates import BatesNMC, price_nmc_bates
from mc_tpu_torch.nmc_engine import (NMC_FAMILIES, NMC_FAMILY_BUILDERS,
                                     FamilyConfig, ensure_family,
                                     family_trajectories,
                                     family_trajectories_plain)
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
OPT = convert.option_params(J_OPT)
FLIP_SE, FLIP_TOL, SMOOTH_TOL, SURF_FRAC = 0.05, 1e-4, 1e-5, 0.999
ST_SIM = mt.SimParams(n_paths=4096, n_steps=10, n_paths_inner=64)
NO_JUMP = tb.BatesDynamics(lam=0.0)
JUMPY = tb.BatesDynamics(lam=1.0, mu_j=0.05, sigma_j=0.25)


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
    jsim = mc_tpu.SimParams(n_paths=512, n_steps=7, n_paths_inner=8)
    got = price_nmc_bates(OPT, tb.DEMO_BATES, convert.sim_params(jsim),
                          payoff, strategy=strategy, device="cpu")
    want = jprice(J_OPT, J_DEMO, jsim, payoff, engine="xla")
    _assert_matches(got, want, jsim.n_paths, payoff)


@pytest.mark.parametrize("name", ["bullet_call", "asian_call",
                                  "down_out_call"])
def test_family_trajectories_match_mc_tpu_scan(name):
    """The generic trajectories (the plain version here) against mc_tpu's
    XLA outer scan, xla_family_trajectories: S to 2e-6, v to 2e-6 of its
    largest |v|, a count or flag state equal on >= 99.9% of paths."""
    n_paths, n_steps = 1500, 12
    jopt = mc_tpu.OptionParams(p1=1.0, p2=6.0, barrier=90.0)
    kmax = tm.poisson_kmax(JUMPY.lam / n_steps)
    jfam = JBatesNMC(extras=(kmax,))
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    key = rng.derive_key(3, 0, tb.BATES_TAG)
    jdyn = convert.bates_dynamics(JUMPY)
    from mc_tpu.models.bates import BatesDynamics as JDyn
    jparams = jfam.pack(jopt.as_f32(), JDyn(*JUMPY.astuple()).as_f32(),
                        n_steps)
    js, jv, jst, jsum, jsq = xla_family_trajectories(
        jfam, jget_payoff(name), jcfg, jparams, np.asarray(key, np.uint32))
    fam = BatesNMC(extras=(kmax,))
    cfg = FamilyConfig(n_paths=n_paths, n_steps=n_steps, n_inner=1)
    prm = tb.pack_bates(convert.option_params(jopt), jdyn, n_steps, "cpu")
    s, v, st, partials = family_trajectories(fam, get_payoff(name), cfg, key,
                                             prm)
    np.testing.assert_allclose(s.T.numpy(),
                               convert.surface_matrix(js, n_paths), rtol=2e-6)
    want_v = convert.surface_matrix(jv, n_paths)
    np.testing.assert_allclose(v.T.numpy(), want_v, rtol=0,
                               atol=2e-6 * np.abs(want_v).max())
    want_st = convert.surface_matrix(jst, n_paths)
    if name == "asian_call":
        np.testing.assert_allclose(st.T.numpy(), want_st, rtol=2e-6)
    else:
        assert (st.T.numpy() == want_st).all(axis=1).mean() >= 0.999
    sums = finish_sum(partials).numpy()
    want = np.array([float(jfinish_sum(jsum)), float(jfinish_sum(jsq))])
    if name == "asian_call":
        np.testing.assert_allclose(sums, want, rtol=1e-5)
    else:
        se = np.sqrt(want[1] / n_paths - (want[0] / n_paths) ** 2)
        assert abs(sums[0] - want[0]) / n_paths <= FLIP_SE * se / np.sqrt(
            n_paths)
    # the grids' own payoff sums are price_bates's Euler sums on the key
    own = finish_sum(tb.bates_partials(
        get_payoff(name), tb.BatesConfig(n_paths=n_paths, n_steps=n_steps,
                                         kmax=kmax), key, prm))
    np.testing.assert_allclose(sums, own.numpy(), rtol=1e-12)


@pytest.fixture(scope="module")
def both():
    sim = mt.SimParams(n_paths=512, n_steps=7, n_paths_inner=8, seed=3)
    return sim, {s: price_nmc_bates(OPT, JUMPY, sim, strategy=s,
                                    device="cpu")
                 for s in ("fused", "grid")}


def test_grid_equals_fused_bitwise(both):
    _, res = both
    assert torch.equal(res["grid"].surface, res["fused"].surface)
    assert float(res["grid"].outer.price) == float(res["fused"].outer.price)
    assert float(res["grid"].outer.stderr) == float(res["fused"].outer.stderr)
    assert res["fused"].spot_surface is None
    assert res["grid"].spot_matrix().shape == (512, 7)


def test_outer_is_price_bates_on_the_outer_key(both):
    sim, res = both
    pb = tb.price_bates(OPT, JUMPY, sim, device="cpu")
    for r in res.values():
        assert float(r.outer.price) == pytest.approx(float(pb.price),
                                                     rel=1e-12)
        assert float(r.outer.stderr) == pytest.approx(float(pb.stderr),
                                                      rel=1e-12)


def test_last_step_is_the_discounted_terminal_payoff(both):
    _, res = both
    g = res["grid"]
    p = tb.unpack_bates(tb.pack_bates(OPT, JUMPY, 7, "cpu"))
    want = torch.exp(-p.r * p.t) * torch.clamp(g.spot_surface[-1] - p.k,
                                               min=0.0)
    assert torch.equal(g.surface[-1], want)


def test_tower_property():
    res = price_nmc_bates(sim=ST_SIM, strategy="fused", device="cpu")
    ref = tb.bates_call_cf(100.0, 100.0, 1.0, 0.1, *tb.DEMO_BATES.astuple())
    assert float(res.surface_mean) == pytest.approx(ref, rel=0.05)
    assert abs(float(res.outer.price) - ref) <= 4.0 * float(res.outer.stderr)


@pytest.fixture(scope="module")
def heston_limit_and_jumps():
    return (price_nmc_bates(sim=ST_SIM, dyn=NO_JUMP, device="cpu"),
            price_nmc_bates(sim=ST_SIM, dyn=JUMPY, device="cpu"))


def test_heston_limit(heston_limit_and_jumps):
    nj, _ = heston_limit_and_jumps
    ref = th.heston_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 0.3,
                            -0.7)
    assert float(nj.surface_mean) == pytest.approx(ref, rel=0.05)


def test_jumps_fatten_pfe_beyond_matched_vol_heston(heston_limit_and_jumps):
    nj, wj = heston_limit_and_jumps

    def pfe(res):
        ee = torch.clamp(res.surface, min=0.0).double()
        return float(torch.quantile(ee, 0.975, dim=1).mean())

    assert pfe(wj) > pfe(nj)


def test_cva_under_jumps_exceeds_no_jump(heston_limit_and_jumps):
    nj, wj = heston_limit_and_jumps
    assert float(wj.cva(0.02, 0.4)) > float(nj.cva(0.02, 0.4)) > 0.0


def test_guards():
    with pytest.raises(ValueError, match="counter space"):
        price_nmc_bates(sim=mt.SimParams(n_paths=64, n_steps=30_000,
                                         n_paths_inner=2000), device="cpu")
    with pytest.raises(ValueError, match="at most one state array"):
        price_nmc_bates(sim=mt.SimParams(n_paths=8, n_steps=4,
                                         n_paths_inner=2),
                        payoff="cliquet", device="cpu")
    with pytest.raises(ValueError, match="params"):
        family_trajectories(BatesNMC(extras=(4,)), get_payoff("vanilla_call"),
                            FamilyConfig(n_paths=8, n_steps=4, n_inner=2),
                            (1, 2), torch.zeros(17))
    with pytest.raises(ValueError, match="at most 4"):
        from mc_tpu_torch.ops import _cuda
        _cuda.family_extras((1, 2, 3, 4, 5))


def test_registry_builder_and_default_trajectories():
    ensure_family("bates")
    assert NMC_FAMILIES["bates"] is price_nmc_bates
    sim = mt.SimParams(n_paths=64, n_steps=5, n_paths_inner=4)
    fam, dyn = NMC_FAMILY_BUILDERS["bates"](OPT, None, sim)
    assert isinstance(fam, BatesNMC) and dyn == tb.DEMO_BATES.as_f32()
    assert fam.extras == (tm.poisson_kmax(tb.DEMO_BATES.lam / 5),)
    # Bates takes the engine's default trajectories: the generic plain
    cfg = FamilyConfig(n_paths=64, n_steps=5, n_inner=4)
    prm = tb.pack_bates(OPT, dyn, 5, "cpu")
    a = fam.trajectories_plain(get_payoff("bullet_call"), cfg, (1, 2), prm)
    b = family_trajectories_plain(fam, get_payoff("bullet_call"), cfg,
                                  (1, 2), prm)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_convert_bates_dynamics():
    from mc_tpu.models.bates import BatesDynamics
    jd = BatesDynamics(v0=0.05, lam=0.7, mu_j=-0.2, sigma_j=0.3)
    assert convert.bates_dynamics(jd) == tb.BatesDynamics(
        0.05, 2.0, 0.04, 0.3, -0.7, 0.7, -0.2, 0.3)
    with pytest.raises(ValueError, match="20"):
        convert.bates_params(np.zeros(17, np.float32))
