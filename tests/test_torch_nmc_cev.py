"""mc_tpu_torch's nested MC under CEV local vol (the family engine, fused and
grid, the grid's outer paths from the generic trajectories kernel) against
mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here; mc_tpu runs its
engine="xla" dual, bitwise equal to its grid and fused Pallas kernels (its
grid strategy builds the CEV outer grids with its XLA scan).  Both draw the
same outer (pair j/2 per step) and inner (pair c_base + q per two substeps,
the trailing odd one dropped) threefry-13 streams and Kahan-sum the inner
legs in the same order.

Tolerances (parity contract): the smooth payoffs' surfaces to rtol = atol =
1e-5 on at least 99.9% of points and their mean and the outer price to 1e-5
relative; the bullet's surface within 1e-4 on 99.9% of points and its outer
price and surface mean within 0.05 outer stderr.  Inside the port, grid ==
fused bitwise, and the outer price is price_cev's on the outer key to f64
rounding.  The statistical cases of tests/test_nmc_cev.py run at mc_tpu's
sizes and tolerances.
"""

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models.cev import DEMO_CEV as J_DEMO
from mc_tpu.nmc_cev import CEVNMC as JCEVNMC
from mc_tpu.nmc_cev import price_nmc_cev as jprice
from mc_tpu.nmc_engine import xla_family_trajectories
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import cev as tc
from mc_tpu_torch.nmc_cev import CEVNMC, price_nmc_cev
from mc_tpu_torch.nmc_engine import (NMC_FAMILIES, NMC_FAMILY_BUILDERS,
                                     FamilyConfig, ensure_family,
                                     family_trajectories,
                                     family_trajectories_plain,
                                     price_nmc_family)
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
OPT = convert.option_params(J_OPT)
FLIP_SE, FLIP_TOL, SMOOTH_TOL, SURF_FRAC = 0.05, 1e-4, 1e-5, 0.999
FLIPS = {"bullet_call", "down_out_call"}
STEEP = tc.CEVDynamics.from_atm_vol(0.6, 0.3, 100.0)


def _assert_matches(got, want, n_paths, payoff):
    g = got.surface_matrix().numpy()
    w = convert.surface_matrix(want.surface, n_paths)
    assert g.shape == w.shape
    flip = payoff in FLIPS
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
    got = price_nmc_cev(OPT, tc.DEMO_CEV, convert.sim_params(jsim), payoff,
                        strategy=strategy, device="cpu")
    want = jprice(J_OPT, J_DEMO, jsim, payoff, engine="xla")
    _assert_matches(got, want, jsim.n_paths, payoff)


@pytest.mark.parametrize("name", ["bullet_call", "asian_call",
                                  "down_out_call"])
def test_family_trajectories_match_mc_tpu_scan(name):
    """The generic trajectories (the plain version here) against mc_tpu's
    XLA outer scan, xla_family_trajectories: S to 2e-6 (absolute 2e-6 of
    the largest S where a path sits at 0), a count or flag state equal on
    >= 99.9% of paths, the Asian's sum to 2e-6."""
    n_paths, n_steps = 1500, 12
    jopt = mc_tpu.OptionParams(p1=1.0, p2=6.0, barrier=90.0)
    jdyn = mc_tpu.models.cev.CEVDynamics(*STEEP.astuple())
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    key = rng.derive_key(3, 0, tc.CEV_TAG)
    jparams = JCEVNMC().pack(jopt.as_f32(), jdyn.as_f32(), n_steps)
    js, jst, jsum, jsq = xla_family_trajectories(
        JCEVNMC(), jget_payoff(name), jcfg, jparams,
        np.asarray(key, np.uint32))
    cfg = FamilyConfig(n_paths=n_paths, n_steps=n_steps, n_inner=1)
    prm = tc.pack_cev(convert.option_params(jopt), STEEP, n_steps, "cpu")
    s, st, partials = family_trajectories(CEVNMC(), get_payoff(name), cfg,
                                          key, prm)
    want_s = convert.surface_matrix(js, n_paths)
    np.testing.assert_allclose(s.T.numpy(), want_s, rtol=2e-6,
                               atol=2e-6 * want_s.max())
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
    # the grids' own payoff sums are price_cev's on the key
    own = finish_sum(tc.cev_partials(
        get_payoff(name), tc.CEVConfig(n_paths=n_paths, n_steps=n_steps), key,
        prm))
    np.testing.assert_allclose(sums, own.numpy(), rtol=1e-12)
    assert bool((s == 0).any())  # the steep skew absorbs some paths


@pytest.fixture(scope="module")
def both():
    sim = mt.SimParams(n_paths=512, n_steps=8, n_paths_inner=8, seed=3)
    return sim, {s: price_nmc_cev(OPT, STEEP, sim, strategy=s, device="cpu")
                 for s in ("fused", "grid")}


def test_grid_equals_fused_bitwise(both):
    _, res = both
    assert torch.equal(res["grid"].surface, res["fused"].surface)
    assert float(res["grid"].outer.price) == float(res["fused"].outer.price)
    assert float(res["grid"].outer.stderr) == float(res["fused"].outer.stderr)
    assert res["fused"].spot_surface is None
    assert res["grid"].spot_matrix().shape == (512, 8)


def test_outer_is_price_cev_on_the_outer_key(both):
    sim, res = both
    pc = tc.price_cev(OPT, STEEP, sim, device="cpu")
    for r in res.values():
        assert float(r.outer.price) == pytest.approx(float(pc.price),
                                                     rel=1e-12)
        assert float(r.outer.stderr) == pytest.approx(float(pc.stderr),
                                                      rel=1e-12)


def test_last_step_is_the_discounted_terminal_payoff(both):
    _, res = both
    g = res["grid"]
    p = tc.unpack_cev(tc.pack_cev(OPT, STEEP, 8, "cpu"))
    want = torch.exp(-p.r * p.t) * torch.clamp(g.spot_surface[-1] - p.k,
                                               min=0.0)
    assert torch.equal(g.surface[-1], want)


def test_guards():
    with pytest.raises(ValueError, match="even n_steps"):
        price_nmc_cev(sim=mt.SimParams(n_paths=256, n_steps=3,
                                       n_paths_inner=4), device="cpu")
    with pytest.raises(ValueError, match="counter"):
        price_nmc_cev(sim=mt.SimParams(n_paths=256, n_steps=4096,
                                       n_paths_inner=1024), device="cpu")
    with pytest.raises(ValueError, match="params"):
        family_trajectories(CEVNMC(), get_payoff("vanilla_call"),
                            FamilyConfig(n_paths=8, n_steps=4, n_inner=2),
                            (1, 2), torch.zeros(17))


def test_registry_builder_and_default_trajectories():
    """tests/test_nmc_family_fused.py's cev cases: the builder's family,
    fused == grid bitwise on vanilla and the Asian, unknown strategies
    refused; CEV takes the engine's default (generic) trajectories."""
    ensure_family("cev")
    assert NMC_FAMILIES["cev"] is price_nmc_cev
    sim = mt.SimParams(n_paths=512, n_steps=4, n_paths_inner=8)
    fam, dyn = NMC_FAMILY_BUILDERS["cev"](mt.OptionParams(), None, sim)
    assert isinstance(fam, CEVNMC) and dyn == tc.DEMO_CEV.as_f32()
    for payoff in ("vanilla_call", "asian_call"):
        g, f = (price_nmc_family(fam, mt.OptionParams(), dyn, sim, payoff,
                                 strategy=s, device="cpu")
                for s in ("grid", "fused"))
        assert torch.equal(g.surface, f.surface)
        assert float(g.outer.price) == float(f.outer.price)
        assert float(g.surface_mean) == float(f.surface_mean)
    with pytest.raises(ValueError, match="strategy"):
        price_nmc_family(fam, mt.OptionParams(), dyn, sim, "vanilla_call",
                         strategy="vmem", device="cpu")
    cfg = FamilyConfig(n_paths=64, n_steps=4, n_inner=2)
    prm = tc.pack_cev(OPT, dyn, 4, "cpu")
    a = fam.trajectories_plain(get_payoff("bullet_call"), cfg, (1, 2), prm)
    b = family_trajectories_plain(fam, get_payoff("bullet_call"), cfg,
                                  (1, 2), prm)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- the cases of tests/test_nmc_cev.py --------------------------------------


def test_ee_flat_at_cev_price():
    """The fully discounted conditional value of a call is a martingale: EE
    at every step within 4% of the Schroder price, the surface mean 3%."""
    sim = mt.SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_cev(sim=sim, device="cpu")
    want = tc.cev_call_closed_form(100.0, 100.0, 1.0, 0.1,
                                   tc.DEMO_CEV.sigma_lv, tc.DEMO_CEV.beta)
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(ee.numpy(), want, rtol=0.04)
    assert bool((pfe >= ee - 1e-5).all())
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_beta_one_limit_matches_bs():
    sim = mt.SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_cev(dyn=tc.CEVDynamics(sigma_lv=0.2, beta=1.0), sim=sim,
                        device="cpu")
    want = mt.oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2)
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_path_dependent_state_resumes():
    sim = mt.SimParams(n_paths=2048, n_steps=8, n_paths_inner=4)
    res = price_nmc_cev(mt.OptionParams(p1=1.0, p2=6.0), tc.DEMO_CEV, sim,
                        payoff="bullet_call", device="cpu")
    assert bool(torch.isfinite(res.surface_matrix()).all())
    assert float(res.outer.stderr) > 0
