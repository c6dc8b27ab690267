"""mc_tpu_torch's nested MC under SABR (the family engine, fused and grid,
the grid's (F, sigma) outer grids from the generic trajectories kernel)
against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here; mc_tpu runs its
engine="xla" dual, bitwise equal to its grid and fused Pallas kernels (its
grid strategy builds the SABR outer grids with its XLA scan).  Both draw the
same outer (pair j per step) and inner (pair ((j+1)*n_inner + m)*n_steps + u
per substep) threefry-13 streams and Kahan-sum the inner legs in the same
order.

Tolerances (parity contract), on the demo dynamics (a skewed backbone with
a strong vol-of-vol parts the two libms' forwards by several ulp within a
few steps): the smooth payoffs' surfaces to rtol = atol = 1e-5 on at least
99.9% of points and their mean and the outer price to 1e-5
relative; the bullet's surface within 1e-4 on 99.9% of points and its outer
price and surface mean within 0.05 outer stderr; the outer grids on the
same key to 2e-6 relative (absolute near 0), one inner leg on the same
inputs to 2e-6 relative plus 16 ulp of the largest forward.  Inside the port, grid == fused bitwise, and the outer price is
price_sabr's on the outer key to f64 rounding.  The inner legs pay on
exp(log F): the last row is the discounted payoff of exp(log(F_T)), not of
F_T.  The statistical cases of tests/test_nmc_sabr.py run at its sizes and
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import sabr as js
from mc_tpu.nmc_engine import xla_family_trajectories
from mc_tpu.nmc_sabr import SABRNMC as JSABRNMC
from mc_tpu.nmc_sabr import price_nmc_sabr as jprice
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import sabr as ts
from mc_tpu_torch.nmc_engine import (NMC_FAMILIES, NMC_FAMILY_BUILDERS,
                                     FamilyConfig, ensure_family,
                                     family_rows_plain, family_trajectories,
                                     price_nmc_family)
from mc_tpu_torch.nmc_sabr import SABRNMC, price_nmc_sabr
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
OPT = convert.option_params(J_OPT)
FLIP_SE, FLIP_TOL, SMOOTH_TOL, SURF_FRAC = 0.05, 1e-4, 1e-5, 0.999
EPS32 = 2.0 ** -24
J_SKEW = js.SABRDynamics(alpha=0.3 * 100.0 ** 0.4, beta=0.6, nu=0.8, rho=0.3)
SKEW = convert.sabr_dynamics(J_SKEW)


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


@pytest.mark.parametrize("n_paths,n_steps", [(512, 8), (300, 7)])
@pytest.mark.parametrize("strategy", ["fused", "grid"])
@pytest.mark.parametrize("payoff", ["vanilla_call", "bullet_call",
                                    "asian_call"])
def test_matches_mc_tpu(payoff, strategy, n_paths, n_steps):
    """300 x 7: a partial tile and an odd step count (one pair a step)."""
    jsim = mc_tpu.SimParams(n_paths=n_paths, n_steps=n_steps,
                            n_paths_inner=8)
    got = price_nmc_sabr(OPT, ts.DEMO_SABR, convert.sim_params(jsim), payoff,
                         strategy=strategy, device="cpu")
    want = jprice(J_OPT, js.DEMO_SABR, jsim, payoff, engine="xla")
    _assert_matches(got, want, jsim.n_paths, payoff)


@pytest.mark.parametrize("name", ["vanilla_call", "asian_call",
                                  "bullet_call"])
def test_family_trajectories_match_mc_tpu_scan(name):
    """The generic trajectories under SABR (the plain version here) against
    mc_tpu's XLA outer scan on the skewed dynamics: F and sigma to 2e-6
    (absolute 2e-6 of the largest where the CEV backbone drives a forward
    towards 0 and the two libms' last bits part), the Asian's sum to 2e-6,
    a count equal on >= 99.9% of paths; the payoff sums are price_sabr's."""
    n_paths, n_steps = 1500, 12
    key = rng.derive_key(3, 0, ts.SABR_TAG)
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    jparams = JSABRNMC().pack(J_OPT.as_f32(), J_SKEW.as_f32(), n_steps)
    jf, jsig, jst, jsum, jsq = xla_family_trajectories(
        JSABRNMC(), jget_payoff(name), jcfg, jparams,
        np.asarray(key, np.uint32))
    cfg = FamilyConfig(n_paths=n_paths, n_steps=n_steps, n_inner=1)
    prm = ts.pack_sabr(OPT, SKEW, n_steps, "cpu")
    f, sig, st, partials = family_trajectories(SABRNMC(), get_payoff(name),
                                               cfg, key, prm)
    for got, want in ((f, jf), (sig, jsig)):
        want = convert.surface_matrix(want, n_paths)
        np.testing.assert_allclose(got.T.numpy(), want, rtol=2e-6,
                                   atol=2e-6 * want.max())
    want_st = convert.surface_matrix(jst, n_paths)
    if name == "bullet_call":
        assert (st.T.numpy() == want_st).all(axis=1).mean() >= 0.999
    else:
        np.testing.assert_allclose(st.T.numpy(), want_st, rtol=2e-6)
    sums = finish_sum(partials).numpy()
    want = np.array([float(jfinish_sum(jsum)), float(jfinish_sum(jsq))])
    if name != "bullet_call":
        np.testing.assert_allclose(sums, want, rtol=1e-5)
    own = finish_sum(ts.sabr_partials(
        get_payoff(name), ts.SABRConfig(n_paths=n_paths, n_steps=n_steps),
        key, prm))
    np.testing.assert_allclose(sums, own.numpy(), rtol=1e-12)


def test_leg_matches_mc_tpu():
    """Three inner substeps from the same (F_t, sigma_t, Asian sum) through
    mc_tpu's SABRNMC.leg and the port's, on the same counters."""
    rs = np.random.default_rng(31)
    n = 2048
    f_t = rs.uniform(60.0, 180.0, n).astype(np.float32)
    sig_t = rs.uniform(0.5, 3.5, n).astype(np.float32)
    acc = rs.uniform(0.0, 500.0, n).astype(np.float32)
    ids = np.arange(n, dtype=np.uint32) + 7
    jp = js._unpack_sabr(js._pack_sabr(J_OPT.as_f32(), J_SKEW.as_f32(), 8))
    jpo = jget_payoff("asian_call")
    want = JSABRNMC().leg(jpo, jp, None, jnp.uint32(11), jnp.uint32(12),
                          jnp.asarray(ids), jnp.uint32(96), 4, 3,
                          (jnp.asarray(f_t), jnp.asarray(sig_t)),
                          (jnp.asarray(acc),),
                          jax.lax.bitcast_convert_type, 8)
    p = ts.unpack_sabr(ts.pack_sabr(OPT, SKEW, 8, "cpu"))
    got = SABRNMC().leg(get_payoff("asian_call"), p, 11, 12,
                        torch.from_numpy(ids.astype(np.int64))[None],
                        torch.tensor([[96]]), 3,
                        (torch.from_numpy(f_t)[None],
                         torch.from_numpy(sig_t)[None]),
                        (torch.from_numpy(acc)[None],))[0]
    # exp(log F) turns an ulp of log F into several of F: 16 ulp of the
    # largest forward
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=16 * EPS32 * float(f_t.max()))


@pytest.fixture(scope="module")
def both():
    sim = mt.SimParams(n_paths=512, n_steps=8, n_paths_inner=8, seed=3)
    return sim, {s: price_nmc_sabr(OPT, SKEW, sim, strategy=s, device="cpu")
                 for s in ("fused", "grid")}


def test_grid_equals_fused_bitwise(both):
    _, res = both
    assert torch.equal(res["grid"].surface, res["fused"].surface)
    assert float(res["grid"].outer.price) == float(res["fused"].outer.price)
    assert float(res["grid"].outer.stderr) == float(res["fused"].outer.stderr)
    assert res["fused"].spot_surface is None
    assert res["grid"].spot_matrix().shape == (512, 8)


def test_outer_is_price_sabr_on_the_outer_key(both):
    sim, res = both
    ps = ts.price_sabr(OPT, SKEW, sim, device="cpu")
    for r in res.values():
        assert float(r.outer.price) == pytest.approx(float(ps.price),
                                                     rel=1e-12)
        assert float(r.outer.stderr) == pytest.approx(float(ps.stderr),
                                                      rel=1e-12)


def test_last_step_pays_on_the_recomputed_forward(both):
    _, res = both
    g = res["grid"]
    p = ts.unpack_sabr(ts.pack_sabr(OPT, SKEW, 8, "cpu"))
    f = torch.exp(torch.log(g.spot_surface[-1]))
    disc = torch.exp(-p.r * p.t)
    assert torch.equal(g.surface[-1], disc * torch.clamp(f - p.k, min=0.0))
    # On a last row of forwards that the round trip moves, the plain leg
    # pays on exp(log F), not on F.
    x = torch.linspace(101.0, 200.0, 1 << 16, dtype=torch.float32)
    rt = torch.exp(torch.log(x))
    off = rt != x
    assert bool(off.any())
    x, rt = x[off], rt[off]
    grid = x.expand(8, -1).contiguous()
    row = family_rows_plain(
        SABRNMC(), get_payoff("vanilla_call"),
        FamilyConfig(n_paths=x.numel(), n_steps=8, n_inner=1), (3, 4),
        ts.pack_sabr(OPT, SKEW, 8, "cpu"), (grid, torch.ones_like(grid)),
        torch.zeros_like(grid), [7])[0]
    assert torch.equal(row, disc * torch.clamp(rt - p.k, min=0.0))
    assert not torch.equal(row, disc * torch.clamp(x - p.k, min=0.0))


def test_guards():
    with pytest.raises(ValueError, match="counter"):
        price_nmc_sabr(sim=mt.SimParams(n_paths=256, n_steps=66_000,
                                        n_paths_inner=1024), device="cpu")
    with pytest.raises(ValueError, match="params"):
        family_trajectories(SABRNMC(), get_payoff("vanilla_call"),
                            FamilyConfig(n_paths=8, n_steps=4, n_inner=2),
                            (1, 2), torch.zeros(13))
    with pytest.raises(ValueError, match="2 market grids"):
        from mc_tpu_torch.nmc_engine import family_inner
        cfg = FamilyConfig(n_paths=8, n_steps=4, n_inner=2)
        z = torch.zeros(4, 8)
        family_inner(SABRNMC(), get_payoff("vanilla_call"), cfg, (1, 2),
                     ts.pack_sabr(OPT, SKEW, 4, "cpu"), (z,), z)


def test_registry_and_builder():
    """tests/test_nmc_family_fused.py's sabr case: the builder's family,
    fused == grid bitwise."""
    ensure_family("sabr")
    assert NMC_FAMILIES["sabr"] is price_nmc_sabr
    sim = mt.SimParams(n_paths=512, n_steps=4, n_paths_inner=8)
    fam, dyn = NMC_FAMILY_BUILDERS["sabr"](mt.OptionParams(), None, sim)
    assert isinstance(fam, SABRNMC) and dyn == ts.DEMO_SABR.as_f32()
    g, f = (price_nmc_family(fam, mt.OptionParams(), dyn, sim, "vanilla_call",
                             strategy=s, device="cpu")
            for s in ("grid", "fused"))
    assert torch.equal(g.surface, f.surface)
    assert float(g.outer.price) == float(f.outer.price)
    assert float(g.outer.stderr) == float(f.outer.stderr)
    assert float(g.surface_mean) == float(f.surface_mean)


def test_keys_are_the_family_streams():
    sim = mt.SimParams(n_paths=128, n_steps=4, n_paths_inner=4, seed=8)
    a = price_nmc_sabr(sim=sim, strategy="fused", device="cpu")
    b = price_nmc_sabr(sim=sim, strategy="fused", stream_outer=1,
                       stream_inner=0, device="cpu")
    assert not torch.equal(a.surface, b.surface)
    ps = ts.price_sabr(sim=sim, key=rng.derive_key(8, 0, ts.SABR_TAG),
                       device="cpu")
    assert float(a.outer.price) == pytest.approx(float(ps.price), rel=1e-12)


# --- the cases of tests/test_nmc_sabr.py -------------------------------------


def test_ee_flat_at_sabr_price():
    """F is a forward-measure martingale: the fully discounted conditional
    call value is flat at the time-0 SABR price."""
    sim = mt.SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_sabr(sim=sim, device="cpu")
    ref = ts.price_sabr(sim=mt.SimParams(n_paths=400_000, n_steps=8),
                        device="cpu")
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(ee.numpy(), float(ref.price), rtol=0.04)
    assert bool((pfe >= ee - 1e-5).all())
    assert float(res.surface_mean) == pytest.approx(float(ref.price),
                                                    rel=0.03)


def test_lognormal_limit_matches_bs():
    dyn = ts.SABRDynamics(alpha=0.2, beta=1.0, nu=1e-6, rho=0.0)
    sim = mt.SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_sabr(mt.OptionParams(), dyn, sim, device="cpu")
    want = mt.oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2)
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_path_dependent_state_resumes():
    sim = mt.SimParams(n_paths=2048, n_steps=8, n_paths_inner=4)
    res = price_nmc_sabr(mt.OptionParams(p1=1.0, p2=6.0), ts.DEMO_SABR, sim,
                         payoff="bullet_call", device="cpu")
    assert bool(torch.isfinite(res.surface_matrix()).all())
    assert float(res.outer.stderr) > 0
