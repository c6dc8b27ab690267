"""mc_tpu_torch's nested MC (fused and grid strategies) against mc_tpu on
the CPU.

The port runs its kernels' plain PyTorch versions here; mc_tpu runs its
engine="xla" dual (bitwise equal to its fused Pallas kernel) or its grid
strategy's Pallas kernels in interpret mode.

Tolerances (parity contract): a barrier count can flip where an inner S
lands within an ulp of B, so the surface is held to rtol = atol = 1e-4 on
at least 99.9% of points, its mean to 1e-4 relative, and the outer price
to 0.05 stderr.
"""

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.nmc import price_nmc as jprice_nmc

import mc_tpu_torch as mt
from mc_tpu_torch import convert
from mc_tpu_torch.ops import nmc_kernels as nk
from mc_tpu_torch.ops.payoffs import get_payoff

torch.set_num_threads(1)

# Tiny but live config: barrier window reachable within 8 steps.
J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
J_SIM = mc_tpu.SimParams(n_paths=256, n_steps=8, n_paths_inner=16)
OPT = convert.option_params(J_OPT)
SIM = convert.sim_params(J_SIM)
SURF_TOL, SURF_FRAC, MEAN_RTOL, OUTER_SE = 1e-4, 0.999, 1e-4, 0.05


def _assert_surfaces_agree(got, want, n_paths):
    g = got.surface_matrix().numpy()
    w = convert.surface_matrix(want.surface, n_paths)
    assert g.shape == w.shape
    close = np.isclose(g, w, rtol=SURF_TOL, atol=SURF_TOL)
    assert close.mean() >= SURF_FRAC, close.mean()
    assert float(got.surface_mean) == pytest.approx(
        float(want.surface_mean), rel=MEAN_RTOL)
    assert abs(float(got.outer.price) - float(want.outer.price)) <= (
        OUTER_SE * float(want.outer.stderr))


@pytest.fixture(scope="module")
def both():
    return (mt.price_nmc(OPT, SIM, device="cpu"),
            jprice_nmc(J_OPT, J_SIM, engine="xla"))


def test_surface_shape(both):
    got, _ = both
    assert tuple(got.surface.shape) == (SIM.n_steps, SIM.n_paths)
    assert tuple(got.surface_matrix().shape) == (SIM.n_paths, SIM.n_steps)
    assert got.surface.dtype == torch.float32
    assert got.n_points == SIM.n_paths * SIM.n_steps


def test_surface_matches_mc_tpu(both):
    got, want = both
    _assert_surfaces_agree(got, want, SIM.n_paths)


@pytest.mark.parametrize("payoff,discount,n_steps", [
    ("vanilla_call", "remaining", 8),
    ("bullet_call", "full", 7),     # odd step count: odd remaining at even j
    ("vanilla_put", "full", 5),
])
def test_nmc_fused_variants_match_mc_tpu(payoff, discount, n_steps):
    jsim = mc_tpu.SimParams(n_paths=200, n_steps=n_steps, n_paths_inner=8,
                            seed=77)
    got = mt.price_nmc(OPT, convert.sim_params(jsim), payoff,
                       discount=discount, device="cpu")
    want = jprice_nmc(J_OPT, jsim, payoff, engine="xla", discount=discount)
    _assert_surfaces_agree(got, want, jsim.n_paths)


def test_last_step_is_deterministic_payoff(both):
    """remaining=0 at the last step: every inner path IS the stored state,
    so surface[last] equals e^{-rT} * payoff(S_T, count_T) of the outer
    path — here the outer path of mc_tpu's trajectory kernel."""
    got, _ = both
    traj = mc_tpu.simulate_trajectories(J_OPT, J_SIM, payoff="bullet_call",
                                        tile_rows=8)
    s_t = np.asarray(traj.path_matrix())[:, -1]
    count = np.asarray(traj.state_matrix())[:, -1]
    in_window = (count >= 1.0) & (count <= 6.0)
    pay = np.where(in_window, np.maximum(s_t - 100.0, 0.0), 0.0)
    want = np.float32(np.exp(np.float32(-0.1))) * pay.astype(np.float32)
    np.testing.assert_allclose(got.surface_matrix().numpy()[:, -1], want,
                               rtol=1e-5)


def test_outer_is_the_plain_bullet_price(both):
    """The outer paths are price()'s bullet paths on the same key."""
    got, _ = both
    plain = mt.price(OPT, SIM, "bullet_call", device="cpu")
    assert float(got.outer.price) == pytest.approx(float(plain.price),
                                                   rel=1e-12)
    assert float(got.outer.stderr) == pytest.approx(float(plain.stderr),
                                                    rel=1e-12)


def test_tower_property(both):
    """E[surface[:, j]] == outer price for every j (tower property under the
    full-T discount); inner noise adds variance, hence the 5-se band."""
    got, _ = both
    surf = got.surface_matrix().numpy()
    outer, se = float(got.outer.price), float(got.outer.stderr)
    for j in range(SIM.n_steps):
        col = surf[:, j].mean()
        assert abs(col - outer) < 5.0 * se + 0.05 * outer, (j, col, outer)


def test_counter_span_guard_and_refusals():
    with pytest.raises(ValueError, match="counter space"):
        nk.NMCConfig(n_paths=8, n_steps=4096, n_inner=1024)
    with pytest.raises(ValueError, match="hardware PRNG"):
        mt.price_nmc(OPT, SIM, rng_source="hw", device="cpu")
    with pytest.raises(ValueError, match="unknown strategy"):
        mt.price_nmc(OPT, SIM, strategy="split", device="cpu")
    with pytest.raises(ValueError, match="discount"):
        mt.price_nmc(OPT, SIM, discount="half", device="cpu")


# --- the grid strategy -----------------------------------------------------


@pytest.fixture(scope="module")
def grid():
    return mt.price_nmc(OPT, SIM, strategy="grid", device="cpu")


def test_grid_strategy_runs_and_equals_fused_bitwise(both, grid):
    """The port's form of tests/test_nmc.py::test_strategies_bitwise_identical:
    the inner kernel over stored trajectories gives the fused surface."""
    fused, _ = both
    assert torch.equal(grid.surface, fused.surface)
    assert float(grid.outer.price) == float(fused.outer.price)
    assert float(grid.surface_mean) == float(fused.surface_mean)


@pytest.mark.parametrize("payoff,discount,n_steps", [
    ("bullet_call", "full", 8),
    ("vanilla_put", "remaining", 7),
])
def test_grid_matches_mc_tpu_grid(payoff, discount, n_steps):
    jsim = mc_tpu.SimParams(n_paths=256, n_steps=n_steps, n_paths_inner=16)
    got = mt.price_nmc(OPT, convert.sim_params(jsim), payoff,
                       strategy="grid", discount=discount, device="cpu")
    want = jprice_nmc(J_OPT, jsim, payoff, strategy="grid",
                      discount=discount)
    _assert_surfaces_agree(got, want, jsim.n_paths)
    np.testing.assert_allclose(
        got.spot_matrix().numpy(),
        convert.surface_matrix(want.spot_surface, jsim.n_paths), rtol=2e-6)


def test_spot_matrix_is_the_trajectory_grid(grid):
    traj = mt.simulate_trajectories(OPT, SIM, device="cpu")
    assert torch.equal(grid.spot_matrix(), traj.path_matrix())
    assert tuple(grid.spot_matrix().shape) == (SIM.n_paths, SIM.n_steps)


def test_spot_matrix_needs_the_grid_strategy(both):
    fused, _ = both
    assert fused.spot_surface is None
    with pytest.raises(ValueError, match="strategy='grid'"):
        fused.spot_matrix()
    with pytest.raises(ValueError, match="strategy='grid'"):
        fused.cva_wwr_spot(0.02, 1.0)


def test_t_horizon_is_the_maturity(grid):
    assert grid.t_horizon == OPT.t
    res = mt.price_nmc(mt.OptionParams(t=2.0, p1=1.0, p2=6.0),
                       SIM.replace(n_paths=64), device="cpu")
    assert res.t_horizon == 2.0
    np.testing.assert_allclose(res.observation_dates().numpy(),
                               np.arange(1, 9) * 0.25, rtol=1e-7)


def test_inner_kernel_guards():
    cfg = nk.NMCConfig(n_paths=8, n_steps=4, n_inner=2)
    prm = mt.engines.pk.pack_params(OPT, 4)
    good = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="s_grid"):
        nk.nmc_inner(get_payoff("bullet_call"), cfg, (1, 2), prm,
                     torch.zeros((4, 7)), good)
    with pytest.raises(ValueError, match="c_grid"):
        nk.nmc_inner(get_payoff("bullet_call"), cfg, (1, 2), prm, good,
                     good.double())


# --- every payoff with at most one state word ---------------------------------

ONE_WORD = ["digital_call", "digital_put", "best_of_cash", "zcb",
            "asian_call", "up_out_call", "down_out_call", "down_in_call",
            "lookback_call"]


def _live_option(payoff):
    return mc_tpu.OptionParams(p1=1.0, p2=6.0, barrier=90.0
                               if payoff.startswith("down") else 120.0)


@pytest.mark.parametrize("payoff", ONE_WORD)
def test_one_word_payoffs_grid_equals_fused_bitwise(payoff):
    opt = convert.option_params(_live_option(payoff))
    sim = mt.SimParams(n_paths=128, n_steps=6, n_paths_inner=8)
    fused = mt.price_nmc(opt, sim, payoff, device="cpu")
    grid = mt.price_nmc(opt, sim, payoff, strategy="grid", device="cpu")
    assert torch.equal(grid.surface, fused.surface)
    assert float(grid.outer.price) == float(fused.outer.price)
    assert bool(torch.isfinite(fused.surface).all())


@pytest.mark.parametrize("payoff", ["asian_call", "down_out_call",
                                    "lookback_call", "digital_call"])
def test_one_word_payoffs_match_mc_tpu(payoff):
    jopt = _live_option(payoff)
    jsim = mc_tpu.SimParams(n_paths=256, n_steps=7, n_paths_inner=16,
                            seed=5)
    got = mt.price_nmc(convert.option_params(jopt), convert.sim_params(jsim),
                       payoff, device="cpu")
    want = jprice_nmc(jopt, jsim, payoff, engine="xla")
    _assert_surfaces_agree(got, want, jsim.n_paths)


def test_nmc_refuses_multi_word_payoffs():
    with pytest.raises(ValueError, match="at most one state array"):
        mt.price_nmc(OPT, SIM, "variance_swap", device="cpu")
