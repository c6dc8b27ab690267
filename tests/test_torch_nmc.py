"""mc_tpu_torch's fused nested MC against mc_tpu on the CPU.

The port runs nmc_fused's plain PyTorch version here; mc_tpu runs its
engine="xla" dual (bitwise equal to its fused Pallas kernel).

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
    with pytest.raises(NotImplementedError, match="grid"):
        mt.price_nmc(OPT, SIM, strategy="grid", device="cpu")
    with pytest.raises(ValueError, match="discount"):
        mt.price_nmc(OPT, SIM, discount="half", device="cpu")
