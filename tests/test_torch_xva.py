"""mc_tpu_torch.xva against mc_tpu.xva, and the XVA properties of
tests/test_xva.py on the port's own NMC surfaces, on the CPU.

Tolerance: every ExposureMetrics method on the same numpy-seeded value
matrix agrees with mc_tpu's to rel 1e-5 (atol 1e-6 where an entry is zero
in exact arithmetic): both compute in f32, and only the order of the f32
sums and the quantile's interpolation arithmetic differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_tpu import xva as jxva

import mc_tpu_torch as mt
from mc_tpu_torch import xva

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N_PATHS, N_STEPS = 2048, 8
SIM = mt.SimParams(n_paths=2048, n_steps=8, n_paths_inner=32)


def _values():
    rs = np.random.default_rng(2024)
    drift = np.linspace(0.5, 2.0, N_STEPS, dtype=np.float32)
    return (drift + 4.0 * rs.standard_normal((N_PATHS, N_STEPS))).astype(
        np.float32)


@pytest.fixture(scope="module", params=["uniform", "coupon_dates"])
def pair(request):
    v = _values()
    if request.param == "uniform":
        return (xva.CollateralizedExposure(values=torch.from_numpy(v),
                                           t_horizon=1.0),
                jxva.CollateralizedExposure(values=jnp.asarray(v),
                                            t_horizon=1.0))
    # non-uniform dates: expiry 0.5 then a 0.25 tenor (obs_dates wins)
    return (xva.CollateralizedExposure(
                values=torch.from_numpy(v), t_horizon=1.0,
                obs_dates=xva.coupon_dates(0.5, 0.25, N_STEPS)),
            jxva.CollateralizedExposure(
                values=jnp.asarray(v), t_horizon=1.0,
                obs_dates=jxva.coupon_dates(0.5, 0.25, N_STEPS)))


CALLS = {
    "observation_dates": lambda r: r.observation_dates(),
    "observation_dates_t2": lambda r: r.observation_dates(2.0),
    "exposure_profile": lambda r: r.exposure_profile(),
    "exposure_profile_q90": lambda r: r.exposure_profile(0.9),
    "ene_profile": lambda r: r.ene_profile(0.95),
    "cva": lambda r: r.cva(0.02),
    "cva_t2": lambda r: r.cva(0.02, 0.3, t_horizon=2.0),
    "dva": lambda r: r.dva(0.03),
    "bilateral_cva": lambda r: r.bilateral_cva(0.02, 0.03, 0.4, 0.35),
    "fva": lambda r: r.fva(0.01),
    "cva_wwr_up": lambda r: r.cva_wwr(0.02, 0.05),
    "cva_wwr_down": lambda r: r.cva_wwr(0.02, -0.05, 0.3),
    "im_profile": lambda r: r.im_profile(0.99, 2),
    "im_profile_mpor_all": lambda r: r.im_profile(0.9, 50),
    "mva": lambda r: r.mva(0.01, 0.99, 2),
    "collateralized": lambda r: r.collateralized(1.0, own_threshold=0.5,
                                                 mta=0.2, mpor_steps=2
                                                 ).surface_matrix(),
    "collateralized_instant": lambda r: r.collateralized().surface_matrix(),
    "collateralized_cva": lambda r: r.collateralized(
        0.5, mta=0.1, mpor_steps=1).cva(0.02),
    "collateralized_dates": lambda r: r.collateralized(
        mpor_steps=100).observation_dates(),
}


def _np(x):
    if isinstance(x, tuple):
        return [_np(a) for a in x]
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("name", list(CALLS))
def test_metric_matches_mc_tpu(pair, name):
    got, want = (_np(CALLS[name](r)) for r in pair)
    if not isinstance(got, list):
        got, want = [got], [want]
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w)
        assert np.asarray(g).dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_coupon_dates_match_mc_tpu():
    np.testing.assert_array_equal(xva.coupon_dates(1.0, 0.5, 7).numpy(),
                                  np.asarray(jxva.coupon_dates(1.0, 0.5, 7)))


def test_quantile_refuses_above_torch_limit(monkeypatch):
    monkeypatch.setattr(xva, "QUANTILE_MAX_ELEMS", N_PATHS * N_STEPS - 1)
    res = xva.CollateralizedExposure(values=torch.from_numpy(_values()),
                                     t_horizon=1.0)
    with pytest.raises(ValueError, match="2\\^24"):
        res.exposure_profile()


# --- properties on the port's own surfaces (tests/test_xva.py) -------------


@pytest.fixture(scope="module")
def res():
    # vanilla_call: the default bullet pays nothing at 8 steps
    return mt.price_nmc(mt.OptionParams(), SIM, "vanilla_call", device="cpu")


def test_long_call_has_no_negative_exposure(res):
    ene, _ = res.ene_profile()
    assert float(ene.max()) == 0.0
    assert float(res.dva(0.02)) == 0.0
    assert float(res.bilateral_cva(0.02, 0.03)) == pytest.approx(
        float(res.cva(0.02)))


def test_fva_hand_integral(res):
    ee, _ = res.exposure_profile()
    fca, fba = res.fva(0.01)
    assert float(fca) == pytest.approx(
        0.01 * float(ee.double().sum()) / SIM.n_steps, rel=1e-6)
    assert float(fba) == 0.0


def test_full_collateralization_kills_exposure(res):
    c = res.collateralized(threshold=0.0, mta=0.0, mpor_steps=0)
    ee, _ = c.exposure_profile()
    assert float(ee.max()) == 0.0
    assert float(c.cva(0.02)) == 0.0


def test_infinite_threshold_is_uncollateralized(res):
    c = res.collateralized(threshold=1e9)
    assert float(c.cva(0.02)) == pytest.approx(float(res.cva(0.02)),
                                               rel=1e-6)


def test_mpor_between_extremes_and_threshold_monotone(res):
    cva_un = float(res.cva(0.02))
    cva_mpor = float(res.collateralized(0.0, mpor_steps=2).cva(0.02))
    assert 0.0 <= cva_mpor <= cva_un
    prev = cva_mpor
    for h in (1.0, 5.0, 20.0):
        cur = float(res.collateralized(h, mpor_steps=2).cva(0.02))
        assert cur >= prev - 1e-7
        prev = cur
    # the first mpor dates are uncollateralized
    c = res.collateralized(0.0, mpor_steps=2)
    raw = torch.clamp(res.surface_matrix(), min=0.0)
    col = torch.clamp(c.surface_matrix(), min=0.0)
    assert torch.equal(col[:, :2], raw[:, :2])


def test_mta_stub_survives(res):
    mta = 3.0
    c = res.collateralized(0.0, mta=mta, mpor_steps=0)
    assert float(c.surface_matrix().max()) <= mta + 1e-5
    assert float(c.cva(0.02)) <= float(res.cva(0.02))


def test_validation(res):
    with pytest.raises(ValueError, match="mpor_steps"):
        res.collateralized(mpor_steps=-1)
    with pytest.raises(ValueError, match="mta"):
        res.collateralized(mta=-1.0)


def test_cva_wwr_spot_sign_flips_with_position():
    """Spot-linked WWR: beta > 0 raises a long call's CVA and lowers a long
    put's; the exposure link raises both."""
    sim = mt.SimParams(n_paths=2048, n_steps=8, n_paths_inner=16)
    call = mt.price_nmc(mt.OptionParams(), sim, "vanilla_call",
                        strategy="grid", device="cpu")
    put = mt.price_nmc(mt.OptionParams(), sim, "vanilla_put",
                       strategy="grid", device="cpu")
    for r in (call, put):
        assert float(r.cva_wwr_spot(0.02, 0.0)) == pytest.approx(
            float(r.cva(0.02)), rel=1e-4)
    assert float(call.cva_wwr_spot(0.02, 2.0)) > float(call.cva(0.02))
    assert float(put.cva_wwr_spot(0.02, 2.0)) < float(put.cva(0.02))
    assert float(put.cva_wwr(0.02, 2.0)) > float(put.cva(0.02))


def test_cva_wwr_spot_needs_the_grid_strategy(res):
    with pytest.raises(ValueError, match="grid"):
        res.cva_wwr_spot(0.02, 1.0)


def test_mpor_beyond_horizon_is_uncollateralized(res):
    c = res.collateralized(0.0, mpor_steps=100)
    assert float(c.cva(0.02)) == pytest.approx(float(res.cva(0.02)),
                                               rel=1e-6)


def test_im_profile_and_mva(res):
    im = res.im_profile(0.99, mpor_steps=2).numpy()
    assert im.shape == (SIM.n_steps,)
    assert np.all(im >= 0.0)
    assert im[-1] == im[-2] == im[-3]  # the last 2 padded with the final value
    mva = float(res.mva(0.01, 0.99, mpor_steps=2))
    assert mva == pytest.approx(0.01 * float(np.sum(im)) / SIM.n_steps,
                                rel=1e-6)
    with pytest.raises(ValueError, match="mpor_steps"):
        res.im_profile(mpor_steps=0)


def test_im_zero_for_constant_surface():
    flat = xva.CollateralizedExposure(values=torch.ones((64, 8)),
                                      t_horizon=1.0)
    assert float(flat.im_profile(0.99, 2).max()) == 0.0
    assert float(flat.mva(0.01)) == 0.0


def test_cva_wwr_brackets_flat_hazard(res):
    flat = float(res.cva(0.02))
    w0 = float(res.cva_wwr(0.02, beta=0.0))
    up = float(res.cva_wwr(0.02, beta=0.05))
    dn = float(res.cva_wwr(0.02, beta=-0.05))
    assert w0 == pytest.approx(flat, rel=1e-5)
    assert up > w0 > dn
