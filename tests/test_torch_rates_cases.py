"""The European cases of mc_tpu's rates tests, on mc_tpu_torch's plain
versions (device="cpu"), at their sizes and against their oracles (the
port's own copies in ``mc_tpu_torch.oracle``):

* tests/test_swaption.py:27, :33, :40, :96, :103 (its European part);
* tests/test_hullwhite.py:24, :40, :47, :56, :116, :246, :255 (its
  European part, with the zero-basis multi-curve == single-curve check at
  2e-5) and :449;
* tests/test_g2pp.py:25, :36, :46, :59, :66, :220, :230 (its European
  part);
* the five cases of tests/test_rates_fused.py: the port has one route, so
  "the engines agree" becomes the port against mc_tpu's fused route
  (engine="xla") within tests/test_torch_rates.py's PRICE_RTOL, beside the
  same oracle gates.
"""

import math

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import g2pp as jg2
from mc_tpu.models import hullwhite as jhw
from mc_tpu.models import swaption as jsw

from mc_tpu_torch import oracle, rng
from mc_tpu_torch.config import SimParams
from mc_tpu_torch.models.g2pp import DEMO_G2, G2Dynamics, price_g2_swaption
from mc_tpu_torch.models.hullwhite import (DEMO_CURVE, DEMO_HW,
                                           DiscountCurve, HullWhiteDynamics,
                                           price_hw_swaption)
from mc_tpu_torch.models.swaption import SwaptionSpec, price_swaption
from mc_tpu_torch.models.vasicek import VasicekDynamics
from mc_tpu_torch.ops.fused import packed_length

torch.set_num_threads(1)

PRICE_RTOL = 5e-7  # tests/test_torch_rates.py

# tests/test_swaption.py
DYN = VasicekDynamics(a=0.3, b=0.05, sigma_r=0.015)
VA_SPEC = SwaptionSpec(expiry=1.0, tenor=0.5, n_payments=10, k_rate=0.05)
R0 = 0.05
SIM19 = SimParams(n_paths=1 << 19, n_steps=1)
# tests/test_hullwhite.py, tests/test_g2pp.py, tests/test_rates_fused.py
SPEC = SwaptionSpec(expiry=1.0, tenor=0.5, n_payments=10, k_rate=0.04)
SIM16 = SimParams(n_paths=1 << 16, n_steps=1)
PROJ = DiscountCurve(DEMO_CURVE.times, np.asarray(DEMO_CURVE.zeros) + 0.0025)


def _z(res, ref):
    return (float(res.price) - ref) / max(float(res.stderr), 1e-9)


def _va_ref(spec, payer=True):
    return oracle.vasicek_swaption(R0, DYN.a, DYN.b, DYN.sigma_r,
                                   spec.expiry, spec.tenor, spec.n_payments,
                                   spec.k_rate, payer=payer)


def _hw_ref(spec, payer=True):
    return oracle.hw_swaption(DEMO_HW.a, DEMO_HW.sigma_r, DEMO_CURVE.df,
                              spec.expiry, spec.tenor, spec.n_payments,
                              spec.k_rate, payer=payer)


def _g2_ref(spec, payer=True, dyn=DEMO_G2):
    return oracle.g2_swaption(dyn.a, dyn.sigma, dyn.b_mr, dyn.eta, dyn.rho,
                              DEMO_CURVE.df, spec.expiry, spec.tenor,
                              spec.n_payments, spec.k_rate, payer=payer)


# --- tests/test_swaption.py -------------------------------------------------


def test_swaption_payer_matches_jamshidian():
    r = price_swaption(VA_SPEC, DYN, SIM19, r0=R0, device="cpu")
    assert abs(_z(r, _va_ref(VA_SPEC))) < 4.0


def test_swaption_receiver_matches_jamshidian():
    spec = SwaptionSpec(payer=False)
    r = price_swaption(spec, DYN, SIM19, r0=R0, device="cpu")
    assert abs(_z(r, _va_ref(spec, payer=False))) < 4.0


def test_swaption_moneyness_ladder():
    prev = float("inf")
    for k in (0.02, 0.05, 0.09):
        spec = SwaptionSpec(k_rate=k)
        r = price_swaption(spec, DYN, SIM19, r0=R0, device="cpu")
        assert float(r.price) < prev + 1e-9
        assert abs(_z(r, _va_ref(spec))) < 4.0, k
        prev = float(r.price)


def test_swaption_r0_monotonicity():
    lo = price_swaption(VA_SPEC, DYN, SIM19, r0=0.03, device="cpu")
    hi = price_swaption(VA_SPEC, DYN, SIM19, r0=0.07, device="cpu")
    assert float(hi.price) > float(lo.price)


def test_swaption_validation():
    with pytest.raises(ValueError, match="n_payments"):
        price_swaption(SwaptionSpec(n_payments=0), device="cpu")
    with pytest.raises(ValueError, match="expiry/tenor"):
        price_swaption(SwaptionSpec(tenor=-1.0), device="cpu")


# --- tests/test_hullwhite.py ------------------------------------------------


def test_hw_oracle_equals_vasicek_on_the_vasicek_curve():
    a, b, sig, r0 = 0.3, 0.05, 0.015, 0.05
    df = lambda t: oracle.vasicek_zcb(r0, a, b, sig, t) if t > 0 else 1.0
    for (t0, tau, n, k) in ((1.0, 0.5, 10, 0.05), (2.0, 0.25, 8, 0.06)):
        for payer in (True, False):
            hw = oracle.hw_swaption(a, sig, df, t0, tau, n, k, payer=payer)
            va = oracle.vasicek_swaption(r0, a, b, sig, t0, tau, n, k,
                                         payer=payer)
            assert hw == pytest.approx(va, rel=1e-12)


def test_hw_mc_matches_jamshidian_on_the_sloped_curve():
    r = price_hw_swaption(SPEC, DEMO_HW, DEMO_CURVE, SIM19, device="cpu")
    assert abs(_z(r, _hw_ref(SPEC))) < 4.0


def test_hw_receiver_matches_oracle():
    spec = SwaptionSpec(expiry=1.0, tenor=0.5, n_payments=10, k_rate=0.04,
                        payer=False)
    r = price_hw_swaption(spec, DEMO_HW, DEMO_CURVE, SIM19, device="cpu")
    assert abs(_z(r, _hw_ref(spec, payer=False))) < 4.0


def test_hw_sigma_zero_is_the_curve_intrinsic():
    dyn0 = HullWhiteDynamics(a=0.3, sigma_r=1e-7)
    r = price_hw_swaption(SPEC, dyn0, DEMO_CURVE,
                          SimParams(n_paths=4096, n_steps=1), device="cpu")
    dfs = [DEMO_CURVE.df(1.0 + 0.5 * j) for j in range(11)]
    det = max(dfs[0] - dfs[10] - 0.04 * 0.5 * sum(dfs[1:11]), 0.0)
    assert float(r.price) == pytest.approx(det, abs=2e-6)


def test_hw_curve_validation_and_interp():
    assert DEMO_CURVE.df(0.0) == 1.0
    for t, z in zip(DEMO_CURVE.times, DEMO_CURVE.zeros):
        assert DEMO_CURVE.df(t) == pytest.approx(math.exp(-z * t), rel=1e-12)
    d20 = DiscountCurve.flat(0.05).df(20.0)
    assert d20 == pytest.approx(math.exp(-0.05 * 20.0), rel=1e-12)
    with pytest.raises(ValueError, match="ascending"):
        DiscountCurve([1.0, 1.0], [0.02, 0.02])
    with pytest.raises(ValueError, match="> 0"):
        DiscountCurve([0.0, 1.0], [0.02, 0.02])


def test_hw_dynamics_validation():
    sim = SimParams(n_paths=128, n_steps=1)
    with pytest.raises(ValueError, match="mean reversion"):
        price_hw_swaption(SPEC, HullWhiteDynamics(a=0.0), DEMO_CURVE, sim,
                          device="cpu")
    with pytest.raises(ValueError, match="sigma_r"):
        price_hw_swaption(SPEC, HullWhiteDynamics(sigma_r=-0.1), DEMO_CURVE,
                          sim, device="cpu")


def test_hw_multicurve_oracle_and_mc():
    jam = _hw_ref(SPEC)
    quad0 = oracle.hw_swaption_multicurve(
        DEMO_HW.a, DEMO_HW.sigma_r, DEMO_CURVE.df, DEMO_CURVE.df,
        SPEC.expiry, SPEC.tenor, SPEC.n_payments, SPEC.k_rate)
    assert quad0 == pytest.approx(jam, rel=1e-6)
    ref = oracle.hw_swaption_multicurve(
        DEMO_HW.a, DEMO_HW.sigma_r, DEMO_CURVE.df, PROJ.df, SPEC.expiry,
        SPEC.tenor, SPEC.n_payments, SPEC.k_rate)
    assert ref > jam
    r = price_hw_swaption(SPEC, DEMO_HW, DEMO_CURVE, SIM19,
                          projection_curve=PROJ, device="cpu")
    assert abs(_z(r, ref)) < 4.0
    # zero basis: the multi-curve tile on the single-curve tile's draws
    sim = SimParams(n_paths=1 << 15, n_steps=1)
    r0 = price_hw_swaption(SPEC, DEMO_HW, DEMO_CURVE, sim,
                           projection_curve=DEMO_CURVE, device="cpu")
    r1 = price_hw_swaption(SPEC, DEMO_HW, DEMO_CURVE, sim, device="cpu")
    assert float(r0.price) == pytest.approx(float(r1.price), rel=2e-5)


def test_hw_bootstrap_from_par_swaps_round_trip():
    tenor = 0.5
    mats = np.array([0.5, 1.0, 2.0, 3.0, 5.0])

    def par_rate(curve, t_m):
        n = int(round(t_m / tenor))
        dfs = [curve.df(tenor * j) for j in range(1, n + 1)]
        return (1.0 - dfs[-1]) / (tenor * sum(dfs))

    pars = [par_rate(DEMO_CURVE, m) for m in mats]
    boot = DiscountCurve.from_par_swaps(mats, pars, tenor=tenor)
    for m, s in zip(mats, pars):
        assert par_rate(boot, m) == pytest.approx(s, rel=1e-12)
    for m in mats:
        assert boot.df(m) == pytest.approx(DEMO_CURVE.df(m), rel=5e-4)
    with pytest.raises(ValueError, match="tenor grid"):
        DiscountCurve.from_par_swaps([0.7], [0.03], tenor=0.5)
    with pytest.raises(ValueError, match="ascending"):
        DiscountCurve.from_par_swaps([1.0, 1.0], [0.03, 0.03])


# --- tests/test_g2pp.py -----------------------------------------------------


def test_g2_oracle_degenerates_to_hull_white():
    for (t0, tau, n, k) in ((1.0, 0.5, 10, 0.04), (2.0, 0.25, 8, 0.05)):
        hw = oracle.hw_swaption(0.3, 0.015, DEMO_CURVE.df, t0, tau, n, k)
        g2 = oracle.g2_swaption(0.3, 0.015, 0.5, 1e-9, 0.0, DEMO_CURVE.df,
                                t0, tau, n, k)
        assert g2 == pytest.approx(hw, rel=5e-6), (t0, g2, hw)


def test_g2_oracle_payer_receiver_parity_is_exact():
    g2p = _g2_ref(SPEC)
    g2r = _g2_ref(SPEC, payer=False)
    dfs = [DEMO_CURVE.df(1.0 + 0.5 * j) for j in range(11)]
    swap = dfs[0] - dfs[10] - 0.04 * 0.5 * sum(dfs[1:11])
    assert g2p - g2r == pytest.approx(swap, abs=1e-12)


def test_g2_second_factor_adds_value():
    base = oracle.g2_swaption(DEMO_G2.a, DEMO_G2.sigma, DEMO_G2.b_mr, 1e-9,
                              0.0, DEMO_CURVE.df, 1.0, 0.5, 10, 0.045)
    two = oracle.g2_swaption(DEMO_G2.a, DEMO_G2.sigma, DEMO_G2.b_mr,
                             DEMO_G2.eta, 0.0, DEMO_CURVE.df, 1.0, 0.5, 10,
                             0.045)
    assert two > base


def test_g2_mc_matches_the_oracle():
    r = price_g2_swaption(SPEC, DEMO_G2, DEMO_CURVE, SIM19, device="cpu")
    assert abs(_z(r, _g2_ref(SPEC))) < 4.0


def test_g2_receiver_mc_matches_the_oracle():
    spec = SwaptionSpec(expiry=1.0, tenor=0.5, n_payments=10, k_rate=0.04,
                        payer=False)
    r = price_g2_swaption(spec, DEMO_G2, DEMO_CURVE, SIM19, device="cpu")
    assert abs(_z(r, _g2_ref(spec, payer=False))) < 4.0


def test_g2_dynamics_validation():
    sim = SimParams(n_paths=128, n_steps=1)
    with pytest.raises(ValueError, match="mean reversions"):
        price_g2_swaption(SPEC, G2Dynamics(a=-0.1), DEMO_CURVE, sim,
                          device="cpu")
    with pytest.raises(ValueError, match="vols"):
        price_g2_swaption(SPEC, G2Dynamics(eta=-0.1), DEMO_CURVE, sim,
                          device="cpu")
    with pytest.raises(ValueError, match="rho"):
        price_g2_swaption(SPEC, G2Dynamics(rho=-1.5), DEMO_CURVE, sim,
                          device="cpu")


def test_g2_multicurve_two_factor():
    one = _g2_ref(SPEC)
    args = (DEMO_G2.a, DEMO_G2.sigma, DEMO_G2.b_mr, DEMO_G2.eta, DEMO_G2.rho)
    quad0 = oracle.g2_swaption_multicurve(
        *args, DEMO_CURVE.df, DEMO_CURVE.df, SPEC.expiry, SPEC.tenor,
        SPEC.n_payments, SPEC.k_rate)
    assert quad0 == pytest.approx(one, rel=1e-6)
    ref = oracle.g2_swaption_multicurve(
        *args, DEMO_CURVE.df, PROJ.df, SPEC.expiry, SPEC.tenor,
        SPEC.n_payments, SPEC.k_rate)
    assert ref > one
    r = price_g2_swaption(SPEC, DEMO_G2, DEMO_CURVE, SIM19,
                          projection_curve=PROJ, device="cpu")
    assert abs(_z(r, ref)) < 4.0


# --- tests/test_rates_fused.py ----------------------------------------------


def _near_mc_tpus_fused(got, want):
    assert float(got.price) == pytest.approx(float(want.price),
                                             rel=PRICE_RTOL, abs=1e-9)


@pytest.mark.parametrize("payer", [True, False], ids=["payer", "receiver"])
def test_hw_one_route_matches_fused_and_oracle(payer):
    spec = SwaptionSpec(expiry=1.0, tenor=0.5, n_payments=10, k_rate=0.04,
                        payer=payer)
    r = price_hw_swaption(spec, DEMO_HW, DEMO_CURVE, SIM16, device="cpu")
    want = jhw.price_hw_swaption(
        jsw.SwaptionSpec(k_rate=0.04, payer=payer), jhw.DEMO_HW,
        jhw.DEMO_CURVE, mc_tpu.SimParams(n_paths=1 << 16, n_steps=1),
        engine="xla")
    _near_mc_tpus_fused(r, want)
    assert abs(float(r.price) - _hw_ref(spec, payer)) < 4.0 * float(r.stderr)


def test_g2_one_route_matches_fused_and_oracle():
    r = price_g2_swaption(SPEC, DEMO_G2, DEMO_CURVE, SIM16, device="cpu")
    want = jg2.price_g2_swaption(
        jsw.SwaptionSpec(k_rate=0.04), jg2.DEMO_G2, jhw.DEMO_CURVE,
        mc_tpu.SimParams(n_paths=1 << 16, n_steps=1), engine="xla")
    _near_mc_tpus_fused(r, want)
    assert abs(float(r.price) - _g2_ref(SPEC)) < 4.0 * float(r.stderr)


@pytest.mark.parametrize("model", ["va", "hw", "g2"])
def test_overhang_masks_the_last_block(model):
    """At 100,001 paths the last block is part full: the price is the mean
    of the first 100,001 paths' payoffs, and mc_tpu's fused route's."""
    from mc_tpu_torch.models import g2pp, hullwhite, swaption

    n = 100_001
    sim = SimParams(n_paths=n, n_steps=1)
    jsim = mc_tpu.SimParams(n_paths=n, n_steps=1)
    js = jsw.SwaptionSpec(k_rate=0.04)
    if model == "va":
        r = price_swaption(SPEC, DYN, sim, r0=R0, device="cpu")
        want = jsw.price_swaption(js, sim=jsim, r0=R0, engine="xla")
        pv = swaption.pack_va_swpt(SPEC, DYN.a, DYN.b, DYN.sigma_r, R0)
        pay, tag = swaption.va_swpt_pay, 0x5A97
    elif model == "hw":
        r = price_hw_swaption(SPEC, sim=sim, device="cpu")
        want = jhw.price_hw_swaption(js, sim=jsim, engine="xla")
        pv = hullwhite.pack_hw_swpt(DEMO_HW.a, DEMO_HW.sigma_r, SPEC,
                                    *hullwhite.hw_tables(SPEC, DEMO_HW,
                                                         DEMO_CURVE))
        pay, tag = hullwhite.hw_swpt_pay, 0x4877
    else:
        r = price_g2_swaption(SPEC, sim=sim, device="cpu")
        want = jg2.price_g2_swaption(js, sim=jsim, engine="xla")
        pv = g2pp.pack_g2_swpt(SPEC, DEMO_G2, g2pp.g2_tables(SPEC, DEMO_G2,
                                                             DEMO_CURVE))
        pay, tag = g2pp.g2_swpt_pay, 0x6270
    k0, k1 = (int(k) for k in rng.derive_key(1234, 0, tag))
    direct = pay(10, pv, torch.arange(n, dtype=torch.int64), k0, k1)
    assert float(r.price) == pytest.approx(float(direct.double().mean()),
                                           rel=1e-12)
    _near_mc_tpus_fused(r, want)


def test_tpu_engine_arguments_raise_and_multicurve_needs_none():
    with pytest.raises(TypeError):
        price_hw_swaption(SPEC, sim=SIM16, engine="cuda", device="cpu")
    with pytest.raises(TypeError):
        price_g2_swaption(SPEC, sim=SIM16, engine="cuda", device="cpu")
    r = price_hw_swaption(SPEC, sim=SimParams(n_paths=4096, n_steps=1),
                          projection_curve=PROJ, device="cpu")
    assert float(r.price) > 0.0 and packed_length("hw_mc", 10) == 48


def test_vasicek_one_route_matches_fused_classic_and_oracle():
    spec = SwaptionSpec(expiry=1.0, tenor=0.5, n_payments=10, k_rate=0.04)
    r = price_swaption(spec, DYN, SIM16, r0=0.05, device="cpu")
    jspec = jsw.SwaptionSpec(k_rate=0.04)
    jsim = mc_tpu.SimParams(n_paths=1 << 16, n_steps=1)
    for engine in ("xla", None):
        _near_mc_tpus_fused(r, jsw.price_swaption(jspec, sim=jsim, r0=0.05,
                                                  engine=engine))
    ref = oracle.vasicek_swaption(0.05, DYN.a, DYN.b, DYN.sigma_r,
                                  spec.expiry, spec.tenor, spec.n_payments,
                                  spec.k_rate)
    assert abs(float(r.price) - ref) < 4.0 * float(r.stderr)
    with pytest.raises(TypeError):
        price_swaption(spec, DYN, SIM16, engine="cuda", device="cpu")
