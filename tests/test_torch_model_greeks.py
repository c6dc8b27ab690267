"""The family greeks (merton_, sabr_, heston_, vasicek_greeks) on the CPU:
the cases of tests/test_model_greeks.py against their oracles, each greek
against mc_tpu's on the same key, and each against its two prices.

On the CPU each greek differences two plain prices of its family (the
kernels' plain versions); mc_tpu differences two prices of its XLA dual on
the same threefry stream and the same f32 bump.

Tolerances:
* against the oracles: tests/test_model_greeks.py's;
* against mc_tpu: the two sides' prices differ by the parity contract's
  few-ulp normals (~1e-7 relative, which the common random numbers carry
  into the difference as ~1e-6 of the greek), and mc_tpu rounds each price
  to f32 before it differences them.  So 1e-4 relative plus 8 f32 roundings
  of the price over the bump, 8 * 2^-24 * |P| / h: at sigma_r (h = 1.5e-5)
  that term is 0.5 of a greek of ~4.6 and the whole difference seen
  (0.014); at delta (h = 0.1) it is 7e-5;
* against the greek's own two prices: bitwise.
"""

import importlib

import numpy as np
import pytest
import torch

import mc_tpu

import mc_tpu_torch as mt
from mc_tpu_torch import rng
from mc_tpu_torch import oracle

torch.set_num_threads(1)

jg = importlib.import_module("mc_tpu.greeks")
tg = importlib.import_module("mc_tpu_torch.greeks")

CPU = dict(device="cpu")
SMALL = mt.SimParams(n_paths=4_096, n_steps=10)
EPS32 = 2.0 ** -24

FAMILIES = {
    "merton": (tg.MERTON_GREEK_FIELDS, mt.price_merton, 0x3E44,
               mt.DEMO_MERTON),
    "sabr": (tg.SABR_GREEK_FIELDS, mt.price_sabr, 0x5AB4, mt.DEMO_SABR),
    "heston": (tg.HESTON_GREEK_FIELDS, mt.price_heston, 0x4E57,
               mt.DEMO_HESTON),
    "vasicek": (tg.VASICEK_GREEK_FIELDS, mt.price_vasicek, 0x7A51,
                mt.DEMO_VASICEK),
}


def _bump(tree_obj, field, rel_bump=1e-3):
    base = np.float32(getattr(tree_obj, field))
    return np.float32(rel_bump) * np.maximum(np.abs(base), np.float32(1e-2))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_greek_matches_mc_tpu(family):
    fields, price_fn, _, dyn = FAMILIES[family]
    which = tuple(sorted(fields))
    mine = getattr(tg, f"{family}_greeks")(sim=SMALL, which=which, **CPU)
    ref = getattr(jg, f"{family}_greeks")(
        sim=mc_tpu.SimParams(n_paths=SMALL.n_paths, n_steps=SMALL.n_steps),
        which=which)
    price = abs(float(price_fn(mt.DEMO_OPTION, dyn, SMALL, **CPU).price))
    for g in which:
        tree, fld, _ = fields[g]
        h = float(_bump(mt.DEMO_OPTION if tree == "option" else dyn, fld))
        tol = 1e-4 * abs(float(ref[g])) + 8 * EPS32 * price / h
        assert abs(float(mine[g]) - float(ref[g])) <= tol, (
            g, float(mine[g]), float(ref[g]), tol)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_greek_is_its_two_prices(family):
    """delta and a dynamics greek are bitwise sign * (up - dn) / (2h) of two
    direct price_<family> calls on the family's key, the bump f32."""
    fields, price_fn, tag, dyn = FAMILIES[family]
    key = tuple(int(k) for k in rng.derive_key(SMALL.seed, 0, tag))
    dyn_greek = next(g for g in sorted(fields) if fields[g][0] != "option")
    g = getattr(tg, f"{family}_greeks")(sim=SMALL,
                                        which=("delta", dyn_greek), **CPU)
    kw = dict(method="euler") if family == "merton" else {}
    for name in ("delta", dyn_greek):
        tree, fld, sgn = fields[name]
        obj = mt.DEMO_OPTION if tree == "option" else dyn.as_f32()
        base = np.float32(getattr(obj, fld))
        h = _bump(obj, fld)
        prices = []
        for x in (base + h, base - h):
            bumped = mt.OptionParams(**{**mt.DEMO_OPTION.__dict__,
                                        fld: float(x)}) \
                if tree == "option" else type(obj)(
                    **{**obj.__dict__, fld: float(x)})
            opt, d = ((bumped, dyn.as_f32()) if tree == "option"
                      else (mt.DEMO_OPTION, bumped))
            prices.append(price_fn(opt, d, SMALL, key=key, **kw,
                                   **CPU).price)
        want = sgn * (prices[0] - prices[1]) / (2.0 * float(h))
        assert float(g[name]) == float(want), name


def test_unknown_greeks_refused():
    with pytest.raises(ValueError, match="unknown greeks"):
        tg.merton_greeks(which=("charm",), **CPU)
    with pytest.raises(ValueError, match="unknown greeks"):
        tg.sabr_greeks(which=("vega",), **CPU)
    with pytest.raises(ValueError, match="unknown heston greeks"):
        tg.heston_greeks(which=("vanna",), **CPU)
    with pytest.raises(ValueError, match="unknown greeks"):
        tg.vasicek_greeks(which=("vanna",), **CPU)


def _oracle_fd(fn, base, field, h):
    up, dn = dict(base), dict(base)
    up[field] += h
    dn[field] -= h
    return (fn(**up) - fn(**dn)) / (2 * h)


def test_merton_market_and_jump_sens_vs_series_oracle():
    """tests/test_model_greeks.py at its 200,000 x 50, antithetic."""
    g = tg.merton_greeks(sim=mt.SimParams(n_paths=200_000, n_steps=50),
                         antithetic=True,
                         which=("delta", "vega", "lam_sens", "sigma_j_sens"),
                         **CPU)
    base = dict(s0=100.0, k=100.0, t=1.0, r=0.1, sigma=0.2, lam=0.3,
                mu_j=-0.10, sigma_j=0.15)
    for name, field in (("delta", "s0"), ("vega", "sigma"),
                        ("lam_sens", "lam"), ("sigma_j_sens", "sigma_j")):
        want = _oracle_fd(mt.merton_call_closed_form, base, field,
                          1e-3 if field != "s0" else 0.1)
        assert float(g[name]) == pytest.approx(want, rel=0.1, abs=0.02), (
            name, float(g[name]), want)


def test_sabr_calibration_sens_vs_hagan():
    g = tg.sabr_greeks(sim=mt.SimParams(n_paths=200_000, n_steps=50),
                       antithetic=True,
                       which=("delta", "alpha_sens", "nu_sens",
                              "rho_fv_sens"), **CPU)
    base = dict(s0=100.0, k=100.0, t=1.0, r=0.1, alpha=0.2, beta=1.0,
                nu=0.4, rho=-0.4)
    for name, field, h in (("delta", "s0", 0.1), ("alpha_sens", "alpha", 1e-3),
                           ("nu_sens", "nu", 1e-2),
                           ("rho_fv_sens", "rho", 1e-2)):
        want = _oracle_fd(mt.sabr_call_hagan, base, field, h)
        assert float(g[name]) == pytest.approx(want, rel=0.15, abs=0.05), (
            name, float(g[name]), want)


def test_vasicek_market_and_curve_sens_vs_merton73():
    g = tg.vasicek_greeks(sim=mt.SimParams(n_paths=200_000, n_steps=20),
                          antithetic=True,
                          which=("delta", "rho0", "b_sens", "sigma_r_sens",
                                 "rho_sr_sens"), **CPU)
    base = dict(s0=100.0, k=100.0, t=1.0, r0=0.1, sigma_s=0.2, a=0.3,
                b=0.05, sigma_r=0.015, rho=-0.3)
    for name, field, h in (("delta", "s0", 0.1), ("rho0", "r0", 1e-3),
                           ("b_sens", "b", 1e-3),
                           ("sigma_r_sens", "sigma_r", 1e-4),
                           ("rho_sr_sens", "rho", 1e-3)):
        want = _oracle_fd(oracle.bsv_call, base, field, h)
        assert float(g[name]) == pytest.approx(want, rel=0.15, abs=0.03), (
            name, float(g[name]), want)


def test_heston_delta_and_v0_vs_cf_oracle():
    """Heston's CRN-FD delta and v0 sensitivity against central differences
    of the characteristic-function price (Euler at 50 steps: the tolerance
    of the other families' oracle cases)."""
    g = tg.heston_greeks(sim=mt.SimParams(n_paths=100_000, n_steps=50),
                         antithetic=True, which=("delta", "vega_v0"), **CPU)
    base = dict(s0=100.0, k=100.0, t=1.0, r=0.1, v0=0.04, kappa=2.0,
                theta=0.04, xi=0.3, rho=-0.7)
    for name, field, h in (("delta", "s0", 0.1), ("vega_v0", "v0", 1e-3)):
        want = _oracle_fd(mt.heston_call_cf, base, field, h)
        assert float(g[name]) == pytest.approx(want, rel=0.1, abs=0.02), (
            name, float(g[name]), want)


def test_family_greeks_default_to_cuda():
    if torch.cuda.is_available():
        assert tg.vasicek_greeks(sim=SMALL)["delta"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tg.vasicek_greeks(sim=SMALL)
