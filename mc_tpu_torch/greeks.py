"""Greeks: sensitivities of the Monte Carlo price to the market parameters
(port of ``mc_tpu/greeks.py``).

``greeks`` (``mc_tpu/greeks.py:47-326``) is GBM's:

* ``method="pathwise"``: exact pathwise derivatives, valid for the payoffs
  with an a.e. derivative (vanilla call and put, best-of-cash, Asian,
  lookback; ``ops.payoffs.PATHWISE``).  Delta, vega, rho and epsilon
  without antithetic pairing come from the fused greek kernel
  (``simulate_greek_partials``), each with its standard error and the
  price beside them; any other request (theta, dual delta, gamma as a
  common-random-numbers difference of pathwise deltas, antithetic) is
  ``torch.autograd.grad`` through ``price()`` (``engines.kernel_sums``).
* ``method="fd"``: central finite differences with common random numbers
  (the same key on both sides) through ``price()``, the simulate kernel;
  any payoff, and gamma.
* ``method="lrm"``: the likelihood-ratio (score-function) estimator,
  unbiased for discontinuous payoffs too (delta, vega, rho, epsilon and a
  second-order-score gamma; Glasserman 7.3).

The routing mirrors ``mc_tpu``'s ``engine="pallas"`` (its CLI,
``mc_tpu/cli.py:811-820``).  Every value is a 0-d f64 tensor on the device.

The other families' greeks (``mc_tpu/greeks.py:329-773``):

* ``merton_greeks``, ``sabr_greeks``, ``heston_greeks``, ``vasicek_greeks``:
  CRN central differences of the family's price (kernels #14, #17, #12,
  #23) on one fixed key per family;
* ``rainbow_greeks``, ``basket_greeks``: per-asset delta and vega vectors
  and the cega matrix in one backward pass, the price the kernel's (#27,
  #25), the gradient its plain version's (``engines.kernel_sums``);
* ``cva_greeks``: d(CVA)/d(market) by forward mode, the CVA the fused NMC
  kernel's (#3, #30), the tangent the plain NMC's JVP.

Where a plain version runs on the card it is only the derivative of the
function the kernel computes, as ``mc_tpu`` differentiates its Pallas
kernels through their bitwise XLA duals; no value comes from it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import (STREAM_INNER, STREAM_OUTER, _stream_key,
                                  finish_price, price, resolve_device)
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PATHWISE, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["greeks", "heston_greeks", "merton_greeks", "sabr_greeks",
           "vasicek_greeks", "rainbow_greeks", "basket_greeks", "cva_greeks",
           "GREEK_FIELDS", "HESTON_GREEK_FIELDS", "MERTON_GREEK_FIELDS",
           "SABR_GREEK_FIELDS", "VASICEK_GREEK_FIELDS", "CVA_GREEK_FIELDS"]

# greek name -> (OptionParams field, sign)
GREEK_FIELDS = {
    "delta": ("s0", 1.0),
    "vega": ("sigma", 1.0),
    "rho": ("r", 1.0),
    "theta": ("t", -1.0),     # market convention: -dP/dT
    "dual_delta": ("k", 1.0),
    "epsilon": ("q", 1.0),    # dividend-yield sensitivity dP/dq
}

# Greeks the likelihood-ratio estimator supports: parameters that enter the
# path density (K and T do not).  gamma is the second-order score, the only
# unbiased gamma for discontinuous payoffs.
_LRM_OK = {"delta", "vega", "rho", "epsilon", "gamma"}

# What the fused greek kernel computes: (pay, delta, vega, rho, epsilon).
_KERNEL_OK = {"delta", "vega", "rho", "epsilon"}
_KERNEL_NAMES = ("price", "delta", "vega", "rho", "epsilon")
_LRM_NAMES = ("price", "delta", "vega", "rho", "epsilon", "gamma")


def _as_f32(option: OptionParams) -> OptionParams:
    """The option with every field rounded to f32, as floats (what the
    kernels see; ``mc_tpu``'s ``option.as_f32()``)."""
    return OptionParams(*(float(np.float32(v)) for v in option.astuple()))


def _finish_each(sums: torch.Tensor, names, n_paths: int,
                 option: OptionParams) -> Dict[str, torch.Tensor]:
    """{name: PriceResult} of the (sum, sumsq) pairs in ``sums``, each
    discounted as ``price()`` discounts."""
    return {name: finish_price(sums[2 * i:2 * i + 2], n_paths, option)
            for i, name in enumerate(names)}


def _kernel_moments(opt32, po, sim, sim_method, key, dev):
    """The five (sum, sumsq) pairs of the fused greek kernel."""
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          method=sim_method)
    params = pk.pack_params(opt32, sim.n_steps, dev)
    sums = finish_sum(pk.simulate_greek_partials(po, cfg, key, params))
    return _finish_each(sums, _KERNEL_NAMES, sim.n_paths, opt32)


class _ScoreSums:
    """The score ingredients of one chunk's paths, fed each draw in order:
    the first draw z_1, sum z_j and sum z_j^2."""

    def __init__(self, zero: torch.Tensor):
        self.z1, self.sum_z, self.sum_z2 = None, zero, zero

    def __call__(self, z: torch.Tensor) -> None:
        if self.z1 is None:
            self.z1 = z
        self.sum_z = self.sum_z + z
        self.sum_z2 = self.sum_z2 + z * z


def _lrm_moments(opt32, po, sim, sim_method, key, dev):
    """LRM moments on the stream ``price()`` draws (port of
    ``mc_tpu/greeks.py:75-178``).

    The leg is ``simulate_partials``'s plain leg (``pk.simulate_leg``), so
    the implied price is bitwise ``price(method=sim_method)``'s plain
    version; it also hands each draw to the score ingredients
    (z_1, sum z_j, sum z_j^2).  Scores (Glasserman 7.3, log-Euler GBM,
    drift r - q - sigma^2/2):

      d log p / d s0    = z_1 / (s0 sigma sqrt(dt))
      d log p / d sigma = sum_j [(z_j^2 - 1)/sigma - z_j sqrt(dt)]
      d log p / d r     = sqrt(dt) sum_j z_j / sigma   (discount adds -T)
      d log p / d q     = -sqrt(dt) sum_j z_j / sigma

    and the second-order score of s0 for gamma.  In ``mc_tpu`` this is XLA
    code outside any Pallas kernel (``xla_moment_scan``), so there is no
    TPU kernel to port: it runs as plain PyTorch operations on the device,
    by design and not as a fallback.
    """
    params = pk.pack_params(opt32, sim.n_steps, dev)
    p = pk.unpack_params(params)
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          method=sim_method)
    if sim_method == "terminal":
        n_z, sq_dt, vol_unit = 1.0, torch.sqrt(p.t), p.vol_t
    else:
        n_z, sq_dt, vol_unit = float(sim.n_steps), torch.sqrt(p.dt), p.vol_dt
    rows = []
    for _, _, ids, valid, draw_pair in pk.path_chunks(cfg, key, params):
        scores = _ScoreSums(torch.zeros_like(ids, dtype=torch.float32))
        s_t, state, _ = pk.simulate_leg(po, cfg, p, p.s0.expand(ids.shape),
                                        draw_pair, on_draw=scores)
        pay = po.terminal(state, s_t, p)
        z1, sum_z, sum_z2 = scores.z1, scores.sum_z, scores.sum_z2
        sc_delta = z1 / (p.s0 * vol_unit)
        sc_vega = (sum_z2 - n_z) / p.sigma - sq_dt * sum_z
        sc_r = sq_dt * sum_z / p.sigma
        # The density depends on s0 only through the first increment, so
        # d2 log p/ds0^2 + (d log p/ds0)^2
        #   = ((z1^2 - 1)/vol_unit^2 - z1/vol_unit) / s0^2.
        sc_gamma = ((z1 * z1 - 1.0) / (vol_unit * vol_unit)
                    - z1 / vol_unit) / (p.s0 * p.s0)
        vals = []
        for v in (pay, pay * sc_delta, pay * sc_vega,
                  pay * (sc_r - p.t),  # d(e^{-rT})/dr folds in the -T
                  pay * (-sc_r), pay * sc_gamma):
            v = torch.where(valid, v, 0.0)
            vals += [v, v * v]
        rows.append(pk.moment_row(vals))
    sums = finish_sum(torch.stack(rows))
    return _finish_each(sums, _LRM_NAMES, sim.n_paths, opt32)


def _with_stderr(res, which) -> Dict[str, torch.Tensor]:
    out = {}
    for g in which:
        out[g] = res[g].price
        out[f"{g}_stderr"] = res[g].stderr
    out["price"] = res["price"].price
    out["price_stderr"] = res["price"].stderr
    return out


def greeks(option: OptionParams = DEMO_OPTION,
           sim: SimParams = DEMO_SIM,
           payoff="vanilla_call",
           *,
           method: str = "pathwise",
           which: Sequence[str] = ("delta", "vega", "rho", "theta"),
           sim_method: Optional[str] = None,
           antithetic: bool = False,
           rel_bump: float = 1e-3,
           stream: int = STREAM_OUTER,
           key=None,
           device="cuda") -> Dict[str, torch.Tensor]:
    """Monte Carlo greeks on ``device``: {greek: value} (0-d f64 tensors).

    ``sim_method`` is the simulation's method ("terminal" for terminal-only
    payoffs, else "euler"); every route draws the per-path stream of
    ``price(method=sim_method)`` on ``key`` (default
    ``rng.derive_key(sim.seed, stream)``), so the greeks belong to that
    price.  The kernel and LRM routes add ``<greek>_stderr``, ``price`` and
    ``price_stderr``.  ``rel_bump`` sizes the finite differences (and the
    pathwise gamma's): h = rel_bump * max(|field|, 0.01), s0 * rel_bump for
    gamma.
    """
    po = get_payoff(payoff)
    if sim_method is None:
        sim_method = "terminal" if po.terminal_only else "euler"
    bad = set(which) - set(GREEK_FIELDS) - {"gamma"}
    if bad:
        raise ValueError(f"unknown greeks {sorted(bad)}; "
                         f"available: {sorted(GREEK_FIELDS)} + ['gamma']")
    if method == "pathwise" and po.name not in PATHWISE:
        raise ValueError(
            f"payoff {po.name!r} has a discontinuous payoff; pathwise "
            "derivatives are invalid — use method='lrm' (unbiased "
            "score-function weights) or method='fd' (common random "
            "numbers make the central difference low-variance)")
    dev = resolve_device(device)
    key = _stream_key(sim, stream, key)
    opt32 = _as_f32(option)

    if method == "lrm":
        bad_lrm = set(which) - _LRM_OK
        if bad_lrm:
            raise ValueError(
                f"LRM supports {sorted(_LRM_OK)} (density parameters "
                f"only); requested {sorted(bad_lrm)} — use method='fd'")
        if antithetic:
            raise ValueError("antithetic pairing is not supported for "
                             "method='lrm' (the scores are odd in z)")
        return _with_stderr(_lrm_moments(opt32, po, sim, sim_method, key,
                                         dev), which)

    def f(opt):
        return price(opt, sim, po, method=sim_method, antithetic=antithetic,
                     key=key, device=dev).price

    if method == "pathwise" and not set(which) - _KERNEL_OK and not antithetic:
        # One fused kernel computes the four market greeks with their
        # stderrs; other which/antithetic requests differentiate price().
        return _with_stderr(_kernel_moments(opt32, po, sim, sim_method, key,
                                            dev), which)

    if method == "pathwise":
        out = _pathwise_grads(f, opt32, which)
        if "gamma" in which:
            # d2P/dS0^2 pathwise is a.e. zero for kinked payoffs: a common-
            # random-numbers central difference of the pathwise delta.
            h = np.float32(rel_bump) * np.float32(opt32.s0)
            d_up, d_dn = (_pathwise_grads(
                f, dataclasses.replace(opt32, s0=float(np.float32(opt32.s0)
                                                       + sgn * h)),
                ("delta",))["delta"] for sgn in (1, -1))
            out["gamma"] = (d_up - d_dn) / (2.0 * float(h))
        return out

    if method != "fd":
        raise ValueError(f"unknown method {method!r}")
    out = {}
    for g in which:
        if g == "gamma":
            h = np.float32(rel_bump) * np.float32(opt32.s0)
            up, mid, dn = (f(dataclasses.replace(
                opt32, s0=float(np.float32(opt32.s0) + sgn * h)))
                for sgn in (1, 0, -1))
            out["gamma"] = (up - 2.0 * mid + dn) / (float(h) * float(h))
            continue
        fld, sgn = GREEK_FIELDS[g]
        base = np.float32(getattr(opt32, fld))
        h = np.float32(rel_bump) * np.maximum(np.abs(base), np.float32(1e-2))
        up = f(dataclasses.replace(opt32, **{fld: float(base + h)}))
        dn = f(dataclasses.replace(opt32, **{fld: float(base - h)}))
        out[g] = sgn * (up - dn) / (2.0 * float(h))
    return out


def _pathwise_grads(f, opt32: OptionParams, which) -> Dict[str, torch.Tensor]:
    """{greek: sign * dP/dfield} for the greeks of ``which`` that are a
    field's derivative: one ``torch.autograd.grad`` through ``price()``."""
    wanted = [g for g in which if g in GREEK_FIELDS]
    if not wanted:
        return {}
    leaves = {fld: torch.tensor(getattr(opt32, fld), dtype=torch.float64,
                                requires_grad=True)
              for fld in sorted({GREEK_FIELDS[g][0] for g in wanted})}
    grads = torch.autograd.grad(f(dataclasses.replace(opt32, **leaves)),
                                list(leaves.values()))
    by_field = dict(zip(leaves, grads))
    return {g: GREEK_FIELDS[g][1] * by_field[GREEK_FIELDS[g][0]]
            for g in wanted}


# ---------------------------------------------------------------------------
# Model-family greeks: CRN central differences over the family kernels
# (mc_tpu/greeks.py:329-548)
# ---------------------------------------------------------------------------


def _fd_model_greeks(f, option, dyn, fields, which, rel_bump,
                     what: str = "greeks") -> Dict[str, torch.Tensor]:
    """CRN central differences over (option, dynamics) fields.

    ``f(option, dyn) -> price`` draws on one fixed key, so both sides of a
    bump ride the same draws.  The bump is f32 as in ``mc_tpu``: h =
    f32(rel_bump) * max(|base|, 1e-2), and base + h, base - h rounded to
    f32; each greek is sign * (up - dn) / (2h) of the two f64 prices."""
    bad = set(which) - set(fields)
    if bad:
        raise ValueError(f"unknown {what} {sorted(bad)}; "
                         f"available: {sorted(fields)}")
    out = {}
    for g in which:
        tree, fld, sgn = fields[g]
        base_obj = option if tree == "option" else dyn
        base = np.float32(getattr(base_obj, fld))
        h = np.float32(rel_bump) * np.maximum(np.abs(base), np.float32(1e-2))
        up_obj = dataclasses.replace(base_obj, **{fld: float(base + h)})
        dn_obj = dataclasses.replace(base_obj, **{fld: float(base - h)})
        if tree == "option":
            up, dn = f(up_obj, dyn), f(dn_obj, dyn)
        else:
            up, dn = f(option, up_obj), f(option, dn_obj)
        out[g] = sgn * (up - dn) / (2.0 * float(h))
    return out


def _family_key(sim: SimParams, stream: int, tag: int):
    k = rng.derive_key(sim.seed, stream, tag)
    return int(k[0]), int(k[1])


MERTON_GREEK_FIELDS = {
    "delta": ("option", "s0", 1.0),
    "vega": ("option", "sigma", 1.0),       # diffusion-vol sensitivity
    "rho": ("option", "r", 1.0),
    "theta": ("option", "t", -1.0),
    "dual_delta": ("option", "k", 1.0),
    "lam_sens": ("dyn", "lam", 1.0),        # dP/d(jump intensity)
    "mu_j_sens": ("dyn", "mu_j", 1.0),      # dP/d(mean log jump)
    "sigma_j_sens": ("dyn", "sigma_j", 1.0),  # dP/d(jump-size vol)
}


def merton_greeks(option=None, merton=None,
                  sim: SimParams = DEMO_SIM,
                  payoff="vanilla_call",
                  *,
                  which: Sequence[str] = ("delta", "vega", "lam_sens"),
                  antithetic: bool = False,
                  rel_bump: float = 1e-3,
                  stream: int = STREAM_OUTER,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Merton-model sensitivities by CRN central differences of
    ``price_merton(method="euler")`` on ``device`` (kernel #14): the market
    greeks and the jump-parameter sensitivities calibration needs, on the
    key ``derive_key(sim.seed, stream, 0x3E44)``."""
    from mc_tpu_torch.models.merton import (DEMO_MERTON, MERTON_TAG,
                                            price_merton)

    option = _as_f32(DEMO_OPTION if option is None else option)
    merton = (DEMO_MERTON if merton is None else merton).as_f32()
    key = _family_key(sim, stream, MERTON_TAG)
    dev = resolve_device(device)

    def f(opt, dyn):
        return price_merton(opt, dyn, sim, payoff, method="euler",
                            antithetic=antithetic, key=key,
                            device=dev).price

    return _fd_model_greeks(f, option, merton, MERTON_GREEK_FIELDS, which,
                            rel_bump)


SABR_GREEK_FIELDS = {
    "delta": ("option", "s0", 1.0),
    "rho": ("option", "r", 1.0),
    "theta": ("option", "t", -1.0),
    "dual_delta": ("option", "k", 1.0),
    "alpha_sens": ("dyn", "alpha", 1.0),    # dP/d(initial forward vol)
    "beta_sens": ("dyn", "beta", 1.0),      # dP/d(backbone exponent)
    "nu_sens": ("dyn", "nu", 1.0),          # dP/d(vol-of-vol)
    "rho_fv_sens": ("dyn", "rho", 1.0),     # dP/d(forward-vol corr)
}


def sabr_greeks(option=None, sabr=None,
                sim: SimParams = DEMO_SIM,
                payoff="vanilla_call",
                *,
                which: Sequence[str] = ("delta", "alpha_sens", "nu_sens"),
                antithetic: bool = False,
                rel_bump: float = 1e-3,
                stream: int = STREAM_OUTER,
                device="cuda") -> Dict[str, torch.Tensor]:
    """SABR-model sensitivities by CRN central differences of
    ``price_sabr`` on ``device`` (kernel #17): the smile calibration set
    (alpha, beta, nu, rho) and spot, rate, maturity and strike, on the key
    ``derive_key(sim.seed, stream, 0x5AB4)``."""
    from mc_tpu_torch.models.sabr import DEMO_SABR, SABR_TAG, price_sabr

    option = _as_f32(DEMO_OPTION if option is None else option)
    sabr = (DEMO_SABR if sabr is None else sabr).as_f32()
    key = _family_key(sim, stream, SABR_TAG)
    dev = resolve_device(device)

    def f(opt, dyn):
        return price_sabr(opt, dyn, sim, payoff, antithetic=antithetic,
                          key=key, device=dev).price

    return _fd_model_greeks(f, option, sabr, SABR_GREEK_FIELDS, which,
                            rel_bump)


HESTON_GREEK_FIELDS = {
    # greek -> (which dataclass, field, sign)
    "delta": ("option", "s0", 1.0),
    "rho": ("option", "r", 1.0),
    "theta": ("option", "t", -1.0),
    "dual_delta": ("option", "k", 1.0),
    "vega_v0": ("heston", "v0", 1.0),        # dP/d(initial variance)
    "vega_theta": ("heston", "theta", 1.0),  # dP/d(long-run variance)
    "vega_xi": ("heston", "xi", 1.0),        # dP/d(vol-of-vol)
    "vega_kappa": ("heston", "kappa", 1.0),
    "vega_rho": ("heston", "rho", 1.0),      # dP/d(spot-vol correlation)
}


def heston_greeks(option=None, heston=None,
                  sim: SimParams = DEMO_SIM,
                  payoff="vanilla_call",
                  *,
                  which: Sequence[str] = ("delta", "vega_v0", "rho"),
                  antithetic: bool = False,
                  rel_bump: float = 1e-3,
                  scheme: str = "euler",
                  stream: int = STREAM_OUTER,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Heston-model sensitivities by CRN central differences of
    ``price_heston(scheme=scheme)`` on ``device`` (kernel #12): spot, rate,
    maturity and strike, and the calibration set (v0, theta, xi, kappa,
    rho), on the key ``derive_key(sim.seed, stream, 0x4E57)``."""
    from mc_tpu_torch.models.heston import (DEMO_HESTON, HESTON_TAG,
                                            price_heston)

    option = _as_f32(DEMO_OPTION if option is None else option)
    heston = (DEMO_HESTON if heston is None else heston).as_f32()
    po = get_payoff(payoff)
    key = _family_key(sim, stream, HESTON_TAG)
    dev = resolve_device(device)

    def f(opt, hes):
        return price_heston(opt, hes, sim.replace(seed=0), po, scheme=scheme,
                            antithetic=antithetic, key=key,
                            device=dev).price

    return _fd_model_greeks(f, option, heston, HESTON_GREEK_FIELDS, which,
                            rel_bump, what="heston greeks")


VASICEK_GREEK_FIELDS = {
    "delta": ("option", "s0", 1.0),
    "vega": ("option", "sigma", 1.0),      # equity diffusion vol
    "theta": ("option", "t", -1.0),
    "dual_delta": ("option", "k", 1.0),
    "rho0": ("option", "r", 1.0),          # dP/d(initial short rate)
    "a_sens": ("dyn", "a", 1.0),           # dP/d(mean-reversion speed)
    "b_sens": ("dyn", "b", 1.0),           # dP/d(long-run rate level)
    "sigma_r_sens": ("dyn", "sigma_r", 1.0),
    "rho_sr_sens": ("dyn", "rho", 1.0),    # dP/d(equity/rate corr)
}


def vasicek_greeks(option=None, dyn=None,
                   sim: SimParams = DEMO_SIM,
                   payoff="vanilla_call",
                   *,
                   which: Sequence[str] = ("delta", "rho0", "sigma_r_sens"),
                   antithetic: bool = False,
                   rel_bump: float = 1e-3,
                   stream: int = STREAM_OUTER,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Stochastic-rate sensitivities by CRN central differences of
    ``price_vasicek`` on ``device`` (kernel #23), on the key
    ``derive_key(sim.seed, stream, 0x7A51)``: ``rho0`` is the sensitivity
    to the initial short rate, the others the curve-shape exposures (a, b,
    sigma_r, the equity/rate correlation)."""
    from mc_tpu_torch.models.vasicek import (DEMO_VASICEK, VASICEK_TAG,
                                             price_vasicek)

    option = _as_f32(DEMO_OPTION if option is None else option)
    dyn = (DEMO_VASICEK if dyn is None else dyn).as_f32()
    key = _family_key(sim, stream, VASICEK_TAG)
    dev = resolve_device(device)

    def f(opt, d):
        return price_vasicek(opt, d, sim, payoff, antithetic=antithetic,
                             key=key, device=dev).price

    return _fd_model_greeks(f, option, dyn, VASICEK_GREEK_FIELDS, which,
                            rel_bump)


# ---------------------------------------------------------------------------
# Multi-asset greeks: one reverse pass (mc_tpu/greeks.py:563-654)
# ---------------------------------------------------------------------------


def _multiasset_greeks(price_fn, basket, which) -> Dict[str, torch.Tensor]:
    """{"delta": (d,), "vega": (d,), "cega": (d, d)} of ``price_fn(b)``,
    one ``torch.autograd.grad`` through the price: the kernel's value, the
    gradient of its plain version (``engines.kernel_sums``) and of the
    pack's twin (``ops.twin``).  cega folds rho_ij and rho_ji, the same
    market parameter, together and zeroes the diagonal."""
    allowed = ("delta", "vega", "cega")
    bad = set(which) - set(allowed)
    if bad:
        raise ValueError(f"unknown greeks {sorted(bad)}; "
                         f"available: {list(allowed)}")
    leaves = [torch.tensor(np.asarray(v, np.float32), requires_grad=True)
              for v in (basket.s0s, basket.sigmas, basket.corr)]
    b = dataclasses.replace(basket, s0s=leaves[0], sigmas=leaves[1],
                            corr=leaves[2])
    g_s0, g_sig, g_corr = torch.autograd.grad(price_fn(b), leaves)
    out = {}
    if "delta" in which:
        out["delta"] = g_s0
    if "vega" in which:
        out["vega"] = g_sig
    if "cega" in which:
        c = g_corr + g_corr.T
        out["cega"] = c - torch.diag(torch.diag(c))
    return out


def rainbow_greeks(option=None, basket=None,
                   sim: SimParams = DEMO_SIM,
                   payoff: str = "call_on_max",
                   *,
                   which: Sequence[str] = ("delta", "vega", "cega"),
                   antithetic: bool = False,
                   stream: int = STREAM_OUTER,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Per-asset sensitivities of a rainbow contract: {"delta": (d,),
    "vega": (d,), "cega": (d, d)}, pathwise through the exact terminal
    draw in one backward pass.  The price is ``price_rainbow``'s (kernel
    #27 on the card) on ``derive_key(sim.seed, stream, 0xBE0F)``; the
    gradient is its plain version's, recomputed on the same device.  cega
    is symmetric with a zero diagonal."""
    from mc_tpu_torch.models.basket import DEMO_BASKET
    from mc_tpu_torch.models.rainbow import RAINBOW_TAG, price_rainbow

    option = _as_f32(DEMO_OPTION if option is None else option)
    basket = (DEMO_BASKET if basket is None else basket).as_f32()
    key = _family_key(sim, stream, RAINBOW_TAG)
    dev = resolve_device(device)

    def price_fn(b):
        return price_rainbow(option, b, sim, payoff, antithetic=antithetic,
                             key=key, device=dev).price

    return _multiasset_greeks(price_fn, basket, which)


def basket_greeks(option=None, basket=None,
                  sim: SimParams = DEMO_SIM,
                  payoff: str = "vanilla_call",
                  *,
                  which: Sequence[str] = ("delta", "vega", "cega"),
                  antithetic: bool = False,
                  stream: int = STREAM_OUTER,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Per-asset sensitivities of a payoff on the weighted basket level (as
    ``price_basket``, kernel #25 on the card, on ``derive_key(sim.seed,
    stream, 0xBA5C)``), by one backward pass through the step loop's plain
    version.  With d = 1 and weight 1 delta and vega are the single-asset
    pathwise ``greeks()``."""
    from mc_tpu_torch.models.basket import (BASKET_TAG, DEMO_BASKET,
                                            price_basket)

    option = _as_f32(DEMO_OPTION if option is None else option)
    basket = (DEMO_BASKET if basket is None else basket).as_f32()
    po = get_payoff(payoff)
    if po.name not in PATHWISE:
        raise ValueError(
            f"pathwise multi-asset greeks need an a.e.-differentiable "
            f"payoff ({sorted(PATHWISE)}); {po.name!r} has "
            "zero-a.e. pathwise derivatives")
    key = _family_key(sim, stream, BASKET_TAG)
    dev = resolve_device(device)

    def price_fn(b):
        return price_basket(option, b, sim, po, antithetic=antithetic,
                            key=key, device=dev).price

    return _multiasset_greeks(price_fn, basket, which)


# ---------------------------------------------------------------------------
# CVA sensitivities: forward mode through the nested pipeline
# (mc_tpu/greeks.py:665-773)
# ---------------------------------------------------------------------------

CVA_GREEK_FIELDS = ("delta", "vega", "rho", "dual_delta")


def cva_greeks(option=None,
               sim: Optional[SimParams] = None,
               payoff="vanilla_call",
               *,
               hazard_rate: float,
               recovery: float = 0.4,
               which: Sequence[str] = ("delta", "vega"),
               model: Optional[str] = None,
               dyn=None,
               stream_outer: int = STREAM_OUTER,
               device="cuda") -> Dict[str, torch.Tensor]:
    """d(CVA)/d(market) through the whole nested pipeline on ``device``:
    outer paths, inner re-pricing, exposure positive part and the default
    leg, the horizon fixed at f32(option.t).

    The CVA's value is the fused NMC kernel's surface (#3 for GBM, #30 for
    a family) through ``ExposureMetrics.cva``.  Its tangent is forward
    mode (``torch.autograd.forward_ad``, one pass per greek, as ``mc_tpu``
    takes one JVP per greek: the inner legs' trip counts depend on the
    step): the JVP of the plain version of that NMC on the same device,
    handed to the kernel's surface by ``ops.twin.with_derivative_of`` and
    on through the metrics.  The plain version is used on the card only as
    that tangent, never as the value.

    ``model=`` runs the pipeline under a family of
    ``nmc_engine.NMC_FAMILY_BUILDERS`` with its ``dyn``; ``which`` then
    takes, besides delta (s0), rho (r) and dual_delta (k), any scalar
    dynamics field by name, a name a canonical greek shadows with the
    ``dyn.`` prefix ("dyn.rho" is Heston's correlation).  "vega" is GBM's
    sigma greek only.  Keys derive from ``sim.seed``, so a CRN central
    difference of the same pipeline reproduces these numbers.
    """
    import torch.autograd.forward_ad as fwAD

    from mc_tpu_torch.nmc import NMCResult
    from mc_tpu_torch.nmc_engine import (FamilyConfig, NMC_FAMILY_BUILDERS,
                                         _validate_and_keys, ensure_family,
                                         family_fused, family_fused_plain)
    from mc_tpu_torch.ops import nmc_kernels as nk
    from mc_tpu_torch.ops import twin

    option = _as_f32(DEMO_OPTION if option is None else option)
    sim = DEMO_SIM if sim is None else sim
    opt_fields = {"delta": "s0", "vega": "sigma", "rho": "r",
                  "dual_delta": "k"}
    fam = dyn32 = None
    if model is not None:
        ensure_family(model)
        fam, dyn32 = NMC_FAMILY_BUILDERS[model](option, dyn, sim)
        dyn_fields = [f.name for f in dataclasses.fields(dyn32)
                      if np.ndim(getattr(dyn32, f.name)) == 0]

    # resolve each requested greek to ("option" | "dyn", field)
    targets = []
    for g in which:
        if g in opt_fields and not (model is not None and g == "vega"):
            targets.append(("option", opt_fields[g]))
            continue
        if model is None:
            raise ValueError(
                f"unknown greeks {sorted(set(which) - set(CVA_GREEK_FIELDS))}"
                f"; available: {list(CVA_GREEK_FIELDS)}")
        name = g[4:] if g.startswith("dyn.") else g
        if name == "vega":
            raise ValueError(
                f"'vega' is the GBM sigma greek; under model={model!r} use a "
                f"dynamics field instead: {dyn_fields}")
        if name not in dyn_fields:
            vec = [f.name for f in dataclasses.fields(dyn32)
                   if f.name not in dyn_fields]
            hint = (f" (vector fields {vec} need the per-asset "
                    "rainbow_greeks/basket_greeks)" if vec else "")
            raise ValueError(
                f"unknown greek {g!r}; option greeks "
                f"{sorted(k for k in opt_fields if k != 'vega')} or "
                f"{model} dynamics fields {dyn_fields}{hint}")
        targets.append(("dyn", name))

    dev = resolve_device(device)
    if model is None:
        cfg = nk.NMCConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                           n_inner=sim.n_paths_inner)
        key_outer, key_inner = (
            tuple(int(k) for k in rng.derive_key(sim.seed, stream))
            for stream in (stream_outer, STREAM_INNER))
        po = get_payoff(payoff)

        def pack(opt, d):
            return pk.pack_params(opt, sim.n_steps, dev)

        def kernel(params):
            return nk.nmc_fused(po, cfg, key_outer, key_inner, params)[0]

        def plain(params):
            return nk.nmc_fused_plain(po, cfg, key_outer, key_inner,
                                      params)[0]
    else:
        po, key_outer, key_inner = _validate_and_keys(
            fam, sim, payoff, stream_outer, STREAM_INNER)
        fcfg = FamilyConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                            n_inner=sim.n_paths_inner)

        def pack(opt, d):
            return fam.pack(opt, d, sim.n_steps, dev)

        def kernel(params):
            return family_fused(fam, po, fcfg, key_outer, key_inner,
                                params)[0]

        def plain(params):
            return family_fused_plain(fam, po, fcfg, key_outer, key_inner,
                                      params)[0]

    t_horizon = float(np.float32(option.t))

    def cva(surface):
        res = NMCResult(surface=surface, outer=None, surface_mean=None,
                        n_points=None, t_horizon=t_horizon)
        return res.cva(hazard_rate, recovery)

    surface = kernel(pack(option, dyn32))
    out = {}
    for g, (kind, field) in zip(which, targets):
        base = option if kind == "option" else dyn32
        with fwAD.dual_level():
            leaf = fwAD.make_dual(twin.f32(getattr(base, field)),
                                  torch.ones((), dtype=torch.float32))
            bumped = dataclasses.replace(base, **{field: leaf})
            params = (pack(bumped, dyn32) if kind == "option"
                      else pack(option, bumped))
            value = cva(twin.with_derivative_of(surface, plain(params)))
            out[g] = fwAD.unpack_dual(value).tangent
    return out
