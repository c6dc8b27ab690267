"""Greeks: sensitivities of the Monte Carlo price to the market parameters
(port of ``mc_tpu/greeks.py:47-326``, the GBM ``greeks``).

* ``method="pathwise"``: exact pathwise derivatives, valid for the payoffs
  with an a.e. derivative (vanilla call and put, best-of-cash, Asian,
  lookback; ``ops.payoffs.PATHWISE``).  Delta, vega, rho and epsilon
  without antithetic pairing come from the fused greek kernel
  (``simulate_greek_partials``), each with its standard error and the
  price beside them; any other request (theta, dual delta, gamma as a
  common-random-numbers difference of pathwise deltas, antithetic) is
  ``torch.autograd.grad`` through ``price()`` (``engines._SimulateSums``).
* ``method="fd"``: central finite differences with common random numbers
  (the same key on both sides) through ``price()``, the simulate kernel;
  any payoff, and gamma.
* ``method="lrm"``: the likelihood-ratio (score-function) estimator,
  unbiased for discontinuous payoffs too (delta, vega, rho, epsilon and a
  second-order-score gamma; Glasserman 7.3).

The routing mirrors ``mc_tpu``'s ``engine="pallas"`` (its CLI,
``mc_tpu/cli.py:811-820``).  Every value is a 0-d f64 tensor on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import (STREAM_OUTER, _stream_key, finish_price,
                                  price, resolve_device)
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PATHWISE, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["greeks", "GREEK_FIELDS"]

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
