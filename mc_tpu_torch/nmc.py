"""Nested Monte Carlo engine: per-point conditional-expectation surfaces
(port of ``mc_tpu/nmc.py:47-120,123-244,256-292``).

For every point (outer path, step) of every outer bullet trajectory,
``n_inner`` inner paths resumed from the stored state estimate the
conditional expected payoff: the price surface of the reference's NMC
wrappers (``inc/wrappers.cuh:128-340``), and through `ExposureMetrics` the
exposure and XVA figures it feeds.

* ``strategy="fused"`` (C11): one kernel recomputes each outer path in
  registers and keeps no history, so there is no tile height to size
  (``mc_tpu``'s ``nmc_auto_tile_rows`` sized the TPU's VMEM history).
* ``strategy="grid"`` (C10): the trajectories kernel stores the outer
  (S, state) grids, the inner kernel sweeps them; the spot grid rides on the
  result for spot-linked metrics.  Both strategies give bitwise equal
  surfaces.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import (STREAM_INNER, STREAM_OUTER, finish_price,
                                  resolve_device)
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops import nmc_kernels as nk
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum
from mc_tpu_torch.xva import (ExposureMetrics, _cva_path_intensity, _f32,
                              _grid_weights)

__all__ = ["price_nmc", "NMCResult"]


@dataclasses.dataclass(frozen=True)
class NMCResult(ExposureMetrics):
    """Price surface + outer estimate.

    ``surface[j, i]`` is the discounted inner-MC estimate of the conditional
    expected payoff of outer path ``i`` given its state after step j+1,
    shaped ``(n_steps, n_paths)`` step-major; ``outer`` the plain outer-path
    price; ``surface_mean`` the mean over all n_paths*n_steps points (the
    reference's final "option price" output); ``t_horizon`` the option's
    maturity T; ``spot_surface`` the outer spot grid in the surface's layout
    under ``strategy="grid"``, else None.
    """

    surface: Any
    outer: PriceResult
    surface_mean: Any
    n_points: Any
    t_horizon: Any = 1.0
    spot_surface: Any = None

    def surface_matrix(self):
        """(n_paths, n_steps) view of the surface."""
        return self.surface.T

    def spot_matrix(self):
        """(n_paths, n_steps) view of the outer spot grid (grid strategy
        only)."""
        if self.spot_surface is None:
            raise ValueError(
                "the outer spot grid is only materialized by "
                "strategy='grid'; re-price with it for spot-linked metrics")
        return self.spot_surface.T

    def cva_wwr_spot(self, hazard_rate: float, beta: float,
                     recovery: float = 0.4,
                     t_horizon: Optional[float] = None):
        """CVA under spot-linked wrong-way risk: the intensity rides each
        path's underlying, lambda_i(t_j) = hazard * exp(beta * (S_ij /
        mean_i S_ij - 1)) (centred per date, so beta=0 is the flat `cva`).
        Unlike the exposure link of `cva_wwr`, the sign of the effect flips
        with the position: beta > 0 raises a long call's CVA and lowers a
        long put's.  Needs ``strategy="grid"``."""
        s = self.spot_matrix()
        v = self.surface_matrix()
        _, _, dt = _grid_weights(self.observation_dates(t_horizon, v.shape[1]))
        rel = s / s.mean(dim=0, keepdim=True) - 1.0
        lam = _f32(hazard_rate, v.device) * torch.exp(
            _f32(beta, v.device) * rel)
        return _cva_path_intensity(v, lam, dt, recovery)


def price_nmc(option: OptionParams = DEMO_OPTION,
              sim: SimParams = DEMO_SIM,
              payoff="bullet_call",
              *,
              strategy: str = "fused",
              discount: str = "full",
              rng_source: str = "threefry13",
              stream_outer: int = STREAM_OUTER,
              stream_inner: int = STREAM_INNER,
              key_outer=None,
              key_inner=None,
              device="cuda") -> NMCResult:
    """Nested Monte Carlo price surface.

    ``sim.n_paths_inner`` inner paths re-price every (path, step) point of
    every outer trajectory.  ``strategy``: "fused" (one kernel) or "grid"
    (materialized trajectories, then the inner kernel; the result carries
    the spot grid).
    """
    po = get_payoff(payoff)
    if strategy not in ("fused", "grid"):
        raise ValueError(f"unknown strategy {strategy!r}; use 'fused' or "
                         "'grid'")
    if po.n_state > 1:
        raise ValueError("NMC supports payoffs with at most one state array")
    cfg = nk.NMCConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                       n_inner=sim.n_paths_inner, discount=discount,
                       rng_source=rng_source)
    dev = resolve_device(device)
    if key_outer is None:
        key_outer = rng.derive_key(sim.seed, stream_outer)
    if key_inner is None:
        key_inner = rng.derive_key(sim.seed, stream_inner)
    key_outer = (int(key_outer[0]), int(key_outer[1]))
    key_inner = (int(key_inner[0]), int(key_inner[1]))

    params = pk.pack_params(option, sim.n_steps, dev)
    spot = None
    if strategy == "fused":
        surface, outer_partials = nk.nmc_fused(po, cfg, key_outer, key_inner,
                                               params)
    else:
        spot, c_grid, outer_partials = pk.simulate_trajectories(
            po, nk.outer_config(cfg), key_outer, params)
        surface = nk.nmc_inner(po, cfg, key_inner, params, spot, c_grid)
    outer = finish_price(finish_sum(outer_partials), sim.n_paths, option)
    n_points = sim.n_paths * sim.n_steps
    return NMCResult(surface=surface, outer=outer,
                     surface_mean=surface.double().sum() / n_points,
                     n_points=n_points, t_horizon=float(option.t),
                     spot_surface=spot)
