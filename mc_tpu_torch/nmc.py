"""Nested Monte Carlo engine: per-point conditional-expectation surfaces
(port of ``mc_tpu/nmc.py:47-120,123-244,256-292``).

For every point (outer path, step) of every outer bullet trajectory,
``n_inner`` inner paths resumed from the stored state estimate the
conditional expected payoff: the price surface of the reference's NMC
wrappers (``inc/wrappers.cuh:128-340``).  Only the fused strategy is
ported; its kernel recomputes each outer path in registers and needs no
history buffer, so there is no tile height to size (``mc_tpu``'s
``nmc_auto_tile_rows`` sized the TPU's VMEM history).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import (STREAM_INNER, STREAM_OUTER, finish_price,
                                  resolve_device)
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops import nmc_kernels as nk
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["price_nmc", "NMCResult"]


@dataclasses.dataclass(frozen=True)
class NMCResult:
    """Price surface + outer estimate.

    ``surface[j, i]`` is the discounted inner-MC estimate of the conditional
    expected payoff of outer path ``i`` given its state after step j+1,
    shaped ``(n_steps, n_paths)`` step-major; ``outer`` the plain outer-path
    price; ``surface_mean`` the mean over all n_paths*n_steps points (the
    reference's final "option price" output).
    """

    surface: Any
    outer: PriceResult
    surface_mean: Any
    n_points: Any

    def surface_matrix(self):
        """(n_paths, n_steps) view of the surface."""
        return self.surface.T


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
    every outer trajectory.  ``strategy="grid"`` (the two-stage version
    over materialized trajectories) is not ported yet.
    """
    po = get_payoff(payoff)
    if strategy == "grid":
        raise NotImplementedError("strategy='grid' is not ported to "
                                  "mc_tpu_torch yet; use 'fused'")
    if strategy != "fused":
        raise ValueError(f"unknown strategy {strategy!r}")
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
    surface, outer_partials = nk.nmc_fused(po, cfg, key_outer, key_inner,
                                           params)
    outer = finish_price(finish_sum(outer_partials), sim.n_paths, option)
    n_points = sim.n_paths * sim.n_steps
    return NMCResult(surface=surface, outer=outer,
                     surface_mean=surface.double().sum() / n_points,
                     n_points=n_points)
