"""Nested Monte Carlo under Black-Scholes-Vasicek stochastic rates
(port of ``mc_tpu/nmc_vasicek.py:53-208``).

Every (path, step) point is discounted to TIME 0 along its own rate paths:

    V*_ij = exp(-y_j) * (1/M) sum_m payoff_m * exp(-(y_T^m - y_j)),

where y = int_0^t r du accumulates along the OUTER path to t_j (its stored
grid) and each inner leg m resumes from the stored market state (S_j, x_j =
r_j - b, payoff state) and accumulates its own remaining discount: the
engine scales each point by exp(-y_j) (``point_scale``) and the outer
payoffs carry their own exp(-y_T) (``outer_discount`` 1).  Martingale
consequence: for a ``zcb`` payoff the expected exposure profile is flat at
the closed-form P(0,T) at every step.

The engine is `nmc_engine`; this module supplies the Vasicek physics
(``models.vasicek.vasicek_step``), the outer grids (S, x, y) from
``models.vasicek.vasicek_trajectories`` (the outer paths are
``price_vasicek``'s threefry-13 paths on the outer key, two steps a block).
Inner draws: point (path i, step j), inner path m, substep u takes the
threefry-13 pairs ``(i, 2*(c_base + u))`` -> (za, zb) and ``(i, 2*(c_base +
u) + 1)`` -> (zc, unused), ``c_base = ((j+1)*n_inner + m) * n_steps``.
"""

from __future__ import annotations

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER
from mc_tpu_torch.models.merton import counters, steps_index
from mc_tpu_torch.models.vasicek import (DEMO_VASICEK, FAMILY_VASICEK,
                                         VASICEK_TAG, VasicekConfig,
                                         VasicekDynamics,
                                         check_vasicek_params, pack_vasicek,
                                         unpack_vasicek, vasicek_step,
                                         vasicek_trajectories,
                                         vasicek_trajectories_plain)
from mc_tpu_torch.nmc import NMCResult
from mc_tpu_torch.nmc_engine import (NMCFamily, price_nmc_family,
                                     register_nmc_family)

__all__ = ["VasicekNMC", "price_nmc_vasicek"]


class VasicekNMC(NMCFamily):
    """Vasicek physics for the engine: market grids (S, x, y) with pathwise
    discounting (point scale exp(-y_j), outer discount 1); no extras."""

    name = "vasicek"
    tag = VASICEK_TAG
    n_grids = 3
    even_steps = True
    cuda_id = FAMILY_VASICEK
    legs = 2  # csrc kLegs

    def span(self, n_steps, n_inner):
        # c_base uses j+1 (up to n_steps) at stride n_steps, doubled.
        return (2 * (n_steps + 1) * n_inner * n_steps,
                "2*(n_steps+1)*n_inner*n_steps")

    def pack(self, option, dyn, n_steps, device):
        return pack_vasicek(option, dyn, n_steps, device)

    def unpack(self, params):
        return unpack_vasicek(params)

    def check_params(self, params, n_steps):
        check_vasicek_params(params)

    def point_scale(self, p, grids_j):
        return torch.exp(-grids_j[2])  # e^{-y_j}: the outer path's discount

    def outer_discount(self, p) -> float:
        return 1.0  # the outer payoffs are discounted pathwise

    def _cfg(self, cfg):
        return VasicekConfig(n_paths=cfg.n_paths, n_steps=cfg.n_steps)

    def trajectories(self, payoff, cfg, key, params, path_offset=0,
                     n_valid=None):
        return vasicek_trajectories(payoff, self._cfg(cfg), key, params,
                                    path_offset, n_valid)

    def trajectories_plain(self, payoff, cfg, key, params, path_offset=0,
                           n_valid=None):
        return vasicek_trajectories_plain(payoff, self._cfg(cfg), key, params,
                                          path_offset, n_valid)

    def leg(self, payoff, p, k0, k1, ids, c_base, remaining, grids_j,
            state_j):
        s_t, x_t, _ = grids_j
        zero = torch.zeros_like(s_t)
        carry, state = (zero, x_t, zero), state_j
        if remaining:  # every substep's two pairs at once
            cu = counters(ids, 2 * (c_base + steps_index(remaining, c_base)))
            za, zb = rng.normal_pair(k0, k1, ids, cu)
            zc, _ = rng.normal_pair(k0, k1, ids, counters(ids, cu + 1))
        for u in range(remaining):
            carry, s = vasicek_step(p, carry, za[u], zb[u], zc[u], s_t)
            state = payoff.update(state, s, p)
        w, _, y = carry
        return payoff.terminal(state, s_t * torch.exp(w), p) * torch.exp(-y)


def price_nmc_vasicek(option: OptionParams = DEMO_OPTION,
                      dyn: VasicekDynamics = DEMO_VASICEK,
                      sim: SimParams = DEMO_SIM,
                      payoff="vanilla_call",
                      *,
                      strategy: str = "grid",
                      stream_outer: int = STREAM_OUTER,
                      stream_inner: int = STREAM_INNER,
                      device="cuda") -> NMCResult:
    """Nested MC price surface under stochastic (Vasicek) rates: every
    (path, step) point re-priced by ``sim.n_paths_inner`` exact inner legs
    resumed from the stored (S_t, r_t), discounted pathwise along both the
    outer and inner rate paths (an even ``n_steps``).  ``strategy``: "grid"
    (the Vasicek trajectories kernel, then the inner kernel; the result
    carries the spot grid) or "fused" (one kernel)."""
    return price_nmc_family(VasicekNMC(), option, dyn.as_f32(), sim, payoff,
                            strategy=strategy, stream_outer=stream_outer,
                            stream_inner=stream_inner, device=device)


def _vasicek_builder(option, dyn, sim):
    return VasicekNMC(), (DEMO_VASICEK if dyn is None else dyn).as_f32()


register_nmc_family("vasicek", price_nmc_vasicek, _vasicek_builder)
