"""Nested Monte Carlo under SABR (port of ``mc_tpu/nmc_sabr.py:36-150``).

Every (path, step) point of the outer trajectories is re-priced by
``sim.n_paths_inner`` inner legs resumed from the stored two-factor state
(F_t, sigma_t) and payoff state: exposure on the smile model desks calibrate
to.  The engine is `nmc_engine`; this module supplies the SABR physics
(``models.sabr.sabr_step``).  SABR has no trajectories kernel of its own:
its outer grids (F, sigma) come from the engine's generic
``family_trajectories``, as ``mc_tpu`` builds them with its XLA scan.

The outer path lives on the FORWARD: it starts from log(f0) and alpha, step
j draws the threefry-13 pair ``(i, j)`` (``price_sabr``'s layout), and the
carry keeps the rounded F = exp(log F) the step stored, which the outer
payoff reads.  Inner draws: point (path i, step j), inner path m, substep u
takes the pair ``(i, ((j+1)*n_inner + m)*n_steps + u)``; the leg resumes
from log F_t and pays on exp(log F) (at the last row on exp(log F_T), not
F_T).  Payoffs are discounted at e^{-rT}.

Martingale gate: F is a martingale under the forward measure, so the fully
discounted conditional value of a call is flat at the time-0 SABR price.
"""

from __future__ import annotations

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER
from mc_tpu_torch.models.merton import counters, steps_index
from mc_tpu_torch.models.sabr import (DEMO_SABR, FAMILY_SABR, SABR_TAG,
                                      SABRDynamics, check_sabr_params,
                                      pack_sabr, sabr_step, unpack_sabr)
from mc_tpu_torch.nmc import NMCResult
from mc_tpu_torch.nmc_engine import (NMCFamily, price_nmc_family,
                                     register_nmc_family)

__all__ = ["SABRNMC", "price_nmc_sabr"]


class SABRNMC(NMCFamily):
    """SABR physics for the engine: market grids (F, sigma); no extras."""

    name = "SABR"
    tag = SABR_TAG
    n_grids = 2
    even_steps = False
    cuda_id = FAMILY_SABR
    legs = 1  # csrc kLegs

    def span(self, n_steps, n_inner):
        return n_steps * n_inner * n_steps, "n_steps^2 * n_inner"

    def pack(self, option, dyn, n_steps, device):
        return pack_sabr(option, dyn, n_steps, device)

    def unpack(self, params):
        return unpack_sabr(params)

    def check_params(self, params, n_steps):
        check_sabr_params(params)

    def outer_init(self, payoff, p, like):
        zero = torch.zeros_like(like)
        f0 = zero + p.f0
        return torch.log(f0), zero + p.alpha, f0, payoff.init(p, zero)

    def outer_draws(self, k0, k1, ids, steps):
        return rng.normal_pair(k0, k1, ids, counters(ids, steps))

    def outer_step(self, payoff, p, carry, draws):
        logf, sig, _, state = carry
        logf, sig = sabr_step(p, logf, sig, *draws)
        f = torch.exp(logf)
        state = payoff.update(state, f, p)
        word0 = state[0] if payoff.n_state else torch.zeros_like(f)
        return (logf, sig, f, state), (f, sig, word0)

    def outer_pay(self, payoff, p, carry):
        _, _, f, state = carry
        return payoff.terminal(state, f, p)

    def leg(self, payoff, p, k0, k1, ids, c_base, remaining, grids_j,
            state_j):
        (f_t, sig), state = grids_j, state_j
        logf = torch.log(f_t)
        if remaining:  # every substep's pair at once
            z_vol, z_perp = rng.normal_pair(
                k0, k1, ids, counters(ids, c_base + steps_index(remaining,
                                                                c_base)))
        for u in range(remaining):
            logf, sig = sabr_step(p, logf, sig, z_vol[u], z_perp[u])
            state = payoff.update(state, torch.exp(logf), p)
        return payoff.terminal(state, torch.exp(logf), p)


def price_nmc_sabr(option: OptionParams = DEMO_OPTION,
                   dyn: SABRDynamics = DEMO_SABR,
                   sim: SimParams = DEMO_SIM,
                   payoff="vanilla_call",
                   *,
                   strategy: str = "grid",
                   stream_outer: int = STREAM_OUTER,
                   stream_inner: int = STREAM_INNER,
                   device="cuda") -> NMCResult:
    """Nested MC price surface under SABR: exposure profiles and CVA under
    the smile model's own dynamics, the inner legs resumed from the stored
    (F_t, sigma_t).  The outer paths are ``price_sabr``'s threefry-13 paths
    on the same key.  ``strategy``: "grid" (the generic trajectories kernel,
    then the inner kernel; the result carries the forward grid as
    ``spot_surface``) or "fused" (one kernel)."""
    return price_nmc_family(SABRNMC(), option, dyn.as_f32(), sim, payoff,
                            strategy=strategy, stream_outer=stream_outer,
                            stream_inner=stream_inner, device=device)


def _sabr_builder(option, dyn, sim):
    return SABRNMC(), (DEMO_SABR if dyn is None else dyn).as_f32()


register_nmc_family("sabr", price_nmc_sabr, _sabr_builder)
