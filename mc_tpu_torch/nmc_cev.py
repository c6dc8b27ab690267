"""Nested Monte Carlo under CEV local volatility
(port of ``mc_tpu/nmc_cev.py:36-151``).

Every (path, step) point of the outer trajectories is re-priced by
``sim.n_paths_inner`` inner legs resumed from the stored spot S_t and payoff
state (CEV's diffusion depends on S alone, so S is the whole market state).
The engine is `nmc_engine`; this module supplies the CEV physics: the
level-space Euler substep with its absorbing zero
(``models.cev.cev_substep``).  CEV has no trajectories kernel of its own: its
outer grids come from the engine's generic ``family_trajectories``, as
``mc_tpu`` builds them with its XLA scan.

Inner draws: point (path i, step j), inner path m takes the threefry-13 pair
``(i, c_base + q)`` for substeps 2q and 2q+1, ``c_base = ((j+1)*n_inner + m)
* ceil(n_steps/2)``, the trailing odd substep dropped (``mc_tpu``'s take2
select).  The outer paths are ``price_cev``'s on the outer key.

Martingale gate: with full e^{-rT} discounting the conditional value of a
call is a martingale, so its expected-exposure profile is flat at the time-0
CEV price (``cev_call_closed_form``) at every step.
"""

from __future__ import annotations

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER
from mc_tpu_torch.models.cev import (CEV_TAG, DEMO_CEV, FAMILY_CEV,
                                     CEVDynamics, check_cev_params,
                                     cev_substep, pack_cev, unpack_cev)
from mc_tpu_torch.models.merton import counters, steps_index
from mc_tpu_torch.nmc import NMCResult
from mc_tpu_torch.nmc_engine import (NMCFamily, price_nmc_family,
                                     register_nmc_family)

__all__ = ["CEVNMC", "price_nmc_cev"]


class CEVNMC(NMCFamily):
    """CEV physics for the engine: market grid (S,); no extras."""

    name = "CEV"
    tag = CEV_TAG
    n_grids = 1
    even_steps = True
    cuda_id = FAMILY_CEV
    legs = 2  # csrc kLegs

    def span(self, n_steps, n_inner):
        return ((n_steps + 1) * n_inner * ((n_steps + 1) // 2),
                "(n_steps+1)*n_inner*ceil(n_steps/2)")

    def counter_stride(self, n_steps):
        return (n_steps + 1) // 2  # one pair per two substeps

    def pack(self, option, dyn, n_steps, device):
        return pack_cev(option, dyn, n_steps, device)

    def unpack(self, params):
        return unpack_cev(params)

    def check_params(self, params, n_steps):
        check_cev_params(params)

    def outer_init(self, payoff, p, like):
        zero = torch.zeros_like(like)
        return zero + p.s0, payoff.init(p, zero)

    def outer_draws(self, k0, k1, ids, steps):
        # step j takes half j % 2 of pair j // 2
        z0, z1 = rng.normal_pair(k0, k1, ids, counters(ids, steps // 2))
        return (torch.where(steps % 2 == 0, z0, z1),)

    def outer_step(self, payoff, p, carry, draws):
        s, state = cev_substep(payoff, p, *carry, draws[0])
        word0 = state[0] if payoff.n_state else torch.zeros_like(s)
        return (s, state), (s, word0)

    def outer_pay(self, payoff, p, carry):
        s, state = carry
        return payoff.terminal(state, s, p)

    def leg(self, payoff, p, k0, k1, ids, c_base, remaining, grids_j,
            state_j):
        (s,), state = grids_j, state_j
        n_pairs = (remaining + 1) // 2
        if n_pairs:  # every pair's normals at once
            z0, z1 = rng.normal_pair(
                k0, k1, ids, counters(ids, c_base + steps_index(n_pairs,
                                                                c_base)))
        for q in range(n_pairs):
            s, state = cev_substep(payoff, p, s, state, z0[q])
            if 2 * q + 1 < remaining:  # mc_tpu's take2
                s, state = cev_substep(payoff, p, s, state, z1[q])
        return payoff.terminal(state, s, p)


def price_nmc_cev(option: OptionParams = DEMO_OPTION,
                  dyn: CEVDynamics = DEMO_CEV,
                  sim: SimParams = DEMO_SIM,
                  payoff="vanilla_call",
                  *,
                  strategy: str = "grid",
                  stream_outer: int = STREAM_OUTER,
                  stream_inner: int = STREAM_INNER,
                  device="cuda") -> NMCResult:
    """Nested MC price surface under CEV local volatility: exposure
    profiles and CVA under the parametric skew.  The outer paths are
    ``price_cev``'s on the same key (an even ``n_steps``).  ``strategy``:
    "grid" (the generic trajectories kernel, then the inner kernel; the
    result carries the spot grid) or "fused" (one kernel)."""
    return price_nmc_family(CEVNMC(), option, dyn.as_f32(), sim, payoff,
                            strategy=strategy, stream_outer=stream_outer,
                            stream_inner=stream_inner, device=device)


def _cev_builder(option, dyn, sim):
    return CEVNMC(), (DEMO_CEV if dyn is None else dyn).as_f32()


register_nmc_family("cev", price_nmc_cev, _cev_builder)
