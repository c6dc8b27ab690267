"""Nested Monte Carlo under Bates SVJ (Heston + compound-Poisson jumps)
(port of ``mc_tpu/nmc_bates.py:47-222``).

Every (path, step) point is re-priced by ``sim.n_paths_inner`` inner legs
resumed from the stored market state (S_t, v_t) and payoff state (jumps are
i.i.d. across steps, so (S, v) stays the whole market state): exposure
under stochastic volatility and crash risk together.  The engine is
`nmc_engine`; this module supplies the Bates physics, Heston's Euler step
then Merton's jump (``models.bates.bates_euler_step``), and the Poisson scan
depth as the family's extras ``(kmax,)``.  Bates has no trajectories kernel
of its own: its outer grids come from the engine's generic
``family_trajectories``, as ``mc_tpu`` builds them with its XLA scan.

Inner draws: point (path i, step j), inner path m, substep u takes counters
``c_base + 3u`` (the diffusion pair), ``+3u+1`` (the jump-size normal) and
``+3u+2`` (the Poisson uniform), ``c_base = ((j+1)*n_inner + m) * 3 *
n_steps``; the outer step j takes 3j, 3j+1, 3j+2: ``price_bates``'s Euler
paths on the outer key.
"""

from __future__ import annotations

import torch

from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER
from mc_tpu_torch.models.bates import (BATES_TAG, DEMO_BATES, FAMILY_BATES,
                                       BatesDynamics, bates_euler_draw,
                                       bates_euler_step,
                                       check_bates_params, pack_bates,
                                       unpack_bates)
from mc_tpu_torch.models.merton import poisson_kmax, steps_index
from mc_tpu_torch.nmc import NMCResult
from mc_tpu_torch.nmc_engine import (NMCFamily, price_nmc_family,
                                     register_nmc_family)

__all__ = ["BatesNMC", "price_nmc_bates"]


class BatesNMC(NMCFamily):
    """Bates physics for the engine: market grids (S, v); ``extras =
    (kmax,)``, the Poisson scan depth at lam*dt."""

    name = "bates"
    tag = BATES_TAG
    n_grids = 2
    even_steps = False
    cuda_id = FAMILY_BATES
    legs = 2  # csrc kLegs

    @property
    def kmax(self) -> int:
        return self.extras[0]

    def table_floats(self) -> int:
        return self.kmax  # the Poisson cdf F(0..kmax-1)

    def span(self, n_steps, n_inner):
        # c_base uses j+1 (up to n_steps) at stride 3*n_steps per leg.
        return (3 * (n_steps + 1) * n_inner * n_steps,
                "3*(n_steps+1)*n_inner*n_steps")

    def counter_stride(self, n_steps):
        return 3 * n_steps

    def pack(self, option, dyn, n_steps, device):
        return pack_bates(option, dyn, n_steps, device)

    def unpack(self, params):
        return unpack_bates(params)

    def check_params(self, params, n_steps):
        check_bates_params(params)

    def outer_init(self, payoff, p, like):
        zero = torch.zeros_like(like)
        return zero, zero + p.v0, zero + p.s0, payoff.init(p, zero)

    def outer_draws(self, k0, k1, ids, steps):
        return bates_euler_draw(k0, k1, ids, 3 * steps)

    def outer_step(self, payoff, p, carry, draws):
        w, v, s, state = carry
        w, v, s, state = bates_euler_step(payoff, p, self.kmax, p.s0, w, v,
                                          state, *draws)
        word0 = state[0] if payoff.n_state else torch.zeros_like(s)
        return (w, v, s, state), (s, v, word0)

    def outer_pay(self, payoff, p, carry):
        _, _, s, state = carry
        return payoff.terminal(state, s, p)

    def leg(self, payoff, p, k0, k1, ids, c_base, remaining, grids_j,
            state_j):
        s_t, v = grids_j
        w, s, state = torch.zeros_like(s_t), s_t, state_j
        if remaining:  # every substep's draws at once
            draws = bates_euler_draw(
                k0, k1, ids, c_base + 3 * steps_index(remaining, c_base))
        for u in range(remaining):
            w, v, s, state = bates_euler_step(payoff, p, self.kmax, s_t, w, v,
                                              state, *(d[u] for d in draws))
        return payoff.terminal(state, s, p)


def _family(option, dyn, sim) -> BatesNMC:
    return BatesNMC(extras=(poisson_kmax(float(dyn.lam) * float(option.t)
                                         / sim.n_steps),))


def price_nmc_bates(option: OptionParams = DEMO_OPTION,
                    dyn: BatesDynamics = DEMO_BATES,
                    sim: SimParams = DEMO_SIM,
                    payoff="vanilla_call",
                    *,
                    strategy: str = "grid",
                    stream_outer: int = STREAM_OUTER,
                    stream_inner: int = STREAM_INNER,
                    device="cuda") -> NMCResult:
    """Nested MC price surface under Bates SVJ dynamics.

    Every (path, step) point is re-priced by ``sim.n_paths_inner`` inner
    SVJ legs resumed from the stored (S_t, v_t, payoff state); the outer
    paths are ``price_bates``'s Euler threefry-13 paths on the same key.
    ``strategy``: "grid" (the generic trajectories kernel, then the inner
    kernel; the result carries the spot grid) or "fused" (one kernel).
    """
    return price_nmc_family(_family(option, dyn, sim), option, dyn.as_f32(),
                            sim, payoff, strategy=strategy,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner, device=device)


def _bates_builder(option, dyn, sim):
    dyn = DEMO_BATES if dyn is None else dyn
    return _family(option, dyn, sim), dyn.as_f32()


register_nmc_family("bates", price_nmc_bates, _bates_builder)
