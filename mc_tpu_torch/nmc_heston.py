"""Nested Monte Carlo under Heston stochastic volatility
(port of ``mc_tpu/nmc_heston.py:41-158``).

Every (path, step) point of the outer trajectories is re-priced by
``sim.n_paths_inner`` inner legs resumed from the stored market state
(S_t, v_t) and payoff state: exposure profiles under stochastic volatility
for XVA.  The engine is `nmc_engine`; this module supplies the Heston
physics: full-truncation Euler inner legs resumed from (S_t, v_t), the
outer grids from ``models.heston.heston_trajectories`` (the family
template's trajectories kernel, ``csrc/family.cuh``), whose plain outer
hooks here (``outer_init``, ``outer_draws``, ``outer_step``, ``outer_pay``)
give ``heston_trajectories_plain``'s grids bit for bit through
``nmc_engine.family_trajectories_plain``.

Inner draws: point (path i, step j), inner path m, substep u takes the
threefry-13 pair ``(i, ((j+1)*n_inner + m)*n_steps + u)``, one Box-Muller
pair per substep (z_v and z_perp).
"""

from __future__ import annotations

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER
from mc_tpu_torch.models.heston import (DEMO_HESTON, FAMILY_HESTON,
                                        HESTON_TAG, HestonConfig,
                                        HestonDynamics, check_heston_params,
                                        heston_euler_step,
                                        heston_trajectories,
                                        heston_trajectories_plain,
                                        pack_heston, unpack_heston)
from mc_tpu_torch.models.merton import counters
from mc_tpu_torch.nmc import NMCResult
from mc_tpu_torch.nmc_engine import (NMCFamily, price_nmc_family,
                                     register_nmc_family)

__all__ = ["HestonNMC", "price_nmc_heston"]


class HestonNMC(NMCFamily):
    """Heston physics for the engine: market grids (S, v)."""

    name = "heston"
    tag = HESTON_TAG
    n_grids = 2
    even_steps = False
    cuda_id = FAMILY_HESTON
    legs = 1  # csrc kLegs

    def span(self, n_steps, n_inner):
        return n_steps * n_inner * n_steps, "n_steps^2 * n_inner"

    def pack(self, option, dyn, n_steps, device):
        return pack_heston(option, dyn, n_steps, device)

    def unpack(self, params):
        return unpack_heston(params)

    def check_params(self, params, n_steps):
        check_heston_params(params)

    @staticmethod
    def _cfg(cfg):
        return HestonConfig(n_paths=cfg.n_paths, n_steps=cfg.n_steps)

    def trajectories(self, payoff, cfg, key, params, path_offset=0,
                     n_valid=None):
        return heston_trajectories(payoff, self._cfg(cfg), key, params,
                                   path_offset, n_valid)

    def trajectories_plain(self, payoff, cfg, key, params, path_offset=0,
                           n_valid=None):
        return heston_trajectories_plain(payoff, self._cfg(cfg), key, params,
                                         path_offset, n_valid)

    # The outer path (the family template's HestonFamily): step j on the
    # threefry-13 pair (id, j), heston_trajectories_plain's step.
    def outer_init(self, payoff, p, like):
        zero = torch.zeros_like(like)
        return zero, zero + p.v0, zero + p.s0, payoff.init(p, zero)

    def outer_draws(self, k0, k1, ids, steps):
        return rng.normal_pair(k0, k1, ids, counters(ids, steps))

    def outer_step(self, payoff, p, carry, draws):
        w, v, s, state = carry
        w, v = heston_euler_step(p, w, v, *draws, p.dt, p.sqrt_dt)
        s = (torch.zeros_like(w) + p.s0) * torch.exp(w)
        state = payoff.update(state, s, p)
        word0 = state[0] if payoff.n_state else torch.zeros_like(s)
        return (w, v, s, state), (s, v, word0)

    def outer_pay(self, payoff, p, carry):
        _, _, s, state = carry
        return payoff.terminal(state, s, p)

    def leg(self, payoff, p, k0, k1, ids, c_base, remaining, grids_j,
            state_j):
        s_t, v = grids_j
        w, s, state = torch.zeros_like(s_t), s_t, state_j
        for u in range(remaining):
            z_v, z_p = rng.normal_pair(k0, k1, ids,
                                       ((c_base + u) & 0xFFFFFFFF)
                                       .expand_as(ids))
            w, v = heston_euler_step(p, w, v, z_v, z_p, p.dt, p.sqrt_dt)
            s = s_t * torch.exp(w)
            state = payoff.update(state, s, p)
        return payoff.terminal(state, s, p)


def price_nmc_heston(option: OptionParams = DEMO_OPTION,
                     heston: HestonDynamics = DEMO_HESTON,
                     sim: SimParams = DEMO_SIM,
                     payoff="vanilla_call",
                     *,
                     strategy: str = "grid",
                     stream_outer: int = STREAM_OUTER,
                     stream_inner: int = STREAM_INNER,
                     device="cuda") -> NMCResult:
    """Nested MC price surface under Heston stochastic volatility.

    Every (path, step) point is re-priced by ``sim.n_paths_inner`` inner
    legs resumed from (S_t, v_t) and the payoff state; the outer paths are
    ``price_heston``'s Euler threefry-13 paths on the same key.
    ``strategy``: "grid" (the trajectories kernel, then the inner kernel;
    the result carries the spot grid) or "fused" (one kernel).
    """
    return price_nmc_family(HestonNMC(), option, heston.as_f32(), sim,
                            payoff, strategy=strategy,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner, device=device)


def _heston_builder(option, dyn, sim):
    return HestonNMC(), (DEMO_HESTON if dyn is None else dyn).as_f32()


register_nmc_family("heston", price_nmc_heston, _heston_builder)
