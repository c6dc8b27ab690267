"""Nested Monte Carlo under Merton jump-diffusion
(port of ``mc_tpu/nmc_merton.py:44-201``).

Every (path, step) point of the outer trajectories is re-priced by
``sim.n_paths_inner`` inner legs resumed from the stored spot S_t and payoff
state (the compound-Poisson increments are i.i.d., so S is the whole market
state): exposure profiles under crash risk.  The engine is `nmc_engine`;
this module supplies the Merton physics: exact-in-law jump-diffusion inner
legs, the outer grids from ``models.merton.merton_trajectories``, and the
Poisson scan depth as the family's extras ``(kmax,)``.

Inner draws: point (path i, step j), inner path m, substep u takes the
threefry-13 pair ``(i, c_base + 2u)`` for (z, e) and word 0 of
``(i, c_base + 2u + 1)`` for the Poisson uniform, ``c_base = ((j+1)*n_inner
+ m) * 2 * n_steps``.  The outer paths are ``price_merton``'s Euler paths
(draw3 per step pair) on the outer key.
"""

from __future__ import annotations

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER
from mc_tpu_torch.models.merton import (DEMO_MERTON, FAMILY_MERTON,
                                        MERTON_TAG, MertonConfig,
                                        MertonDynamics,
                                        check_merton_params, counters,
                                        merton_step, merton_trajectories,
                                        merton_trajectories_plain,
                                        pack_merton, poisson_kmax,
                                        steps_index, unpack_merton)
from mc_tpu_torch.nmc import NMCResult
from mc_tpu_torch.nmc_engine import (NMCFamily, price_nmc_family,
                                     register_nmc_family)

__all__ = ["MertonNMC", "price_nmc_merton"]


class MertonNMC(NMCFamily):
    """Merton physics for the engine: market grid (S,); ``extras =
    (kmax,)``, the Poisson scan depth at lam*dt."""

    name = "merton"
    tag = MERTON_TAG
    n_grids = 1
    even_steps = True
    cuda_id = FAMILY_MERTON
    legs = 4  # csrc kLegs

    @property
    def kmax(self) -> int:
        return self.extras[0]

    def table_floats(self) -> int:
        return self.kmax  # the Poisson cdf F(0..kmax-1)

    def span(self, n_steps, n_inner):
        # c_base uses j+1 (up to n_steps) at stride 2*n_steps per leg.
        return (2 * (n_steps + 1) * n_inner * n_steps,
                "2*(n_steps+1)*n_inner*n_steps")

    def counter_stride(self, n_steps):
        return 2 * n_steps

    def pack(self, option, dyn, n_steps, device):
        return pack_merton(option, dyn, n_steps, device)

    def unpack(self, params):
        return unpack_merton(params)

    def check_params(self, params, n_steps):
        check_merton_params(params)

    def _cfg(self, cfg):
        return MertonConfig(n_paths=cfg.n_paths, n_steps=cfg.n_steps,
                            kmax=self.kmax)

    def trajectories(self, payoff, cfg, key, params, path_offset=0,
                     n_valid=None):
        return merton_trajectories(payoff, self._cfg(cfg), key, params,
                                   path_offset, n_valid)

    def trajectories_plain(self, payoff, cfg, key, params, path_offset=0,
                           n_valid=None):
        return merton_trajectories_plain(payoff, self._cfg(cfg), key, params,
                                         path_offset, n_valid)

    def leg(self, payoff, p, k0, k1, ids, c_base, remaining, grids_j,
            state_j):
        (s_t,) = grids_j
        w, s, state = torch.zeros_like(s_t), s_t, state_j
        if remaining:  # every substep's draws at once
            c = counters(ids, c_base + 2 * steps_index(remaining, c_base))
            z, e = rng.normal_pair(k0, k1, ids, c)
            b0, _ = rng.threefry2x32(k0, k1, ids, counters(ids, c + 1),
                                     rounds=rng.DEFAULT_ROUNDS)
            uu = rng.bits_to_unit(b0)
        for u in range(remaining):
            w, s, state = merton_step(payoff, p, self.kmax, s_t, w, state,
                                      z[u], e[u], uu[u])
        return payoff.terminal(state, s, p)


def _family(option, dyn, sim) -> MertonNMC:
    return MertonNMC(extras=(poisson_kmax(float(dyn.lam) * float(option.t)
                                          / sim.n_steps),))


def price_nmc_merton(option: OptionParams = DEMO_OPTION,
                     dyn: MertonDynamics = DEMO_MERTON,
                     sim: SimParams = DEMO_SIM,
                     payoff="vanilla_call",
                     *,
                     strategy: str = "grid",
                     stream_outer: int = STREAM_OUTER,
                     stream_inner: int = STREAM_INNER,
                     device="cuda") -> NMCResult:
    """Nested MC price surface under Merton jump-diffusion.

    Every (path, step) point is re-priced by ``sim.n_paths_inner`` inner
    jump-diffusion legs resumed from the stored (S_t, payoff state); the
    outer paths are ``price_merton``'s Euler threefry-13 paths on the same
    key (an even ``n_steps``).  ``strategy``: "grid" (the Merton
    trajectories kernel, then the inner kernel; the result carries the spot
    grid) or "fused" (one kernel).
    """
    return price_nmc_family(_family(option, dyn, sim), option, dyn.as_f32(),
                            sim, payoff, strategy=strategy,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner, device=device)


def _merton_builder(option, dyn, sim):
    dyn = DEMO_MERTON if dyn is None else dyn
    return _family(option, dyn, sim), dyn.as_f32()


register_nmc_family("merton", price_nmc_merton, _merton_builder)
