"""Nested Monte Carlo under a local-volatility surface
(port of ``mc_tpu/nmc_localvol.py:52-207``).

Every (path, step) point of the outer trajectories is re-priced by
``sim.n_paths_inner`` inner legs resumed from the stored spot S_t and payoff
state: exposure profiles and CVA under the smile.  The surface is a function
of the absolute log-moneyness log(S/S0) and the calendar step, so an inner
leg at row j starts from w = log(S_t / s0) and its substep u reads surface
row j+1+u.  The engine is `nmc_engine`; this module supplies the local-vol
physics (``models.localvol.localvol_step``), the outer grids from
``models.localvol.localvol_trajectories`` (#20), and the knot count as the
family's extras ``(n_knots,)``.

Inner draws: point (path i, step j), inner path m takes the threefry-13 pair
``(i, c_base + q)`` for substeps 2q and 2q+1, ``c_base = ((j+1)*n_inner + m)
* ceil(n_steps/2)``, the trailing odd substep dropped (``mc_tpu``'s take2
select).  The inner leg pays on S = s0*exp(w) recomputed from w at its last
substep (at the last row, with no substep left, on s0*exp(log(S_t/s0)), not
S_t), as ``mc_tpu`` does; the outer paths carry S and pay on the spot the
step stored.

Martingale gate: with full e^{-rT} discounting the conditional value of a
non-negative payoff is a martingale, so a call's expected-exposure profile
is flat at the time-0 price at every step: the smile moves the PFE
quantiles, never the EE mean.
"""

from __future__ import annotations

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER
from mc_tpu_torch.models.localvol import (DEMO_LOCALVOL, FAMILY_LOCALVOL,
                                          LOCALVOL_TAG, LocalVolConfig,
                                          LocalVolSurface,
                                          check_localvol_params,
                                          localvol_step,
                                          localvol_trajectories,
                                          localvol_trajectories_plain,
                                          pack_localvol, unpack_localvol,
                                          validate_surface)
from mc_tpu_torch.models.merton import counters, steps_index
from mc_tpu_torch.nmc import NMCResult
from mc_tpu_torch.nmc_engine import (NMCFamily, price_nmc_family,
                                     register_nmc_family)

__all__ = ["LocalVolNMC", "price_nmc_localvol"]


class LocalVolNMC(NMCFamily):
    """Local-vol physics for the engine: market grid (S,); ``extras =
    (n_knots,)``, the surface's knot count."""

    name = "localvol"
    tag = LOCALVOL_TAG
    n_grids = 1
    even_steps = True
    cuda_id = FAMILY_LOCALVOL
    legs = 4  # csrc kLegs

    @property
    def n_knots(self) -> int:
        return self.extras[0]

    def span(self, n_steps, n_inner):
        return ((n_steps + 1) * n_inner * ((n_steps + 1) // 2),
                "(n_steps+1)*n_inner*ceil(n_steps/2)")

    def counter_stride(self, n_steps):
        return (n_steps + 1) // 2  # one pair per two substeps

    def pack(self, option, dyn, n_steps, device):
        return pack_localvol(option, dyn, n_steps, device)

    def unpack(self, params):
        return unpack_localvol(params, self.n_knots)

    def check_params(self, params, n_steps):
        check_localvol_params(params, self.n_knots, n_steps)

    def _cfg(self, cfg):
        return LocalVolConfig(n_paths=cfg.n_paths, n_steps=cfg.n_steps,
                              n_knots=self.n_knots)

    def trajectories(self, payoff, cfg, key, params, path_offset=0,
                     n_valid=None):
        return localvol_trajectories(payoff, self._cfg(cfg), key, params,
                                     path_offset, n_valid)

    def trajectories_plain(self, payoff, cfg, key, params, path_offset=0,
                           n_valid=None):
        return localvol_trajectories_plain(payoff, self._cfg(cfg), key,
                                           params, path_offset, n_valid)

    def leg(self, payoff, p, k0, k1, ids, c_base, remaining, grids_j,
            state_j):
        (s_t,), state = grids_j, state_j
        w = torch.log(s_t / p.s0)  # the absolute log-moneyness at the point
        s = p.s0 * torch.exp(w)
        row = p.n_steps - remaining  # j + 1
        n_pairs = (remaining + 1) // 2
        if n_pairs:  # every pair's normals at once
            z0, z1 = rng.normal_pair(
                k0, k1, ids, counters(ids, c_base + steps_index(n_pairs,
                                                                c_base)))
        for q in range(n_pairs):
            w, s, state = localvol_step(payoff, p, w, state, z0[q],
                                        row + 2 * q)
            if 2 * q + 1 < remaining:  # mc_tpu's take2
                w, s, state = localvol_step(payoff, p, w, state, z1[q],
                                            row + 2 * q + 1)
        return payoff.terminal(state, s, p)


def _family(surf: LocalVolSurface, n_steps: int):
    if surf is None:
        surf = (DEMO_LOCALVOL if n_steps == 100
                else LocalVolSurface.demo(n_steps))
    s32 = validate_surface(surf, n_steps)
    return LocalVolNMC(extras=(s32.n_knots,)), s32


def price_nmc_localvol(option: OptionParams = DEMO_OPTION,
                       surf: LocalVolSurface = None,
                       sim: SimParams = DEMO_SIM,
                       payoff="vanilla_call",
                       *,
                       strategy: str = "grid",
                       stream_outer: int = STREAM_OUTER,
                       stream_inner: int = STREAM_INNER,
                       device="cuda") -> NMCResult:
    """Nested MC price surface under a local-volatility smile (default: the
    demo surface at ``sim.n_steps``).  The outer paths are
    ``price_localvol``'s threefry-13 paths on the same key (an even
    ``n_steps``).  ``strategy``: "grid" (the local-vol trajectories kernel,
    then the inner kernel; the result carries the spot grid) or "fused"
    (one kernel)."""
    fam, s32 = _family(surf, sim.n_steps)
    return price_nmc_family(fam, option, s32, sim, payoff,
                            strategy=strategy, stream_outer=stream_outer,
                            stream_inner=stream_inner, device=device)


def _localvol_builder(option, dyn, sim):
    return _family(dyn, sim.n_steps)


register_nmc_family("localvol", price_nmc_localvol, _localvol_builder)
