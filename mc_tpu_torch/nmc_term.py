"""Nested Monte Carlo under term structures (port of
``mc_tpu/nmc_term.py:36-162``).

Every (path, step) point of the outer trajectories is re-priced by
``sim.n_paths_inner`` inner legs resumed from the stored spot S_t and payoff
state: exposure profiles whose underlying drifts with the rate curve and
diffuses with the calendar-dated vol.  The engine is `nmc_engine`; this
module supplies the term-structure physics (``models.term.term_step``).
Term has no trajectories kernel of its own: its outer S grid comes from the
engine's generic ``family_trajectories``, as ``mc_tpu`` builds it with its
XLA scan.

The outer paths are ``price_term``'s (pair j/2 per step, the curves' entry
j), carrying the rounded S = s0*exp(w) the step stored, which the outer
payoff reads.  Inner draws: point (path i, step j), inner path m takes the
threefry-13 pair ``(i, c_base + q)`` for substeps 2q and 2q+1, ``c_base =
((j+1)*n_inner + m) * ceil(n_steps/2)``, the trailing odd substep dropped
(``mc_tpu``'s take2 select).  The legs read the curves by the ABSOLUTE move
index j+1+u and restart from w = log(S_t/s0), paying on s0*exp(w) (at the
last row on s0*exp(log(S_T/s0)), not S_T), as ``mc_tpu`` does.  Discounting
is the curve average e^{-r_bar T}, ``price_term``'s.

Martingale gate: the fully discounted conditional value of a call is then a
martingale, so its EE profile is flat at the time-0 term price.
"""

from __future__ import annotations

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER
from mc_tpu_torch.models.merton import counters, steps_index
from mc_tpu_torch.models.term import (FAMILY_TERM, TERM_TAG, TermStructure,
                                      check_term_params, demo_term, pack_term,
                                      term_step, unpack_term, validate_term)
from mc_tpu_torch.nmc import NMCResult
from mc_tpu_torch.nmc_engine import (NMCFamily, price_nmc_family,
                                     register_nmc_family)

__all__ = ["TermNMC", "price_nmc_term"]


class TermNMC(NMCFamily):
    """Term-structure physics for the engine: market grid (S,); no extras
    (the kernels get the curves' length as n_steps)."""

    name = "term"
    tag = TERM_TAG
    n_grids = 1
    even_steps = True
    cuda_id = FAMILY_TERM
    legs = 4  # csrc kLegs

    def span(self, n_steps, n_inner):
        return ((n_steps + 1) * n_inner * ((n_steps + 1) // 2),
                "(n_steps+1)*n_inner*ceil(n_steps/2)")

    def counter_stride(self, n_steps):
        return (n_steps + 1) // 2  # one pair per two substeps

    def pack(self, option, dyn, n_steps, device):
        return pack_term(option, dyn, n_steps, device)

    def unpack(self, params):
        return unpack_term(params)

    def check_params(self, params, n_steps):
        check_term_params(params, n_steps)

    def outer_init(self, payoff, p, like):
        zero = torch.zeros_like(like)
        return zero, zero + p.s0, payoff.init(p, zero), 0  # ..., step j

    def outer_draws(self, k0, k1, ids, steps):
        # step j takes half j % 2 of pair j // 2
        z0, z1 = rng.normal_pair(k0, k1, ids, counters(ids, steps // 2))
        return (torch.where(steps % 2 == 0, z0, z1),)

    def outer_step(self, payoff, p, carry, draws):
        w, _, state, j = carry
        w, s, state = term_step(payoff, p, w, state, draws[0], j)
        word0 = state[0] if payoff.n_state else torch.zeros_like(s)
        return (w, s, state, j + 1), (s, word0)

    def outer_pay(self, payoff, p, carry):
        _, s, state, _ = carry
        return payoff.terminal(state, s, p)

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
            w, s, state = term_step(payoff, p, w, state, z0[q], row + 2 * q)
            if 2 * q + 1 < remaining:  # mc_tpu's take2
                w, s, state = term_step(payoff, p, w, state, z1[q],
                                        row + 2 * q + 1)
        return payoff.terminal(state, s, p)


def price_nmc_term(option: OptionParams = DEMO_OPTION,
                   dyn: TermStructure = None,
                   sim: SimParams = DEMO_SIM,
                   payoff="vanilla_call",
                   *,
                   strategy: str = "grid",
                   stream_outer: int = STREAM_OUTER,
                   stream_inner: int = STREAM_INNER,
                   device="cuda") -> NMCResult:
    """Nested MC price surface under deterministic r(t)/sigma(t) curves
    (default the demo curves, ``demo_term(sim.n_steps)``; an even
    ``n_steps``).  The outer paths are ``price_term``'s on the same key.
    ``strategy``: "grid" (the generic trajectories kernel, then the inner
    kernel; the result carries the spot grid) or "fused" (one kernel)."""
    _, t32 = _term_builder(option, dyn, sim)
    return price_nmc_family(TermNMC(), option, t32, sim, payoff,
                            strategy=strategy, stream_outer=stream_outer,
                            stream_inner=stream_inner, device=device)


def _term_builder(option, dyn, sim):
    if dyn is None:
        dyn = demo_term(sim.n_steps)
    return TermNMC(), validate_term(dyn, sim.n_steps)


register_nmc_family("term", price_nmc_term, _term_builder)
