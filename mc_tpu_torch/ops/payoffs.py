"""Path-payoff registry (port of ``mc_tpu/ops/payoffs.py:28-96,157-177``).

A payoff is a small static object with three pure functions over
``(state, S, params)``: ``init``, ``update`` (after every step) and
``terminal``.  The plain PyTorch versions below run on tensors of any
device; ``csrc/payoffs.cuh`` holds the same three payoffs as CUDA template
functors, picked by ``cuda_id``.  State arrays are f32, so a step count is
exact up to 2^24 steps.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

__all__ = ["PathPayoff", "PAYOFFS", "get_payoff"]

State = Tuple[Any, ...]


class PathPayoff:
    """Base: a payoff accumulated along the path with O(1) state."""

    name: str = "base"
    n_state: int = 0
    # Payoffs that need no step loop (European) can be priced with the exact
    # one-shot terminal draw (trajectories.cuh:74-75).
    terminal_only: bool = False
    # Index of the matching functor in csrc/payoffs.cuh (PAYOFF_* ids).
    cuda_id: int = -1

    def init(self, p, like) -> State:
        return ()

    def update(self, state: State, s, p) -> State:
        return state

    def terminal(self, state: State, s, p):
        raise NotImplementedError

    def __repr__(self):
        return f"<PathPayoff {self.name}>"


class VanillaCall(PathPayoff):
    """max(S_T - K, 0) — trajectories.cuh:76."""

    name = "vanilla_call"
    terminal_only = True
    cuda_id = 0

    def terminal(self, state, s, p):
        return torch.clamp(s - p.k, min=0.0)


class VanillaPut(PathPayoff):
    name = "vanilla_put"
    terminal_only = True
    cuda_id = 1

    def terminal(self, state, s, p):
        return torch.clamp(p.k - s, min=0.0)


class BulletCall(PathPayoff):
    """Barrier-window call (trajectories.cuh:144-153).

    state = (count,): number of steps with S < B, as f32.
    Pays max(S_T - K, 0) iff P1 <= count <= P2.
    """

    name = "bullet_call"
    n_state = 1
    cuda_id = 2

    def init(self, p, like):
        return (torch.zeros_like(like),)

    def update(self, state, s, p):
        (count,) = state
        return (count + (s < p.barrier).to(count.dtype),)

    def terminal(self, state, s, p):
        (count,) = state
        in_window = (count >= p.p1) & (count <= p.p2)
        return torch.where(in_window, torch.clamp(s - p.k, min=0.0), 0.0)


PAYOFFS: Dict[str, PathPayoff] = {
    po.name: po for po in (VanillaCall(), VanillaPut(), BulletCall())
}

# Payoffs of mc_tpu's registry that this package does not carry yet.
NOT_PORTED = (
    "asian_call", "asian_call_geo_cv", "best_of_cash", "cliquet",
    "digital_call", "digital_put", "down_in_call", "down_out_call",
    "down_out_call_bb", "forward_start_call", "lookback_call",
    "up_out_call", "up_out_call_bb", "variance_swap", "zcb",
)


def get_payoff(name_or_payoff) -> PathPayoff:
    if isinstance(name_or_payoff, PathPayoff):
        return name_or_payoff
    try:
        return PAYOFFS[name_or_payoff]
    except KeyError:
        raise KeyError(
            f"unknown payoff {name_or_payoff!r}; available: {sorted(PAYOFFS)}"
            f"; not yet ported from mc_tpu: {list(NOT_PORTED)}") from None
