"""Path-payoff registry (port of ``mc_tpu/ops/payoffs.py``, all 18 payoffs).

A payoff is a small static object with three pure functions over
``(state, S, params)``: ``init``, ``update`` (after every step) and
``terminal``.  The plain PyTorch versions below run on tensors of any
device; ``csrc/payoffs.cuh`` holds the same payoffs as CUDA functors with a
state struct, picked by ``cuda_id``.  State arrays are f32, so a step count
is exact up to 2^24 steps.

The arithmetic follows ``mc_tpu`` operation for operation (same operands,
same association), so a kernel built with ``--fmad=false`` rounds each value
as the plain version does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

__all__ = ["PathPayoff", "PAYOFFS", "get_payoff"]

State = Tuple[Any, ...]


class PathPayoff:
    """Base: a payoff accumulated along the path with O(1) state.

    ``init(params, like)`` -> state tuple of tensors shaped like ``like``;
    ``update(state, s, params)`` -> state, applied after every Euler step;
    ``terminal(state, s, params)`` -> payoff tensor.
    """

    name: str = "base"
    n_state: int = 0
    # Payoffs that need no step loop (European) can be priced with the exact
    # one-shot terminal draw (trajectories.cuh:74-75).
    terminal_only: bool = False
    # Index of the matching functor in csrc/payoffs.cuh (PayoffId).
    cuda_id: int = -1

    def init(self, p, like) -> State:
        return ()

    def update(self, state: State, s, p) -> State:
        return state

    def terminal(self, state: State, s, p):
        raise NotImplementedError

    def validate(self, option, n_steps: int) -> None:
        """Entry-point validation with concrete option fields; array-valued
        fields (a book) are skipped."""

    # Optional payoff-specific control variate: ``control(state, s, p)``
    # returns the per-path control X and ``control_expectation(p)`` its
    # exact expectation (engines fall back to X = S_T, E[X] = S0 e^{(r-q)T}).
    has_control: bool = False

    def control(self, state: State, s, p):
        raise NotImplementedError

    def control_expectation(self, p):
        raise NotImplementedError

    def __repr__(self):
        return f"<PathPayoff {self.name}>"


def _scalar(v):
    """``float(v)`` for a scalar field, None for an array-valued one."""
    return None if getattr(v, "ndim", 0) else float(v)


def _step(cond, like):
    """1.0 where cond holds, else 0.0, in the dtype of ``like``."""
    return cond.to(like.dtype)


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


class DigitalCall(PathPayoff):
    """Cash-or-nothing digital call: pays 1 iff S_T > K (closed form
    e^{-rT} N(d2), ``oracle.bs_digital_call``)."""

    name = "digital_call"
    terminal_only = True
    cuda_id = 3

    def terminal(self, state, s, p):
        return _step(s > p.k, s)


class DigitalPut(PathPayoff):
    """Cash-or-nothing digital put: pays 1 iff S_T < K; with the call it
    sums to the discount bond path by path."""

    name = "digital_put"
    terminal_only = True
    cuda_id = 4

    def terminal(self, state, s, p):
        return _step(s < p.k, s)


class BestOfCash(PathPayoff):
    """max(S_T, K): e^{-rT} E[max(S_T, K)] = K e^{-rT} + bs_call."""

    name = "best_of_cash"
    terminal_only = True
    cuda_id = 5

    def terminal(self, state, s, p):
        return torch.maximum(s, p.k)


class ZeroCouponBond(PathPayoff):
    """Pays 1 at maturity: e^{-rT} exactly under deterministic rates."""

    name = "zcb"
    terminal_only = True
    cuda_id = 6

    def terminal(self, state, s, p):
        return torch.ones_like(s)


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
        return (count + _step(s < p.barrier, count),)

    def terminal(self, state, s, p):
        (count,) = state
        in_window = (count >= p.p1) & (count <= p.p2)
        return torch.where(in_window, torch.clamp(s - p.k, min=0.0), 0.0)


class AsianCall(PathPayoff):
    """Arithmetic-average Asian call: max(mean(S_1..S_N) - K, 0).
    state = (running sum of S,)."""

    name = "asian_call"
    n_state = 1
    cuda_id = 7

    def init(self, p, like):
        return (torch.zeros_like(like),)

    def update(self, state, s, p):
        (acc,) = state
        return (acc + s,)

    def terminal(self, state, s, p):
        (acc,) = state
        return torch.clamp(acc * p.inv_n_steps - p.k, min=0.0)


class UpOutCall(PathPayoff):
    """Up-and-out call: pays max(S_T-K,0) unless S ever >= B (discrete
    monitoring).  state = (alive flag as f32,)."""

    name = "up_out_call"
    n_state = 1
    cuda_id = 8

    def init(self, p, like):
        return (torch.ones_like(like),)

    def update(self, state, s, p):
        (alive,) = state
        return (alive * _step(s < p.barrier, alive),)

    def terminal(self, state, s, p):
        (alive,) = state
        return alive * torch.clamp(s - p.k, min=0.0)


class DownOutCall(PathPayoff):
    """Down-and-out call: dies if S ever < B; with `DownInCall` it sums to
    the vanilla path by path."""

    name = "down_out_call"
    n_state = 1
    cuda_id = 9

    def init(self, p, like):
        return (torch.ones_like(like),)

    def update(self, state, s, p):
        (alive,) = state
        return (alive * _step(s >= p.barrier, alive),)

    def terminal(self, state, s, p):
        (alive,) = state
        return alive * torch.clamp(s - p.k, min=0.0)


class DownInCall(PathPayoff):
    """Down-and-in call: pays only if S ever < B."""

    name = "down_in_call"
    n_state = 1
    cuda_id = 10

    def init(self, p, like):
        return (torch.zeros_like(like),)

    def update(self, state, s, p):
        (hit,) = state
        return (torch.maximum(hit, _step(s < p.barrier, hit)),)

    def terminal(self, state, s, p):
        (hit,) = state
        return hit * torch.clamp(s - p.k, min=0.0)


class LookbackFixedCall(PathPayoff):
    """Fixed-strike lookback call: max(max_t S_t - K, 0).

    state = (running max,).  As in ``mc_tpu``, ``init`` returns ``like``,
    which every caller passes as zeros: the running max starts at 0, not at
    S0, so the max is over S_1..S_N.
    """

    name = "lookback_call"
    n_state = 1
    cuda_id = 11

    def init(self, p, like):
        return (like,)

    def update(self, state, s, p):
        (m,) = state
        return (torch.maximum(m, s),)

    def terminal(self, state, s, p):
        (m,) = state
        return torch.clamp(m - p.k, min=0.0)


def _bridge_survival(surv, inside, a, bb, p):
    """surv * P(no crossing between two monitored steps): the crossing
    probability exp(-2 a b / (sigma^2 dt)) of the log-price bridge,
    associated left to right as ``mc_tpu`` writes it."""
    p_cross = torch.exp(-2.0 * a * bb / (p.sigma * p.sigma * p.dt))
    return surv * torch.where(inside, 1.0 - p_cross, 0.0)


class UpOutCallBB(PathPayoff):
    """Up-and-out call with the Brownian-bridge barrier correction: the
    product of the one-step survival probabilities of the log-price bridge
    gives an unbiased estimate of the continuously monitored price
    (Glasserman, section 6.4).  state = (prev S, survival weight)."""

    name = "up_out_call_bb"
    n_state = 2
    cuda_id = 12

    def init(self, p, like):
        return (torch.zeros_like(like) + p.s0, torch.ones_like(like))

    def update(self, state, s, p):
        prev_s, surv = state
        a = torch.log(p.barrier / prev_s)
        bb = torch.log(p.barrier / s)
        below = (prev_s < p.barrier) & (s < p.barrier)
        return (s, _bridge_survival(surv, below, a, bb, p))

    def terminal(self, state, s, p):
        _, surv = state
        return surv * torch.clamp(s - p.k, min=0.0)


class DownOutCallBB(PathPayoff):
    """Down-and-out call with the Brownian-bridge correction, the crossing
    measured downward.  state = (prev S, survival weight)."""

    name = "down_out_call_bb"
    n_state = 2
    cuda_id = 13

    def init(self, p, like):
        return (torch.zeros_like(like) + p.s0, torch.ones_like(like))

    def update(self, state, s, p):
        prev_s, surv = state
        a = torch.log(prev_s / p.barrier)
        bb = torch.log(s / p.barrier)
        above = (prev_s > p.barrier) & (s > p.barrier)
        return (s, _bridge_survival(surv, above, a, bb, p))

    def terminal(self, state, s, p):
        _, surv = state
        return surv * torch.clamp(s - p.k, min=0.0)


class VarianceSwap(PathPayoff):
    """Realized-variance swap: sum((log S_i/S_{i-1})^2)/T - K, with K the
    VARIANCE strike.  state = (prev S, running sum of squared log
    returns)."""

    name = "variance_swap"
    n_state = 2
    cuda_id = 14

    def init(self, p, like):
        return (torch.zeros_like(like) + p.s0, torch.zeros_like(like))

    def update(self, state, s, p):
        prev_s, acc = state
        lr = torch.log(s / prev_s)
        return (s, acc + lr * lr)

    def terminal(self, state, s, p):
        _, acc = state
        return acc / p.t - p.k


class ForwardStartCall(PathPayoff):
    """Forward-start call: max(S_T - k * S_{t1}, 0), with ``k`` a RATIO and
    ``p1`` the determination STEP (the strike fixes after step p1; p1=0
    fixes at S0).  state = (step count, S at t1)."""

    name = "forward_start_call"
    n_state = 2
    cuda_id = 15

    def validate(self, option, n_steps):
        p1 = _scalar(option.p1)
        if p1 is None:
            return
        if p1 != int(p1) or not 0 <= p1 <= n_steps:
            raise ValueError(
                f"forward_start_call: p1 (determination step) must be an "
                f"integer in [0, n_steps={n_steps}], got {p1} — a "
                f"non-matching p1 would silently price a vanilla struck "
                f"at k*S0")

    def init(self, p, like):
        return (torch.zeros_like(like), torch.zeros_like(like) + p.s0)

    def update(self, state, s, p):
        count, s_ref = state
        count = count + 1.0
        s_ref = torch.where(count == p.p1, s, s_ref)
        return (count, s_ref)

    def terminal(self, state, s, p):
        _, s_ref = state
        return torch.clamp(s - p.k * s_ref, min=0.0)


class Cliquet(PathPayoff):
    """Ratchet cliquet: sum of period returns clamped to [p1, p2], reset
    every ``k`` steps (k is the PERIOD LENGTH in steps).
    state = (step count, S at last reset, acc)."""

    name = "cliquet"
    n_state = 3
    cuda_id = 16

    def validate(self, option, n_steps):
        k, p1, p2 = (_scalar(getattr(option, f)) for f in ("k", "p1", "p2"))
        if None in (k, p1, p2):
            return
        if k != int(k) or not 1 <= k <= n_steps:
            raise ValueError(
                f"cliquet: k (period length in steps) must be an integer "
                f"in [1, n_steps={n_steps}], got {k}")
        if p1 > p2:
            raise ValueError(f"cliquet: floor p1={p1} > cap p2={p2}")

    def init(self, p, like):
        return (torch.zeros_like(like), torch.zeros_like(like) + p.s0,
                torch.zeros_like(like))

    def update(self, state, s, p):
        count, s_ref, acc = state
        count = count + 1.0
        # torch.remainder is a floor-mod like Python's float %; for the
        # positive count and k it equals the kernel's truncating fmodf.
        reset = torch.remainder(count, p.k) == 0.0
        ret = torch.clamp(s / s_ref - 1.0, min=p.p1, max=p.p2)
        acc = torch.where(reset, acc + ret, acc)
        s_ref = torch.where(reset, s, s_ref)
        return (count, s_ref, acc)

    def terminal(self, state, s, p):
        _, _, acc = state
        return acc


class AsianCallGeoCV(AsianCall):
    """Arithmetic Asian call with the geometric-Asian control variate.

    state = (running sum of S, running sum of log S).  The control is the
    geometric-average call, whose discrete average is lognormal under GBM,
    so `control_expectation` is exact.
    """

    name = "asian_call_geo_cv"
    n_state = 2
    has_control = True
    cuda_id = 17

    def init(self, p, like):
        return (torch.zeros_like(like), torch.zeros_like(like))

    def update(self, state, s, p):
        acc, lacc = state
        return (acc + s, lacc + torch.log(s))

    def terminal(self, state, s, p):
        acc, _ = state
        return torch.clamp(acc * p.inv_n_steps - p.k, min=0.0)

    def control(self, state, s, p):
        _, lacc = state
        geo = torch.exp(lacc * p.inv_n_steps)
        return torch.clamp(geo - p.k, min=0.0)

    def control_expectation(self, p):
        # Discrete geometric average of GBM is lognormal:
        #   mean log: mu = ln S0 + (r - q - sigma^2/2) T (n+1)/(2n)
        #   var log:  s2 = sigma^2 T (n+1)(2n+1)/(6 n^2)
        # E[(G-K)+] = e^{mu+s2/2} N(d1) - K N(d2), d1=(mu-lnK+s2)/s, d2=d1-s.
        n = 1.0 / p.inv_n_steps
        mu = (torch.log(p.s0)
              + (p.r - p.q - 0.5 * p.sigma * p.sigma)
              * p.t * (n + 1.0) / (2.0 * n))
        s2 = (p.sigma * p.sigma * p.t
              * (n + 1.0) * (2.0 * n + 1.0) / (6.0 * n * n))
        s_ = torch.sqrt(s2)
        d1 = (mu - torch.log(p.k) + s2) / s_
        d2 = d1 - s_
        return (torch.exp(mu + 0.5 * s2) * torch.special.ndtr(d1)
                - p.k * torch.special.ndtr(d2))


PAYOFFS: Dict[str, PathPayoff] = {
    po.name: po
    for po in (
        VanillaCall(), VanillaPut(), DigitalCall(), BulletCall(),
        AsianCall(), AsianCallGeoCV(), UpOutCall(), DownInCall(),
        DownOutCall(), UpOutCallBB(), DownOutCallBB(),
        LookbackFixedCall(), VarianceSwap(), ZeroCouponBond(),
        ForwardStartCall(), Cliquet(), DigitalPut(), BestOfCash(),
    )
}


def get_payoff(name_or_payoff) -> PathPayoff:
    if isinstance(name_or_payoff, PathPayoff):
        return name_or_payoff
    try:
        return PAYOFFS[name_or_payoff]
    except KeyError:
        raise KeyError(
            f"unknown payoff {name_or_payoff!r}; available: {sorted(PAYOFFS)}"
        ) from None
