"""Closed-form oracle and the Monte Carlo result type
(port of ``mc_tpu/oracle.py:63-71,605-638``).

``bs_call`` is host f64 through ``math.erf``; ``summarize`` turns f64 moment
sums into a `PriceResult` on whatever device the sums live.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["bs_call", "PriceResult", "summarize"]


def _ncdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def bs_call(s0, k, t, r, sigma, q=0.0) -> float:
    """European call, exact closed form with continuous dividend yield
    (cf. BlackandScholes.hpp:34-43, which has q=0)."""
    s0, k, t, r, sigma, q = map(float, (s0, k, t, r, sigma, q))
    sqrt_t = math.sqrt(t)
    d1 = (math.log(s0 / k) + (r - q + 0.5 * sigma * sigma) * t) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return (s0 * math.exp(-q * t) * _ncdf(d1)
            - k * math.exp(-r * t) * _ncdf(d2))


@dataclasses.dataclass(frozen=True)
class PriceResult:
    """A Monte Carlo price with its statistical error (0-d f64 tensors).

    Every engine returns the standard error beside the estimate, so
    correctness is checkable as |price - oracle| <= 3 * stderr.
    """

    price: Any          # discounted mean payoff
    stderr: Any         # standard error of the discounted mean
    n_paths: Any        # effective number of (outer) paths
    payoff_mean: Any    # undiscounted mean payoff
    payoff_var: Any     # undiscounted payoff sample variance

    def within(self, oracle_price: float, n_se: float = 3.0) -> bool:
        """|price - oracle| <= n_se * stderr (the acceptance criterion)."""
        return abs(float(self.price) - oracle_price) <= n_se * float(self.stderr)


def summarize(sum_w, sum_w2, n, discount) -> PriceResult:
    """Build a PriceResult from f64 accumulators of payoff and payoff^2."""
    sum_w = torch.as_tensor(sum_w, dtype=torch.float64)
    sum_w2 = torch.as_tensor(sum_w2, dtype=torch.float64, device=sum_w.device)
    n = torch.as_tensor(n, dtype=torch.float64, device=sum_w.device)
    mean = sum_w / n
    var = (torch.clamp(sum_w2 / n - mean * mean, min=0.0)
           * (n / torch.clamp(n - 1.0, min=1.0)))
    stderr = torch.sqrt(var / n) * discount
    return PriceResult(
        price=discount * mean,
        stderr=stderr,
        n_paths=n,
        payoff_mean=mean,
        payoff_var=var,
    )
