"""Closed-form oracles and the Monte Carlo result type
(port of ``mc_tpu/oracle.py:63-200,459-505,549-638``).

The oracles are host f64 through ``math.erf``/``math.erfc``: the gates of
the payoffs (vanilla, digital, continuous-barrier, forward-start, cliquet),
of the greeks (Black-Scholes delta, vega, gamma) and the implied
volatility.  ``summarize`` turns f64 moment sums into a
`PriceResult` on whatever device the sums live.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["bs_call", "bs_put", "bs_digital_call", "bs_digital_put",
           "bs_up_out_call", "bs_down_out_call", "bs_forward_start_call",
           "bs_cliquet", "bs_delta_call", "bs_vega", "bs_gamma",
           "bs_implied_vol", "PriceResult", "summarize"]


def _ncdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _phid(x: float) -> float:
    """N(x) through erfc, which keeps the lower tail's relative accuracy."""
    return 0.5 * math.erfc(-x / math.sqrt(2.0))


def bs_call(s0, k, t, r, sigma, q=0.0) -> float:
    """European call, exact closed form with continuous dividend yield
    (cf. BlackandScholes.hpp:34-43, which has q=0)."""
    s0, k, t, r, sigma, q = map(float, (s0, k, t, r, sigma, q))
    sqrt_t = math.sqrt(t)
    d1 = (math.log(s0 / k) + (r - q + 0.5 * sigma * sigma) * t) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return (s0 * math.exp(-q * t) * _ncdf(d1)
            - k * math.exp(-r * t) * _ncdf(d2))


def bs_put(s0, k, t, r, sigma, q=0.0) -> float:
    """European put via put-call parity."""
    q, r, t = float(q), float(r), float(t)
    return (bs_call(s0, k, t, r, sigma, q) - float(s0) * math.exp(-q * t)
            + float(k) * math.exp(-r * t))


def _d2(s0, k, t, r, sigma, q) -> float:
    s0, k, t, r, sigma, q = map(float, (s0, k, t, r, sigma, q))
    return ((math.log(s0 / k) + (r - q - 0.5 * sigma * sigma) * t)
            / (sigma * math.sqrt(t)))


def bs_digital_call(s0, k, t, r, sigma, q=0.0) -> float:
    """Cash-or-nothing digital call: e^{-rT} N(d2)."""
    return math.exp(-float(r) * float(t)) * _phid(_d2(s0, k, t, r, sigma, q))


def bs_digital_put(s0, k, t, r, sigma, q=0.0) -> float:
    """Cash-or-nothing digital put: e^{-rT} N(-d2) (call + put = e^{-rT})."""
    return math.exp(-float(r) * float(t)) * _phid(-_d2(s0, k, t, r, sigma, q))


# Continuously monitored barriers (reflection principle): the oracles of the
# Brownian-bridge barrier payoffs.


def _call_segment_f64(x, k, t, r, sigma, q, lo, hi):
    """e^{-rT} E_x[(S_T - k) 1{lo < S_T < hi}] under GBM; ``hi=None`` is
    +infinity.  The truncated-lognormal expectation, stable where a
    call-spread + digital split would cancel."""
    st = sigma * math.sqrt(t)

    def d1(y):
        return (math.log(x / y) + (r - q + 0.5 * sigma * sigma) * t) / st

    n1_lo, n2_lo = _ncdf(d1(lo)), _ncdf(d1(lo) - st)
    n1_hi = _ncdf(d1(hi)) if hi is not None else 0.0
    n2_hi = _ncdf(d1(hi) - st) if hi is not None else 0.0
    return (x * math.exp(-q * t) * (n1_lo - n1_hi)
            - k * math.exp(-r * t) * (n2_lo - n2_hi))


def bs_up_out_call(s0, k, t, r, sigma, b, q=0.0) -> float:
    """Up-and-out call, continuously monitored barrier b (> s0, > k):
    C_uo = seg(s0) - (b/s0)^{2mu/sigma^2} seg(b^2/s0), mu = r - q -
    sigma^2/2, seg(x) = e^{-rT} E_x[(S_T-K) 1{K < S_T < b}]."""
    s0, k, t, r, sigma, b, q = map(float, (s0, k, t, r, sigma, b, q))
    if s0 >= b or k >= b:
        return 0.0
    mu = r - q - 0.5 * sigma * sigma
    refl = (b / s0) ** (2.0 * mu / (sigma * sigma))
    return (_call_segment_f64(s0, k, t, r, sigma, q, k, b)
            - refl * _call_segment_f64(b * b / s0, k, t, r, sigma, q, k, b))


def bs_down_out_call(s0, k, t, r, sigma, b, q=0.0) -> float:
    """Down-and-out call, continuously monitored barrier b (< s0): the same
    reflection with seg(x) = e^{-rT} E_x[(S_T-K) 1{S_T > max(k, b)}]."""
    s0, k, t, r, sigma, b, q = map(float, (s0, k, t, r, sigma, b, q))
    if s0 <= b:
        return 0.0
    mu = r - q - 0.5 * sigma * sigma
    refl = (b / s0) ** (2.0 * mu / (sigma * sigma))
    lo = max(k, b)
    return (_call_segment_f64(s0, k, t, r, sigma, q, lo, None)
            - refl * _call_segment_f64(b * b / s0, k, t, r, sigma, q,
                                       lo, None))


def bs_forward_start_call(s0, k_ratio, t1, t, r, sigma, q=0.0) -> float:
    """Rubinstein (1991) forward-start call:
    e^{-rT} E[max(S_T - k S_{t1}, 0)] = S0 e^{-q t1} * BS(1, k, T-t1)."""
    s0, k_ratio, t1, t, r, sigma, q = map(
        float, (s0, k_ratio, t1, t, r, sigma, q))
    tau = t - t1
    if tau <= 0.0:
        raise ValueError("need t1 < t")
    st = sigma * math.sqrt(tau)
    d1 = (math.log(1.0 / k_ratio) + (r - q + 0.5 * sigma * sigma) * tau) / st
    d2 = d1 - st
    unit = (math.exp(-q * tau) * _phid(d1)
            - k_ratio * math.exp(-r * tau) * _phid(d2))
    return s0 * math.exp(-q * t1) * unit


def bs_cliquet(n_periods, dt_period, floor, cap, t, r, sigma,
               q=0.0) -> float:
    """Ratchet cliquet under GBM: e^{-rT} n E[clamp(R - 1, floor, cap)],
    the period returns R iid lognormal over dt_period, and
    E[clamp(R-1, f, c)] = f + E[(R-(1+f))+] - E[(R-(1+c))+], each term an
    undiscounted Black call on the unit forward."""
    n_periods = int(n_periods)
    dt_period, floor, cap, t, r, sigma, q = map(
        float, (dt_period, floor, cap, t, r, sigma, q))

    def fwd_call(strike):
        if strike <= 0.0:
            return math.exp((r - q) * dt_period) - strike
        st = sigma * math.sqrt(dt_period)
        d1 = (math.log(1.0 / strike)
              + (r - q + 0.5 * sigma * sigma) * dt_period) / st
        return (math.exp((r - q) * dt_period) * _phid(d1)
                - strike * _phid(d1 - st))

    e_clamp = floor + fwd_call(1.0 + floor) - (
        fwd_call(1.0 + cap) if math.isfinite(cap) else 0.0)
    return math.exp(-r * t) * n_periods * e_clamp


def _d1(s0, k, t, r, sigma, q) -> float:
    return ((math.log(s0 / k) + (r - q + 0.5 * sigma * sigma) * t)
            / (sigma * math.sqrt(t)))


def _pdf(x: float) -> float:
    return math.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def bs_delta_call(s0, k, t, r, sigma, q=0.0) -> float:
    """Black-Scholes call delta e^{-qT} N(d1)."""
    s0, k, t, r, sigma, q = map(float, (s0, k, t, r, sigma, q))
    return math.exp(-q * t) * _ncdf(_d1(s0, k, t, r, sigma, q))


def bs_vega(s0, k, t, r, sigma, q=0.0) -> float:
    """dC/dsigma = s0 e^{-qT} phi(d1) sqrt(T)."""
    s0, k, t, r, sigma, q = map(float, (s0, k, t, r, sigma, q))
    d1 = _d1(s0, k, t, r, sigma, q)
    return (s0 * math.exp(-q * t) * math.exp(-0.5 * d1 * d1)
            / math.sqrt(2.0 * math.pi) * math.sqrt(t))


def bs_gamma(s0, k, t, r, sigma, q=0.0) -> float:
    """d2C/dS0^2 = e^{-qT} phi(d1) / (s0 sigma sqrt(T))."""
    s0, k, t, r, sigma, q = map(float, (s0, k, t, r, sigma, q))
    return (math.exp(-q * t) * _pdf(_d1(s0, k, t, r, sigma, q))
            / (s0 * sigma * math.sqrt(t)))


def bs_implied_vol(price, s0, k, t, r, q=0.0, n_iter: int = 24) -> float:
    """Black-Scholes implied volatility of a call: bisection-safeguarded
    Newton from the Brenner-Subrahmanyam start, a fixed n_iter steps, as
    ``mc_tpu.oracle.bs_implied_vol`` (which runs it in f32 on the device).
    Prices outside the no-arbitrage band (forward intrinsic, spot) give
    NaN."""
    price, s0, k, t, r, q = map(float, (price, s0, k, t, r, q))
    lb = max(s0 * math.exp(-q * t) - k * math.exp(-r * t), 0.0)
    ub = s0 * math.exp(-q * t)
    if not lb < price < ub:
        return math.nan
    lo, hi = 1e-4, 5.0
    sigma = min(max(math.sqrt(2.0 * math.pi / t) * price / s0, 1e-3), 4.0)
    for _ in range(n_iter):
        diff = bs_call(s0, k, t, r, sigma, q) - price
        if diff < 0.0:
            lo = sigma
        if diff > 0.0:
            hi = sigma
        newton = sigma - diff / max(bs_vega(s0, k, t, r, sigma, q), 1e-8)
        sigma = newton if lo < newton < hi else 0.5 * (lo + hi)
    return sigma


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
