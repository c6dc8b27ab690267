"""Closed-form oracles and the Monte Carlo result type
(port of ``mc_tpu/oracle.py:63-200,208-455,459-505,515-549,549-638,
641-1003``).

The oracles are host f64 through ``math.erf``/``math.erfc`` (but
``cnd_as`` and ``bs_call_as``, the reference's Abramowitz-Stegun CND in
f32 on tensors): the gates of
the payoffs (vanilla, digital, continuous-barrier, forward-start, cliquet),
of the greeks (Black-Scholes delta, vega, gamma), the implied volatility,
the Vasicek bond and Merton's (1973) call under Vasicek rates,
Margrabe's (1978) exchange option, the bivariate normal CDF (Genz's BVND)
with Stulz's (1982) two-asset min/max options, and the cross-currency
closed forms (Garman-Kohlhagen, quanto, composite, flexo); the rates
oracles: Jamshidian's swaption under Vasicek and curve-fitted Hull-White
(on zero-coupon bond puts), the conditional-Jamshidian G2++ price and the
multi-curve quadratures (numpy and scipy, imported where they are used).
``summarize`` turns f64 moment sums into a `PriceResult` on whatever device
the sums live.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["bs_call", "bs_put", "cnd_as", "bs_call_as", "bs_digital_call",
           "bs_digital_put", "bs_up_out_call", "bs_down_out_call",
           "bs_forward_start_call", "bs_cliquet", "bs_delta_call", "bs_vega",
           "bs_gamma", "bs_implied_vol", "vasicek_zcb", "bsv_call", "margrabe",
           "bvn_cdf", "stulz_min_call", "stulz_max_call", "stulz_min_put",
           "stulz_max_put", "gk_call", "gk_put", "quanto_call", "quanto_put",
           "compo_call", "compo_put", "flexo_call", "flexo_put",
           "vasicek_zbp", "vasicek_swaption", "hw_zbp", "hw_swaption",
           "g2_swaption", "hw_swaption_multicurve", "g2_swaption_multicurve",
           "PriceResult", "summarize"]


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


def cnd_as(x):
    """The Abramowitz-Stegun polynomial CND (max abs error ~7.5e-8), in f32
    as ``mc_tpu.oracle.cnd_as`` computes it: the reference's 5-term
    approximation (``BlackandScholes.hpp:8-30``), its sign branch a mask.
    ``x`` a float, array or tensor; returns an f32 tensor."""
    x = torch.as_tensor(x, dtype=torch.float32)
    p = torch.tensor(0.2316419, dtype=torch.float32)
    b = (0.31938153, -0.356563782, 1.781477937, -1.821255978, 1.330274429)
    one_over_sqrt2pi = torch.tensor(0.39894228, dtype=torch.float32)
    ax = torch.abs(x)
    tt = 1.0 / (1.0 + p * ax)
    poly = tt * (b[0] + tt * (b[1] + tt * (b[2] + tt * (b[3] + tt * b[4]))))
    upper_tail = one_over_sqrt2pi * torch.exp(-0.5 * ax * ax) * poly
    return torch.where(x >= 0, 1.0 - upper_tail, upper_tail)


def bs_call_as(s0, k, t, r, sigma):
    """The Black-Scholes call through ``cnd_as``, in f32: comparable bit for
    bit with the reference's oracle (``mc_tpu.oracle.bs_call_as``)."""
    s0, k, t, r, sigma = (torch.as_tensor(v, dtype=torch.float32)
                          for v in (s0, k, t, r, sigma))
    sqrt_t = torch.sqrt(t)
    d1 = (torch.log(s0 / k) + (r + 0.5 * sigma * sigma) * t) / (sigma
                                                                 * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return s0 * cnd_as(d1) - k * torch.exp(-r * t) * cnd_as(d2)


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


def vasicek_zcb(r0, a, b, sigma_r, t) -> float:
    """Zero-coupon bond P(0,T) = E[exp(-int_0^T r_u du)] under
    dr = a (b - r) dt + sigma_r dW (the affine closed form)."""
    r0, a, b, sigma_r, t = map(float, (r0, a, b, sigma_r, t))
    bt = -math.expm1(-a * t) / a
    loga = ((b - sigma_r * sigma_r / (2.0 * a * a)) * (bt - t)
            - sigma_r * sigma_r * bt * bt / (4.0 * a))
    return math.exp(loga - bt * r0)


def bsv_call(s0, k, t, r0, sigma_s, a, b, sigma_r, rho, q=0.0) -> float:
    """European equity call under Black-Scholes-Vasicek (Merton 1973): under
    the T-forward measure F = S e^{-qT}/P(0,T) is lognormal with variance
    sigma_s^2 T + (sigma_r/a)^2 (T - 2B + C2) + 2 rho sigma_s (sigma_r/a)
    (T - B), B = (1-e^{-aT})/a, C2 = (1-e^{-2aT})/(2a); the Black formula
    S0 e^{-qT} N(d1) - K P(0,T) N(d2)."""
    s0, k, t, r0, sigma_s, a, b, sigma_r, rho, q = map(
        float, (s0, k, t, r0, sigma_s, a, b, sigma_r, rho, q))
    p0t = vasicek_zcb(r0, a, b, sigma_r, t)
    bt = -math.expm1(-a * t) / a
    c2 = -math.expm1(-2.0 * a * t) / (2.0 * a)
    var = (sigma_s * sigma_s * t
           + (sigma_r * sigma_r / (a * a)) * (t - 2.0 * bt + c2)
           + 2.0 * rho * sigma_s * (sigma_r / a) * (t - bt))
    sig = math.sqrt(var)
    d1 = (math.log(s0 * math.exp(-q * t) / (k * p0t)) + 0.5 * var) / sig
    d2 = d1 - sig
    return s0 * math.exp(-q * t) * _phid(d1) - k * p0t * _phid(d2)


def margrabe(s1, s2, t, sigma1, sigma2, rho, q1=0.0, q2=0.0) -> float:
    """Margrabe (1978) exchange option e^{-rT} E[max(S1_T - S2_T, 0)]: rate
    free, at sigma^2 = sigma1^2 + sigma2^2 - 2 rho sigma1 sigma2."""
    s1, s2, t, sigma1, sigma2, rho, q1, q2 = map(
        float, (s1, s2, t, sigma1, sigma2, rho, q1, q2))
    sig = math.sqrt(sigma1 * sigma1 + sigma2 * sigma2
                    - 2.0 * rho * sigma1 * sigma2)
    st = sig * math.sqrt(t)
    d1 = (math.log(s1 / s2) + (q2 - q1 + 0.5 * sig * sig) * t) / st
    d2 = d1 - st
    return (s1 * math.exp(-q1 * t) * _phid(d1)
            - s2 * math.exp(-q2 * t) * _phid(d2))


# Gauss-Legendre half-rules (weights, nodes on [0, 1] mapped from [-1, 1]).
_GL_RULES = {
    6: ((0.1713244923791704, 0.3607615730481386, 0.4679139345726910),
        (0.9324695142031521, 0.6612093864662645, 0.2386191860831969)),
    12: ((0.04717533638651183, 0.1069393259953184, 0.1600783285433462,
          0.2031674267230659, 0.2334925365383548, 0.2491470458134028),
         (0.9815606342467192, 0.9041172563704749, 0.7699026741943047,
          0.5873179542866175, 0.3678314989981802, 0.1252334085114689)),
    20: ((0.01761400713915212, 0.04060142980038694, 0.06267204833410906,
          0.08327674157670475, 0.1019301198172404, 0.1181945319615184,
          0.1316886384491766, 0.1420961093183821, 0.1491729864726037,
          0.1527533871307259),
         (0.9931285991850949, 0.9639719272779138, 0.9122344282513259,
          0.8391169718222188, 0.7463319064601508, 0.6360536807265150,
          0.5108670019508271, 0.3737060887154196, 0.2277858511416451,
          0.07652652113349733)),
}


def _bvnu(dh: float, dk: float, r: float) -> float:
    """Upper tail P(X > dh, Y > dk) of the standard bivariate normal with
    correlation r: Genz's (2004) BVND, a Gauss-Legendre quadrature of
    Drezner-Wesolowsky's integral over arcsin(r) for |r| < 0.925, else the
    expansion in sqrt(1 - r^2) with a quadrature remainder."""
    twopi = 2.0 * math.pi
    if abs(r) < 0.3:
        w, xgl = _GL_RULES[6]
    elif abs(r) < 0.75:
        w, xgl = _GL_RULES[12]
    else:
        w, xgl = _GL_RULES[20]
    h, k = dh, dk
    hk = h * k
    bvn = 0.0
    if abs(r) < 0.925:
        hs = (h * h + k * k) / 2.0
        asr = math.asin(r)
        for wi, xi in zip(w, xgl):
            for sn in (math.sin(asr * (1.0 - xi) / 2.0),
                       math.sin(asr * (1.0 + xi) / 2.0)):
                bvn += wi * math.exp((sn * hk - hs) / (1.0 - sn * sn))
        return bvn * asr / (2.0 * twopi) + _phid(-h) * _phid(-k)
    if r < 0.0:
        k = -k
        hk = -hk
    if abs(r) < 1.0:
        a_s = (1.0 - r) * (1.0 + r)
        a = math.sqrt(a_s)
        bs = (h - k) ** 2
        c = (4.0 - hk) / 8.0
        d = (12.0 - hk) / 16.0
        asr = -(bs / a_s + hk) / 2.0
        if asr > -100.0:
            bvn = (a * math.exp(asr)
                   * (1.0 - c * (bs - a_s) * (1.0 - d * bs / 5.0) / 3.0
                      + c * d * a_s * a_s / 5.0))
        if -hk < 100.0:
            b = math.sqrt(bs)
            sp = math.sqrt(twopi) * _phid(-b / a)
            bvn -= (math.exp(-hk / 2.0) * sp * b
                    * (1.0 - c * bs * (1.0 - d * bs / 5.0) / 3.0))
        a = a / 2.0
        for wi, xi in zip(w, xgl):
            for xs in ((a * (1.0 - xi)) ** 2, (a * (1.0 + xi)) ** 2):
                rs = math.sqrt(1.0 - xs)
                asr = -(bs / xs + hk) / 2.0
                if asr > -100.0:
                    sp = 1.0 + c * xs * (1.0 + d * xs)
                    ep = math.exp(-hk * (1.0 - rs)
                                  / (2.0 * (1.0 + rs))) / rs
                    bvn += a * wi * math.exp(asr) * (ep - sp)
        bvn = -bvn / twopi
    if r > 0.0:
        return bvn + _phid(-max(h, k))
    bvn = -bvn
    if k > h:
        bvn += _phid(k) - _phid(h)
    return bvn


def bvn_cdf(x, y, rho) -> float:
    """P(X <= x, Y <= y) for a standard bivariate normal with corr rho."""
    return _bvnu(-float(x), -float(y), float(rho))


def stulz_min_call(s1, s2, k, t, r, sigma1, sigma2, rho,
                   q1=0.0, q2=0.0) -> float:
    """Stulz (1982) call on the minimum of two assets,
    e^{-rT} E[max(min(S1_T, S2_T) - K, 0)], K > 0."""
    s1, s2, k, t, r, sigma1, sigma2, rho, q1, q2 = map(
        float, (s1, s2, k, t, r, sigma1, sigma2, rho, q1, q2))
    sig = math.sqrt(sigma1 * sigma1 + sigma2 * sigma2
                    - 2.0 * rho * sigma1 * sigma2)
    st = sig * math.sqrt(t)
    rt = math.sqrt(t)
    d = (math.log(s1 / s2) + (q2 - q1 + 0.5 * sig * sig) * t) / st
    y1 = (math.log(s1 / k) + (r - q1 + 0.5 * sigma1 * sigma1) * t) \
        / (sigma1 * rt)
    y2 = (math.log(s2 / k) + (r - q2 + 0.5 * sigma2 * sigma2) * t) \
        / (sigma2 * rt)
    rho1 = (sigma1 - rho * sigma2) / sig
    rho2 = (sigma2 - rho * sigma1) / sig
    return (s1 * math.exp(-q1 * t) * bvn_cdf(y1, -d, -rho1)
            + s2 * math.exp(-q2 * t) * bvn_cdf(y2, d - st, -rho2)
            - k * math.exp(-r * t) * bvn_cdf(y1 - sigma1 * rt,
                                             y2 - sigma2 * rt, rho))


def stulz_max_call(s1, s2, k, t, r, sigma1, sigma2, rho,
                   q1=0.0, q2=0.0) -> float:
    """Call on the maximum of two assets, by the multiset identity
    max(M-K,0) + max(m-K,0) = max(S1-K,0) + max(S2-K,0)."""
    c1 = bs_call(s1, k, t, r, sigma1, q1)
    c2 = bs_call(s2, k, t, r, sigma2, q2)
    return c1 + c2 - stulz_min_call(s1, s2, k, t, r, sigma1, sigma2, rho,
                                    q1, q2)


def _min_forward(s1, s2, t, sigma1, sigma2, rho, q1, q2) -> float:
    """e^{-rT} E[min(S1_T, S2_T)] = S1 e^{-q1 T} - Margrabe(S1 -> S2)."""
    return (float(s1) * math.exp(-float(q1) * float(t))
            - margrabe(s1, s2, t, sigma1, sigma2, rho, q1, q2))


def stulz_min_put(s1, s2, k, t, r, sigma1, sigma2, rho,
                  q1=0.0, q2=0.0) -> float:
    """Put on the minimum by parity: p_min(K) = K e^{-rT} - c_min(0) +
    c_min(K)."""
    return (float(k) * math.exp(-float(r) * float(t))
            - _min_forward(s1, s2, t, sigma1, sigma2, rho, q1, q2)
            + stulz_min_call(s1, s2, k, t, r, sigma1, sigma2, rho, q1, q2))


def stulz_max_put(s1, s2, k, t, r, sigma1, sigma2, rho,
                  q1=0.0, q2=0.0) -> float:
    """Put on the maximum by parity, with c_max(0) = S1 e^{-q1 T} + S2
    e^{-q2 T} - c_min(0)."""
    fwd_max = (float(s1) * math.exp(-float(q1) * float(t))
               + float(s2) * math.exp(-float(q2) * float(t))
               - _min_forward(s1, s2, t, sigma1, sigma2, rho, q1, q2))
    return (float(k) * math.exp(-float(r) * float(t)) - fwd_max
            + stulz_max_call(s1, s2, k, t, r, sigma1, sigma2, rho, q1, q2))


# Cross-currency closed forms: ``x0`` is the FX spot in domestic units per
# foreign unit, ``r`` the domestic rate, ``r_f`` the foreign rate, ``q`` the
# asset's dividend yield, ``rho`` the asset/FX log-return correlation.


def _bs64(call: bool, s0, k, t, r, sigma, q) -> float:
    """Black-Scholes in host f64 (math and _phid)."""
    s0, k, t, r, sigma, q = map(float, (s0, k, t, r, sigma, q))
    st = sigma * math.sqrt(t)
    d1 = (math.log(s0 / k) + (r - q + 0.5 * sigma * sigma) * t) / st
    d2 = d1 - st
    c = (s0 * math.exp(-q * t) * _phid(d1)
         - k * math.exp(-r * t) * _phid(d2))
    if call:
        return c
    return c - s0 * math.exp(-q * t) + k * math.exp(-r * t)


def gk_call(x0, kx, t, r, r_f, sigma_x, call: bool = True) -> float:
    """Garman-Kohlhagen FX option: Black-Scholes with q = r_f."""
    return _bs64(call, x0, kx, t, r, sigma_x, r_f)


def gk_put(x0, kx, t, r, r_f, sigma_x) -> float:
    return gk_call(x0, kx, t, r, r_f, sigma_x, call=False)


def quanto_call(s0, k, t, r, r_f, sigma_s, sigma_x, rho, q=0.0,
                x_bar=1.0, call: bool = True) -> float:
    """Quanto option x_bar * max(+-(S_T - K), 0) paid in domestic currency:
    Black-Scholes at the domestic rate with the effective dividend yield
    q_eff = r - r_f + q + rho sigma_s sigma_x."""
    q_eff = (float(r) - float(r_f) + float(q)
             + float(rho) * float(sigma_s) * float(sigma_x))
    return float(x_bar) * _bs64(call, s0, k, t, r, sigma_s, q_eff)


def quanto_put(s0, k, t, r, r_f, sigma_s, sigma_x, rho, q=0.0,
               x_bar=1.0) -> float:
    return quanto_call(s0, k, t, r, r_f, sigma_s, sigma_x, rho, q, x_bar,
                       call=False)


def compo_call(s0, x0, k, t, r, sigma_s, sigma_x, rho, q=0.0,
               call: bool = True) -> float:
    """Composite option on S_T X_T with a domestic strike: S X is a
    domestic tradable paying q, GBM with vol sqrt(sigma_s^2 + sigma_x^2 +
    2 rho sigma_s sigma_x)."""
    sigma_s, sigma_x, rho = map(float, (sigma_s, sigma_x, rho))
    sigma_c = math.sqrt(sigma_s * sigma_s + sigma_x * sigma_x
                        + 2.0 * rho * sigma_s * sigma_x)
    return _bs64(call, float(s0) * float(x0), k, t, r, sigma_c, q)


def compo_put(s0, x0, k, t, r, sigma_s, sigma_x, rho, q=0.0) -> float:
    return compo_call(s0, x0, k, t, r, sigma_s, sigma_x, rho, q, call=False)


def flexo_call(s0, x0, k, t, r_f, sigma_s, q=0.0, call: bool = True) -> float:
    """A foreign vanilla converted at the realized FX rate, e^{-rT}
    E[X_T max(+-(S_T - K), 0)]: x0 times the foreign-rate Black-Scholes
    (change of numeraire; the domestic rate drops out)."""
    return float(x0) * _bs64(call, s0, k, t, r_f, sigma_s, q)


def flexo_put(s0, x0, k, t, r_f, sigma_s, q=0.0) -> float:
    return flexo_call(s0, x0, k, t, r_f, sigma_s, q, call=False)


# ---------------------------------------------------------------------------
# The rates oracles (mc_tpu/oracle.py:641-1003): Jamshidian for Vasicek and
# curve-fitted Hull-White, the conditional-Jamshidian G2++ trapezoid, and
# the multi-curve quadratures; the same bisection bounds and counts and the
# same nodes, host f64.
# ---------------------------------------------------------------------------


def vasicek_zbp(r0, a, b, sigma_r, t_expiry, t_bond, k) -> float:
    """European PUT on a zero-coupon bond under Vasicek: the option at
    ``t_expiry`` on P(t_expiry, t_bond) struck at ``k`` (Jamshidian's
    building block).  Black-like closed form with bond volatility
    sigma_p = (sigma_r/a)(1 - e^{-a(S-T)}) sqrt((1 - e^{-2aT})/(2a))."""
    r0, a, b, sigma_r, t_expiry, t_bond, k = map(
        float, (r0, a, b, sigma_r, t_expiry, t_bond, k))
    p_t = vasicek_zcb(r0, a, b, sigma_r, t_expiry)
    p_s = vasicek_zcb(r0, a, b, sigma_r, t_bond)
    sig_p = ((sigma_r / a) * (-math.expm1(-a * (t_bond - t_expiry)))
             * math.sqrt(-math.expm1(-2.0 * a * t_expiry) / (2.0 * a)))
    if sig_p < 1e-12:
        return max(k * p_t - p_s, 0.0)
    h = math.log(p_s / (k * p_t)) / sig_p + 0.5 * sig_p
    cnd = lambda x: 0.5 * math.erfc(-x / math.sqrt(2.0))
    return k * p_t * cnd(-h + sig_p) - p_s * cnd(-h)


def vasicek_swaption(r0, a, b, sigma_r, t_expiry, tenor, n_payments,
                     k_rate, payer=True) -> float:
    """European swaption under Vasicek via Jamshidian decomposition.

    Swap: fixed rate ``k_rate`` against float on unit notional, payment
    dates T_i = t_expiry + i*tenor (i = 1..n_payments).  A payer
    swaption is a basket of ZCB PUTS struck at K_i = P(T0, T_i; r*)
    where r* makes the coupon bond worth par at expiry; a receiver is
    the complementary basket of calls, obtained here by put-call parity
    on the swap (receiver = payer - swap value).
    """
    r0, a, b, sigma_r = map(float, (r0, a, b, sigma_r))
    t0, tau, kr = float(t_expiry), float(tenor), float(k_rate)
    n = int(n_payments)
    mats = [t0 + (i + 1) * tau for i in range(n)]
    cs = [kr * tau] * n
    cs[-1] += 1.0

    def coupon_bond(r):
        return sum(c * vasicek_zcb(r, a, b, sigma_r, s - t0)
                   for c, s in zip(cs, mats))

    # r*: coupon_bond(r*) = 1 (monotone decreasing in r) — bisection
    lo, hi = -2.0, 3.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if coupon_bond(mid) > 1.0:
            lo = mid
        else:
            hi = mid
    r_star = 0.5 * (lo + hi)

    payer_px = sum(
        c * vasicek_zbp(r0, a, b, sigma_r, t0, s,
                        vasicek_zcb(r_star, a, b, sigma_r, s - t0))
        for c, s in zip(cs, mats))
    if payer:
        return payer_px
    # receiver = payer - (float - fixed) = payer + fixed-leg - float-leg
    fixed_leg = sum(c * vasicek_zcb(r0, a, b, sigma_r, s)
                    for c, s in zip(cs, mats))
    float_leg = vasicek_zcb(r0, a, b, sigma_r, t0)
    return payer_px + fixed_leg - float_leg


def hw_zbp(a, sigma_r, p0_expiry, p0_bond, t_expiry, t_bond, k) -> float:
    """European PUT on a zero-coupon bond under curve-fitted Hull-White.

    Identical Black-like form to `vasicek_zbp` — the bond volatility
    depends only on (a, sigma_r), while the forward bond level comes
    from the INPUT curve discounts P(0, t_expiry), P(0, t_bond) (the
    defining property of the theta(t) fit: today's curve is repriced
    exactly).  Brigo-Mercurio (3.40-3.41).
    """
    a, sigma_r = float(a), float(sigma_r)
    p_t, p_s = float(p0_expiry), float(p0_bond)
    t0, s, k = float(t_expiry), float(t_bond), float(k)
    sig_p = ((sigma_r / a) * (-math.expm1(-a * (s - t0)))
             * math.sqrt(-math.expm1(-2.0 * a * t0) / (2.0 * a)))
    if sig_p < 1e-12:
        return max(k * p_t - p_s, 0.0)
    h = math.log(p_s / (k * p_t)) / sig_p + 0.5 * sig_p
    cnd = lambda x: 0.5 * math.erfc(-x / math.sqrt(2.0))
    return k * p_t * cnd(-h + sig_p) - p_s * cnd(-h)


def hw_swaption(a, sigma_r, df, t_expiry, tenor, n_payments, k_rate,
                payer=True) -> float:
    """European swaption under curve-fitted Hull-White (Jamshidian).

    ``df``: callable t -> P(0, t), the input discount curve the model
    reprices exactly.  Bonds at expiry are lognormal in the OU factor
    x(T0): P(T0, S; x) = (P(0,S)/P(0,T0)) exp(-B(S-T0) x
    - (sigma^2/(4a))(1 - e^{-2aT0}) B(S-T0)^2); Jamshidian finds x*
    putting the coupon bond at par and decomposes the payer swaption
    into ZCB puts struck at P(T0, T_i; x*).
    """
    a, sigma_r = float(a), float(sigma_r)
    t0, tau, kr = float(t_expiry), float(tenor), float(k_rate)
    n = int(n_payments)
    mats = [t0 + (i + 1) * tau for i in range(n)]
    cs = [kr * tau] * n
    cs[-1] += 1.0
    p0_t0 = float(df(t0))
    var_fac = (sigma_r * sigma_r / (4.0 * a)) * (-math.expm1(-2.0 * a * t0))
    # alpha(t0) - f(0, t0): the x-SHIFT term of the reconstruction.
    # Jamshidian strikes are invariant to it (pure shift of the bond
    # family), but it is kept so bond_at_expiry is the true P(T0, S; x)
    # (the MC intrinsics in models/hullwhite.py evaluate the same form
    # at simulated x, where omitting it is a real bias).
    shift = ((sigma_r * sigma_r / (2.0 * a * a))
             * math.expm1(-a * t0) ** 2)

    def bond_at_expiry(s, x):
        b = -math.expm1(-a * (s - t0)) / a
        return (float(df(s)) / p0_t0) * math.exp(
            -b * x - var_fac * b * b - b * shift)

    def coupon_bond(x):
        return sum(c * bond_at_expiry(s, x) for c, s in zip(cs, mats))

    lo, hi = -3.0, 3.0  # x is OU(0) with std << 1
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if coupon_bond(mid) > 1.0:
            lo = mid
        else:
            hi = mid
    x_star = 0.5 * (lo + hi)

    payer_px = sum(
        c * hw_zbp(a, sigma_r, p0_t0, float(df(s)), t0, s,
                   bond_at_expiry(s, x_star))
        for c, s in zip(cs, mats))
    if payer:
        return payer_px
    fixed_leg = sum(c * float(df(s)) for c, s in zip(cs, mats))
    return payer_px + fixed_leg - p0_t0


def g2_swaption(a, sigma, b_mr, eta, rho, df, t_expiry, tenor,
                n_payments, k_rate, payer=True, n_quad: int = 2001):
    """European swaption under curve-fitted G2++ (two-factor Gaussian).

    r = x + y + phi(t), dx = -a x dt + sigma dW1, dy = -b_mr y dt +
    eta dW2, corr rho; phi fits ``df`` exactly.  Semi-analytic
    "conditional Jamshidian": under the T-forward measure (x, y) at
    expiry are jointly Gaussian with known means (Brigo-Mercurio 4.33);
    GIVEN x the coupon bond is monotone in y, so the exercise boundary
    ybar(x) solves a 1-D root-find and the inner expectation is a sum
    of lognormal tails in y — the outer x-integral is Gauss-Hermite.
    eta -> 0 degenerates to `hw_swaption` (gated)."""
    import numpy as np

    a, s, b, e, rho = map(float, (a, sigma, b_mr, eta, rho))
    t0, tau, kr = float(t_expiry), float(tenor), float(k_rate)
    n = int(n_payments)
    mats = [t0 + (i + 1) * tau for i in range(n)]
    cs = np.array([kr * tau] * n)
    cs[-1] += 1.0
    p0_t = float(df(t0))
    p0_i = np.array([float(df(m)) for m in mats])

    def bf(k_, t):  # (1 - e^{-k t}) / k
        return -math.expm1(-k_ * t) / k_

    def v_of(t):  # Var[int_0^t (x + y)]
        return ((s * s / (a * a)) * (t - 2 * bf(a, t)
                                     - math.expm1(-2 * a * t) / (2 * a))
                + (e * e / (b * b)) * (t - 2 * bf(b, t)
                                       - math.expm1(-2 * b * t) / (2 * b))
                + (2 * rho * s * e / (a * b))
                * (t - bf(a, t) - bf(b, t)
                   - math.expm1(-(a + b) * t) / (a + b)))

    ba = np.array([bf(a, m - t0) for m in mats])
    bb = np.array([bf(b, m - t0) for m in mats])
    # A_i = (P(0,t_i)/P(0,T)) exp(0.5 [V(t_i - T) - V(t_i) + V(T)])
    av = np.array([
        (p0_i[i] / p0_t) * math.exp(0.5 * (v_of(mats[i] - t0)
                                           - v_of(mats[i]) + v_of(t0)))
        for i in range(n)])

    # T-forward-measure moments of (x, y) at T (B-M 4.33 / 4.34)
    sx = s * math.sqrt(-math.expm1(-2 * a * t0) / (2 * a))
    sy = e * math.sqrt(-math.expm1(-2 * b * t0) / (2 * b))
    rxy = (rho * s * e * (-math.expm1(-(a + b) * t0)) / (a + b)
           / (sx * sy)) if sx > 0 and sy > 0 else 0.0
    mx = -((s * s / (a * a) + rho * s * e / (a * b)) * (-math.expm1(-a * t0))
           - s * s / (2 * a * a) * (-math.expm1(-2 * a * t0))
           - rho * s * e / (b * (a + b)) * (-math.expm1(-(a + b) * t0)))
    my = -((e * e / (b * b) + rho * s * e / (a * b)) * (-math.expm1(-b * t0))
           - e * e / (2 * b * b) * (-math.expm1(-2 * b * t0))
           - rho * s * e / (a * (a + b)) * (-math.expm1(-(a + b) * t0)))

    from scipy.special import ndtr  # vectorized normal CDF

    s_cond = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))
    # Trapezoid over +-8 sigma: unlike Gauss-Hermite it stays accurate
    # when eta -> 0 turns the conditional expectation into a STEP in x
    # (the degenerate-to-Hull-White gate), and hermegauss overflows
    # beyond ~600 nodes anyway.  n_quad ~ 2001 -> ~1e-9 relative.
    m = max(int(n_quad), 201)
    xs = np.linspace(mx - 8.0 * sx, mx + 8.0 * sx, m)  # (m,)
    pdf = np.exp(-0.5 * ((xs - mx) / sx) ** 2) / (sx * math.sqrt(2.0
                                                                 * math.pi))
    wts = np.full(m, xs[1] - xs[0])
    wts[0] = wts[-1] = 0.5 * (xs[1] - xs[0])
    mu_c = my + (rxy * sy / sx) * (xs - mx) if sx > 0 else np.full(m, my)
    coef = cs[None, :] * av[None, :] * np.exp(-np.outer(xs, ba))  # (m,n)

    # vectorized bisection for ybar(x): coupon bond decreasing in y
    lo = np.full(m, -6.0)
    hi = np.full(m, 6.0)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        val = (coef * np.exp(-np.outer(mid, bb))).sum(axis=1)
        above = val > 1.0
        lo = np.where(above, mid, lo)
        hi = np.where(above, hi, mid)
    ybar = 0.5 * (lo + hi)
    d = (ybar - mu_c) / s_cond
    inner = ndtr(-d)
    for i in range(n):
        lam = bb[i]
        inner -= (coef[:, i]
                  * np.exp(-lam * mu_c + 0.5 * lam * lam
                           * s_cond * s_cond)
                  * ndtr(-d - lam * s_cond))
    payer_px = p0_t * float(np.sum(inner * pdf * wts))
    if payer:
        return payer_px
    return payer_px + float(np.dot(cs, p0_i)) - p0_t


def hw_swaption_multicurve(a, sigma_r, df_disc, df_proj, t_expiry,
                           tenor, n_payments, k_rate, payer=True,
                           n_quad: int = 4001):
    """European swaption under curve-fitted Hull-White with TWO curves:
    discounting off ``df_disc`` (OIS), forwards off ``df_proj``, linked
    by a DETERMINISTIC multiplicative basis (the standard post-2008
    multi-curve simplification — one factor drives both curves).

    With the basis spread s_j = B(t_{j-1})/B(t_j), B(t) =
    P_proj(0,t)/P_disc(0,t), the swap value at expiry is a MIXED-sign
    sum of discount bonds, so Jamshidian's monotone coupon-bond trick
    does not apply; the price is computed by direct (kink-robust
    trapezoid) quadrature of the positive part over the T-forward
    Gaussian law of x.  ``df_proj = df_disc`` reproduces `hw_swaption`
    to quadrature precision (gated)."""
    import numpy as np

    a, sig = float(a), float(sigma_r)
    t0, tau, kr = float(t_expiry), float(tenor), float(k_rate)
    n = int(n_payments)
    dates = [t0 + j * tau for j in range(n + 1)]
    pd_ = np.array([float(df_disc(t)) for t in dates], np.float64)
    pp_ = np.array([float(df_proj(t)) for t in dates], np.float64)
    basis = pp_ / pd_
    # V(x) = sum_m w_m P_d(T0, t_m; x); weights from the spread algebra:
    # float leg telescopes to s_{j} P_d(t_{j-1}) - P_d(t_j) per period
    w = np.zeros(n + 1)
    w[0] += basis[0] / basis[1]
    for m in range(1, n):
        w[m] += basis[m] / basis[m + 1] - 1.0 - kr * tau
    w[n] += -1.0 - kr * tau
    bvec = np.array([-math.expm1(-a * (t - t0)) / a for t in dates])
    var_fac = (sig * sig / (4.0 * a)) * (-math.expm1(-2.0 * a * t0))
    shift = (sig * sig / (2.0 * a * a)) * math.expm1(-a * t0) ** 2
    coef = w * (pd_ / pd_[0]) * np.exp(-var_fac * bvec * bvec
                                       - bvec * shift)

    sx = sig * math.sqrt(-math.expm1(-2 * a * t0) / (2 * a))
    mx = -((sig * sig / (a * a)) * (-math.expm1(-a * t0))
           - sig * sig / (2 * a * a) * (-math.expm1(-2 * a * t0)))
    m = max(int(n_quad), 201)
    xs = np.linspace(mx - 8.0 * sx, mx + 8.0 * sx, m)
    pdf = np.exp(-0.5 * ((xs - mx) / sx) ** 2) / (sx * math.sqrt(
        2.0 * math.pi))
    wts = np.full(m, xs[1] - xs[0])
    wts[0] = wts[-1] = 0.5 * (xs[1] - xs[0])
    v = (coef[None, :] * np.exp(-np.outer(xs, bvec))).sum(axis=1)
    if not payer:
        v = -v
    payer_px = pd_[0] * float(np.sum(np.maximum(v, 0.0) * pdf * wts))
    return payer_px


def g2_swaption_multicurve(a, sigma, b_mr, eta, rho, df_disc, df_proj,
                           t_expiry, tenor, n_payments, k_rate,
                           payer=True, n_quad: int = 501):
    """Multi-curve European swaption under G2++ (deterministic basis).

    The mixed-sign bond weights break BOTH Jamshidian tricks (no x*
    root, and given x the value is no longer monotone in y), so the
    price is a direct 2-D trapezoid over the T-forward Gaussian law of
    (x, y) — ~n_quad^2 nodes, kink-robust.  ``df_proj = df_disc``
    reproduces `g2_swaption` (gated)."""
    import numpy as np

    a, s, b, e, rho = map(float, (a, sigma, b_mr, eta, rho))
    t0, tau, kr = float(t_expiry), float(tenor), float(k_rate)
    n = int(n_payments)
    dates = [t0 + j * tau for j in range(n + 1)]
    pd_ = np.array([float(df_disc(t)) for t in dates], np.float64)
    pp_ = np.array([float(df_proj(t)) for t in dates], np.float64)
    basis = pp_ / pd_
    w = np.zeros(n + 1)
    w[0] += basis[0] / basis[1]
    for m in range(1, n):
        w[m] += basis[m] / basis[m + 1] - 1.0 - kr * tau
    w[n] += -1.0 - kr * tau

    def bf(k_, t):
        return -math.expm1(-k_ * t) / k_

    def v_of(t):
        return ((s * s / (a * a)) * (t - 2 * bf(a, t)
                                     - math.expm1(-2 * a * t) / (2 * a))
                + (e * e / (b * b)) * (t - 2 * bf(b, t)
                                       - math.expm1(-2 * b * t) / (2 * b))
                + (2 * rho * s * e / (a * b))
                * (t - bf(a, t) - bf(b, t)
                   - math.expm1(-(a + b) * t) / (a + b)))

    ba = np.array([bf(a, t - t0) for t in dates])
    bb = np.array([bf(b, t - t0) for t in dates])
    amat = np.array([0.5 * (v_of(t - t0) - v_of(t) + v_of(t0))
                     for t in dates])
    coef = w * (pd_ / pd_[0]) * np.exp(amat)

    sx = s * math.sqrt(-math.expm1(-2 * a * t0) / (2 * a))
    sy = e * math.sqrt(-math.expm1(-2 * b * t0) / (2 * b))
    rxy = (rho * s * e * (-math.expm1(-(a + b) * t0)) / (a + b)
           / (sx * sy)) if sx > 0 and sy > 0 else 0.0
    mx = -((s * s / (a * a) + rho * s * e / (a * b))
           * (-math.expm1(-a * t0))
           - s * s / (2 * a * a) * (-math.expm1(-2 * a * t0))
           - rho * s * e / (b * (a + b)) * (-math.expm1(-(a + b) * t0)))
    my = -((e * e / (b * b) + rho * s * e / (a * b))
           * (-math.expm1(-b * t0))
           - e * e / (2 * b * b) * (-math.expm1(-2 * b * t0))
           - rho * s * e / (a * (a + b)) * (-math.expm1(-(a + b) * t0)))

    m = max(int(n_quad), 101)
    xs = np.linspace(mx - 8.0 * sx, mx + 8.0 * sx, m)
    ys = np.linspace(my - 8.0 * sy, my + 8.0 * sy, m)
    dx, dy = xs[1] - xs[0], ys[1] - ys[0]
    wx = np.full(m, dx)
    wx[0] = wx[-1] = dx / 2
    wy = np.full(m, dy)
    wy[0] = wy[-1] = dy / 2
    xg, yg = np.meshgrid(xs, ys, indexing="ij")
    det = 1.0 - rxy * rxy
    zq = (((xg - mx) / sx) ** 2 - 2 * rxy * ((xg - mx) / sx)
          * ((yg - my) / sy) + ((yg - my) / sy) ** 2) / det
    pdf = np.exp(-0.5 * zq) / (2 * math.pi * sx * sy * math.sqrt(det))
    v = np.zeros_like(xg)
    for j in range(n + 1):
        v += coef[j] * np.exp(-ba[j] * xg - bb[j] * yg)
    if not payer:
        v = -v
    payer_px = pd_[0] * float(
        np.sum(np.maximum(v, 0.0) * pdf * wx[:, None] * wy[None, :]))
    return payer_px


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
