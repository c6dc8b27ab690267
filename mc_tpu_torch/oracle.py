"""Closed-form oracles and the Monte Carlo result type
(port of ``mc_tpu/oracle.py:63-200,208-455,459-505,515-549,549-638``).

The oracles are host f64 through ``math.erf``/``math.erfc``: the gates of
the payoffs (vanilla, digital, continuous-barrier, forward-start, cliquet),
of the greeks (Black-Scholes delta, vega, gamma), the implied volatility,
the Vasicek bond and Merton's (1973) call under Vasicek rates,
Margrabe's (1978) exchange option, the bivariate normal CDF (Genz's BVND)
with Stulz's (1982) two-asset min/max options, and the cross-currency
closed forms (Garman-Kohlhagen, quanto, composite, flexo).
``summarize`` turns f64 moment sums into a `PriceResult` on whatever device
the sums live.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["bs_call", "bs_put", "bs_digital_call", "bs_digital_put",
           "bs_up_out_call", "bs_down_out_call", "bs_forward_start_call",
           "bs_cliquet", "bs_delta_call", "bs_vega", "bs_gamma",
           "bs_implied_vol", "vasicek_zcb", "bsv_call", "margrabe",
           "bvn_cdf", "stulz_min_call", "stulz_max_call", "stulz_min_put",
           "stulz_max_put", "gk_call", "gk_put", "quanto_call", "quanto_put",
           "compo_call", "compo_put", "flexo_call", "flexo_put",
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
