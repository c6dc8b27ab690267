"""European swaptions under G2++ two-factor Gaussian rates fitted to an
input discount curve (port of the European half of
``mc_tpu/models/g2pp.py``).

r(t) = x(t) + y(t) + phi(t);  dx = -a x dt + sigma dW1,  dy = -b y dt +
eta dW2,  d<W1, W2> = rho dt; phi reprices the curve and is never
materialized.  (x, y, z = int x + y) over a step is jointly Gaussian, drawn
through the host-f64 3x3 Cholesky of ``step_chol``; bonds reconstruct as
P(t,S) = (P(0,S)/P(0,t)) exp(A(t,S) - B_a x - B_b y) with A = (V(S-t) -
V(S) + V(t))/2, and the discount is P(0,t) exp(-z - V(t)/2).

A European swaption prices from one draw at expiry: the threefry-13 pair at
counter (id, 0) and an inverse-CDF normal from word 0 at (id, 1)
(``rng.inv_normal_cdf``, a few ulp off ``mc_tpu``'s jitted one, ROADMAP
C19).  ``g2_tables`` is host f64 and ``pack_g2_swpt`` casts it to f32, so
the pack is bitwise ``mc_tpu``'s.  ``g2_swpt_pay`` and ``g2_mc_swpt_pay``
(multi-curve, ``mc_tpu``'s classic ``_g2_european_mc_impl`` arithmetic)
are tiles of kernel #11 (``ops/fused.py``, ``csrc/rates.cuh``).  Oracles:
``oracle.g2_swaption`` (conditional Jamshidian) and
``oracle.g2_swaption_multicurve`` (2-D quadrature).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import SimParams
from mc_tpu_torch.engines import STREAM_OUTER, resolve_device
from mc_tpu_torch.models.hullwhite import (DEMO_CURVE, DiscountCurve,
                                           hw_mc_weights, pack_multicurve)
from mc_tpu_torch.models.swaption import (DEMO_SWAPTION, SwaptionSpec,
                                          finish_swaption)
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops.fused import fused_moment_partials

__all__ = ["G2Dynamics", "DEMO_G2", "G2_TAG", "G2_SWPT_HEADER", "bf", "v_of",
           "step_chol", "g2_tables", "pack_g2_swpt", "g2_swpt_pay",
           "g2_mc_swpt_pay", "price_g2_swaption"]

# rng.derive_key stream tag of the G2++ swaption (mc_tpu's).
G2_TAG = 0x6270
# ch00, ch10, ch11, ch20, ch21, ch22, P(0,t0), V(t0)/2, K*tau, payer sign
G2_SWPT_HEADER = 10


@dataclasses.dataclass(frozen=True)
class G2Dynamics:
    """Two-factor parameters (host floats; the grid quantities are
    precomputed in f64 and shipped as f32)."""

    a: float = 0.5
    sigma: float = 0.01
    b_mr: float = 0.05
    eta: float = 0.008
    rho: float = -0.7

    def validate(self) -> "G2Dynamics":
        if not (self.a > 0.0 and self.b_mr > 0.0):
            raise ValueError(
                f"mean reversions must be > 0, got (a={self.a}, "
                f"b_mr={self.b_mr})")
        if self.sigma < 0.0 or self.eta < 0.0:
            raise ValueError(f"vols must be >= 0, got (sigma="
                             f"{self.sigma}, eta={self.eta})")
        if not -1.0 <= self.rho <= 1.0:
            raise ValueError(f"rho must be in [-1, 1], got {self.rho}")
        return self


DEMO_G2 = G2Dynamics()


def bf(k, t):
    """(1 - e^{-k t}) / k."""
    return -math.expm1(-k * t) / k


def v_of(dyn: G2Dynamics, t: float) -> float:
    """Var[int_0^t (x + y)] (closed form)."""
    a, s, b, e, rho = dyn.a, dyn.sigma, dyn.b_mr, dyn.eta, dyn.rho
    return ((s * s / (a * a)) * (t - 2 * bf(a, t)
                                 - math.expm1(-2 * a * t) / (2 * a))
            + (e * e / (b * b)) * (t - 2 * bf(b, t)
                                   - math.expm1(-2 * b * t) / (2 * b))
            + (2 * rho * s * e / (a * b))
            * (t - bf(a, t) - bf(b, t)
               - math.expm1(-(a + b) * t) / (a + b)))


def step_chol(dyn: G2Dynamics, dt: float):
    """Host-f64 step constants (``mc_tpu``'s ``_step_chol``): the decay
    factors, the integration loads and the 3x3 Cholesky of the (eps_x,
    eps_y, eps_z) covariance, its diagonal lifted by 1e-12 of the mean
    trace."""
    a, s, b, e, rho = dyn.a, dyn.sigma, dyn.b_mr, dyn.eta, dyn.rho
    ba, bb = bf(a, dt), bf(b, dt)
    bab = bf(a + b, dt)
    cxx = s * s * (-math.expm1(-2 * a * dt)) / (2 * a)
    cyy = e * e * (-math.expm1(-2 * b * dt)) / (2 * b)
    cxy = rho * s * e * (-math.expm1(-(a + b) * dt)) / (a + b)
    cxz = (s * s / a) * (ba - (-math.expm1(-2 * a * dt)) / (2 * a)) \
        + (rho * s * e / b) * (ba - bab)
    cyz = (e * e / b) * (bb - (-math.expm1(-2 * b * dt)) / (2 * b)) \
        + (rho * s * e / a) * (bb - bab)
    czz = v_of(dyn, dt)
    cov = np.array([[cxx, cxy, cxz],
                    [cxy, cyy, cyz],
                    [cxz, cyz, czz]], np.float64)
    cov += 1e-12 * np.trace(cov) / 3.0 * np.eye(3)
    chol = np.linalg.cholesky(cov)
    return (math.exp(-a * dt), math.exp(-b * dt), ba, bb, chol)


def g2_tables(spec: SwaptionSpec, dyn: G2Dynamics, curve: DiscountCurve):
    """Host-f64 (p0, vhalf, amat, bamat, bbmat) on the dates t_i = expiry
    + i tenor (``mc_tpu``'s ``_g2_tables``): p0[i] = P(0, t_i), vhalf[i] =
    V(t_i)/2 and, for j > i, A(t_i, t_j), B_a and B_b of t_j - t_i."""
    dyn.validate()
    n = spec.n_payments
    dates = [spec.expiry + i * spec.tenor for i in range(n + 1)]
    p0 = np.array([curve.df(t) for t in dates], np.float64)
    vhalf = np.array([0.5 * v_of(dyn, t) for t in dates], np.float64)
    amat = np.zeros((n + 1, n + 1), np.float64)
    bamat = np.zeros((n + 1, n + 1), np.float64)
    bbmat = np.zeros((n + 1, n + 1), np.float64)
    for i in range(n + 1):
        for j in range(i + 1, n + 1):
            tau = dates[j] - dates[i]
            amat[i, j] = 0.5 * (v_of(dyn, tau) - v_of(dyn, dates[j])
                                + v_of(dyn, dates[i]))
            bamat[i, j] = bf(dyn.a, tau)
            bbmat[i, j] = bf(dyn.b_mr, tau)
    return p0, vhalf, amat, bamat, bbmat


def pack_g2_swpt(spec: SwaptionSpec, dyn: G2Dynamics, consts,
                 device="cpu") -> torch.Tensor:
    """The (10 + 4n,) f32 pack of ``mc_tpu``'s ``_pack_g2_swpt``, bit for
    bit: the expiry step's Cholesky, P(0,t0), V(t0)/2, K*tau and the payer
    sign; then P(0,t_j)/P(0,t0), A_j, Ba_j and Bb_j, all host f64 rounded
    to f32."""
    p0, vhalf, amat, bamat, bbmat = consts
    n = spec.n_payments
    ch = step_chol(dyn, spec.expiry)[4]
    vals = np.concatenate([
        [ch[0, 0], ch[1, 0], ch[1, 1], ch[2, 0], ch[2, 1], ch[2, 2], p0[0],
         vhalf[0], spec.k_rate * spec.tenor, 1.0 if spec.payer else -1.0],
        [p0[j] / p0[0] for j in range(1, n + 1)],
        amat[0, 1:n + 1], bamat[0, 1:n + 1], bbmat[0, 1:n + 1]])
    return torch.from_numpy(vals.astype(np.float32)).to(device)


def _g2_draw(pv, ids, k0, k1):
    """(x, y, z) at expiry from the pair at (id, 0) and the inverse-CDF
    normal of word 0 at (id, 1); x0 = y0 = z0 = 0."""
    w0, w1 = rng.normal_pair(k0, k1, ids, torch.zeros_like(ids))
    bits, _ = rng.threefry2x32(k0, k1, ids, torch.ones_like(ids),
                               rounds=rng.DEFAULT_ROUNDS)
    w2 = rng.inv_normal_cdf(rng.bits_to_unit(bits))
    return (pv[0] * w0, pv[1] * w0 + pv[2] * w1,
            pv[3] * w0 + pv[4] * w1 + pv[5] * w2)


def _g2_bond(pv, n_pay, j, x, y):
    h = G2_SWPT_HEADER
    return pv[h + j] * torch.exp(pv[h + n_pay + j] - pv[h + 2 * n_pay + j] * x
                                 - pv[h + 3 * n_pay + j] * y)


def g2_swpt_pay(n_pay: int, pv: torch.Tensor, ids, k0: int, k1: int):
    """Each path's discounted payoff (``mc_tpu``'s ``_g2_swpt_tile`` op for
    op, ``csrc/rates.cuh`` ``G2Swpt``)."""
    x, y, z = _g2_draw(pv, ids, k0, k1)
    fixed = torch.zeros_like(x)
    for j in range(n_pay):
        p_j = _g2_bond(pv, n_pay, j, x, y)
        fixed = fixed + pv[8] * p_j
    fixed = fixed + p_j  # the principal rides the last bond
    mtm = (1.0 - fixed) * pv[9]
    return torch.clamp(mtm, min=0.0) * pv[6] * torch.exp(-z - pv[7])


def g2_mc_swpt_pay(n_pay: int, pv: torch.Tensor, ids, k0: int, k1: int):
    """The multi-curve payoff (``mc_tpu``'s ``_g2_mtm_multicurve`` at date
    0 and ``_g2_european_mc_impl``, ``csrc/rates.cuh`` ``G2SwptMc``)."""
    x, y, z = _g2_draw(pv, ids, k0, k1)
    base = G2_SWPT_HEADER + 4 * n_pay
    v = pv[base]
    for j in range(n_pay):
        v = v + pv[base + 1 + j] * _g2_bond(pv, n_pay, j, x, y)
    return torch.clamp(v * pv[9], min=0.0) * pv[6] * torch.exp(-z - pv[7])


def price_g2_swaption(spec: SwaptionSpec = DEMO_SWAPTION,
                      dyn: G2Dynamics = DEMO_G2,
                      curve: DiscountCurve = DEMO_CURVE,
                      sim: SimParams = SimParams(n_paths=1 << 20,
                                                 n_steps=1),
                      *,
                      projection_curve: Optional[DiscountCurve] = None,
                      seed=None,
                      stream: int = STREAM_OUTER,
                      device="cuda") -> PriceResult:
    """European payer/receiver swaption under curve-fitted G2++ on
    ``device``: one exact (x, y, int) draw at expiry, two-factor bonds on
    the curve, pathwise discounting; ``sim.n_steps`` is ignored.  Key
    ``rng.derive_key(seed, stream, 0x6270)``, the stream of
    ``mc_tpu.price_g2_swaption``.  ``projection_curve``: multi-curve (the
    ``g2_mc`` tile).  Oracles: ``oracle.g2_swaption``,
    ``oracle.g2_swaption_multicurve``."""
    spec = spec.validate()
    consts = g2_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = rng.derive_key(seed, stream, G2_TAG)
    dev = resolve_device(device)
    pv = pack_g2_swpt(spec, dyn, consts, dev)
    tile = "g2"
    if projection_curve is not None:
        pv = pack_multicurve(pv, *hw_mc_weights(spec, curve,
                                                projection_curve))
        tile = "g2_mc"
    return finish_swaption(fused_moment_partials(
        tile, spec.n_payments, (int(key[0]), int(key[1])), pv, sim.n_paths),
        sim.n_paths)
