"""European swaptions under Hull-White fitted to an input discount curve
(port of the European half of ``mc_tpu/models/hullwhite.py``).

dr = (theta(t) - a r) dt + sigma dW with theta(t) chosen so that today's
curve P(0, t) is repriced exactly; r(t) = x(t) + alpha(t) with x an OU
factor started at 0 makes everything tractable without materializing theta
(Brigo-Mercurio ch. 3):

    bonds:  P(t, S) = (P(0,S)/P(0,t)) exp(-B(S-t) x(t) - corr(t, S))
    cash:   e^{-int_0^t r} = P(0, t) exp(-int_0^t x - c(t)),
            c(t) = Var[int_0^t x]/2

(x, int x) over a step is the Vasicek pair with b = 0, so a European
swaption prices from one exact draw at expiry (the threefry-13 pair at
counter (id, 0)): ``hw_tables`` and ``hw_mc_weights`` precompute the curve
algebra in host f64, ``pack_hw_swpt`` ships it in f32, and ``hw_swpt_pay``
is the tile of kernel #11 (``ops/fused.py``, ``csrc/rates.cuh``
``HwSwpt``).  Multi-curve (forwards off a projection curve, discounting
off ``curve``, a deterministic basis) is a second tile on the same kernel,
``hw_mc_swpt_pay``, whose arithmetic follows ``mc_tpu``'s classic
``_hw_european_mc_impl`` (its fused engines are single-curve).  Oracles:
``oracle.hw_swaption`` (curve-consistent Jamshidian) and
``oracle.hw_swaption_multicurve`` (quadrature).
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
from mc_tpu_torch.models.swaption import (DEMO_SWAPTION, SwaptionSpec,
                                          finish_swaption)
from mc_tpu_torch.models.vasicek import ou_chol2
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops.fused import fused_moment_partials

__all__ = ["DiscountCurve", "DEMO_CURVE", "HullWhiteDynamics", "DEMO_HW",
           "HW_TAG", "HW_SWPT_HEADER", "hw_tables", "hw_mc_weights",
           "pack_hw_swpt", "pack_multicurve", "hw_swpt_pay",
           "hw_mc_swpt_pay", "price_hw_swaption"]

# rng.derive_key stream tag of the Hull-White swaption (mc_tpu's).
HW_TAG = 0x4877
# l11, l21, l22, P(0,t0), c0, K*tau, payer sign
HW_SWPT_HEADER = 7


class DiscountCurve:
    """P(0, t) from zero-rate knots (host-side, float64).

    Log-linear interpolation of the discount factor (= linear in t*z(t),
    the market-standard bootstrap convention); flat zero-rate
    extrapolation beyond the last knot.
    """

    def __init__(self, times, zeros):
        self.times = np.asarray(times, np.float64)
        self.zeros = np.asarray(zeros, np.float64)
        if self.times.ndim != 1 or self.times.shape != self.zeros.shape:
            raise ValueError("times/zeros must be matching 1-D arrays")
        if self.times.shape[0] < 1:
            raise ValueError("need at least one curve knot")
        if np.any(self.times <= 0.0):
            raise ValueError("knot times must be > 0")
        if np.any(np.diff(self.times) <= 0.0):
            raise ValueError("knot times must be strictly ascending")

    @staticmethod
    def flat(rate: float, horizon: float = 50.0) -> "DiscountCurve":
        return DiscountCurve([horizon], [rate])

    @staticmethod
    def from_par_swaps(maturities, par_rates,
                       tenor: float = 0.5) -> "DiscountCurve":
        """Bootstrap the curve from par swap quotes: ``par_rates[i]`` is the
        fixed rate making the spot-starting swap to ``maturities[i]`` worth
        zero, s_m tau sum_{j<=m} P(t_j) = 1 - P(t_m).  Maturities lie on
        the tenor grid and ascend; par rates between quotes interpolate
        linearly (the single-curve bootstrap)."""
        mats = np.asarray(maturities, np.float64)
        pars = np.asarray(par_rates, np.float64)
        if mats.shape != pars.shape or mats.ndim != 1:
            raise ValueError("maturities/par_rates must match, 1-D")
        if np.any(np.diff(mats) <= 0.0):
            raise ValueError("maturities must be strictly ascending")
        n_steps = np.round(mats / tenor).astype(int)
        if not np.allclose(n_steps * tenor, mats, atol=1e-9):
            raise ValueError("maturities must lie on the tenor grid")
        grid = np.arange(1, n_steps[-1] + 1) * tenor
        s = np.interp(grid, mats, pars)
        dfs = np.empty(len(grid), np.float64)
        acc = 0.0  # running annuity sum_{j<m} P(t_j)
        for m in range(len(grid)):
            with np.errstate(divide="ignore", invalid="ignore"):
                dfs[m] = ((1.0 - s[m] * tenor * acc)
                          / (1.0 + s[m] * tenor))
            # Inconsistent quotes drive 1 - s tau acc <= 0, whose log would
            # put NaN zero rates into every price: name the pillar instead.
            if not (0.0 < dfs[m] < np.inf) or np.isnan(dfs[m]):
                raise ValueError(
                    f"par-swap bootstrap failed at maturity "
                    f"{grid[m]:g} (par rate {s[m]:.6g}): implied "
                    f"discount factor {dfs[m]:.6g} is not a positive "
                    "finite number — the quotes are inconsistent with "
                    "positive rates")
            acc += dfs[m]
        zeros = -np.log(dfs) / grid
        return DiscountCurve(grid, zeros)

    def df(self, t) -> float:
        """P(0, t); t = 0 -> 1 exactly."""
        t = float(t)
        if t <= 0.0:
            return 1.0
        ts, zs = self.times, self.zeros
        tz = ts * zs  # integrated zero t z(t), linear between knots
        v = np.interp(t, ts, tz)
        if t > ts[-1]:
            v = tz[-1] + zs[-1] * (t - ts[-1])
        if t < ts[0]:
            v = zs[0] * t  # flat short end
        return float(math.exp(-v))


DEMO_CURVE = DiscountCurve([0.5, 1.0, 2.0, 3.0, 5.0, 10.0],
                           [0.030, 0.035, 0.040, 0.043, 0.046, 0.048])


@dataclasses.dataclass(frozen=True)
class HullWhiteDynamics:
    """Mean-reversion speed and short-rate vol (host floats: everything
    derived is precomputed in f64 and shipped as f32)."""

    a: float = 0.3
    sigma_r: float = 0.015

    def validate(self) -> "HullWhiteDynamics":
        if not self.a > 0.0:
            raise ValueError(f"mean reversion a must be > 0, got "
                             f"{self.a} (every B(t), variance, and "
                             "correction divides by it)")
        if self.sigma_r < 0.0:
            raise ValueError(f"sigma_r must be >= 0, got {self.sigma_r}")
        return self


DEMO_HW = HullWhiteDynamics()


def _dates(spec: SwaptionSpec):
    return [spec.expiry + i * spec.tenor for i in range(spec.n_payments + 1)]


def hw_tables(spec: SwaptionSpec, dyn: HullWhiteDynamics,
              curve: DiscountCurve):
    """Host-f64 (p0, c, bmat, corr) on the dates t_i = expiry + i tenor,
    i = 0..n (``mc_tpu``'s ``_hw_tables``): p0[i] = P(0, t_i); c[i] =
    Var[int_0^{t_i} x]/2; for j > i, bmat[i, j] = B(t_j - t_i) and
    corr[i, j] = (sigma^2/(4a))(1 - e^{-2a t_i}) B^2 + B sigma^2/(2a^2)
    (1 - e^{-a t_i})^2, the full bond exponent whose second term makes
    E[D(0,t_i) P(t_i,t_j)] == P(0,t_j)."""
    dyn.validate()
    a, sig = float(dyn.a), float(dyn.sigma_r)
    n = spec.n_payments
    dates = _dates(spec)
    p0 = np.array([curve.df(t) for t in dates], np.float64)
    bt = lambda tau: -math.expm1(-a * tau) / a
    c = np.array([
        (sig * sig / (2.0 * a * a))
        * (t - 2.0 * bt(t) - math.expm1(-2.0 * a * t) / (2.0 * a))
        for t in dates], np.float64)
    bmat = np.zeros((n + 1, n + 1), np.float64)
    corr = np.zeros((n + 1, n + 1), np.float64)
    for i in range(n + 1):
        var_fac = (sig * sig / (4.0 * a)) * (-math.expm1(-2.0 * a
                                                         * dates[i]))
        shift = (sig * sig / (2.0 * a * a)) * math.expm1(
            -a * dates[i]) ** 2
        for j in range(i + 1, n + 1):
            bmat[i, j] = bt(dates[j] - dates[i])
            corr[i, j] = (var_fac * bmat[i, j] * bmat[i, j]
                          + bmat[i, j] * shift)
    return p0, c, bmat, corr


def hw_mc_weights(spec: SwaptionSpec, curve: DiscountCurve,
                  proj: DiscountCurve):
    """Host-f64 multi-curve weights (``mc_tpu``'s ``_hw_mc_weights``):
    with the deterministic basis B(t) = P_proj/P_disc, the remaining swap
    at date t_i is const[i] + sum_{m > i} wvec[m] P_disc(t_i, t_m; x)."""
    n = spec.n_payments
    dates = _dates(spec)
    basis = np.array([proj.df(t) / curve.df(t) for t in dates],
                     np.float64)
    wvec = np.zeros(n + 1, np.float64)
    for m in range(1, n):
        wvec[m] = basis[m] / basis[m + 1] - 1.0 - spec.k_rate * spec.tenor
    wvec[n] = -1.0 - spec.k_rate * spec.tenor
    const = np.array([basis[i] / basis[i + 1] if i < n else 0.0
                      for i in range(n + 1)], np.float64)
    return const, wvec


def _f32(v):
    return torch.tensor(float(v), dtype=torch.float32)


def pack_hw_swpt(a, sigma_r, spec: SwaptionSpec, p0, c, bmat, corr,
                 device="cpu") -> torch.Tensor:
    """The (7 + 3n,) f32 pack of ``mc_tpu``'s ``_pack_hw_swpt`` on
    ``device``: l11, l21, l22 of the OU step to expiry (``ou_chol2`` in
    f32), P(0,t0), c0, K*tau (rounded from f64) and the payer sign; then
    P(0,t_j)/P(0,t0), B_j and corr_j from the host-f64 tables."""
    n = spec.n_payments
    _, _, l11, l21, l22 = ou_chol2(_f32(a), _f32(sigma_r), _f32(spec.expiry))
    head = torch.stack([l11, l21, l22])
    rest = np.concatenate([
        [p0[0], c[0], spec.k_rate * spec.tenor,
         1.0 if spec.payer else -1.0],
        [p0[j] / p0[0] for j in range(1, n + 1)],
        bmat[0, 1:n + 1], corr[0, 1:n + 1]]).astype(np.float32)
    return torch.cat([head, torch.from_numpy(rest)]).to(device)


def pack_multicurve(pv: torch.Tensor, const, wvec) -> torch.Tensor:
    """A multi-curve tile's pack (``hw_mc``, ``g2_mc``): the single-curve
    pack ``pv``, then const[0] and wvec[1..n] of ``hw_mc_weights`` in
    f32."""
    n = len(wvec) - 1
    extra = np.concatenate([[const[0]], wvec[1:n + 1]]).astype(np.float32)
    return torch.cat([pv, torch.from_numpy(extra).to(pv.device)])


def _hw_draw(pv, ids, k0, k1):
    z0, z1 = rng.normal_pair(k0, k1, ids, torch.zeros_like(ids))
    return pv[0] * z0, pv[1] * z0 + pv[2] * z1  # x0 = 0: the expiry draw


def _hw_bond(pv, n_pay, j, x):
    h = HW_SWPT_HEADER
    return pv[h + j] * torch.exp(-pv[h + n_pay + j] * x
                                 - pv[h + 2 * n_pay + j])


def hw_swpt_pay(n_pay: int, pv: torch.Tensor, ids, k0: int, k1: int):
    """Each path's discounted payoff (``mc_tpu``'s ``_hw_swpt_tile`` op for
    op, ``csrc/rates.cuh`` ``HwSwpt``): the pair at (id, 0), the bond
    loop with the principal on the last bond, the curve discount."""
    x, y = _hw_draw(pv, ids, k0, k1)
    fixed = torch.zeros_like(x)
    for j in range(n_pay):
        p_j = _hw_bond(pv, n_pay, j, x)
        fixed = fixed + pv[5] * p_j
    fixed = fixed + p_j  # the principal rides the last bond
    swap = (1.0 - fixed) * pv[6]
    return torch.clamp(swap, min=0.0) * pv[3] * torch.exp(-y - pv[4])


def hw_mc_swpt_pay(n_pay: int, pv: torch.Tensor, ids, k0: int, k1: int):
    """The multi-curve payoff (``mc_tpu``'s ``_hw_mtm_multicurve`` at date
    0 and ``_hw_european_mc_impl``, ``csrc/rates.cuh`` ``HwSwptMc``): v =
    const_0 + sum_j w_j p_j, signed, max(v, 0) P(0,t0) e^{-y - c0}."""
    x, y = _hw_draw(pv, ids, k0, k1)
    base = HW_SWPT_HEADER + 3 * n_pay
    v = pv[base]
    for j in range(n_pay):
        v = v + pv[base + 1 + j] * _hw_bond(pv, n_pay, j, x)
    return torch.clamp(v * pv[6], min=0.0) * pv[3] * torch.exp(-y - pv[4])


def price_hw_swaption(spec: SwaptionSpec = DEMO_SWAPTION,
                      dyn: HullWhiteDynamics = DEMO_HW,
                      curve: DiscountCurve = DEMO_CURVE,
                      sim: SimParams = SimParams(n_paths=1 << 20,
                                                 n_steps=1),
                      *,
                      projection_curve: Optional[DiscountCurve] = None,
                      seed=None,
                      stream: int = STREAM_OUTER,
                      device="cuda") -> PriceResult:
    """European payer/receiver swaption under curve-fitted Hull-White on
    ``device``: one exact (x, int x) draw at expiry, curve-reconstructed
    bonds, pathwise discounting through the curve; ``sim.n_steps`` is
    ignored.  Key ``rng.derive_key(seed, stream, 0x4877)``, the stream of
    ``mc_tpu.price_hw_swaption``.  ``projection_curve``: multi-curve,
    forwards off it and discounting off ``curve`` (the ``hw_mc`` tile).
    Oracles: ``oracle.hw_swaption``, ``oracle.hw_swaption_multicurve``."""
    spec = spec.validate()
    p0, c, bmat, corr = hw_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = rng.derive_key(seed, stream, HW_TAG)
    dev = resolve_device(device)
    pv = pack_hw_swpt(dyn.a, dyn.sigma_r, spec, p0, c, bmat, corr, dev)
    tile = "hw"
    if projection_curve is not None:
        pv = pack_multicurve(pv, *hw_mc_weights(spec, curve,
                                                projection_curve))
        tile = "hw_mc"
    return finish_swaption(fused_moment_partials(
        tile, spec.n_payments, (int(key[0]), int(key[1])), pv, sim.n_paths),
        sim.n_paths)
