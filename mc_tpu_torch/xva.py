"""XVA metrics on nested-MC value surfaces (port of ``mc_tpu/xva.py``).

The NMC engine produces a per-(path, step) conditional-value surface V_ij;
this module turns it into what an XVA desk books, for every result type
that carries the `ExposureMetrics` mixin:

* EE/ENE/PFE profiles (positive and negative expected exposure);
* unilateral CVA (counterparty default leg, flat hazard), DVA (own default
  leg on the negative exposure) and bilateral CVA = CVA - DVA;
* FVA split into funding cost (FCA, on EE) and benefit (FBA, on ENE);
* wrong-way-risk CVA with an exposure-linked intensity;
* dynamic initial margin (a quantile of the value move over the margin
  period of risk) and MVA;
* collateralized exposure under a two-way CSA: thresholds, minimum transfer
  amount and a margin period of risk (Gregory ch. 7).

All values are already discounted (the engines discount the inner legs to
t=0), so the metrics integrate profiles directly.  Column j of a surface
observes at a date t_j; every time integral runs over the actual intervals
(t_{j-1}, t_j] with t_0 = 0.  NMC surfaces observe on the uniform grid
t_j = j*T/n; a host with other dates carries them in ``obs_dates``, which
then overrides any ``t_horizon``.

Pure tensor code on the surface's device, in f32 as ``mc_tpu`` computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

__all__ = ["ExposureMetrics", "CollateralizedExposure", "coupon_dates"]

# torch.quantile refuses inputs of more than 2^24 elements.
QUANTILE_MAX_ELEMS = 1 << 24


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def coupon_dates(expiry, tenor, n: int, device="cuda") -> torch.Tensor:
    """Observation dates of a rates exposure grid: expiry + i*tenor for
    i = 0..n-1 (a swap's coupon or exercise dates), on ``device``."""
    return (_f32(expiry, device)
            + torch.arange(n, dtype=torch.float32, device=device)
            * _f32(tenor, device))


def _grid_weights(dates: torch.Tensor):
    """(t, t_prev, dt) from observation dates t_1..t_n (t_0 = 0): the
    integration intervals (t_{j-1}, t_j]."""
    t = dates.to(torch.float32)
    t_prev = torch.cat([t.new_zeros(1), t[:-1]])
    return t, t_prev, t - t_prev


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Per-column ``q`` quantile with linear interpolation (what
    ``jnp.quantile`` does by default).  ``torch.quantile`` takes at most
    2^24 elements: a 100,000 x 100 surface (1e7) passes; a larger one
    raises here rather than be cut or sampled."""
    if x.numel() > QUANTILE_MAX_ELEMS:
        raise ValueError(
            f"quantile over {x.numel()} surface points: torch.quantile takes "
            f"at most 2^24 = {QUANTILE_MAX_ELEMS}; use fewer outer paths or "
            "steps for PFE/IM")
    return torch.quantile(x, q, dim=0, interpolation="linear")


def _cva_on(v, hazard_rate, recovery, dates, side: float):
    """Default-leg integral on the positive (side=+1, CVA) or negative
    (side=-1, DVA) part of the value matrix ``v`` (n_paths, n_steps),
    observed at ``dates``: (1-R) * sum_j E[(side*V_j)^+] *
    [e^{-lam t_{j-1}} - e^{-lam t_j}]."""
    exp_prof = torch.clamp(side * v, min=0.0).mean(dim=0)
    t, t_prev, _ = _grid_weights(dates)
    lam = _f32(hazard_rate, v.device)
    dpd = torch.exp(-lam * t_prev) - torch.exp(-lam * t)
    return (1.0 - _f32(recovery, v.device)) * torch.sum(exp_prof * dpd)


def _cva_path_intensity(v, lam, dt, recovery):
    """CVA with a per-path intensity ``lam`` (n_paths, n_steps): survival
    and default increments along each path's own intensity over the
    intervals ``dt``, then averaged over paths."""
    h = lam * dt
    cum = torch.cumsum(h, dim=1)
    surv_prev = torch.exp(-(cum - h))
    dpd = surv_prev * (1.0 - torch.exp(-h))
    pos = torch.clamp(v, min=0.0)
    return (1.0 - _f32(recovery, v.device)) * torch.mean(
        torch.sum(pos * dpd, dim=1))


class ExposureMetrics:
    """Shared XVA surface metrics.  Hosts provide ``surface_matrix()`` ->
    (n_paths, n_steps) discounted values and a ``t_horizon`` field; hosts
    whose columns do not observe on the uniform grid j*T/n also carry an
    ``obs_dates`` vector, which is then authoritative and any
    ``t_horizon=`` override is ignored.
    """

    obs_dates = None  # hosts with non-uniform observation set a field

    def observation_dates(self, t_horizon: Optional[float] = None,
                          n: Optional[int] = None) -> torch.Tensor:
        """Dates t_1..t_n the surface columns observe at (t_0 = 0 is
        implicit): ``obs_dates`` if the host carries one, else the uniform
        grid j * t_horizon / n."""
        v = self.surface_matrix()
        od = getattr(self, "obs_dates", None)
        if od is not None:
            return _f32(od, v.device)
        n = v.shape[1] if n is None else n
        th = _f32(self.t_horizon if t_horizon is None else t_horizon,
                  v.device)
        return (torch.arange(1, n + 1, dtype=torch.float32, device=v.device)
                * (th / n))

    def exposure_profile(self, quantile: float = 0.95):
        """(EE, PFE): expected exposure mean(max(V_j, 0)) and its
        ``quantile`` per observation date, each (n_steps,)."""
        pos = torch.clamp(self.surface_matrix(), min=0.0)
        return pos.mean(dim=0), _quantile(pos, quantile)

    def ene_profile(self, quantile: float = 0.95):
        """(ENE, NPFE): expected negative exposure mean(max(-V, 0)) and its
        quantile per date: the own-default and funding-benefit side."""
        neg = torch.clamp(-self.surface_matrix(), min=0.0)
        return neg.mean(dim=0), _quantile(neg, quantile)

    def cva(self, hazard_rate: float, recovery: float = 0.4,
            t_horizon: Optional[float] = None):
        """Unilateral CVA = (1 - R) * sum_j EE(t_j) * PD(t_{j-1}, t_j) with a
        flat hazard rate: PD over (a, b] = e^{-lambda a} - e^{-lambda b}.
        The values are already discounted (the EE* convention).
        ``t_horizon`` rescales the uniform grid only."""
        v = self.surface_matrix()
        return _cva_on(v, hazard_rate, recovery,
                       self.observation_dates(t_horizon, v.shape[1]), +1.0)

    def dva(self, own_hazard_rate: float, own_recovery: float = 0.4,
            t_horizon: Optional[float] = None):
        """Debit valuation adjustment: the own-default leg on the negative
        exposure."""
        v = self.surface_matrix()
        return _cva_on(v, own_hazard_rate, own_recovery,
                       self.observation_dates(t_horizon, v.shape[1]), -1.0)

    def bilateral_cva(self, hazard_rate: float, own_hazard_rate: float,
                      recovery: float = 0.4, own_recovery: float = 0.4,
                      t_horizon: Optional[float] = None):
        """BCVA = CVA - DVA (independent flat hazards, no first-to-default
        correction)."""
        v = self.surface_matrix()
        dates = self.observation_dates(t_horizon, v.shape[1])
        return (_cva_on(v, hazard_rate, recovery, dates, +1.0)
                - _cva_on(v, own_hazard_rate, own_recovery, dates, -1.0))

    def fva(self, funding_spread: float,
            t_horizon: Optional[float] = None):
        """(FCA, FBA): spread * integral of EE dt (cost) and of ENE dt
        (benefit) over the actual intervals.  Net FVA = FCA - FBA."""
        v = self.surface_matrix()
        _, _, dt = _grid_weights(self.observation_dates(t_horizon, v.shape[1]))
        sp = _f32(funding_spread, v.device)
        fca = sp * torch.sum(torch.clamp(v, min=0.0).mean(dim=0) * dt)
        fba = sp * torch.sum(torch.clamp(-v, min=0.0).mean(dim=0) * dt)
        return fca, fba

    def cva_wwr(self, hazard_rate: float, beta: float,
                recovery: float = 0.4, t_horizon: Optional[float] = None):
        """CVA under wrong-way risk: the intensity rides each path's own
        exposure, lambda_i(t_j) = hazard_rate * exp(beta * (V_ij -
        mean_j V)) (Hull-White 2012; centred, so beta=0 is the flat CVA).
        Survival and default increments run along each path's intensity
        path over the actual intervals, then are averaged."""
        v = self.surface_matrix()
        _, _, dt = _grid_weights(self.observation_dates(t_horizon, v.shape[1]))
        lam = _f32(hazard_rate, v.device) * torch.exp(
            _f32(beta, v.device) * (v - v.mean(dim=0, keepdim=True)))
        return _cva_path_intensity(v, lam, dt, recovery)

    def im_profile(self, quantile: float = 0.99, mpor_steps: int = 2):
        """Dynamic initial margin IM(t_j): the ``quantile`` of the adverse
        move (V_{j+m} - V_j)^+ over the margin period of risk m.  The last
        m dates carry the final computable value."""
        if mpor_steps < 1:
            raise ValueError(f"mpor_steps must be >= 1, got {mpor_steps}")
        v = self.surface_matrix()
        m = min(int(mpor_steps), v.shape[1] - 1)
        if m < 1:
            return v.new_zeros(v.shape[1])
        move = torch.clamp(v[:, m:] - v[:, :-m], min=0.0)
        im = _quantile(move, quantile)
        return torch.cat([im, im[-1:].expand(m)])

    def mva(self, funding_spread: float, quantile: float = 0.99,
            mpor_steps: int = 2, t_horizon: Optional[float] = None):
        """Margin valuation adjustment: spread * integral IM(t) dt over the
        actual intervals."""
        im = self.im_profile(quantile, mpor_steps)
        _, _, dt = _grid_weights(self.observation_dates(t_horizon,
                                                        im.shape[0]))
        return _f32(funding_spread, im.device) * torch.sum(im * dt)

    def collateralized(self, threshold: float = 0.0,
                       own_threshold: Optional[float] = None,
                       mta: float = 0.0,
                       mpor_steps: int = 0) -> "CollateralizedExposure":
        """Exposure under a two-way CSA.

        The collateral held against t_j was called at t_{j-m} (m =
        ``mpor_steps``): C_j = (V_{j-m} - H)^+ - (-V_{j-m} - H_own)^+, each
        leg posted only when the call exceeds ``mta``.  The first m dates
        are uncollateralized.  m=0 is instantaneous margining: with
        H = mta = 0 the residual exposure is zero.  The host's observation
        dates carry through.
        """
        if mpor_steps < 0:
            raise ValueError(f"mpor_steps must be >= 0, got {mpor_steps}")
        if mta < 0.0:
            raise ValueError(f"mta must be >= 0, got {mta}")
        v = self.surface_matrix()
        h_c = _f32(threshold, v.device)
        h_o = _f32(threshold if own_threshold is None else own_threshold,
                   v.device)
        # m >= n_steps: no call settles inside the horizon
        m = min(int(mpor_steps), v.shape[1])
        v_call = (v if m == 0 else
                  torch.cat([v.new_zeros((v.shape[0], m)),
                             v[:, : v.shape[1] - m]], dim=1))
        call_c = torch.clamp(v_call - h_c, min=0.0)
        call_o = torch.clamp(-v_call - h_o, min=0.0)
        mta_f = _f32(mta, v.device)
        coll = (torch.where(call_c > mta_f, call_c, 0.0)
                - torch.where(call_o > mta_f, call_o, 0.0))
        return CollateralizedExposure(values=v - coll,
                                      t_horizon=self.t_horizon,
                                      obs_dates=getattr(self, "obs_dates",
                                                        None))


@dataclasses.dataclass(frozen=True)
class CollateralizedExposure(ExposureMetrics):
    """A value matrix with the full metrics surface: the carrier for a
    net-of-collateral matrix or any exposure matrix built elsewhere;
    non-uniform observation dates ride in ``obs_dates``."""

    values: Any          # (n_paths, n_steps), discounted
    t_horizon: Any
    obs_dates: Any = None  # (n_steps,) dates t_1..t_n; None = uniform grid

    def surface_matrix(self):
        return self.values
