"""Geometric Brownian motion dynamics on tensors (port of
``mc_tpu/models/gbm.py``).

The reference hard-codes GBM in every kernel:

* the exact one-shot terminal draw over the horizon T,
  ``St *= exp((r - sigma^2/2) T + sigma sqrt(T) G)``
  (``inc/trajectories.cuh:74-75``, ``inc/tool.cuh:120-126``);
* the log-Euler step of size dt,
  ``St *= exp((r - sigma^2/2) dt + sigma sqrt(dt) G)``
  (``inc/trajectories.cuh:144-148``, ``inc/tool.cuh:155-171``).

Here they are plain tensor functions, and ``GBM`` packages the per-step
and terminal coefficients (f32, in ``mc_tpu``'s order) so that a step is
two multiplies and one exp.  The simulate kernels inline the same
arithmetic from ``path_kernels.pack_params``; nothing in the port calls
this module, which is the public counterpart of ``mc_tpu``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["gbm_exact_terminal", "gbm_log_euler_step", "GBM"]


def _t(x):
    return x if torch.is_tensor(x) else torch.tensor(float(x),
                                                     dtype=torch.float32)


def gbm_exact_terminal(s0, t, r, sigma, z):
    """S_T = S0 * exp((r - sigma^2/2) T + sigma sqrt(T) Z): exact under
    GBM, no discretization error (``trajectories.cuh:74-75``)."""
    t, sigma = _t(t), _t(sigma)
    drift = (r - 0.5 * sigma * sigma) * t
    vol = sigma * torch.sqrt(t)
    return s0 * torch.exp(drift + vol * z)


def gbm_log_euler_step(s, dt, r, sigma, z):
    """One log-Euler step: S <- S * exp((r - sigma^2/2) dt + sigma sqrt(dt)
    Z)."""
    dt, sigma = _t(dt), _t(sigma)
    drift = (r - 0.5 * sigma * sigma) * dt
    vol = sigma * torch.sqrt(dt)
    return s * torch.exp(drift + vol * z)


@dataclasses.dataclass(frozen=True)
class GBM:
    """GBM with precomputed log-step coefficients: log S step = a + b Z."""

    drift_dt: Any   # (r - sigma^2/2) * dt
    vol_dt: Any     # sigma * sqrt(dt)
    drift_t: Any    # (r - sigma^2/2) * T
    vol_t: Any      # sigma * sqrt(T)

    @staticmethod
    def make(t, r, sigma, n_steps: int, device="cpu") -> "GBM":
        """The coefficients as 0-d f32 tensors on ``device``, each computed
        in f32 in ``mc_tpu``'s order."""
        t, r, sigma = (torch.tensor(float(v), dtype=torch.float32)
                       for v in (t, r, sigma))
        dt = t / torch.tensor(float(n_steps), dtype=torch.float32)
        return GBM(*(v.to(device) for v in (
            (r - 0.5 * sigma * sigma) * dt, sigma * torch.sqrt(dt),
            (r - 0.5 * sigma * sigma) * t, sigma * torch.sqrt(t))))

    def step(self, s, z):
        """One log-Euler step (any shape)."""
        return s * torch.exp(self.drift_dt + self.vol_dt * z)

    def terminal(self, s0, z):
        """The exact terminal draw over the full horizon."""
        return s0 * torch.exp(self.drift_t + self.vol_t * z)
