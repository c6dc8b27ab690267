"""Pricing engine (port of ``mc_tpu/engines.py:165-411``).

``price`` chooses the method and stream exactly as ``mc_tpu.price`` does,
runs one kernel (or its plain version on the CPU), finishes the moment
sums in f64 and returns a `PriceResult`.  ``simulate_trajectories``
materializes every step's price and payoff state.  The device is explicit:
CUDA by default, and there is no fallback when no card is present.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.oracle import PriceResult, summarize
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PathPayoff, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["price", "finish_price", "simulate_trajectories", "Trajectories",
           "STREAM_OUTER", "STREAM_INNER", "resolve_device"]

# Stream tags (replace the reference's magic seeds 1234/1235,
# wrappers.cuh:41,151: outer vs inner NMC draws must be independent).
STREAM_OUTER = 0
STREAM_INNER = 1


def resolve_device(device) -> torch.device:
    """The requested device, refused if it cannot run here."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' "
                         "or 'cpu'")
    return dev


def _f32_fields(option: OptionParams) -> OptionParams:
    """The option as the kernels see it: every field rounded to f32."""
    return OptionParams(*(float(np.float32(v)) for v in option.astuple()))


def finish_price(sums: torch.Tensor, n_paths: int, option: OptionParams,
                 control_variate: bool = False) -> PriceResult:
    """PriceResult from the finished f64 moment sums of one pricing run:
    ``[sum_pay, sum_pay2]``, or with the control variate
    ``[sum_pay, sum_pay2, sum_x, sum_x2, sum_pay_x]``."""
    o = _f32_fields(option)
    discount = math.exp(-o.r * o.t)
    n = torch.tensor(float(n_paths), dtype=torch.float64, device=sums.device)
    if not control_variate:
        return summarize(sums[0], sums[1], n, discount)

    # Control-variate finish (no Bessel factor, as in mc_tpu).
    sum_p, sum_p2, sum_x, sum_x2, sum_px = sums
    mean_p = sum_p / n
    mean_x = sum_x / n
    var_p = torch.clamp(sum_p2 / n - mean_p * mean_p, min=0.0)
    var_x = torch.clamp(sum_x2 / n - mean_x * mean_x, min=1e-30)
    cov = sum_px / n - mean_p * mean_x
    beta = cov / var_x
    ex = o.s0 * math.exp((o.r - o.q) * o.t)  # E[S_T]
    adj_mean = mean_p - beta * (mean_x - ex)
    adj_var = torch.clamp(var_p - cov * cov / var_x, min=0.0)
    return PriceResult(
        price=discount * adj_mean,
        stderr=torch.sqrt(adj_var / n) * discount,
        n_paths=n,
        payoff_mean=adj_mean,
        payoff_var=adj_var,
    )


def _price_impl(option: OptionParams, payoff: PathPayoff, sim: SimParams,
                method: str, antithetic: bool, control_variate: bool,
                rng_source: str, key, path_offset: int, n_paths: int,
                importance_shift: float, device: torch.device) -> PriceResult:
    params = pk.pack_params(option, sim.n_steps, device)
    if method == "terminal_pair":
        # both Box-Muller halves become paths: element e = paths (2e, 2e+1)
        cfgp = pk.KernelConfig(n_paths=(n_paths + 1) // 2, n_steps=sim.n_steps,
                               rng_source=rng_source, method="terminal")
        partials = pk.terminal_pair_partials(payoff, cfgp, key, params, n_paths)
    else:
        cfg = pk.KernelConfig(n_paths=n_paths, n_steps=sim.n_steps,
                              antithetic=antithetic, with_cv=control_variate,
                              rng_source=rng_source, method=method,
                              is_shift=importance_shift)
        partials = pk.simulate_partials(payoff, cfg, key, params,
                                        path_offset=path_offset)
    return finish_price(finish_sum(partials), n_paths, option,
                        control_variate)


def price(option: OptionParams = DEMO_OPTION,
          sim: SimParams = DEMO_SIM,
          payoff="vanilla_call",
          *,
          method: Optional[str] = None,
          antithetic: bool = False,
          control_variate: bool = False,
          rng_source: str = "threefry13",
          stream: int = STREAM_OUTER,
          key=None,
          path_offset: int = 0,
          n_paths: Optional[int] = None,
          importance_shift=0.0,
          device="cuda") -> PriceResult:
    """Price an option by Monte Carlo on ``device``.

    method: "terminal" (exact, European-only) | "terminal_pair" (exact,
    both Box-Muller halves become paths; no antithetic/CV/offset) |
    "euler".  Default, as in ``mc_tpu.price``: "terminal_pair" for plain
    terminal-only pricing, "terminal" when antithetic/CV/path_offset need
    the per-path counter stream, "euler" for path-dependent payoffs.  The
    two terminal kernels draw different streams (pair element e covers
    paths (2e, 2e+1)).

    ``key``: a (k0, k1) pair of uint32 words; default
    ``rng.derive_key(sim.seed, stream)``.

    ``importance_shift``: shift the sampled terminal log-price by this many
    sigma*sqrt(T) standard deviations, with the exact likelihood ratio on
    every payoff (unbiased); ``"auto"`` centres the terminal log-price at
    log K, (log(K/S0) - (r - q - sigma^2/2) T) / (sigma sqrt(T)), which aims
    deep out-of-the-money paths at the strike.
    """
    po = get_payoff(payoff)
    if method is None:
        if (po.terminal_only and not antithetic and not control_variate
                and not importance_shift and not path_offset):
            method = "terminal_pair"
        else:
            method = "terminal" if po.terminal_only else "euler"
    if po.n_state > 0 and method in ("terminal", "terminal_pair"):
        raise ValueError(f"{po.name} is path-dependent; "
                         f"method={method!r} invalid")
    if method not in ("terminal", "terminal_pair", "euler"):
        raise ValueError(f"unknown method {method!r}; use 'terminal_pair', "
                         "'terminal' or 'euler'")
    if method == "terminal_pair":
        if antithetic or control_variate or importance_shift:
            raise ValueError("terminal_pair is the plain fast path: "
                             "antithetic/control_variate/importance_shift "
                             "route through method='terminal'")
        if path_offset:
            raise ValueError("terminal_pair does not take a path_offset "
                             "(element ids cover paths (2e, 2e+1))")
    if importance_shift == "auto":
        # centre E[log S_T] at log K: shift = (log(K/S0) - mu T)/(sigma vT)
        mu = option.r - option.q - 0.5 * option.sigma ** 2
        importance_shift = ((math.log(option.k / option.s0) - mu * option.t)
                            / (option.sigma * math.sqrt(option.t)))
    pk.check_rng_source(rng_source)
    dev = resolve_device(device)
    if key is None:
        key = rng.derive_key(sim.seed, stream)
    key = (int(key[0]), int(key[1]))
    return _price_impl(option, po, sim, method, antithetic, control_variate,
                       rng_source, key, int(path_offset),
                       int(n_paths or sim.n_paths), float(importance_shift),
                       dev)


# ---------------------------------------------------------------------------
# Trajectory materialization (the reference's C9)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Trajectories:
    """Materialized path grids, step-major ``(n_steps, n_paths)`` f32.

    ``s[j]`` is the price after step j+1; ``state[j]`` the payoff state
    (the bullet barrier count; zeros for a payoff without state) after step
    j+1: the (d_stock_prices, d_sums_i) grids of trajectories.cuh:304-305.
    ``pay_sum``/``pay_sq`` are the f64 sums of the undiscounted payoff and
    its square over the paths.
    """

    s: Any
    state: Any
    pay_sum: Any
    pay_sq: Any

    @property
    def n_paths(self) -> int:
        return self.s.shape[1]

    def path_matrix(self):
        """(n_paths, n_steps) view of the price grid."""
        return self.s.T

    def state_matrix(self):
        """(n_paths, n_steps) view of the state grid."""
        return self.state.T


def simulate_trajectories(option: OptionParams = DEMO_OPTION,
                          sim: SimParams = DEMO_SIM,
                          payoff="bullet_call",
                          *,
                          stream: int = STREAM_OUTER,
                          key=None,
                          path_offset: int = 0,
                          device="cuda") -> Trajectories:
    """Simulate and keep every step of ``sim.n_paths`` log-Euler paths
    (simulate_outer_trajectories, trajectories.cuh:273-351) on ``device``,
    on the threefry-13 stream ``price()`` draws for the same key."""
    po = get_payoff(payoff)
    dev = resolve_device(device)
    if key is None:
        key = rng.derive_key(sim.seed, stream)
    key = (int(key[0]), int(key[1]))
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps)
    s, st, partials = pk.simulate_trajectories(
        po, cfg, key, pk.pack_params(option, sim.n_steps, dev),
        path_offset=int(path_offset))
    pay_sum, pay_sq = finish_sum(partials)
    return Trajectories(s=s, state=st, pay_sum=pay_sum, pay_sq=pay_sq)
