"""Pricing engine (port of ``mc_tpu/engines.py:165-649``).

``price`` chooses the method and stream exactly as ``mc_tpu.price`` does,
runs one kernel (or its plain version on the CPU), finishes the moment
sums in f64 and returns a `PriceResult`.  ``simulate_trajectories``
materializes every step's price and payoff state.  ``price_ladder`` prices
M strikes on shared paths and ``price_portfolio`` a book of B contracts
under common random numbers, each in one kernel.  The device is explicit:
CUDA by default, and there is no fallback when no card is present.

``price`` is differentiable (the counterpart of ``mc_tpu``'s custom VJP,
``mc_tpu/engines.py:112-157``): option fields given as 0-d tensors that
require grad flow through the packing, the simulate kernel and the finish,
so ``torch.autograd.grad`` of a price gives its pathwise derivatives.
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

__all__ = ["price", "price_ladder", "price_portfolio", "finish_price",
           "control_mean", "simulate_trajectories", "Trajectories",
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


def _f32(v, device):
    """A field as the kernels see it, rounded to f32: a float, or an f64
    tensor on ``device`` for an array-valued (book) field or a field that
    requires grad (whose graph it keeps)."""
    if getattr(v, "ndim", 0) or (torch.is_tensor(v) and v.requires_grad):
        return torch.as_tensor(v).to(torch.float32).to(device, torch.float64)
    return float(np.float32(v))


class _HostExp(torch.autograd.Function):
    """exp of a 0-d tensor by ``math.exp``: the value a float field's
    ``_exp`` gives, bit for bit, with exp's derivative."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tensor(math.exp(float(x)), dtype=x.dtype, device=x.device)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return grad * y


def _exp(x):
    if not torch.is_tensor(x):
        return math.exp(x)
    return _HostExp.apply(x) if x.dim() == 0 else torch.exp(x)


def control_mean(payoff: PathPayoff, params: torch.Tensor):
    """E[X] of the payoff's own control variate, in f64 from the packed f32
    parameters (``(15,)``, or a book's ``(B, 15)`` rows)."""
    rows = params.double()
    return payoff.control_expectation(
        pk.unpack_params(rows.T if rows.dim() == 2 else rows))


def finish_price(sums: torch.Tensor, n_paths: int, option: OptionParams,
                 control_variate: bool = False,
                 control_expectation=None) -> PriceResult:
    """PriceResult from the finished f64 moment sums of one pricing run:
    ``[sum_pay, sum_pay2]``, or with the control variate
    ``[sum_pay, sum_pay2, sum_x, sum_x2, sum_pay_x]``; each sum a scalar,
    or a ``(B,)`` vector for a book whose option fields are ``(B,)``.
    ``control_expectation`` is E[X] of a payoff's own control; the default
    control is S_T, E[S_T] = S0 e^{(r-q)T}."""
    s0, r, t, q = (_f32(v, sums.device)
                   for v in (option.s0, option.r, option.t, option.q))
    discount = _exp(-r * t)
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
    ex = (s0 * _exp((r - q) * t) if control_expectation is None  # E[S_T]
          else control_expectation)
    adj_mean = mean_p - beta * (mean_x - ex)
    adj_var = torch.clamp(var_p - cov * cov / var_x, min=0.0)
    return PriceResult(
        price=discount * adj_mean,
        stderr=torch.sqrt(adj_var / n) * discount,
        n_paths=n,
        payoff_mean=adj_mean,
        payoff_var=adj_var,
    )


def _stream_key(sim: SimParams, stream: int, key):
    """The (k0, k1) stream key: ``key``, or ``derive_key(sim.seed, stream)``."""
    if key is None:
        key = rng.derive_key(sim.seed, stream)
    return int(key[0]), int(key[1])


class _SimulateSums(torch.autograd.Function):
    """The finished moment sums of ``simulate_partials`` as a function of
    the packed parameters, differentiable.

    Forward: the simulate kernel on a CUDA tensor, its plain version on a
    CPU one, as ``simulate_partials`` chooses; the forward value is always
    what that call computes.  Backward: ``simulate_partials_plain`` is
    recomputed on the same device under ``enable_grad`` and its
    vector-Jacobian product returned.  The plain version computes the
    kernel's f32 values per path (bitwise on the card, where the kernels
    are built without float contraction), so this is the gradient of the
    function the kernel computes, as ``mc_tpu`` differentiates its Pallas
    kernel through its bitwise-equal XLA dual; it is no fallback.  The
    sums, not the per-block rows, are the output: the kernel and the plain
    version cut the paths into different rows.
    """

    @staticmethod
    def forward(ctx, params, payoff, cfg, key, path_offset):
        ctx.save_for_backward(params)
        ctx.args = (payoff, cfg, key, path_offset)
        return finish_sum(pk.simulate_partials(payoff, cfg, key,
                                               params.detach(),
                                               path_offset=path_offset))

    @staticmethod
    def backward(ctx, grad_sums):
        (params,) = ctx.saved_tensors
        payoff, cfg, key, path_offset = ctx.args
        with torch.enable_grad():
            p = params.detach().requires_grad_()
            sums = finish_sum(pk.simulate_partials_plain(
                payoff, cfg, key, p, path_offset=path_offset))
            (grad_params,) = torch.autograd.grad(sums, p, grad_sums)
        return grad_params, None, None, None, None


def _price_impl(option: OptionParams, payoff: PathPayoff, sim: SimParams,
                method: str, antithetic: bool, control_variate: bool,
                rng_source: str, key, path_offset: int, n_paths: int,
                importance_shift: float, device: torch.device) -> PriceResult:
    params = pk.pack_params(option, sim.n_steps, device)
    if method == "terminal_pair":
        # both Box-Muller halves become paths: element e = paths (2e, 2e+1)
        cfgp = pk.KernelConfig(n_paths=(n_paths + 1) // 2, n_steps=sim.n_steps,
                               rng_source=rng_source, method="terminal")
        sums = finish_sum(pk.terminal_pair_partials(payoff, cfgp, key, params,
                                                    n_paths))
    else:
        cfg = pk.KernelConfig(n_paths=n_paths, n_steps=sim.n_steps,
                              antithetic=antithetic, with_cv=control_variate,
                              rng_source=rng_source, method=method,
                              is_shift=importance_shift)
        if params.requires_grad:
            sums = _SimulateSums.apply(params, payoff, cfg, key, path_offset)
        else:
            sums = finish_sum(pk.simulate_partials(payoff, cfg, key, params,
                                                   path_offset=path_offset))
    ex = (control_mean(payoff, params)
          if control_variate and payoff.has_control else None)
    return finish_price(sums, n_paths, option, control_variate, ex)


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

    Differentiable: an option field may be a 0-d tensor that requires grad,
    and ``torch.autograd.grad`` of the result then gives the pathwise
    derivative of the price (``_SimulateSums``); its value is bitwise the
    price from float fields.  The terminal_pair kernel has no
    differentiable counterpart (``method="terminal"`` draws the same
    distribution), nor does ``rng_source="hw"``.
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
        if any(torch.is_tensor(v) and v.requires_grad
               for v in option.astuple()):
            raise ValueError(
                "price() with a field that requires grad differentiates the "
                "simulate kernel; terminal_pair has no differentiable "
                "counterpart: pass method='terminal'")
        if antithetic or control_variate or importance_shift:
            raise ValueError("terminal_pair is the plain fast path: "
                             "antithetic/control_variate/importance_shift "
                             "route through method='terminal'")
        if path_offset:
            raise ValueError("terminal_pair does not take a path_offset "
                             "(element ids cover paths (2e, 2e+1))")
    po.validate(option, sim.n_steps)
    if importance_shift == "auto":
        # centre E[log S_T] at log K: shift = (log(K/S0) - mu T)/(sigma vT)
        mu = option.r - option.q - 0.5 * option.sigma ** 2
        importance_shift = ((math.log(option.k / option.s0) - mu * option.t)
                            / (option.sigma * math.sqrt(option.t)))
    pk.check_rng_source(rng_source)
    dev = resolve_device(device)
    return _price_impl(option, po, sim, method, antithetic, control_variate,
                       rng_source, _stream_key(sim, stream, key),
                       int(path_offset),
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
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps)
    s, st, partials = pk.simulate_trajectories(
        po, cfg, _stream_key(sim, stream, key),
        pk.pack_params(option, sim.n_steps, dev),
        path_offset=int(path_offset))
    pay_sum, pay_sq = finish_sum(partials)
    return Trajectories(s=s, state=st, pay_sum=pay_sum, pay_sq=pay_sq)


# ---------------------------------------------------------------------------
# Strike ladders and books: many payoffs on shared paths, one kernel each
# ---------------------------------------------------------------------------


def _batch_method(po: PathPayoff, method: Optional[str]) -> str:
    """The ladder's and the book's method: "terminal" for terminal-only
    payoffs (the classic per-path stream, not terminal_pair), else
    "euler"."""
    if method is None:
        method = "terminal" if po.terminal_only else "euler"
    if po.n_state > 0 and method == "terminal":
        raise ValueError(f"{po.name} is path-dependent; "
                         "method='terminal' invalid")
    return method


def price_ladder(strikes,
                 option: OptionParams = DEMO_OPTION,
                 sim: SimParams = DEMO_SIM,
                 payoff="vanilla_call",
                 *,
                 method: Optional[str] = None,
                 antithetic: bool = False,
                 stream: int = STREAM_OUTER,
                 key=None,
                 device="cuda") -> PriceResult:
    """Price a strike ladder on SHARED paths in one kernel.

    Returns a PriceResult whose fields are ``(n_strikes,)`` tensors.  Each
    path is simulated once and every strike evaluated on it (the strike
    enters a payoff only through ``terminal``), so strike m is
    ``price(option with k=strikes[m], method=...)`` on the same key: bitwise
    up to 2^21 paths on the card (the two kernels then share their blocks),
    to f64 rounding above.  The estimates across strikes are positively
    correlated, as calibration wants.
    """
    po = get_payoff(payoff)
    method = _batch_method(po, method)
    dev = resolve_device(device)
    if torch.is_tensor(strikes):
        strikes = strikes.detach().cpu()
    strikes = torch.as_tensor(np.asarray(strikes, np.float64)).to(
        torch.float32).reshape(-1).to(dev)
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          antithetic=antithetic, method=method)
    partials = pk.simulate_ladder_partials(
        po, cfg, _stream_key(sim, stream, key),
        pk.pack_params(option, sim.n_steps, dev), strikes)
    return finish_price(finish_sum(partials).T, sim.n_paths, option)


def price_portfolio(options: OptionParams,
                    sim: SimParams = DEMO_SIM,
                    payoff="vanilla_call",
                    *,
                    method: Optional[str] = None,
                    antithetic: bool = False,
                    control_variate: bool = False,
                    stream: int = STREAM_OUTER,
                    key=None,
                    device="cuda") -> PriceResult:
    """Price a book of B contracts in one kernel.

    ``options`` is an OptionParams whose fields are floats or ``(B,)``
    arrays or tensors (scalars broadcast to B): any mix of spots, strikes,
    vols, maturities and barriers.  Every contract runs on the same draws
    (common random numbers), so spreads and book-level Greeks are
    low-variance and contract b is its standalone ``price(...,
    method=...)`` on the same key: bitwise up to 2^21 paths and 216 steps on
    the card (the two kernels then share their blocks), to f64 rounding
    beyond.  Returns a PriceResult of ``(B,)``
    tensors; ``control_variate`` finishes each contract with its own CV.
    """
    po = get_payoff(payoff)
    method = _batch_method(po, method)
    dev = resolve_device(device)
    rows = pk.pack_params_rows(options, sim.n_steps, dev)
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          antithetic=antithetic, with_cv=control_variate,
                          method=method)
    partials = pk.simulate_book_partials(po, cfg, _stream_key(sim, stream, key),
                                         rows)
    ex = (control_mean(po, rows)
          if control_variate and po.has_control else None)
    return finish_price(finish_sum(partials).T, sim.n_paths,
                        pk.unpack_params(rows.T), control_variate, ex)
