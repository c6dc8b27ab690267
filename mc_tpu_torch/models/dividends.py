"""GBM with discrete CASH dividends (port of ``mc_tpu/models/dividends.py``).

At dividend step j the spot drops by the payment right after the step's
move, ``S -> max(S - D_j, 1e-6)`` (the floor absorbs a payment larger than
the spot).  Between payments the step is the exact-in-law GBM factor, kept
in LEVEL space (the cash drop breaks log-space accumulation):

    S = S * exp(drift_dt + vol_dt*z);  S = max(S - D_j, 1e-6).

The oracles are host f64 Gauss-Hermite quadratures: ``bs_call_cash_div``
(one dividend, exact for the scheme) and ``cash_div_forward`` (the forward
under any schedule, for put-call parity).

The packed vector (``pack_divs``, bitwise ``mc_tpu``'s ``_pack_divs``) is a
13-float head, then the n per-step amounts:

    [s0, k, r, barrier, p1, p2, t, q, sigma, dt, inv_n_steps, drift_dt,
     vol_dt, D_0, ..., D_{n-1}]

One kernel lives in ``csrc/divs_kernels.cu``:

* ``divs_partials`` (replaces ``_divs_partials``,
  ``mc_tpu/models/dividends.py:146``): the level-space loop over step pairs,
  threefry-13, the antithetic twin in the same thread, [sum pay, sum pay^2]
  per block in f64.

Counters, as in ``mc_tpu``: steps 2m and 2m+1 of path ``id`` take the two
normals of pair ``(id, m)``.  Every payoff of the registry sees the
post-dividend path.  The wrapper takes its plain PyTorch version below only
when the parameter tensor lies on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_OUTER, finish_price, resolve_device
from mc_tpu_torch.models.merton import counters, steps_index
from mc_tpu_torch.oracle import PriceResult, bs_call
from mc_tpu_torch.ops import _cuda, twin
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PathPayoff, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["DIVS_TAG", "DIV_FLOOR", "HEAD_FIELDS", "DivsConfig",
           "div_schedule", "packed_length", "pack_divs", "unpack_divs",
           "divs_step", "divs_partials", "divs_partials_plain", "price_divs",
           "bs_call_cash_div", "cash_div_forward"]

# rng.derive_key stream tag of the cash-dividend family (mc_tpu's 0xD1F).
DIVS_TAG = 0xD1F
DIV_FLOOR = 1e-6  # the absorbing floor after a payment exceeding the spot

HEAD_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "q", "sigma",
               "dt", "inv_n_steps", "drift_dt", "vol_dt")


def div_schedule(n_steps: int, steps: Sequence[int],
                 amounts: Sequence[float]) -> np.ndarray:
    """(n_steps,) f32 per-step cash amounts from (step index, amount)
    pairs; step j's payment lands right AFTER the j-th step's move (time
    (j+1)/n * T)."""
    divs = np.zeros(n_steps, np.float32)
    for j, a in zip(steps, amounts):
        if not 0 <= int(j) < n_steps:
            raise ValueError(f"dividend step {j} outside [0, {n_steps})")
        if a < 0:
            raise ValueError(f"negative dividend {a}")
        divs[int(j)] += np.float32(a)
    return divs


def packed_length(n_steps: int) -> int:
    """13 + n_steps: the head, then the amounts."""
    return len(HEAD_FIELDS) + n_steps


_f32 = twin.f32  # a tensor keeps its derivative


def pack_divs(option: OptionParams, divs, n_steps: int,
              device) -> torch.Tensor:
    """The packed f32 vector on ``device``, each derived head field computed
    in f32 in the order of ``mc_tpu``'s ``_pack_divs`` (so the two are
    bitwise equal), then the amounts."""
    s0, t, k, r, sigma, barrier, p1, p2, q = (_f32(v)
                                              for v in option.astuple())
    n = _f32(n_steps)
    dt = t / n
    head = torch.stack([s0, k, r, barrier, p1, p2, t, q, sigma, dt, 1.0 / n,
                        (r - q - 0.5 * sigma * sigma) * dt,
                        sigma * torch.sqrt(dt)])
    amounts = torch.from_numpy(np.asarray(divs, np.float32).copy())
    return torch.cat([head, amounts]).to(device)


def unpack_divs(params: torch.Tensor) -> SimpleNamespace:
    """The head fields by name and the amounts ``d`` (n_steps,) as a
    view."""
    p = SimpleNamespace(**{f: params[i] for i, f in enumerate(HEAD_FIELDS)})
    p.d = params[len(HEAD_FIELDS):]
    return p


def divs_step(payoff: PathPayoff, p, s, state, z, j: int):
    """One level-space step (``mc_tpu``'s one_step, ``csrc/divs.cuh``): the
    GBM factor, then the cash drop floored at 1e-6: ``(s, state)``."""
    s = s * torch.exp(p.drift_dt + p.vol_dt * z)
    s = torch.clamp(s - p.d[j], min=DIV_FLOOR)
    return s, payoff.update(state, s, p)


# ---------------------------------------------------------------------------
# Kernel configuration and checks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DivsConfig:
    n_paths: int
    n_steps: int
    antithetic: bool = False

    def __post_init__(self):
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")
        if self.n_steps < 2 or self.n_steps % 2:
            raise ValueError("dividends require an even n_steps "
                             "(pair-consuming step loop)")

    def path_config(self) -> pk.KernelConfig:
        """The path layout and stream of ``pk.path_chunks`` (threefry-13)."""
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=self.n_steps)


def check_divs_params(params: torch.Tensor, n_steps: int) -> None:
    want = packed_length(n_steps)
    if (not torch.is_tensor(params) or params.dtype != torch.float32
            or params.shape != (want,) or not params.is_contiguous()
            or params.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params must be a contiguous float32 ({want},) tensor "
            f"(pack_divs at n_steps={n_steps}) on the CPU or a CUDA device; "
            f"got {getattr(params, 'shape', None)} "
            f"{getattr(params, 'dtype', type(params))}")


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _pay(payoff: PathPayoff, cfg: DivsConfig, p, like, k0, k1, ids):
    """Each path's payoff (the antithetic pair's mean when
    ``cfg.antithetic``: the normals negated)."""
    zero = torch.zeros_like(like)
    n_legs = 2 if cfg.antithetic else 1
    s, st = [zero + p.s0] * n_legs, [payoff.init(p, zero)] * n_legs
    # Every pair's normals at once: z0[m], z1[m] for steps 2m, 2m+1.
    z0, z1 = rng.normal_pair(k0, k1, ids,
                             counters(ids, steps_index(cfg.n_steps // 2, ids)))
    for j in range(cfg.n_steps):
        z = (z0 if j % 2 == 0 else z1)[j // 2]
        for leg in range(n_legs):
            s[leg], st[leg] = divs_step(payoff, p, s[leg], st[leg],
                                        -z if leg else z, j)
    pays = [payoff.terminal(st[leg], s[leg], p) for leg in range(n_legs)]
    return pays[0] if n_legs == 1 else 0.5 * (pays[0] + pays[1])


def divs_partials_plain(payoff: PathPayoff, cfg: DivsConfig, key,
                        params: torch.Tensor, path_offset: int = 0,
                        n_valid=None):
    """Plain version of the divs_partials kernel: (chunks, 2) f64
    [sum pay, sum pay^2] over paths ``path_offset + i``, those at or past
    the bound (default: the end of the run) adding zeros."""
    p = unpack_divs(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, _ in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound,
            pk.plain_chunk(params)):
        pay = torch.where(valid, _pay(payoff, cfg, p, ids.float(), k0, k1,
                                      ids), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# Wrapper: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def divs_partials(payoff: PathPayoff, cfg: DivsConfig, key,
                  params: torch.Tensor, path_offset: int = 0, n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` cash-dividend
    paths (global ids ``path_offset + i``, masked at ``n_valid``, default
    the end of the run); ``params`` from ``pack_divs`` at ``cfg.n_steps``."""
    check_divs_params(params, cfg.n_steps)
    if params.device.type == "cpu":
        return divs_partials_plain(payoff, cfg, key, params, path_offset,
                                   n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(cfg.n_paths, lib.mc_divs_block_paths()),
                   _cuda.MAX_BLOCKS)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_divs_partials(
            payoff.cuda_id, int(cfg.antithetic), int(key[0]), int(key[1]),
            params.data_ptr(), cfg.n_steps, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound, partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "divs_partials kernel")
    _cuda.count_launch("divs_partials")
    return partials


# ---------------------------------------------------------------------------
# Entry point and oracles
# ---------------------------------------------------------------------------


def price_divs(option: OptionParams = DEMO_OPTION,
               divs=None,
               sim: SimParams = DEMO_SIM,
               payoff="vanilla_call",
               *,
               antithetic: bool = False,
               stream: int = STREAM_OUTER,
               key=None,
               device="cuda") -> PriceResult:
    """Monte Carlo price under GBM with discrete CASH dividends on
    ``device``.  ``divs``: (n_steps,) per-step amounts (``div_schedule``;
    default none, plain GBM), an even ``n_steps``.  ``key``: a (k0, k1)
    pair; default ``rng.derive_key(sim.seed, stream, 0xD1F)``, the stream
    ``mc_tpu.price_divs`` draws.  Every payoff of the registry, validated
    first.  The moment sums finish in f64 with e^{-rT}."""
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    if sim.n_steps % 2:
        raise ValueError("dividends require an even n_steps "
                         "(pair-consuming step loop)")
    divs = (np.zeros(sim.n_steps, np.float32) if divs is None
            else np.asarray(divs, np.float32))
    if divs.shape != (sim.n_steps,):
        raise ValueError(f"divs must be shaped (n_steps,) = "
                         f"({sim.n_steps},), got {divs.shape}")
    if key is None:
        key = rng.derive_key(sim.seed, stream, DIVS_TAG)
    cfg = DivsConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                     antithetic=antithetic)
    dev = resolve_device(device)
    params = pack_divs(option, divs, sim.n_steps, dev)
    sums = finish_sum(divs_partials(po, cfg, (int(key[0]), int(key[1])),
                                    params))
    return finish_price(sums, sim.n_paths, option)


def bs_call_cash_div(s0, k, t, r, sigma, d_amount, tau, q=0.0,
                     n_quad: int = 120, floor: float = DIV_FLOOR) -> float:
    """European call with ONE cash dividend ``d_amount`` at time ``tau``:
    Gauss-Hermite integration of the post-dividend Black-Scholes value over
    the lognormal pre-dividend spot (exact for the scheme's max(S - D,
    floor) drop when tau sits on a step boundary)."""
    s0, k, t, r, sigma, d_amount, tau, q = map(
        float, (s0, k, t, r, sigma, d_amount, tau, q))
    if not 0.0 < tau < t:
        raise ValueError(f"need 0 < tau < t, got tau={tau}, t={t}")
    x, w = np.polynomial.hermite.hermgauss(n_quad)
    s_pre = s0 * np.exp((r - q - 0.5 * sigma * sigma) * tau
                        + sigma * np.sqrt(2.0 * tau) * x)
    s_post = np.maximum(s_pre - d_amount, floor)
    inner = np.array([bs_call(sp, k, t - tau, r, sigma, q) for sp in s_post])
    return float(np.exp(-r * tau) * np.sum(w * inner) / np.sqrt(np.pi))


def cash_div_forward(s0, t, r, sigma, divs, n_steps, q=0.0,
                     n_quad: int = 120, floor: float = DIV_FLOOR) -> float:
    """E[S_T] under the discrete-dividend scheme (host f64, Gauss-Hermite
    over each payment date): the forward of the put-call-parity gate for any
    schedule.  Where the floor never binds it is the classical S0 e^{(r-q)T}
    - sum_i D_i e^{(r-q)(T - tau_i)}."""
    s0, t, r, sigma, q = map(float, (s0, t, r, sigma, q))
    divs = np.asarray(divs, np.float64)
    mu = r - q
    fwd, t_prev = s0, 0.0
    x, w = np.polynomial.hermite.hermgauss(n_quad)
    for j in np.nonzero(divs)[0]:
        tau = (int(j) + 1) / n_steps * t
        # the forward to tau, then E[max(. - D, floor)] over the lognormal
        # factor around it
        fwd = fwd * np.exp(mu * (tau - t_prev))
        sig2 = sigma * sigma * tau
        s_pre = fwd * np.exp(-0.5 * sig2 + sigma * np.sqrt(2.0 * tau) * x)
        fwd = float(np.sum(w * np.maximum(s_pre - float(divs[j]), floor))
                    / np.sqrt(np.pi))
        t_prev = tau
    return float(fwd * np.exp(mu * (t - t_prev)))
