"""Term-structure GBM (port of ``mc_tpu/models/term.py``): per-step
deterministic rate and volatility curves,

    d log S = (r_j - q - sigma_j^2/2) dt + sigma_j sqrt(dt) dW,   step j.

The terminal law is GBM at the averaged parameters r_bar = mean(r_j) and
sigma_bar = sqrt(mean(sigma_j^2)), so every European contract has Black-
Scholes at (r_bar, sigma_bar) as its exact oracle; path-dependent payoffs
see the real curve.  The option's flat ``r`` and ``sigma`` are ignored:
prices are discounted at e^{-r_bar T}, and payoffs that read r or sigma (the
Brownian-bridge barriers) see the averages.

The packed vector (``pack_term``, ``mc_tpu``'s ``_pack_term``) is an 11-float
head, then drift_dt[n] = (r_j - q - sigma_j^2/2)*dt, then vol_sdt[n] =
sigma_j*sqrt(dt):

    [s0, k, t, barrier, p1, p2, q, dt, inv_n_steps, r_bar, sigma_bar, ...]

One kernel lives in ``csrc/term_kernels.cu``:

* ``term_partials`` (replaces ``_term_partials``,
  ``mc_tpu/models/term.py:178``): the log-Euler loop over step pairs reading
  the step's two curve values, threefry-13, the antithetic twin in the same
  thread, [sum pay, sum pay^2] per block in f64.

Counters, as in ``mc_tpu``: steps 2m and 2m+1 of path ``id`` take the two
normals of pair ``(id, m)``.  The wrapper takes its plain PyTorch version
below only when the parameter tensor lies on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_OUTER, finish_price, resolve_device
from mc_tpu_torch.models.merton import pair_draws
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops import _cuda, twin
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PathPayoff, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["TermStructure", "DEMO_KNOTS", "demo_term", "DEMO_TERM",
           "TERM_TAG", "HEAD_FIELDS",
           "TermConfig", "fma_f32", "sqrt_f32", "mean_f32", "packed_length",
           "pack_term", "unpack_term", "term_step", "term_partials", "term_partials_plain", "qmc_pay",
           "price_term"]

# rng.derive_key stream tag of the term-structure family (mc_tpu's 0x7E53).
TERM_TAG = 0x7E53
# FamilyId of csrc/family.cuh.
FAMILY_TERM = 6

# The packed head: r and sigma are the averaged curves (what payoffs read).
HEAD_FIELDS = ("s0", "k", "t", "barrier", "p1", "p2", "q", "dt",
               "inv_n_steps", "r", "sigma")


@dataclasses.dataclass(frozen=True)
class TermStructure:
    """Per-step curves, numpy f32: ``rates[j]`` and ``sigmas[j]`` apply over
    simulation step j (length n_steps; spread coarse knots with
    ``from_knots``)."""

    rates: Any
    sigmas: Any

    @property
    def n_steps(self) -> int:
        return int(np.shape(self.rates)[0])

    def as_f32(self) -> "TermStructure":
        return TermStructure(rates=np.asarray(self.rates, np.float32),
                             sigmas=np.asarray(self.sigmas, np.float32))

    @staticmethod
    def from_knots(rate_knots, sigma_knots, n_steps: int) -> "TermStructure":
        """Spread K knot values over n_steps as equal piecewise segments."""
        def spread(vals):
            vals = np.asarray(vals, np.float32)
            idx = np.minimum((np.arange(n_steps) * len(vals)) // n_steps,
                             len(vals) - 1)
            return vals[idx]
        return TermStructure(rates=spread(rate_knots),
                             sigmas=spread(sigma_knots))


# The demo curves' knots (mc_tpu's DEMO_TERM and its NMC default): rates
# 10%, 7%, 5%; vols 15%, 22%, 30%.
DEMO_KNOTS = ([0.10, 0.07, 0.05], [0.15, 0.22, 0.30])


def demo_term(n_steps: int) -> TermStructure:
    """The demo curves spread over n_steps (DEMO_TERM at 100)."""
    return TermStructure.from_knots(*DEMO_KNOTS, n_steps)


DEMO_TERM = demo_term(100)


def fma_f32(a, b, c) -> torch.Tensor:
    """a*b + c rounded once to f32 (round half to even), as a 0-d f32
    tensor from f32 scalars: the fused multiply-add XLA's CPU backend
    contracts ``mc_tpu``'s jitted a*b + c into, computed exactly in
    rationals.  An operand that carries a derivative passes on that of
    the torch expression a*b + c."""
    args = (a, b, c)
    a, b, c = (np.float32(twin.primal(v)) for v in args)
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    near = (np.nextafter(r, np.float32(-np.inf)), r,
            np.nextafter(r, np.float32(np.inf)))
    best = min(near, key=lambda x: (abs(Fraction(float(x)) - exact),
                                    int(np.asarray(x).view(np.int32)) & 1))
    value = torch.tensor(best, dtype=torch.float32)
    if not any(map(twin.carries_derivative, args)):
        return value
    ta, tb, tc = map(twin.f32, args)
    return twin.with_derivative_of(value, ta * tb + tc)


def sqrt_f32(x) -> torch.Tensor:
    """The correctly rounded f32 square root of an f32 scalar, as a 0-d f32
    tensor (XLA's; PyTorch's CPU sqrt of a 0-d tensor misses it now and
    then), with torch.sqrt's derivative where ``x`` carries one."""
    value = torch.tensor(np.sqrt(np.float32(twin.primal(x))),
                         dtype=torch.float32)
    if not twin.carries_derivative(x):
        return value
    return twin.with_derivative_of(value, torch.sqrt(twin.f32(x)))


def mean_f32(x: torch.Tensor) -> torch.Tensor:
    """The f32 mean of a 1-D tensor in the order of ``mc_tpu``'s reduction
    (XLA on the CPU, ``jnp.mean``): up to 32 values add in order; a longer
    vector is padded with zeros, centred, to a multiple of 32, each window
    of 32 added in order and the window sums reduced the same way; the sum
    is multiplied by f32(1/n).  ``r_bar`` then equals ``mc_tpu``'s bit for
    bit."""
    def xla_sum(v):
        if v.shape[0] <= 32:
            acc = torch.zeros((), dtype=torch.float32)
            for e in v:
                acc = acc + e
            return acc
        m = -(-v.shape[0] // 32)
        pad = 32 * m - v.shape[0]
        w = torch.cat([torch.zeros(pad // 2), v,
                       torch.zeros(pad - pad // 2)]).reshape(m, 32)
        acc = torch.zeros(m, dtype=torch.float32)
        for k in range(32):
            acc = acc + w[:, k]
        return xla_sum(acc)

    return xla_sum(x) * (torch.tensor(1.0) / x.shape[0])


def packed_length(n_steps: int) -> int:
    """11 + 2*n_steps: the head, then the two curves."""
    return len(HEAD_FIELDS) + 2 * n_steps


_f32 = twin.f32  # a tensor keeps its derivative


def pack_term(option: OptionParams, term: TermStructure, n_steps: int,
              device) -> torch.Tensor:
    """The packed f32 vector on ``device``, each value computed in f32 in
    the order of ``mc_tpu``'s ``_pack_term``: r_bar bitwise (``mean_f32``),
    sigma_bar = sqrt(mean(sigma^2)) within 1 ulp of ``mc_tpu``'s (XLA's f32
    sqrt on the CPU rounds a near-halfway root the other way at times),
    every other entry bitwise."""
    s0, t, k, _, _, barrier, p1, p2, q = (_f32(v) for v in option.astuple())
    rs = torch.from_numpy(np.asarray(term.rates, np.float32).copy())
    sg = torch.from_numpy(np.asarray(term.sigmas, np.float32).copy())
    n = _f32(n_steps)
    dt = t / n
    head = torch.stack([s0, k, t, barrier, p1, p2, q, dt, 1.0 / n,
                        mean_f32(rs), torch.sqrt(mean_f32(sg * sg))])
    drift_dt = (rs - q - 0.5 * sg * sg) * dt
    vol_sdt = sg * torch.sqrt(dt)
    return torch.cat([head, drift_dt, vol_sdt]).to(device)


def unpack_term(params: torch.Tensor) -> SimpleNamespace:
    """The head fields by name (r, sigma the averages) and the curves
    ``drift_dt`` and ``vol_sdt`` (n_steps,) as views."""
    p = SimpleNamespace(**{f: params[i] for i, f in enumerate(HEAD_FIELDS)})
    h = len(HEAD_FIELDS)
    p.n_steps = (params.shape[0] - h) // 2
    p.drift_dt = params[h:h + p.n_steps]
    p.vol_sdt = params[h + p.n_steps:]
    return p


def term_step(payoff: PathPayoff, p, w, state, z, j: int):
    """One log-Euler step on the curves' entry j (``mc_tpu``'s one_step,
    ``csrc/term.cuh``): ``(w, s, state)`` with w = w + (drift_dt[j] +
    vol_sdt[j]*z), S = s0*exp(w)."""
    w = w + (p.drift_dt[j] + p.vol_sdt[j] * z)
    s = p.s0 * torch.exp(w)  # log-space: one exp rounding per S_t
    return w, s, payoff.update(state, s, p)


# ---------------------------------------------------------------------------
# Kernel configuration and checks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TermConfig:
    n_paths: int
    n_steps: int
    antithetic: bool = False

    def __post_init__(self):
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")
        if self.n_steps < 2 or self.n_steps % 2:
            raise ValueError("term requires an even n_steps (pair-consuming "
                             "step loop)")

    def path_config(self) -> pk.KernelConfig:
        """The path layout and stream of ``pk.path_chunks`` (threefry-13)."""
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=self.n_steps)


def check_term_params(params: torch.Tensor, n_steps: int) -> None:
    want = packed_length(n_steps)
    if (not torch.is_tensor(params) or params.dtype != torch.float32
            or params.shape != (want,) or not params.is_contiguous()
            or params.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params must be a contiguous float32 ({want},) tensor "
            f"(pack_term at n_steps={n_steps}) on the CPU or a CUDA device; "
            f"got {getattr(params, 'shape', None)} "
            f"{getattr(params, 'dtype', type(params))}")


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _pay(payoff: PathPayoff, cfg: TermConfig, p, like, draw_pair):
    """Each path's payoff (the antithetic pair's mean when
    ``cfg.antithetic``: the normals negated); ``draw_pair(m)`` gives the
    normals of steps 2m and 2m+1."""
    zero = torch.zeros_like(like)
    n_legs = 2 if cfg.antithetic else 1
    w, s = [zero] * n_legs, [zero + p.s0] * n_legs
    st = [payoff.init(p, zero)] * n_legs
    for j in range(cfg.n_steps):
        if j % 2 == 0:
            pair = draw_pair(j // 2)
        z = pair[j % 2]
        for leg in range(n_legs):
            w[leg], s[leg], st[leg] = term_step(payoff, p, w[leg], st[leg],
                                                -z if leg else z, j)
    pays = [payoff.terminal(st[leg], s[leg], p) for leg in range(n_legs)]
    return pays[0] if n_legs == 1 else 0.5 * (pays[0] + pays[1])


def qmc_pay(payoff: PathPayoff, p, n_steps: int, like, draw_pair):
    """The leg on a randomized-QMC draw: pair m, dimensions (2m, 2m+1),
    feeds steps 2m and 2m+1."""
    return _pay(payoff, TermConfig(n_paths=1, n_steps=n_steps), p, like,
                draw_pair)


def term_partials_plain(payoff: PathPayoff, cfg: TermConfig, key,
                        params: torch.Tensor, path_offset: int = 0,
                        n_valid=None):
    """Plain version of the term_partials kernel: (chunks, 2) f64
    [sum pay, sum pay^2] over paths ``path_offset + i``, those at or past
    the bound (default: the end of the run) adding zeros."""
    p = unpack_term(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, _ in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound,
            pk.plain_chunk(params)):
        pay = torch.where(valid, _pay(payoff, cfg, p, ids.float(), pair_draws(
            k0, k1, ids, cfg.n_steps // 2)), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# Wrapper: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def term_partials(payoff: PathPayoff, cfg: TermConfig, key,
                  params: torch.Tensor, path_offset: int = 0, n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` term-structure
    paths (global ids ``path_offset + i``, masked at ``n_valid``, default
    the end of the run); ``params`` from ``pack_term`` at ``cfg.n_steps``."""
    check_term_params(params, cfg.n_steps)
    if params.device.type == "cpu":
        return term_partials_plain(payoff, cfg, key, params, path_offset,
                                   n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(cfg.n_paths, lib.mc_term_block_threads()),
                   _cuda.MAX_BLOCKS)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_term_partials(
            payoff.cuda_id, int(cfg.antithetic), int(key[0]), int(key[1]),
            params.data_ptr(), cfg.n_steps, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound, partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "term_partials kernel")
    _cuda.count_launch("term_partials")
    return partials


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def validate_term(term: TermStructure, n_steps: int) -> TermStructure:
    """The entry points' checks (the curves' length, an even step count);
    returns ``term.as_f32()``."""
    t32 = term.as_f32()
    if t32.n_steps != n_steps or np.shape(t32.sigmas) != (n_steps,):
        raise ValueError(
            f"term structure has {t32.n_steps} steps, sim has {n_steps}; "
            f"build with TermStructure.from_knots(..., n_steps={n_steps})")
    if n_steps % 2:
        raise ValueError("term requires an even n_steps (pair-consuming "
                         "step loop)")
    return t32


def price_term(option: OptionParams = DEMO_OPTION,
               term: TermStructure = DEMO_TERM,
               sim: SimParams = DEMO_SIM,
               payoff="vanilla_call",
               *,
               antithetic: bool = False,
               stream: int = STREAM_OUTER,
               key=None,
               device="cuda") -> PriceResult:
    """Monte Carlo price under per-step rate and volatility CURVES on
    ``device``.  ``term`` has ``sim.n_steps`` entries (an even count); the
    option's flat r and sigma are ignored and the price is discounted at
    e^{-r_bar T}.  ``key``: a (k0, k1) pair; default ``rng.derive_key(
    sim.seed, stream, 0x7E53)``, the stream ``mc_tpu.price_term`` draws.
    Every payoff of the registry, validated first.  The moment sums finish
    in f64."""
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    t32 = validate_term(term, sim.n_steps)
    if key is None:
        key = rng.derive_key(sim.seed, stream, TERM_TAG)
    cfg = TermConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                     antithetic=antithetic)
    dev = resolve_device(device)
    params = pack_term(option, t32, sim.n_steps, dev)
    sums = finish_sum(term_partials(po, cfg, (int(key[0]), int(key[1])),
                                    params))
    # the curve discount exp(-sum r_j dt) = exp(-r_bar T)
    r_bar = float(params[HEAD_FIELDS.index("r")])
    return finish_price(sums, sim.n_paths,
                        dataclasses.replace(option, r=r_bar))
