"""Local volatility on a knot grid (port of ``mc_tpu/models/localvol.py``).

    d log S = (r - q - sigma(x, t_j)^2 / 2) dt + sigma(x, t_j) sqrt(dt) dW,

x = log(S/S0), sigma piecewise linear in x over K knots per step j and flat
beyond the ends.  Such a function is a sum of clamped ramps,

    sigma(x) = v_0 + sum_k m_k * clamp(x - x_k, 0, x_{k+1} - x_k),

so the lookup is K-1 multiply-adds and clamps, no search (``sigma_at``),
accumulated from v_0 over k ascending and floored at 1e-4, as in ``mc_tpu``.
A flat surface is exact log-Euler GBM; a surface sigma0 (S/S0)^(beta-1)
reproduces the CEV closed form (the cross-model gate).

The packed vector (``pack_localvol``, bitwise ``mc_tpu``'s ``_pack_localvol``)
has a variable length, 11 + 2K - 1 + n_steps*K floats:

    [s0, k, t, barrier, p1, p2, q, dt, inv_n_steps, r, sigma_ref,
     x_knots(K), dx(K-1), v0(n_steps), slopes(n_steps*(K-1))]

the head laid out as ``mc_tpu``'s term-structure head (sigma_ref, the
time-rms of the at-the-money vol, is what payoffs that read sigma see: the
Brownian-bridge barriers).  The kernels take it by pointer and K as a
runtime integer.

Two kernels, in ``csrc/localvol_kernels.cu`` and
``csrc/localvol_nmc_kernels.cu``:

* ``localvol_partials`` (replaces ``_localvol_partials``,
  ``mc_tpu/models/localvol.py:264``): the log-Euler loop over step pairs,
  threefry-13 or -20, the antithetic twin in the same thread, [sum pay,
  sum pay^2] per block in f64.
* ``localvol_trajectories`` (replaces ``localvol_trajectories_kernel``,
  ``mc_tpu/models/localvol.py:406``): the loop on threefry-13 storing S and
  payoff state word 0 after every step, step-major ``(n_steps, n_paths)``,
  plus the payoff's moment rows; the local-vol instantiation of the family
  engine's trajectories kernel.

Counters, as in ``mc_tpu``: steps 2m and 2m+1 of path ``id`` take the two
normals of pair ``(id, m)``.  The terminal payoff reads the spot the last
step stored (S = s0*exp(w), carried).  Each wrapper takes its plain PyTorch
version below only when the parameter tensor lies on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
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

__all__ = ["LocalVolSurface", "DEMO_LOCALVOL", "LOCALVOL_TAG", "HEAD_FIELDS",
           "LocalVolConfig", "validate_surface", "packed_length",
           "pack_localvol", "unpack_localvol", "sigma_at", "localvol_step",
           "localvol_partials", "localvol_partials_plain", "qmc_pay",
           "localvol_trajectories", "localvol_trajectories_plain",
           "price_localvol"]

# rng.derive_key stream tag of the local-vol family (mc_tpu's 0x10CA).
LOCALVOL_TAG = 0x10CA
# FamilyId of csrc/family.cuh.
FAMILY_LOCALVOL = 4

# The packed head (mc_tpu's term-structure head): r and sigma are the flat
# fields a payoff may read, sigma = sigma_ref.
HEAD_FIELDS = ("s0", "k", "t", "barrier", "p1", "p2", "q", "dt",
               "inv_n_steps", "r", "sigma")
SIGMA_FLOOR = 1e-4


@dataclasses.dataclass(frozen=True)
class LocalVolSurface:
    """sigma(log-moneyness, step) on a (n_steps, K) knot grid: ``x_knots``
    (K,) ascending, ``vols`` (n_steps, K) positive, both numpy f32."""

    x_knots: Any
    vols: Any

    @property
    def n_steps(self) -> int:
        return int(np.shape(self.vols)[0])

    @property
    def n_knots(self) -> int:
        return int(np.shape(self.x_knots)[0])

    def as_f32(self) -> "LocalVolSurface":
        return LocalVolSurface(x_knots=np.asarray(self.x_knots, np.float32),
                               vols=np.asarray(self.vols, np.float32))

    @staticmethod
    def from_function(fn, n_steps: int, x_lo=-1.0, x_hi=1.0,
                      n_knots: int = 9) -> "LocalVolSurface":
        """Sample ``fn(x, t_frac) -> sigma`` on the knot grid, t_frac =
        (j + 1) / n_steps, the step's end."""
        xs = np.linspace(x_lo, x_hi, n_knots).astype(np.float32)
        vols = np.stack([
            np.asarray([fn(float(x), (j + 1.0) / n_steps) for x in xs],
                       np.float32)
            for j in range(n_steps)])
        return LocalVolSurface(x_knots=xs, vols=vols)

    @staticmethod
    def flat(sigma: float, n_steps: int, n_knots: int = 9):
        return LocalVolSurface.from_function(lambda x, t: sigma, n_steps,
                                             n_knots=n_knots)

    @staticmethod
    def demo(n_steps: int = 100) -> "LocalVolSurface":
        """The demo surface, a mild smile deepening with time, at any step
        count (``mc_tpu``'s one definition)."""
        return LocalVolSurface.from_function(
            lambda x, t: 0.2 + 0.1 * x * x + 0.05 * t, n_steps)


DEMO_LOCALVOL = LocalVolSurface.demo(100)


def validate_surface(surf: LocalVolSurface, n_steps: int) -> LocalVolSurface:
    """The entry points' checks (step count, at least 2 knots, strictly
    ascending knots: dx <= 0 would give infinite slopes and NaN prices);
    returns ``surf.as_f32()``."""
    s32 = surf.as_f32()
    if s32.n_steps != n_steps:
        raise ValueError(
            f"surface has {s32.n_steps} steps, sim has {n_steps}; build with "
            f"LocalVolSurface.from_function(..., n_steps={n_steps})")
    if s32.n_knots < 2:
        raise ValueError("need at least 2 knots")
    if s32.x_knots.ndim != 1 or s32.vols.shape != (n_steps, s32.n_knots):
        raise ValueError(f"vols must be (n_steps, K) = ({n_steps}, "
                         f"{s32.n_knots}); got {s32.vols.shape}")
    xs = np.asarray(surf.x_knots, np.float64)
    if not np.all(np.diff(xs) > 0.0):
        raise ValueError(f"x_knots must be strictly ascending, got "
                         f"{xs.tolist()}")
    return s32


def packed_length(n_knots: int, n_steps: int) -> int:
    """11 + 2K - 1 + n_steps*K: the head, the knots, their spacings, and per
    step the left value and K-1 slopes."""
    return len(HEAD_FIELDS) + 2 * n_knots - 1 + n_steps * n_knots


_f32 = twin.f32  # a tensor keeps its derivative


def pack_localvol(option: OptionParams, surf: LocalVolSurface, n_steps: int,
                  device) -> torch.Tensor:
    """The packed f32 vector on ``device``, each derived value computed in
    f32 in the order of ``mc_tpu``'s ``_pack_localvol`` (so the two are
    bitwise equal).  The one reduction, sigma_ref's mean over the steps,
    adds in step order."""
    s0, t, k, r, _, barrier, p1, p2, q = (_f32(v) for v in option.astuple())
    xs = torch.from_numpy(np.asarray(surf.x_knots, np.float32).copy())
    vols = torch.from_numpy(np.asarray(surf.vols, np.float32).copy())
    n = _f32(n_steps)
    dt = t / n
    dx = xs[1:] - xs[:-1]
    slopes = (vols[:, 1:] - vols[:, :-1]) / dx[None, :]
    # sigma_ref: the time-rms of the surface at x = 0 (the true at-the-money
    # vol on an asymmetric grid).  Each step's ramps add in knot order, as
    # XLA's row sum does; XLA's sum over the steps follows its own blocking,
    # which torch.sum does not reproduce: sigma_ref is within 2 ulp of
    # mc_tpu's, every other entry bitwise.
    ramps = slopes * torch.minimum(torch.clamp(0.0 - xs[:-1], min=0.0), dx)
    ramp_sum = ramps[:, 0]
    for kk in range(1, ramps.shape[1]):
        ramp_sum = ramp_sum + ramps[:, kk]
    atm = vols[:, 0] + ramp_sum
    sigma_ref = torch.sqrt(torch.sum(atm * atm) / n)
    head = torch.stack([s0, k, t, barrier, p1, p2, q, dt, 1.0 / n, r,
                        sigma_ref])
    return torch.cat([head, xs, dx, vols[:, 0],
                      slopes.reshape(-1)]).to(device)


def unpack_localvol(params: torch.Tensor, n_knots: int) -> SimpleNamespace:
    """The head fields by name, the surface tables (``x``, ``dx``, ``v0``
    (n_steps,), ``slopes`` (n_steps, K-1)) as views, and the step's
    constants ``base_drift`` = (r-q)*dt and ``sdt`` = sqrt(dt)."""
    p = SimpleNamespace(**{f: params[i] for i, f in enumerate(HEAD_FIELDS)})
    h, k = len(HEAD_FIELDS), n_knots
    n_steps = (params.shape[0] - h - 2 * k + 1) // k
    p.n_knots, p.n_steps = k, n_steps
    p.x = params[h:h + k]
    p.dx = params[h + k:h + 2 * k - 1]
    p.v0 = params[h + 2 * k - 1:h + 2 * k - 1 + n_steps]
    p.slopes = params[h + 2 * k - 1 + n_steps:].reshape(n_steps, k - 1)
    p.base_drift = (p.r - p.q) * p.dt
    p.sdt = torch.sqrt(p.dt)
    return p


def sigma_at(p, w, j: int):
    """sigma(w, step j) from the packed tables: v0[j] plus the K-1 clamped
    ramps m_k * min(max(w - x_k, 0), dx_k), added in k order, floored at
    1e-4 (``mc_tpu``'s ``_make_sigma_at``, ``csrc/localvol.cuh``)."""
    km1 = p.n_knots - 1
    lead = (km1,) + (1,) * w.dim()  # the knot axis first: contiguous ramps
    ramps = p.slopes[j].reshape(lead) * torch.minimum(
        torch.clamp(w - p.x[:km1].reshape(lead), min=0.0),
        p.dx.reshape(lead))
    s = p.v0[j] + ramps[0]
    for kk in range(1, km1):
        s = s + ramps[kk]
    return torch.clamp(s, min=SIGMA_FLOOR)


def localvol_step(payoff: PathPayoff, p, w, state, z, j: int):
    """One log-Euler step on surface row j: ``(w, s, state)`` with
    w = (w + (base_drift - 0.5*sg*sg*dt)) + (sg*sdt)*z, S = s0*exp(w)."""
    sg = sigma_at(p, w, j)
    w = w + (p.base_drift - 0.5 * sg * sg * p.dt) + sg * p.sdt * z
    s = p.s0 * torch.exp(w)  # log-space: one exp rounding per S_t
    return w, s, payoff.update(state, s, p)


# ---------------------------------------------------------------------------
# Kernel configuration and checks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LocalVolConfig:
    n_paths: int
    n_steps: int
    n_knots: int
    antithetic: bool = False
    rng_source: str = "threefry13"  # "threefry13" | "threefry" (20 rounds)

    def __post_init__(self):
        pk.check_rng_source(self.rng_source)
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")
        if self.n_steps < 2 or self.n_steps % 2:
            raise ValueError("localvol requires an even n_steps "
                             "(pair-consuming step loop)")
        if self.n_knots < 2:
            raise ValueError("need at least 2 knots")

    @property
    def rng_rounds(self) -> int:
        return 13 if self.rng_source == "threefry13" else 20

    def path_config(self) -> pk.KernelConfig:
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=self.n_steps,
                               rng_source=self.rng_source)


def check_localvol_params(params: torch.Tensor, n_knots: int,
                          n_steps: int) -> None:
    want = packed_length(n_knots, n_steps)
    if (not torch.is_tensor(params) or params.dtype != torch.float32
            or params.shape != (want,) or not params.is_contiguous()
            or params.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params must be a contiguous float32 ({want},) tensor "
            f"(pack_localvol at K={n_knots}, n_steps={n_steps}) on the CPU "
            f"or a CUDA device; got {getattr(params, 'shape', None)} "
            f"{getattr(params, 'dtype', type(params))}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _pay(payoff: PathPayoff, cfg: LocalVolConfig, p, like, draw_pair):
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
            w[leg], s[leg], st[leg] = localvol_step(payoff, p, w[leg], st[leg],
                                                    -z if leg else z, j)
    pays = [payoff.terminal(st[leg], s[leg], p) for leg in range(n_legs)]
    return pays[0] if n_legs == 1 else 0.5 * (pays[0] + pays[1])


def qmc_pay(payoff: PathPayoff, p, n_steps: int, like, draw_pair):
    """The leg on a randomized-QMC draw: pair m, dimensions (2m, 2m+1),
    feeds steps 2m and 2m+1."""
    cfg = LocalVolConfig(n_paths=1, n_steps=n_steps, n_knots=p.n_knots)
    return _pay(payoff, cfg, p, like, draw_pair)


def localvol_partials_plain(payoff: PathPayoff, cfg: LocalVolConfig, key,
                            params: torch.Tensor, path_offset: int = 0,
                            n_valid=None):
    """Plain version of the localvol_partials kernel: (chunks, 2) f64
    [sum pay, sum pay^2] over paths ``path_offset + i``, those at or past
    the bound (default: the end of the run) adding zeros."""
    p = unpack_localvol(params, cfg.n_knots)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, _ in pk.path_chunks(cfg.path_config(), key, params,
                                              path_offset, bound,
                                              pk.plain_chunk(params)):
        pay = torch.where(valid, _pay(payoff, cfg, p, ids.float(), pair_draws(
            k0, k1, ids, cfg.n_steps // 2, cfg.rng_rounds)), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


def localvol_trajectories_plain(payoff: PathPayoff, cfg: LocalVolConfig, key,
                                params: torch.Tensor, path_offset: int = 0,
                                n_valid=None):
    """Plain version of the localvol_trajectories kernel: ``(s_grid,
    state_grid, partials)``, the grids ``(n_steps, n_paths)`` f32 after step
    j+1 (state word 0, zeros for a payoff without state), the partials
    (chunks, 2) f64 [sum pay, sum pay^2]."""
    p = unpack_localvol(params, cfg.n_knots)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    shape = (cfg.n_steps, cfg.n_paths)
    s_grid = torch.empty(shape, dtype=torch.float32, device=params.device)
    st_grid = torch.zeros_like(s_grid)
    rows = []
    for start, stop, ids, valid, _ in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound,
            pk.plain_chunk(params)):
        zero = torch.zeros_like(ids, dtype=torch.float32)
        w, s, state = zero, zero + p.s0, payoff.init(p, zero)
        draw_pair = pair_draws(k0, k1, ids, cfg.n_steps // 2)
        for j in range(cfg.n_steps):
            z = draw_pair(j // 2)[j % 2]
            w, s, state = localvol_step(payoff, p, w, state, z, j)
            s_grid[j, start:stop] = s
            if payoff.n_state:
                st_grid[j, start:stop] = state[0]
        pay = torch.where(valid, payoff.terminal(state, s, p), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return s_grid, st_grid, torch.stack(rows)


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def localvol_partials(payoff: PathPayoff, cfg: LocalVolConfig, key,
                      params: torch.Tensor, path_offset: int = 0,
                      n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` local-vol paths
    (global ids ``path_offset + i``, masked at ``n_valid``, default the end
    of the run); ``params`` from ``pack_localvol`` at ``cfg.n_knots``."""
    check_localvol_params(params, cfg.n_knots, cfg.n_steps)
    if params.device.type == "cpu":
        return localvol_partials_plain(payoff, cfg, key, params, path_offset,
                                       n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(cfg.n_paths, lib.mc_localvol_block_paths()),
                   _cuda.MAX_BLOCKS)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_localvol_partials(
            payoff.cuda_id, cfg.rng_rounds, int(cfg.antithetic), int(key[0]),
            int(key[1]), params.data_ptr(), cfg.n_knots, cfg.n_steps,
            cfg.n_paths, path_offset & 0xFFFFFFFF, bound, partials.data_ptr(),
            n_blocks, _cuda.stream_handle(params.device))
    _cuda.check(status, "localvol_partials kernel")
    _cuda.count_launch("localvol_partials")
    return partials


def localvol_trajectories(payoff: PathPayoff, cfg: LocalVolConfig, key,
                          params: torch.Tensor, path_offset: int = 0,
                          n_valid=None):
    """Materialize the (S, state) grids: ``(s_grid, state_grid,
    partials)``, the grids ``(n_steps, n_paths)`` f32 step-major (entry
    [j, i] after step j+1 of path i), the partials ``(rows, 2)`` f64.  The
    loop on threefry-13 only, without an antithetic twin, as in ``mc_tpu``."""
    check_localvol_params(params, cfg.n_knots, cfg.n_steps)
    if payoff.n_state > 1:
        raise ValueError("the trajectories kernel stores one state array")
    if cfg.antithetic or cfg.rng_source != "threefry13":
        raise ValueError("localvol_trajectories runs the loop on threefry-13 "
                         "without an antithetic twin")
    if params.device.type == "cpu":
        return localvol_trajectories_plain(payoff, cfg, key, params,
                                           path_offset, n_valid)
    from mc_tpu_torch.nmc_engine import launch_family_trajectories

    *grids, st, partials = launch_family_trajectories(
        FAMILY_LOCALVOL, 1, (cfg.n_knots,), payoff, cfg.n_paths, cfg.n_steps,
        key, params, path_offset, n_valid)
    _cuda.count_launch("localvol_trajectories")
    return grids[0], st, partials


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def price_localvol(option: OptionParams = DEMO_OPTION,
                   surf: LocalVolSurface = DEMO_LOCALVOL,
                   sim: SimParams = DEMO_SIM,
                   payoff="vanilla_call",
                   *,
                   antithetic: bool = False,
                   stream: int = STREAM_OUTER,
                   key=None,
                   rng_source: str = "threefry13",
                   device="cuda") -> PriceResult:
    """Monte Carlo price under a local-volatility surface on ``device``.

    ``surf.vols`` has ``sim.n_steps`` rows (``LocalVolSurface.
    from_function``); every payoff of the registry prices.  Log-Euler, weak
    order 1 in dt (exact in law only for an S-independent surface).
    ``key``: a (k0, k1) pair; default ``rng.derive_key(sim.seed, stream,
    0x10CA)``, the stream ``mc_tpu.price_localvol`` draws.  The moment sums
    finish in f64 with e^{-rT}.
    """
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    s32 = validate_surface(surf, sim.n_steps)
    if sim.n_steps % 2:
        raise ValueError("localvol requires an even n_steps "
                         "(pair-consuming step loop)")
    if key is None:
        key = rng.derive_key(sim.seed, stream, LOCALVOL_TAG)
    cfg = LocalVolConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                         n_knots=s32.n_knots, antithetic=antithetic,
                         rng_source=rng_source)
    dev = resolve_device(device)
    params = pack_localvol(option, s32, sim.n_steps, dev)
    sums = finish_sum(localvol_partials(po, cfg, (int(key[0]), int(key[1])),
                                        params))
    return finish_price(sums, sim.n_paths, option)
