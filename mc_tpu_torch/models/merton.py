"""Merton jump-diffusion family (port of ``mc_tpu/models/merton.py``).

    dS/S = (r - q - lam*kappa) dt + sigma dW + (e^Y - 1) dN,
    N ~ Poisson(lam),  Y ~ N(mu_j, sigma_j^2),  kappa = E[e^Y] - 1.

The per-step log increment is exact in law: given the step's count N, the
sum of its N jumps is N(N mu_j, N sigma_j^2), so one extra normal e stands
for the whole jump sum:

    dlog S = (r - q - lam*kappa - sigma^2/2) dt + sigma sqrt(dt) z
             + N mu_j + sigma_j sqrt(N) e,      N ~ Poisson(lam dt),

N drawn by a branch-free inverse-CDF scan of depth ``kmax``, chosen on the
host so the clipped tail is below 1e-12 (``poisson_kmax``).  Every payoff of
the registry reads only (state, S, params), and Merton packs every field of
the GBM parameters, so all 18 price under it.

Two kernels, in ``csrc/merton_kernels.cu`` and ``csrc/merton_nmc_kernels.cu``:

* ``merton_partials`` (replaces ``_merton_partials``,
  ``mc_tpu/models/merton.py:278``): the exact terminal draw or the Euler
  loop over step pairs, threefry-13 or -20, the antithetic twin in the same
  thread, [sum pay, sum pay^2] per block in f64.
* ``merton_trajectories`` (replaces ``merton_trajectories_kernel``,
  ``mc_tpu/models/merton.py:392``): the Euler loop on threefry-13 that
  stores S and payoff state word 0 after every step, step-major
  ``(n_steps, n_paths)``, plus the payoff's moment rows; the Merton
  instantiation of the family engine's trajectories kernel.

Counters, as in ``mc_tpu``: the step pair (2m, 2m+1) of path ``id`` draws
the diffusion normals of pair ``(id, 3m)``, the jump-size normals of
``(id, 3m+1)`` and the Poisson uniforms of both words of ``(id, 3m+2)``;
the terminal draw takes z and e from the two halves of pair ``(id, 0)`` and
u from word 0 of ``(id, 2)`` (``mc_tpu``'s unpacking of its draw3, kept).
Each wrapper takes its plain PyTorch version below only when the parameter
tensor lies on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_OUTER, finish_price, resolve_device
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops import _cuda, twin
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PathPayoff, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["MertonDynamics", "DEMO_MERTON", "MERTON_FIELDS", "MERTON_TAG",
           "MertonConfig", "pack_merton", "unpack_merton", "poisson_kmax",
           "poisson_inv_cdf", "jump_increment", "counters", "steps_index",
           "merton_draw3", "pair_draws", "qmc_pay",
           "merton_partials", "merton_partials_plain", "merton_trajectories",
           "merton_trajectories_plain", "price_merton",
           "merton_call_closed_form"]

# rng.derive_key stream tag of the Merton family (mc_tpu's 0x3E44).
MERTON_TAG = 0x3E44
# FamilyId of csrc/family.cuh.
FAMILY_MERTON = 1
# The deepest Poisson scan a kernel runs.
MAX_KMAX = 256


@dataclasses.dataclass(frozen=True)
class MertonDynamics:
    """Jump parameters."""

    lam: float = 0.3       # jump intensity (expected jumps per year)
    mu_j: float = -0.10    # mean of the log jump size Y
    sigma_j: float = 0.15  # std of the log jump size Y

    def astuple(self):
        return (self.lam, self.mu_j, self.sigma_j)

    def as_f32(self) -> "MertonDynamics":
        return MertonDynamics(*(float(np.float32(x)) for x in self.astuple()))

    def kappa(self) -> float:
        """E[e^Y] - 1, the drift compensator."""
        return math.exp(float(self.mu_j) + 0.5 * float(self.sigma_j) ** 2) - 1.0


DEMO_MERTON = MertonDynamics()

MERTON_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "q", "sigma",
                 "dt", "inv_n_steps", "drift_dt", "vol_dt", "drift_t",
                 "vol_t", "lam_dt", "lam_t", "mu_j", "sigma_j")


_f32 = twin.f32  # a tensor keeps its derivative


def pack_merton(option: OptionParams, dyn: MertonDynamics, n_steps: int,
                device) -> torch.Tensor:
    """The 19 fields of ``MERTON_FIELDS`` as an f32 (19,) tensor on
    ``device``, each derived field computed in f32 on the host in the order
    of ``mc_tpu``'s ``_pack_merton`` (so the two are bitwise equal)."""
    s0, t, k, r, sigma, barrier, p1, p2, q = (_f32(v) for v in option.astuple())
    lam, mu_j, sigma_j = (_f32(v) for v in dyn.astuple())
    kappa = torch.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0
    n = _f32(n_steps)
    dt = t / n
    # The compensated drift: E[S_t] = S0 e^{(r-q)t} exactly.
    mu = r - q - lam * kappa - 0.5 * sigma * sigma
    vals = dict(s0=s0, k=k, r=r, barrier=barrier, p1=p1, p2=p2, t=t, q=q,
                sigma=sigma, dt=dt, inv_n_steps=1.0 / n, drift_dt=mu * dt,
                vol_dt=sigma * torch.sqrt(dt), drift_t=mu * t,
                vol_t=sigma * torch.sqrt(t), lam_dt=lam * dt, lam_t=lam * t,
                mu_j=mu_j, sigma_j=sigma_j)
    return torch.stack([vals[f] for f in MERTON_FIELDS]).to(device)


def unpack_merton(params: torch.Tensor) -> SimpleNamespace:
    return SimpleNamespace(**{f: params[i] for i, f in
                              enumerate(MERTON_FIELDS)})


def poisson_kmax(lam: float, tail: float = 1e-12) -> int:
    """Smallest k with P(Poisson(lam) > k) < tail: the scan depth (host,
    f64, as ``mc_tpu``'s), refused beyond 256."""
    lam = float(lam)
    if lam <= 0.0:
        return 1
    pmf = math.exp(-lam)
    cdf = pmf
    k = 0
    while cdf < 1.0 - tail and k < MAX_KMAX:
        k += 1
        pmf *= lam / k
        cdf += pmf
    if cdf < 1.0 - tail:
        raise ValueError(
            f"Poisson scan depth would exceed {MAX_KMAX} at intensity "
            f"lam={lam} (truncated tail {1.0 - cdf:.3e} > {tail:.0e} design "
            "target); reduce lam*dt by using more steps or a lower jump "
            "intensity")
    return max(k, 1)


def poisson_inv_cdf(u, lam, kmax: int):
    """The branch-free Poisson inverse CDF, N = #{k in 0..kmax-1 : u >=
    F(k)}, as an f32 count shaped like ``u``; ``lam`` a 0-d f32 tensor.
    The pmf recurrence (pmf*lam)/k and the cdf sum run in ``mc_tpu``'s
    order (``csrc/merton.cuh`` poisson_inv_cdf); the divisor is a tensor,
    so the division is IEEE's on the card too (a Python-number divisor
    becomes a multiply by its reciprocal there)."""
    ks = torch.arange(1, kmax + 1, dtype=torch.float32, device=u.device)
    pmf = torch.exp(-lam)
    cdf = pmf
    n = torch.zeros_like(u)
    for k in range(kmax):
        n = n + (u >= cdf).to(u.dtype)
        pmf = pmf * lam / ks[k]
        cdf = cdf + pmf
    return n


def jump_increment(p, n, e):
    """The compound-jump log increment given count ``n`` and one N(0,1)
    ``e``: n*mu_j + (sigma_j*sqrt(n))*e."""
    return n * p.mu_j + p.sigma_j * torch.sqrt(n) * e


def counters(ids, c):
    """Counter words ``c`` (an int, or an int64 tensor whose trailing dims
    broadcast against ``ids``) as masked int64 on the ids' device: the
    threefry of ``rng`` broadcasts them, so a tensor of leading step
    indices draws every step at once."""
    return torch.as_tensor(c, dtype=torch.int64, device=ids.device) & 0xFFFFFFFF


def steps_index(n: int, ids):
    """0..n-1 shaped ``(n, 1, ...)`` to lead the dims of ``ids``."""
    return torch.arange(n, dtype=torch.int64, device=ids.device).reshape(
        (n,) + (1,) * ids.dim())


def pair_draws(k0: int, k1: int, ids, n: int, rounds: int = 13):
    """``draw_pair(m)`` -> the two normals of pair (id, m), m < n, every pair
    drawn in one threefry call: the MC draw of the step loops that take a
    draw (their QMC draw reads the point's coordinates instead)."""
    z0, z1 = rng.normal_pair(k0, k1, ids, counters(ids, steps_index(n, ids)),
                             rounds=rounds)
    return lambda m: (z0[m], z1[m])


def merton_draw3(k0: int, k1: int, ids, m, rounds: int = 13):
    """Draws for the step pair (2m, 2m+1): ``(z0, z1, e0, e1, u0, u1)`` from
    counters 3m (diffusion normals), 3m+1 (jump-size normals) and 3m+2
    (Poisson uniforms, both words).  ``m`` an int, or a tensor of pair
    indices (``steps_index``) for every pair at once."""
    c = counters(ids, 3 * m)
    z0, z1 = rng.normal_pair(k0, k1, ids, c, rounds=rounds)
    e0, e1 = rng.normal_pair(k0, k1, ids, counters(ids, c + 1), rounds=rounds)
    b0, b1 = rng.threefry2x32(k0, k1, ids, counters(ids, c + 2), rounds=rounds)
    return z0, z1, e0, e1, rng.bits_to_unit(b0), rng.bits_to_unit(b1)


def merton_step(payoff: PathPayoff, p, kmax: int, base, w, state, z, e, u):
    """One step from the leg's start price ``base``: ``(w, s, state)`` with
    w = ((w + drift_dt) + vol_dt*z) + jump, S = base*exp(w)."""
    n = poisson_inv_cdf(u, p.lam_dt, kmax)
    w = w + p.drift_dt + p.vol_dt * z + jump_increment(p, n, e)
    s = base * torch.exp(w)  # log-space: one exp rounding per S_t
    return w, s, payoff.update(state, s, p)


# ---------------------------------------------------------------------------
# Kernel configuration and checks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MertonConfig:
    n_paths: int
    n_steps: int
    kmax: int                       # Poisson scan depth (poisson_kmax)
    method: str = "euler"           # "euler" | "terminal"
    antithetic: bool = False
    rng_source: str = "threefry13"  # "threefry13" | "threefry" (20 rounds)

    def __post_init__(self):
        if self.method not in ("euler", "terminal"):
            raise ValueError(f"unknown method {self.method!r}")
        pk.check_rng_source(self.rng_source)
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be positive; got {self.n_steps}")
        if self.method == "euler" and self.n_steps % 2:
            raise ValueError("Merton requires an even n_steps (pair-consuming "
                             "step loop)")
        if not 1 <= self.kmax <= MAX_KMAX:
            raise ValueError(f"kmax must be in [1, {MAX_KMAX}]; got {self.kmax}")

    @property
    def rng_rounds(self) -> int:
        return 13 if self.rng_source == "threefry13" else 20

    def path_config(self) -> pk.KernelConfig:
        """The path layout and stream of ``pk.path_chunks``."""
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=self.n_steps,
                               rng_source=self.rng_source)


def check_merton_params(params: torch.Tensor) -> None:
    if (not torch.is_tensor(params) or params.dtype != torch.float32
            or params.shape != (len(MERTON_FIELDS),)
            or not params.is_contiguous()
            or params.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params must be a contiguous float32 ({len(MERTON_FIELDS)},) "
            f"tensor (pack_merton) on the CPU or a CUDA device; got "
            f"{getattr(params, 'shape', None)} "
            f"{getattr(params, 'dtype', type(params))}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _threefry_draw3(k0: int, k1: int, ids, n_pairs: int, rounds: int):
    """``draw3(m)`` -> merton_draw3 of step pair m, every pair drawn at
    once."""
    draws = merton_draw3(k0, k1, ids, steps_index(n_pairs, ids), rounds)
    return lambda m: tuple(d[m] for d in draws)


def _euler_pay(payoff: PathPayoff, cfg: MertonConfig, p, like, draw3):
    """Each path's Euler payoff (the antithetic pair's mean when
    ``cfg.antithetic``: normals negated, u -> 1 - u); ``draw3(m)`` gives
    step pair m's (z0, z1, e0, e1, u0, u1)."""
    s0 = torch.zeros_like(like) + p.s0
    n_legs = 2 if cfg.antithetic else 1
    w = [torch.zeros_like(like)] * n_legs
    s, st = [s0] * n_legs, [payoff.init(p, torch.zeros_like(like))] * n_legs
    for m in range(cfg.n_steps // 2):
        z0, z1, e0, e1, u0, u1 = draw3(m)
        for leg in range(n_legs):
            halves = ((z0, e0, u0), (z1, e1, u1))
            if leg:
                halves = tuple((-z, -e, 1.0 - u) for z, e, u in halves)
            for z, e, u in halves:
                w[leg], s[leg], st[leg] = merton_step(payoff, p, cfg.kmax, s0,
                                                      w[leg], st[leg], z, e, u)
    pays = [payoff.terminal(st[leg], s[leg], p) for leg in range(n_legs)]
    return pays[0] if n_legs == 1 else 0.5 * (pays[0] + pays[1])


def qmc_pay(payoff: PathPayoff, p, n_steps: int, like, draw_pair):
    """The Euler leg on a randomized-QMC draw (``mc_tpu``'s draw3 layout):
    step pair m reads dimensions 6m..6m+3 as the normals of pairs 3m and
    3m+1 and dimensions 6m+4, 6m+5 as RAW uniforms for the Poisson counts
    (``draw_pair.unit``); the scan depth is ``p.kmax``."""
    def draw3(m):
        z0, z1 = draw_pair(3 * m)
        e0, e1 = draw_pair(3 * m + 1)
        return (z0, z1, e0, e1, draw_pair.unit(6 * m + 4),
                draw_pair.unit(6 * m + 5))

    cfg = MertonConfig(n_paths=1, n_steps=n_steps, kmax=p.kmax)
    return _euler_pay(payoff, cfg, p, like, draw3)


def _terminal_pay(payoff: PathPayoff, cfg: MertonConfig, p, k0, k1, ids):
    """The exact terminal draw: z and e the halves of pair (id, 0), u word 0
    of (id, 2), N ~ Poisson(lam*T)."""
    z, e = rng.normal_pair(k0, k1, ids, torch.zeros_like(ids),
                           rounds=cfg.rng_rounds)
    b0, _ = rng.threefry2x32(k0, k1, ids, torch.full_like(ids, 2),
                             rounds=cfg.rng_rounds)
    u = rng.bits_to_unit(b0)

    def one(z, e, u):
        n = poisson_inv_cdf(u, p.lam_t, cfg.kmax)
        s_t = p.s0 * torch.exp(p.drift_t + p.vol_t * z
                               + jump_increment(p, n, e))
        return payoff.terminal((), s_t, p)

    pay = one(z, e, u)
    if cfg.antithetic:
        pay = 0.5 * (pay + one(-z, -e, 1.0 - u))
    return pay


def merton_partials_plain(payoff: PathPayoff, cfg: MertonConfig, key,
                          params: torch.Tensor, path_offset: int = 0,
                          n_valid=None):
    """Plain version of the merton_partials kernel: (chunks, 2) f64
    [sum pay, sum pay^2] over paths ``path_offset + i``, those at or past
    the bound (default: the end of the run) adding zeros."""
    p = unpack_merton(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, _ in pk.path_chunks(cfg.path_config(), key, params,
                                              path_offset, bound):
        if cfg.method == "terminal":
            pay = _terminal_pay(payoff, cfg, p, k0, k1, ids)
        else:
            pay = _euler_pay(payoff, cfg, p, ids.float(), _threefry_draw3(
                k0, k1, ids, cfg.n_steps // 2, cfg.rng_rounds))
        pay = torch.where(valid, pay, 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


def merton_trajectories_plain(payoff: PathPayoff, cfg: MertonConfig, key,
                              params: torch.Tensor, path_offset: int = 0,
                              n_valid=None):
    """Plain version of the merton_trajectories kernel: ``(s_grid,
    state_grid, partials)``, the grids ``(n_steps, n_paths)`` f32 after
    step j+1 (state word 0, zeros for a payoff without state), the partials
    (chunks, 2) f64 [sum pay, sum pay^2]."""
    p = unpack_merton(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    shape = (cfg.n_steps, cfg.n_paths)
    s_grid = torch.empty(shape, dtype=torch.float32, device=params.device)
    st_grid = torch.zeros_like(s_grid)
    rows = []
    for start, stop, ids, valid, _ in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound):
        zero = torch.zeros_like(ids, dtype=torch.float32)
        s0 = zero + p.s0
        w, s, state = zero, s0, payoff.init(p, zero)
        n_pairs = cfg.n_steps // 2
        draws = merton_draw3(k0, k1, ids, steps_index(n_pairs, ids))
        for m in range(n_pairs):
            z0, z1, e0, e1, u0, u1 = (d[m] for d in draws)
            for j, (z, e, u) in ((2 * m, (z0, e0, u0)),
                                 (2 * m + 1, (z1, e1, u1))):
                w, s, state = merton_step(payoff, p, cfg.kmax, s0, w, state,
                                          z, e, u)
                s_grid[j, start:stop] = s
                if payoff.n_state:
                    st_grid[j, start:stop] = state[0]
        pay = torch.where(valid, payoff.terminal(state, s, p), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return s_grid, st_grid, torch.stack(rows)


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def merton_partials(payoff: PathPayoff, cfg: MertonConfig, key,
                    params: torch.Tensor, path_offset: int = 0, n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` Merton paths
    (global ids ``path_offset + i``, masked at ``n_valid``, default the end
    of the run) by ``cfg.method``; ``params`` from ``pack_merton``."""
    check_merton_params(params)
    if cfg.method == "terminal" and not payoff.terminal_only:
        raise ValueError(f"payoff {payoff.name!r} is path-dependent; "
                         "method='terminal' would ignore its path state")
    if params.device.type == "cpu":
        return merton_partials_plain(payoff, cfg, key, params, path_offset,
                                     n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(cfg.n_paths, lib.mc_merton_block_paths()),
                   _cuda.MAX_BLOCKS)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_merton_partials(
            payoff.cuda_id, int(cfg.method == "terminal"), cfg.rng_rounds,
            int(cfg.antithetic), int(key[0]), int(key[1]), params.data_ptr(),
            cfg.kmax, cfg.n_steps, cfg.n_paths, path_offset & 0xFFFFFFFF,
            bound, partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "merton_partials kernel")
    _cuda.count_launch("merton_partials")
    return partials


def merton_trajectories(payoff: PathPayoff, cfg: MertonConfig, key,
                        params: torch.Tensor, path_offset: int = 0,
                        n_valid=None):
    """Materialize the (S, state) grids: ``(s_grid, state_grid,
    partials)``, the grids ``(n_steps, n_paths)`` f32 step-major (entry
    [j, i] after step j+1 of path i), the partials ``(rows, 2)`` f64.  The
    Euler loop on threefry-13 only, as in ``mc_tpu``."""
    check_merton_params(params)
    if payoff.n_state > 1:
        raise ValueError("the trajectories kernel stores one state array")
    if (cfg.method != "euler" or cfg.antithetic
            or cfg.rng_source != "threefry13"):
        raise ValueError("merton_trajectories runs the Euler loop on "
                         "threefry-13 without an antithetic twin")
    if params.device.type == "cpu":
        return merton_trajectories_plain(payoff, cfg, key, params,
                                         path_offset, n_valid)
    from mc_tpu_torch.nmc_engine import launch_family_trajectories

    *grids, st, partials = launch_family_trajectories(
        FAMILY_MERTON, 1, (cfg.kmax,), payoff, cfg.n_paths, cfg.n_steps, key,
        params, path_offset, n_valid)
    _cuda.count_launch("merton_trajectories")
    return grids[0], st, partials


# ---------------------------------------------------------------------------
# Entry point and oracle
# ---------------------------------------------------------------------------


def price_merton(option: OptionParams = DEMO_OPTION,
                 dyn: MertonDynamics = DEMO_MERTON,
                 sim: SimParams = DEMO_SIM,
                 payoff="vanilla_call",
                 *,
                 method: str = "euler",
                 antithetic: bool = False,
                 stream: int = STREAM_OUTER,
                 key=None,
                 rng_source: str = "threefry13",
                 device="cuda") -> PriceResult:
    """Monte Carlo price under Merton jump-diffusion on ``device``.

    ``method="terminal"`` draws S_T exactly in one shot (terminal-only
    payoffs, N ~ Poisson(lam*T)); ``method="euler"`` steps the exact-in-law
    log increment (an even ``n_steps``), so path-dependent payoffs see the
    jumps at step resolution.  ``key``: a (k0, k1) pair; default
    ``rng.derive_key(sim.seed, stream, 0x3E44)``, the stream
    ``mc_tpu.price_merton`` draws.  The moment sums finish in f64 with
    e^{-rT}.
    """
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    if method == "terminal" and not po.terminal_only:
        raise ValueError(f"payoff {po.name!r} is path-dependent; "
                         "method='terminal' would ignore its path state")
    if method not in ("terminal", "euler"):
        raise ValueError(f"unknown method {method!r}")
    if method == "euler" and sim.n_steps % 2:
        raise ValueError("Merton requires an even n_steps (pair-consuming "
                         "step loop)")
    lam_scale = (float(option.t) if method == "terminal"
                 else float(option.t) / sim.n_steps)
    kmax = poisson_kmax(float(dyn.lam) * lam_scale)
    if key is None:
        key = rng.derive_key(sim.seed, stream, MERTON_TAG)
    cfg = MertonConfig(n_paths=sim.n_paths, n_steps=sim.n_steps, kmax=kmax,
                       method=method, antithetic=antithetic,
                       rng_source=rng_source)
    dev = resolve_device(device)
    params = pack_merton(option, dyn, sim.n_steps, dev)
    sums = finish_sum(merton_partials(po, cfg, (int(key[0]), int(key[1])),
                                      params))
    return finish_price(sums, sim.n_paths, option)


def merton_call_closed_form(s0, k, t, r, sigma, lam, mu_j, sigma_j,
                            q=0.0, tol: float = 1e-14) -> float:
    """European call under Merton jump-diffusion (Merton 1976 series, host
    f64, as ``mc_tpu``'s): a Poisson(lam') mixture of Black-Scholes prices
    with lam' = lam (1 + kappa), sigma_n = sqrt(sigma^2 + n sigma_j^2 / t)
    and r_n = r - lam kappa + n (mu_j + sigma_j^2/2) / t."""
    s0, k, t, r, sigma, lam, mu_j, sigma_j, q = map(
        float, (s0, k, t, r, sigma, lam, mu_j, sigma_j, q))

    def bs(s0_, r_, sig_):
        if sig_ * math.sqrt(t) < 1e-12:
            return max(s0_ * math.exp((r_ - q) * t) - k, 0.0) \
                * math.exp(-r_ * t)
        d1 = (math.log(s0_ / k) + (r_ - q + 0.5 * sig_ * sig_) * t) \
            / (sig_ * math.sqrt(t))
        d2 = d1 - sig_ * math.sqrt(t)

        def nd(x):
            return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))

        return (s0_ * math.exp(-q * t) * nd(d1)
                - k * math.exp(-r_ * t) * nd(d2))

    kappa = math.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0
    lam_p = lam * (1.0 + kappa)
    if lam_p * t < 1e-15:
        return bs(s0, r, sigma)
    w = math.exp(-lam_p * t)  # Poisson(lam' t) pmf at n = 0
    total = 0.0
    n = 0
    while True:
        sigma_n = math.sqrt(sigma * sigma + n * sigma_j * sigma_j / t)
        r_n = r - lam * kappa + n * (mu_j + 0.5 * sigma_j * sigma_j) / t
        total += w * bs(s0, r_n, sigma_n)
        n += 1
        w *= lam_p * t / n
        if n > lam_p * t and w < tol:
            break
        if n > 512:
            break
    return float(total)
