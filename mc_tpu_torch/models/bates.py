"""Bates (1996) stochastic-volatility jump-diffusion family (port of
``mc_tpu/models/bates.py``).

    dS/S = (r - q - lam*kbar) dt + sqrt(v) dW_s + (e^Y - 1) dN
    dv   = kappa (theta - v) dt + xi sqrt(v) dW_v,  d<W_s,W_v> = rho dt
    N ~ Poisson(lam),  Y ~ N(mu_j, sigma_j^2),  kbar = E[e^Y] - 1.

The family composes the two others, as ``mc_tpu`` does: the diffusion
substep is the Heston module's ``heston_euler_step``/``heston_qe_step`` and
the jump substep Merton's ``poisson_inv_cdf`` and ``jump_increment``; the
compensator sits in the packed ``growth``, so the Heston steps take the
Bates parameters unchanged.  The two Brownian-bridge barriers read the GBM
sigma, which Bates does not have, and raise.

One kernel lives in ``csrc/bates_kernels.cu``:

* ``bates_partials`` (replaces ``_bates_partials``,
  ``mc_tpu/models/bates.py:257``): the Euler or QE step loop with the jump,
  threefry-13 or -20, the antithetic twin in the same thread,
  [sum pay, sum pay^2] per block in f64.  The QE loop is a kernel of its own
  in ``csrc/bates_qe_kernels.cu``: Heston's branch-split QE step, the
  Poisson count against a block's cdf table, the jump size drawn only where
  a count can be nonzero, the plain and antithetic paths kernels apart.

Counters, as in ``mc_tpu``: the Euler step j of path ``id`` draws the pair
``(id, 3j)`` for (z_v, z_perp), the first normal of ``(id, 3j+1)`` for the
jump size and word 0 of ``(id, 3j+2)`` for the Poisson uniform; the QE step
the pair ``(id, 4j)``, the QE uniform of ``(id, 4j+1)``, the jump normal of
``(id, 4j+2)`` and the Poisson uniform of ``(id, 4j+3)``.  The wrapper takes
its plain PyTorch version below only when the parameter tensor lies on the
CPU; for a CUDA tensor it launches the kernel or raises.
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
from mc_tpu_torch.models.heston import (HESTON_FIELDS, SIGMA_PAYOFFS,
                                        heston_euler_step, heston_qe_step,
                                        qe_consts)
from mc_tpu_torch.models.merton import (MAX_KMAX, counters, jump_increment,
                                        poisson_inv_cdf, poisson_kmax,
                                        steps_index)
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops import _cuda, twin
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PathPayoff, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["BatesDynamics", "DEMO_BATES", "BATES_FIELDS", "BATES_TAG",
           "FAMILY_BATES",
           "BatesConfig", "pack_bates", "unpack_bates", "bates_euler_draw",
           "bates_jump", "bates_euler_step", "bates_partials",
           "bates_partials_plain", "qmc_pay", "price_bates", "bates_call_cf"]

# rng.derive_key stream tag of the Bates family (mc_tpu's 0xBA7E).
BATES_TAG = 0xBA7E
# FamilyId of csrc/family.cuh.
FAMILY_BATES = 2


@dataclasses.dataclass(frozen=True)
class BatesDynamics:
    """Heston variance parameters and Merton jump parameters."""

    v0: float = 0.04       # initial variance
    kappa: float = 2.0     # variance mean-reversion speed
    theta: float = 0.04    # long-run variance
    xi: float = 0.3        # vol-of-vol
    rho: float = -0.7      # spot/vol correlation
    lam: float = 0.3       # jump intensity (per year)
    mu_j: float = -0.10    # mean log jump size
    sigma_j: float = 0.15  # std of log jump size

    def astuple(self):
        return (self.v0, self.kappa, self.theta, self.xi, self.rho,
                self.lam, self.mu_j, self.sigma_j)

    def as_f32(self) -> "BatesDynamics":
        return BatesDynamics(*(float(np.float32(x)) for x in self.astuple()))

    def kbar(self) -> float:
        """E[e^Y] - 1, the jump drift compensator."""
        return math.exp(float(self.mu_j) + 0.5 * float(self.sigma_j) ** 2) - 1.0


DEMO_BATES = BatesDynamics()

# HESTON_FIELDS and the jump's: the Heston steps read theirs by name, the
# jump substep lam_dt, mu_j and sigma_j.
BATES_FIELDS = HESTON_FIELDS + ("lam_dt", "mu_j", "sigma_j")


_f32 = twin.f32  # a tensor keeps its derivative


def pack_bates(option: OptionParams, dyn: BatesDynamics, n_steps: int,
               device) -> torch.Tensor:
    """The 20 fields of ``BATES_FIELDS`` as an f32 (20,) tensor on
    ``device``, each derived field computed in f32 on the host in the order
    of ``mc_tpu``'s ``_pack_bates`` (so the two are bitwise equal)."""
    s0, t, k, r, _, barrier, p1, p2, q = (_f32(v) for v in option.astuple())
    v0, kappa, theta, xi, rho, lam, mu_j, sigma_j = (
        _f32(v) for v in dyn.astuple())
    kbar = torch.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0
    n = _f32(n_steps)
    dt = t / n
    vals = dict(
        s0=s0, k=k, r=r, barrier=barrier, p1=p1, p2=p2, t=t, dt=dt,
        inv_n_steps=1.0 / n, v0=v0, kappa=kappa, theta=theta, xi=xi,
        rho=rho, rho_perp=torch.sqrt(1.0 - rho * rho), sqrt_dt=torch.sqrt(dt),
        # The compensated growth: E[S_t] = S0 e^{(r-q)t} exactly.
        growth=r - q - lam * kbar,
        lam_dt=lam * dt, mu_j=mu_j, sigma_j=sigma_j)
    return torch.stack([vals[f] for f in BATES_FIELDS]).to(device)


def unpack_bates(params: torch.Tensor) -> SimpleNamespace:
    return SimpleNamespace(**{f: params[i] for i, f in
                              enumerate(BATES_FIELDS)})


def bates_euler_draw(k0: int, k1: int, ids, c, rounds: int = 13):
    """The Euler step's draws from counter ``c`` (an int, or an int64 tensor
    whose leading dims index steps, ``merton.counters``): ``(z_v, z_perp,
    e, u)``, the pair of c, the first normal of c+1 and the uniform of word
    0 of c+2."""
    c = counters(ids, c)
    z_v, z_perp = rng.normal_pair(k0, k1, ids, c, rounds=rounds)
    e, _ = rng.normal_pair(k0, k1, ids, counters(ids, c + 1), rounds=rounds)
    b0, _ = rng.threefry2x32(k0, k1, ids, counters(ids, c + 2), rounds=rounds)
    return z_v, z_perp, e, rng.bits_to_unit(b0)


def _qe_draw(k0: int, k1: int, ids, j, rounds: int):
    """The QE step's draws: ``(z_v, z_s, u_v, e, u_n)`` from counters 4j
    (pair), 4j+1 (QE uniform), 4j+2 (jump normal), 4j+3 (Poisson uniform);
    ``j`` an int or a tensor of step indices."""
    c = counters(ids, 4 * j)
    z_v, z_s = rng.normal_pair(k0, k1, ids, c, rounds=rounds)
    b_v, _ = rng.threefry2x32(k0, k1, ids, counters(ids, c + 1),
                              rounds=rounds)
    e, _ = rng.normal_pair(k0, k1, ids, counters(ids, c + 2), rounds=rounds)
    b_n, _ = rng.threefry2x32(k0, k1, ids, counters(ids, c + 3),
                              rounds=rounds)
    return z_v, z_s, rng.bits_to_unit(b_v), e, rng.bits_to_unit(b_n)


def bates_jump(payoff: PathPayoff, p, kmax: int, base, w, state, e, u):
    """The jump half of a step after the diffusion moved w: ``(w, s,
    state)`` with w += jump(N(u), e), S = base*exp(w)."""
    n = poisson_inv_cdf(u, p.lam_dt, kmax)
    w = w + jump_increment(p, n, e)
    s = base * torch.exp(w)  # log-space: one exp rounding per S_t
    return w, s, payoff.update(state, s, p)


def bates_euler_step(payoff: PathPayoff, p, kmax: int, base, w, v, state,
                     z_v, z_perp, e, u):
    """One Bates Euler step: Heston's full-truncation step, then the jump;
    ``(w, v, s, state)``."""
    w, v = heston_euler_step(p, w, v, z_v, z_perp, p.dt, p.sqrt_dt)
    w, s, state = bates_jump(payoff, p, kmax, base, w, state, e, u)
    return w, v, s, state


# ---------------------------------------------------------------------------
# Kernel configuration and checks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatesConfig:
    n_paths: int
    n_steps: int
    kmax: int                       # Poisson scan depth (poisson_kmax)
    scheme: str = "euler"           # "euler" | "qe"
    antithetic: bool = False
    rng_source: str = "threefry13"  # "threefry13" | "threefry" (20 rounds)

    def __post_init__(self):
        if self.scheme not in ("euler", "qe"):
            raise ValueError(f"unknown scheme {self.scheme!r} (euler | qe)")
        pk.check_rng_source(self.rng_source)
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be positive; got {self.n_steps}")
        if not 1 <= self.kmax <= MAX_KMAX:
            raise ValueError(f"kmax must be in [1, {MAX_KMAX}]; got {self.kmax}")

    @property
    def rng_rounds(self) -> int:
        return 13 if self.rng_source == "threefry13" else 20

    def path_config(self) -> pk.KernelConfig:
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=self.n_steps,
                               rng_source=self.rng_source)


def check_bates_params(params: torch.Tensor) -> None:
    if (not torch.is_tensor(params) or params.dtype != torch.float32
            or params.shape != (len(BATES_FIELDS),)
            or not params.is_contiguous()
            or params.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params must be a contiguous float32 ({len(BATES_FIELDS)},) "
            f"tensor (pack_bates) on the CPU or a CUDA device; got "
            f"{getattr(params, 'shape', None)} "
            f"{getattr(params, 'dtype', type(params))}")


def check_bates_payoff(payoff: PathPayoff) -> None:
    if payoff.name in SIGMA_PAYOFFS:
        raise ValueError(
            f"{payoff.name} corrects for crossings with the GBM bridge "
            "probability, which reads sigma; the Bates parameters have no "
            "sigma (mc_tpu fails on it too)")


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _threefry_draws(cfg: BatesConfig, k0: int, k1: int, ids):
    """``draws(j)`` -> step j's (z_v, z_2, u_v, e, u_n) as the kernel's
    BatesDraws (u_v unused under Euler), every step drawn at once."""
    j = steps_index(cfg.n_steps, ids)
    if cfg.scheme == "qe":
        draws = _qe_draw(k0, k1, ids, j, cfg.rng_rounds)
    else:
        z_v, z_2, e, u_n = bates_euler_draw(k0, k1, ids, 3 * j, cfg.rng_rounds)
        draws = (z_v, z_2, torch.zeros_like(u_n), e, u_n)
    return lambda j: tuple(d[j] for d in draws)


def _pay(payoff: PathPayoff, cfg: BatesConfig, p, like, draws):
    """Each path's payoff (the antithetic pair's mean when
    ``cfg.antithetic``: normals negated, each uniform u -> 1 - u);
    ``draws(j)`` gives step j's (z_v, z_2, u_v, e, u_n)."""
    qc = qe_consts(p) if cfg.scheme == "qe" else None
    zero = torch.zeros_like(like)
    s0 = zero + p.s0
    n_legs = 2 if cfg.antithetic else 1
    w, v = [zero] * n_legs, [zero + p.v0] * n_legs
    s, st = [s0] * n_legs, [payoff.init(p, zero)] * n_legs
    for j in range(cfg.n_steps):
        z_v, z_2, u_v, e, u_n = draws(j)
        for leg in range(n_legs):
            if leg:
                z_v, z_2, u_v, e, u_n = -z_v, -z_2, 1.0 - u_v, -e, 1.0 - u_n
            if cfg.scheme == "qe":
                w[leg], v[leg] = heston_qe_step(p, qc, w[leg], v[leg], z_v,
                                                z_2, u_v)
            else:
                w[leg], v[leg] = heston_euler_step(p, w[leg], v[leg], z_v,
                                                   z_2, p.dt, p.sqrt_dt)
            w[leg], s[leg], st[leg] = bates_jump(payoff, p, cfg.kmax, s0,
                                                 w[leg], st[leg], e, u_n)
    pays = [payoff.terminal(st[leg], s[leg], p) for leg in range(n_legs)]
    return pays[0] if n_legs == 1 else 0.5 * (pays[0] + pays[1])


def qmc_pay(payoff: PathPayoff, p, n_steps: int, like, draw_pair):
    """The Euler leg on a randomized-QMC draw, ``mc_tpu``'s packed layout of
    4 dimensions a step (ROADMAP C4): step j reads (4j, 4j+1) as the
    diffusion pair 2j, dimension 4j+2 as the jump-size normal (the first of
    pair 2j+1, its second discarded) and dimension 4j+3 as the RAW uniform
    of the Poisson count; the scan depth is ``p.kmax``."""
    def draws(j):
        z_v, z_2 = draw_pair(2 * j)
        e, _ = draw_pair(2 * j + 1)
        return z_v, z_2, None, e, draw_pair.unit(4 * j + 3)

    cfg = BatesConfig(n_paths=1, n_steps=n_steps, kmax=p.kmax)
    return _pay(payoff, cfg, p, like, draws)


def bates_partials_plain(payoff: PathPayoff, cfg: BatesConfig, key,
                         params: torch.Tensor, path_offset: int = 0,
                         n_valid=None):
    """Plain version of the bates_partials kernel: (chunks, 2) f64
    [sum pay, sum pay^2] over paths ``path_offset + i``, those at or past
    the bound (default: the end of the run) adding zeros."""
    p = unpack_bates(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, _ in pk.path_chunks(cfg.path_config(), key, params,
                                              path_offset, bound):
        pay = torch.where(valid, _pay(payoff, cfg, p, ids.float(),
                                      _threefry_draws(cfg, k0, k1, ids)), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# Wrapper: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def bates_partials(payoff: PathPayoff, cfg: BatesConfig, key,
                   params: torch.Tensor, path_offset: int = 0, n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` Bates paths
    (global ids ``path_offset + i``, masked at ``n_valid``, default the end
    of the run) under ``cfg.scheme``; ``params`` from ``pack_bates``."""
    check_bates_params(params)
    check_bates_payoff(payoff)
    if params.device.type == "cpu":
        return bates_partials_plain(payoff, cfg, key, params, path_offset,
                                    n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(cfg.n_paths, lib.mc_bates_block_paths()),
                   _cuda.MAX_BLOCKS)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_bates_partials(
            payoff.cuda_id, int(cfg.scheme == "qe"), cfg.rng_rounds,
            int(cfg.antithetic), int(key[0]), int(key[1]), params.data_ptr(),
            cfg.kmax, cfg.n_steps, cfg.n_paths, path_offset & 0xFFFFFFFF,
            bound, partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "bates_partials kernel")
    _cuda.count_launch("bates_partials")
    return partials


# ---------------------------------------------------------------------------
# Entry point and oracle
# ---------------------------------------------------------------------------


def price_bates(option: OptionParams = DEMO_OPTION,
                dyn: BatesDynamics = DEMO_BATES,
                sim: SimParams = DEMO_SIM,
                payoff="vanilla_call",
                *,
                scheme: str = "euler",
                antithetic: bool = False,
                stream: int = STREAM_OUTER,
                key=None,
                rng_source: str = "threefry13",
                device="cuda") -> PriceResult:
    """Monte Carlo price under Bates SVJ dynamics on ``device``.

    ``scheme`` picks the diffusion substep: "euler" (full truncation) or
    "qe" (Andersen 2008, martingale corrected); the jump is exact in law
    either way, its Poisson scan depth chosen on the host from lam*dt.
    ``key``: a (k0, k1) pair; default ``rng.derive_key(sim.seed, stream,
    0xBA7E)``, the stream ``mc_tpu.price_bates`` draws.  Every payoff of the
    registry except the two Brownian-bridge barriers.  The moment sums
    finish in f64 with e^{-rT}.
    """
    po = get_payoff(payoff)
    if key is None:
        key = rng.derive_key(sim.seed, stream, BATES_TAG)
    kmax = poisson_kmax(float(dyn.lam) * float(option.t) / sim.n_steps)
    cfg = BatesConfig(n_paths=sim.n_paths, n_steps=sim.n_steps, kmax=kmax,
                      scheme=scheme, antithetic=antithetic,
                      rng_source=rng_source)
    dev = resolve_device(device)
    params = pack_bates(option, dyn, sim.n_steps, dev)
    sums = finish_sum(bates_partials(po, cfg, (int(key[0]), int(key[1])),
                                     params))
    return finish_price(sums, sim.n_paths, option)


def bates_call_cf(s0, k, t, r, v0, kappa, theta, xi, rho, lam, mu_j,
                  sigma_j, q=0.0, n_quad: int = 2048,
                  u_max: float = 200.0) -> float:
    """Semi-analytic Bates European call (host, float64), as
    ``mc_tpu.models.bates.bates_call_cf``: the Bates characteristic function
    is the Heston one (the stable little-trap form) times the compensated
    compound-Poisson factor

        phi_J(u) = exp(lam t (e^{i u mu_j - u^2 sigma_j^2 / 2} - 1)
                       - i u lam t kbar),

    inverted by Gil-Pelaez with the trapezoid rule.  lam = 0 gives
    ``heston_call_cf``; xi -> 0 with v0 = theta gives Merton's series."""
    s0, k, t, r, q = map(float, (s0, k, t, r, q))
    v0, kappa, theta, xi, rho = map(float, (v0, kappa, theta, xi, rho))
    lam, mu_j, sigma_j = map(float, (lam, mu_j, sigma_j))
    kbar = math.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0

    def cf(u):
        iu = 1j * u
        d = np.sqrt((rho * xi * iu - kappa) ** 2 + xi * xi * (iu + u * u))
        g2 = (kappa - rho * xi * iu - d) / (kappa - rho * xi * iu + d)
        exp_dt = np.exp(-d * t)
        c = (kappa * theta / xi ** 2) * (
            (kappa - rho * xi * iu - d) * t
            - 2.0 * np.log((1.0 - g2 * exp_dt) / (1.0 - g2)))
        dd = ((kappa - rho * xi * iu - d) / xi ** 2
              * (1.0 - exp_dt) / (1.0 - g2 * exp_dt))
        jump = lam * t * (np.exp(iu * mu_j - 0.5 * u * u * sigma_j ** 2)
                          - 1.0) - iu * lam * t * kbar
        return np.exp(iu * (np.log(s0) + (r - q) * t) + c + dd * v0 + jump)

    u = np.linspace(1e-8, u_max, n_quad)
    lnk = np.log(k)
    phi_u = cf(u)
    phi_u_minus_i = cf(u - 1j)
    denom = cf(np.array(-1j))  # = E[S_T] = s0 e^{(r-q)T}
    int1 = np.real(np.exp(-1j * u * lnk) * phi_u_minus_i / (1j * u * denom))
    int2 = np.real(np.exp(-1j * u * lnk) * phi_u / (1j * u))
    p1 = 0.5 + np.trapezoid(int1, u) / np.pi
    p2 = 0.5 + np.trapezoid(int2, u) / np.pi
    return float(s0 * math.exp(-q * t) * p1 - k * math.exp(-r * t) * p2)
