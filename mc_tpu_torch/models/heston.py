"""Heston stochastic-volatility family (port of ``mc_tpu/models/heston.py``).

    dS = r S dt + sqrt(v) S dW_s
    dv = kappa (theta - v) dt + xi sqrt(v) dW_v,   d<W_s, W_v> = rho dt

Two schemes, as in ``mc_tpu``: full-truncation Euler (Lord et al. 2010;
only v+ = max(v, 0) enters the diffusion terms) and Andersen's (2008)
quadratic-exponential scheme with the per-step martingale correction.  The
price accumulates in log space (S = s0 exp(w), one exp rounding per S_t),
and every payoff of the registry reads only (state, S, params), so it plugs
in unchanged, except the two Brownian-bridge barriers, which read the GBM
sigma that the Heston parameters do not have.

Two kernels serve this module:

* ``heston_partials`` (replaces ``_heston_partials_pallas``,
  ``mc_tpu/models/heston.py:332``): the Euler or QE step loop, threefry-13
  or -20, the antithetic twin in the same thread, [sum pay, sum pay^2] per
  block in f64.  Each loop forms S only where the payoff reads it (a
  barrier as the log-price against a threshold found once a block), and
  the plain and antithetic paths are kernels apart.  The QE loop is a
  kernel of its own in ``csrc/heston_qe_kernels.cu``: each lane computes
  only the sampler it takes, and the exponential sampler's uniform is
  drawn only where a lane takes it.
* ``heston_trajectories`` (replaces ``heston_trajectories_kernel``,
  ``mc_tpu/models/heston.py:527``): the Euler loop on threefry-13 that
  stores S, v (the raw full-truncation state) and payoff state word 0 after
  every step, step-major ``(n_steps, n_paths)``, plus the payoff's moment
  rows.  Its kernel is the family template's
  (``family_trajectories_kernel<HestonFamily, P, split>``,
  ``csrc/family_nmc_kernels.cu``), launched through
  ``nmc_engine.launch_family_trajectories``: a row per 128 paths.

Counters, as in ``mc_tpu``: the Euler step j of path ``id`` draws the normal
pair ``(id, j)``; the QE step j draws the pair ``(id, 2j)`` and the uniform
of word 0 of ``(id, 2j+1)``, so the two schemes never share draws.  Each
wrapper takes its plain PyTorch version below only when the parameter
tensor lies on the CPU; for a CUDA tensor it launches the kernel or raises.
The step functions keep ``mc_tpu``'s association operation by operation,
and the kernels (built with ``--fmad=false``) keep it too.
"""

from __future__ import annotations

import dataclasses
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

__all__ = ["HestonDynamics", "DEMO_HESTON", "HESTON_FIELDS", "HESTON_TAG",
           "FAMILY_HESTON",
           "HestonConfig", "pack_heston", "unpack_heston",
           "heston_euler_step", "qe_consts", "heston_qe_step",
           "heston_partials", "heston_partials_plain", "heston_trajectories",
           "heston_trajectories_plain", "qmc_pay", "price_heston",
           "heston_call_cf"]

# rng.derive_key stream tag of the Heston family (mc_tpu's 0x4E57).
HESTON_TAG = 0x4E57
# FamilyId of csrc/family.cuh.
FAMILY_HESTON = 0


@dataclasses.dataclass(frozen=True)
class HestonDynamics:
    """Variance-process parameters."""

    v0: float = 0.04       # initial variance (sigma0^2)
    kappa: float = 2.0     # mean-reversion speed
    theta: float = 0.04    # long-run variance
    xi: float = 0.3        # vol-of-vol
    rho: float = -0.7      # spot/vol correlation

    def astuple(self):
        return (self.v0, self.kappa, self.theta, self.xi, self.rho)

    def as_f32(self) -> "HestonDynamics":
        return HestonDynamics(*(float(np.float32(x)) for x in self.astuple()))


DEMO_HESTON = HestonDynamics()

HESTON_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "dt",
                 "inv_n_steps", "v0", "kappa", "theta", "xi", "rho",
                 "rho_perp", "sqrt_dt", "growth")

# The two payoffs that read the GBM sigma (their bridge crossing
# probability); mc_tpu fails on them with an AttributeError while tracing.
SIGMA_PAYOFFS = ("up_out_call_bb", "down_out_call_bb")

# Andersen's switching threshold, and the largest f32 below 1 (keeps
# log1p(-u) finite).
PSI_C = 1.5
U_MAX = float(np.float32(0.99999994))
# The validity margin of the martingale correction, in f32 as mc_tpu has it.
ONE_MINUS = float(np.float32(1.0 - 1e-6))


def pack_heston(option: OptionParams, heston: HestonDynamics, n_steps: int,
                device) -> torch.Tensor:
    """The 17 fields of ``HESTON_FIELDS`` as an f32 (17,) tensor on
    ``device``, each derived field computed in f32 in the order of
    ``mc_tpu``'s ``_pack_heston`` (so the two are bitwise equal)."""
    f32 = twin.f32  # a tensor keeps its derivative
    s0, t, k, r, _, barrier, p1, p2, q = (f32(v) for v in option.astuple())
    v0, kappa, theta, xi, rho = (f32(v) for v in heston.astuple())
    n = f32(n_steps)
    dt = t / n
    vals = dict(s0=s0, k=k, r=r, barrier=barrier, p1=p1, p2=p2, t=t, dt=dt,
                inv_n_steps=1.0 / n, v0=v0, kappa=kappa, theta=theta, xi=xi,
                rho=rho, rho_perp=torch.sqrt(1.0 - rho * rho),
                sqrt_dt=torch.sqrt(dt), growth=r - q)
    return torch.stack([vals[f] for f in HESTON_FIELDS]).to(device)


def unpack_heston(params: torch.Tensor) -> SimpleNamespace:
    return SimpleNamespace(**{f: params[i] for i, f in
                              enumerate(HESTON_FIELDS)})


# ---------------------------------------------------------------------------
# The schemes (mc_tpu/models/heston.py:94-220), association kept
# ---------------------------------------------------------------------------


def heston_euler_step(p, w, v, z_v, z_perp, dt, sqrt_dt):
    """One full-truncation Euler substep of the log-price accumulator w and
    the variance v (``csrc/heston.cuh`` heston_euler_step)."""
    z_s = p.rho * z_v + p.rho_perp * z_perp
    v_plus = torch.clamp(v, min=0.0)
    sq = torch.where(v > 0.0, torch.sqrt(torch.where(v > 0.0, v, 1.0)),
                     0.0) * sqrt_dt
    w = w + ((p.growth - 0.5 * v_plus) * dt + sq * z_s)
    v = v + p.kappa * (p.theta - v_plus) * dt + p.xi * sq * z_v
    return w, v


def qe_consts(p) -> SimpleNamespace:
    """Per-step constants of the QE scheme (Andersen 2008, eqs. 27-34),
    central discretization gamma1 = gamma2 = 1/2, f32."""
    gamma = 0.5
    emkdt = torch.exp(-p.kappa * p.dt)
    one_m = 1.0 - emkdt
    c1 = p.xi * p.xi * emkdt * one_m / p.kappa
    c2 = p.theta * p.xi * p.xi * one_m * one_m / (2.0 * p.kappa)
    kr = p.kappa * p.rho / p.xi - 0.5
    k0 = -p.rho * p.kappa * p.theta * p.dt / p.xi
    k1 = gamma * p.dt * kr - p.rho / p.xi
    k2 = gamma * p.dt * kr + p.rho / p.xi
    k3 = gamma * p.dt * (1.0 - p.rho * p.rho)
    k4 = k3
    # martingale-correction exponent A = K2 + K4/2 (Prop. 5.1)
    a_mc = k2 + 0.5 * k4
    return SimpleNamespace(emkdt=emkdt, c1=c1, c2=c2, k0=k0, k1=k1, k2=k2,
                           k3=k3, k4=k4, a_mc=a_mc, growth_dt=p.growth * p.dt)


def heston_qe_step(p, qc, w, v, z_v, z_s, u):
    """One Andersen QE step (w, v) -> (w', v'), v' >= 0, with the per-step
    martingale correction (K0* of Prop. 5.1; the plain K0 where its
    validity constraint fails).  ``z_v`` drives the quadratic sampler,
    ``u`` the exponential one, ``z_s`` the spot; ``qc = qe_consts(p)``."""
    m = p.theta + (v - p.theta) * qc.emkdt
    s2 = v * qc.c1 + qc.c2
    psi = s2 / (m * m)

    # quadratic branch: v' = a (b + Z)^2 (evaluated domain-safe everywhere)
    two_over = 2.0 / torch.clamp(psi, min=1e-12)
    b2 = torch.clamp(two_over - 1.0, min=0.0)
    b2 = b2 + torch.sqrt(two_over * b2)
    a = m / (1.0 + b2)
    bz = torch.sqrt(b2) + z_v
    v_quad = a * bz * bz

    # exponential branch: mass p_at0 at zero + exponential tail
    p_at0 = (psi - 1.0) / (psi + 1.0)
    beta = (1.0 - p_at0) / torch.clamp(m, min=1e-30)
    u_c = torch.clamp(u, max=U_MAX)
    v_exp = torch.where(u_c <= p_at0, 0.0,
                        (torch.log1p(-p_at0) - torch.log1p(-u_c)) / beta)

    quad = psi <= PSI_C
    v_next = torch.where(quad, v_quad, v_exp)

    # K0* = -ln M - (K1 + K3/2) v, M = E[e^{A v'} | v]; k0_eff replaces
    # K0 + K1 v
    aa = qc.a_mc
    two_a_a = 2.0 * aa * a
    ok_q = two_a_a < ONE_MINUS
    safe = torch.where(ok_q, 1.0 - two_a_a, 1.0)
    k0_q = -aa * b2 * a / safe + 0.5 * torch.log(safe) - 0.5 * qc.k3 * v
    ok_e = aa < beta * ONE_MINUS
    marg = torch.where(ok_e, p_at0 + beta * (1.0 - p_at0)
                       / torch.clamp(beta - aa, min=1e-30), 1.0)
    k0_e = -torch.log(marg) - 0.5 * qc.k3 * v
    k0_plain = qc.k0 + qc.k1 * v
    k0_eff = torch.where(quad, torch.where(ok_q, k0_q, k0_plain),
                         torch.where(ok_e, k0_e, k0_plain))

    var_s = torch.clamp(qc.k3 * v + qc.k4 * v_next, min=0.0)
    w = w + qc.growth_dt + k0_eff + qc.k2 * v_next + torch.sqrt(var_s) * z_s
    return w, v_next


# ---------------------------------------------------------------------------
# Kernel configuration and checks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HestonConfig:
    n_paths: int
    n_steps: int
    scheme: str = "euler"          # "euler" | "qe"
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

    @property
    def rng_rounds(self) -> int:
        return 13 if self.rng_source == "threefry13" else 20

    def path_config(self) -> pk.KernelConfig:
        """The path layout and stream of ``pk.path_chunks``."""
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=self.n_steps,
                               rng_source=self.rng_source)


def check_heston_params(params: torch.Tensor) -> None:
    if (not torch.is_tensor(params) or params.dtype != torch.float32
            or params.shape != (len(HESTON_FIELDS),)
            or not params.is_contiguous()
            or params.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params must be a contiguous float32 ({len(HESTON_FIELDS)},) "
            f"tensor (pack_heston) on the CPU or a CUDA device; got "
            f"{getattr(params, 'shape', None)} "
            f"{getattr(params, 'dtype', type(params))}")


def check_heston_payoff(payoff: PathPayoff) -> None:
    if payoff.name in SIGMA_PAYOFFS:
        raise ValueError(
            f"{payoff.name} corrects for crossings with the GBM bridge "
            "probability, which reads sigma; the Heston parameters have no "
            "sigma (mc_tpu fails on it too)")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _draw_fn(scheme: str, rounds: int, k0: int, k1: int, ids):
    """``draw(j) -> (z_v, z_2, u)`` for step j of paths ``ids``: Euler the
    normal pair (id, j) and no uniform; QE the pair (id, 2j) and the
    uniform of word 0 of (id, 2j+1)."""
    if scheme == "qe":
        def draw(j):
            c = torch.full_like(ids, (2 * j) & 0xFFFFFFFF)
            z_v, z_s = rng.normal_pair(k0, k1, ids, c, rounds=rounds)
            b0, _ = rng.threefry2x32(k0, k1, ids, (c + 1) & 0xFFFFFFFF,
                                     rounds=rounds)
            return z_v, z_s, rng.bits_to_unit(b0)
    else:
        def draw(j):
            z_v, z_p = rng.normal_pair(k0, k1, ids, torch.full_like(ids, j),
                                       rounds=rounds)
            return z_v, z_p, None
    return draw


def _pay(payoff: PathPayoff, cfg: HestonConfig, p, like, draw):
    """Each path's payoff (the antithetic pair's mean when ``cfg.antithetic``;
    the twin takes (z_v, z_2, u) -> (-z_v, -z_2, 1 - u))."""
    qc = qe_consts(p) if cfg.scheme == "qe" else None
    zero = torch.zeros_like(like)
    s0 = zero + p.s0
    n_legs = 2 if cfg.antithetic else 1
    w, v = [zero] * n_legs, [zero + p.v0] * n_legs
    s, st = [s0] * n_legs, [payoff.init(p, zero)] * n_legs
    for j in range(cfg.n_steps):
        z_v, z_2, u = draw(j)
        for leg in range(n_legs):
            if leg:
                z_v, z_2 = -z_v, -z_2
                u = None if u is None else 1.0 - u
            if cfg.scheme == "qe":
                w[leg], v[leg] = heston_qe_step(p, qc, w[leg], v[leg], z_v,
                                                z_2, u)
            else:
                w[leg], v[leg] = heston_euler_step(p, w[leg], v[leg], z_v,
                                                   z_2, p.dt, p.sqrt_dt)
            s[leg] = s0 * torch.exp(w[leg])  # one exp rounding per S_t
            st[leg] = payoff.update(st[leg], s[leg], p)
    pays = [payoff.terminal(st[leg], s[leg], p) for leg in range(n_legs)]
    return pays[0] if n_legs == 1 else 0.5 * (pays[0] + pays[1])


def qmc_pay(payoff: PathPayoff, p, n_steps: int, like, draw_pair):
    """The Euler leg on a randomized-QMC draw: step j reads the normals of
    pair j, dimensions (2j, 2j+1), as (z_v, z_perp) (``mc_tpu``'s QMC
    hook runs the Euler leg only)."""
    cfg = HestonConfig(n_paths=1, n_steps=n_steps)
    return _pay(payoff, cfg, p, like, lambda j: (*draw_pair(j), None))


def heston_partials_plain(payoff: PathPayoff, cfg: HestonConfig, key,
                          params: torch.Tensor, path_offset: int = 0,
                          n_valid=None):
    """Plain version of the heston_partials kernel: (chunks, 2) f64
    [sum pay, sum pay^2] over paths ``path_offset + i``, those at or past
    the bound (default: the end of the run) adding zeros."""
    p = unpack_heston(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, _ in pk.path_chunks(cfg.path_config(), key, params,
                                              path_offset, bound):
        draw = _draw_fn(cfg.scheme, cfg.rng_rounds, k0, k1, ids)
        pay = torch.where(valid, _pay(payoff, cfg, p, ids.float(), draw), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


def heston_trajectories_plain(payoff: PathPayoff, cfg: HestonConfig, key,
                              params: torch.Tensor, path_offset: int = 0,
                              n_valid=None):
    """Plain version of the heston_trajectories kernel: ``(s_grid, v_grid,
    state_grid, partials)``, the grids ``(n_steps, n_paths)`` f32 after
    step j+1 (state word 0, zeros for a payoff without state), the
    partials (chunks, 2) f64 [sum pay, sum pay^2]."""
    p = unpack_heston(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    shape = (cfg.n_steps, cfg.n_paths)
    s_grid = torch.empty(shape, dtype=torch.float32, device=params.device)
    v_grid = torch.empty_like(s_grid)
    st_grid = torch.zeros_like(s_grid)
    rows = []
    for start, stop, ids, valid, _ in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound):
        draw = _draw_fn("euler", 13, k0, k1, ids)
        zero = torch.zeros_like(ids, dtype=torch.float32)
        s0 = zero + p.s0
        w, v, s, state = zero, zero + p.v0, s0, payoff.init(p, zero)
        for j in range(cfg.n_steps):
            z_v, z_p, _ = draw(j)
            w, v = heston_euler_step(p, w, v, z_v, z_p, p.dt, p.sqrt_dt)
            s = s0 * torch.exp(w)
            state = payoff.update(state, s, p)
            s_grid[j, start:stop] = s
            v_grid[j, start:stop] = v
            if payoff.n_state:
                st_grid[j, start:stop] = state[0]
        pay = torch.where(valid, payoff.terminal(state, s, p), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return s_grid, v_grid, st_grid, torch.stack(rows)


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def _grid(lib, n: int) -> int:
    return min(_cuda.cdiv(n, lib.mc_heston_block_paths()), _cuda.MAX_BLOCKS)


def heston_partials(payoff: PathPayoff, cfg: HestonConfig, key,
                    params: torch.Tensor, path_offset: int = 0, n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` Heston paths
    (global ids ``path_offset + i``, masked at ``n_valid``, default the
    end of the run) under ``cfg.scheme``; ``params`` from ``pack_heston``."""
    check_heston_params(params)
    check_heston_payoff(payoff)
    if params.device.type == "cpu":
        return heston_partials_plain(payoff, cfg, key, params, path_offset,
                                     n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = _grid(lib, cfg.n_paths)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_heston_partials(
            payoff.cuda_id, int(cfg.scheme == "qe"), cfg.rng_rounds,
            int(cfg.antithetic), int(key[0]), int(key[1]), params.data_ptr(),
            cfg.n_steps, cfg.n_paths, path_offset & 0xFFFFFFFF, bound,
            partials.data_ptr(), n_blocks, _cuda.stream_handle(params.device))
    _cuda.check(status, "heston_partials kernel")
    _cuda.count_launch("heston_partials")
    return partials


def heston_trajectories(payoff: PathPayoff, cfg: HestonConfig, key,
                        params: torch.Tensor, path_offset: int = 0,
                        n_valid=None):
    """Materialize the (S, v, state) grids: ``(s_grid, v_grid, state_grid,
    partials)``, the grids ``(n_steps, n_paths)`` f32 step-major (entry
    [j, i] after step j+1 of path i; ``v`` the raw full-truncation state,
    clip it at 0 before using it as a regressor), the partials ``(rows,
    2)`` f64 (on the card a row per block of the family template's paths a
    block).  The Euler loop on threefry-13 only, as in ``mc_tpu``."""
    check_heston_params(params)
    check_heston_payoff(payoff)
    if payoff.n_state > 1:
        raise ValueError("the trajectories kernel stores one state array")
    if (cfg.scheme != "euler" or cfg.antithetic
            or cfg.rng_source != "threefry13"):
        raise ValueError("heston_trajectories runs the Euler loop on "
                         "threefry-13 without an antithetic twin")
    if params.device.type == "cpu":
        return heston_trajectories_plain(payoff, cfg, key, params,
                                         path_offset, n_valid)
    from mc_tpu_torch.nmc_engine import launch_family_trajectories

    s_grid, v_grid, st, partials = launch_family_trajectories(
        FAMILY_HESTON, 2, (), payoff, cfg.n_paths, cfg.n_steps, key, params,
        path_offset, n_valid)
    _cuda.count_launch("heston_trajectories")
    return s_grid, v_grid, st, partials


# ---------------------------------------------------------------------------
# Entry point and oracle
# ---------------------------------------------------------------------------


def price_heston(option: OptionParams = DEMO_OPTION,
                 heston: HestonDynamics = DEMO_HESTON,
                 sim: SimParams = DEMO_SIM,
                 payoff="vanilla_call",
                 *,
                 scheme: str = "euler",
                 antithetic: bool = False,
                 stream: int = STREAM_OUTER,
                 key=None,
                 rng_source: str = "threefry13",
                 device="cuda") -> PriceResult:
    """Monte Carlo price under Heston stochastic volatility on ``device``.

    ``scheme``: "euler" (full truncation) or "qe" (Andersen, martingale
    corrected).  ``key``: a (k0, k1) pair; default ``rng.derive_key(
    sim.seed, stream, 0x4E57)``, the stream ``mc_tpu.price_heston`` draws,
    disjoint from the GBM stream at the same seed.  Every payoff of the
    registry except the two Brownian-bridge barriers.  The moment sums
    finish in f64 with e^{-rT}.
    """
    po = get_payoff(payoff)
    if key is None:
        key = rng.derive_key(sim.seed, stream, HESTON_TAG)
    cfg = HestonConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                       scheme=scheme, antithetic=antithetic,
                       rng_source=rng_source)
    dev = resolve_device(device)
    params = pack_heston(option, heston, sim.n_steps, dev)
    sums = finish_sum(heston_partials(po, cfg, (int(key[0]), int(key[1])),
                                      params))
    return finish_price(sums, sim.n_paths, option)


def heston_call_cf(s0, k, t, r, v0, kappa, theta, xi, rho, q=0.0,
                   n_quad: int = 2048, u_max: float = 200.0) -> float:
    """Semi-analytic Heston European call (host, float64): the
    characteristic function in the stable 'little Heston trap' form
    (Albrecher et al. 2007), integrated with the trapezoid rule, as
    ``mc_tpu.models.heston.heston_call_cf``."""
    s0, k, t, r, q = map(float, (s0, k, t, r, q))
    v0, kappa, theta, xi, rho = map(float, (v0, kappa, theta, xi, rho))

    def cf(u):
        # phi(u) = E[exp(i u ln S_T)]
        iu = 1j * u
        d = np.sqrt((rho * xi * iu - kappa) ** 2 + xi * xi * (iu + u * u))
        g2 = (kappa - rho * xi * iu - d) / (kappa - rho * xi * iu + d)
        exp_dt = np.exp(-d * t)
        c = (kappa * theta / xi ** 2) * (
            (kappa - rho * xi * iu - d) * t
            - 2.0 * np.log((1.0 - g2 * exp_dt) / (1.0 - g2)))
        dd = ((kappa - rho * xi * iu - d) / xi ** 2
              * (1.0 - exp_dt) / (1.0 - g2 * exp_dt))
        return np.exp(iu * (np.log(s0) + (r - q) * t) + c + dd * v0)

    # P1, P2 by the Gil-Pelaez inversions
    u = np.linspace(1e-8, u_max, n_quad)
    lnk = np.log(k)
    phi_u = cf(u)
    phi_u_minus_i = cf(u - 1j)
    denom = cf(-1j)  # = E[S_T] = s0 e^{(r-q)T}
    int1 = np.real(np.exp(-1j * u * lnk) * phi_u_minus_i / (1j * u * denom))
    int2 = np.real(np.exp(-1j * u * lnk) * phi_u / (1j * u))
    p1 = 0.5 + np.trapezoid(int1, u) / np.pi
    p2 = 0.5 + np.trapezoid(int2, u) / np.pi
    # price = e^{-rT}(E[S_T] P1 - K P2), E[S_T] = s0 e^{(r-q)T}
    return s0 * np.exp(-q * t) * p1 - k * np.exp(-r * t) * p2
