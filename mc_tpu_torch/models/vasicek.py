"""Black-Scholes-Vasicek hybrid: equity under stochastic short rates
(port of ``mc_tpu/models/vasicek.py``).

    dr   = a (b - r) dt + sigma_r dW_r,          r_0 = option.r
    dS/S = (r_t - q) dt + sigma_s dW_s,          <dW_s, dW_r> = rho dt

Each step is exact in law: the triple (eps, eta, u) = (the OU shock, the
integrated-rate shock, the equity diffusion) is jointly Gaussian with a
known covariance, whose 3x3 Cholesky is packed once (``pack_vasicek``, in
the closed cancellation-free form of ``ou_chol2``/``ou_gap``).  The state of
a path is (w = log S/S0, x = r - b, y = int r du):

    dy = b dt + x B + eta;   w += dy - (q + sigma_s^2/2) dt + u;
    y += dy;                 x = x e^{-a dt} + eps          (``vasicek_step``)

Every payoff of the registry prices on the S path and is discounted
PATHWISE by exp(-y_T), so ``price_vasicek`` finishes with discount 1; the
``zcb`` payoff prices the bond itself.  Oracles: ``oracle.vasicek_zcb`` and
``oracle.bsv_call`` (Merton 1973).

Two kernels, in ``csrc/vasicek_kernels.cu`` and
``csrc/vasicek_nmc_kernels.cu``:

* ``vasicek_partials`` (replaces ``_vasicek_partials``,
  ``mc_tpu/models/vasicek.py:266``): the step loop over step pairs,
  threefry-13 or -20, the antithetic twin in the same thread, [sum pay, sum
  pay^2] of the discounted payoffs per block in f64.
* ``vasicek_trajectories`` (replaces ``vasicek_trajectories_kernel``,
  ``mc_tpu/models/vasicek.py:405``): the same loop on threefry-13 storing S,
  x, y and payoff state word 0 after every step, step-major ``(n_steps,
  n_paths)``, plus the discounted payoff's moment rows; the Vasicek
  instantiation of the family engine's trajectories kernel.

Counters, as in ``mc_tpu``: the step pair (2m, 2m+1) of path ``id`` takes
the pairs ``(id, 3m)``, ``(id, 3m+1)``, ``(id, 3m+2)`` -> (z0, z1), (z2,
z3), (z4, z5), step 2m stepping on (z0, z1, z2) and step 2m+1 on (z3, z4,
z5), so ``n_steps`` must be even.  Each wrapper takes its plain PyTorch
version below only when the parameter tensor lies on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_OUTER, resolve_device
from mc_tpu_torch.models.merton import counters, steps_index
from mc_tpu_torch.models.term import fma_f32, sqrt_f32
from mc_tpu_torch.oracle import PriceResult, summarize
from mc_tpu_torch.ops import _cuda, twin
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PathPayoff, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["VasicekDynamics", "DEMO_VASICEK", "VASICEK_FIELDS",
           "VASICEK_TAG", "VasicekConfig", "ou_gap", "ou_chol2",
           "pack_vasicek", "unpack_vasicek", "vasicek_step",
           "vasicek_partials", "vasicek_partials_plain",
           "vasicek_trajectories", "vasicek_trajectories_plain",
           "qmc_pay", "price_vasicek"]

# rng.derive_key stream tag of the Vasicek family (mc_tpu's 0x7A51).
VASICEK_TAG = 0x7A51
# FamilyId of csrc/family.cuh.
FAMILY_VASICEK = 7


@dataclasses.dataclass(frozen=True)
class VasicekDynamics:
    """Short-rate parameters; the initial rate r0 is ``option.r``."""

    a: float = 0.3         # mean-reversion speed
    b: float = 0.05        # long-run rate level
    sigma_r: float = 0.015  # absolute rate volatility
    rho: float = -0.3      # equity/rate correlation

    def astuple(self):
        return (self.a, self.b, self.sigma_r, self.rho)

    def as_f32(self) -> "VasicekDynamics":
        return VasicekDynamics(*(float(np.float32(x)) for x in self.astuple()))


DEMO_VASICEK = VasicekDynamics()

VASICEK_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "dt",
                  "inv_n_steps", "sqrt_dt", "sigma", "x0", "bdt", "e1",
                  "big_b", "drift_adj", "l11", "l21", "l22", "l31", "l32",
                  "l33")


_f32 = twin.f32  # a tensor keeps its derivative


def ou_gap(x):
    """G(x) = x - 2 tanh(x/2), the exact-OU conditional-variance factor of
    an f32 scalar, in ``mc_tpu``'s stable split: its Maclaurin series
    through x^9 below 0.5 (Horner in fused multiply-adds, as XLA's CPU
    backend contracts it), the closed tanh form above (the textbook c11 -
    c10^2/c00 loses ~x^-2 relative digits in f32)."""
    x2 = x * x
    h = fma_f32(x2, _f32(-31.0 / 362880.0), _f32(17.0 / 20160.0))
    h = fma_f32(x2, h, _f32(-1.0 / 120.0))
    h = fma_f32(x2, h, _f32(1.0 / 12.0))
    series = x * x2 * h
    direct = x - 2.0 * torch.tanh(0.5 * x)
    return torch.where(x < 0.5, series, direct)


def ou_chol2(a, sigma_r, dt):
    """(e1, big_b, l11, l21, l22): the exact-OU step decay, B(dt), and the
    Cholesky of the (OU increment, integrated-OU increment) covariance in
    cancellation-free closed form (B - c2 = v^2/(2a), Var[eta | eps] =
    sigma_r^2 G(a dt) / a^3), f32 in ``mc_tpu``'s order."""
    x = a * dt
    u = torch.exp(-x)
    v = -torch.expm1(-x)
    c2 = -torch.expm1(-2.0 * x) / (2.0 * a)
    sqrt_c2 = sqrt_f32(c2)
    big_b = v / a
    l11 = sigma_r * sqrt_c2
    l21 = sigma_r * v * v / (2.0 * a * a * sqrt_c2)
    l22 = (sigma_r / a) * sqrt_f32(ou_gap(x) / a)
    return u, big_b, l11, l21, l22


def pack_vasicek(option: OptionParams, dyn: VasicekDynamics, n_steps: int,
                 device) -> torch.Tensor:
    """The 22 fields of ``VASICEK_FIELDS`` as an f32 (22,) tensor on
    ``device``, each derived field computed in f32 in the order of
    ``mc_tpu``'s jitted ``_pack_vasicek``, with the fused multiply-adds XLA's
    CPU backend contracts it into (``fma_f32``) and its rewrite of t / n as
    t * (1/n).  The spot row of the Cholesky reduces to l31 = rho sigma_s v
    / (a sqrt(c2)), l32 = rho sigma_s sqrt(G/a), l33 = sigma_s sqrt(dt)
    sqrt(max(1 - rho^2, 0)).  The fields that go through exp, expm1 or
    tanh (e1, big_b, l11, l21, l22, l31, l32) differ from ``mc_tpu``'s by a
    few ulp, XLA's CPU approximations of those functions not being
    PyTorch's (ROADMAP C17); every other field is bitwise."""
    s0, t, k, r0, sigma_s, barrier, p1, p2, q = (
        _f32(v) for v in option.astuple())
    a, b, sigma_r, rho = (_f32(v) for v in dyn.astuple())
    inv_n = 1.0 / _f32(n_steps)
    dt = t * inv_n  # XLA turns mc_tpu's jitted t / n into this multiply
    e1, big_b, l11, l21, l22 = ou_chol2(a, sigma_r, dt)
    x = a * dt
    gx = ou_gap(x)
    c2 = -torch.expm1(-2.0 * x) / (2.0 * a)
    v = -torch.expm1(-x)
    l31 = rho * sigma_s * v / (a * sqrt_f32(c2))
    l32 = rho * sigma_s * sqrt_f32(gx / a)
    l33 = (sigma_s * sqrt_f32(dt)
           * sqrt_f32(torch.clamp(fma_f32(-rho, rho, 1.0), min=0.0)))
    vals = dict(s0=s0, k=k, r=r0, barrier=barrier, p1=p1, p2=p2, t=t,
                dt=dt, inv_n_steps=inv_n, sqrt_dt=sqrt_f32(dt),
                sigma=sigma_s, x0=r0 - b, bdt=b * dt, e1=e1, big_b=big_b,
                drift_adj=fma_f32(0.5 * sigma_s, sigma_s, q) * dt,
                l11=l11, l21=l21, l22=l22, l31=l31, l32=l32, l33=l33)
    return torch.stack([vals[f] for f in VASICEK_FIELDS]).to(device)


def unpack_vasicek(params: torch.Tensor) -> SimpleNamespace:
    return SimpleNamespace(**{f: params[i] for i, f in
                              enumerate(VASICEK_FIELDS)})


def vasicek_step(p, carry, za, zb, zc, s0):
    """One exact step from three iid normals (``mc_tpu``'s
    ``vasicek_step``, ``csrc/vasicek.cuh``): ``((w, x, y), s)`` with S =
    s0*exp(w) from the leg's start price ``s0``."""
    w, x, y = carry
    eps = p.l11 * za
    eta = p.l21 * za + p.l22 * zb
    u = p.l31 * za + p.l32 * zb + p.l33 * zc
    dy = p.bdt + x * p.big_b + eta
    w = w + dy - p.drift_adj + u
    y = y + dy
    x = x * p.e1 + eps
    return (w, x, y), s0 * torch.exp(w)  # log-space: one exp rounding per S_t


# ---------------------------------------------------------------------------
# Kernel configuration and checks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VasicekConfig:
    n_paths: int
    n_steps: int
    antithetic: bool = False
    rng_source: str = "threefry13"  # "threefry13" | "threefry" (20 rounds)

    def __post_init__(self):
        pk.check_rng_source(self.rng_source)
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")
        if self.n_steps < 2 or self.n_steps % 2:
            raise ValueError("vasicek requires an even n_steps (pair-consuming "
                             f"step loop); got {self.n_steps}")

    @property
    def rng_rounds(self) -> int:
        return 13 if self.rng_source == "threefry13" else 20

    def path_config(self) -> pk.KernelConfig:
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=self.n_steps,
                               rng_source=self.rng_source)


def check_vasicek_params(params: torch.Tensor) -> None:
    if (not torch.is_tensor(params) or params.dtype != torch.float32
            or params.shape != (len(VASICEK_FIELDS),)
            or not params.is_contiguous()
            or params.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params must be a contiguous float32 ({len(VASICEK_FIELDS)},) "
            f"tensor (pack_vasicek) on the CPU or a CUDA device; got "
            f"{getattr(params, 'shape', None)} "
            f"{getattr(params, 'dtype', type(params))}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _threefry_pairs(cfg: VasicekConfig, k0: int, k1: int, ids):
    """``draw_pair(c)`` -> the normals of pair (id, c), c < 3*n_steps/2,
    every step pair's three pairs drawn at once."""
    m = steps_index(cfg.n_steps // 2, ids)
    z = [rng.normal_pair(k0, k1, ids, counters(ids, 3 * m + c),
                         rounds=cfg.rng_rounds) for c in range(3)]
    return lambda c: (z[c % 3][0][c // 3], z[c % 3][1][c // 3])


def _legs(payoff: PathPayoff, cfg: VasicekConfig, p, like, draw_pair,
          on_step=None):
    """Each path's discounted payoff (the antithetic pair's mean when
    ``cfg.antithetic``: every normal negated); step pair m reads pairs 3m,
    3m+1 and 3m+2 of ``draw_pair``.  ``on_step(j, s, (w, x, y), state)``
    sees the first leg after each step."""
    zero = torch.zeros_like(like)
    s0 = zero + p.s0
    n_legs = 2 if cfg.antithetic else 1
    carry = [(zero, zero + p.x0, zero)] * n_legs
    s, st = [s0] * n_legs, [payoff.init(p, zero)] * n_legs
    for mm in range(cfg.n_steps // 2):
        (z0, z1), (z2, z3), (z4, z5) = (draw_pair(3 * mm + c)
                                        for c in range(3))
        for j, zs in ((2 * mm, (z0, z1, z2)), (2 * mm + 1, (z3, z4, z5))):
            for leg in range(n_legs):
                za, zb, zc = (-x for x in zs) if leg else zs
                carry[leg], s[leg] = vasicek_step(p, carry[leg], za, zb, zc,
                                                  s0)
                st[leg] = payoff.update(st[leg], s[leg], p)
            if on_step is not None:
                on_step(j, s[0], carry[0], st[0])
    pays = [payoff.terminal(st[leg], s[leg], p) * torch.exp(-carry[leg][2])
            for leg in range(n_legs)]
    return pays[0] if n_legs == 1 else 0.5 * (pays[0] + pays[1])


def qmc_pay(payoff: PathPayoff, p, n_steps: int, like, draw_pair):
    """The discounted leg on a randomized-QMC draw: step pair m reads pairs
    3m, 3m+1 and 3m+2, dimensions 6m..6m+5."""
    return _legs(payoff, VasicekConfig(n_paths=1, n_steps=n_steps), p, like,
                 draw_pair)


def vasicek_partials_plain(payoff: PathPayoff, cfg: VasicekConfig, key,
                           params: torch.Tensor, path_offset: int = 0,
                           n_valid=None):
    """Plain version of the vasicek_partials kernel: (chunks, 2) f64 [sum
    pay, sum pay^2] of the discounted payoffs over paths ``path_offset +
    i``, those at or past the bound (default: the end of the run) adding
    zeros."""
    p = unpack_vasicek(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, _ in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound,
            pk.plain_chunk(params)):
        pay = torch.where(valid, _legs(payoff, cfg, p, ids.float(),
                                       _threefry_pairs(cfg, k0, k1, ids)), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


def vasicek_trajectories_plain(payoff: PathPayoff, cfg: VasicekConfig, key,
                               params: torch.Tensor, path_offset: int = 0,
                               n_valid=None):
    """Plain version of the vasicek_trajectories kernel: ``(s_grid, x_grid,
    y_grid, state_grid, partials)``, the grids ``(n_steps, n_paths)`` f32
    after step j+1 (state word 0, zeros for a payoff without state), the
    partials (chunks, 2) f64 of the discounted payoff."""
    p = unpack_vasicek(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    shape = (cfg.n_steps, cfg.n_paths)
    grids = [torch.empty(shape, dtype=torch.float32, device=params.device)
             for _ in range(3)]
    st_grid = torch.zeros(shape, dtype=torch.float32, device=params.device)
    rows = []
    for start, stop, ids, valid, _ in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound,
            pk.plain_chunk(params)):
        def store(j, s, carry, state, start=start, stop=stop):
            for g, row in zip(grids, (s, carry[1], carry[2])):
                g[j, start:stop] = row
            if payoff.n_state:
                st_grid[j, start:stop] = state[0]

        pay = torch.where(valid, _legs(payoff, cfg, p, ids.float(),
                                       _threefry_pairs(cfg, k0, k1, ids),
                                       store), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return (*grids, st_grid, torch.stack(rows))


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def vasicek_partials(payoff: PathPayoff, cfg: VasicekConfig, key,
                     params: torch.Tensor, path_offset: int = 0,
                     n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` Vasicek paths'
    discounted payoffs (global ids ``path_offset + i``, masked at
    ``n_valid``, default the end of the run); ``params`` from
    ``pack_vasicek``."""
    check_vasicek_params(params)
    if params.device.type == "cpu":
        return vasicek_partials_plain(payoff, cfg, key, params, path_offset,
                                      n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(cfg.n_paths, lib.mc_vasicek_block_threads()),
                   _cuda.MAX_BLOCKS)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_vasicek_partials(
            payoff.cuda_id, cfg.rng_rounds, int(cfg.antithetic), int(key[0]),
            int(key[1]), params.data_ptr(), cfg.n_steps, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound, partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "vasicek_partials kernel")
    _cuda.count_launch("vasicek_partials")
    return partials


def vasicek_trajectories(payoff: PathPayoff, cfg: VasicekConfig, key,
                         params: torch.Tensor, path_offset: int = 0,
                         n_valid=None):
    """Materialize the (S, x = r - b, y = int r, state) grids: ``(s_grid,
    x_grid, y_grid, state_grid, partials)``, the grids ``(n_steps,
    n_paths)`` f32 step-major (entry [j, i] after step j+1 of path i), the
    partials ``(rows, 2)`` f64 of the discounted payoff.  Threefry-13
    without an antithetic twin, as in ``mc_tpu``."""
    check_vasicek_params(params)
    if payoff.n_state > 1:
        raise ValueError("the trajectories kernel stores one state array")
    if cfg.antithetic or cfg.rng_source != "threefry13":
        raise ValueError("vasicek_trajectories runs threefry-13 without an "
                         "antithetic twin")
    if params.device.type == "cpu":
        return vasicek_trajectories_plain(payoff, cfg, key, params,
                                          path_offset, n_valid)
    from mc_tpu_torch.nmc_engine import launch_family_trajectories

    out = launch_family_trajectories(FAMILY_VASICEK, 3, (), payoff,
                                     cfg.n_paths, cfg.n_steps, key, params,
                                     path_offset, n_valid)
    _cuda.count_launch("vasicek_trajectories")
    return out


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def price_vasicek(option: OptionParams = DEMO_OPTION,
                  dyn: VasicekDynamics = DEMO_VASICEK,
                  sim: SimParams = DEMO_SIM,
                  payoff="vanilla_call",
                  *,
                  antithetic: bool = False,
                  stream: int = STREAM_OUTER,
                  key=None,
                  rng_source: str = "threefry13",
                  device="cuda") -> PriceResult:
    """Monte Carlo price under Black-Scholes-Vasicek rates on ``device``:
    ``option.r`` is the initial short rate r0, every payoff is discounted
    pathwise by exp(-int r dt) (``payoff="zcb"`` prices the bond), and the
    scheme is exact in law, so ``sim.n_steps`` (even) sets the monitoring
    dates only.  ``key``: a (k0, k1) pair; default ``rng.derive_key(
    sim.seed, stream, 0x7A51)``, the stream ``mc_tpu.price_vasicek`` draws.
    Each payoff validated first; the moment sums finish in f64 with
    discount 1."""
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    if sim.n_steps % 2:
        raise ValueError("vasicek requires an even n_steps "
                         "(pair-consuming step loop)")
    if key is None:
        key = rng.derive_key(sim.seed, stream, VASICEK_TAG)
    cfg = VasicekConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                        antithetic=antithetic, rng_source=rng_source)
    dev = resolve_device(device)
    params = pack_vasicek(option, dyn, sim.n_steps, dev)
    sums = finish_sum(vasicek_partials(po, cfg, (int(key[0]), int(key[1])),
                                       params))
    # the discount is applied pathwise inside the leg
    return summarize(sums[0], sums[1], float(sim.n_paths), 1.0)
