"""CEV local-volatility family (port of ``mc_tpu/models/cev.py``).

    dS = (r - q) S dt + sigma_lv S^beta dW,

beta = 1 is GBM, beta < 1 the equity skew.  The state-dependent diffusion
steps the price in LEVEL space,

    S' = (S + growth_dt*S) + (sigma_lv*S^beta*sqrt_dt)*z,  S' = max(S', 0),

with S^beta = exp(beta*log(max(S, 1e-12))) and an absorbing zero: a path
that reaches 0 stays there (the CEV boundary for beta < 1).  The European
call has a closed form in the noncentral chi-squared distribution (Schroder
1989), ``cev_call_closed_form``.

The packed parameters have no sigma and no q (``CEV_FIELDS``), so the two
Brownian-bridge barriers, whose crossing probability reads sigma, are refused
(``mc_tpu`` fails on them with an AttributeError); every other payoff prices.
``price_cev`` does not call the payoff's ``validate``, as ``mc_tpu``'s does
not (ROADMAP C13): a cliquet whose period exceeds the steps prices 0.

One kernel lives in ``csrc/cev_kernels.cu``:

* ``cev_partials`` (replaces ``_cev_partials``, ``mc_tpu/models/cev.py:150``):
  the level-space Euler loop over step pairs on threefry-13, the antithetic
  twin in the same thread, [sum pay, sum pay^2] per block in f64.

Counters, as in ``mc_tpu``: substeps 2m and 2m+1 of path ``id`` take the two
normals of pair ``(id, m)``.  The wrapper takes its plain PyTorch version
below only when the parameter tensor lies on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_OUTER, finish_price, resolve_device
from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
from mc_tpu_torch.models.merton import pair_draws
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops import _cuda, twin
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PathPayoff, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["CEVDynamics", "DEMO_CEV", "CEV_FIELDS", "CEV_TAG", "CEVConfig",
           "pack_cev", "unpack_cev", "cev_substep", "cev_partials",
           "cev_partials_plain", "qmc_pay", "price_cev", "cev_call_closed_form"]

# rng.derive_key stream tag of the CEV family (mc_tpu's 0xCE4).
CEV_TAG = 0xCE4
# FamilyId of csrc/family.cuh.
FAMILY_CEV = 3


@dataclasses.dataclass(frozen=True)
class CEVDynamics:
    """CEV parameters: local vol at spot S is sigma_lv * S^(beta-1).
    ``from_atm_vol`` keeps the at-the-money vol comparable across betas."""

    sigma_lv: float = 0.2 * 100.0 ** 0.5  # sigma_atm 0.2, beta 0.5, S0 100
    beta: float = 0.5

    def astuple(self):
        return (self.sigma_lv, self.beta)

    def as_f32(self) -> "CEVDynamics":
        return CEVDynamics(*(float(np.float32(x)) for x in self.astuple()))

    @staticmethod
    def from_atm_vol(sigma_atm: float, beta: float,
                     s0: float = 100.0) -> "CEVDynamics":
        return CEVDynamics(sigma_lv=sigma_atm * s0 ** (1.0 - beta), beta=beta)


DEMO_CEV = CEVDynamics()

CEV_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "dt",
              "inv_n_steps", "sqrt_dt", "growth_dt", "sigma_lv", "beta")


_f32 = twin.f32  # a tensor keeps its derivative


def pack_cev(option: OptionParams, dyn: CEVDynamics, n_steps: int,
             device) -> torch.Tensor:
    """The 13 fields of ``CEV_FIELDS`` as an f32 (13,) tensor on ``device``,
    each derived field computed in f32 in the order of ``mc_tpu``'s
    ``_pack_cev`` (so the two are bitwise equal)."""
    s0, t, k, r, _, barrier, p1, p2, q = (_f32(v) for v in option.astuple())
    n = _f32(n_steps)
    dt = t / n
    vals = dict(s0=s0, k=k, r=r, barrier=barrier, p1=p1, p2=p2, t=t, dt=dt,
                inv_n_steps=1.0 / n, sqrt_dt=torch.sqrt(dt),
                growth_dt=(r - q) * dt, sigma_lv=_f32(dyn.sigma_lv),
                beta=_f32(dyn.beta))
    return torch.stack([vals[f] for f in CEV_FIELDS]).to(device)


def unpack_cev(params: torch.Tensor) -> SimpleNamespace:
    return SimpleNamespace(**{f: params[i] for i, f in enumerate(CEV_FIELDS)})


def cev_substep(payoff: PathPayoff, p, s, state, z):
    """One level-space Euler substep with the absorbing zero (``mc_tpu``'s
    ``_cev_leg``, ``csrc/cev.cuh`` cev_substep): ``(s, state)``."""
    alive = s > 0.0
    s_beta = torch.exp(p.beta * torch.log(torch.clamp(s, min=1e-12)))
    diff = p.sigma_lv * s_beta
    s_new = s + p.growth_dt * s + diff * p.sqrt_dt * z
    s = torch.where(alive, torch.clamp(s_new, min=0.0), 0.0)
    return s, payoff.update(state, s, p)


# ---------------------------------------------------------------------------
# Kernel configuration and checks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CEVConfig:
    n_paths: int
    n_steps: int
    antithetic: bool = False

    def __post_init__(self):
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")
        if self.n_steps < 2 or self.n_steps % 2:
            raise ValueError("CEV requires an even n_steps (pair-consuming "
                             "step loop)")

    def path_config(self) -> pk.KernelConfig:
        """The path layout and stream of ``pk.path_chunks`` (threefry-13)."""
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=self.n_steps)


def check_cev_params(params: torch.Tensor) -> None:
    if (not torch.is_tensor(params) or params.dtype != torch.float32
            or params.shape != (len(CEV_FIELDS),)
            or not params.is_contiguous()
            or params.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params must be a contiguous float32 ({len(CEV_FIELDS)},) "
            f"tensor (pack_cev) on the CPU or a CUDA device; got "
            f"{getattr(params, 'shape', None)} "
            f"{getattr(params, 'dtype', type(params))}")


def check_cev_payoff(payoff: PathPayoff) -> None:
    if payoff.name in SIGMA_PAYOFFS:
        raise ValueError(
            f"{payoff.name} corrects for crossings with the GBM bridge "
            "probability, which reads sigma; the CEV parameters have no "
            "sigma (mc_tpu fails on it too)")


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _pay(payoff: PathPayoff, cfg: CEVConfig, p, like, draw_pair):
    """Each path's payoff (the antithetic pair's mean when
    ``cfg.antithetic``: the normals negated); ``draw_pair(m)`` gives the
    normals of substeps 2m and 2m+1."""
    s0 = torch.zeros_like(like) + p.s0
    n_legs = 2 if cfg.antithetic else 1
    s, st = [s0] * n_legs, [payoff.init(p, torch.zeros_like(like))] * n_legs
    for m in range(cfg.n_steps // 2):
        z0, z1 = draw_pair(m)
        for leg in range(n_legs):
            for z in (z0, z1):
                s[leg], st[leg] = cev_substep(payoff, p, s[leg], st[leg],
                                              -z if leg else z)
    pays = [payoff.terminal(st[leg], s[leg], p) for leg in range(n_legs)]
    return pays[0] if n_legs == 1 else 0.5 * (pays[0] + pays[1])


def qmc_pay(payoff: PathPayoff, p, n_steps: int, like, draw_pair):
    """The leg on a randomized-QMC draw: pair m, dimensions (2m, 2m+1),
    feeds substeps 2m and 2m+1."""
    return _pay(payoff, CEVConfig(n_paths=1, n_steps=n_steps), p, like,
                draw_pair)


def cev_partials_plain(payoff: PathPayoff, cfg: CEVConfig, key,
                       params: torch.Tensor, path_offset: int = 0,
                       n_valid=None):
    """Plain version of the cev_partials kernel: (chunks, 2) f64
    [sum pay, sum pay^2] over paths ``path_offset + i``, those at or past
    the bound (default: the end of the run) adding zeros."""
    p = unpack_cev(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, _ in pk.path_chunks(cfg.path_config(), key, params,
                                              path_offset, bound):
        pay = torch.where(valid, _pay(payoff, cfg, p, ids.float(), pair_draws(
            k0, k1, ids, cfg.n_steps // 2)), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# Wrapper: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def cev_partials(payoff: PathPayoff, cfg: CEVConfig, key,
                 params: torch.Tensor, path_offset: int = 0, n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` CEV paths
    (global ids ``path_offset + i``, masked at ``n_valid``, default the end
    of the run); ``params`` from ``pack_cev``."""
    check_cev_params(params)
    check_cev_payoff(payoff)
    if params.device.type == "cpu":
        return cev_partials_plain(payoff, cfg, key, params, path_offset,
                                  n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(cfg.n_paths, lib.mc_cev_block_paths()),
                   _cuda.MAX_BLOCKS)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_cev_partials(
            payoff.cuda_id, int(cfg.antithetic), int(key[0]), int(key[1]),
            params.data_ptr(), cfg.n_steps, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound, partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "cev_partials kernel")
    _cuda.count_launch("cev_partials")
    return partials


# ---------------------------------------------------------------------------
# Entry point and oracle
# ---------------------------------------------------------------------------


def price_cev(option: OptionParams = DEMO_OPTION,
              cev: CEVDynamics = DEMO_CEV,
              sim: SimParams = DEMO_SIM,
              payoff="vanilla_call",
              *,
              antithetic: bool = False,
              stream: int = STREAM_OUTER,
              key=None,
              device="cuda") -> PriceResult:
    """Monte Carlo price under CEV local volatility on ``device``.

    Level-space Euler (weak order 1 in dt) on threefry-13, an even
    ``n_steps``.  ``key``: a (k0, k1) pair; default ``rng.derive_key(
    sim.seed, stream, 0xCE4)``, the stream ``mc_tpu.price_cev`` draws.  The
    moment sums finish in f64 with e^{-rT}.
    """
    po = get_payoff(payoff)
    if sim.n_steps % 2:
        raise ValueError("CEV requires an even n_steps (pair-consuming "
                         "step loop)")
    if key is None:
        key = rng.derive_key(sim.seed, stream, CEV_TAG)
    cfg = CEVConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                    antithetic=antithetic)
    dev = resolve_device(device)
    params = pack_cev(option, cev, sim.n_steps, dev)
    sums = finish_sum(cev_partials(po, cfg, (int(key[0]), int(key[1])),
                                   params))
    return finish_price(sums, sim.n_paths, option)


def cev_call_closed_form(s0, k, t, r, sigma_lv, beta, q=0.0) -> float:
    """European call under CEV by the noncentral chi-squared closed form
    (Schroder 1989; host scipy, as ``mc_tpu``'s), valid for 0 < beta < 1
    (absorbing boundary at zero)."""
    from scipy.stats import ncx2

    s0, k, t, r, sigma_lv, beta, q = map(
        float, (s0, k, t, r, sigma_lv, beta, q))
    if not 0.0 < beta < 1.0:
        raise ValueError("closed form implemented for 0 < beta < 1")
    mu = r - q
    # Hull's parameterization (exact GBM limit as beta -> 1)
    if abs(mu) > 1e-12:
        nu = (sigma_lv ** 2 / (2.0 * mu * (beta - 1.0))
              * (np.exp(2.0 * mu * (beta - 1.0) * t) - 1.0))
    else:
        nu = sigma_lv ** 2 * t
    a = ((k * np.exp(-mu * t)) ** (2.0 * (1.0 - beta))
         / ((1.0 - beta) ** 2 * nu))
    b = 1.0 / (1.0 - beta)
    c = s0 ** (2.0 * (1.0 - beta)) / ((1.0 - beta) ** 2 * nu)
    call = (s0 * np.exp(-q * t) * (1.0 - ncx2.cdf(a, b + 2.0, c))
            - k * np.exp(-r * t) * ncx2.cdf(c, b, a))
    return float(call)
