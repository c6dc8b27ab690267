"""SABR stochastic-volatility family (port of ``mc_tpu/models/sabr.py``).

    dF     = sigma F^beta dW_1,      F_0 = s0 e^{(r-q)T}
    dsigma = nu sigma dW_2,          <dW_1, dW_2> = rho dt

The forward steps in LOG space with the local lognormal vol sigma F^(beta-1)
and the vol factor is exact in distribution (``sabr_step``, the one step
definition the pricing loop and the NMC legs share).  Payoffs see the
forward path F = exp(log F) after every step and are discounted at e^{-rT}.
The oracle is Hagan et al.'s (2002) implied-vol expansion
(``sabr_implied_vol``, ``sabr_call_hagan``).

The packed parameters (``SABR_FIELDS``, bitwise ``mc_tpu``'s ``_pack_sabr``)
have no sigma, so the two Brownian-bridge barriers are refused (``mc_tpu``
fails on them with an AttributeError); the other 16 payoffs price.

One kernel lives in ``csrc/sabr_kernels.cu``:

* ``sabr_partials`` (replaces ``_sabr_partials``,
  ``mc_tpu/models/sabr.py:177``): the step loop, threefry-13 or -20, paths
  in lockstep (an antithetic path's twin as one more leg), [sum pay, sum
  pay^2] per block of 256 paths in f64; at a packed beta of 1 its unit-beta
  instantiation, whose step has no local-vol ``exp`` (``sabr_unit_beta``).

Counters, as in ``mc_tpu``: step j of path ``id`` draws the normal pair
``(id, j) -> (z_vol, z_perp)``, the forward's shock z_f = rho z_vol +
rho_perp z_perp.  The wrapper takes its plain PyTorch version below only
when the parameter tensor lies on the CPU; for a CUDA tensor it launches the
kernel or raises.
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
from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
from mc_tpu_torch.models.merton import pair_draws
from mc_tpu_torch.oracle import PriceResult, _call_segment_f64
from mc_tpu_torch.ops import _cuda, twin
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PathPayoff, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["SABRDynamics", "DEMO_SABR", "SABR_FIELDS", "SABR_TAG",
           "SABRConfig", "pack_sabr", "unpack_sabr", "sabr_step",
           "sabr_partials", "sabr_partials_plain", "sabr_unit_beta",
           "qmc_pay", "price_sabr",
           "sabr_implied_vol", "sabr_call_hagan"]

# rng.derive_key stream tag of the SABR family (mc_tpu's 0x5AB4).
SABR_TAG = 0x5AB4
# FamilyId of csrc/family.cuh.
FAMILY_SABR = 5


@dataclasses.dataclass(frozen=True)
class SABRDynamics:
    """SABR parameters: alpha the initial vol of the forward, beta the CEV
    backbone exponent in [0, 1], nu the vol-of-vol, rho the forward-vol
    correlation."""

    alpha: float = 0.2
    beta: float = 1.0
    nu: float = 0.4
    rho: float = -0.4

    def astuple(self):
        return (self.alpha, self.beta, self.nu, self.rho)

    def as_f32(self) -> "SABRDynamics":
        return SABRDynamics(*(float(np.float32(x)) for x in self.astuple()))


DEMO_SABR = SABRDynamics()

SABR_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "q",
               "dt", "inv_n_steps", "sqrt_dt", "f0",
               "alpha", "beta", "nu", "rho", "rho_perp")


_f32 = twin.f32  # a tensor keeps its derivative


def pack_sabr(option: OptionParams, dyn: SABRDynamics, n_steps: int,
              device) -> torch.Tensor:
    """The 17 fields of ``SABR_FIELDS`` as an f32 (17,) tensor on
    ``device``, each derived field computed in f32 in the order of
    ``mc_tpu``'s ``_pack_sabr`` (so the two are bitwise equal): the
    forward f0 = s0*exp((r - q)*t) and rho_perp = sqrt(max(1 - rho^2, 0))
    are packed on the host."""
    s0, t, k, r, _, barrier, p1, p2, q = (_f32(v) for v in option.astuple())
    n = _f32(n_steps)
    dt = t / n
    rho = _f32(dyn.rho)
    vals = dict(s0=s0, k=k, r=r, barrier=barrier, p1=p1, p2=p2, t=t, q=q,
                dt=dt, inv_n_steps=1.0 / n, sqrt_dt=torch.sqrt(dt),
                f0=s0 * torch.exp((r - q) * t),
                alpha=_f32(dyn.alpha), beta=_f32(dyn.beta), nu=_f32(dyn.nu),
                rho=rho,
                rho_perp=torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0)))
    return torch.stack([vals[f] for f in SABR_FIELDS]).to(device)


def unpack_sabr(params: torch.Tensor) -> SimpleNamespace:
    return SimpleNamespace(**{f: params[i] for i, f in enumerate(SABR_FIELDS)})


def sabr_step(p, logf, sig, z_vol, z_perp):
    """One SABR step (``mc_tpu``'s ``sabr_step``, ``csrc/sabr.cuh``): the
    log-forward under the local lognormal vol sig*F^(beta-1), then the exact
    lognormal vol factor: ``(logf, sig)``."""
    z_f = p.rho * z_vol + p.rho_perp * z_perp
    vol_loc = sig * torch.exp((p.beta - 1.0) * logf)
    logf = logf + vol_loc * p.sqrt_dt * z_f - 0.5 * vol_loc * vol_loc * p.dt
    sig = sig * torch.exp(p.nu * p.sqrt_dt * z_vol - 0.5 * p.nu * p.nu * p.dt)
    return logf, sig


# ---------------------------------------------------------------------------
# Kernel configuration and checks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SABRConfig:
    n_paths: int
    n_steps: int
    antithetic: bool = False
    rng_source: str = "threefry13"  # "threefry13" | "threefry" (20 rounds)

    def __post_init__(self):
        pk.check_rng_source(self.rng_source)
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be positive; got {self.n_steps}")

    @property
    def rng_rounds(self) -> int:
        return 13 if self.rng_source == "threefry13" else 20

    def path_config(self) -> pk.KernelConfig:
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=self.n_steps,
                               rng_source=self.rng_source)


def check_sabr_params(params: torch.Tensor) -> None:
    if (not torch.is_tensor(params) or params.dtype != torch.float32
            or params.shape != (len(SABR_FIELDS),)
            or not params.is_contiguous()
            or params.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params must be a contiguous float32 ({len(SABR_FIELDS)},) "
            f"tensor (pack_sabr) on the CPU or a CUDA device; got "
            f"{getattr(params, 'shape', None)} "
            f"{getattr(params, 'dtype', type(params))}")


def check_sabr_payoff(payoff: PathPayoff) -> None:
    if payoff.name in SIGMA_PAYOFFS:
        raise ValueError(
            f"{payoff.name} corrects for crossings with the GBM bridge "
            "probability, which reads sigma; the SABR parameters have no "
            "sigma (mc_tpu fails on it too)")


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _pay(payoff: PathPayoff, cfg: SABRConfig, p, like, draw_pair):
    """Each path's payoff on the forward path (the antithetic pair's mean
    when ``cfg.antithetic``: both normals negated); ``draw_pair(j)`` gives
    step j's (z_vol, z_perp)."""
    zero = torch.zeros_like(like)
    logf0 = torch.log(zero + p.f0)
    n_legs = 2 if cfg.antithetic else 1
    logf, sig = [logf0] * n_legs, [zero + p.alpha] * n_legs
    st = [payoff.init(p, zero)] * n_legs
    for j in range(cfg.n_steps):
        z_vol, z_perp = draw_pair(j)
        for leg in range(n_legs):
            zv, zp = (-z_vol, -z_perp) if leg else (z_vol, z_perp)
            logf[leg], sig[leg] = sabr_step(p, logf[leg], sig[leg], zv, zp)
            st[leg] = payoff.update(st[leg], torch.exp(logf[leg]), p)
    pays = [payoff.terminal(st[leg], torch.exp(logf[leg]), p)
            for leg in range(n_legs)]
    return pays[0] if n_legs == 1 else 0.5 * (pays[0] + pays[1])


def qmc_pay(payoff: PathPayoff, p, n_steps: int, like, draw_pair):
    """The leg on a randomized-QMC draw: step j reads pair j, dimensions
    (2j, 2j+1), as (z_vol, z_perp)."""
    return _pay(payoff, SABRConfig(n_paths=1, n_steps=n_steps), p, like,
                draw_pair)


def sabr_partials_plain(payoff: PathPayoff, cfg: SABRConfig, key,
                        params: torch.Tensor, path_offset: int = 0,
                        n_valid=None):
    """Plain version of the sabr_partials kernel: (chunks, 2) f64
    [sum pay, sum pay^2] over paths ``path_offset + i``, those at or past
    the bound (default: the end of the run) adding zeros."""
    p = unpack_sabr(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, _ in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound,
            pk.plain_chunk(params)):
        pay = torch.where(valid, _pay(payoff, cfg, p, ids.float(), pair_draws(
            k0, k1, ids, cfg.n_steps, cfg.rng_rounds)), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# Wrapper: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def sabr_unit_beta(params: torch.Tensor) -> bool:
    """Whether the packed beta is 1 (``c.beta - 1.0f == 0``), where the
    kernel's unit-beta instantiation gives the general step's bits without
    its local-vol ``exp``: one 4-byte read of the packed vector (on the
    card, a copy to the host)."""
    beta = float(params[SABR_FIELDS.index("beta")])
    return beta - 1.0 == 0.0


def sabr_partials(payoff: PathPayoff, cfg: SABRConfig, key,
                  params: torch.Tensor, path_offset: int = 0, n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` SABR paths
    (global ids ``path_offset + i``, masked at ``n_valid``, default the end
    of the run); ``params`` from ``pack_sabr``."""
    check_sabr_params(params)
    check_sabr_payoff(payoff)
    if params.device.type == "cpu":
        return sabr_partials_plain(payoff, cfg, key, params, path_offset,
                                   n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(cfg.n_paths, lib.mc_sabr_block_paths()),
                   _cuda.MAX_BLOCKS)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_sabr_partials(
            payoff.cuda_id, cfg.rng_rounds, int(cfg.antithetic),
            int(sabr_unit_beta(params)), int(key[0]),
            int(key[1]), params.data_ptr(), cfg.n_steps, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound, partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "sabr_partials kernel")
    _cuda.count_launch("sabr_partials")
    return partials


# ---------------------------------------------------------------------------
# Entry point and oracles
# ---------------------------------------------------------------------------


def price_sabr(option: OptionParams = DEMO_OPTION,
               dyn: SABRDynamics = DEMO_SABR,
               sim: SimParams = DEMO_SIM,
               payoff="vanilla_call",
               *,
               antithetic: bool = False,
               stream: int = STREAM_OUTER,
               key=None,
               rng_source: str = "threefry13",
               device="cuda") -> PriceResult:
    """Monte Carlo price under SABR on ``device``: payoffs on the FORWARD
    path, discounted at e^{-rT}.  ``key``: a (k0, k1) pair; default
    ``rng.derive_key(sim.seed, stream, 0x5AB4)``, the stream
    ``mc_tpu.price_sabr`` draws.  Every payoff but the two Brownian-bridge
    barriers, each validated first.  The moment sums finish in f64."""
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    if key is None:
        key = rng.derive_key(sim.seed, stream, SABR_TAG)
    cfg = SABRConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                     antithetic=antithetic, rng_source=rng_source)
    dev = resolve_device(device)
    params = pack_sabr(option, dyn, sim.n_steps, dev)
    sums = finish_sum(sabr_partials(po, cfg, (int(key[0]), int(key[1])),
                                    params))
    return finish_price(sums, sim.n_paths, option)


def sabr_implied_vol(f, k, t, alpha, beta, nu, rho) -> float:
    """Hagan et al. (2002) lognormal implied-vol expansion, host f64 (the
    model's oracle; accurate to O(T) for moderate vol-of-vol, ~1% here)."""
    f, k, t, alpha, beta, nu, rho = map(
        float, (f, k, t, alpha, beta, nu, rho))
    omb = 1.0 - beta
    lfk = math.log(f / k)
    fkb = (f * k) ** (omb / 2.0)
    # the correction factor common to the ATM and smile branches
    corr = (1.0 + (omb ** 2 / 24.0 * alpha ** 2 / fkb ** 2
                   + rho * beta * nu * alpha / (4.0 * fkb)
                   + (2.0 - 3.0 * rho ** 2) / 24.0 * nu ** 2) * t)
    denom = fkb * (1.0 + omb ** 2 / 24.0 * lfk ** 2
                   + omb ** 4 / 1920.0 * lfk ** 4)
    if abs(lfk) < 1e-10:
        return alpha / denom * corr
    z = nu / alpha * fkb * lfk
    xz = math.log((math.sqrt(1.0 - 2.0 * rho * z + z * z) + z - rho)
                  / (1.0 - rho))
    return alpha / denom * (z / xz) * corr


def sabr_call_hagan(s0, k, t, r, alpha, beta, nu, rho, q=0.0) -> float:
    """European call under SABR: Hagan's implied vol into Black-76 on the
    forward s0*e^{(r-q)T}, discounted at e^{-rT}."""
    s0, k, t, r, q = map(float, (s0, k, t, r, q))
    f = s0 * math.exp((r - q) * t)
    iv = sabr_implied_vol(f, k, t, alpha, beta, nu, rho)
    return _call_segment_f64(f, k, t, 0.0, iv, 0.0, k, None) * math.exp(-r * t)
