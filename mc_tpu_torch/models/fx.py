"""Cross-currency contracts: quanto, composite, flexo and FX options
(port of ``mc_tpu/models/fx.py``).

A foreign equity S (foreign currency units) and the FX rate X (domestic
units per foreign unit) follow correlated GBMs under the domestic
risk-neutral measure:

    dS/S = (r_f - q - rho sigma_s sigma_x) dt + sigma_s dW_s
    dX/X = (r_d - r_f) dt + sigma_x dW_x,     d<W_s, W_x> = rho dt

Both terminal laws are exact, so every contract prices from one threefry
Box-Muller pair per path at counter (id, 0): z_s = z0 drives the asset and
z_x = rho z0 + sqrt(1 - rho^2) z1 the FX rate.  Contracts (all settle in
domestic currency, discounted at r_d):

    gk_call/put      max(+-(X_T - kx), 0)          Garman-Kohlhagen
    quanto_call/put  x_bar * max(+-(S_T - K), 0)   fixed conversion x_bar
    compo_call/put   max(+-(S_T X_T - K), 0)       composite (domestic K)
    flexo_call/put   X_T * max(+-(S_T - K), 0)     converted at realized FX

with exact closed forms (``oracle.gk_call``, ``quanto_call``,
``compo_call``, ``flexo_call``).  ``quanto_option_params`` maps a quanto
contract onto the single-asset GBM engine.

One kernel, in ``csrc/fx_kernels.cu``: ``fx_partials`` (replaces
``_fx_partials``, ``mc_tpu/models/fx.py:208``), threefry-13 or -20, an
instantiation a contract (picked on the host; each computes only the
terminal values its payoff reads), 256 paths a block run several a thread
in lockstep, [sum pay, sum pay^2] per block in f64.  The wrapper takes its plain PyTorch version below only
when the parameter tensor lies on the CPU; for a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Optional

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_OUTER, finish_price, resolve_device
from mc_tpu_torch.models.term import fma_f32, sqrt_f32
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops import _cuda, twin
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["FXDynamics", "DEMO_FX", "FX_TAG", "FX_CONTRACTS", "FX_FIELDS",
           "FXConfig", "get_fx_contract", "pack_fx", "unpack_fx", "fx_vals",
           "fx_partials", "fx_partials_plain", "price_fx",
           "quanto_option_params"]

# rng.derive_key stream tag of the fx family (mc_tpu's).
FX_TAG = 0xF0E8

# contract -> its id in csrc/fx_kernels.cu (even: call, odd: put).
FX_CONTRACTS = {"gk_call": 0, "gk_put": 1, "quanto_call": 2, "quanto_put": 3,
                "compo_call": 4, "compo_put": 5, "flexo_call": 6,
                "flexo_put": 7}

FX_FIELDS = ("s0", "k", "x0", "kx", "x_bar", "rho", "rho_perp", "drift_s_t",
             "vol_s_t", "drift_x_t", "vol_x_t")


@dataclasses.dataclass(frozen=True)
class FXDynamics:
    """The FX leg: spot ``x0`` (domestic per foreign), its vol ``sigma_x``,
    the foreign rate ``r_f``, the asset/FX correlation ``rho``, the FX
    option strike ``kx`` and the fixed quanto rate ``x_bar`` (both default
    to x0).  The asset leg (s0, sigma, domestic r, q, T, K) rides in
    `OptionParams`."""

    x0: Any = 1.0
    sigma_x: Any = 0.15
    r_f: Any = 0.03
    rho: Any = -0.35
    kx: Optional[Any] = None
    x_bar: Optional[Any] = None

    def as_f32(self) -> "FXDynamics":
        x0 = np.float32(self.x0)
        return FXDynamics(
            x0=x0, sigma_x=np.float32(self.sigma_x), r_f=np.float32(self.r_f),
            rho=np.float32(self.rho),
            kx=x0 if self.kx is None else np.float32(self.kx),
            x_bar=x0 if self.x_bar is None else np.float32(self.x_bar))


DEMO_FX = FXDynamics()


def get_fx_contract(name: str) -> str:
    if name not in FX_CONTRACTS:
        raise KeyError(f"unknown fx contract {name!r}; "
                       f"available: {sorted(FX_CONTRACTS)}")
    return name


_f32 = twin.f32  # a tensor keeps its derivative


def pack_fx(option: OptionParams, fx: FXDynamics, device) -> torch.Tensor:
    """The 11 packed f32 fields (``FX_FIELDS``) on ``device``, bitwise
    ``mc_tpu``'s jitted ``_pack_fx``: XLA's CPU backend contracts
    1 - rho*rho and the drifts' a - b*c into fused multiply-adds
    (``fma_f32``), and its sqrt is correctly rounded (``sqrt_f32``)."""
    f = fx.as_f32()
    s0, t, k, r, sig, _, _, _, q = (_f32(v) for v in option.astuple())
    rho, sx, rf = _f32(f.rho), _f32(f.sigma_x), _f32(f.r_f)
    sqrt_t = sqrt_f32(t)
    vals = dict(
        s0=s0, k=k, x0=_f32(f.x0), kx=_f32(f.kx), x_bar=_f32(f.x_bar),
        rho=rho, rho_perp=sqrt_f32(fma_f32(-rho, rho, 1.0)),
        drift_s_t=fma_f32(-(0.5 * sig), sig,
                          fma_f32(-(rho * sig), sx, rf - q)) * t,
        vol_s_t=sig * sqrt_t,
        drift_x_t=fma_f32(-(0.5 * sx), sx, r - rf) * t,
        vol_x_t=sx * sqrt_t)
    return torch.stack([vals[n] for n in FX_FIELDS]).to(device)


def unpack_fx(params: torch.Tensor) -> SimpleNamespace:
    return SimpleNamespace(**{n: params[i] for i, n in enumerate(FX_FIELDS)})


def fx_vals(contract: str, p, z0, z1):
    """Each path's domestic payoff from its pair: S_T on z0, X_T on
    rho z0 + rho_perp z1 (``mc_tpu``'s ``_fx_vals``)."""
    z_x = p.rho * z0 + p.rho_perp * z1
    s_t = p.s0 * torch.exp(p.drift_s_t + p.vol_s_t * z0)
    x_t = p.x0 * torch.exp(p.drift_x_t + p.vol_x_t * z_x)
    cid = FX_CONTRACTS[contract]
    sign = -1.0 if cid & 1 else 1.0
    kind = cid >> 1
    if kind == 0:
        return torch.clamp(sign * (x_t - p.kx), min=0.0)
    if kind == 1:
        return p.x_bar * torch.clamp(sign * (s_t - p.k), min=0.0)
    if kind == 2:
        return torch.clamp(sign * (s_t * x_t - p.k), min=0.0)
    return x_t * torch.clamp(sign * (s_t - p.k), min=0.0)


@dataclasses.dataclass(frozen=True)
class FXConfig:
    n_paths: int
    rng_source: str = "threefry13"  # "threefry13" | "threefry" (20 rounds)

    def __post_init__(self):
        pk.check_rng_source(self.rng_source)
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")

    @property
    def rng_rounds(self) -> int:
        return 13 if self.rng_source == "threefry13" else 20

    def path_config(self) -> pk.KernelConfig:
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=1,
                               rng_source=self.rng_source)


def check_fx_params(params: torch.Tensor) -> None:
    if (not torch.is_tensor(params) or params.dtype != torch.float32
            or params.shape != (len(FX_FIELDS),) or not params.is_contiguous()
            or params.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params must be a contiguous float32 ({len(FX_FIELDS)},) tensor "
            f"(pack_fx) on the CPU or a CUDA device; got "
            f"{getattr(params, 'shape', None)} "
            f"{getattr(params, 'dtype', type(params))}")


def fx_partials_plain(contract: str, cfg: FXConfig, key, params: torch.Tensor,
                      path_offset: int = 0, n_valid=None):
    """Plain version of the fx_partials kernel: (chunks, 2) f64 [sum pay,
    sum pay^2] over paths ``path_offset + i``, those at or past the bound
    (default: the end of the run) adding zeros."""
    p = unpack_fx(params)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, _, valid, draw_pair in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound):
        z0, z1 = draw_pair(0)
        pay = torch.where(valid, fx_vals(contract, p, z0, z1), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


def fx_partials(contract: str, cfg: FXConfig, key, params: torch.Tensor,
                path_offset: int = 0, n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` paths of
    ``contract`` (global ids ``path_offset + i``, masked at ``n_valid``,
    default the end of the run); ``params`` from ``pack_fx``."""
    get_fx_contract(contract)
    check_fx_params(params)
    if params.device.type == "cpu":
        return fx_partials_plain(contract, cfg, key, params, path_offset,
                                 n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(cfg.n_paths, lib.mc_fx_block_paths()),
                   _cuda.MAX_BLOCKS)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_fx_partials(
            FX_CONTRACTS[contract], cfg.rng_rounds, int(key[0]), int(key[1]),
            params.data_ptr(), cfg.n_paths, path_offset & 0xFFFFFFFF, bound,
            partials.data_ptr(), n_blocks, _cuda.stream_handle(params.device))
    _cuda.check(status, "fx_partials kernel")
    _cuda.count_launch("fx_partials")
    return partials


def price_fx(option: OptionParams = DEMO_OPTION,
             fx: FXDynamics = DEMO_FX,
             sim: SimParams = DEMO_SIM,
             contract: str = "quanto_call",
             *,
             stream: int = STREAM_OUTER,
             key=None,
             rng_source: str = "threefry13",
             device="cuda") -> PriceResult:
    """Monte Carlo price of a cross-currency contract (``FX_CONTRACTS``) on
    ``device``.  The terminal laws are exact, so ``sim.n_steps`` is ignored.
    ``key``: a (k0, k1) pair; default ``rng.derive_key(sim.seed, stream,
    0xF0E8)``, the stream ``mc_tpu.price_fx`` draws, independent of the GBM
    and model-family streams at the same seed.  Discounted at e^{-r_d T};
    the moment sums finish in f64."""
    contract = get_fx_contract(contract)
    if key is None:
        key = rng.derive_key(sim.seed, stream, FX_TAG)
    cfg = FXConfig(n_paths=sim.n_paths, rng_source=rng_source)
    dev = resolve_device(device)
    params = pack_fx(option, fx, dev)
    sums = finish_sum(fx_partials(contract, cfg, (int(key[0]), int(key[1])),
                                  params))
    return finish_price(sums, sim.n_paths, option)


def quanto_option_params(option: OptionParams, fx: FXDynamics):
    """(adjusted OptionParams, x_bar) mapping a quanto contract onto the
    single-asset GBM engine: the effective dividend yield q_eff = r_d - r_f
    + q + rho sigma_s sigma_x, so any payoff of the S path prices through
    ``price`` (times x_bar).  Host f64, as ``mc_tpu``'s."""
    q_eff = (float(option.r) - float(fx.r_f) + float(option.q)
             + float(fx.rho) * float(option.sigma) * float(fx.sigma_x))
    x_bar = float(fx.x0 if fx.x_bar is None else fx.x_bar)
    return dataclasses.replace(option, q=q_eff), x_bar
