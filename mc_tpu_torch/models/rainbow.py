"""Rainbow options: payoffs on the order statistics of correlated assets
(port of ``mc_tpu/models/rainbow.py``).

The basket (``models.basket``) prices payoffs on the weighted sum; rainbow
contracts read the individual terminal prices: best-of and worst-of calls
and puts, the Margrabe exchange, best-of-assets-or-cash.  Each path is one
exact correlated GBM draw over the full horizon: ceil(d/2) threefry pairs
at counters (id, q), the d normals mixed by the Cholesky factor L,

    y_i = L_i0 z_0 + L_i1 z_1 + ...        (k in order)
    S_i = s0_i exp(drift_i + sqrt_T y_i)

then a max or min fold over the assets in order.  The packed vector is the
basket's at n_steps = 1 (``pack_basket``: the drifts span the full horizon,
sqrt_dt = sqrt(T)); the weights are ignored.  Gates: Margrabe (1978) and
Stulz (1982) at d = 2 (``oracle.margrabe``, ``oracle.stulz_*``).

One kernel, in ``csrc/rainbow_partials.cuh`` (instantiated in
``csrc/rainbow_kernels.cu`` and ``csrc/rainbow32_kernels.cu``):
``rainbow_partials`` (replaces ``_rainbow_partials``,
``mc_tpu/models/rainbow.py:135``), d a runtime value up to 32 through the
basket's capacities (4, 8, 16, 32, picked in the library), threefry-13 or
-20, the payoff a runtime switch, the plain and the antithetic path
(every normal negated) kernels apart, 256 paths a block and several a
thread in lockstep, [sum pay, sum pay^2] per block in f64.  The wrapper
takes its plain PyTorch version below only when the parameter tensor lies
on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import (STREAM_OUTER, finish_price, kernel_sums,
                                  resolve_device)
from mc_tpu_torch.models.basket import (DEMO_BASKET, BasketDynamics,
                                        _check_d, _col, check_basket_params,
                                        pack_basket, unpack_basket)
from mc_tpu_torch.models.merton import counters
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops import path_kernels as pk

__all__ = ["RAINBOW_PAYOFFS", "RAINBOW_TAG", "RainbowConfig",
           "get_rainbow_payoff", "rainbow_normals", "rainbow_levels",
           "rainbow_pay", "rainbow_partials", "rainbow_partials_plain",
           "price_rainbow"]

# rng.derive_key stream tag of price_rainbow (mc_tpu's).
RAINBOW_TAG = 0xBE0F

# name -> (its id in csrc/rainbow_kernels.cu, the fewest assets it needs)
RAINBOW_PAYOFFS = {"call_on_max": (0, 1), "call_on_min": (1, 1),
                   "put_on_max": (2, 1), "put_on_min": (3, 1),
                   "exchange": (4, 2), "best_of_cash": (5, 1)}


def get_rainbow_payoff(name: str) -> str:
    if name not in RAINBOW_PAYOFFS:
        raise KeyError(f"unknown rainbow payoff {name!r}; "
                       f"available: {sorted(RAINBOW_PAYOFFS)}")
    return name


@dataclasses.dataclass(frozen=True)
class RainbowConfig:
    n_paths: int
    d: int
    antithetic: bool = False
    rng_source: str = "threefry13"  # "threefry13" | "threefry" (20 rounds)

    def __post_init__(self):
        _check_d(self.d)
        pk.check_rng_source(self.rng_source)
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")

    @property
    def rng_rounds(self) -> int:
        return 13 if self.rng_source == "threefry13" else 20

    def path_config(self) -> pk.KernelConfig:
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=1,
                               rng_source=self.rng_source)


def rainbow_normals(k0: int, k1: int, ids, d: int, rounds: int):
    """The d normals of each path, (d, *ids.shape): pair q at counter (id,
    q) gives z_{2q}, z_{2q+1} (an odd d drops the last)."""
    npps = (d + 1) // 2
    q = _col(torch.arange(npps, dtype=torch.int64, device=ids.device), ids)
    z0, z1 = rng.normal_pair(k0, k1, ids, counters(ids, q), rounds=rounds)
    return torch.stack([z0, z1], dim=1).reshape(2 * npps, *z0.shape[1:])[:d]


def rainbow_levels(p, zs):
    """S_i = s0_i exp(drift_i + sqrt_T y_i), (d, ...), y_i = L_i0 z_0 + L_i1
    z_1 + ... in k order (``mc_tpu``'s ``_rainbow_leg``)."""
    d = zs.shape[0]
    one = zs[0]
    y = _col(p.chol[:, 0], one) * zs[0]
    for k in range(1, d):
        y[k:] = y[k:] + _col(p.chol[k:, k], one) * zs[k]
    return _col(p.s0s, one) * torch.exp(_col(p.drifts, one) + p.sqrt_dt * y)


def rainbow_pay(name: str, p, ss):
    """The payoff of the terminal prices ``ss`` (d, ...): the max or min
    folded over the assets in order."""
    if name == "exchange":
        return torch.clamp(ss[0] - ss[1], min=0.0)
    fold = torch.maximum if name in ("call_on_max", "put_on_max",
                                     "best_of_cash") else torch.minimum
    m = ss[0]
    for s in ss[1:]:
        m = fold(m, s)
    if name.startswith("call"):
        return torch.clamp(m - p.k, min=0.0)
    if name.startswith("put"):
        return torch.clamp(p.k - m, min=0.0)
    return torch.maximum(m, p.k)  # best_of_cash


def rainbow_partials_plain(name: str, cfg: RainbowConfig, key,
                           params: torch.Tensor, path_offset: int = 0,
                           n_valid=None):
    """Plain version of the rainbow_partials kernel: (chunks, 2) f64 [sum
    pay, sum pay^2] over paths ``path_offset + i``, those at or past the
    bound (default: the end of the run) adding zeros."""
    p = unpack_basket(params, cfg.d)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, _ in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound,
            pk.plain_chunk(params)):
        zs = rainbow_normals(k0, k1, ids, cfg.d, cfg.rng_rounds)
        pay = rainbow_pay(name, p, rainbow_levels(p, zs))
        if cfg.antithetic:
            pay = 0.5 * (pay + rainbow_pay(name, p, rainbow_levels(p, -zs)))
        pay = torch.where(valid, pay, 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


def rainbow_partials(name: str, cfg: RainbowConfig, key, params: torch.Tensor,
                     path_offset: int = 0, n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` rainbow paths
    (global ids ``path_offset + i``, masked at ``n_valid``, default the end
    of the run); ``params`` from ``pack_basket`` at n_steps = 1 and
    ``cfg.d``."""
    get_rainbow_payoff(name)
    check_basket_params(params, cfg.d)
    if params.device.type == "cpu":
        return rainbow_partials_plain(name, cfg, key, params, path_offset,
                                      n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(cfg.n_paths, lib.mc_rainbow_block_paths()),
                   _cuda.MAX_BLOCKS)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_rainbow_partials(
            RAINBOW_PAYOFFS[name][0], cfg.rng_rounds, int(cfg.antithetic),
            int(key[0]), int(key[1]), params.data_ptr(), cfg.d, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound, partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "rainbow_partials kernel")
    _cuda.count_launch("rainbow_partials")
    return partials


def price_rainbow(option: OptionParams = DEMO_OPTION,
                  basket: BasketDynamics = DEMO_BASKET,
                  sim: SimParams = DEMO_SIM,
                  payoff: str = "call_on_max",
                  *,
                  antithetic: bool = False,
                  stream: int = STREAM_OUTER,
                  key=None,
                  rng_source: str = "threefry13",
                  device="cuda") -> PriceResult:
    """Monte Carlo price of a rainbow option on correlated GBM assets on
    ``device``: ``payoff`` one of ``RAINBOW_PAYOFFS`` (contracts on the
    terminal max or min of the assets, or the exchange max(S1 - S2, 0));
    ``option.k`` is the cash strike, the basket's weights are ignored and
    ``sim.n_steps`` too (one exact terminal draw).  ``key``: a (k0, k1)
    pair; default ``rng.derive_key(sim.seed, stream, 0xBE0F)``, the stream
    ``mc_tpu.price_rainbow`` draws.  Discounted at e^{-rT}; the moment sums
    finish in f64."""
    get_rainbow_payoff(payoff)
    b32 = basket.as_f32()
    min_d = RAINBOW_PAYOFFS[payoff][1]
    if b32.d < min_d:
        raise ValueError(f"{payoff!r} needs >= {min_d} assets, basket has "
                         f"{b32.d}")
    if key is None:
        key = rng.derive_key(sim.seed, stream, RAINBOW_TAG)
    cfg = RainbowConfig(n_paths=sim.n_paths, d=b32.d, antithetic=antithetic,
                        rng_source=rng_source)
    dev = resolve_device(device)
    params = pack_basket(option, b32, 1, dev)
    key = (int(key[0]), int(key[1]))
    # basket fields that require grad (greeks.rainbow_greeks): the kernel's
    # value, the plain version's gradient
    sums = kernel_sums(
        params, lambda prm: rainbow_partials(payoff, cfg, key, prm),
        lambda prm, off, n: rainbow_partials_plain(
            payoff, dataclasses.replace(cfg, n_paths=n), key, prm, off,
            sim.n_paths),
        sim.n_paths, b32.d)
    return finish_price(sums, sim.n_paths, option)
