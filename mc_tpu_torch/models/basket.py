"""Correlated multi-asset basket (port of ``mc_tpu/models/basket.py``).

``d`` assets follow correlated GBM and every payoff of the registry prices
on the basket level ``B_t = sum_i w_i S_{i,t}`` (basket calls, Asians,
knock-outs, bullets, ...; the option's strike and barrier refer to B).  Per
step, d iid normals are mixed by the lower-triangular Cholesky factor L of
the return covariance diag(sigma) corr diag(sigma) (plus a 1e-6 relative
jitter on its diagonal):

    y_i = sum_{k <= i} L_ik z_k          (k in order)
    w_i += (r - q - sigma_i^2/2) dt + sqrt(dt) y_i,   S_i = s0_i e^{w_i}
    B = sum_i w_i S_i                    (i in order)

``d`` is a runtime value up to ``MAX_BASKET_D`` = 32.  The packed vector
(``pack_basket``, bitwise ``mc_tpu``'s ``_pack_basket`` of its jitted
``_basket_namespace``) is a 10-float head, then s0s, weights and drifts (d
each) and L's lower triangle row by row (d(d+1)/2):

    [k, r, t, barrier, p1, p2, dt, inv_n_steps, sqrt_dt, b0, ...]

The payoffs see b0 = sum_i w_i s0_i as s0 and sigma = k*0: the Brownian-
bridge barriers then price as their discrete twins, as ``mc_tpu``'s Pallas
kernel does (its XLA dual reads the option's sigma instead; ROADMAP C16).

Two kernels, in ``csrc/basket_partials.cuh``, at the capacity that fits d
(4, 8, 16 or 32; a source a capacity, ``csrc/basket_kernels.cu`` and
``csrc/basket{8,16,32}_kernels.cu``):

* ``basket_partials`` (replaces ``_basket_partials``,
  ``mc_tpu/models/basket.py:268``): the step loop, threefry-13, the
  antithetic leg (every normal negated) in lockstep with the first on the
  same draw, [sum pay, sum pay^2] per block in f64.
* ``basket_trajectories`` (replaces ``basket_trajectories_kernel``,
  ``mc_tpu/models/basket.py:393``): the same loop, several paths a thread
  in lockstep, storing the basket level B and payoff state word 0 after
  every step, step-major ``(n_steps, n_paths)`` (the grids ``mc_tpu``'s
  basket LSMC reads), plus the payoff's moment rows.

The NMC's d per-asset price grids are a third store of the same leg
(``nmc_basket``).  Counters, as in ``mc_tpu``: step j of path ``id`` takes
the pairs ``(id, j*ceil(d/2) + q)``, q = 0..ceil(d/2)-1, whose halves are
z_{2q}, z_{2q+1} (an odd d drops the last).  Each wrapper takes its plain
PyTorch version below only when the parameter tensor lies on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import (STREAM_OUTER, finish_price, kernel_sums,
                                  resolve_device)
from mc_tpu_torch.models.merton import counters
from mc_tpu_torch.models.term import fma_f32, sqrt_f32
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops import _cuda, twin
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PathPayoff, get_payoff

__all__ = ["BasketDynamics", "demo_basket", "DEMO_BASKET", "MAX_BASKET_D",
           "BASKET_TAG", "HEAD_FIELDS", "BasketConfig", "chol_scalars",
           "packed_length", "pack_basket", "unpack_basket", "basket_normals",
           "mix_step", "levels", "basket_of", "partials_blocks",
           "basket_partials",
           "basket_partials_plain", "basket_trajectories",
           "basket_trajectories_plain", "qmc_pay", "price_basket"]

# rng.derive_key stream tag of the basket family (mc_tpu's 0xBA5C).
BASKET_TAG = 0xBA5C
# FamilyId of csrc/family.cuh.
FAMILY_BASKET = 8
# The largest basket (mc_tpu's bound, which its unrolled Cholesky mixing
# needs; the kernels here take any d up to it without a rebuild).
MAX_BASKET_D = 32

HEAD_FIELDS = ("k", "r", "t", "barrier", "p1", "p2", "dt", "inv_n_steps",
               "sqrt_dt", "s0")


@dataclasses.dataclass(frozen=True)
class BasketDynamics:
    """d-asset basket parameters, numpy f32: initial prices, volatilities,
    basket weights (signed allowed) and the (d, d) correlation matrix."""

    s0s: Any
    sigmas: Any
    weights: Any
    corr: Any

    @property
    def d(self) -> int:
        return int(np.shape(self.s0s)[0])

    def as_f32(self) -> "BasketDynamics":
        """numpy f32 fields; a field that carries a derivative stays a
        tensor (``greeks.rainbow_greeks`` and ``basket_greeks``)."""
        return BasketDynamics(*(
            v.to("cpu", torch.float32) if twin.carries_derivative(v)
            else np.asarray(v, np.float32)
            for v in (self.s0s, self.sigmas, self.weights, self.corr)))


def demo_basket(d: int = 4, rho: float = 0.5) -> BasketDynamics:
    """``mc_tpu``'s demo: d assets at 100, vols evenly from 15% to 30%,
    equal weights, pairwise correlation rho."""
    corr = np.full((d, d), rho, np.float32)
    np.fill_diagonal(corr, 1.0)
    return BasketDynamics(s0s=np.full(d, 100.0, np.float32),
                          sigmas=np.linspace(0.15, 0.3, d).astype(np.float32),
                          weights=np.full(d, 1.0 / d, np.float32), corr=corr)


DEMO_BASKET = demo_basket()


_f32 = twin.f32  # a tensor keeps its derivative


def _f32_array(v) -> torch.Tensor:
    """A basket field as an f32 CPU tensor (a tensor keeps its
    derivative)."""
    if torch.is_tensor(v):
        return v.to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def _check_d(d: int) -> None:
    if d > MAX_BASKET_D:
        raise ValueError(
            f"basket dimension d={d} exceeds MAX_BASKET_D={MAX_BASKET_D}: "
            "mc_tpu's unrolled Cholesky mixing compiles O(d^2) scalar FMAs "
            "per step and bounds d there; factor the basket")
    if d < 1:
        raise ValueError(f"a basket needs at least one asset; got d={d}")


def chol_scalars(cov: torch.Tensor, d: int) -> torch.Tensor:
    """The Banachiewicz Cholesky of a small SPD (d, d) f32 matrix, scalar
    by scalar in ``mc_tpu``'s order: acc = cov_ij, then acc - L_ik L_jk for
    k < j in order (one fused multiply-add each, as XLA's CPU backend
    contracts it), the diagonal sqrt(max(acc, 1e-30)), the rest acc /
    L_jj.  The lower triangle of a (d, d) f32 tensor."""
    _check_d(d)
    L = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            acc = cov[i][j]
            for k in range(j):
                acc = fma_f32(-L[i][k], L[j][k], acc)
            L[i][j] = (sqrt_f32(torch.clamp(acc, min=1e-30)) if i == j
                       else acc / L[j][j])
    zero = torch.zeros((), dtype=torch.float32)
    return torch.stack([torch.stack([zero if x is None else x for x in row])
                        for row in L])


def packed_length(d: int) -> int:
    """10 + 3d + d(d+1)/2: the head, s0s, weights, drifts, L's triangle."""
    return len(HEAD_FIELDS) + 3 * d + d * (d + 1) // 2


def pack_basket(option: OptionParams, basket: BasketDynamics, n_steps: int,
                device) -> torch.Tensor:
    """The packed f32 vector on ``device``, bitwise ``mc_tpu``'s jitted
    ``_pack_basket(_basket_namespace(...))``: each value in f32 in its
    order, with the fused multiply-adds XLA's CPU backend contracts its
    expressions into (``fma_f32``).  cov_ij = (sigma_i corr_ij) sigma_j off
    the diagonal; the jitter 1e-6 * mean(diag(cov)) in XLA's reduction order
    (the diagonal's products fused into the sum), each diagonal entry
    fma(sigma_i corr_ii, sigma_i, jitter) (at d = 1 the rounded product
    plus the jitter); b0 = sum(w * s0s) as a chain of
    fused multiply-adds; dt = t * (1/n) (XLA's rewrite of t / n);
    drift_i = fma(-(0.5 sigma_i), sigma_i, r - q) * dt."""
    b = basket.as_f32()
    d = b.d
    _check_d(d)
    sig, corr, s0s, w = (_f32_array(v) for v in (b.sigmas, b.corr, b.s0s,
                                                b.weights))
    offdiag = sig[:, None] * corr * sig[None, :]
    acc = torch.zeros((), dtype=torch.float32)
    for i in range(d):
        acc = fma_f32(sig[i] * corr[i, i], sig[i], acc)
    jitter = 1e-6 * (acc * (torch.tensor(1.0) / d))
    cov = [[offdiag[i, j] for j in range(d)] for i in range(d)]
    if d > 1:  # at d = 1 XLA adds the jitter to the rounded product
        for i in range(d):
            cov[i][i] = fma_f32(sig[i] * corr[i, i], sig[i], jitter)
    else:
        cov[0][0] = cov[0][0] + jitter
    L = chol_scalars(cov, d)
    _, t, k, r, _, barrier, p1, p2, q = (_f32(v) for v in option.astuple())
    inv_n = 1.0 / _f32(n_steps)
    dt = t * inv_n
    b0 = torch.zeros((), dtype=torch.float32)
    for i in range(d):
        b0 = fma_f32(w[i], s0s[i], b0)
    head = torch.stack([k, r, t, barrier, p1, p2, dt, inv_n, sqrt_f32(dt),
                        b0])
    drifts = torch.stack([fma_f32(-(0.5 * s), s, r - q) for s in sig]) * dt
    tri = L[torch.tril_indices(d, d).unbind()]
    return torch.cat([head, s0s, w, drifts, tri]).to(device)


def unpack_basket(params: torch.Tensor, d: int) -> SimpleNamespace:
    """The head fields by name (s0 = b0, sigma = k*0), s0s, weights and
    drifts as (d,) views and L as a (d, d) lower-triangular tensor."""
    h = len(HEAD_FIELDS)
    p = SimpleNamespace(**{f: params[i] for i, f in enumerate(HEAD_FIELDS)})
    p.d = d
    p.s0s = params[h:h + d]
    p.weights = params[h + d:h + 2 * d]
    p.drifts = params[h + 2 * d:h + 3 * d]
    p.chol = torch.zeros((d, d), dtype=torch.float32, device=params.device)
    rows, cols = torch.tril_indices(d, d, device=params.device)
    p.chol[rows, cols] = params[h + 3 * d:]
    p.sigma = p.k * 0.0  # mc_tpu's Pallas kernel: the bridge reads sigma 0
    return p


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (n,) vector shaped (n, 1, ...) to lead the dims of ``like``."""
    return v.reshape(v.shape[0], *(1,) * like.dim())


def basket_normals(k0: int, k1: int, ids, c, d: int, sign: float = 1.0):
    """The d normals of one step, (d, *ids.shape): pair q of counter ``c +
    q`` (an int, or an int64 tensor that broadcasts against ``ids``) gives
    z_{2q}, z_{2q+1}; negated when ``sign`` < 0."""
    npps = (d + 1) // 2
    q = _col(torch.arange(npps, dtype=torch.int64, device=ids.device), ids)
    z0, z1 = rng.normal_pair(k0, k1, ids, counters(ids, c + q))
    zs = torch.stack([z0, z1], dim=1).reshape(2 * npps, *z0.shape[1:])[:d]
    return -zs if sign < 0 else zs


def mix_step(p, ws, zs):
    """One step of the d log-moneyness values ``ws`` (d, ...) on the normals
    ``zs``: y_i = L_i0 z_0 + L_i1 z_1 + ... in k order, then (w_i +
    drift_i) + sqrt_dt * y_i (``mc_tpu``'s ``_basket_leg`` step,
    ``csrc/basket.cuh``)."""
    d = ws.shape[0]
    one = ws[0]
    y = _col(p.chol[:, 0], one) * zs[0]
    for k in range(1, d):
        y[k:] = y[k:] + _col(p.chol[k:, k], one) * zs[k]
    return ws + _col(p.drifts, one) + p.sqrt_dt * y


def levels(p, ws):
    """The asset prices s0_i * exp(w_i), (d, ...)."""
    return _col(p.s0s, ws[0]) * torch.exp(ws)


def basket_of(p, lv):
    """B = w_0 S_0 + w_1 S_1 + ... in i order from the levels ``lv``."""
    terms = _col(p.weights, lv[0]) * lv
    b = terms[0]
    for i in range(1, terms.shape[0]):
        b = b + terms[i]
    return b


def basket_leg(payoff: PathPayoff, p, normals, c, n_steps: int, ws, state,
               on_step=None, level=basket_of):
    """``n_steps`` steps from ``(ws, state)``, step u mixing the (d, ...)
    normals ``normals(c + u*ceil(d/2))`` (its pairs from that counter on):
    ``(ws, levels, b, state)`` after the last, b = ``level(p, levels)`` the
    level the payoff reads (the basket's weighted sum; the rainbow NMC's
    order statistic); ``on_step(u, lv, b, state)`` sees every step."""
    npps = (p.d + 1) // 2
    lv = b = None
    for u in range(n_steps):
        ws = mix_step(p, ws, normals(c + u * npps))
        lv = levels(p, ws)
        b = level(p, lv)
        state = payoff.update(state, b, p)
        if on_step is not None:
            on_step(u, lv, b, state)
    return ws, lv, b, state


# ---------------------------------------------------------------------------
# Kernel configuration and checks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BasketConfig:
    n_paths: int
    n_steps: int
    d: int
    antithetic: bool = False

    def __post_init__(self):
        _check_d(self.d)
        if not 0 < self.n_paths < 1 << 32:
            raise ValueError(f"n_paths must be in [1, 2^32); got {self.n_paths}")
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be positive; got {self.n_steps}")

    def path_config(self) -> pk.KernelConfig:
        """The path layout and stream of ``pk.path_chunks`` (threefry-13)."""
        return pk.KernelConfig(n_paths=self.n_paths, n_steps=self.n_steps)


def check_basket_params(params: torch.Tensor, d: int) -> None:
    want = packed_length(d)
    if (not torch.is_tensor(params) or params.dtype != torch.float32
            or params.shape != (want,) or not params.is_contiguous()
            or params.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"params must be a contiguous float32 ({want},) tensor "
            f"(pack_basket at d={d}) on the CPU or a CUDA device; got "
            f"{getattr(params, 'shape', None)} "
            f"{getattr(params, 'dtype', type(params))}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _pay(payoff: PathPayoff, cfg: BasketConfig, p, like, normals,
         on_step=None):
    """Each path's payoff (the antithetic pair's mean when
    ``cfg.antithetic``: a second leg on the negated normals);
    ``normals(c, sign)`` gives the step's d normals from pair c on."""
    zero = torch.zeros_like(like)
    pays = []
    for sign in ((1.0, -1.0) if cfg.antithetic else (1.0,)):
        ws = zero.expand(cfg.d, *zero.shape)
        _, _, b, state = basket_leg(
            payoff, p, lambda c, sign=sign: normals(c, sign), 0, cfg.n_steps,
            ws, payoff.init(p, zero), on_step if sign > 0 else None)
        pays.append(payoff.terminal(state, b, p))
    return pays[0] if len(pays) == 1 else 0.5 * (pays[0] + pays[1])


def _threefry_normals(p, k0: int, k1: int, ids):
    """``normals(c, sign)``: basket_normals on the MC stream."""
    return lambda c, sign: basket_normals(k0, k1, ids, c, p.d, sign)


def qmc_pay(payoff: PathPayoff, p, n_steps: int, like, draw_pair):
    """The leg on a randomized-QMC draw: step j's d normals from pairs
    j*ceil(d/2) + q, dimensions (2(j ceil(d/2) + q), +1), the last pair's
    second normal unused at an odd d."""
    def normals(c, sign):
        zs = [z for q in range((p.d + 1) // 2) for z in draw_pair(c + q)]
        return torch.stack(zs[:p.d])

    return _pay(payoff, BasketConfig(n_paths=1, n_steps=n_steps, d=p.d), p,
                like, normals)


def basket_partials_plain(payoff: PathPayoff, cfg: BasketConfig, key,
                          params: torch.Tensor, path_offset: int = 0,
                          n_valid=None):
    """Plain version of the basket_partials kernel: (chunks, 2) f64
    [sum pay, sum pay^2] over paths ``path_offset + i``, those at or past
    the bound (default: the end of the run) adding zeros."""
    p = unpack_basket(params, cfg.d)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    rows = []
    for _, _, ids, valid, _ in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound,
            pk.plain_chunk(params)):
        pay = torch.where(valid, _pay(payoff, cfg, p, ids.float(),
                                      _threefry_normals(p, k0, k1, ids)), 0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return torch.stack(rows)


def basket_trajectories_plain(payoff: PathPayoff, cfg: BasketConfig, key,
                              params: torch.Tensor, path_offset: int = 0,
                              n_valid=None):
    """Plain version of the basket_trajectories kernel: ``(b_grid,
    state_grid, partials)``, the grids ``(n_steps, n_paths)`` f32 after
    step j+1 (state word 0, zeros for a payoff without state), the partials
    (chunks, 2) f64 [sum pay, sum pay^2]."""
    p = unpack_basket(params, cfg.d)
    k0, k1 = int(key[0]), int(key[1])
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    shape = (cfg.n_steps, cfg.n_paths)
    b_grid = torch.empty(shape, dtype=torch.float32, device=params.device)
    st_grid = torch.zeros_like(b_grid)
    rows = []
    for start, stop, ids, valid, _ in pk.path_chunks(
            cfg.path_config(), key, params, path_offset, bound,
            pk.plain_chunk(params)):
        def store(j, lv, b, state, start=start, stop=stop):
            b_grid[j, start:stop] = b
            if payoff.n_state:
                st_grid[j, start:stop] = state[0]

        pay = torch.where(valid, _pay(payoff, cfg, p, ids.float(),
                                      _threefry_normals(p, k0, k1, ids), store),
                          0.0)
        rows.append(pk.moment_row([pay, pay * pay]))
    return b_grid, st_grid, torch.stack(rows)


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def partials_blocks(n_paths: int, block_paths: int) -> int:
    """The partials kernel's blocks: block b sums paths b*block_paths ..
    b*block_paths + block_paths-1 (the library's paths a block), capped at
    MAX_BLOCKS, past which the blocks grid-stride."""
    return min(_cuda.cdiv(n_paths, block_paths), _cuda.MAX_BLOCKS)


def basket_partials(payoff: PathPayoff, cfg: BasketConfig, key,
                    params: torch.Tensor, path_offset: int = 0, n_valid=None):
    """(rows, 2) f64 [sum pay, sum pay^2] of ``cfg.n_paths`` basket paths
    (global ids ``path_offset + i``, masked at ``n_valid``, default the end
    of the run); ``params`` from ``pack_basket`` at ``cfg.d``."""
    check_basket_params(params, cfg.d)
    if params.device.type == "cpu":
        return basket_partials_plain(payoff, cfg, key, params, path_offset,
                                     n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = partials_blocks(cfg.n_paths, lib.mc_basket_block_paths())
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_basket_partials(
            payoff.cuda_id, int(cfg.antithetic), int(key[0]), int(key[1]),
            params.data_ptr(), cfg.d, cfg.n_steps, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound, partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "basket_partials kernel")
    _cuda.count_launch("basket_partials")
    return partials


def basket_trajectories(payoff: PathPayoff, cfg: BasketConfig, key,
                        params: torch.Tensor, path_offset: int = 0,
                        n_valid=None):
    """Materialize the (basket level, payoff state) grids that ``mc_tpu``'s
    basket LSMC reads: ``(b_grid, state_grid, partials)``, the grids
    ``(n_steps, n_paths)`` f32 step-major (entry [j, i] after step j+1 of
    path i), the partials ``(rows, 2)`` f64.  Without an antithetic twin,
    as in ``mc_tpu``."""
    check_basket_params(params, cfg.d)
    if payoff.n_state > 1:
        raise ValueError("the trajectories kernel stores one state array")
    if cfg.antithetic:
        raise ValueError("basket_trajectories runs without an antithetic "
                         "twin")
    if params.device.type == "cpu":
        return basket_trajectories_plain(payoff, cfg, key, params,
                                         path_offset, n_valid)
    bound = pk._bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = partials_blocks(cfg.n_paths,
                               lib.mc_basket_trajectories_block_paths())
    grids = torch.empty((2, cfg.n_steps, cfg.n_paths), dtype=torch.float32,
                        device=params.device)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_basket_trajectories(
            payoff.cuda_id, int(key[0]), int(key[1]), params.data_ptr(),
            cfg.d, cfg.n_steps, cfg.n_paths, path_offset & 0xFFFFFFFF, bound,
            grids[0].data_ptr(), grids[1].data_ptr(), partials.data_ptr(),
            n_blocks, _cuda.stream_handle(params.device))
    _cuda.check(status, "basket_trajectories kernel")
    _cuda.count_launch("basket_trajectories")
    return grids[0], grids[1], partials


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def price_basket(option: OptionParams = DEMO_OPTION,
                 basket: BasketDynamics = DEMO_BASKET,
                 sim: SimParams = DEMO_SIM,
                 payoff="vanilla_call",
                 *,
                 antithetic: bool = False,
                 stream: int = STREAM_OUTER,
                 key=None,
                 device="cuda") -> PriceResult:
    """Monte Carlo price of an option on a correlated d-asset basket on
    ``device``: every payoff on the basket level B_t, discounted at
    e^{-rT}.  ``key``: a (k0, k1) pair; default ``rng.derive_key(sim.seed,
    stream, 0xBA5C)``, the stream ``mc_tpu.price_basket`` draws
    (threefry-13).  As in ``mc_tpu``, the payoff is not validated.  The
    moment sums finish in f64."""
    po = get_payoff(payoff)
    b32 = basket.as_f32()
    if key is None:
        key = rng.derive_key(sim.seed, stream, BASKET_TAG)
    cfg = BasketConfig(n_paths=sim.n_paths, n_steps=sim.n_steps, d=b32.d,
                       antithetic=antithetic)
    dev = resolve_device(device)
    params = pack_basket(option, b32, sim.n_steps, dev)
    key = (int(key[0]), int(key[1]))
    # basket fields that require grad (greeks.basket_greeks): the kernel's
    # value, the plain version's gradient
    sums = kernel_sums(
        params, lambda prm: basket_partials(po, cfg, key, prm),
        lambda prm, off, n: basket_partials_plain(
            po, dataclasses.replace(cfg, n_paths=n), key, prm, off,
            sim.n_paths),
        sim.n_paths, sim.n_steps * b32.d)
    return finish_price(sums, sim.n_paths, option)
