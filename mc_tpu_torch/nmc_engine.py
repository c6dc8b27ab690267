"""The generic nested-Monte-Carlo engine over a model-family protocol
(port of ``mc_tpu/nmc_engine.py:59-249,251-277,445-488,543-675``).

A family supplies its physics through `NMCFamily` (parameter packing, its
integer ``extras``, the trajectories that store its outer state grids, the
plain inner leg and its discounting); the engine owns the rest: the entry
guards, the keys, the f32 Kahan inner sum and the two strategies.  Heston,
Merton, Bates, CEV, local vol, SABR, term structures, Vasicek (pathwise
discounting: a per-point scale from its own grid) and the basket (d asset
grids, d a runtime value up to 32) and the rainbow (the basket's grids
with an order-statistic level) are registered: every adapter of ``mc_tpu``'s
``FAMILY_MODULES``.

Three kernel templates over a device-side family struct (``csrc/family.cuh``;
each family's instantiations compiled in its own source, the entry points
in ``csrc/family_nmc_kernels.cu``):

* ``family_inner`` (replaces ``family_inner_kernel``,
  ``mc_tpu/nmc_engine.py:314``): the grid strategy, over the grids the
  family's trajectories kernel stored;
* ``family_fused`` (replaces ``family_fused_kernel``,
  ``mc_tpu/nmc_engine.py:407``): recomputes each outer path itself;
* ``family_trajectories``: stores the outer grids of every family (under
  Heston, Merton, local vol and Vasicek it replaces ``mc_tpu``'s
  trajectories kernels, ``models/heston.py:527``, ``models/merton.py:392``,
  ``models/localvol.py:406``, ``models/vasicek.py:405``; under Bates, CEV,
  SABR, term, the basket and the rainbow ``mc_tpu``'s XLA scan
  ``xla_family_trajectories``), stepping
  the family's outer step, the fused kernel's (on a small outer grid its
  draws split off to warps of their own), so the grid and fused strategies
  agree.

The wrappers compute each call's launch geometry on the host
(``family_launch``: the point's legs in groups of the family's ``legs``,
its struct's kLegs; the packed parameters staged in shared memory when
they fit ``FAMILY_SMEM_BUDGET``, else read where they lie) and pass it to
the entry points, which refuse a geometry that does not fit.

For outer path i and step j, surface[j, i] = point_scale * (1/n_inner) *
the f32 Kahan sum over m = 0..n_inner-1, in that order, of inner leg m
resumed from the state after step j+1, its substep u drawing on counter
``((j+1)*n_inner + m) * counter_stride + u`` of the inner key.  ``mc_tpu``
makes that order part of its bitwise contract (``family_point_tile``,
``mc_tpu/nmc_engine.py:251-277``), so the engine keeps its Kahan sum where
the port's GBM NMC (``ops/nmc_kernels.py``) sums in f64.  Each wrapper takes
its plain PyTorch version only when the parameter tensor lies on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib
import math
from typing import Any, Callable, Dict

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER, resolve_device
from mc_tpu_torch.nmc import NMCResult
from mc_tpu_torch.oracle import summarize
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops.path_kernels import (KernelConfig, _bound, moment_row,
                                           path_chunks)
from mc_tpu_torch.ops.payoffs import PathPayoff, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["NMCFamily", "FamilyConfig", "FamilyLaunch", "family_launch",
           "FAMILY_SMEM_BUDGET", "family_occupancy", "family_point_sum_plain",
           "family_rows_plain", "family_inner", "family_inner_plain",
           "family_fused", "family_fused_plain", "family_trajectories",
           "family_trajectories_plain", "launch_family_trajectories",
           "family_trajectories_layout",
           "price_nmc_family", "NMC_FAMILIES", "NMC_FAMILY_BUILDERS",
           "register_nmc_family", "ensure_family"]

# Inner-leg elements (inner paths x outer paths) per block of the plain
# version: bounds its temporaries.
PLAIN_INNER_ELEMS = 1 << 20

# The dynamic shared memory a block of the fused and inner kernels may take
# for its staged pack and table, in bytes (csrc/family.cuh
# kFamilySmemBudget, which refuses more).
FAMILY_SMEM_BUDGET = 12 * 1024

_MASK = 0xFFFFFFFF


class NMCFamily:
    """Per-family physics consumed by the engine.  A family overrides the
    class attributes and the methods below; ``cuda_id`` names its struct in
    ``csrc/family.cuh`` (FamilyId).  ``extras`` are the family's integer
    specializations of one call (Merton's and Bates's Poisson scan depth,
    local vol's knot count, the basket's d), passed to the kernels by value
    (at most four)."""

    name = "?"
    tag = 0            # rng.derive_key stream tag (that of price_<model>)
    n_grids = 1        # market-state grids, S first
    even_steps = True  # a pair-consuming outer loop needs even n_steps
    cuda_id = -1
    legs = 1           # inner legs a thread runs at once (its struct's kLegs)

    def __init__(self, extras: tuple = ()):
        self.extras = tuple(int(x) for x in extras)

    def span(self, n_steps: int, n_inner: int):
        """(largest inner counter, formula) for the counter-wrap guard."""
        raise NotImplementedError

    def pack(self, option, dyn, n_steps: int, device) -> torch.Tensor:
        raise NotImplementedError

    def unpack(self, params: torch.Tensor):
        raise NotImplementedError

    def check_params(self, params: torch.Tensor, n_steps: int) -> None:
        """Refuse a parameter tensor the kernels of an ``n_steps`` run
        cannot read."""
        raise NotImplementedError

    def counter_stride(self, n_steps: int) -> int:
        """Counters one inner leg may draw."""
        return n_steps

    def table_floats(self) -> int:
        """Floats of the family's per-block table in the kernels' shared
        memory, after the staged pack (Merton's and Bates's Poisson cdf)."""
        return 0

    def point_scale(self, p, grids_j):
        """Per-point factor on the inner mean: the full e^{-rT} (f32), as
        the reference's nmc.cuh:100-104."""
        return torch.exp(-p.r * p.t)

    def outer_discount(self, p) -> float:
        """The outer price's discount, e^{-rT} in f64 from the f32 fields
        (``engines.finish_price``'s)."""
        return math.exp(-float(p.r) * float(p.t))

    def trajectories(self, payoff, cfg, key, params, path_offset=0,
                     n_valid=None):
        """The outer paths on ``key``: ``(*market_grids, state_grid,
        partials)``, grids ``(n_steps, n_paths)`` f32 step-major, partials
        ``(rows, 2)`` f64 [sum pay, sum pay^2].  Default: the generic
        ``family_trajectories`` kernel over the family's outer step; a
        family with a trajectories kernel of its own overrides it."""
        return family_trajectories(self, payoff, cfg, key, params,
                                   path_offset, n_valid)

    def trajectories_plain(self, payoff, cfg, key, params, path_offset=0,
                           n_valid=None):
        return family_trajectories_plain(self, payoff, cfg, key, params,
                                         path_offset, n_valid)

    # The plain outer path of the default trajectories (mc_tpu's
    # outer_init/outer_block/outer_pay, one step a block): tensors shaped
    # like the path ids.
    def outer_init(self, payoff: PathPayoff, p, like):
        """The outer carry at t = 0 (it holds the payoff state)."""
        raise NotImplementedError

    def outer_draws(self, k0: int, k1: int, ids, steps):
        """The outer key's draws of the steps ``steps`` (an int64 tensor of
        step indices leading the dims of ``ids``): a tuple of tensors (or of
        sequences that draw on indexing) whose index [j] is step j's
        draws."""
        raise NotImplementedError

    def outer_step(self, payoff: PathPayoff, p, carry, draws):
        """One outer step from ``carry`` on its ``draws``: ``(carry,
        (*market_rows, state_word_0))``."""
        raise NotImplementedError

    def outer_pay(self, payoff: PathPayoff, p, carry):
        """The outer path's payoff from its final carry."""
        raise NotImplementedError

    def leg(self, payoff: PathPayoff, p, k0: int, k1: int, ids, c_base,
            remaining: int, grids_j, state_j):
        """The plain inner legs resumed from the grid rows ``grids_j`` and
        payoff state ``state_j`` (tensors shaped like ``ids``): ``remaining``
        substeps, substep u on counters ``(ids, c_base + u)``; the terminal
        payoffs."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FamilyConfig:
    n_paths: int   # outer paths
    n_steps: int
    n_inner: int   # inner paths per point

    def __post_init__(self):
        if self.n_paths < 1 or self.n_steps < 1 or self.n_inner < 1:
            raise ValueError("n_paths, n_steps and n_inner must be positive")
        if self.n_paths >= 1 << 32:
            raise ValueError("n_paths must be below 2^32 (uint32 path ids)")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def family_point_sum_plain(fam: NMCFamily, payoff: PathPayoff,
                           cfg: FamilyConfig, p, key_inner, ids, j: int,
                           grids_j, state_j):
    """The f32 Kahan sum over the n_inner legs, m = 0..n_inner-1 in order,
    resumed from the state after step j+1 (one per path of ``ids``): the
    order of ``mc_tpu``'s ``family_point_tile``."""
    k0, k1 = int(key_inner[0]), int(key_inner[1])
    remaining = cfg.n_steps - j - 1
    stride = fam.counter_stride(cfg.n_steps)
    acc = torch.zeros_like(grids_j[0])
    comp = torch.zeros_like(acc)
    per_block = max(1, PLAIN_INNER_ELEMS // max(ids.numel(), 1))
    for m0 in range(0, cfg.n_inner, per_block):
        m = torch.arange(m0, min(m0 + per_block, cfg.n_inner),
                         dtype=torch.int64, device=ids.device)[:, None]
        c_base = (((j + 1) * cfg.n_inner + m) * stride) & _MASK
        ids2 = ids.expand(m.shape[0], -1)
        pays = fam.leg(payoff, p, k0, k1, ids2, c_base,
                       remaining, tuple(g.expand_as(ids2) for g in grids_j),
                       tuple(a.expand_as(ids2) for a in state_j))
        for pay in pays:  # Kahan, in the order of m
            y = pay - comp
            t = acc + y
            comp = (t - acc) - y
            acc = t
    return acc


def family_rows_plain(fam: NMCFamily, payoff: PathPayoff, cfg: FamilyConfig,
                      key_inner, params: torch.Tensor, grids, state_grid,
                      steps, path_offset: int = 0, n_valid=None):
    """Rows ``steps`` of the plain surface, ``(len(steps), n_paths)`` f32,
    from the stored grids."""
    p = fam.unpack(params)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    ids = (torch.arange(cfg.n_paths, dtype=torch.int64, device=params.device)
           + path_offset) & _MASK
    valid = ids < bound
    inv_n = torch.tensor(1.0 / cfg.n_inner, dtype=torch.float32,
                         device=params.device)
    rows = []
    for j in steps:
        grids_j = tuple(g[j] for g in grids)
        state_j = (state_grid[j],) if payoff.n_state else ()
        acc = family_point_sum_plain(fam, payoff, cfg, p, key_inner, ids, j,
                                     grids_j, state_j)
        v = acc * inv_n * fam.point_scale(p, grids_j)
        rows.append(torch.where(valid, v, 0.0))
    return torch.stack(rows)


def family_inner_plain(fam: NMCFamily, payoff: PathPayoff, cfg: FamilyConfig,
                       key_inner, params: torch.Tensor, grids, state_grid,
                       path_offset: int = 0, n_valid=None):
    """Plain version of the family_inner kernel: the surface
    ``(n_steps, n_paths)`` f32."""
    return family_rows_plain(fam, payoff, cfg, key_inner, params, grids,
                             state_grid, range(cfg.n_steps), path_offset,
                             n_valid)


def family_trajectories_plain(fam: NMCFamily, payoff: PathPayoff,
                              cfg: FamilyConfig, key, params: torch.Tensor,
                              path_offset: int = 0, n_valid=None):
    """Plain version of the family_trajectories kernel: ``(*market_grids,
    state_grid, partials)`` from the family's plain outer hooks, the grids
    ``(n_steps, n_paths)`` f32 after step j+1 (state word 0, zeros for a
    payoff without state), the partials (chunks, 2) f64."""
    p = fam.unpack(params)
    k0, k1 = int(key[0]), int(key[1])
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    shape = (cfg.n_steps, cfg.n_paths)
    grids = [torch.empty(shape, dtype=torch.float32, device=params.device)
             for _ in range(fam.n_grids)]
    st_grid = torch.zeros(shape, dtype=torch.float32, device=params.device)
    rows = []
    layout = KernelConfig(n_paths=cfg.n_paths, n_steps=cfg.n_steps)
    for start, stop, ids, valid, _ in path_chunks(layout, key, params,
                                                  path_offset, bound):
        carry = fam.outer_init(payoff, p, ids.float())
        steps = torch.arange(cfg.n_steps, dtype=torch.int64,
                             device=ids.device)[:, None]
        draws = fam.outer_draws(k0, k1, ids, steps)  # every step at once
        for j in range(cfg.n_steps):
            carry, (*market, word0) = fam.outer_step(
                payoff, p, carry, tuple(d[j] for d in draws))
            for g, row in zip(grids, market):
                g[j, start:stop] = row
            if payoff.n_state:
                st_grid[j, start:stop] = word0
        pay = torch.where(valid, fam.outer_pay(payoff, p, carry), 0.0)
        rows.append(moment_row([pay, pay * pay]))
    return (*grids, st_grid, torch.stack(rows))


def family_fused_plain(fam: NMCFamily, payoff: PathPayoff, cfg: FamilyConfig,
                       key_outer, key_inner, params: torch.Tensor,
                       path_offset: int = 0, n_valid=None):
    """Plain version of the family_fused kernel: ``(surface, outer
    partials)``.  The fused kernel recomputes in registers the outer states
    the trajectories kernel stores, so its plain version is the two plain
    stages of the grid strategy."""
    *grids, state_grid, outer = fam.trajectories_plain(
        payoff, cfg, key_outer, params, path_offset, n_valid)
    return family_inner_plain(fam, payoff, cfg, key_inner, params, grids,
                              state_grid, path_offset, n_valid), outer


# ---------------------------------------------------------------------------
# Launch geometry of the fused and inner kernels
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FamilyLaunch:
    """How one call of the fused or inner kernel runs: each point's legs in
    ``groups`` groups of ``legs`` (the last group holds ``last_legs``, the
    others past n_inner run and are not added), and the block's dynamic
    shared memory: the pack's first ``stage_floats`` floats (all of them, or
    0 where the pack is over the budget and is read where it lies) and the
    family's table."""
    legs: int
    groups: int
    last_legs: int
    stage_floats: int
    table_floats: int

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.stage_floats + self.table_floats)

    @property
    def staged(self) -> bool:
        """The route: the pack staged in shared memory, or read in place."""
        return self.stage_floats > 0


def family_launch(fam: NMCFamily, n_inner: int, n_pack: int) -> FamilyLaunch:
    """The launch geometry of family ``fam`` at ``n_inner`` inner legs a
    point and a packed parameter vector of ``n_pack`` floats: the pack is
    staged when it fits FAMILY_SMEM_BUDGET beside the family's table."""
    legs, table = fam.legs, fam.table_floats()
    if 4 * table > FAMILY_SMEM_BUDGET:
        raise ValueError(f"{fam.name}'s table of {table} floats is over the "
                         f"{FAMILY_SMEM_BUDGET}-byte shared budget")
    groups = -(-n_inner // legs)
    stage = n_pack if 4 * (n_pack + table) <= FAMILY_SMEM_BUDGET else 0
    return FamilyLaunch(legs=legs, groups=groups,
                        last_legs=n_inner - (groups - 1) * legs,
                        stage_floats=stage, table_floats=table)


def family_trajectories_layout(fam: NMCFamily, payoff: PathPayoff,
                               n_paths: int) -> dict:
    """The trajectories kernel of ``fam`` for ``payoff`` on ``n_paths``
    outer paths on the current card: its blocks, threads a block (128
    advance lanes, and the draw warps where the grid has at most the
    family's kTrajSplitBlocks blocks an SM), dynamic shared bytes and
    resident blocks per SM."""
    lib = _cuda.load()
    ex = _cuda.family_extras(fam.extras)
    n_blocks = min(_cuda.cdiv(n_paths, lib.mc_family_trajectories_block_paths()),
                   _cuda.MAX_BLOCKS)
    threads, smem, blocks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _cuda.check(lib.mc_family_trajectories_geometry(
        fam.cuda_id, ex, n_blocks, ctypes.addressof(threads),
        ctypes.addressof(smem)), "family_trajectories_geometry")
    _cuda.check(lib.mc_family_trajectories_occupancy(
        fam.cuda_id, payoff.cuda_id, ex, n_blocks, ctypes.addressof(blocks)),
        "family_trajectories_occupancy")
    return dict(n_blocks=n_blocks, threads=threads.value,
                smem_bytes=smem.value, blocks_per_sm=blocks.value)


def family_occupancy(fam: NMCFamily, payoff: PathPayoff, fused: bool,
                     smem_bytes: int) -> int:
    """Resident blocks per SM of ``fam``'s fused or inner kernel for
    ``payoff`` at ``smem_bytes`` of dynamic shared memory, on the current
    card (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _cuda.load()
    blocks = ctypes.c_int(0)
    _cuda.check(lib.mc_family_occupancy(
        fam.cuda_id, payoff.cuda_id, _cuda.family_extras(fam.extras),
        int(fused), smem_bytes, ctypes.addressof(blocks)),
        "family_occupancy")
    return blocks.value


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def _check(fam: NMCFamily, payoff: PathPayoff, params: torch.Tensor,
           cfg: FamilyConfig) -> None:
    fam.check_params(params, cfg.n_steps)
    if payoff.n_state > 1:
        raise ValueError("NMC supports payoffs with at most one state array")


def _check_grid(name: str, g, cfg: FamilyConfig, device) -> None:
    if (not torch.is_tensor(g) or g.dtype != torch.float32
            or g.shape != (cfg.n_steps, cfg.n_paths)
            or not g.is_contiguous() or g.device != device):
        raise ValueError(
            f"{name} must be a contiguous float32 tensor of shape "
            f"({cfg.n_steps}, {cfg.n_paths}) on {device}; got "
            f"{getattr(g, 'shape', None)} {getattr(g, 'dtype', type(g))}")


def family_inner(fam: NMCFamily, payoff: PathPayoff, cfg: FamilyConfig,
                 key_inner, params: torch.Tensor, grids, state_grid,
                 path_offset: int = 0, n_valid=None):
    """Grid-strategy family NMC over the stored outer grids (``fam.n_grids``
    market grids and the payoff's state grid, each ``(n_steps, n_paths)``
    f32 on the params' device, as ``fam.trajectories`` returns them): the
    surface ``(n_steps, n_paths)`` f32."""
    _check(fam, payoff, params, cfg)
    grids = tuple(grids)
    if len(grids) != fam.n_grids:
        raise ValueError(f"{fam.name} has {fam.n_grids} market grids; got "
                         f"{len(grids)}")
    for k, g in enumerate(grids):
        _check_grid(f"grids[{k}]", g, cfg, params.device)
    _check_grid("state_grid", state_grid, cfg, params.device)
    if params.device.type == "cpu":
        return family_inner_plain(fam, payoff, cfg, key_inner, params, grids,
                                  state_grid, path_offset, n_valid)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    geo = family_launch(fam, cfg.n_inner, params.numel())
    lib = _cuda.load()
    surface = torch.empty((cfg.n_steps, cfg.n_paths), dtype=torch.float32,
                          device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_family_inner(
            fam.cuda_id, payoff.cuda_id, int(key_inner[0]), int(key_inner[1]),
            params.data_ptr(), _cuda.family_extras(fam.extras), cfg.n_steps,
            cfg.n_inner, geo.groups, geo.stage_floats, cfg.n_paths,
            path_offset & _MASK, bound,
            _cuda.pointer_array(grids),
            len(grids), state_grid.data_ptr(), surface.data_ptr(),
            _cuda.stream_handle(params.device))
    _cuda.check(status, "family_inner kernel")
    _cuda.count_launch("family_inner")
    return surface


def family_fused(fam: NMCFamily, payoff: PathPayoff, cfg: FamilyConfig,
                 key_outer, key_inner, params: torch.Tensor,
                 path_offset: int = 0, n_valid=None):
    """Fused family NMC: ``(surface (n_steps, n_paths) f32, outer (rows, 2)
    f64)``, no outer grids kept anywhere."""
    _check(fam, payoff, params, cfg)
    if params.device.type == "cpu":
        return family_fused_plain(fam, payoff, cfg, key_outer, key_inner,
                                  params, path_offset, n_valid)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    geo = family_launch(fam, cfg.n_inner, params.numel())
    lib = _cuda.load()
    tiles = _cuda.cdiv(cfg.n_paths, lib.mc_family_block_threads())
    surface = torch.empty((cfg.n_steps, cfg.n_paths), dtype=torch.float32,
                          device=params.device)
    outer = torch.empty((tiles, 2), dtype=torch.float64, device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_family_fused(
            fam.cuda_id, payoff.cuda_id, int(key_outer[0]), int(key_outer[1]),
            int(key_inner[0]), int(key_inner[1]), params.data_ptr(),
            _cuda.family_extras(fam.extras), cfg.n_steps, cfg.n_inner,
            geo.groups, geo.stage_floats, cfg.n_paths, path_offset & _MASK,
            bound, surface.data_ptr(),
            outer.data_ptr(),
            _cuda.stream_handle(params.device))
    _cuda.check(status, "family_fused kernel")
    _cuda.count_launch("family_fused")
    return surface, outer


def launch_family_trajectories(family_id: int, n_grids: int, extras, payoff,
                               n_paths: int, n_steps: int, key,
                               params: torch.Tensor, path_offset: int = 0,
                               n_valid=None):
    """Launch family_trajectories_kernel for family ``family_id`` on the
    card (the caller checks and counts): ``(*market_grids, state_grid,
    partials)``, a partials row per block of the kernel's paths a block
    (``mc_family_trajectories_block_paths``)."""
    bound = _bound(path_offset, n_paths, n_valid)
    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(n_paths,
                              lib.mc_family_trajectories_block_paths()),
                   _cuda.MAX_BLOCKS)
    out = torch.empty((n_grids + 1, n_steps, n_paths), dtype=torch.float32,
                      device=params.device)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_family_trajectories(
            family_id, payoff.cuda_id, int(key[0]), int(key[1]),
            params.data_ptr(), _cuda.family_extras(extras), n_steps, n_paths,
            path_offset & _MASK, bound, _cuda.pointer_array(out[:n_grids]),
            n_grids, out[n_grids].data_ptr(), partials.data_ptr(), n_blocks,
            _cuda.stream_handle(params.device))
    _cuda.check(status, "family_trajectories kernel")
    return (*out, partials)


def family_trajectories(fam: NMCFamily, payoff: PathPayoff, cfg: FamilyConfig,
                        key, params: torch.Tensor, path_offset: int = 0,
                        n_valid=None):
    """The outer grids of family ``fam`` on ``key`` through the generic
    trajectories kernel: ``(*market_grids, state_grid, partials)``, the
    grids ``(n_steps, n_paths)`` f32 step-major, the partials ``(rows, 2)``
    f64 [sum pay, sum pay^2]."""
    _check(fam, payoff, params, cfg)
    if params.device.type == "cpu":
        return family_trajectories_plain(fam, payoff, cfg, key, params,
                                         path_offset, n_valid)
    out = launch_family_trajectories(fam.cuda_id, fam.n_grids, fam.extras,
                                     payoff, cfg.n_paths, cfg.n_steps, key,
                                     params, path_offset, n_valid)
    _cuda.count_launch("family_trajectories")
    return out


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def _validate_and_keys(fam: NMCFamily, sim: SimParams, payoff,
                       stream_outer: int, stream_inner: int):
    """The entry guards and the family's keys ``derive_key(seed, stream,
    tag)`` (``mc_tpu/nmc_engine.py:592-611``)."""
    po = get_payoff(payoff)
    if po.n_state > 1:
        raise ValueError("NMC supports payoffs with at most one state array")
    if fam.even_steps and sim.n_steps % 2:
        raise ValueError(f"{fam.name} requires an even n_steps "
                         "(pair-consuming outer loop)")
    span, desc = fam.span(sim.n_steps, sim.n_paths_inner)
    if span >= 1 << 32:
        raise ValueError(
            f"inner RNG counter space exhausted: {desc} = {span} >= 2^32; "
            "reduce n_steps or n_paths_inner")
    keys = [rng.derive_key(sim.seed, s, fam.tag)
            for s in (stream_outer, stream_inner)]
    return po, *((int(k[0]), int(k[1])) for k in keys)


def price_nmc_family(fam: NMCFamily,
                     option: OptionParams,
                     dyn,
                     sim: SimParams,
                     payoff="vanilla_call",
                     *,
                     strategy: str = "grid",
                     stream_outer: int = STREAM_OUTER,
                     stream_inner: int = STREAM_INNER,
                     device="cuda") -> NMCResult:
    """Nested MC surface under family ``fam`` on ``device``.

    ``strategy``: "grid" stores the outer grids (the family's trajectories
    kernel) and re-prices them (``family_inner``); the result carries grid 0
    (the spot) as ``spot_surface``.  "fused" runs ``family_fused``, which
    recomputes the outer paths.  Both give bitwise equal surfaces.
    """
    po, key_outer, key_inner = _validate_and_keys(fam, sim, payoff,
                                                  stream_outer, stream_inner)
    if strategy not in ("fused", "grid"):
        raise ValueError(f"unknown strategy {strategy!r}; use 'fused' or "
                         "'grid'")
    dev = resolve_device(device)
    cfg = FamilyConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                       n_inner=sim.n_paths_inner)
    params = fam.pack(option, dyn, sim.n_steps, dev)
    spot = None
    if strategy == "fused":
        surface, outer_partials = family_fused(fam, po, cfg, key_outer,
                                               key_inner, params)
    else:
        *grids, state_grid, outer_partials = fam.trajectories(
            po, cfg, key_outer, params)
        surface = family_inner(fam, po, cfg, key_inner, params, grids,
                               state_grid)
        spot = grids[0]  # every family's grid 0 is the market spot
    sums = finish_sum(outer_partials)
    outer = summarize(sums[0], sums[1], float(sim.n_paths),
                      fam.outer_discount(fam.unpack(params)))
    n_points = sim.n_paths * sim.n_steps
    return NMCResult(surface=surface, outer=outer,
                     surface_mean=surface.double().sum() / n_points,
                     n_points=n_points, t_horizon=float(option.t),
                     spot_surface=spot)


# name -> price_nmc_<model>, filled by the family modules when imported
# (the CLI's `nmc --model` dispatch reads it after ensure_family);
# NMC_FAMILY_BUILDERS: name -> builder(option, dyn, sim) -> (family, dyn32),
# the family instance with its extras for a call.
NMC_FAMILIES: Dict[str, Callable[..., Any]] = {}
NMC_FAMILY_BUILDERS: Dict[str, Callable[..., Any]] = {}
# name -> the module that registers it.
FAMILY_MODULES = {"heston": "mc_tpu_torch.nmc_heston",
                  "merton": "mc_tpu_torch.nmc_merton",
                  "bates": "mc_tpu_torch.nmc_bates",
                  "cev": "mc_tpu_torch.nmc_cev",
                  "localvol": "mc_tpu_torch.nmc_localvol",
                  "sabr": "mc_tpu_torch.nmc_sabr",
                  "term": "mc_tpu_torch.nmc_term",
                  "vasicek": "mc_tpu_torch.nmc_vasicek",
                  "basket": "mc_tpu_torch.nmc_basket",
                  "rainbow": "mc_tpu_torch.nmc_rainbow"}


def register_nmc_family(name: str, price_fn, builder=None) -> None:
    NMC_FAMILIES[name] = price_fn
    if builder is not None:
        NMC_FAMILY_BUILDERS[name] = builder


def ensure_family(name: str) -> None:
    """Import the module that registers family ``name``; a name without an
    adapter raises."""
    if name not in FAMILY_MODULES:
        raise ValueError(
            f"model family {name!r} has no nested-MC adapter (mc_tpu has "
            f"none either); the families: {sorted(FAMILY_MODULES)}")
    importlib.import_module(FAMILY_MODULES[name])
