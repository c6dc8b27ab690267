"""Nested Monte Carlo kernels: wrappers, plain versions, configuration
(port of ``mc_tpu/ops/nmc_kernels.py:55-186``).

Two kernels in ``csrc/nmc_kernels.cu`` compute one surface:

* ``nmc_fused`` replaces the fused Pallas kernel at
  ``mc_tpu/ops/nmc_kernels.py:264``: it recomputes the outer paths itself;
* ``nmc_inner`` replaces ``nmc_inner_kernel`` at
  ``mc_tpu/ops/nmc_kernels.py:338`` (the grid strategy): it reads the outer
  states from the grids ``path_kernels.simulate_trajectories`` stored.

For every outer path ``i`` and step ``j`` they estimate the discounted
conditional expected payoff given the state after step ``j+1`` by
``n_inner`` inner paths resumed from ``(S_j, count_j)``.  The inner counter
for draw pair ``q`` of inner path ``m`` is
``(i, ((j+1)*n_inner + m)*pair_cap + q)`` on the inner key: unique, and
independent of how paths are laid out.

The surface is step-major ``(n_steps, n_paths)`` f32; the outer moments
come back as ``(rows, 2)`` f64 partials for ``reduce.finish_sum``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from mc_tpu_torch import rng
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.path_kernels import _bound, _check_params, unpack_params
from mc_tpu_torch.ops.payoffs import PathPayoff

__all__ = ["NMCConfig", "nmc_fused", "nmc_inner", "nmc_fused_plain",
           "nmc_inner_plain"]

# Inner-path elements per step of the plain version: bounds its temporaries.
PLAIN_INNER_ELEMS = 1 << 20


@dataclasses.dataclass(frozen=True)
class NMCConfig:
    n_paths: int              # outer paths
    n_steps: int
    n_inner: int              # inner paths per point (N_PATHS_INNER)
    discount: str = "full"    # "full": e^{-rT} like nmc.cuh:100; "remaining": e^{-r(T-t)}
    rng_source: str = "threefry13"

    def __post_init__(self):
        if self.rng_source == "hw":
            raise ValueError(
                "rng_source='hw' is the TPU hardware PRNG and has no "
                "counterpart in mc_tpu_torch yet; NMC supports 'threefry13'")
        if self.rng_source != "threefry13":
            raise ValueError(f"unknown rng_source {self.rng_source!r}; "
                             "NMC supports 'threefry13'")
        if self.discount not in ("full", "remaining"):
            raise ValueError(f"unknown discount {self.discount!r}; use "
                             "'full' or 'remaining'")
        if self.n_paths < 1 or self.n_steps < 1 or self.n_inner < 1:
            raise ValueError("n_paths, n_steps and n_inner must be positive")
        if self.n_paths >= 1 << 32:
            raise ValueError("n_paths must be below 2^32 (uint32 path ids)")
        # Inner draw counter = ((j+1)*n_inner + m)*pair_cap + q in uint32;
        # it must not wrap or inner streams would silently collide.
        span = self.n_steps * self.n_inner * ((self.n_steps + 1) // 2)
        if span >= 1 << 32:
            raise ValueError(
                "inner RNG counter space exhausted: n_steps * n_inner * "
                f"ceil(n_steps/2) = {span} >= 2^32; reduce n_steps or "
                "n_inner (or split the run across seeds)")

    @property
    def pair_cap(self) -> int:
        """Counter stride per inner path: max Box-Muller pairs per resume."""
        return (self.n_steps + 1) // 2


@dataclasses.dataclass(frozen=True)
class NMCLaunch:
    """How one call of the fused or inner kernel runs a point's inner legs:
    in ``groups`` groups of ``legs`` (the library's kNmcLegs); the legs of
    the last group past n_inner run and are not added."""
    legs: int
    groups: int


def nmc_launch(n_inner: int, legs: int) -> NMCLaunch:
    """The leg groups of ``n_inner`` inner legs a point, ``legs`` at a time:
    what the entry points take (``n_groups``) and check."""
    if n_inner < 1 or legs < 1:
        raise ValueError(f"n_inner and legs must be positive; got {n_inner}, "
                         f"{legs}")
    return NMCLaunch(legs=legs, groups=-(-n_inner // legs))


def nmc_occupancy(payoff: PathPayoff, fused: bool) -> int:
    """Resident blocks per SM of the fused or inner kernel for ``payoff``,
    on the current card (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _cuda.load()
    blocks = ctypes.c_int(0)
    _cuda.check(lib.mc_nmc_occupancy(payoff.cuda_id, int(fused),
                                     ctypes.addressof(blocks)),
                "nmc_occupancy")
    return blocks.value


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _simulate_resumed(payoff: PathPayoff, p, s_t, state_t, remaining: int,
                      draw_pair):
    """Run ``remaining`` log-Euler steps from ``(s_t, state_t)``; returns
    the payoff.  Two steps per threefry call; when the last pair overruns
    ``remaining`` its second half-step is dropped by a select."""
    w = torch.zeros_like(s_t)
    s, state = s_t, state_t
    for q in range((remaining + 1) // 2):
        z0, z1 = draw_pair(q)
        w1 = w + (p.drift_dt + p.vol_dt * z0)
        s1 = s_t * torch.exp(w1)
        st1 = payoff.update(state, s1, p)
        w2 = w1 + (p.drift_dt + p.vol_dt * z1)
        s2 = s_t * torch.exp(w2)
        st2 = payoff.update(st1, s2, p)
        take2 = (2 * q + 1) < remaining
        w, s, state = (w2, s2, st2) if take2 else (w1, s1, st1)
    return payoff.terminal(state, s, p)


def _nmc_point_sum(payoff: PathPayoff, cfg: NMCConfig, p, ki0, ki1, ids, j,
                   s_j, c_j):
    """Sum over the n_inner inner payoffs at step j, f64, one per path."""
    remaining = cfg.n_steps - j - 1
    total = torch.zeros(ids.shape, dtype=torch.float64, device=ids.device)
    per_block = max(1, PLAIN_INNER_ELEMS // max(ids.numel(), 1))
    for m0 in range(0, cfg.n_inner, per_block):
        m = torch.arange(m0, min(m0 + per_block, cfg.n_inner),
                         dtype=torch.int64, device=ids.device)[:, None]
        c1_base = (((j + 1) * cfg.n_inner + m) * cfg.pair_cap) & 0xFFFFFFFF
        ids2 = ids.expand(m.shape[0], -1)

        def draw_pair(q, c1_base=c1_base, ids2=ids2):
            c1 = (c1_base + q).expand_as(ids2)
            return rng.normal_pair(ki0, ki1, ids2, c1)

        s_t = s_j.expand_as(ids2)
        st = (c_j.expand_as(ids2),) if payoff.n_state else ()
        pay = _simulate_resumed(payoff, p, s_t, st, remaining, draw_pair)
        total = total + pay.double().sum(dim=0)
    return total


def _discount_factor(cfg: NMCConfig, p, j: int):
    """Per-point discount (f32): reference parity is the full e^{-rT}."""
    if cfg.discount == "full":
        return torch.exp(-p.r * p.t)
    # e^{-r (T - t_j)} with t_j = (j+1) dt — the conditional discount.
    t_j = (torch.tensor(float(j), dtype=torch.float32) + 1.0).to(p.dt.device) * p.dt
    return torch.exp(-p.r * (p.t - t_j))


def nmc_inner_plain(payoff: PathPayoff, cfg: NMCConfig, key_inner,
                    params: torch.Tensor, s_grid, c_grid, path_offset: int = 0,
                    n_valid=None, steps=None):
    """Plain version of the inner (grid-strategy) NMC kernel: the surface
    from the outer states ``s_grid``/``c_grid`` (n_steps, n_paths), or only
    its rows ``steps``, ``(len(steps), n_paths)``."""
    p = unpack_params(params)
    ki0, ki1 = int(key_inner[0]), int(key_inner[1])
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    ids = (torch.arange(cfg.n_paths, dtype=torch.int64, device=params.device)
           + path_offset) & 0xFFFFFFFF
    valid = ids < bound
    steps = range(cfg.n_steps) if steps is None else list(steps)
    surface = torch.empty((len(steps), cfg.n_paths), dtype=torch.float32,
                          device=params.device)
    for row, j in enumerate(steps):
        inner_sum = _nmc_point_sum(payoff, cfg, p, ki0, ki1, ids, j,
                                   s_grid[j], c_grid[j])
        v = (inner_sum / cfg.n_inner).float() * _discount_factor(cfg, p, j)
        surface[row] = torch.where(valid, v, 0.0)
    return surface


def outer_config(cfg: NMCConfig) -> pk.KernelConfig:
    """The outer paths' stream: the plain log-Euler loop, threefry-13."""
    return pk.KernelConfig(n_paths=cfg.n_paths, n_steps=cfg.n_steps,
                           rng_source=cfg.rng_source)


def nmc_fused_plain(payoff: PathPayoff, cfg: NMCConfig, key_outer, key_inner,
                    params: torch.Tensor, path_offset: int = 0, n_valid=None):
    """Plain version of the fused NMC kernel: (surface, outer partials).

    The fused kernel recomputes in registers the outer states that the
    trajectories kernel stores, so its plain version is the two plain
    stages of the grid strategy.
    """
    s_grid, c_grid, outer = pk.simulate_trajectories_plain(
        payoff, outer_config(cfg), key_outer, params, path_offset, n_valid)
    return nmc_inner_plain(payoff, cfg, key_inner, params, s_grid, c_grid,
                           path_offset, n_valid), outer


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------


def nmc_fused(payoff: PathPayoff, cfg: NMCConfig, key_outer, key_inner,
              params: torch.Tensor, path_offset: int = 0, n_valid=None):
    """Fused NMC: ``(surface (n_steps, n_paths) f32, outer (rows, 2) f64)``."""
    _check_params(params)
    if payoff.n_state > 1:
        raise ValueError("NMC supports payoffs with at most one state array")
    if params.device.type == "cpu":
        return nmc_fused_plain(payoff, cfg, key_outer, key_inner, params,
                               path_offset, n_valid)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    geo = nmc_launch(cfg.n_inner, lib.mc_nmc_legs())
    tiles = _cuda.cdiv(cfg.n_paths, lib.mc_nmc_block_threads())
    surface = torch.empty((cfg.n_steps, cfg.n_paths), dtype=torch.float32,
                          device=params.device)
    outer = torch.empty((tiles, 2), dtype=torch.float64, device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_nmc_fused(
            payoff.cuda_id, int(cfg.discount == "remaining"),
            int(key_outer[0]), int(key_outer[1]), int(key_inner[0]),
            int(key_inner[1]), params.data_ptr(), cfg.n_steps, cfg.n_inner,
            geo.groups, cfg.n_paths, path_offset & 0xFFFFFFFF, bound,
            surface.data_ptr(), outer.data_ptr(),
            _cuda.stream_handle(params.device))
    _cuda.check(status, "nmc_fused kernel")
    _cuda.count_launch("nmc_fused")
    return surface, outer


def nmc_inner(payoff: PathPayoff, cfg: NMCConfig, key_inner,
              params: torch.Tensor, s_grid, c_grid, path_offset: int = 0,
              n_valid=None):
    """Grid-strategy NMC over the stored outer states ``s_grid``/``c_grid``
    ((n_steps, n_paths) f32 on the params' device, as
    ``path_kernels.simulate_trajectories`` returns them): the surface
    (n_steps, n_paths) f32."""
    _check_params(params)
    if payoff.n_state > 1:
        raise ValueError("NMC supports payoffs with at most one state array")
    for name, g in (("s_grid", s_grid), ("c_grid", c_grid)):
        if (not torch.is_tensor(g) or g.dtype != torch.float32
                or g.shape != (cfg.n_steps, cfg.n_paths)
                or not g.is_contiguous() or g.device != params.device):
            raise ValueError(
                f"{name} must be a contiguous float32 tensor of shape "
                f"({cfg.n_steps}, {cfg.n_paths}) on {params.device}; got "
                f"{getattr(g, 'shape', None)} {getattr(g, 'dtype', type(g))}")
    if params.device.type == "cpu":
        return nmc_inner_plain(payoff, cfg, key_inner, params, s_grid, c_grid,
                               path_offset, n_valid)
    bound = _bound(path_offset, cfg.n_paths, n_valid)
    lib = _cuda.load()
    geo = nmc_launch(cfg.n_inner, lib.mc_nmc_legs())
    surface = torch.empty((cfg.n_steps, cfg.n_paths), dtype=torch.float32,
                          device=params.device)
    with torch.cuda.device(params.device):
        status = lib.mc_nmc_inner(
            payoff.cuda_id, int(cfg.discount == "remaining"),
            int(key_inner[0]), int(key_inner[1]), params.data_ptr(),
            cfg.n_steps, cfg.n_inner, geo.groups, cfg.n_paths,
            path_offset & 0xFFFFFFFF, bound, s_grid.data_ptr(),
            c_grid.data_ptr(), surface.data_ptr(),
            _cuda.stream_handle(params.device))
    _cuda.check(status, "nmc_inner kernel")
    _cuda.count_launch("nmc_inner")
    return surface
