"""Build, load and count the hand-written CUDA kernels
(the counterpart of ``mc_tpu/ops/_pallas.py``).

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, as many
at once as the host has CPUs less one, the largest first, and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build happens at the first
launch, never at import, into ``build/mc_tpu_torch/<hash>/`` beside
the package, keyed by a hash of the sources and flags, so a fresh checkout
builds everything on its first call and later calls reuse the library.

Each wrapper that launches a kernel adds one to its entry of
``launch_counts`` right after the launch, and nowhere else, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["cdiv", "launch_counts", "count_launch", "reset_launch_counts",
           "load", "check", "stream_handle", "pointer_array", "build_info",
           "FamilyExtras", "family_extras", "KERNELS", "MAX_BLOCKS"]

# The kernels' grids are capped so a large run grid-strides; the cap depends
# on nothing but the path or element count, so the order of the per-block
# partials is fixed.
MAX_BLOCKS = 8192

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mc_tpu_torch"
LIB_NAME = "libmc_tpu_torch.so"

# -O3, no --use_fast_math (the normals must stay within a few ulp of the
# plain versions), and no float contraction, so each mul and add rounds as
# it does in the PyTorch version.  -Xptxas -v reports registers per kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("terminal_pair", "simulate_partials", "trajectories", "nmc_fused",
           "nmc_inner", "ladder", "book", "greek_partials", "tile_partials",
           "sum_sumsq", "heston_partials", "heston_trajectories",
           "family_inner", "family_fused", "merton_partials",
           "merton_trajectories", "bates_partials", "family_trajectories",
           "cev_partials", "localvol_partials", "localvol_trajectories",
           "sabr_partials", "term_partials", "divs_partials",
           "vasicek_partials", "vasicek_trajectories", "basket_partials",
           "basket_trajectories", "fx_partials", "rainbow_partials",
           "qmc_sums", "qmc_bridge_sums", "qmc_model_sums",
           # #11, one count per rates tile (ops/fused.py TILES)
           "rates_partials_va", "rates_partials_hw", "rates_partials_hw_mc",
           "rates_partials_g2", "rates_partials_g2_mc")
launch_counts = dict.fromkeys(KERNELS, 0)

_c_int, _c_u32, _c_ptr = ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p
_c_f32, _c_u64 = ctypes.c_float, ctypes.c_uint64
_c_ptr_array = ctypes.POINTER(ctypes.c_void_p)


class FamilyExtras(ctypes.Structure):
    """A family's integer extras, passed by value (``csrc/family.cuh``
    FamilyExtras): Merton's and Bates's i[0] is the Poisson scan depth,
    local vol's the knot count, the basket's its dimension d."""

    _fields_ = [("i", ctypes.c_int * 4)]


def family_extras(values) -> FamilyExtras:
    values = tuple(int(v) for v in values)
    if len(values) > 4:
        raise ValueError(f"a family carries at most 4 integer extras; got "
                         f"{len(values)}")
    return FamilyExtras((ctypes.c_int * 4)(*values))


_SIGNATURES = {
    "mc_error_string": ([_c_int], ctypes.c_char_p),
    "mc_block_threads": ([], _c_int),
    "mc_simulate_block_paths": ([], _c_int),
    # payoff_id, euler, antithetic, with_cv, blocks
    "mc_simulate_occupancy": ([_c_int, _c_int, _c_int, _c_int, _c_ptr], _c_int),
    "mc_nmc_block_threads": ([], _c_int),
    "mc_nmc_legs": ([], _c_int),
    # bad (2 u64, zeroed), stream
    "mc_nmc_libm_check": ([_c_ptr, _c_ptr], _c_int),
    # payoff_id, fused, blocks (out)
    "mc_nmc_occupancy": ([_c_int, _c_int, _c_ptr], _c_int),
    "mc_ladder_block_paths": ([], _c_int),
    "mc_ladder_paths_per_thread": ([_c_int], _c_int),
    "mc_ladder_strikes_per_pass": ([_c_int], _c_int),
    # payoff_id, euler, blocks (out)
    "mc_ladder_occupancy": ([_c_int, _c_int, _c_ptr], _c_int),
    "mc_reduce_block_threads": ([], _c_int),
    "mc_heston_block_paths": ([], _c_int),
    # qe, antithetic, blocks
    "mc_heston_occupancy": ([_c_int, _c_int, _c_ptr], _c_int),
    "mc_family_block_threads": ([], _c_int),
    "mc_family_trajectories_block_paths": ([], _c_int),
    # family_id, payoff_id, extras, n_blocks, blocks (out)
    "mc_family_trajectories_occupancy": ([_c_int, _c_int, FamilyExtras,
                                          _c_int, _c_ptr], _c_int),
    # family_id, extras, n_blocks, threads (out), dynamic shared bytes (out)
    "mc_family_trajectories_geometry": ([_c_int, FamilyExtras, _c_int,
                                         _c_ptr, _c_ptr], _c_int),
    "mc_merton_block_paths": ([], _c_int),
    # payoff_id, terminal, antithetic, blocks
    "mc_merton_occupancy": ([_c_int, _c_int, _c_int, _c_ptr], _c_int),
    "mc_bates_block_paths": ([], _c_int),
    # qe, antithetic, blocks
    "mc_bates_occupancy": ([_c_int, _c_int, _c_ptr], _c_int),
    "mc_cev_block_paths": ([], _c_int),
    # antithetic, blocks
    "mc_cev_occupancy": ([_c_int, _c_ptr], _c_int),
    # bad (2 u64: 0 and ~0), stream
    "mc_cev_logf_check": ([_c_ptr, _c_ptr], _c_int),
    "mc_localvol_block_paths": ([], _c_int),
    "mc_localvol_capacity": ([_c_int], _c_int),
    # antithetic
    "mc_localvol_paths_per_thread": ([_c_int], _c_int),
    # payoff_id, n_knots, antithetic, blocks
    "mc_localvol_occupancy": ([_c_int, _c_int, _c_int, _c_ptr], _c_int),
    "mc_sabr_block_paths": ([], _c_int),
    "mc_sabr_paths_per_thread": ([], _c_int),
    # unit_beta, antithetic, blocks
    "mc_sabr_occupancy": ([_c_int, _c_int, _c_ptr], _c_int),
    "mc_term_block_threads": ([], _c_int),
    "mc_divs_block_paths": ([], _c_int),
    # antithetic
    "mc_divs_paths_per_thread": ([_c_int], _c_int),
    "mc_divs_table_steps": ([], _c_int),
    # antithetic, n_steps, blocks
    "mc_divs_occupancy": ([_c_int, _c_int, _c_ptr], _c_int),
    "mc_vasicek_block_threads": ([], _c_int),
    # d
    "mc_basket_block_threads": ([_c_int], _c_int),
    "mc_basket_trajectories_block_paths": ([], _c_int),
    # payoff_id, d, blocks
    "mc_basket_trajectories_occupancy": ([_c_int, _c_int, _c_ptr], _c_int),
    "mc_basket_block_paths": ([], _c_int),
    "mc_basket_capacity": ([_c_int], _c_int),
    "mc_basket_paths_per_thread": ([_c_int], _c_int),
    # payoff_id, d, antithetic, blocks
    "mc_basket_occupancy": ([_c_int, _c_int, _c_int, _c_ptr], _c_int),
    "mc_fx_block_paths": ([], _c_int),
    "mc_fx_paths_per_thread": ([], _c_int),
    # contract, blocks
    "mc_fx_occupancy": ([_c_int, _c_ptr], _c_int),
    "mc_rainbow_block_paths": ([], _c_int),
    # d
    "mc_rainbow_paths_per_thread": ([_c_int], _c_int),
    # d, antithetic, blocks
    "mc_rainbow_occupancy": ([_c_int, _c_int, _c_ptr], _c_int),
    "mc_greek_block_paths": ([], _c_int),
    # euler
    "mc_greek_paths_per_thread": ([_c_int], _c_int),
    # payoff_id, euler, blocks
    "mc_greek_occupancy": ([_c_int, _c_int, _c_ptr], _c_int),
    "mc_qmc_block_threads": ([], _c_int),
    "mc_qmc_bridge_threads": ([_c_int], _c_int),
    "mc_qmc_bridge_shifts": ([], _c_int),
    "mc_qmc_bridge_slots": ([], _c_int),
    "mc_qmc_model_block_threads": ([], _c_int),
    "mc_rates_block_paths": ([], _c_int),
    "mc_rates_paths_per_thread": ([], _c_int),
    "mc_rates_stage_payments": ([], _c_int),
    # tile, n_pay, blocks
    "mc_rates_occupancy": ([_c_int, _c_int, _c_ptr], _c_int),
    "mc_terminal_pair_block_elems": ([], _c_int),
    "mc_terminal_pair_elems_per_thread": ([], _c_int),
    "mc_terminal_pair_occupancy": ([_c_ptr], _c_int),
    # payoff_id, rounds, k0, k1, params, n_elems, n_paths_total, partials,
    # n_blocks, stream
    "mc_terminal_pair": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr, _c_u32,
                          _c_u32, _c_ptr, _c_int, _c_ptr], _c_int),
    # payoff_id, rounds, euler, antithetic, with_cv, k0, k1, params, n_steps,
    # start_step, is_shift, n_paths, path_offset, bound, s_init, state_init
    # (the (kStates, n_paths) block), partials, n_mom, n_blocks, stream
    "mc_simulate_partials": ([_c_int, _c_int, _c_int, _c_int, _c_int, _c_u32,
                              _c_u32, _c_ptr, _c_int, _c_int, _c_f32, _c_u32,
                              _c_u32, _c_u32, _c_ptr, _c_ptr, _c_ptr, _c_int,
                              _c_int, _c_ptr], _c_int),
    # payoff_id, rounds, k0, k1, params, n_steps, n_paths, path_offset,
    # bound, s_grid, state_grid, partials, n_blocks, stream
    "mc_trajectories": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr, _c_int,
                         _c_u32, _c_u32, _c_u32, _c_ptr, _c_ptr, _c_ptr,
                         _c_int, _c_ptr], _c_int),
    # payoff_id, discount_remaining, ko0, ko1, ki0, ki1, params, n_steps,
    # n_inner, n_groups, n_paths, path_offset, bound, surface, outer_partials,
    # stream
    "mc_nmc_fused": ([_c_int, _c_int, _c_u32, _c_u32, _c_u32, _c_u32, _c_ptr,
                      _c_int, _c_int, _c_int, _c_u32, _c_u32, _c_u32, _c_ptr,
                      _c_ptr, _c_ptr], _c_int),
    # payoff_id, discount_remaining, ki0, ki1, params, n_steps, n_inner,
    # n_groups, n_paths, path_offset, bound, s_grid, state_grid, surface,
    # stream
    "mc_nmc_inner": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr, _c_int, _c_int,
                      _c_int, _c_u32, _c_u32, _c_u32, _c_ptr, _c_ptr, _c_ptr,
                      _c_ptr], _c_int),
    # payoff_id, euler, antithetic, k0, k1, params, strikes, n_strikes,
    # n_steps, n_paths, path_offset, bound, partials, n_blocks, stream
    "mc_ladder_partials": ([_c_int, _c_int, _c_int, _c_u32, _c_u32, _c_ptr,
                            _c_ptr, _c_int, _c_int, _c_u32, _c_u32, _c_u32,
                            _c_ptr, _c_int, _c_ptr], _c_int),
    # payoff_id
    "mc_book_contracts": ([_c_int], _c_int),
    # payoff_id, euler, n_steps, threads, blocks
    "mc_book_occupancy": ([_c_int, _c_int, _c_int, _c_int, _c_ptr], _c_int),
    # payoff_id, euler, antithetic, with_cv, k0, k1, params_rows,
    # n_contracts, n_steps, n_paths, path_offset, bound, threads, partials,
    # n_mom, n_blocks, stream
    "mc_book_partials": ([_c_int, _c_int, _c_int, _c_int, _c_u32, _c_u32,
                          _c_ptr, _c_int, _c_int, _c_u32, _c_u32, _c_u32,
                          _c_int, _c_ptr, _c_int, _c_int, _c_ptr], _c_int),
    # payoff_id, rounds, euler, k0, k1, params, n_steps, n_paths, partials,
    # n_blocks, stream
    "mc_greek_partials": ([_c_int, _c_int, _c_int, _c_u32, _c_u32, _c_ptr,
                           _c_int, _c_u32, _c_ptr, _c_int, _c_ptr], _c_int),
    # x, n, partials, n_blocks, stream
    "mc_tile_partials": ([_c_ptr, _c_u64, _c_ptr, _c_int, _c_ptr], _c_int),
    "mc_sum_sumsq_partials": ([_c_ptr, _c_u64, _c_ptr, _c_int, _c_ptr],
                              _c_int),
    # payoff_id, qe, rounds, antithetic, k0, k1, params, n_steps, n_paths,
    # path_offset, bound, partials, n_blocks, stream
    "mc_heston_partials": ([_c_int, _c_int, _c_int, _c_int, _c_u32, _c_u32,
                            _c_ptr, _c_int, _c_u32, _c_u32, _c_u32, _c_ptr,
                            _c_int, _c_ptr], _c_int),
    # family_id, payoff_id, ki0, ki1, params, extras, n_steps, n_inner,
    # n_groups, stage_floats, n_paths, path_offset, bound, grids (host array
    # of n_grids device pointers), n_grids, state_grid, surface, stream
    "mc_family_inner": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr, FamilyExtras,
                         _c_int, _c_int, _c_int, _c_int, _c_u32, _c_u32,
                         _c_u32, _c_ptr_array, _c_int, _c_ptr, _c_ptr,
                         _c_ptr], _c_int),
    # family_id, payoff_id, ko0, ko1, ki0, ki1, params, extras, n_steps,
    # n_inner, n_groups, stage_floats, n_paths, path_offset, bound, surface,
    # outer_partials, stream
    "mc_family_fused": ([_c_int, _c_int, _c_u32, _c_u32, _c_u32, _c_u32,
                         _c_ptr, FamilyExtras, _c_int, _c_int, _c_int, _c_int,
                         _c_u32, _c_u32, _c_u32, _c_ptr, _c_ptr, _c_ptr],
                        _c_int),
    # family_id, payoff_id, extras, fused, smem_bytes, blocks (int*)
    "mc_family_occupancy": ([_c_int, _c_int, FamilyExtras, _c_int, _c_int,
                             _c_ptr], _c_int),
    # family_id, payoff_id, k0, k1, params, extras, n_steps, n_paths,
    # path_offset, bound, grids (host array of n_grids device pointers),
    # n_grids, state_grid, partials, n_blocks, stream
    "mc_family_trajectories": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr,
                                FamilyExtras, _c_int, _c_u32, _c_u32, _c_u32,
                                _c_ptr_array, _c_int, _c_ptr, _c_ptr, _c_int,
                                _c_ptr], _c_int),
    # payoff_id, terminal, rounds, antithetic, k0, k1, params, kmax,
    # n_steps, n_paths, path_offset, bound, partials, n_blocks, stream
    "mc_merton_partials": ([_c_int, _c_int, _c_int, _c_int, _c_u32, _c_u32,
                            _c_ptr, _c_int, _c_int, _c_u32, _c_u32, _c_u32,
                            _c_ptr, _c_int, _c_ptr], _c_int),
    # payoff_id, qe, rounds, antithetic, k0, k1, params, kmax, n_steps,
    # n_paths, path_offset, bound, partials, n_blocks, stream
    "mc_bates_partials": ([_c_int, _c_int, _c_int, _c_int, _c_u32, _c_u32,
                           _c_ptr, _c_int, _c_int, _c_u32, _c_u32, _c_u32,
                           _c_ptr, _c_int, _c_ptr], _c_int),
    # payoff_id, antithetic, k0, k1, params, n_steps, n_paths, path_offset,
    # bound, partials, n_blocks, stream
    "mc_cev_partials": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr, _c_int,
                         _c_u32, _c_u32, _c_u32, _c_ptr, _c_int, _c_ptr],
                        _c_int),
    # payoff_id, rounds, antithetic, k0, k1, params, n_knots, n_steps,
    # n_paths, path_offset, bound, partials, n_blocks, stream
    "mc_localvol_partials": ([_c_int, _c_int, _c_int, _c_u32, _c_u32, _c_ptr,
                              _c_int, _c_int, _c_u32, _c_u32, _c_u32, _c_ptr,
                              _c_int, _c_ptr], _c_int),
    # payoff_id, rounds, antithetic, unit_beta, k0, k1, params, n_steps,
    # n_paths, path_offset, bound, partials, n_blocks, stream
    "mc_sabr_partials": ([_c_int, _c_int, _c_int, _c_int, _c_u32, _c_u32,
                          _c_ptr, _c_int, _c_u32, _c_u32, _c_u32, _c_ptr,
                          _c_int, _c_ptr], _c_int),
    # payoff_id, antithetic, k0, k1, params, n_steps, n_paths, path_offset,
    # bound, partials, n_blocks, stream (term: 11 + 2*n_steps params; divs:
    # 13 + n_steps)
    "mc_term_partials": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr, _c_int,
                          _c_u32, _c_u32, _c_u32, _c_ptr, _c_int, _c_ptr],
                         _c_int),
    "mc_divs_partials": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr, _c_int,
                          _c_u32, _c_u32, _c_u32, _c_ptr, _c_int, _c_ptr],
                         _c_int),
    # payoff_id, rounds, antithetic, k0, k1, params, n_steps, n_paths,
    # path_offset, bound, partials, n_blocks, stream
    "mc_vasicek_partials": ([_c_int, _c_int, _c_int, _c_u32, _c_u32, _c_ptr,
                             _c_int, _c_u32, _c_u32, _c_u32, _c_ptr, _c_int,
                             _c_ptr], _c_int),
    # payoff_id, antithetic, k0, k1, params, d, n_steps, n_paths,
    # path_offset, bound, partials, n_blocks, stream
    "mc_basket_partials": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr, _c_int,
                            _c_int, _c_u32, _c_u32, _c_u32, _c_ptr, _c_int,
                            _c_ptr], _c_int),
    # payoff_id, k0, k1, params, d, n_steps, n_paths, path_offset, bound,
    # b_grid, state_grid, partials, n_blocks, stream
    "mc_basket_trajectories": ([_c_int, _c_u32, _c_u32, _c_ptr, _c_int,
                                _c_int, _c_u32, _c_u32, _c_u32, _c_ptr,
                                _c_ptr, _c_ptr, _c_int, _c_ptr], _c_int),
    # contract, rounds, k0, k1, params, n_paths, path_offset, bound,
    # partials, n_blocks, stream
    "mc_fx_partials": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr, _c_u32,
                        _c_u32, _c_u32, _c_ptr, _c_int, _c_ptr], _c_int),
    # payoff, rounds, antithetic, k0, k1, params, d, n_paths, path_offset,
    # bound, partials, n_blocks, stream
    "mc_rainbow_partials": ([_c_int, _c_int, _c_int, _c_u32, _c_u32, _c_ptr,
                             _c_int, _c_u32, _c_u32, _c_u32, _c_ptr, _c_int,
                             _c_ptr], _c_int),
    # payoff_id, family, euler, n, d, table, shifts, n_shifts, params,
    # n_steps, partials, n_bx, n_groups, stream
    "mc_qmc_sums": ([_c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr, _c_ptr,
                     _c_int, _c_ptr, _c_int, _c_ptr, _c_int, _c_int, _c_ptr],
                    _c_int),
    # family_id, payoff_id, family, n, d, table, shifts, n_shifts, params,
    # n_steps, extra, partials, n_bx, n_groups, stream
    "mc_qmc_model_sums": ([_c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr,
                           _c_ptr, _c_int, _c_ptr, _c_int, _c_int, _c_ptr,
                           _c_int, _c_int, _c_ptr], _c_int),
    "mc_qmc_shifts": ([], _c_int),
    # family_id, extra
    "mc_qmc_model_shifts": ([_c_int, _c_int], _c_int),
    # family_id (-1: qmc_kernel), payoff_id, extra, blocks
    "mc_qmc_occupancy": ([_c_int, _c_int, _c_int, _c_ptr], _c_int),
    # payoff_id, family, n, d, table, shifts, n_shifts, params, n_steps,
    # entries, pairs, n_slots, partials, n_bx, n_groups, stream
    "mc_qmc_bridge_sums": ([_c_int, _c_int, _c_int, _c_int, _c_ptr, _c_ptr,
                            _c_int, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_int,
                            _c_ptr, _c_int, _c_int, _c_ptr], _c_int),
    # tile, n_pay, k0, k1, pv, n_paths, path_offset, bound, partials,
    # n_blocks, stream
    "mc_rates_partials": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr, _c_u32,
                           _c_u32, _c_u32, _c_ptr, _c_int, _c_ptr], _c_int),
}

_lock = threading.Lock()
_lib = None
# path, seconds (None when reused), ptxas log, ptxas_by_source (each
# source's log), source_seconds (each source's nvcc)
build_info: dict = {}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # finds the toolkit only

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of mc_tpu_torch are "
                       "built from csrc/ at first use and need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _run_all(cmds: list[list[str]], jobs: int) -> list[tuple[str, float]]:
    """Run the commands, at most ``jobs`` at once, in order: the stderr and
    the seconds of each, or raise on the first that fails."""
    def run(cmd):
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=CSRC)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}):\n"
                               f"{' '.join(cmd)}\n{p.stderr}")
        return p.stderr, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=jobs) as pool:
        return list(pool.map(run, cmds))


# Each source's nvcc seconds on the H100 machine (chip_smoke.py phase 1
# prints them; NVIDIA H100 80GB HBM3 host, 7 compilers at once; the basket
# and FX sources from a host ~1.35x slower than the rest's; the family NMC
# sources, two trajectories kernels a payoff, from one build on a host ~1.2x
# slower, scaled by the other sources' median ratio; batch_kernels.cu and
# family_nmc_kernels.cu their earlier figures scaled by the ratio of their
# nvcc seconds to their earlier sources' in one family_nmc_probe.py build):
# the build starts the longest first, so the pool ends together.  A source
# not listed starts before them, the largest unit first (_unit_bytes).
NVCC_SECONDS = {
    "basket32_kernels.cu": 114.2, "batch_kernels.cu": 35.2,
    "merton_kernels.cu": 31.1, "rainbow_nmc_kernels.cu": 41.5,
    "localvol10_kernels.cu": 30.1, "localvol_kernels.cu": 30.0,
    "basket_nmc_kernels.cu": 40.5, "basket16_kernels.cu": 38.6,
    "bates_qe_kernels.cu": 28.0, "path_kernels.cu": 9.1,
    "simulate_kernels.cu": 29.7, "simulate20_kernels.cu": 30.2,
    "basket_kernels.cu": 21.4, "sabr_kernels.cu": 19.6,
    "sabr1_kernels.cu": 18.1, "merton_nmc_kernels.cu": 23.2,
    "heston_qe_kernels.cu": 18.9, "bates_nmc_kernels.cu": 24.1,
    "basket8_kernels.cu": 19.9, "localvol_nmc_kernels.cu": 19.9,
    "vasicek_nmc_kernels.cu": 19.9, "qmc_kernels.cu": 15.9,
    "nmc_kernels.cu": 15.3, "rainbow_nmc32_kernels.cu": 15.2,
    "basket_nmc32_kernels.cu": 14.7, "vasicek_kernels.cu": 13.7,
    "term_nmc_kernels.cu": 15.5, "cev_nmc_kernels.cu": 14.8,
    "bates_kernels.cu": 9.0, "heston_kernels.cu": 11.9,
    "qmc_merton_kernels.cu": 10.4, "sabr_nmc_kernels.cu": 14.5,
    "qmc_bates_kernels.cu": 9.5, "qmc_basket_kernels.cu": 8.9,
    "qmc_localvol_kernels.cu": 8.7, "family_nmc_kernels.cu": 10.1,
    "qmc_vasicek_kernels.cu": 6.9, "greek_kernels.cu": 7.7,
    "qmc_sabr_kernels.cu": 6.9, "qmc_cev_kernels.cu": 6.8,
    "qmc_term_kernels.cu": 6.7, "divs_kernels.cu": 20.3,
    "term_kernels.cu": 6.5, "qmc_heston_kernels.cu": 6.4,
    "cev_kernels.cu": 11.0, "qmc_basket32_kernels.cu": 6.1,
    "rates_kernels.cu": 5.5, "rainbow_kernels.cu": 5.4,
    "rainbow32_kernels.cu": 9.4,
    "fx_kernels.cu": 7.4, "reduce_kernels.cu": 3.0}


def _build_order(src: Path):
    """The build's sort key of a source: unlisted first (largest unit
    first), then by NVCC_SECONDS, longest first."""
    if src.name in NVCC_SECONDS:
        return (1, -NVCC_SECONDS[src.name], src.name)
    return (0, -_unit_bytes(src), src.name)


def _unit_bytes(src: Path) -> int:
    """The bytes of ``src`` and of the csrc headers it includes, each once."""
    seen, todo = {src}, [src]
    while todo:
        for name in re.findall(r'#include "([^"]+)"', todo.pop().read_text()):
            h = CSRC / name
            if h.exists() and h not in seen:
                seen.add(h)
                todo.append(h)
    return sum(p.stat().st_size for p in seen)


def _build() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    out = out_dir / LIB_NAME
    log = out_dir / "ptxas.json"
    if out.exists():
        by_source = json.loads(log.read_text()) if log.exists() else {}
        build_info.update(path=str(out), seconds=None,
                          ptxas="".join(by_source.values()),
                          ptxas_by_source=by_source)
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    # The longest sources start first (_build_order), so the pool ends
    # together.  The pool leaves one CPU to the caller's other threads: on
    # the H100 machine a thread beside 40 busy processes ran at a fifth of
    # its speed at any niceness, beside 7 at full speed, and 7 compilers at
    # once built in 72.9 s where 40 took 79.7 s.
    srcs = sorted(CSRC.glob("*.cu"), key=_build_order)
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    t0 = time.perf_counter()
    jobs = max(1, len(os.sched_getaffinity(0)) - 1)
    runs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                     for o, src in zip(objs, srcs)], jobs)
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]], 1)
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    by_source = {s.name: err for s, (err, _) in zip(srcs, runs)}
    log.write_text(json.dumps(by_source))
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    build_info.update(path=str(out), seconds=seconds,
                      ptxas="".join(by_source.values()),
                      ptxas_by_source=by_source,
                      source_seconds={s.name: sec
                                      for s, (_, sec) in zip(srcs, runs)})
    return out


def load():
    """The loaded kernel library, built first if this source hash is new."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if status:
        msg = load().mc_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def pointer_array(tensors):
    """A host array of the tensors' device pointers (a ``const float* const*``
    argument)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
