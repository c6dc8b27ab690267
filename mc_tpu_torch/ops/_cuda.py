"""Build, load and count the hand-written CUDA kernels
(the counterpart of ``mc_tpu/ops/_pallas.py``).

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The build happens at the first
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
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["cdiv", "launch_counts", "count_launch", "reset_launch_counts",
           "load", "check", "stream_handle", "build_info", "KERNELS",
           "MAX_BLOCKS"]

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
           "sum_sumsq")
launch_counts = dict.fromkeys(KERNELS, 0)

_c_int, _c_u32, _c_ptr = ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p
_c_f32, _c_u64 = ctypes.c_float, ctypes.c_uint64
_SIGNATURES = {
    "mc_error_string": ([_c_int], ctypes.c_char_p),
    "mc_block_threads": ([], _c_int),
    "mc_nmc_block_threads": ([], _c_int),
    "mc_ladder_block_threads": ([], _c_int),
    "mc_reduce_block_threads": ([], _c_int),
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
    # n_inner, n_paths, path_offset, bound, surface, outer_partials, stream
    "mc_nmc_fused": ([_c_int, _c_int, _c_u32, _c_u32, _c_u32, _c_u32, _c_ptr,
                      _c_int, _c_int, _c_u32, _c_u32, _c_u32, _c_ptr, _c_ptr,
                      _c_ptr], _c_int),
    # payoff_id, discount_remaining, ki0, ki1, params, n_steps, n_inner,
    # n_paths, path_offset, bound, s_grid, state_grid, surface, stream
    "mc_nmc_inner": ([_c_int, _c_int, _c_u32, _c_u32, _c_ptr, _c_int, _c_int,
                      _c_u32, _c_u32, _c_u32, _c_ptr, _c_ptr, _c_ptr, _c_ptr],
                     _c_int),
    # payoff_id, euler, antithetic, k0, k1, params, strikes, n_strikes,
    # n_steps, n_paths, path_offset, bound, partials, n_blocks, stream
    "mc_ladder_partials": ([_c_int, _c_int, _c_int, _c_u32, _c_u32, _c_ptr,
                            _c_ptr, _c_int, _c_int, _c_u32, _c_u32, _c_u32,
                            _c_ptr, _c_int, _c_ptr], _c_int),
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
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}  # path, seconds (None when reused), ptxas log


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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; their stderr, or raise on the first that
    fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=CSRC) for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    for c, p, err in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}):\n"
                               f"{' '.join(c)}\n{err}")
    return "".join(errs)


def _build() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    out = out_dir / LIB_NAME
    if out.exists():
        log = out_dir / "ptxas.log"
        build_info.update(path=str(out), seconds=None,
                          ptxas=log.read_text() if log.exists() else "")
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    t0 = time.perf_counter()
    ptxas = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                      for o, src in zip(objs, srcs)])
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    (out_dir / "ptxas.log").write_text(ptxas)
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    build_info.update(path=str(out), seconds=seconds, ptxas=ptxas)
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
