"""Carry state across from ``mc_tpu``.

This system has no weights.  What the two packages must share to compute
the same thing is the contract and geometry, the stream keys, and the
layout of the surfaces they return.  The inputs here are numpy values (or
objects with ``mc_tpu``'s field names whose values numpy can read); this
module never imports ``mc_tpu`` or JAX.
"""

from __future__ import annotations

import numpy as np

from mc_tpu_torch.config import OptionParams, SimParams

__all__ = ["option_params", "sim_params", "key", "surface_matrix"]

_OPTION_FIELDS = ("s0", "t", "k", "r", "sigma", "barrier", "p1", "p2", "q")
_SIM_FIELDS = ("n_paths", "n_steps", "n_paths_inner", "seed")


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def option_params(src) -> OptionParams:
    """``mc_tpu.OptionParams`` fields (scalars) -> the port's OptionParams."""
    vals = []
    for f in _OPTION_FIELDS:
        v = np.asarray(_field(src, f))
        if v.shape != ():
            raise ValueError(f"option field {f!r} must be a scalar; the port "
                             f"prices one contract (got shape {v.shape})")
        vals.append(float(v))
    return OptionParams(*vals)


def sim_params(src) -> SimParams:
    """``mc_tpu.SimParams`` fields -> the port's SimParams."""
    return SimParams(**{f: int(_field(src, f)) for f in _SIM_FIELDS})


def key(arr) -> tuple[int, int]:
    """A ``derive_key`` output or a ``(2,)`` uint32 array -> (k0, k1)."""
    a = np.asarray(arr)
    if a.shape != (2,):
        raise ValueError(f"a stream key is two uint32 words; got shape {a.shape}")
    if a.dtype != np.uint32:
        if not np.issubdtype(a.dtype, np.integer) or a.min() < 0 or a.max() >> 32:
            raise ValueError(f"key words must be uint32; got {a!r}")
        a = a.astype(np.uint32)
    return int(a[0]), int(a[1])


def surface_matrix(grid, n_paths: int) -> np.ndarray:
    """A step-major ``(n_steps, rows, 128)`` surface or state grid, as
    ``mc_tpu`` returns it, cut to the ``(n_paths, n_steps)`` matrix that
    the port's ``NMCResult.surface_matrix()`` returns."""
    g = np.asarray(grid)
    if g.ndim != 3:
        raise ValueError(f"expected a (n_steps, rows, lanes) grid; got {g.shape}")
    n_steps, rows, lanes = g.shape
    if n_paths > rows * lanes:
        raise ValueError(f"n_paths={n_paths} exceeds the grid's "
                         f"{rows * lanes} slots")
    return np.moveaxis(g, 0, -1).reshape(rows * lanes, n_steps)[:n_paths]
