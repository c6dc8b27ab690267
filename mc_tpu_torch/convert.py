"""Carry state across from ``mc_tpu``.

This system has no weights.  What the two packages must share to compute
the same thing is the contract and geometry, the stream keys, the layout of
the surfaces they return, and the state of a chunked run (a checkpoint).
The inputs here are numpy values (or objects with ``mc_tpu``'s field names
whose values numpy can read); this module never imports ``mc_tpu`` or JAX.
"""

from __future__ import annotations

import os

import numpy as np

from mc_tpu_torch.checkpoint import Checkpoint
from mc_tpu_torch.config import OptionParams, SimParams

__all__ = ["option_params", "book_params", "sim_params", "key",
           "surface_matrix", "checkpoint"]

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


def book_params(src) -> OptionParams:
    """``mc_tpu.OptionParams`` whose fields are scalars or ``(B,)`` arrays
    (a book for ``price_portfolio``) -> the port's OptionParams with every
    field a ``(B,)`` float32 numpy array, scalars broadcast to B."""
    vals = [np.atleast_1d(np.asarray(_field(src, f), np.float32))
            for f in _OPTION_FIELDS]
    for f, v in zip(_OPTION_FIELDS, vals):
        if v.ndim != 1:
            raise ValueError(f"book field {f!r} must be a scalar or a (B,) "
                             f"array; got shape {v.shape}")
    return OptionParams(*(np.array(v) for v in np.broadcast_arrays(*vals)))


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


# mc_tpu's checkpoint magic and the meta keys that describe its TPU engine.
_MC_TPU_MAGIC = "mc_tpu-checkpoint-v1"
_ENGINE_META = ("engine", "tile_rows")


def checkpoint(src) -> Checkpoint:
    """An ``mc_tpu`` checkpoint -> the port's ``Checkpoint``, so that
    ``chunked_price(resume=True)`` continues a run ``mc_tpu`` began.

    ``src`` is the path of ``mc_tpu``'s ``.npz``, or a mapping of its
    arrays (``acc``, ``comp``, ``paths_done``, ``n_paths``, ``meta_*``).
    The sums are the f64 sum of the Kahan accumulators ``acc`` less the f64
    sum of their compensations ``comp``; the meta drops ``engine`` and
    ``tile_rows``, which describe the TPU's kernels and not the run.
    """
    if isinstance(src, (str, os.PathLike)):
        with np.load(src, allow_pickle=False) as z:
            return checkpoint({k: z[k] for k in z.files})
    if "magic" in src and str(src["magic"]) != _MC_TPU_MAGIC:
        raise ValueError(f"not an mc_tpu checkpoint (magic "
                         f"{str(src['magic'])!r})")
    acc = np.asarray(src["acc"], np.float64)
    comp = np.asarray(src["comp"], np.float64)
    sums = (acc.reshape(acc.shape[0], -1).sum(axis=1)
            - comp.reshape(comp.shape[0], -1).sum(axis=1))
    meta = {k[5:]: np.asarray(v).item() if np.ndim(v) == 0 else v
            for k, v in src.items()
            if k.startswith("meta_") and k[5:] not in _ENGINE_META}
    return Checkpoint(paths_done=int(src["paths_done"]),
                      n_paths=int(src["n_paths"]), sums=sums, meta=meta)
