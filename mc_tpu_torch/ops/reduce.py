"""Reductions (port of ``mc_tpu/ops/reduce.py``): the grid-level finish
and the standalone sums that stand in for the reference's reduce3-6.

Every kernel of the port writes one row of f64 moment sums per block
(``csrc/reduce.cuh``); the plain versions write one row per chunk of paths.
``finish_sum`` adds the rows in f64, in a fixed order, on the device the
rows live on.  The TPU's double-float tree and the CPU Neumaier scan
(``mc_tpu/ops/reduce.py:139-162``) exist because the TPU has no f64; the
H100 has it, so neither is ported.

Two kernels live in ``csrc/reduce_kernels.cu``:

* ``tile_partials`` (replaces the Pallas kernel at
  ``mc_tpu/ops/reduce.py:78``): the f64 sum of an f32 array, one row per
  block, ``(n_blocks, 1)``; ``sum_pallas`` finishes it.
* ``sum_sumsq_partials`` (replaces the Pallas call of ``sum_sumsq_pallas``,
  ``mc_tpu/ops/reduce.py:195``): the fused sum and sum of squares in one
  pass, ``(n_blocks, 2)``; ``sum_sumsq_pallas`` finishes it.

``mc_tpu``'s ``tile_rows``, ``interpret`` and ``pad_to_tiles`` describe the
TPU's (8, 128) tiling and its interpreter: here a block reads its own
grid-stride share of the flat array and pads nothing, so none of them is
ported.  ``kahan_sum`` is the sequential f32 Kahan sum the tests take as
ground truth (an XLA ``lax.scan`` in ``mc_tpu``, no Pallas): a host loop.

Each wrapper takes its plain PyTorch version only when the array lies on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from mc_tpu_torch.ops import _cuda

__all__ = ["finish_sum", "tile_partials", "sum_pallas",
           "sum_sumsq_partials", "sum_sumsq_pallas", "kahan_sum",
           "tile_partials_plain", "sum_sumsq_partials_plain"]

# Elements per row of the plain versions: bounds their f64 temporaries.
PLAIN_CHUNK = 1 << 22


def finish_sum(partials: torch.Tensor) -> torch.Tensor:
    """(n_rows, ..., n_moments) f64 partials -> (..., n_moments) f64 sums
    (the ladder's and the book's rows carry a strike or contract axis)."""
    if partials.dtype != torch.float64 or partials.dim() < 2:
        raise ValueError("finish_sum takes (rows, ..., moments) float64 "
                         f"partials; got {tuple(partials.shape)} "
                         f"{partials.dtype}")
    return partials.sum(dim=0)


def _flat(x) -> torch.Tensor:
    """``x`` as a 1-D f32 tensor: a view where ``x`` is contiguous (so a
    sliced view keeps its offset), else a copy."""
    if (not torch.is_tensor(x) or x.dtype != torch.float32
            or x.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"the reductions take a float32 tensor on the CPU or a CUDA "
            f"device; got {getattr(x, 'dtype', type(x))} on "
            f"{getattr(x, 'device', None)}")
    return x.contiguous().view(-1)


def _plain_rows(flat: torch.Tensor, squares: bool) -> torch.Tensor:
    rows = []
    for start in range(0, max(flat.numel(), 1), PLAIN_CHUNK):
        v = flat[start:start + PLAIN_CHUNK]
        rows.append(torch.stack([v.double().sum(), (v * v).double().sum()])
                    if squares else v.double().sum().reshape(1))
    return torch.stack(rows)


def tile_partials_plain(x) -> torch.Tensor:
    """Plain version of the tile_partials kernel: (chunks, 1) f64."""
    return _plain_rows(_flat(x), squares=False)


def sum_sumsq_partials_plain(x) -> torch.Tensor:
    """Plain version of the sum_sumsq kernel: (chunks, 2) f64 [sum of x,
    sum of x^2], each square taken in f32 as ``mc_tpu`` and the path
    kernels' moments take it, the sums in f64."""
    return _plain_rows(_flat(x), squares=True)


def _launch(flat: torch.Tensor, n_mom: int, entry: str, name: str):
    lib = _cuda.load()
    n = flat.numel()
    # Four elements (one float4) per thread and pass.
    n_blocks = max(1, min(_cuda.cdiv(n, 4 * lib.mc_reduce_block_threads()),
                          _cuda.MAX_BLOCKS))
    partials = torch.empty((n_blocks, n_mom), dtype=torch.float64,
                           device=flat.device)
    with torch.cuda.device(flat.device):
        status = getattr(lib, entry)(flat.data_ptr(), n,
                                     partials.data_ptr(), n_blocks,
                                     _cuda.stream_handle(flat.device))
    _cuda.check(status, f"{name} kernel")
    _cuda.count_launch(name)
    return partials


def tile_partials(x) -> torch.Tensor:
    """Per-block f64 sums of the f32 array ``x`` (any shape), ``(rows, 1)``:
    the reduce3..6 analogue.  Each thread adds its grid-stride share in
    f64, each block tree-reduces its threads in a fixed order and writes one
    row; ``finish_sum`` adds the rows."""
    flat = _flat(x)
    if flat.device.type == "cpu":
        return tile_partials_plain(flat)
    return _launch(flat, 1, "mc_tile_partials", "tile_partials")


def sum_pallas(x) -> torch.Tensor:
    """The f64 sum of an f32 array (0-d f64 tensor on ``x``'s device)."""
    return finish_sum(tile_partials(x))[0]


def sum_sumsq_partials(x) -> torch.Tensor:
    """Per-block f64 [sum, sum of squares] of the f32 array ``x``,
    ``(rows, 2)``, in one pass over it."""
    flat = _flat(x)
    if flat.device.type == "cpu":
        return sum_sumsq_partials_plain(flat)
    return _launch(flat, 2, "mc_sum_sumsq_partials", "sum_sumsq")


def sum_sumsq_pallas(x):
    """Fused (sum, sum of squares) of an f32 array, one pass: the moment
    pair ``oracle.summarize`` turns into a price and its standard error.
    Returns two 0-d f64 tensors."""
    s, s2 = finish_sum(sum_sumsq_partials(x))
    return s, s2


def kahan_sum(x) -> np.float32:
    """Kahan-compensated sequential f32 sum on the host (ground truth for
    tests), the role of the reference's CPU ``sum_random_array`` oracle
    (``inc/testing.cuh:161-174``)."""
    flat = (x.detach().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x)).astype(np.float32).ravel()
    total, comp = np.float32(0.0), np.float32(0.0)
    for v in flat:
        y = v - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total
