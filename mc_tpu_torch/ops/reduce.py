"""The grid-level finish (port of ``mc_tpu/ops/reduce.py`` ``finish_sum``).

Every kernel of the port writes one row of f64 moment sums per block
(``csrc/reduce.cuh``); the plain versions write one row per chunk of paths.
``finish_sum`` adds the rows in f64, in a fixed order, on the device the
rows live on.  The TPU's double-float tree and the CPU Neumaier scan
(``mc_tpu/ops/reduce.py:139-162``) exist because the TPU has no f64; the
H100 has it, so neither is ported.
"""

from __future__ import annotations

import torch

__all__ = ["finish_sum"]


def finish_sum(partials: torch.Tensor) -> torch.Tensor:
    """(n_rows, n_moments) f64 partials -> (n_moments,) f64 sums."""
    if partials.dtype != torch.float64 or partials.dim() != 2:
        raise ValueError("finish_sum takes (rows, moments) float64 partials; "
                         f"got {tuple(partials.shape)} {partials.dtype}")
    return partials.sum(dim=0)
