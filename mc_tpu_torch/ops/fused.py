"""The rates' fused moment partials: kernel #11 (port of
``mc_tpu/ops/_pallas.py:107 fused_moment_partials``, its ``pallas_call`` at
``:145``).

In ``mc_tpu`` this is one scaffold for every packed-params terminal pricer:
a grid over path tiles that Kahan-accumulates the (sum, sumsq) slabs of a
per-path payoff ``tile(pv, ids, valid, k0, k1)`` reading only a packed f32
vector.  Its users are the European swaption tiles of the rates, so the
port names them, each a device functor in ``csrc/rates.cuh`` and a plain
PyTorch payoff beside its model:

    tile    payoff (plain)                         packed floats
    va      models.swaption.va_swpt_pay            10 + 2n   (Vasicek)
    hw      models.hullwhite.hw_swpt_pay           7 + 3n    (Hull-White)
    hw_mc   models.hullwhite.hw_mc_swpt_pay        8 + 4n    (multi-curve)
    g2      models.g2pp.g2_swpt_pay                10 + 4n   (G2++)
    g2_mc   models.g2pp.g2_mc_swpt_pay             11 + 5n   (multi-curve)

with n = n_payments.  Each path draws the threefry-13 pair at counter (id,
0) (and G2++ an inverse-CDF normal at (id, 1)), prices the swap's n bonds
and returns the discounted positive part; ``mc_tpu`` prices the multi-curve
swaptions only on its classic XLA route, whose per-path arithmetic the two
``_mc`` tiles follow.

The kernel (``csrc/rates_kernels.cu`` ``rates_partials_kernel<Tile, P,
staged>``) sums 256 paths a block, grid-strided, P paths a thread in
lockstep (thread t of T = 256 / P runs paths t, t + T, ...), each path's
f64 [pay, pay^2] in a lane of its own; the lanes add as the top levels of
the tree a block of 256 one-path threads would run, and one f64 row of
[sum pay, sum pay^2] per block comes out (``csrc/reduce.cuh``).  A block
stages the pack's header, and up to ``mc_rates_stage_payments()`` payments
its tables, in shared memory; past that it reads the tables in place (the
library picks the path by ``n_pay``).  The plain version computes the same
f32 payoffs and adds them in that order: path b*256 + t's grid-stride
share in sequence, then the 256-wide tree.  So the two return the same rows bit for bit
wherever their per-path payoffs agree.  The wrapper takes the plain
version only when ``pv`` lies on the CPU; for a CUDA tensor it launches the
kernel or raises.  ``mc_tpu``'s ``use_interpret`` and its (8, 128) slab
helpers describe the TPU and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops import path_kernels as pk

__all__ = ["RatesTile", "TILES", "RATES_THREADS", "packed_length",
           "fused_moment_partials", "fused_moment_partials_plain",
           "block_rows"]

# Paths a block of the rates kernel (csrc/rates_kernels.cu kRatesTile): the
# threads of the one-path-a-thread tree whose order the kernel's lanes keep
# and the plain version reduces in.
RATES_THREADS = 256


class RatesTile(NamedTuple):
    cuda_id: int      # the tile's id in csrc/rates_kernels.cu
    header: int       # packed floats besides the per-payment tables
    per_payment: int  # packed floats per payment


TILES = {"va": RatesTile(0, 10, 2), "hw": RatesTile(1, 7, 3),
         "hw_mc": RatesTile(2, 8, 4), "g2": RatesTile(3, 10, 4),
         "g2_mc": RatesTile(4, 11, 5)}


def _tile(tile: str) -> RatesTile:
    if tile not in TILES:
        raise KeyError(f"unknown rates tile {tile!r}; available: "
                       f"{sorted(TILES)}")
    return TILES[tile]


def packed_length(tile: str, n_pay: int) -> int:
    """The length of ``tile``'s packed vector for ``n_pay`` payments."""
    t = _tile(tile)
    return t.header + t.per_payment * n_pay


def _pay_fn(tile: str):
    from mc_tpu_torch.models import g2pp, hullwhite, swaption

    return {"va": swaption.va_swpt_pay, "hw": hullwhite.hw_swpt_pay,
            "hw_mc": hullwhite.hw_mc_swpt_pay, "g2": g2pp.g2_swpt_pay,
            "g2_mc": g2pp.g2_mc_swpt_pay}[tile]


def _check(tile: str, n_pay: int, pv, n_paths: int) -> None:
    if n_pay < 1:
        raise ValueError(f"n_pay must be >= 1, got {n_pay}")
    if not 0 < n_paths < 1 << 32:
        raise ValueError(f"n_paths must be in [1, 2^32); got {n_paths}")
    want = packed_length(tile, n_pay)
    if (not torch.is_tensor(pv) or pv.dtype != torch.float32
            or pv.shape != (want,) or not pv.is_contiguous()
            or pv.device.type not in ("cpu", "cuda")):
        raise ValueError(
            f"pv must be a contiguous float32 ({want},) tensor (the {tile} "
            f"pack at n_pay={n_pay}) on the CPU or a CUDA device; got "
            f"{getattr(pv, 'shape', None)} "
            f"{getattr(pv, 'dtype', type(pv))}")


def _n_blocks(n_paths: int) -> int:
    return min(_cuda.cdiv(n_paths, RATES_THREADS), _cuda.MAX_BLOCKS)


def block_rows(pay: torch.Tensor) -> torch.Tensor:
    """(n_blocks, 2) f64 [sum pay, sum pay^2] of the f32 per-path ``pay``,
    added as the kernel adds them: slot t of block b (T = RATES_THREADS
    slots; the kernel's thread t mod T/P, lane t div T/P) sums paths b*T +
    t, + stride, ... (stride = n_blocks*T) in f64 in that order, then the
    block's tree halves its T sums (the lanes' folds, then ``reduce.cuh``
    block_store_moments_warp)."""
    n = pay.shape[0]
    n_blocks = _n_blocks(n)
    stride = n_blocks * RATES_THREADS
    k = _cuda.cdiv(n, stride)
    vals = torch.zeros((2, k * stride), dtype=torch.float32,
                       device=pay.device)
    vals[0, :n] = pay
    vals[1, :n] = pay * pay
    vals = vals.view(2, k, stride).double()
    acc = vals[:, 0]
    for i in range(1, k):
        acc = acc + vals[:, i]
    acc = acc.view(2, n_blocks, RATES_THREADS)
    s = RATES_THREADS // 2
    while s:
        acc = acc[..., :s] + acc[..., s:]
        s //= 2
    return acc[..., 0].T.contiguous()


def fused_moment_partials_plain(tile: str, n_pay: int, key, pv: torch.Tensor,
                                n_paths: int, path_offset: int = 0,
                                n_valid=None) -> torch.Tensor:
    """Plain version of the rates kernel: ``tile``'s payoffs over paths
    ``path_offset + i`` (those at or past the bound add zeros) in chunks,
    reduced by ``block_rows``."""
    _check(tile, n_pay, pv, n_paths)
    pay_fn = _pay_fn(tile)
    bound = pk._bound(path_offset, n_paths, n_valid)
    k0, k1 = int(key[0]), int(key[1])
    chunk = pk.plain_chunk(pv)
    pays = []
    for start in range(0, n_paths, chunk):
        local = torch.arange(start, min(start + chunk, n_paths),
                             dtype=torch.int64, device=pv.device)
        ids = (local + path_offset) & 0xFFFFFFFF
        pays.append(torch.where(ids < bound, pay_fn(n_pay, pv, ids, k0, k1),
                                0.0))
    return block_rows(torch.cat(pays))


def fused_moment_partials(tile: str, n_pay: int, key, pv: torch.Tensor,
                          n_paths: int, path_offset: int = 0,
                          n_valid=None) -> torch.Tensor:
    """(n_blocks, 2) f64 [sum pay, sum pay^2] rows of ``n_paths`` paths of
    ``tile`` (``TILES``) with ``n_pay`` payments (global ids ``path_offset
    + i``, masked at ``n_valid``, default the end of the run);
    ``ops/reduce.finish_sum`` finishes them.  ``pv``: the tile's pack."""
    _check(tile, n_pay, pv, n_paths)
    if pv.device.type == "cpu":
        return fused_moment_partials_plain(tile, n_pay, key, pv, n_paths,
                                           path_offset, n_valid)
    lib = _cuda.load()
    paths = lib.mc_rates_block_paths()
    if paths != RATES_THREADS:
        raise RuntimeError(f"the rates kernel sums {paths} paths a block; "
                           f"mc_tpu_torch expects {RATES_THREADS}")
    bound = pk._bound(path_offset, n_paths, n_valid)
    n_blocks = _n_blocks(n_paths)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64,
                           device=pv.device)
    with torch.cuda.device(pv.device):
        status = lib.mc_rates_partials(
            TILES[tile].cuda_id, n_pay, int(key[0]), int(key[1]),
            pv.data_ptr(), n_paths, path_offset & 0xFFFFFFFF, bound,
            partials.data_ptr(), n_blocks, _cuda.stream_handle(pv.device))
    _cuda.check(status, f"rates_partials kernel ({tile})")
    _cuda.count_launch(f"rates_partials_{tile}")
    return partials
