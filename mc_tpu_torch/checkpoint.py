"""Checkpoint/resume for long Monte Carlo runs (port of
``mc_tpu/checkpoint.py:51-319``, GBM).

The counter-based stream makes any global path range ``[offset,
offset + n)`` recomputable from ``(seed, offset)`` alone, so a checkpoint
is the moment sums so far and the next offset: a few bytes, whatever the
path count.  ``chunked_price`` prices ``sim.n_paths`` paths in chunks of
``chunk_paths`` (bounding each kernel's latency for a preemptible worker):
chunk k is one simulate kernel at ``path_offset = start``, its f64 sums
are added to the running f64 sums in chunk order, and a snapshot is
written after every chunk.  ``resume=True`` continues from the snapshot;
the chunk boundaries, not the wall clock, define the order of the sums, so
a resumed run is bitwise the uninterrupted one.

The TPU's Kahan (8, 128) f32 slabs become f64 sums here, so the file
layout differs from ``mc_tpu``'s and carries its own magic;
``convert.checkpoint`` carries an ``mc_tpu`` checkpoint across.  The model
families (``model=``) come with ROADMAP item 13 and elastic runs over
several cards (``mesh=``) with item 20.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_OUTER, finish_price, resolve_device
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

__all__ = ["chunked_price", "load_checkpoint", "Checkpoint"]

MAGIC = "mc_tpu_torch-checkpoint-v1"


@dataclasses.dataclass
class Checkpoint:
    """The accumulated moment sums after ``paths_done`` of ``n_paths``
    paths: ``sums`` is (sum pay, sum pay^2), f64."""

    paths_done: int
    n_paths: int
    sums: np.ndarray
    meta: dict

    def save(self, path: str) -> None:
        """Write to ``path`` through a temporary file and an atomic rename,
        so a reader sees the old snapshot or the new one, never a part."""
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, magic=MAGIC, paths_done=self.paths_done,
                     n_paths=self.n_paths,
                     sums=np.asarray(self.sums, np.float64),
                     **{f"meta_{k}": v for k, v in self.meta.items()})
        os.replace(tmp, path)


def load_checkpoint(path: str) -> Checkpoint:
    with np.load(path, allow_pickle=False) as z:
        if "magic" not in z.files or str(z["magic"]) != MAGIC:
            raise ValueError(f"{path} is not an mc_tpu_torch checkpoint "
                             "(convert.checkpoint reads mc_tpu's)")
        meta = {k[5:]: z[k].item() if z[k].ndim == 0 else z[k]
                for k in z.files if k.startswith("meta_")}
        return Checkpoint(paths_done=int(z["paths_done"]),
                          n_paths=int(z["n_paths"]), sums=z["sums"],
                          meta=meta)


def chunked_price(option: OptionParams = DEMO_OPTION,
                  sim: SimParams = DEMO_SIM,
                  payoff="vanilla_call",
                  *,
                  chunk_paths: int = 1 << 24,
                  checkpoint_path: Optional[str] = None,
                  resume: bool = False,
                  method: Optional[str] = None,
                  rng_source: str = "threefry13",
                  stream: int = STREAM_OUTER,
                  model: str = "gbm",
                  device="cuda") -> PriceResult:
    """Price ``sim.n_paths`` paths in chunks on ``device``, with optional
    checkpointing.

    ``method`` is the simulate kernel's ("terminal" for terminal-only
    payoffs by default, else "euler"), on the per-path stream, so the
    result is ``price(method=method)`` up to the order of its f64 sums.
    The snapshot's meta fingerprints the run (seed, payoff, method, chunk
    size, rng source, steps, market data); resuming under any other raises.
    """
    po = get_payoff(payoff)
    if model != "gbm":
        raise ValueError(f"chunked_price takes model='gbm' only; the model "
                         f"families ({model!r}) come with ROADMAP item 13")
    if rng_source not in ("threefry", "threefry13"):
        # 'hw' is stateful: a resumed run could not be bitwise the
        # uninterrupted one, which is this module's contract.
        raise ValueError(f"rng_source {rng_source!r} not resumable; use "
                         "'threefry13' or 'threefry'")
    if method is None:
        method = "terminal" if po.terminal_only else "euler"
    po.validate(option, sim.n_steps)
    dev = resolve_device(device)
    chunk_paths = min(int(chunk_paths), sim.n_paths)
    if chunk_paths < 1:
        raise ValueError(f"chunk_paths must be positive; got {chunk_paths}")
    key = rng.derive_key(sim.seed, stream)
    meta = dict(seed=sim.seed, payoff=po.name, method=method,
                chunk_paths=chunk_paths,
                # the stream is part of the contract: resuming a run
                # recorded under another round count must fail loudly
                rng_source=rng_source, n_steps=sim.n_steps,
                # the market data: resuming under other dynamics must fail
                # loudly, not merge distributions
                option=",".join(f"{v:.9g}" for v in
                                (float(x) for x in option.astuple())),
                model=model, dyn="")

    start = 0
    sums = torch.zeros(2, dtype=torch.float64, device=dev)
    if resume:
        if not (checkpoint_path and os.path.exists(checkpoint_path)):
            raise FileNotFoundError(
                f"resume requested but no checkpoint at {checkpoint_path}")
        ck = load_checkpoint(checkpoint_path)
        for k, v in meta.items():
            if str(ck.meta.get(k)) != str(v):
                raise ValueError(
                    f"checkpoint mismatch for {k!r}: {ck.meta.get(k)} != {v}")
        if ck.n_paths != sim.n_paths:
            raise ValueError("checkpoint n_paths mismatch")
        start = ck.paths_done
        sums = torch.as_tensor(np.asarray(ck.sums, np.float64)).to(dev)

    params = pk.pack_params(option, sim.n_steps, dev)
    while start < sim.n_paths:
        n_local = min(chunk_paths, sim.n_paths - start)
        cfg = pk.KernelConfig(n_paths=n_local, n_steps=sim.n_steps,
                              method=method, rng_source=rng_source)
        sums = sums + finish_sum(pk.simulate_partials(
            po, cfg, key, params, path_offset=start, n_valid=sim.n_paths))
        start += n_local
        if checkpoint_path:
            Checkpoint(paths_done=start, n_paths=sim.n_paths,
                       sums=sums.cpu().numpy(), meta=meta
                       ).save(checkpoint_path)
    return finish_price(sums, sim.n_paths, option)
