"""Netting-set nested Monte Carlo: EE/PFE/CVA of a B-contract book (port
of ``mc_tpu/nmc_book.py:57-237``).

An XVA desk computes exposure on a netting set, many trades with one
counterparty netted per (path, step) point before the positive part:

    EE_net(t_j) = E[ max( sum_b w_b V^b_ij , 0 ) ]

which is at most sum_b EE_b (netting subadditivity).

Every contract is the grid ``price_nmc`` / ``price_nmc_family`` on the
same outer and inner keys (common random numbers), so the per-point values
are priced under the same market scenarios and the netted surface has the
contracts' correlation by construction: under GBM the trajectories kernel
(#4) and the inner kernel (#5), under a family its trajectories (the family
template, or its own kernel) and ``family_inner`` (#29).  The contracts run
one after another in Python; the netted surface is ``net + w_b *
surface_b`` in f32 in contract order, so a one-contract book is bitwise
the grid ``price_nmc`` / ``price_nmc_<model>``.

Netting needs one market state: s0, r, sigma, q and t must be equal across
the book's rows, while the contract terms (k, barrier, p1, p2) vary.
``weights`` are signed position sizes (shorts are first-class).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from mc_tpu_torch.config import DEMO_SIM, OptionParams, SimParams
from mc_tpu_torch.engines import STREAM_INNER, STREAM_OUTER, resolve_device
from mc_tpu_torch.nmc import price_nmc
from mc_tpu_torch.oracle import PriceResult
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.xva import ExposureMetrics

__all__ = ["price_nmc_book", "NMCBookResult"]

_MARKET_FIELDS = ("s0", "r", "sigma", "q", "t")
# The families with a book form (mc_tpu's; rainbow and term have none).
_BOOK_MODELS = ("heston", "bates", "merton", "cev", "localvol", "sabr",
                "vasicek", "basket")


@dataclasses.dataclass(frozen=True)
class NMCBookResult(ExposureMetrics):
    """Netted value surface and per-contract diagnostics.

    ``net_surface[j, i]`` is the netted MtM sum_b w_b V^b at outer path i
    after step j+1, ``(n_steps, n_paths)`` f32; ``outers`` the contracts'
    outer estimates (a PriceResult of (B,) tensors); ``ee_contract[b]``
    contract b's standalone expected exposure of w_b V^b, ``(B, n_steps)``;
    ``net_outer_price`` sum_b w_b outer_b.  The exposure and XVA metrics
    read the netted surface.
    """

    net_surface: Any
    outers: PriceResult
    ee_contract: Any
    net_outer_price: Any
    n_paths: Any
    t_horizon: Any

    def surface_matrix(self):
        """(n_paths, n_steps) view of the netted surface."""
        return self.net_surface.T


def _contract(cols: dict, b: int) -> OptionParams:
    return OptionParams(**{f: float(cols[f][b]) for f in cols})


def price_nmc_book(options: OptionParams,
                   sim: SimParams = DEMO_SIM,
                   payoff="vanilla_call",
                   weights=None,
                   *,
                   model: str = "gbm",
                   dyn=None,
                   stream_outer: int = STREAM_OUTER,
                   stream_inner: int = STREAM_INNER,
                   device="cuda") -> NMCBookResult:
    """Netting-set NMC on ``device``: netted EE/PFE/CVA over a B-contract
    book.

    ``options``: an OptionParams whose fields are (B,) arrays (scalars
    broadcast); the market fields (s0, r, sigma, q, t) must agree across
    the rows, the contract terms (k, barrier, p1, p2) may vary.
    ``weights``: (B,) position sizes (negative = short), default all +1.
    ``model``: "gbm" or a family of ``_BOOK_MODELS``, whose dynamics
    ``dyn`` the book is netted under (the keys carry the family's tag, as
    ``price_nmc_<model>``'s).
    """
    po = get_payoff(payoff)
    if po.n_state > 1:
        raise ValueError("NMC supports payoffs with at most one state array")
    po.validate(options, sim.n_steps)
    b_shape = np.shape(options.k)
    if len(b_shape) != 1 or b_shape[0] < 1:
        raise ValueError("options fields must be 1-D (B,) arrays; got "
                         f"strike shape {b_shape}")
    n_contracts = int(b_shape[0])
    cols = {f.name: np.broadcast_to(
        np.asarray(getattr(options, f.name), np.float32), (n_contracts,))
        for f in dataclasses.fields(OptionParams)}
    for f in _MARKET_FIELDS:
        col = cols[f]
        if not np.all(col == col[0]):
            raise ValueError(
                f"netting requires one market state: field {f!r} differs "
                f"across the book ({col.tolist()}); only contract terms "
                "(k, barrier, p1, p2) may vary")
    w = (np.ones((n_contracts,), np.float32) if weights is None
         else np.asarray(weights, np.float32))
    if w.shape != (n_contracts,):
        raise ValueError(f"weights shape {w.shape} != ({n_contracts},)")
    fam = dyn32 = None
    if model != "gbm":
        from mc_tpu_torch.nmc_engine import (NMC_FAMILY_BUILDERS,
                                             ensure_family, price_nmc_family)
        if model not in _BOOK_MODELS:
            raise ValueError(f"unknown book model {model!r}; available: "
                             f"('gbm',) + {_BOOK_MODELS}")
        ensure_family(model)
        fam, dyn32 = NMC_FAMILY_BUILDERS[model](_contract(cols, 0), dyn, sim)
    dev = resolve_device(device)

    net = torch.zeros((sim.n_steps, sim.n_paths), dtype=torch.float32,
                      device=dev)
    outers, ees = [], []
    for b in range(n_contracts):
        # the grid pipeline on the book's keys; price_nmc_family checks
        # the even steps and the inner counter span before contract 0 runs
        if fam is None:
            res = price_nmc(_contract(cols, b), sim, po, strategy="grid",
                            stream_outer=stream_outer,
                            stream_inner=stream_inner, device=dev)
        else:
            res = price_nmc_family(fam, _contract(cols, b), dyn32, sim, po,
                                   strategy="grid", stream_outer=stream_outer,
                                   stream_inner=stream_inner, device=dev)
        outers.append(res.outer)
        w_surface = res.surface * float(w[b])
        # the standalone EE of the weighted position
        ees.append(torch.clamp(w_surface, min=0.0).sum(dim=1) / sim.n_paths)
        net = net + w_surface
    stacked = PriceResult(*(torch.stack([torch.as_tensor(
        getattr(o, f.name), dtype=torch.float64, device=dev) for o in outers])
        for f in dataclasses.fields(PriceResult)))
    net_outer = torch.sum(torch.as_tensor(w, dtype=torch.float64, device=dev)
                          * stacked.price)
    return NMCBookResult(net_surface=net, outers=stacked,
                         ee_contract=torch.stack(ees),
                         net_outer_price=net_outer, n_paths=sim.n_paths,
                         t_horizon=float(cols["t"][0]))
