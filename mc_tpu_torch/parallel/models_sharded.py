"""The model table: one row of wiring per non-GBM family (port of
``mc_tpu/parallel/models_sharded.py:42-327`` without the mesh).

``mc_tpu`` keys its model families by name in a registry (``_MODEL_DEFS``)
of ``ShardedModel`` rows, each carrying the family's stream tag, demo
dynamics, validation, packing, partials kernel and discount, so that every
entry point that takes ``model=`` is generic over them.  The port keeps the
table and its ten rows: Heston, Bates, CEV, Merton, SABR, the rainbow,
Vasicek, term structures, local vol and FX.  Each row's ``build`` returns
the packed parameter tensor and a ``partials(key, params, path_offset,
n_valid)`` that calls the port's own partials wrapper: kernel #12's Euler
loop, #14, #16, #17, #18, #19, #21 and #23 for the step-loop families, #27
and #28 for the terminal-draw families (rainbow, FX).  Like those wrappers
it launches the family's kernel for a CUDA tensor and runs its plain
version for a CPU one.

A family's host integer choices (Merton's and Bates's Poisson scan depth
``kmax``, local vol's knot count) come from its ``prepare`` as a tuple of
ints, the values the kernels take as ``FamilyExtras`` (as
``NMCFamily.extras``).

``checkpoint.chunked_price(model=...)`` reads this table.  The sharded
pricer ``price_model_sharded`` (one family's paths over several cards)
waits for ROADMAP item 20.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import numpy as np

from mc_tpu_torch.config import SimParams

__all__ = ["ShardedModel", "SHARDED_MODELS", "model_fingerprint"]


@dataclasses.dataclass(frozen=True)
class ShardedModel:
    """One model family's wiring.

    ``prepare(option, dyn, sim) -> (dyn, extras)`` validates and returns the
    family's integer extras; ``build(payoff, cfg, option, dyn, n_steps,
    device, extras) -> (params, partials)`` the packed tensor on ``device``
    and ``partials(key, params, path_offset, n_valid)``, the (rows, 2) f64
    moment partials of ``cfg.n_paths`` paths; ``discount(params, option)``
    the finish's discount as a float (default e^{-rT} in f64 from the f32
    fields, as ``engines.finish_price``).  ``cfg`` is a
    ``path_kernels.KernelConfig``: its ``n_paths``, ``antithetic``,
    ``rng_source`` and, under Merton, ``method``.
    """

    tag: int
    default_dyn: Callable[[SimParams], Any]
    build: Callable[..., Any]
    prepare: Optional[Callable[..., Any]] = None
    discount: Optional[Callable[..., float]] = None
    even_steps: bool = False
    terminal_only: bool = False   # rainbow/fx: one exact draw, n_steps = 1
    # Families whose payoff is a NAME in their own registry (rainbow, fx
    # contracts) supply a resolver: payoff-or-None -> name.
    resolve_payoff: Optional[Callable[[Any], Any]] = None

    def finish_discount(self, params, option) -> float:
        """The discount the finish applies (pathwise families: 1)."""
        if self.discount is not None:
            return self.discount(params, option)
        return math.exp(-float(np.float32(option.r))
                        * float(np.float32(option.t)))


def _key(key):
    return int(key[0]), int(key[1])


def _def_heston():
    from mc_tpu_torch.models.heston import DEMO_HESTON, HESTON_TAG
    return ShardedModel(tag=HESTON_TAG, default_dyn=lambda sim: DEMO_HESTON,
                        build=_build_heston)


def _build_heston(payoff, cfg, option, dyn, n_steps, device, extras):
    from mc_tpu_torch.models.heston import (HestonConfig, heston_partials,
                                            pack_heston)
    params = pack_heston(option, dyn, n_steps, device)
    hcfg = HestonConfig(n_paths=cfg.n_paths, n_steps=n_steps,
                        antithetic=cfg.antithetic, rng_source=cfg.rng_source)

    def partials(key, params, path_offset=0, n_valid=None):
        return heston_partials(payoff, hcfg, _key(key), params, path_offset,
                               n_valid)

    return params, partials


def _def_cev():
    from mc_tpu_torch.models.cev import CEV_TAG, DEMO_CEV
    return ShardedModel(tag=CEV_TAG, default_dyn=lambda sim: DEMO_CEV,
                        build=_build_cev, even_steps=True)


def _build_cev(payoff, cfg, option, dyn, n_steps, device, extras):
    from mc_tpu_torch.models.cev import CEVConfig, cev_partials, pack_cev
    params = pack_cev(option, dyn, n_steps, device)
    ccfg = CEVConfig(n_paths=cfg.n_paths, n_steps=n_steps,
                     antithetic=cfg.antithetic)

    def partials(key, params, path_offset=0, n_valid=None):
        return cev_partials(payoff, ccfg, _key(key), params, path_offset,
                            n_valid)

    return params, partials


def _jump_prepare(option, dyn, sim):
    from mc_tpu_torch.models.merton import poisson_kmax
    return dyn, (poisson_kmax(float(dyn.lam) * float(option.t)
                              / sim.n_steps),)


def _def_merton():
    from mc_tpu_torch.models.merton import DEMO_MERTON, MERTON_TAG
    return ShardedModel(tag=MERTON_TAG, default_dyn=lambda sim: DEMO_MERTON,
                        build=_build_merton, prepare=_jump_prepare,
                        even_steps=True)


def _build_merton(payoff, cfg, option, dyn, n_steps, device, extras):
    from mc_tpu_torch.models.merton import (MertonConfig, merton_partials,
                                            pack_merton)
    params = pack_merton(option, dyn, n_steps, device)
    mcfg = MertonConfig(n_paths=cfg.n_paths, n_steps=n_steps,
                        kmax=extras[0], method=cfg.method,
                        antithetic=cfg.antithetic, rng_source=cfg.rng_source)

    def partials(key, params, path_offset=0, n_valid=None):
        return merton_partials(payoff, mcfg, _key(key), params, path_offset,
                               n_valid)

    return params, partials


def _def_bates():
    from mc_tpu_torch.models.bates import BATES_TAG, DEMO_BATES
    return ShardedModel(tag=BATES_TAG, default_dyn=lambda sim: DEMO_BATES,
                        build=_build_bates, prepare=_jump_prepare)


def _build_bates(payoff, cfg, option, dyn, n_steps, device, extras):
    from mc_tpu_torch.models.bates import (BatesConfig, bates_partials,
                                           pack_bates)
    params = pack_bates(option, dyn, n_steps, device)
    bcfg = BatesConfig(n_paths=cfg.n_paths, n_steps=n_steps, kmax=extras[0],
                       antithetic=cfg.antithetic, rng_source=cfg.rng_source)

    def partials(key, params, path_offset=0, n_valid=None):
        return bates_partials(payoff, bcfg, _key(key), params, path_offset,
                              n_valid)

    return params, partials


def _def_sabr():
    from mc_tpu_torch.models.sabr import DEMO_SABR, SABR_TAG
    return ShardedModel(tag=SABR_TAG, default_dyn=lambda sim: DEMO_SABR,
                        build=_build_sabr)


def _build_sabr(payoff, cfg, option, dyn, n_steps, device, extras):
    from mc_tpu_torch.models.sabr import SABRConfig, pack_sabr, sabr_partials
    params = pack_sabr(option, dyn, n_steps, device)
    scfg = SABRConfig(n_paths=cfg.n_paths, n_steps=n_steps,
                      antithetic=cfg.antithetic, rng_source=cfg.rng_source)

    def partials(key, params, path_offset=0, n_valid=None):
        return sabr_partials(payoff, scfg, _key(key), params, path_offset,
                             n_valid)

    return params, partials


def _resolve_rainbow_payoff(payoff):
    from mc_tpu_torch.models.rainbow import get_rainbow_payoff
    return get_rainbow_payoff("call_on_max" if payoff is None else payoff)


def _def_rainbow():
    from mc_tpu_torch.models.basket import DEMO_BASKET
    from mc_tpu_torch.models.rainbow import RAINBOW_TAG
    return ShardedModel(tag=RAINBOW_TAG, default_dyn=lambda sim: DEMO_BASKET,
                        build=_build_rainbow, terminal_only=True,
                        resolve_payoff=_resolve_rainbow_payoff)


def _build_rainbow(payoff, cfg, option, dyn, n_steps, device, extras):
    from mc_tpu_torch.models.basket import pack_basket
    from mc_tpu_torch.models.rainbow import RainbowConfig, rainbow_partials
    b32 = dyn.as_f32()
    params = pack_basket(option, b32, 1, device)
    rcfg = RainbowConfig(n_paths=cfg.n_paths, d=b32.d,
                         antithetic=cfg.antithetic, rng_source=cfg.rng_source)

    def partials(key, params, path_offset=0, n_valid=None):
        # `payoff` is the rainbow payoff's name
        return rainbow_partials(payoff, rcfg, _key(key), params, path_offset,
                                n_valid)

    return params, partials


def _resolve_fx_contract(payoff):
    from mc_tpu_torch.models.fx import get_fx_contract
    return get_fx_contract("quanto_call" if payoff is None else payoff)


def _def_fx():
    from mc_tpu_torch.models.fx import DEMO_FX, FX_TAG
    return ShardedModel(tag=FX_TAG, default_dyn=lambda sim: DEMO_FX,
                        build=_build_fx, terminal_only=True,
                        resolve_payoff=_resolve_fx_contract)


def _build_fx(payoff, cfg, option, dyn, n_steps, device, extras):
    from mc_tpu_torch.models.fx import FXConfig, fx_partials, pack_fx
    params = pack_fx(option, dyn, device)
    fcfg = FXConfig(n_paths=cfg.n_paths, rng_source=cfg.rng_source)

    def partials(key, params, path_offset=0, n_valid=None):
        # `payoff` is the fx contract's name
        return fx_partials(payoff, fcfg, _key(key), params, path_offset,
                           n_valid)

    return params, partials


def _def_vasicek():
    from mc_tpu_torch.models.vasicek import DEMO_VASICEK, VASICEK_TAG
    return ShardedModel(tag=VASICEK_TAG,
                        default_dyn=lambda sim: DEMO_VASICEK,
                        build=_build_vasicek, even_steps=True,
                        discount=lambda params, option: 1.0)  # pathwise


def _build_vasicek(payoff, cfg, option, dyn, n_steps, device, extras):
    from mc_tpu_torch.models.vasicek import (VasicekConfig, pack_vasicek,
                                             vasicek_partials)
    params = pack_vasicek(option, dyn, n_steps, device)
    vcfg = VasicekConfig(n_paths=cfg.n_paths, n_steps=n_steps,
                         antithetic=cfg.antithetic, rng_source=cfg.rng_source)

    def partials(key, params, path_offset=0, n_valid=None):
        return vasicek_partials(payoff, vcfg, _key(key), params, path_offset,
                                n_valid)

    return params, partials


def _term_discount(params, option) -> float:
    # term discounts off its curve average: r_bar, packed in the head
    from mc_tpu_torch.models.term import HEAD_FIELDS
    return math.exp(-float(params[HEAD_FIELDS.index("r")])
                    * float(np.float32(option.t)))


def _def_term():
    from mc_tpu_torch.models.term import TERM_TAG, TermStructure

    def default_dyn(sim):
        return TermStructure.from_knots([0.10, 0.07, 0.05],
                                        [0.15, 0.22, 0.30], sim.n_steps)

    def prepare(option, dyn, sim):
        n = np.shape(dyn.rates)[0]
        if n != sim.n_steps:
            raise ValueError(f"term structure has {n} steps, sim has "
                             f"{sim.n_steps}")
        return dyn, ()

    return ShardedModel(tag=TERM_TAG, default_dyn=default_dyn,
                        build=_build_term, prepare=prepare, even_steps=True,
                        discount=_term_discount)


def _build_term(payoff, cfg, option, dyn, n_steps, device, extras):
    from mc_tpu_torch.models.term import (TermConfig, pack_term,
                                          term_partials, validate_term)
    params = pack_term(option, validate_term(dyn, n_steps), n_steps, device)
    tcfg = TermConfig(n_paths=cfg.n_paths, n_steps=n_steps,
                      antithetic=cfg.antithetic)

    def partials(key, params, path_offset=0, n_valid=None):
        return term_partials(payoff, tcfg, _key(key), params, path_offset,
                             n_valid)

    return params, partials


def _def_localvol():
    from mc_tpu_torch.models.localvol import LOCALVOL_TAG, LocalVolSurface

    def prepare(option, dyn, sim):
        from mc_tpu_torch.models.localvol import validate_surface
        surf = validate_surface(dyn, sim.n_steps)
        return surf, (surf.n_knots,)

    return ShardedModel(tag=LOCALVOL_TAG,
                        default_dyn=lambda sim: LocalVolSurface.demo(
                            sim.n_steps),
                        build=_build_localvol, prepare=prepare,
                        even_steps=True)


def _build_localvol(payoff, cfg, option, dyn, n_steps, device, extras):
    from mc_tpu_torch.models.localvol import (LocalVolConfig,
                                              localvol_partials,
                                              pack_localvol)
    params = pack_localvol(option, dyn, n_steps, device)
    lcfg = LocalVolConfig(n_paths=cfg.n_paths, n_steps=n_steps,
                          n_knots=extras[0], antithetic=cfg.antithetic,
                          rng_source=cfg.rng_source)

    def partials(key, params, path_offset=0, n_valid=None):
        return localvol_partials(payoff, lcfg, _key(key), params,
                                 path_offset, n_valid)

    return params, partials


# Registry: model name -> its row's definition, built on first use so that
# importing the package imports no family module.
_MODEL_DEFS: dict = {
    "heston": _def_heston, "bates": _def_bates, "cev": _def_cev,
    "merton": _def_merton,
    "sabr": _def_sabr, "rainbow": _def_rainbow, "vasicek": _def_vasicek,
    "term": _def_term, "localvol": _def_localvol, "fx": _def_fx,
}

SHARDED_MODELS = tuple(_MODEL_DEFS)


@functools.lru_cache(maxsize=None)
def _model_def(model: str) -> ShardedModel:
    """The table's row for ``model`` (KeyError for a name not in it)."""
    return _MODEL_DEFS[model]()


def model_fingerprint(dyn) -> str:
    """Every leaf of the dynamics dataclass ``dyn``, in field order, as f32
    values printed ``%.9g`` and joined by commas: ``mc_tpu``'s checkpoint
    meta ``dyn`` (its pytree leaves are the dataclass fields in order)."""
    return ",".join(
        f"{float(v):.9g}"
        for f in dataclasses.fields(dyn)
        for v in np.asarray(np.asarray(getattr(dyn, f.name), np.float32),
                            np.float64).ravel())
