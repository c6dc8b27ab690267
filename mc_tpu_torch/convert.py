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
import torch

from mc_tpu_torch.checkpoint import Checkpoint
from mc_tpu_torch.config import OptionParams, SimParams
from mc_tpu_torch import qmc as _qmc
from mc_tpu_torch.models import basket as _basket
from mc_tpu_torch.models import dividends as _divs
from mc_tpu_torch.models.fx import FX_FIELDS, FXDynamics
from mc_tpu_torch.models.g2pp import G2Dynamics
from mc_tpu_torch.models.hullwhite import DiscountCurve, HullWhiteDynamics
from mc_tpu_torch.models.swaption import SwaptionSpec
from mc_tpu_torch.models import term as _term
from mc_tpu_torch.models.bates import BATES_FIELDS, BatesDynamics
from mc_tpu_torch.models.cev import CEV_FIELDS, CEVDynamics
from mc_tpu_torch.models.heston import HESTON_FIELDS, HestonDynamics
from mc_tpu_torch.models.localvol import LocalVolSurface, packed_length
from mc_tpu_torch.models.merton import MERTON_FIELDS, MertonDynamics
from mc_tpu_torch.models.sabr import SABR_FIELDS, SABRDynamics
from mc_tpu_torch.models.vasicek import VASICEK_FIELDS, VasicekDynamics
from mc_tpu_torch.ops import fused as _fused

__all__ = ["option_params", "book_params", "sim_params", "key",
           "surface_matrix", "book_surface", "checkpoint", "heston_dynamics",
           "heston_params", "merton_dynamics", "merton_params",
           "bates_dynamics", "bates_params", "cev_dynamics", "cev_params", "localvol_surface",
           "localvol_params", "sabr_dynamics", "sabr_params",
           "term_structure", "term_params", "divs_params",
           "vasicek_dynamics", "vasicek_params", "basket_dynamics",
           "basket_params", "rainbow_dynamics", "rainbow_params",
           "fx_dynamics", "fx_params", "qmc_pointset", "swaption_spec",
           "discount_curve", "hw_dynamics", "g2_dynamics", "va_swpt_params",
           "hw_swpt_params", "g2_swpt_params"]

_OPTION_FIELDS = ("s0", "t", "k", "r", "sigma", "barrier", "p1", "p2", "q")
_SIM_FIELDS = ("n_paths", "n_steps", "n_paths_inner", "seed")
_HESTON_DYN_FIELDS = ("v0", "kappa", "theta", "xi", "rho")
_MERTON_DYN_FIELDS = ("lam", "mu_j", "sigma_j")
_BATES_DYN_FIELDS = _HESTON_DYN_FIELDS + _MERTON_DYN_FIELDS
_CEV_DYN_FIELDS = ("sigma_lv", "beta")
_SABR_DYN_FIELDS = ("alpha", "beta", "nu", "rho")
_VASICEK_DYN_FIELDS = ("a", "b", "sigma_r", "rho")
_BASKET_FIELDS = ("s0s", "sigmas", "weights", "corr")
_HW_DYN_FIELDS = ("a", "sigma_r")
_G2_DYN_FIELDS = ("a", "sigma", "b_mr", "eta", "rho")


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def option_params(src) -> OptionParams:
    """``mc_tpu.OptionParams`` fields (scalars) -> the port's OptionParams
    (one contract; ``book_params`` takes a book)."""
    return OptionParams(*_scalars(src, _OPTION_FIELDS, "option"))


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


def _scalars(src, fields, what):
    vals = []
    for f in fields:
        v = np.asarray(_field(src, f))
        if v.shape != ():
            raise ValueError(f"{what} field {f!r} must be a scalar; got "
                             f"shape {v.shape}")
        vals.append(float(v))
    return vals


def _packed(arr, fields, what) -> torch.Tensor:
    return _packed_vector(arr, len(fields), what)


def _packed_vector(arr, want: int, what: str) -> torch.Tensor:
    a = np.asarray(arr)
    if a.shape != (want,) or a.dtype != np.float32:
        raise ValueError(f"packed {what} parameters are {want} float32 "
                         f"values; got {a.shape} {a.dtype}")
    return torch.from_numpy(a.copy())


def heston_dynamics(src) -> HestonDynamics:
    """``mc_tpu.models.heston.HestonDynamics`` fields (scalars) -> the
    port's HestonDynamics."""
    return HestonDynamics(*_scalars(src, _HESTON_DYN_FIELDS, "Heston"))


def heston_params(arr) -> torch.Tensor:
    """``mc_tpu``'s packed Heston parameters (``_pack_heston``: the (17,)
    f32 vector of ``HESTON_FIELDS``) -> the port's CPU tensor, bit for
    bit; ``.to(device)`` it for a kernel."""
    return _packed(arr, HESTON_FIELDS, "Heston")


def merton_dynamics(src) -> MertonDynamics:
    """``mc_tpu.models.merton.MertonDynamics`` fields (scalars) -> the
    port's MertonDynamics."""
    return MertonDynamics(*_scalars(src, _MERTON_DYN_FIELDS, "Merton"))


def merton_params(arr) -> torch.Tensor:
    """``mc_tpu``'s packed Merton parameters (``_pack_merton``: the (19,)
    f32 vector of ``MERTON_FIELDS``) -> the port's CPU tensor, bit for
    bit."""
    return _packed(arr, MERTON_FIELDS, "Merton")


def bates_dynamics(src) -> BatesDynamics:
    """``mc_tpu.models.bates.BatesDynamics`` fields (scalars) -> the port's
    BatesDynamics."""
    return BatesDynamics(*_scalars(src, _BATES_DYN_FIELDS, "Bates"))


def bates_params(arr) -> torch.Tensor:
    """``mc_tpu``'s packed Bates parameters (``_pack_bates``: the (20,) f32
    vector of ``BATES_FIELDS``) -> the port's CPU tensor, bit for bit."""
    return _packed(arr, BATES_FIELDS, "Bates")


def cev_dynamics(src) -> CEVDynamics:
    """``mc_tpu.models.cev.CEVDynamics`` fields (scalars) -> the port's
    CEVDynamics."""
    return CEVDynamics(*_scalars(src, _CEV_DYN_FIELDS, "CEV"))


def cev_params(arr) -> torch.Tensor:
    """``mc_tpu``'s packed CEV parameters (``_pack_cev``: the (13,) f32
    vector of ``CEV_FIELDS``) -> the port's CPU tensor, bit for bit."""
    return _packed(arr, CEV_FIELDS, "CEV")


def localvol_surface(src) -> LocalVolSurface:
    """``mc_tpu.models.localvol.LocalVolSurface`` (``x_knots`` (K,) and
    ``vols`` (n_steps, K), arrays numpy can read) -> the port's, as f32
    numpy arrays."""
    xs = np.asarray(_field(src, "x_knots"), np.float32)
    vols = np.asarray(_field(src, "vols"), np.float32)
    if xs.ndim != 1 or vols.ndim != 2 or vols.shape[1] != xs.shape[0]:
        raise ValueError(f"a surface is x_knots (K,) and vols (n_steps, K); "
                         f"got {xs.shape} and {vols.shape}")
    return LocalVolSurface(x_knots=xs.copy(), vols=vols.copy())


def localvol_params(arr, n_knots: int, n_steps: int) -> torch.Tensor:
    """``mc_tpu``'s packed local-vol vector (``_pack_localvol``) -> the
    port's CPU tensor, bit for bit, its length checked against
    11 + 2K - 1 + n_steps*K."""
    return _packed_vector(arr, packed_length(n_knots, n_steps),
                          f"local-vol (K={n_knots}, n_steps={n_steps})")


def sabr_dynamics(src) -> SABRDynamics:
    """``mc_tpu.models.sabr.SABRDynamics`` fields (scalars) -> the port's
    SABRDynamics."""
    return SABRDynamics(*_scalars(src, _SABR_DYN_FIELDS, "SABR"))


def sabr_params(arr) -> torch.Tensor:
    """``mc_tpu``'s packed SABR parameters (``_pack_sabr``: the (17,) f32
    vector of ``SABR_FIELDS``) -> the port's CPU tensor, bit for bit."""
    return _packed(arr, SABR_FIELDS, "SABR")


def term_structure(src) -> _term.TermStructure:
    """``mc_tpu.models.term.TermStructure`` (``rates`` and ``sigmas``, one
    entry per step, arrays numpy can read) -> the port's, as f32 numpy
    arrays."""
    rates = np.asarray(_field(src, "rates"), np.float32)
    sigmas = np.asarray(_field(src, "sigmas"), np.float32)
    if rates.ndim != 1 or rates.shape != sigmas.shape:
        raise ValueError(f"a term structure is rates and sigmas, both "
                         f"(n_steps,); got {rates.shape} and {sigmas.shape}")
    return _term.TermStructure(rates=rates.copy(), sigmas=sigmas.copy())


def term_params(arr, n_steps: int) -> torch.Tensor:
    """``mc_tpu``'s packed term-structure vector (``_pack_term``) -> the
    port's CPU tensor, bit for bit, its length checked against
    11 + 2*n_steps."""
    return _packed_vector(arr, _term.packed_length(n_steps),
                          f"term-structure (n_steps={n_steps})")


def divs_params(arr, n_steps: int) -> torch.Tensor:
    """``mc_tpu``'s packed cash-dividend vector (``_pack_divs``) -> the
    port's CPU tensor, bit for bit, its length checked against
    13 + n_steps."""
    return _packed_vector(arr, _divs.packed_length(n_steps),
                          f"cash-dividend (n_steps={n_steps})")


def vasicek_dynamics(src) -> VasicekDynamics:
    """``mc_tpu.models.vasicek.VasicekDynamics`` fields (scalars) -> the
    port's VasicekDynamics."""
    return VasicekDynamics(*_scalars(src, _VASICEK_DYN_FIELDS, "Vasicek"))


def vasicek_params(arr) -> torch.Tensor:
    """``mc_tpu``'s packed Vasicek parameters (``_pack_vasicek``: the (22,)
    f32 vector of ``VASICEK_FIELDS``) -> the port's CPU tensor, bit for
    bit."""
    return _packed(arr, VASICEK_FIELDS, "Vasicek")


def basket_dynamics(src) -> _basket.BasketDynamics:
    """``mc_tpu.models.basket.BasketDynamics`` (``s0s``, ``sigmas``,
    ``weights`` (d,) and ``corr`` (d, d), arrays numpy can read) -> the
    port's, as f32 numpy arrays."""
    s0s, sigmas, weights, corr = (np.asarray(_field(src, f), np.float32)
                                  for f in _BASKET_FIELDS)
    d = s0s.shape[0] if s0s.ndim == 1 else -1
    if (d < 1 or sigmas.shape != (d,) or weights.shape != (d,)
            or corr.shape != (d, d)):
        raise ValueError(f"a basket is s0s, sigmas, weights (d,) and corr "
                         f"(d, d); got {s0s.shape}, {sigmas.shape}, "
                         f"{weights.shape} and {corr.shape}")
    return _basket.BasketDynamics(s0s.copy(), sigmas.copy(), weights.copy(),
                                  corr.copy())


def basket_params(arr, d: int) -> torch.Tensor:
    """``mc_tpu``'s packed basket vector (``_pack_basket``) -> the port's
    CPU tensor, bit for bit, its length checked against 10 + 3d +
    d(d+1)/2."""
    return _packed_vector(arr, _basket.packed_length(d), f"basket (d={d})")


# The rainbow reads the basket's dynamics and its pack at n_steps = 1.
rainbow_dynamics = basket_dynamics
rainbow_params = basket_params


def fx_dynamics(src) -> FXDynamics:
    """``mc_tpu.models.fx.FXDynamics`` fields (scalars; ``kx`` and
    ``x_bar`` may be None, meaning x0) -> the port's FXDynamics."""
    x0, sigma_x, r_f, rho = _scalars(src, ("x0", "sigma_x", "r_f", "rho"),
                                     "FX")
    kx, x_bar = (None if _field(src, f) is None else float(_field(src, f))
                 for f in ("kx", "x_bar"))
    return FXDynamics(x0=x0, sigma_x=sigma_x, r_f=r_f, rho=rho, kx=kx,
                      x_bar=x_bar)


def fx_params(arr) -> torch.Tensor:
    """``mc_tpu``'s packed fx vector (``_pack_fx``: the (11,) f32 vector of
    ``FX_FIELDS``) -> the port's CPU tensor, bit for bit."""
    return _packed(arr, FX_FIELDS, "fx")


def swaption_spec(src) -> SwaptionSpec:
    """``mc_tpu.models.swaption.SwaptionSpec`` fields -> the port's."""
    expiry, tenor, k_rate = _scalars(src, ("expiry", "tenor", "k_rate"),
                                     "swaption")
    return SwaptionSpec(expiry=expiry, tenor=tenor,
                        n_payments=int(_field(src, "n_payments")),
                        k_rate=k_rate, payer=bool(_field(src, "payer")))


def discount_curve(src) -> DiscountCurve:
    """``mc_tpu.models.hullwhite.DiscountCurve`` (its f64 ``times`` and
    ``zeros`` knots) -> the port's, the same knots bit for bit."""
    return DiscountCurve(np.asarray(_field(src, "times"), np.float64),
                         np.asarray(_field(src, "zeros"), np.float64))


def hw_dynamics(src) -> HullWhiteDynamics:
    """``mc_tpu.models.hullwhite.HullWhiteDynamics`` -> the port's."""
    return HullWhiteDynamics(*_scalars(src, _HW_DYN_FIELDS, "Hull-White"))


def g2_dynamics(src) -> G2Dynamics:
    """``mc_tpu.models.g2pp.G2Dynamics`` -> the port's."""
    return G2Dynamics(*_scalars(src, _G2_DYN_FIELDS, "G2++"))


def va_swpt_params(arr, n_payments: int) -> torch.Tensor:
    """``mc_tpu``'s packed Vasicek swaption vector (``_pack_va_swpt``) ->
    the port's CPU tensor, bit for bit, its length checked against 10 +
    2n."""
    return _packed_vector(arr, _fused.packed_length("va", n_payments),
                          f"Vasicek swaption (n={n_payments})")


def hw_swpt_params(arr, n_payments: int) -> torch.Tensor:
    """``mc_tpu``'s packed Hull-White swaption vector (``_pack_hw_swpt``)
    -> the port's CPU tensor, bit for bit, its length checked against 7 +
    3n."""
    return _packed_vector(arr, _fused.packed_length("hw", n_payments),
                          f"Hull-White swaption (n={n_payments})")


def g2_swpt_params(arr, n_payments: int) -> torch.Tensor:
    """``mc_tpu``'s packed G2++ swaption vector (``_pack_g2_swpt``) -> the
    port's CPU tensor, bit for bit, its length checked against 10 + 4n."""
    return _packed_vector(arr, _fused.packed_length("g2", n_payments),
                          f"G2++ swaption (n={n_payments})")


def qmc_pointset(family: str, n: int, zvec, shifts,
                 device="cpu") -> "_qmc.QMCPointSet":
    """``mc_tpu``'s point set ``(n, zvec, shifts)`` (``_qmc_pointset``:
    the lattice's int32 generating vector and f32 (R, d) shifts, or Sobol's
    flattened int32 (d*30,) directions and int32 (R, d) digital shifts) ->
    the port's ``QMCPointSet``, bit for bit, so both packages can price the
    same points."""
    if family not in _qmc.FAMILIES:
        raise ValueError(f"unknown QMC family {family!r}")
    table = np.asarray(zvec)
    sh = np.asarray(shifts)
    if (not np.issubdtype(table.dtype, np.integer) or table.ndim != 1
            or sh.ndim != 2):
        raise ValueError(f"a point set is an integer (d,) or (d*30,) table "
                         f"and (R, d) shifts; got {table.shape} "
                         f"{table.dtype} and {sh.shape}")
    want = np.int32 if family == "sobol" else np.float32
    ps = _qmc.QMCPointSet(
        family=family, n=int(n), d=int(sh.shape[1]),
        table=torch.from_numpy(table.astype(np.int32)).to(device),
        shifts=torch.from_numpy(sh.astype(want)).to(device))
    ps.check()
    return ps


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


def book_surface(src) -> np.ndarray:
    """An ``mc_tpu`` ``NMCBookResult`` (its ``net_surface``, ``(n_steps,
    rows, 128)`` with lane padding, and ``n_paths``) -> the port's
    ``NMCBookResult.net_surface`` layout, ``(n_steps, n_paths)`` f32."""
    n_paths = int(float(np.asarray(src.n_paths)))
    return np.ascontiguousarray(
        surface_matrix(src.net_surface, n_paths).T.astype(np.float32))


# mc_tpu's checkpoint magic and the meta keys that describe its TPU engine.
_MC_TPU_MAGIC = "mc_tpu-checkpoint-v1"
_ENGINE_META = ("engine", "tile_rows")


def checkpoint(src) -> Checkpoint:
    """An ``mc_tpu`` checkpoint -> the port's ``Checkpoint``, so that
    ``chunked_price(resume=True)`` continues a run ``mc_tpu`` began.

    ``src`` is the path of ``mc_tpu``'s ``.npz``, or a mapping of its
    arrays (``acc``, ``comp``, ``paths_done``, ``n_paths``, ``meta_*``).
    A ``model=`` run's meta carries its ``model`` and ``dyn`` fingerprint
    (every dynamics leaf as ``%.9g``), which the port's
    ``chunked_price(model=...)`` writes the same way.
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
