"""The launch geometry of the family nested-MC kernels (#29
family_inner_kernel, #30 family_fused_kernel), computed on the host by
``nmc_engine.family_launch`` and passed to the entry points: the shared
bytes of each family's staged pack (and Merton's and Bates's Poisson table),
the route of a pack over the shared budget (read where it lies), and the
leg groups with their ragged last group.

No card is needed: the geometry is host arithmetic, and the constants it
must agree with (each family struct's kLegs, the shared budget) are read
from the CUDA sources.  The grouped Kahan sum, legs run kLegs at a time and
the surplus legs of a ragged last group dropped, is held bit for bit to the
plain version's sum in leg order.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_tpu_torch import nmc_engine as ne
from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.models import basket as bm
from mc_tpu_torch.models import localvol as lm
from mc_tpu_torch.models import merton as mm
from mc_tpu_torch.nmc_basket import BasketNMC
from mc_tpu_torch.nmc_bates import BatesNMC
from mc_tpu_torch.nmc_cev import CEVNMC
from mc_tpu_torch.nmc_heston import HestonNMC
from mc_tpu_torch.nmc_localvol import LocalVolNMC
from mc_tpu_torch.nmc_merton import MertonNMC
from mc_tpu_torch.nmc_rainbow import RainbowNMC
from mc_tpu_torch.nmc_sabr import SABRNMC
from mc_tpu_torch.nmc_term import TermNMC
from mc_tpu_torch.nmc_vasicek import VasicekNMC

CSRC = Path(ne.__file__).resolve().parent / "csrc"
BUDGET_FLOATS = ne.FAMILY_SMEM_BUDGET // 4

# family -> (instance, the header that defines its struct, the struct)
FAMILIES = {
    "heston": (HestonNMC(), "family_nmc_kernels.cu", "HestonFamily"),
    "merton": (MertonNMC(extras=(4,)), "merton.cuh", "MertonFamily"),
    "bates": (BatesNMC(extras=(4,)), "bates.cuh", "BatesFamily"),
    "cev": (CEVNMC(), "cev.cuh", "CEVFamily"),
    "localvol": (LocalVolNMC(extras=(9,)), "localvol.cuh", "LocalVolFamily"),
    "sabr": (SABRNMC(), "sabr.cuh", "SABRFamily"),
    "term": (TermNMC(), "term.cuh", "TermFamily"),
    "vasicek": (VasicekNMC(), "vasicek.cuh", "VasicekFamily"),
    "basket": (BasketNMC(extras=(4,)), "basket.cuh", "BasketFamily"),
    "rainbow": (RainbowNMC(extras=(4, 0)), "basket.cuh", "BasketFamily"),
}


def struct_legs(header: str, struct: str) -> str:
    """The kLegs initializer of ``struct`` in ``header``."""
    src = (CSRC / header).read_text()
    body = src[src.index(f"struct {struct} {{"):]
    m = re.search(r"static constexpr int kLegs = (.*?);", body)
    return m.group(1)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_legs_match_the_struct(family):
    fam, header, struct = FAMILIES[family]
    init = struct_legs(header, struct)
    if struct == "BasketFamily":  # capacity 8 its own legs, capacity 32 one
        m = re.fullmatch(r"kMaxD <= 8 \? family_legs\((\d+)\) : 1", init)
        assert m, init
        assert fam.legs == int(m.group(1))
        wide = type(fam)(extras=(9,) + fam.extras[1:])
        assert wide.legs == 1
    else:
        m = re.fullmatch(r"family_legs\((\d+)\)", init)
        assert m, init
        assert fam.legs == int(m.group(1))
    assert fam.legs in (1, 2, 4)


def test_budget_matches_the_kernels():
    src = (CSRC / "family.cuh").read_text()
    m = re.search(r"constexpr int kFamilySmemBudget = (\d+) \* (\d+);", src)
    assert int(m.group(1)) * int(m.group(2)) == ne.FAMILY_SMEM_BUDGET
    # 16 blocks (the SM's 2,048 threads at 128 a block) with their 1 KB
    # reservation fit in the SM's 228 KB
    assert 16 * (ne.FAMILY_SMEM_BUDGET + 1024) <= 228 * 1024


@pytest.mark.parametrize("family", ["basket", "rainbow"])
@pytest.mark.parametrize("d", range(1, 33))
def test_shared_bytes_basket(family, d):
    """The pack is 10 + 3d + d(d+1)/2 floats, 634 at d = 32: always staged."""
    dyn = bm.demo_basket(d, 0.5)
    prm = bm.pack_basket(OptionParams(), dyn, 8, "cpu")
    n_pack = 10 + 3 * d + d * (d + 1) // 2
    assert prm.numel() == n_pack == bm.packed_length(d)
    extras = (d,) if family == "basket" else (d, 0)
    fam = FAMILIES[family][0].__class__(extras=extras)
    geo = ne.family_launch(fam, 500, prm.numel())
    assert geo.staged and geo.stage_floats == n_pack
    assert geo.table_floats == 0
    assert geo.smem_bytes == 4 * n_pack <= ne.FAMILY_SMEM_BUDGET
    assert geo.legs == (FAMILIES[family][0].legs if d <= 8 else 1)


@pytest.mark.parametrize("n_knots", [2, 9, 25])
@pytest.mark.parametrize("n_steps", [7, 100, 300])
def test_shared_bytes_localvol(n_knots, n_steps):
    """The surface is 11 + 2K - 1 + n_steps*K floats: staged up to the
    budget (K = 25 at 100 steps, 10,240 bytes), read where it lies past it
    (K = 25 at 300 steps, 30,240 bytes)."""
    surf = lm.LocalVolSurface.from_function(
        lambda x, t: 0.2 + 0.05 * x * x, n_steps, x_lo=-1.0, x_hi=1.0,
        n_knots=n_knots)
    prm = lm.pack_localvol(OptionParams(), surf, n_steps, "cpu")
    n_pack = 11 + 2 * n_knots - 1 + n_steps * n_knots
    assert prm.numel() == n_pack
    geo = ne.family_launch(LocalVolNMC(extras=(n_knots,)), 500, n_pack)
    fits = 4 * n_pack <= ne.FAMILY_SMEM_BUDGET
    assert geo.staged == fits
    assert geo.stage_floats == (n_pack if fits else 0)
    assert geo.smem_bytes == (4 * n_pack if fits else 0)
    assert (n_knots, n_steps, fits) != (25, 300, True)
    assert (n_knots, n_steps, fits) != (25, 100, False)


def test_route_over_the_budget():
    """One float past the budget reads the pack in place; the budget itself
    stages it."""
    fam = LocalVolNMC(extras=(9,))
    at = ne.family_launch(fam, 7, BUDGET_FLOATS)
    past = ne.family_launch(fam, 7, BUDGET_FLOATS + 1)
    assert at.staged and at.smem_bytes == ne.FAMILY_SMEM_BUDGET
    assert not past.staged and past.smem_bytes == 0


@pytest.mark.parametrize("family", ["merton", "bates"])
@pytest.mark.parametrize("lam_dt", [0.003, 0.3, 3.0, 30.0])
def test_shared_bytes_poisson_table(family, lam_dt):
    """Merton's and Bates's table of kmax cdf values follows the pack; a
    pack that would not fit beside it is read in place, the table stays."""
    kmax = mm.poisson_kmax(lam_dt)
    fam = FAMILIES[family][0].__class__(extras=(kmax,))
    n_pack = 19 if family == "merton" else 20
    geo = ne.family_launch(fam, 500, n_pack)
    assert geo.table_floats == kmax
    assert geo.staged and geo.smem_bytes == 4 * (n_pack + kmax)
    big = ne.family_launch(fam, 500, BUDGET_FLOATS)
    assert not big.staged and big.smem_bytes == 4 * kmax


def test_table_over_the_budget_raises():
    fam = MertonNMC(extras=(BUDGET_FLOATS + 1,))
    with pytest.raises(ValueError, match="shared budget"):
        ne.family_launch(fam, 500, 19)


@pytest.mark.parametrize("legs", [1, 2, 4])
@pytest.mark.parametrize("n_inner", [1, 2, 3, 4, 5, 7, 8, 64, 499, 500])
def test_ragged_groups(legs, n_inner):
    fam = CEVNMC()
    fam.legs = legs
    geo = ne.family_launch(fam, n_inner, 13)
    assert geo.groups == math.ceil(n_inner / legs)
    assert 1 <= geo.last_legs <= legs
    assert (geo.groups - 1) * legs + geo.last_legs == n_inner
    assert geo.last_legs == (n_inner % legs or legs)


def kahan(acc, comp, pay):
    y = pay - comp
    t = acc + y
    return t, (t - acc) - y


@pytest.mark.parametrize("legs", [1, 2, 4])
@pytest.mark.parametrize("n_inner", [1, 5, 7, 64])
def test_grouped_sum_is_the_leg_order_sum(legs, n_inner):
    """The kernels' loop, groups of ``legs`` with the legs past n_inner
    computed and not added, gives the plain version's f32 Kahan sum in leg
    order bit for bit (payoffs from a seeded numpy draw, the surplus legs'
    garbage included)."""
    rng_np = np.random.default_rng(13)
    fam = CEVNMC()
    fam.legs = legs
    geo = ne.family_launch(fam, n_inner, 13)
    pays = torch.from_numpy(rng_np.lognormal(
        0.0, 2.0, (geo.groups * legs, 256)).astype(np.float32))
    want_acc = want_comp = torch.zeros(256)
    for m in range(n_inner):
        want_acc, want_comp = kahan(want_acc, want_comp, pays[m])
    acc = comp = torch.zeros(256)
    for q in range(geo.groups):
        for l in range(legs):
            if q * legs + l < n_inner:
                acc, comp = kahan(acc, comp, pays[q * legs + l])
    assert torch.equal(acc, want_acc)
    assert geo.groups * legs - n_inner == legs - geo.last_legs


def test_wrappers_pass_the_geometry():
    """family_fused and family_inner hand the entry points the geometry of
    the call (the CUDA branch's arguments, read from its source)."""
    import inspect

    for fn in (ne.family_fused, ne.family_inner):
        src = inspect.getsource(fn)
        assert "geo = family_launch(fam, cfg.n_inner, params.numel())" in src
        assert "geo.groups, geo.stage_floats" in src
