"""The launch of the GBM nested-MC kernels (#3 nmc_fused_kernel, #5
nmc_inner_kernel), computed on the host by ``nmc_kernels.nmc_launch`` and
passed to the entry points: each point's inner legs run kNmcLegs at a time
(the constant read from the CUDA source), in groups with a ragged last
group whose surplus legs run and are not added.

No card is needed.  The kernels add a point's inner payoffs in f64 in leg
order, group by group; a mirror of that order, surplus legs run and
dropped, is held bit for bit to the legs' sum in leg order, and that sum to
the plain version's (which adds in another order) to f64 rounding.
``price_nmc`` at
an inner count that no leg group divides is held to mc_tpu's grid and fused
routes.  The payoffs whose legs test the log-price against a threshold in
place of the spot (those with ``update_below`` in ``csrc/payoffs.cuh``)
read the spot in their plain update only through S < B.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.nmc import price_nmc as jprice_nmc

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.ops import nmc_kernels as nk
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff

torch.set_num_threads(1)

CSRC = Path(nk.__file__).resolve().parent.parent / "csrc"
N_INNER = (1, 3, 7, 64, 500)
# as tests/test_torch_nmc.py holds the surfaces to mc_tpu's
SURF_TOL, SURF_FRAC, MEAN_RTOL, OUTER_SE = 1e-4, 0.999, 1e-4, 0.05


def _source_legs() -> int:
    text = (CSRC / "nmc_kernels.cu").read_text()
    return int(re.search(r"constexpr int kNmcLegs = nmc_legs\((\d+)\);",
                         text).group(1))


def test_legs_match_the_source():
    """kNmcLegs is 1, 2 or 4; the library exports it, and the launchers
    refuse a group count that is not ceil(n_inner / kNmcLegs)."""
    assert _source_legs() in (1, 2, 4)
    text = (CSRC / "nmc_kernels.cu").read_text()
    assert "int mc_nmc_legs() { return mc::kNmcLegs; }" in text
    assert "n_groups != (n_inner + kNmcLegs - 1) / kNmcLegs" in text
    assert re.search(r"MC_NMC_LEGS", text)


@pytest.mark.parametrize("legs", [1, 2, 4])
@pytest.mark.parametrize("n_inner", N_INNER)
def test_leg_groups(n_inner, legs):
    geo = nk.nmc_launch(n_inner, legs)
    assert geo.legs == legs
    assert geo.groups == -(-n_inner // legs)
    last_legs = n_inner - (geo.groups - 1) * legs
    assert 1 <= last_legs <= legs
    # the surplus legs of the last group: none when legs divides n_inner
    surplus = geo.groups * legs - n_inner
    assert surplus == legs - last_legs
    assert (surplus == 0) == (n_inner % legs == 0)


def test_the_source_legs_group_the_main_shape():
    geo = nk.nmc_launch(500, _source_legs())
    assert geo.groups * geo.legs >= 500 > (geo.groups - 1) * geo.legs


@pytest.mark.parametrize("legs,n_inner", [(-1, 8), (0, 8), (2, 0)])
def test_leg_groups_refuse_what_the_kernels_cannot_run(legs, n_inner):
    with pytest.raises(ValueError):
        nk.nmc_launch(n_inner, legs)


def _leg_payoffs(po, cfg, p, ki, ids, j, s_j, c_j, n_legs):
    """(n_legs, n_paths) f32: inner legs m = 0..n_legs-1 resumed at step j,
    leg m on counters ((j+1)*n_inner + m)*pair_cap + q, as the kernels draw
    them (legs m >= n_inner: the surplus of a ragged last group)."""
    m = torch.arange(n_legs, dtype=torch.int64)[:, None]
    c1_base = (((j + 1) * cfg.n_inner + m) * cfg.pair_cap) & 0xFFFFFFFF
    ids2 = ids.expand(n_legs, -1)

    def draw_pair(q):
        return rng.normal_pair(ki[0], ki[1], ids2,
                               (c1_base + q).expand_as(ids2))

    st = (c_j.expand_as(ids2),) if po.n_state else ()
    return nk._simulate_resumed(po, p, s_j.expand_as(ids2), st,
                                cfg.n_steps - j - 1, draw_pair)


def _grouped_sum(pay: np.ndarray, n_inner: int, legs: int) -> np.ndarray:
    """The kernels' f64 sum of a point's legs: group by group, each
    group's legs in order, a leg past n_inner run and not added."""
    geo = nk.nmc_launch(n_inner, legs)
    total = np.zeros(pay.shape[1], dtype=np.float64)
    for g in range(geo.groups):
        for lane in range(legs):
            m = g * legs + lane
            if m < n_inner:
                total = total + pay[m].astype(np.float64)
    return total


@pytest.mark.parametrize("per_block", [None, 3])
@pytest.mark.parametrize("legs", [1, 2, 4])
@pytest.mark.parametrize("payoff,n_steps,n_inner", [
    ("bullet_call", 7, 7),
    ("vanilla_call", 8, 7),
    ("asian_call", 7, 5),
    ("down_out_call", 6, 64),
])
def test_grouped_sum_is_the_leg_order_sum(monkeypatch, payoff, n_steps,
                                          n_inner, legs, per_block):
    """At every step j (odd and even remaining counts) the grouped f64 sum
    is the legs' sum in leg order bit for bit, and that sum is the plain
    version's to rtol 1e-13 (n_inner <= 64 non-negative f32 payoffs added
    in f64 in two orders part by at most ~64 f64 ulps), with the plain
    version's legs in one block or in blocks of 3."""
    n_paths = 33
    if per_block is not None:
        monkeypatch.setattr(nk, "PLAIN_INNER_ELEMS", per_block * n_paths)
    po = get_payoff(payoff)
    opt = OptionParams(p1=1.0, p2=6.0, barrier=95.0)
    cfg = nk.NMCConfig(n_paths=n_paths, n_steps=n_steps, n_inner=n_inner)
    prm = pk.pack_params(opt, n_steps)
    p = pk.unpack_params(prm)
    ko = tuple(int(k) for k in rng.derive_key(11, 1))
    ki = tuple(int(k) for k in rng.derive_key(11, 2))
    s_grid, c_grid, _ = pk.simulate_trajectories_plain(
        po, nk.outer_config(cfg), ko, prm)
    ids = torch.arange(n_paths, dtype=torch.int64)
    n_legs = nk.nmc_launch(n_inner, legs).groups * legs
    for j in range(n_steps):
        pay = _leg_payoffs(po, cfg, p, ki, ids, j, s_grid[j], c_grid[j],
                           n_legs).numpy()
        in_order = np.zeros(n_paths, dtype=np.float64)
        for m in range(n_inner):
            in_order = in_order + pay[m].astype(np.float64)
        np.testing.assert_array_equal(_grouped_sum(pay, n_inner, legs),
                                      in_order)
        plain = nk._nmc_point_sum(po, cfg, p, ki[0], ki[1], ids, j,
                                  s_grid[j], c_grid[j]).numpy()
        np.testing.assert_allclose(plain, in_order, rtol=1e-13, atol=0)


@pytest.mark.parametrize("strategy", ["grid", "fused"])
@pytest.mark.parametrize("payoff,discount", [
    ("bullet_call", "full"),
    ("vanilla_call", "remaining"),
])
def test_price_nmc_at_a_ragged_inner_count_matches_mc_tpu(strategy, payoff,
                                                          discount):
    """7 inner paths (no group of 2 or 4 divides them) over 7 steps (odd
    remaining counts at even j): the surface and the outer price against
    mc_tpu's grid strategy and fused route."""
    j_opt = mc_tpu.OptionParams(p1=1.0, p2=6.0)
    jsim = mc_tpu.SimParams(n_paths=200, n_steps=7, n_paths_inner=7, seed=3)
    got = mt.price_nmc(convert.option_params(j_opt), convert.sim_params(jsim),
                       payoff, strategy=strategy, discount=discount,
                       device="cpu")
    kw = {"strategy": "grid"} if strategy == "grid" else {"engine": "xla"}
    want = jprice_nmc(j_opt, jsim, payoff, discount=discount, **kw)
    g = got.surface_matrix().numpy()
    w = convert.surface_matrix(want.surface, jsim.n_paths)
    assert g.shape == w.shape
    close = np.isclose(g, w, rtol=SURF_TOL, atol=SURF_TOL)
    assert close.mean() >= SURF_FRAC, close.mean()
    assert float(got.surface_mean) == pytest.approx(
        float(want.surface_mean), rel=MEAN_RTOL)
    assert abs(float(got.outer.price) - float(want.outer.price)) <= (
        OUTER_SE * float(want.outer.stderr))


def _update_below_structs() -> set:
    """The payoff structs of csrc/payoffs.cuh that define update_below."""
    text = (CSRC / "payoffs.cuh").read_text()
    return {m.group(1)
            for m in re.finditer(r"^struct (\w+) : PayoffBase<\d>", text, re.M)
            if "update_below" in text[m.end():text.index("\n};", m.end())]}


def test_update_below_payoffs_are_one_word():
    structs = _update_below_structs()
    one_word = {type(po).__name__ for po in PAYOFFS.values()
                if po.n_state == 1}
    assert structs and structs <= one_word, structs


@pytest.mark.parametrize("name", sorted(
    n for n, po in PAYOFFS.items()
    if type(po).__name__ in _update_below_structs()))
def test_update_below_payoffs_read_the_spot_only_through_the_barrier(name):
    """Their plain update gives the same state from the spot as from
    -inf (a spot below the barrier) or +inf (one not below it), over spots
    at, around and far from the barrier and every state word."""
    po = get_payoff(name)
    p = pk.unpack_params(pk.pack_params(OptionParams(barrier=110.0), 8))
    b = np.float32(110.0)
    near = [np.nextafter(b, np.float32(-np.inf)), b,
            np.nextafter(b, np.float32(np.inf))]
    s = torch.tensor([1e-3, 50.0, 109.99, *near, 110.01, 500.0, 3e38],
                     dtype=torch.float32)
    side = torch.where(s < p.barrier, -torch.inf, torch.inf)
    for word in (0.0, 1.0, 3.0):
        st = (torch.full_like(s, word),)
        for got, want in zip(po.update(st, side, p), po.update(st, s, p)):
            assert torch.equal(got, want)
