"""The Heston Euler kernel #12 (heston_euler_kernel,
``csrc/heston_kernels.cu``): S only where the payoff reads it (the barrier
payoffs' test on the log-price against the block's threshold), the plain
and antithetic kernels apart, and the grid the wrapper computes from the
library's paths a block.

No card is needed.  A torch mirror of the kernel's legs (w and v stepped as
heston_euler_step steps them, a barrier payoff's state from ``w <=
below_max_all(s0, B)`` where s0 is not below 0, S at each step otherwise or
where the payoff reads it, once at maturity else; the twin on the negated
pair) equals the plain version's legs (S at each step) bit for bit over
edge spots and barriers; the source keeps S and the twin's branch out of
the step loop; and the plain version stays held to mc_tpu's engine="xla"
dual, plain and antithetic, at 1e-5 relative (0.05 stderr for the barrier
payoffs' flips).
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import heston as jh

import mc_tpu_torch as mt
from mc_tpu_torch.models import heston as th
from mc_tpu_torch.ops import _cuda, payoffs
from mc_tpu_torch.ops.payoffs import get_payoff
from test_torch_book_launch import BARRIER_PAYOFFS, state_read, update_below
from test_torch_localvol_launch import launch_blocks
from test_torch_simulate_launch import EDGES, _body, _same, _threshold

torch.set_num_threads(1)

CSRC = Path(th.__file__).resolve().parents[1] / "csrc"
SRC = (CSRC / "heston_kernels.cu").read_text()
VANILLA_RTOL = 1e-5
BULLET_SE = 0.05
STRESS = th.HestonDynamics(v0=0.09, kappa=1.0, theta=0.09, xi=1.0, rho=-0.9)


def mirror_pay(po, cfg, p, draw, thresholds):
    """heston_euler_pay: each leg's w and v by heston_euler_step (the twin
    on (-z_v, -z_2)); a barrier payoff's state from w <= below_max where
    by_w, from S otherwise; a spot payoff's from S at each step; S formed
    once, at the end, where the steps did not form it; the pair's mean."""
    read = state_read(po)
    below_max, by_w = thresholds
    zero = torch.zeros(cfg.n_paths)
    s0 = zero + p.s0
    n_legs = 2 if cfg.antithetic else 1
    w, v = [zero] * n_legs, [zero + p.v0] * n_legs
    s, st = [s0] * n_legs, [po.init(p, zero)] * n_legs
    for j in range(cfg.n_steps):
        z_v, z_2, _ = draw(j)
        for leg in range(n_legs):
            zv, z2 = (-z_v, -z_2) if leg else (z_v, z_2)
            w[leg], v[leg] = th.heston_euler_step(p, w[leg], v[leg], zv, z2,
                                                  p.dt, p.sqrt_dt)
            if read == "spot" or (read == "barrier" and not by_w):
                s[leg] = s0 * torch.exp(w[leg])
                st[leg] = po.update(st[leg], s[leg], p)
            elif read == "barrier":
                st[leg] = update_below(po, st[leg], w[leg] <= below_max, p)
    if read != "spot":
        s = [s0 * torch.exp(w[leg]) for leg in range(n_legs)]
    pays = [po.terminal(st[leg], s[leg], p) for leg in range(n_legs)]
    return pays[0] if n_legs == 1 else 0.5 * (pays[0] + pays[1])


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("edge", EDGES, ids=str)
@pytest.mark.parametrize("name", BARRIER_PAYOFFS + ("vanilla_call",
                                                    "asian_call"))
def test_threshold_legs_are_the_spot_legs_bitwise(name, edge, antithetic):
    """Each path's payoff (the pair's mean if antithetic) through the
    kernel's legs equals the plain version's (S at every step) bit for bit,
    under the stress dynamics (v crosses 0), the block's threshold at the
    edge's spot and barrier."""
    s0, barrier, k = edge
    po = get_payoff(name)
    cfg = th.HestonConfig(n_paths=300, n_steps=17, antithetic=antithetic)
    prm = th.pack_heston(mt.OptionParams(s0=s0, barrier=barrier, k=k,
                                         p1=2.0, p2=9.0), STRESS, 17, "cpu")
    p = th.unpack_heston(prm)
    ids = torch.arange(cfg.n_paths, dtype=torch.int64)
    draw = th._draw_fn("euler", 13, 11, 22, ids)
    thr = (_threshold(p, s0, barrier) if state_read(po) == "barrier"
           else (torch.tensor(0.0), True))
    with np.errstate(all="ignore"):
        got = mirror_pay(po, cfg, p, draw, thr)
        want = th._pay(po, cfg, p, ids.float(), draw)
    assert _same(got, want)


def test_step_loop_forms_no_spot_and_holds_no_branch_of_the_twin():
    """The Euler loop steps (w, v) by heston_euler_step and leaves the
    payoff state to leg_update (S only for a kSpot payoff, or a kBarrier
    leg whose s0 is below 0: barrier.cuh); the twin is a compile-time leg
    on the negated pair; S once at the end (leg_end_spot); no scheme
    parameter, no runtime antithetic flag."""
    loop = _body(SRC, "for (int j = 0; j < n_steps; ++j)")
    assert "expf" not in loop and "antithetic" not in loop
    assert "heston_euler_step(h, z_v, z_2, w[0], v[0]);" in loop
    assert "if constexpr (A) heston_euler_step(h, -z_v, -z_2, w[1], v[1]);" in loop
    assert "leg_update<Payoff>(h.pay, s0, below_max, by_w, w[l], s[l], st[l]);" in loop
    assert "leg_end_spot<Payoff>(s0, n_steps > 0, w[l], s[l]);" in SRC
    assert "EulerScheme" not in SRC and "heston_partials_body" not in SRC
    assert re.search(r"template <class Payoff, int ROUNDS, bool A>\s+"
                     r"__global__ void __launch_bounds__\(kHestonThreads, "
                     r"A \? 5 : 6\)\s+heston_euler_kernel\(uint32_t k0", SRC)
    assert "block_below_max<Payoff>(h.pay, by_w);" in SRC
    # the trajectories (#13) left this source for the family template, whose
    # Heston advance keeps its S at each step (family_nmc_kernels.cu)
    assert "heston_trajectories_kernel" not in SRC
    assert "c.s = h.pay.s0 * expf(c.w);" in (
        CSRC / "family_nmc_kernels.cu").read_text()


def test_heston_steps_untouched():
    """heston_euler_step's arithmetic, which the trajectories, the family
    NMC and the QMC leg share, as it was; the family's outer step
    (HestonFamily: the draw of pair (id, j), then the advance) is the old
    heston_outer_step split in two, the same operations in the same
    order."""
    step = (CSRC / "heston.cuh").read_text()
    assert "w = w + ((h.growth - 0.5f * v_plus) * h.pay.dt + sq * z_s);" in step
    assert ("v = (v + (h.kappa * (h.theta - v_plus)) * h.pay.dt) + "
            "(h.xi * sq) * z_v;") in step
    assert "heston_outer_step" not in step
    fam = (CSRC / "family_nmc_kernels.cu").read_text()
    draw = _body(fam, "__device__ static void outer_draw(")
    assert "normal_pair<13>(k0, k1, id, u, d.w[0], d.w[1]);" in draw
    advance = _body(fam, "__device__ static void outer_advance(")
    assert advance.index("heston_euler_step(h, d.w[0], d.w[1], c.w, c.v);") < (
        advance.index("c.s = h.pay.s0 * expf(c.w);")) < advance.index(
        "c.st = Payoff::update(c.st, c.s, h.pay);")
    outer = _body(fam, "__device__ static void outer_step(")
    assert outer.index("outer_draw(h, k0, k1, id, static_cast<uint32_t>(j), d);") < (
        outer.index("outer_advance<Payoff>(h, j, d, c);"))


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("tile", [256, 128])
@pytest.mark.parametrize("n_paths", [1, 257, 1_000_000])
def test_wrapper_reads_the_librarys_paths_a_block(monkeypatch, n_paths, tile,
                                                  antithetic):
    """The grid is ceil(n_paths / the library's paths a block), capped at
    MAX_BLOCKS, for the plain and the antithetic Euler kernel alike."""
    cfg = th.HestonConfig(n_paths=n_paths, n_steps=100,
                          antithetic=antithetic)
    params = torch.empty(len(th.HESTON_FIELDS), device="meta")
    got = launch_blocks(
        monkeypatch, th, "heston", tile,
        lambda: th.heston_partials(payoffs.get_payoff("vanilla_call"), cfg,
                                   (1, 2), params))
    assert got == min(-(-n_paths // tile), _cuda.MAX_BLOCKS)


def test_wrapper_passes_scheme_and_twin(monkeypatch):
    """mc_heston_partials gets (payoff, qe 0, rounds, antithetic, ...): the
    entry point picks the plain or the antithetic Euler kernel by them."""
    seen = []

    class Lib:
        def mc_heston_block_paths(self):
            return 256

        def mc_heston_partials(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(_cuda, "load", Lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_cuda, "launch_counts", dict(_cuda.launch_counts))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(th, "check_heston_params", lambda *args: None)
    params = torch.empty(len(th.HESTON_FIELDS), device="meta")
    for anti, rounds in ((False, "threefry13"), (True, "threefry")):
        cfg = th.HestonConfig(n_paths=1000, n_steps=10, antithetic=anti,
                              rng_source=rounds)
        th.heston_partials(get_payoff("bullet_call"), cfg, (1, 2), params)
        assert seen[-1][:4] == (get_payoff("bullet_call").cuda_id, 0,
                                cfg.rng_rounds, int(anti))


# --- the plain version against mc_tpu ------------------------------------------


J_SIM = mc_tpu.SimParams(n_paths=4096, n_steps=16)
SIM = mt.SimParams(n_paths=4096, n_steps=16)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("name", ["vanilla_call", "asian_call",
                                  "bullet_call", "up_out_call",
                                  "down_in_call", "digital_put"])
def test_plain_euler_matches_mc_tpu_xla(name, antithetic):
    """price_heston's Euler plain version (the kernels' contract) against
    mc_tpu.price_heston(engine="xla") on the same key, plain and
    antithetic, 4,096 x 16 on the demo dynamics, the barriers within reach
    (B = 110, window [1, 6] steps): price 1e-5 relative, the barrier
    payoffs 0.05 stderr."""
    kw = dict(barrier=110.0, p1=1.0, p2=6.0)
    if name == "down_in_call":
        kw = dict(barrier=95.0)
    want = jh.price_heston(mc_tpu.OptionParams(**kw), jh.DEMO_HESTON, J_SIM,
                           name, engine="xla", antithetic=antithetic)
    got = th.price_heston(mt.OptionParams(**kw), th.DEMO_HESTON, SIM, name,
                          antithetic=antithetic, device="cpu")
    gp, wp, ws = float(got.price), float(want.price), float(want.stderr)
    assert wp != 0.0
    if name in BARRIER_PAYOFFS or name == "digital_put":
        assert abs(gp - wp) <= BULLET_SE * ws, (gp, wp, ws)
    else:
        assert abs(gp - wp) <= VANILLA_RTOL * abs(wp), (gp, wp)
        assert abs(float(got.stderr) - ws) <= VANILLA_RTOL * ws
