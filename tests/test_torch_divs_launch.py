"""The cash-dividend partials kernel #22 (divs_partials_kernel,
``csrc/divs_kernels.cu``): the block's payment table and the step loop that
walks it, the skipped subtract at a step that pays nothing, the lockstep
paths' lanes and ragged tail, the source constants and the grid the wrapper
computes from the library's paths a block.

No card is needed.  A torch f32 mirror of the kernel's loop (the table of
the steps whose amount is not +-0, ascending, and a subtract only at those
steps) holds each path's payoff to ``divs_partials_plain``'s (its ``_pay``)
bit for bit on edge schedules (a payment at step 0 and at the last step,
every step paying, -0.0, NaN, negative and +inf amounts, an amount above
the spot), every payoff, plain and antithetic; and to mc_tpu's leg
(``_divs_leg``) within the parity contract of ``test_torch_divs.py``.  The
floor is the plain version's clamp here: the card's ``fmaxf`` takes 1e-6
where the clamp keeps a NaN, which only a NaN spot or amount meets.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import dividends as jd
from mc_tpu.ops.payoffs import get_payoff as jget_payoff

from mc_tpu_torch import rng
from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.models import dividends as td
from mc_tpu_torch.models.merton import counters, steps_index
from mc_tpu_torch.ops import _cuda, payoffs
from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff
from family_nmc_probe import divs_schedules
from test_torch_basket_launch import _thread_sums, _tree
from test_torch_localvol_launch import launch_blocks

CSRC = Path(td.__file__).resolve().parents[1] / "csrc"
SRC = (CSRC / "divs_kernels.cu").read_text()
STEP = (CSRC / "divs.cuh").read_text()
F32 = np.float32
KEY = (0x1234567, 0x89ABCDEF)
OPTIONS = {"variance_swap": dict(k=0.04),
           "forward_start_call": dict(k=1.0, p1=6.0),
           "cliquet": dict(k=4.0, p1=-0.05, p2=0.05),
           "down_out_call": dict(barrier=90.0),
           "down_in_call": dict(barrier=90.0),
           "down_out_call_bb": dict(barrier=90.0),
           "bullet_call": dict(p1=1.0, p2=10.0)}


def schedule(label: str, n: int) -> np.ndarray:
    """The edge schedules of ``family_nmc_probe.py --partials`` at n steps."""
    return divs_schedules(n)[label]


SCHEDULES = ("two payments", "none", "first and last step", "every step",
             "-0.0 between", "NaN", "negative", "above spot", "+inf")


def payment_table(d: np.ndarray):
    """divs_table: the steps whose amount is not +0 or -0, ascending, their
    amounts, then the sentinel n_steps."""
    bits = np.asarray(d, F32).view(np.uint32)
    steps = [int(j) for j in np.nonzero(bits & 0x7FFFFFFF)[0]]
    return steps + [d.size], [d[j] for j in steps]


def mirror_pay(payoff, cfg, p, ids, d):
    """The kernel's step loop over the table: each path's payoff (the
    antithetic pair's mean), the drop only at a step the table lists."""
    k0, k1 = KEY
    zero = torch.zeros(ids.shape, dtype=torch.float32)
    n_legs = 2 if cfg.antithetic else 1
    s, st = [zero + p.s0] * n_legs, [payoff.init(p, zero)] * n_legs
    z0, z1 = rng.normal_pair(k0, k1, ids,
                             counters(ids, steps_index(cfg.n_steps // 2, ids)))
    steps, amounts = payment_table(d)
    q, nxt = 0, steps[0]
    for j in range(cfg.n_steps):
        z = (z0 if j % 2 == 0 else z1)[j // 2]
        pays = j == nxt
        if pays:
            dj = torch.tensor(amounts[q])
            q += 1
            nxt = steps[q]
        for leg in range(n_legs):
            x = s[leg] * torch.exp(p.drift_dt + p.vol_dt * (-z if leg else z))
            if pays:
                x = x - dj
            s[leg] = torch.clamp(x, min=td.DIV_FLOOR)
            st[leg] = payoff.update(st[leg], s[leg], p)
    pays_ = [payoff.terminal(st[leg], s[leg], p) for leg in range(n_legs)]
    return pays_[0] if n_legs == 1 else 0.5 * (pays_[0] + pays_[1])


def same_bits(a, b) -> bool:
    """Bit for bit, but that a NaN may carry another payload."""
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all()
                and (a[~nan].view(np.uint32) == b[~nan].view(np.uint32)).all())


def _case(name, label, n_steps, antithetic, n_paths=2051, offset=0):
    opt = OptionParams(**OPTIONS.get(name, {}))
    d = schedule(label, n_steps)
    params = td.pack_divs(opt, d, n_steps, "cpu")
    cfg = td.DivsConfig(n_paths=n_paths, n_steps=n_steps, antithetic=antithetic)
    ids = torch.arange(offset, offset + n_paths, dtype=torch.int64)
    return get_payoff(name), cfg, td.unpack_divs(params), ids, d


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("label", SCHEDULES)
@pytest.mark.parametrize("name", ["vanilla_call", "bullet_call", "asian_call",
                                  "up_out_call_bb"])
def test_table_walk_is_the_plain_step_bitwise(name, label, antithetic):
    """The table and the skipped subtract give every path's payoff of the
    plain version bit for bit, on each edge schedule."""
    po, cfg, p, ids, d = _case(name, label, 20, antithetic)
    want = td._pay(po, cfg, p, ids.float(), *KEY, ids)
    got = mirror_pay(po, cfg, p, ids, d)
    assert same_bits(got.numpy(), want.numpy())


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("name", sorted(PAYOFFS))
def test_every_payoff_on_two_payments(name, antithetic):
    po, cfg, p, ids, d = _case(name, "two payments", 40, antithetic)
    want = td._pay(po, cfg, p, ids.float(), *KEY, ids)
    assert same_bits(mirror_pay(po, cfg, p, ids, d).numpy(), want.numpy())


@pytest.mark.parametrize("n_steps", [2, 4, 100])
@pytest.mark.parametrize("label", ["first and last step", "every step"])
def test_table_at_its_ends(n_steps, label):
    """A payment at step 0 and at the last step, or at every step, at the
    fewest steps the wrapper admits and at the demo's 100, with an offset
    past 2^20."""
    po, cfg, p, ids, d = _case("asian_call", label, n_steps, True,
                               offset=(1 << 20) + 12_345)
    steps, _ = payment_table(d)
    assert steps[0] == 0 and steps[-2] == n_steps - 1 and steps[-1] == n_steps
    want = td._pay(po, cfg, p, ids.float(), *KEY, ids)
    assert same_bits(mirror_pay(po, cfg, p, ids, d).numpy(), want.numpy())


@pytest.mark.parametrize("label", ["two payments", "every step", "above spot",
                                   "negative"])
def test_table_walk_matches_mc_tpu(label):
    """The mirror's payoffs against mc_tpu's leg on the same normals: the
    step contract of test_torch_divs.py (each framework's exp: 2e-6
    relative plus 4 ulp of the largest S) once per step."""
    n_steps, n = 20, 1024
    po, cfg, p, ids, d = _case("vanilla_call", label, n_steps, False, n)
    got = mirror_pay(po, cfg, p, ids, d).numpy()
    k0, k1 = KEY
    z0, z1 = rng.normal_pair(k0, k1, ids,
                             counters(ids, steps_index(n_steps // 2, ids)))
    jprm = jd._pack_divs(mc_tpu.OptionParams().as_f32(), d, n_steps)
    want = np.asarray(jd._divs_leg(
        jget_payoff("vanilla_call"), n_steps, jd._unpack_divs_head(jprm),
        lambda j: jprm[jd._HDR + j], jnp.full(n, F32(100.0)),
        lambda m: (jnp.asarray(z0.numpy())[m], jnp.asarray(z1.numpy())[m])))
    big = F32(np.abs(want).max() + 100.0)
    tol = n_steps * (2e-6 * big + 4 * np.spacing(big))
    assert (np.abs(got - want) <= tol).all()


def _grid() -> np.ndarray:
    """A dense f32 grid: the floor and its neighbours, subnormals, +-0,
    +-inf, and 2^20 floats spread over the whole range."""
    floor = F32(1e-6)
    near = np.nextafter(np.repeat(floor, 9), F32(np.inf), dtype=F32)
    u = np.linspace(0, 0xFFFFFFFF, 1 << 20, dtype=np.float64).astype(np.uint32)
    spread = u.view(F32)
    sub = np.array([1e-45, -1e-45, 1e-40, -1e-40, 1.1754942e-38], F32)
    return np.concatenate([spread, near, -near, sub, [floor, -floor],
                           np.array([0.0, -0.0, np.inf, -np.inf], F32)])


@pytest.mark.parametrize("zero", [0.0, -0.0])
def test_skipped_subtract_is_the_floor_alone(zero):
    """max(S - (+-0), 1e-6) is max(S, 1e-6) bit for bit on every S of the
    grid, under the card's fmaxf (NaN ignored) and the plain version's
    clamp (NaN kept)."""
    s = _grid()
    z = F32(zero)
    with np.errstate(invalid="ignore"):
        assert same_bits(np.fmax(s - z, F32(1e-6)), np.fmax(s, F32(1e-6)))
    ts = torch.from_numpy(s)
    assert same_bits(torch.clamp(ts - torch.tensor(z), min=1e-6).numpy(),
                     torch.clamp(ts, min=1e-6).numpy())


def constant(name: str, text: str = SRC) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_source_constants():
    """A block of 256 paths (the one-path kernel's), 2 paths a thread
    plain and antithetic, a table of up to 2,048 steps in (n + 1) * 8 bytes
    of dynamic shared memory, the step in divs.cuh."""
    assert constant("kDivsTile") == 256
    assert constant("kDivsPaths") == 2 and constant("kDivsPathsAnti") == 2
    assert constant("kDivsTableSteps") == 2048
    assert "(n_steps + 1) * (sizeof(int) + sizeof(float))" in SRC
    assert "if (n_steps <= kDivsTableSteps) {" in SRC
    assert "if (pays) x = x - dj;" in STEP
    assert "const bool pays = (__float_as_uint(dj) << 1) != 0u;" in SRC


def lane_paths(p: int, n: int, offset: int, bound: int) -> None:
    """Lane q of thread t takes path i + q*T (T = 256 / P): the paths it
    adds, and the ones it masks (past n_paths or at id >= bound, the id
    wrapping at 2^32), are the one-path thread t + q*T's, for 1, 3 and
    ceil(n / 256) blocks."""
    t = 256 // p
    for n_blocks in (1, 3, -(-n // 256)):
        stride = n_blocks * 256
        for b in range(n_blocks):
            for thread in range(t):
                for lane in range(p):
                    old = thread + lane * t  # the one-path kernel's thread
                    i = np.arange(b * 256 + thread, n, stride) + lane * t
                    got = i[i < n]
                    want = np.arange(b * 256 + old, n, stride)
                    assert np.array_equal(got, want)
                    assert np.array_equal(
                        ((offset + got) & 0xFFFFFFFF) < bound,
                        ((offset + want) & 0xFFFFFFFF) < bound)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("n,offset,bound_cut", [
    (1_000, 0, 13), (5_003, (1 << 20) + 7, 7), (77, (1 << 32) - 40, 1),
    (2_051, (1 << 21) + 1, 3)])
def test_lockstep_tail_keeps_the_parent_mask(p, n, offset, bound_cut):
    """The lanes' paths and masks are the one-path kernel's, at ragged
    counts and offsets past 2^20 (lane_paths)."""
    lane_paths(p, n, offset, (offset + n - n // bound_cut) & 0xFFFFFFFF)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("n,n_blocks", ((1_000, 4), (5_003, 2), (77, 1)))
def test_lanes_keep_the_block_sums(p, n, n_blocks):
    """P lanes a thread, added pairwise as the one-path tree's first levels,
    then the T threads' tree: each block's row bit for bit."""
    rs = np.random.default_rng(p * n + n_blocks)
    pay = (rs.standard_normal(n) * 23.0).astype(F32)
    valid = np.arange(n) < n - n // 9
    acc = _thread_sums(pay, valid, n_blocks).reshape(n_blocks, 256, 2)
    want = _tree(acc)
    lanes = acc.reshape(n_blocks, p, 256 // p, 2).copy()
    h = p // 2
    while h:
        lanes[:, :h] += lanes[:, h:2 * h]
        h //= 2
    assert _tree(lanes[:, 0]).tobytes() == want.tobytes()


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("tile", [256, 128])
@pytest.mark.parametrize("n_paths", [1, 255, 256, 257, 1_000_000,
                                     (1 << 32) - 1])
def test_wrapper_reads_the_librarys_paths_a_block(monkeypatch, n_paths, tile,
                                                  antithetic):
    """The grid is ceil(n_paths / the library's paths a block), capped at
    MAX_BLOCKS (the kernel grid-strides past it)."""
    cfg = td.DivsConfig(n_paths=n_paths, n_steps=100, antithetic=antithetic)
    params = torch.empty(td.packed_length(100), device="meta")
    got = launch_blocks(
        monkeypatch, td, "divs", tile,
        lambda: td.divs_partials(payoffs.get_payoff("vanilla_call"), cfg,
                                 (1, 2), params))
    assert got == min(-(-n_paths // tile), _cuda.MAX_BLOCKS)
