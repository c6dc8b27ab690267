"""The family trajectories kernel (family_trajectories_kernel,
``csrc/family.cuh``: Heston's #13, Merton's #15, local vol's #20, Vasicek's
#24 and the outer grids of CEV, SABR, term, Bates, the basket and the
rainbow): each
family's outer step split into a draw and an advance, a block of 128 paths
whose draw warps fill a double-buffered shared chunk of draw units while
its 128 advance lanes take the steps, the launch geometry (read from the
CUDA sources) and the grid the wrapper computes from the library's paths a
block.

No card is needed.  A mirror of the kernel's order (the grid-stride rounds,
chunks of C units drawn into one half of a (2, C, words, 128) buffer while
the lanes read the other, each lane stepping its own path, a ragged last
chunk and an odd last step of a pair) on the plain draws and steps gives
the plain version's grids and state grid bit for bit, and its rows, the
lanes' f64 sums over the rounds folded by reduce.cuh's tree, are the
one-path-a-thread kernel's rows on the plain version's payoffs.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_tpu_torch import nmc_engine as ne
from mc_tpu_torch import rng
from mc_tpu_torch.config import OptionParams, SimParams
from mc_tpu_torch.models import basket as bm
from mc_tpu_torch.models import heston as hm
from mc_tpu_torch.models import localvol as lm
from mc_tpu_torch.models import merton as mm
from mc_tpu_torch.models import vasicek as vm
from mc_tpu_torch.models.merton import counters
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
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops.payoffs import get_payoff
from test_torch_basket_launch import _thread_sums, _tree

CSRC = Path(ne.__file__).resolve().parent / "csrc"
FAMILY = (CSRC / "family.cuh").read_text()
ENTRY = (CSRC / "family_nmc_kernels.cu").read_text()
REDUCE = (CSRC / "reduce.cuh").read_text()
MASK = 0xFFFFFFFF
KEY = (0x12345678, 0x9ABCDEF0)


# --- the geometry, from the sources ------------------------------------------


def _const(name: str, text: str = FAMILY) -> int:
    m = re.search(rf"constexpr int {name} = (\d+)( \* 1024)?;", text)
    return int(m.group(1)) * (1024 if m.group(2) else 1)


def block_paths() -> int:
    assert ("int mc_family_trajectories_block_paths() { return "
            "mc::kFamilyThreads; }") in ENTRY
    return _const("kFamilyThreads")


def draw_warps() -> int:
    """kTrajDrawWarps: a plain constant, no build option."""
    assert "MC_TRAJ" not in FAMILY
    return _const("kTrajDrawWarps")


def chunk_units(words: int, warps: int) -> int:
    """TrajGeometry::kChunk: the units of `words` floats that fit the two
    buffer halves of kTrajBufferBytes, rounded down to a multiple of
    warps/4 (from 8 warps on) where one fits."""
    for line in ("kFit = kTrajBufferBytes / (2 * kFamilyThreads * sizeof(Draw));",
                 "kGroup = kDrawWarps >= 8 ? kDrawWarps / 4 : 1;",
                 "kChunk = kFit >= kGroup ? kFit / kGroup * kGroup : "
                 "(kFit > 1 ? kFit : 1);"):
        assert line in FAMILY, line
    fit = _const("kTrajBufferBytes") // (2 * block_paths() * 4 * words)
    group = warps // 4 if warps >= 8 else 1
    return fit // group * group if fit >= group else max(fit, 1)


# (family, header, struct, plain family): every struct the kernel runs
STRUCTS = (("heston", "family_nmc_kernels.cu", "HestonFamily", HestonNMC()),
           ("merton", "merton.cuh", "MertonFamily", MertonNMC(extras=(4,))),
           ("localvol", "localvol.cuh", "LocalVolFamily",
            LocalVolNMC(extras=(9,))),
           ("vasicek", "vasicek.cuh", "VasicekFamily", VasicekNMC()),
           ("cev", "cev.cuh", "CEVFamily", CEVNMC()),
           ("sabr", "sabr.cuh", "SABRFamily", SABRNMC()),
           ("term", "term.cuh", "TermFamily", TermNMC()),
           ("bates", "bates.cuh", "BatesFamily", BatesNMC(extras=(4,))),
           ("basket", "basket.cuh", "BasketFamily", BasketNMC(extras=(4,))),
           ("rainbow", "basket.cuh", "RainbowFamily",
            RainbowNMC(extras=(4, 0))))


def struct_body(header: str, struct: str) -> str:
    text = (CSRC / header).read_text()
    start = re.search(rf"struct {struct}\b[^;{{]*{{", text).end()
    depth, i = 1, start
    while depth:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        i += 1
    return text[start:i]


def outer_words(header: str, struct: str) -> int:
    """The floats of the struct's OuterDraw (DrawWords<N>; the basket's its
    capacity, of which a call draws 2*ceil(d/2))."""
    if struct == "RainbowFamily":  # the basket's
        struct = "BasketFamily"
    m = re.search(r"using OuterDraw = DrawWords<(\w+)>;",
                  struct_body(header, struct))
    return int(m.group(1)) if m.group(1).isdigit() else 8


# each struct's step function, which outer_advance and outer_step share
STEPS = {"heston": "outer_advance<Payoff>(",
         "merton": "merton_step<Payoff>(", "localvol": "lv_step<Payoff>(",
         "vasicek": "vasicek_step(", "cev": "cev_substep<Payoff>(",
         "sabr": "outer_advance<Payoff>(", "term": "term_step<Payoff>(",
         "bates": "outer_advance<Payoff>(", "basket": "outer_advance<Payoff>(",
         "rainbow": "outer_advance<Payoff>("}


def _method(body: str, name: str) -> str:
    text = body[body.index(f"static void {name}("):]
    return text[:text.index("\n  }\n")]


@pytest.mark.parametrize("family,header,struct,fam", STRUCTS,
                         ids=[s[0] for s in STRUCTS])
def test_every_family_splits_its_outer_step(family, header, struct, fam):
    """Each struct draws a unit (outer_draw), advances a step on it
    (outer_advance) and takes kStepsPerDraw steps a unit: 2 where the plain
    family consumes a pair (even_steps), 1 elsewhere.  outer_step draws at a
    unit's first step (a pair's odd half parked in the carry, as before the
    split, so the fused kernel compiles its old outer loop) and takes the
    step outer_advance takes.  Merton and Bates, whose draw holds a Poisson
    uniform, also count it against the block's table (draw_counts) and step
    on the count (outer_advance_counted)."""
    body = struct_body(header, struct)
    advance = _method(body, "outer_advance")
    if family == "rainbow":  # the basket's draw, its own fold
        assert "struct RainbowFamily : BasketFamily<kMaxD>" in (
            CSRC / header).read_text()
        body = struct_body(header, "BasketFamily") + body
    assert "static void outer_draw(" in body
    m = re.search(r"static constexpr int kStepsPerDraw = (\d);", body)
    assert int(m.group(1)) == (2 if fam.even_steps else 1)
    step = _method(struct_body(header, struct), "outer_step")
    assert "outer_draw(" in step and STEPS[family] in step
    if fam.even_steps:
        assert "if ((j & 1) == 0) {" in step and STEPS[family] in advance
        assert "(j & 1) == 0 ?" in advance or "const bool even = (j & 1) == 0;" in advance
    # the blocks an SM up to which the draws split off: where the draw is
    # most of a step, more (PERF.md §6, the probe's crossover); capacity 32
    # never splits
    m = re.search(r"static constexpr int kTrajSplitBlocks = ([^;]+);", body)
    split = {"4": (4, 4), "2": (2, 2), "kMaxD <= 8 ? 2 : 0": (2, 0)}[m.group(1)]
    assert split[0] == (4 if family in ("merton", "vasicek", "bates") else 2)
    assert split[1] == (0 if family in ("basket", "rainbow") else split[0])
    has_table = fam.table_floats() > 0
    assert ("static void draw_counts(" in body) == has_table
    assert ("static void outer_advance_counted(" in body) == has_table


def test_kernel_structure_in_source():
    """128 paths a block, the draw warps after the advance lanes, one
    barrier a chunk, the rows folded over the advance lanes only; the split
    and the one-thread-a-path kernels instantiated apart, each under its own
    launch bounds."""
    assert block_paths() == 128 and draw_warps() % 4 == 0
    assert "constexpr int kThreads = kFamilyThreads + 32 * kDrawWarps;" in FAMILY
    assert ("const bool mine = threadIdx.x < kFamilyThreads && i < n_paths;"
            in FAMILY)
    assert ("template <class Family, class Payoff, bool kSplit>\n__global__ "
            "void __launch_bounds__(kSplit ? TrajGeometry<Family>::kThreads : "
            "kFamilyThreads)\nfamily_trajectories_kernel(") in FAMILY
    # the draw warps run where the grid leaves an SM few blocks; a family
    # that never splits instantiates no split kernel
    assert ("return n_blocks <= static_cast<long long>(Family::kTrajSplitBlocks)"
            " * traj_sm_count();") in FAMILY
    assert FAMILY.count("if constexpr (Family::kTrajSplitBlocks > 0) {") == 2
    assert FAMILY.count("family_trajectories_kernel<Family, Payoff, true>") == 2
    assert FAMILY.count("family_trajectories_kernel<Family, Payoff, false>") == 2
    assert "return split ? TrajGeometry<Family>::kThreads : kFamilyThreads;" in FAMILY
    assert ("block_store_moments_unrolled<2, kFamilyThreads>(acc,\n"
            in FAMILY)
    assert "__syncthreads();  // chunk q read, chunk q+1 written" in FAMILY
    assert FAMILY.count("Family::draw_counts(p, d)") == 1
    # one out-of-line draw serves both kernels of every payoff
    assert ("__device__ __noinline__ typename Family::OuterDraw family_draw("
            in FAMILY)
    assert FAMILY.count("family_draw<Family>(p, k0, k1, ") == 2
    # the fold: the tree of a 128-thread block, the other threads idle
    body = REDUCE[REDUCE.index("void block_store_moments_unrolled("):]
    body = body[:body.index("\n}\n")]
    assert "if (threadIdx.x < THREADS) {" in body
    assert "for (int s = THREADS / 2; s > 0; s >>= 1) {" in body
    assert "sh[m][threadIdx.x] += sh[m][threadIdx.x + s];" in body
    assert "block_store_moments_lanes" not in REDUCE


@pytest.mark.parametrize("family,header,struct,fam", STRUCTS,
                         ids=[s[0] for s in STRUCTS])
@pytest.mark.parametrize("warps", (4, 12))
def test_buffer_fits_and_spreads_evenly(family, header, struct, fam, warps):
    """Both halves and Merton's or Bates's table (up to 256 floats) fit the
    48 KB a block takes without opting in, beside the fold's 2 KB; a chunk
    of C units is C*128 draws, a whole number a draw thread where the
    buffer holds a multiple of warps/4 units."""
    words = outer_words(header, struct)
    c = chunk_units(words, warps)
    buffer = 2 * c * words * block_paths() * 4
    assert c >= 1 and buffer <= _const("kTrajBufferBytes")
    assert buffer + 256 * 4 + 2 * 128 * 8 <= 48 * 1024
    if c >= warps // 4:
        assert c * 128 % (32 * warps) == 0 or warps == 4


def test_wrapper_grid_from_the_librarys_block_paths():
    src = Path(ne.__file__).read_text()
    assert "lib.mc_family_trajectories_block_paths()" in src
    assert "mc_family_block_threads()" in src  # the fused kernel's tiles


@pytest.mark.parametrize("n_paths", (1, 127, 128, 129, 2_049,
                                     (1 << 20) + 1))
@pytest.mark.parametrize("tile", (128, 64))
def test_wrapper_passes_the_grid(monkeypatch, n_paths, tile):
    """ceil(n_paths / the library's paths a block) blocks, capped at
    MAX_BLOCKS, a partials row each, one launch counted."""
    seen = []

    class Lib:
        def __getattr__(self, attr):
            if attr == "mc_family_trajectories_block_paths":
                return lambda: tile
            if attr == "mc_family_trajectories":
                return lambda *args: seen.append(args) or 0
            raise AttributeError(attr)

    monkeypatch.setattr(_cuda, "load", Lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_cuda, "launch_counts",
                        dict.fromkeys(_cuda.KERNELS, 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    fam = SABRNMC()
    monkeypatch.setattr(fam, "check_params", lambda params, n: None)
    params = torch.empty(17, device="meta")
    cfg = ne.FamilyConfig(n_paths=n_paths, n_steps=2, n_inner=1)
    *grids, st, rows = ne.family_trajectories(
        fam, get_payoff("vanilla_call"), cfg, (1, 2), params)
    blocks = min(-(-n_paths // tile), _cuda.MAX_BLOCKS)
    assert len(seen) == 1 and seen[0][-2] == blocks
    assert rows.shape == (blocks, 2) and len(grids) == 2
    assert _cuda.launch_counts["family_trajectories"] == 1


# --- the mirror of the kernel's order ----------------------------------------


class _Merton:
    """Unit m: merton_draw3's [z0, z1, e0, e1, u0, u1], the uniforms turned
    into their counts on the draw side; step 2m + h takes half h."""
    S = 2

    def __init__(self, n_steps):
        self.fam = MertonNMC(extras=(mm.poisson_kmax(
            mm.DEMO_MERTON.lam / n_steps),))
        self.params = mm.pack_merton(OptionParams(), mm.DEMO_MERTON, n_steps,
                                     "cpu")
        self.p = mm.unpack_merton(self.params)

    def words(self, ids, u):
        z0, z1, e0, e1, u0, u1 = mm.merton_draw3(*KEY, ids, u)
        kmax = self.fam.kmax
        return [z0, z1, e0, e1, mm.poisson_inv_cdf(u0, self.p.lam_dt, kmax),
                mm.poisson_inv_cdf(u1, self.p.lam_dt, kmax)]

    def init(self, po, like):
        zero = torch.zeros_like(like)
        return zero, zero + self.p.s0, po.init(self.p, zero)

    def advance(self, po, carry, j, wd):
        w, s0, state = carry[0], self.p.s0 + torch.zeros_like(carry[0]), carry[2]
        h = j & 1
        p = self.p
        w = w + p.drift_dt + p.vol_dt * wd[h] + mm.jump_increment(p, wd[4 + h],
                                                                 wd[2 + h])
        s = s0 * torch.exp(w)
        state = po.update(state, s, p)
        return (w, s, state), (s,)

    def pay(self, po, carry):
        return po.terminal(carry[2], carry[1], self.p)

    def plain(self, po, n, steps, offset, n_valid):
        cfg = mm.MertonConfig(n_paths=n, n_steps=steps, kmax=self.fam.kmax)
        return mm.merton_trajectories_plain(po, cfg, KEY, self.params, offset,
                                            n_valid)

    def pay_from_grids(self, po, grids, state):
        return po.terminal(state, grids[0][-1], self.p)


class _LocalVol(_Merton):
    """Unit m: pair (id, m); step 2m + h takes its normal h."""

    def __init__(self, n_steps):
        self.surf = lm.LocalVolSurface.demo(n_steps)
        self.params = lm.pack_localvol(OptionParams(), self.surf, n_steps,
                                       "cpu")
        self.p = lm.unpack_localvol(self.params, self.surf.n_knots)

    def words(self, ids, u):
        return list(rng.normal_pair(*KEY, ids, counters(ids, u)))

    def advance(self, po, carry, j, wd):
        w, s, state = lm.localvol_step(po, self.p, carry[0], carry[2],
                                       wd[j & 1], j)
        return (w, s, state), (s,)

    def plain(self, po, n, steps, offset, n_valid):
        cfg = lm.LocalVolConfig(n_paths=n, n_steps=steps,
                                n_knots=self.surf.n_knots)
        return lm.localvol_trajectories_plain(po, cfg, KEY, self.params,
                                              offset, n_valid)


class _Vasicek(_Merton):
    """Unit m: pairs 3m, 3m+1, 3m+2 of path id; the even step on (z0, z1,
    z2), the odd on (z3, z4, z5)."""

    def __init__(self, n_steps):
        self.params = vm.pack_vasicek(OptionParams(), vm.DEMO_VASICEK, n_steps,
                                      "cpu")
        self.p = vm.unpack_vasicek(self.params)

    def words(self, ids, u):
        out = []
        for c in range(3):
            out += rng.normal_pair(*KEY, ids, counters(ids, 3 * u + c))
        return out

    def init(self, po, like):
        zero = torch.zeros_like(like)
        return (zero, zero + self.p.x0, zero), zero + self.p.s0, po.init(
            self.p, zero)

    def advance(self, po, carry, j, wd):
        h = 3 * (j & 1)
        s0 = self.p.s0 + torch.zeros_like(carry[1])
        g, s = vm.vasicek_step(self.p, carry[0], *wd[h:h + 3], s0)
        state = po.update(carry[2], s, self.p)
        return (g, s, state), (s, g[1], g[2])

    def pay(self, po, carry):
        return po.terminal(carry[2], carry[1], self.p) * torch.exp(
            -carry[0][2])

    def plain(self, po, n, steps, offset, n_valid):
        cfg = vm.VasicekConfig(n_paths=n, n_steps=steps)
        return vm.vasicek_trajectories_plain(po, cfg, KEY, self.params,
                                             offset, n_valid)

    def pay_from_grids(self, po, grids, state):
        return po.terminal(state, grids[0][-1], self.p) * torch.exp(
            -grids[2][-1])


class _Generic:
    """A family on the engine's plain hooks (one step a unit): SABR's pair
    (id, j); the basket's ceil(d/2) pairs j*npps + q, 2*npps words."""
    S = 1

    def __init__(self, fam, params):
        self.fam, self.params = fam, params
        self.p = fam.unpack(params)

    def words(self, ids, u):
        npps = (self.fam.d + 1) // 2 if hasattr(self.fam, "d") else 1
        out = []
        for q in range(npps):
            out += rng.normal_pair(*KEY, ids, counters(ids, u * npps + q))
        return out

    def init(self, po, like):
        return self.fam.outer_init(po, self.p, like)

    def advance(self, po, carry, j, wd):
        draws = ((torch.stack(wd[:self.fam.d]),) if hasattr(self.fam, "d")
                 else tuple(wd))
        carry, (*market, _) = self.fam.outer_step(po, self.p, carry, draws)
        return carry, tuple(market)

    def pay(self, po, carry):
        return self.fam.outer_pay(po, self.p, carry)

    def plain(self, po, n, steps, offset, n_valid):
        cfg = ne.FamilyConfig(n_paths=n, n_steps=steps, n_inner=1)
        return ne.family_trajectories_plain(self.fam, po, cfg, KEY,
                                            self.params, offset, n_valid)

    def pay_from_grids(self, po, grids, state):
        if hasattr(self.fam, "d"):
            s = self.fam.level(self.p, torch.stack([g[-1] for g in grids]))
        else:
            s = grids[0][-1]
        return po.terminal(state, s, self.p)


class _Heston(_Generic):
    """Heston on HestonNMC's plain hooks (unit j: pair (id, j)), held to
    the models module's own plain version."""

    def plain(self, po, n, steps, offset, n_valid):
        cfg = hm.HestonConfig(n_paths=n, n_steps=steps)
        return hm.heston_trajectories_plain(po, cfg, KEY, self.params, offset,
                                            n_valid)


def _heston(n_steps):
    return _Heston(HestonNMC(), hm.pack_heston(OptionParams(), hm.DEMO_HESTON,
                                               n_steps, "cpu"))


def _sabr(n_steps):
    from mc_tpu_torch.models import sabr as sm

    return _Generic(SABRNMC(), sm.pack_sabr(OptionParams(), sm.DEMO_SABR,
                                            n_steps, "cpu"))


def _basket(d):
    def make(n_steps):
        fam, dyn = BasketNMC(extras=(d,)), bm.demo_basket(d, 0.5)
        return _Generic(fam, fam.pack(OptionParams(), dyn, n_steps, "cpu"))
    return make


SPECS = {"heston": _heston, "merton": _Merton, "localvol": _LocalVol,
         "vasicek": _Vasicek, "sabr": _sabr, "basket d=3": _basket(3),
         "basket d=9": _basket(9)}


def mirror(spec, po, n, steps, offset, bound, n_blocks, chunk):
    """The kernel's order: (grids and state grid, rows, per-path pays).
    Each grid-stride round the draw warps fill chunk 0 into buffer half 0,
    then chunk q+1 into half (q+1)&1 while lane t of block b (column b*128
    + t) takes chunk q's units from half q&1, each unit's steps below
    n_steps in order; a lane adds its paths' [pay, pay^2] in f64 over the
    rounds and a block folds its 128 lanes by reduce.cuh's tree."""
    tile = block_paths()
    n_units = -(-steps // spec.S)
    n_chunks = -(-n_units // chunk)
    cols = n_blocks * tile
    acc = np.zeros((cols, 2))
    pays = torch.zeros(n)
    grids = None
    for base in range(0, n, cols):
        i = base + np.arange(cols)
        mine = i < n
        ids = torch.as_tensor((offset + i[mine]) & MASK, dtype=torch.int64)
        n_words = len(spec.words(ids, 0))
        buf = np.full((2, chunk, n_words, cols), np.nan, np.float32)

        def fill(q, half):
            for ul in range(chunk):
                u = q * chunk + ul
                if u < n_units:
                    for f, x in enumerate(spec.words(ids, u)):
                        buf[half, ul, f, mine] = x.numpy()

        fill(0, 0)
        carry = spec.init(po, ids.float())
        for q in range(n_chunks):
            half = q & 1
            if q + 1 < n_chunks:
                fill(q + 1, half ^ 1)
            for ul in range(chunk):
                u = q * chunk + ul
                if u >= n_units:
                    break
                words = [torch.from_numpy(buf[half, ul, f, mine].copy())
                         for f in range(n_words)]
                for s in range(spec.S):
                    j = u * spec.S + s
                    if j < steps:
                        carry, market = spec.advance(po, carry, j, words)
                        if grids is None:
                            grids = torch.full((len(market) + 1, steps, n),
                                               float("nan"))
                        for k, row in enumerate(market):
                            grids[k, j, i[mine]] = row
                        st = carry[-1]
                        grids[-1, j, i[mine]] = (st[0] if po.n_state else
                                                 torch.zeros_like(row))
        pay = spec.pay(po, carry)
        pays[i[mine]] = pay
        x = torch.where(ids < bound, pay, 0.0).numpy().astype(np.float32)
        acc[mine, 0] += x.astype(np.float64)
        acc[mine, 1] += (x * x).astype(np.float64)
    return grids, _tree(acc.reshape(n_blocks, tile, 2)), pays


# (paths, steps, offset, bound or None, blocks or None): ragged blocks, a
# ragged last chunk and an odd last step, grid-stride rounds over a grid
# capped at 3 blocks, ids past 2^32 and a bound below the run's end
SHAPES = ((1, 2, 0, None, None), (127, 16, 0, None, None),
          (129, 22, 0, None, None), (1_000, 18, 0, None, 3),
          (300, 6, (1 << 32) - 100, None, None),
          (300, 6, 1_000, 1_000 + 250, 2))
ODD = ((1, 1, 0, None, None), (129, 3, 0, None, None),
       (257, 17, 0, None, 1))


# the odd step counts under the families whose plain version takes them
MIRROR_CASES = [(name, shape) for name in sorted(SPECS)
                for shape in SHAPES + (ODD if name in ("heston", "sabr",
                                                       "basket d=3",
                                                       "basket d=9") else ())]


@pytest.mark.parametrize("spec_name,shape", MIRROR_CASES, ids=str)
@pytest.mark.parametrize("payoff", ("vanilla_call", "bullet_call"))
@pytest.mark.parametrize("warps", (0, 4, 12))
def test_mirror_gives_the_plain_grids_and_rows(spec_name, shape, payoff,
                                               warps):
    n, steps, offset, n_valid, blocks = shape
    spec = SPECS[spec_name](steps)
    po = get_payoff(payoff)
    # 0 draw warps: one thread a path, a unit at a time (a chunk of one)
    words = len(spec.words(torch.zeros(1, dtype=torch.int64), 0))
    chunk = 1 if warps == 0 else chunk_units(words, warps)
    n_blocks = blocks or min(-(-n // block_paths()), _cuda.MAX_BLOCKS)
    bound = ((offset + n) if n_valid is None else n_valid) & MASK
    *g_p, st_p, rows_p = spec.plain(po, n, steps, offset, n_valid)
    grids, rows, pays = mirror(spec, po, n, steps, offset, bound, n_blocks,
                               chunk)
    want = torch.stack([*g_p, st_p])
    assert grids.shape == want.shape
    assert torch.equal(grids.isnan(), want.isnan())
    ok = ~want.isnan()
    assert torch.equal(grids[ok].view(torch.int32), want[ok].view(torch.int32))
    # the pays the plain grids give, in the one-path kernel's order
    state = (st_p[-1],) if po.n_state else ()
    ref = spec.pay_from_grids(po, g_p, state).numpy().astype(np.float32)
    assert ref.tobytes() == pays.numpy().astype(np.float32).tobytes()
    ids = (offset + np.arange(n)) & MASK
    thread = _thread_sums(ref, ids < bound, n_blocks, block_paths())
    assert rows.tobytes() == _tree(thread.reshape(n_blocks, -1, 2)).tobytes()
    np.testing.assert_allclose(rows.sum(0), rows_p.double().sum(0).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_mirror_catches_a_neighbours_draw():
    """The mirror is no tautology: a lane reading its neighbour's column,
    or a chunk's last unit read from the half being filled, moves the
    grids."""
    spec = _Merton(16)
    po = get_payoff("vanilla_call")
    *g_p, st_p, _ = spec.plain(po, 129, 16, 0, None)
    good, _, _ = mirror(spec, po, 129, 16, 0, 129, 2, 3)
    assert torch.equal(good[0], g_p[0])

    class Shifted(_Merton):
        def words(self, ids, u):
            return super().words(torch.roll(ids, 1), u)

    bad, _, _ = mirror(Shifted(16), po, 129, 16, 0, 129, 2, 3)
    assert not torch.equal(bad[0], g_p[0])
