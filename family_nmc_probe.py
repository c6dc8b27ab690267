"""Probe the family nested-MC kernels (#29 family_inner_kernel, #30
family_fused_kernel), or with ``--qmc`` the QMC kernels (#33
qmc_model_kernel, #32 qmc_kernel, #31 qmc_bridge_kernel), or with ``--gbm``
the GBM nested-MC kernels (#3 nmc_fused_kernel, #5 nmc_inner_kernel), the
book (#7), the simulate kernel (#2 simulate_kernel), the terminal-pair
kernel (#1) and the strike ladder (#6 ladder_kernel), or with
``--trajectories`` the family trajectories kernel (#13, #15, #20, #24), or
with ``--basket`` the basket's partials and trajectories kernels (#25
basket_partials_kernel, #26 basket_trajectories_kernel), or with ``--fx``
the FX kernel (#28 fx_partials_kernel) and the rainbow's (#27
rainbow_partials_kernel), or with ``--greeks`` the pathwise-greek kernel
(#8 greek_kernel), or with
``--partials`` the local-vol, Merton, CEV and cash-dividend partials
kernels (#19 localvol_partials_kernel, #14 merton_partials_kernel, #18
cev_partials_kernel, #22 divs_partials_kernel), the Heston and Bates QE
kernels (#12 heston_qe_kernel, #16's QE instantiation) and #12's Euler
kernel (heston_euler_kernel), or with ``--sabr``
the SABR partials kernel (#17 sabr_partials_kernel), on one CUDA card:
what they cost in registers, spills, shared memory and resident blocks,
their SASS loops, and their times.

    python3 family_nmc_probe.py [--qmc | --gbm | --basket | --fx |
                                 --greeks | --partials | --sabr | --rates |
                                 --trajectories | --wrappers DIR]
                                [--kernels NAME,...]
                                [--variant LABEL=DIR[:DEFINE,...]] ...
                                [--sass] [--time] [--out PATH]

from the root of a checkout.  Each variant is a copy of ``csrc`` (DIR; the
package's own by default) whose family NMC sources (``family_nmc_kernels.cu``
and ``*_nmc*_kernels.cu``) it compiles with the package's nvcc flags and the
given ``-D`` defines into ``build/probe/<LABEL>/``, every variant's sources
at once (the CPUs less one compilers).  Per variant and family it prints
the ptxas resources of the VanillaCall instantiations of both kernels
(capacity 8 for the basket and the rainbow) and, where the variant has the
``mc_family_occupancy`` entry point, their resident blocks per SM.
``--sass`` prints the loops of the inner kernel's SASS (``cuobjdump``) for
term, local vol and the basket: each backward branch's span, its
instruction count and its instructions by class.  ``--time`` runs each
family's fused and inner kernels once at 16,384 x 100 x 500 (CUDA events,
after a warm-up at 256 x 8 x 8) in turns over the variants, twice, and
checks every variant's surfaces bit for bit against the first variant's.
A variant whose library lacks ``mc_family_occupancy`` is called through the
entry points as they were before the launch geometry was passed in (an
older commit's ``csrc``).

``--qmc`` builds ``qmc_kernels.cu`` and ``qmc_*_kernels.cu`` instead and
prints the ptxas resources of qmc_model_kernel<Leg, VanillaCall> per
family, of qmc_kernel<AsianCall> and qmc_bridge_kernel<AsianCall>, and,
where the variant exports them, each kernel's shifts a thread and resident
blocks per SM.  ``--sass`` prints the loops of those kernels and their
instructions by class.  ``--time`` runs
each family's call on 2^20 Sobol points x 100 steps x 16 shifts and the
GBM Asian by Euler and by the bridge on both point families (CUDA events,
after a warm-up at 4,096 points) in turns over the variants, twice, and
checks every variant's partials bit for bit against the first variant's.
A variant whose library does not export its shifts a thread
(``mc_qmc_shifts``) is called through the entry points as they were
before the shift groups were passed in, and one without
``mc_qmc_bridge_shifts`` through the W-buffer bridge's (one shift a block
row, the breadth-first schedule); where the bridge is streamed its shifts
a thread and its live slots at 100 steps are printed too.

``--gbm`` builds ``nmc_kernels.cu`` (through a unit that adds the resident
blocks per SM of its kernels) and prints the ptxas resources, the legs a
thread (where the variant exports them) and the resident blocks of both
kernels for BulletCall and VanillaCall; ``--sass`` prints their loops (the
pair loop among them) and their instructions by class.  ``--time`` runs
both kernels at 16,384 x 100 x 500, bullet and vanilla, on the plain
trajectories' grids (CUDA events, after a warm-up at 256 x 8 x 8) in turns
over the variants, twice, and checks every variant's surfaces and outer
moments bit for bit against the first variant's and its inner surface
against its fused one.  A variant whose library does not export its legs a
thread (``mc_nmc_legs``) is called through the entry points as they were
before the leg groups were passed in.  ``-DMC_NMC_LEGS=N`` sets a
variant's legs a thread.
``--gbm`` also builds the book kernel (#7, ``batch_kernels.cu``, into the
same library: it shares the bullet and the draw; a source without
``mc_book_occupancy``, an older commit's, through the unit's addition of
it), prints its resources, blocks per SM at 100 steps and (``--sass``) its
loops, and runs 265 edge books (every payoff on 5 contracts, plain,
antithetic, with the control variate and by the terminal draw; 1 to 300
contracts; 1 to 217 steps; barriers 0, -1, +-inf, NaN, spots 0, -0, -50,
+inf, NaN, sigma 0 and 1e19, an infinite drift, on every contract or two)
through every variant, each bitwise against the first; ``--time`` also
times it on chip_smoke.py's bullet book64, 64 x 2^20 x 100, in turns,
bitwise against the first.
``--gbm`` also builds the simulate kernel (#2, ``path_kernels.cu`` and
``simulate*_kernels.cu``; an older commit's, whose simulate_kernel took
its modes at run time, through a unit adding ``mc_simulate_occupancy``),
prints the ptxas resources of its BulletCall and VanillaCall (a tree's
TerminalOnly, which the six terminal-only payoffs share) threefry-13
instantiations, (``--sass``) their loops, its resident blocks per SM
under SIMULATE_MODES, runs 562 edge cases (simulate_edge_cases: every
payoff by Euler, plain, antithetic, with the control variate and both;
the terminal draw; importance sampling; 0 to 33 steps; resume at even and
odd starts of even and odd counts with resume spots +-0, -50, +inf, NaN;
the barrier payoffs' edges; ragged and past-the-grid path counts,
offsets and bounds) through every variant, each bitwise against the
first, and (``--time``) times chip_smoke.py's phase-5 simulate rows and
the bullet at 1M x 100 in turns, each call's time a batch's share (the
batch sized to >= 5 ms: a single call at ~0.03 ms is mostly launch).
``--gbm`` also runs the library's check of two premises of the kernels on
every input they can meet (``mc_nmc_libm_check``, as chip_smoke.py's phase
2 does, through the first variant that exports it): that ``sincosf`` is
``cosf`` and ``sinf`` bit for bit on each theta the Box-Muller draw can
give, and that ``expf`` keeps the order of every finite float (the barrier
legs' threshold rests on it).

``--basket`` builds ``basket_kernels.cu`` and each capacity's
``basket<N>_kernels.cu`` (a source without ``mc_basket_occupancy`` or
``mc_basket_trajectories_occupancy``, an older commit's, through a unit
that adds them) and prints the ptxas resources of every VanillaCall and
BulletCall instantiation of both kernels, each d's capacity, paths a
thread (where exported) and resident blocks per SM; ``--sass`` their
loops, with the instructions issued under a predicate and the forward
branches; then it runs 258 #26 edge cases (basket_grid_cases: every
one-word payoff at d = 1, 2, 3, 4, 5, 8, 9, 16, 17, 32; 1 to 100,001
paths at 1, 2 and 217 steps; past the capped grid; offsets and bounds
past 2^32; a Cholesky entry, weight or s0 of +-inf or NaN), grids and
rows bitwise against the first variant; ``--time`` runs price_basket's
kernel at 1M x 100 for d = 1, 4, 8, 9, 16, 32, with and without
antithetic, in turns over the variants, twice, and #26's call and bullet
at 100,000 x 100 for d = 1, 4, 9, 16, 32, each call a batch's share (>=
5 ms), in 2 pairs of turns beside its bound, each bitwise against the
first.  ``-DMC_BASKET_PATHS=N`` sets the partials kernel's paths a thread
of every capacity up to 16.  ``--sass`` writes each listed kernel's SASS
beside ``--out``.

``--fx`` builds ``fx_kernels.cu`` (an older commit's through a unit
adding ``mc_fx_occupancy``) and the rainbow's sources (#27:
``rainbow_kernels.cu`` and ``rainbow32_kernels.cu``; an older commit's
through a unit adding ``mc_rainbow_occupancy``), prints the ptxas
resources of every FX instantiation and of the rainbow's threefry-13 ones,
each contract's resident blocks per SM and the paths a block and a
thread, and the rainbow's paths a thread and blocks per SM about each
capacity; runs 384 FX edge cases (fx_cases: every contract under
threefry-13 and -20 at 1 to 2^24 paths, offsets and bounds past 2^32, rho
+-1 and 0, sigma 0, s0 or x0 of +-0, +inf, NaN, drifts past expf's range)
and 488 rainbow edge cases (rainbow_cases: every payoff, plain and
antithetic, under both rounds at d about every capacity; 1 to 2^21 + 3
paths; offsets and bounds past 2^32; an s0, a drift or a Cholesky entry of
+-inf or NaN) bitwise against the first variant; ``--time`` times the
quanto, GK and compo calls at 1M and 2^24 paths and RAINBOW_TIMED's
rainbow calls on 1M paths, each call a batch's share (>= 20 ms), in 3
pairs of turns, beside the bounds chip_smoke.py counts (``probe_bound``).
``--kernels fx`` or ``--kernels rainbow`` takes one half.

``--greeks`` builds ``greek_kernels.cu`` (the pathwise-greek kernel #8;
an older commit's through a unit adding ``mc_greek_occupancy``), prints
the ptxas resources of its threefry-13 instantiations, each mode's paths a
thread and each payoff's blocks per SM, (``--sass``) their loops; runs 168
edge cases (greek_cases: the five pathwise payoffs by each mode they take
under both rounds, 1 to 2^21 + 3 paths, 1 to 217 steps, sigma = 0, s0 =
+inf) bitwise against the first variant; ``--time`` times GREEK_TIMED (the
call at 1M terminal, the Asian and the call by Euler at 100,000 x 100),
each call a batch's share (>= 5 ms), in 3 pairs of turns, beside its
bound.

``--partials`` builds ``localvol_kernels.cu``, each knot capacity's
``localvol<N>_kernels.cu`` and ``merton_kernels.cu`` (a source without
``mc_localvol_occupancy`` or ``mc_merton_occupancy``, an older commit's,
through a unit that adds it) and prints the ptxas resources of the
VanillaCall threefry-13 instantiations, per shape the resident blocks per
SM and, where exported, the knot capacity and paths a thread; ``--sass``
their loops; then it runs 178 small cases (every payoff, K = 2-33, K = 25 at
300 steps, kmax 1-53, threefry-20, antithetic, an offset and a bound)
through every variant, each bitwise against the first; ``--time`` runs
price_localvol's kernel at 1M x 100 on the demo surface (K = 9) and on the
K = 25 CEV surface and price_merton's Euler (1M x 100) and terminal (1M)
kernels, with and without antithetic, in turns over the variants, twice,
each bitwise against the first.  A sweep of the paths a thread or the
knot capacity edits those constants in a copy of ``csrc`` and passes it as
a variant.  ``--partials`` also builds ``cev_kernels.cu`` and
``divs_kernels.cu`` (an older commit's through units adding
``mc_cev_occupancy`` and ``mc_divs_occupancy``), prints each variant's
``mc_cev_logf_check`` (CEV's clamped-spot logf against the toolkit's on
every float of [1e-12, FLT_MAX] and +inf), runs their edge cases
(cev_edge_cases, divs_edge_cases) and (``--time``) times price_cev's and
price_divs's kernels at 1M x 100 (the call plain and antithetic, the
Asian).  ``--partials`` also builds ``heston_kernels.cu`` and
``bates_kernels.cu`` with their ``<family>_qe_kernels.cu`` (an older
commit's through units adding ``mc_heston_occupancy`` and
``mc_bates_occupancy``), prints the ptxas resources of the QE and Euler
kernels and their blocks per SM, runs the QE edge cases (qe_edge_cases:
both samplers and both fall-backs of the martingale correction, diverging
warps, threefry-20, degenerate dynamics and barriers, Bates's depths and
non-finite jump parameters) and (``--time``) times price_heston's and
price_bates's QE kernels at 1M x 100 (the call plain and antithetic, the
Asian) and their Euler kernels' call.  ``--kernels heston_euler`` builds
the Heston sources for #12's Euler kernel (heston_euler_kernel, plain and
antithetic kernels apart since S is formed only where the payoff reads
it), runs its edge cases (heston_euler_edge_cases: every payoff, threefry-13
and -20, plain and antithetic, the stress regime, 0 to 453 steps, an
offset, bounds, more paths than the grid's threads, the barrier payoffs'
threshold at barriers +-0, -1, +-inf, NaN and spots +-0, -50, +inf, NaN)
and (``--time``) times its call and bullet at 1M x 100, plain and
antithetic.
``--kernels`` names the kernels to build and run (a comma list of
localvol, merton, cev, divs, heston_qe, bates_qe and heston_euler; all
seven by default).

``--sabr`` builds ``sabr_kernels.cu`` and ``sabr1_kernels.cu`` (the
unit-beta instantiations; a source without ``mc_sabr_occupancy``, an older
commit's, through a unit that adds it and is called through the entry
point before its unit-beta argument) and prints the ptxas resources of the
VanillaCall and BulletCall threefry-13 instantiations, per beta class and
antithetic the resident blocks per SM and paths a thread; ``--sass`` their
loops with the MUFU functions in each; then it runs 276 edge cases (every
payoff at beta 1 and 0.5, plain and antithetic; threefry-20; an offset and
a bound; 1, 2 and 7 steps; 2^21 + 4,099 paths, over the grid's threads; at
beta 1 alpha 0, -0, 1e19, inf, NaN, a forward of 0, 1e38, inf, NaN, nu 0
and 60, rho +-1, barriers 0, -1, +-inf, NaN) through every variant, each
bitwise against the first; ``--time`` runs price_sabr's kernel at 1M x 100
on the call at beta 1 (the demo) and 0.5, antithetic and not, the bullet
and the Asian at beta 1, and the beta = 1 call through the general-beta
kernel, in turns over the variants, twice, each bitwise against the first.

``--gbm --kernels terminal_pair`` builds ``path_kernels.cu`` for the
terminal-pair kernel (#1 terminal_pair_kernel; an older commit's through a
unit adding ``mc_terminal_pair_occupancy``), prints its resources and
blocks per SM, runs each of the six terminal payoffs under threefry-13 and
-20 over ragged element counts, odd path totals and degenerate options
through every variant, each bitwise against the first, and (``--time``)
times the call at 1M and 2^24 paths in turns, each call's time a batch's
share.

``--gbm --kernels ladder`` builds ``batch_kernels.cu`` for the strike
ladder (#6 ladder_kernel; an older commit's through a unit adding
``mc_ladder_occupancy``), prints the ptxas resources of its VanillaCall and
BulletCall instantiations, its paths a block, paths a thread and strikes a
pass by mode and its blocks per SM; runs 256 edge ladders (the call and
the put by the terminal draw and by Euler, the bullet and the Asian by
Euler, plain and antithetic, at M = 1, 3, 17, 64 and 67 strikes over 1,
255, 257 and 2^20 + 3 paths; the call and the bullet at offsets past 2^32
and a bound below the run's end) through every variant, rows bitwise
against the first (both keep the one-path-a-thread tree's order); and
(``--time``) times LADDER_TIMED (the call by the terminal draw at 1M paths
and M = 1, 4, 17, 64; the Euler bullet at 16,384 and 1M x 100, M = 17),
each call a batch's share (>= 5 ms), in 3 pairs of turns, beside
``chip_smoke.probe_bound("ladder")``.

``--rates`` builds ``rates_kernels.cu`` (the rates kernel #11
rates_partials_kernel; an older commit's through a unit adding
``mc_rates_occupancy``), prints the ptxas resources of its instantiations,
blocks per SM per tile at 10, 60 and 513 payments, paths a thread and
staging cap (where exported) and (``--sass``) its loops; runs every tile,
payer and receiver, over 1 to 100,001 paths at n = 1, 2, 3, 10, 60, the
cap and one past it, offsets and bounds past 2^32, non-finite and
overflowing packs and 2^24 paths, through every variant, each bitwise
against the first; ``--time`` times each tile at 2^20 and 2^24 paths with
10 payments and at 2^20 with 60 and with the cap, in turns, each call's
time a batch's share.  The library stages the tables up to its cap and
reads them in place past it; a variant whose copy of ``csrc`` sets
``kRatesStagePayments`` to 0 times the in-place path at every n.

``--trajectories`` builds the family NMC sources for the family
trajectories kernel (family_trajectories_kernel, family.cuh: Heston's #13,
Merton's #15, local vol's #20, Vasicek's #24 and the outer grids of CEV,
SABR, term, Bates, the basket and the rainbow at capacities 8 and 32; an
older commit's sources through units adding each family's resident
blocks, TRAJ_SHIM; one whose Heston grids came from a kernel of its own,
``mc_heston_trajectories``, through HESTON_TRAJ_SHIM, called there, its
rows' sums held to f64 rounding), prints the ptxas resources of its
VanillaCall and BulletCall instantiations and each instantiation's threads
a block and resident blocks per SM; runs ~1,100 edge cases (traj_cases:
the call and the bullet of every instantiation at 1 to 217 steps and 1 to
16,385 paths, every one-word payoff on Heston, Merton and the basket, the
basket and the
rainbow at d = 1, 3, 8, 9, 32 under both folds, a grid capped at 3
blocks, offsets and bounds past 2^32, the last packed field at +-inf and
NaN) through every variant, grids, state grid and rows bitwise against
the first; ``--time`` times the call and the bullet of every
instantiation at TRAJ_TIMED (16,384 x 100, 2,048 x 16, 2,048 x 100,
20,000, 33,000, 50,000 and 100,000 x 100), each call a batch's share (>=
5 ms), in 3 pairs of turns,
beside the bound chip_smoke.py counts (``probe_bound``).  ``--kernels``
takes a comma list of TRAJ_INSTANCES' labels (``heston``, ``merton``, ..;
all by default).  A sweep is a
variant whose copy of ``csrc`` edits the constants in ``family.cuh`` and
the family headers: ``kTrajDrawWarps`` (the draw warps of a split block),
a family's ``kTrajSplitBlocks`` (the blocks an SM up to which its grids
split; 0: none, a large value: every grid), e.g.

    cp -r mc_tpu_torch/csrc build/split_all
    sed -i 's/kTrajSplitBlocks = [^;]*;/kTrajSplitBlocks = 1000000;/' \
        build/split_all/*.cuh
    python3 family_nmc_probe.py --trajectories --variant tree=mc_tpu_torch/csrc \
        --variant split_all=build/split_all --time

``--wrappers DIR`` builds nothing of its own: it imports the
``mc_tpu_torch`` of the checkout DIR (its library built, or loaded, under
DIR's ``build/``) and times the calls that chip_smoke.py's phase 5 times at
a shape the host owns: #1 through ``terminal_pair_partials`` on the 1M-path
call, #11 through ``fused_moment_partials`` per tile at 2^20 paths and
10 payments, #28 through ``fx_partials`` on the 1M-path quanto call,
#26 through ``basket_trajectories`` on the call at 100,000 x 100, d = 4,
#27 through ``rainbow_partials`` on the 1M-path best-of call at d = 4 and
antithetic at d = 2 and #8 through ``simulate_greek_partials`` at
GREEK_TIMED's shapes,
each as a batch's share of the CUDA events (>= 5 ms a batch) and as the
host clock's share of the same batch before its synchronize (the
wrapper's own host time, the launches queued behind it); and end to end
(host clock, each call ended by a synchronize) ``price()``'s 1M-path
call, ``price_fx()``'s 1M-path quanto call, ``price_rainbow()``'s 1M-path
best-of call at d = 4, ``greeks()``'s fused-kernel call at 1M terminal and
Asian at 100,000 x 100 and the six swaption rows, payer, at 2^20 paths.  Each row is the
median of WRAP_REPS.  Run it once a process from each of two checkouts in
turns (A B B A ...) to compare their host paths on one host.

Everything printed also goes, as JSON, to ``--out`` (default
``build/family_probe.json``).  Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

NMC_MAIN = (16384, 100, 500)
NMC_WARM = (256, 8, 8)
PAYOFF = "vanilla_call"
SASS_FAMILIES = ("term", "localvol", "basket")
ROOT = Path(__file__).resolve().parent

_u32, _int, _ptr = ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p


def families():
    """(name, NMCFamily, params at NMC_MAIN's steps, inner and outer keys,
    the device struct's name) of the ten families, the demo dynamics."""
    from mc_tpu_torch import engines, rng
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.models import basket as bm
    from mc_tpu_torch.models import bates as bam
    from mc_tpu_torch.models import cev as cm
    from mc_tpu_torch.models import heston as hm
    from mc_tpu_torch.models import localvol as lm
    from mc_tpu_torch.models import merton as mm
    from mc_tpu_torch.models import sabr as sm
    from mc_tpu_torch.models import term as tm
    from mc_tpu_torch.models import vasicek as vm
    from mc_tpu_torch.nmc_basket import BasketNMC
    from mc_tpu_torch.nmc_bates import BatesNMC
    from mc_tpu_torch.nmc_cev import CEVNMC
    from mc_tpu_torch.nmc_heston import HestonNMC
    from mc_tpu_torch.nmc_localvol import LocalVolNMC
    from mc_tpu_torch.nmc_merton import MertonNMC
    from mc_tpu_torch.nmc_rainbow import RAINBOW_NMC_TAG, RainbowNMC
    from mc_tpu_torch.nmc_sabr import SABRNMC
    from mc_tpu_torch.nmc_term import TermNMC
    from mc_tpu_torch.nmc_vasicek import VasicekNMC

    n_steps = NMC_MAIN[1]
    k_dt = mm.poisson_kmax(mm.DEMO_MERTON.lam / n_steps)
    table = (
        ("heston", HestonNMC(), hm.pack_heston, hm.DEMO_HESTON,
         hm.HESTON_TAG, "HestonFamily"),
        ("merton", MertonNMC(extras=(k_dt,)), mm.pack_merton, mm.DEMO_MERTON,
         mm.MERTON_TAG, "MertonFamily"),
        ("bates", BatesNMC(extras=(k_dt,)), bam.pack_bates, bam.DEMO_BATES,
         bam.BATES_TAG, "BatesFamily"),
        ("cev", CEVNMC(), cm.pack_cev, cm.DEMO_CEV, cm.CEV_TAG, "CEVFamily"),
        ("localvol", LocalVolNMC(extras=(9,)), lm.pack_localvol,
         lm.LocalVolSurface.demo(n_steps), lm.LOCALVOL_TAG, "LocalVolFamily"),
        ("sabr", SABRNMC(), sm.pack_sabr, sm.DEMO_SABR, sm.SABR_TAG,
         "SABRFamily"),
        ("term", TermNMC(), tm.pack_term, tm.demo_term(n_steps), tm.TERM_TAG,
         "TermFamily"),
        ("vasicek", VasicekNMC(), vm.pack_vasicek, vm.DEMO_VASICEK,
         vm.VASICEK_TAG, "VasicekFamily"),
        ("basket", BasketNMC(extras=(4,)), bm.pack_basket, bm.DEMO_BASKET,
         bm.BASKET_TAG, "BasketFamily<8>"),
        ("rainbow", RainbowNMC(extras=(4, 0)), bm.pack_basket,
         bm.demo_basket(4, 0.5), RAINBOW_NMC_TAG, "RainbowFamily<8>"),
    )
    out = []
    for name, fam, pack, dyn, tag, struct in table:
        keys = tuple(tuple(int(k) for k in rng.derive_key(1234, s, tag))
                     for s in (engines.STREAM_OUTER, engines.STREAM_INNER))
        out.append((name, fam, lambda n, d, pack=pack, dyn=dyn: pack(
            OptionParams(), dyn, n, d), keys, struct))
    return out


# --- build -------------------------------------------------------------------


# --gbm compiles a variant's nmc_kernels.cu and batch_kernels.cu (the book,
# #7, which shares the bullet and the draw) through this unit, which adds the
# resident blocks per SM of the NMC kernels (whatever their arguments).
GBM_SHIM = """#include "{src}/nmc_kernels.cu"
#include "{src}/batch_kernels.cu"

template <class P>
static int probe_occupancy(int fused, int* blocks) {{
  const int threads = mc_nmc_block_threads();
  if (fused)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mc::nmc_fused_kernel<P>,
                                                         threads, 0);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mc::nmc_inner_kernel<P>,
                                                       threads, 0);
}}

extern "C" int probe_nmc_occupancy(int payoff_id, int fused, int* blocks) {{
  switch (payoff_id) {{
    case mc::PAYOFF_BULLET_CALL: return probe_occupancy<mc::BulletCall>(fused, blocks);
    case mc::PAYOFF_VANILLA_CALL: return probe_occupancy<mc::VanillaCall>(fused, blocks);
    default: return cudaErrorInvalidValue;
  }}
}}
"""
# A batch_kernels.cu that predates mc_book_occupancy (one template argument,
# the buffer 8 bytes a pair and thread): this adds it to the --gbm unit.
BOOK_OCCUPANCY_SHIM = """
template <class P>
static int probe_book_occupancy(int euler, int n_steps, int threads, int* blocks) {{
  const int n_pairs = euler ? (n_steps + 1) / 2 : 1;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(n_pairs) * threads;
  if (smem > 48 * 1024) {{
    const cudaError_t err = cudaFuncSetAttribute(
        mc::book_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }}
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mc::book_kernel<P>, threads, smem);
}}

extern "C" int mc_book_occupancy(int payoff_id, int euler, int n_steps, int threads,
                                 int* blocks) {{
  switch (payoff_id) {{
    case mc::PAYOFF_BULLET_CALL:
      return probe_book_occupancy<mc::BulletCall>(euler, n_steps, threads, blocks);
    case mc::PAYOFF_VANILLA_CALL:
      return probe_book_occupancy<mc::VanillaCall>(euler, n_steps, threads, blocks);
    default: return cudaErrorInvalidValue;
  }}
}}
"""


# A path_kernels.cu that predates mc_simulate_occupancy (simulate_kernel<P,
# R>: the modes runtime flags, 256 threads a block): this unit adds it, for
# threefry-13 (the mode arguments ignored).
SIMULATE_SHIM = """#include "{src}/path_kernels.cu"

template <class P>
static int probe_simulate_occupancy(int* blocks) {{
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mc::simulate_kernel<P, 13>,
                                                       mc_block_threads(), 0);
}}

extern "C" int mc_simulate_occupancy(int payoff_id, int euler, int antithetic, int with_cv,
                                     int* blocks) {{
  (void)euler; (void)antithetic; (void)with_cv;
  switch (payoff_id) {{
    case mc::PAYOFF_BULLET_CALL: return probe_simulate_occupancy<mc::BulletCall>(blocks);
    case mc::PAYOFF_VANILLA_CALL: return probe_simulate_occupancy<mc::VanillaCall>(blocks);
    default: return cudaErrorInvalidValue;
  }}
}}
"""


def simulate_sources(src: Path, out: Path):
    """The sources of simulate_kernel (#2) in ``src``: ``path_kernels.cu``
    and any ``simulate*_kernels.cu``, through SIMULATE_SHIM where none
    exports ``mc_simulate_occupancy``."""
    own = [src / "path_kernels.cu", *sorted(src.glob("simulate*_kernels.cu"))]
    if any("mc_simulate_occupancy" in q.read_text() for q in own):
        return own
    unit = out / "simulate_probe.cu"
    unit.write_text(SIMULATE_SHIM.format(src=src))
    return [unit]


def probe_sources(src: Path, mode: str, out: Path, kernels=None):
    """The sources a probe compiles from ``src``: the family NMC ones, the
    QMC ones, or (``gbm``) the GBM NMC unit, written to ``out``
    (``partials``: those of ``kernels``)."""
    if mode == "qmc":
        return [src / "qmc_kernels.cu",
                *(p for p in src.glob("qmc_*_kernels.cu"))]
    if mode == "gbm":
        parts = kernels or GBM_PARTS
        srcs = []
        if {"nmc", "book"} & set(parts):
            shim = out / "nmc_probe.cu"
            text = GBM_SHIM
            if "mc_book_occupancy" not in (src / "batch_kernels.cu").read_text():
                text += BOOK_OCCUPANCY_SHIM
            shim.write_text(text.format(src=src))
            srcs.append(shim)
        if "simulate" in parts:
            srcs += simulate_sources(src, out)
        elif "terminal_pair" in parts:
            srcs.append(src / "path_kernels.cu")
        if "terminal_pair" in parts:
            srcs = terminal_pair_sources(src, out, srcs)
        if "ladder" in parts:
            srcs = ladder_sources(src, out, srcs)
        return srcs
    if mode == "rates":
        return rates_sources(src, out)
    if mode == "sabr":
        return sabr_sources(src, out)
    if mode == "basket":
        return basket_sources(src, out)
    if mode == "fx":
        return fx_sources(src, out, kernels or FX_PARTS)
    if mode == "greeks":
        return greek_sources(src, out)
    if mode == "partials":
        return partials_sources(src, out, kernels or PARTIALS_KERNELS)
    if mode == "trajectories":
        return traj_sources(src, out)
    return list(dict.fromkeys([src / "family_nmc_kernels.cu",
                               *src.glob("*_nmc_kernels.cu"),
                               *src.glob("*_nmc32_kernels.cu")]))


def build(variants, mode: str = "family", kernels=None):
    """Compile every variant's family NMC (QMC, GBM NMC) sources at once
    and link one library each: {label: (library path, {source: ptxas
    log})}."""
    from mc_tpu_torch.ops import _cuda

    nvcc = _cuda._nvcc()
    cmds, jobs = [], []
    for label, src, defines in variants:
        out = ROOT / "build" / "probe" / label
        out.mkdir(parents=True, exist_ok=True)
        for old in out.glob("*.o"):
            old.unlink()
        srcs = sorted(probe_sources(src, mode, out, kernels),
                      key=lambda p: -p.stat().st_size)
        for s in srcs:
            cmds.append([nvcc, *_cuda.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                         "-c", "-o", str(out / f"{s.stem}.o"), str(s)])
            jobs.append((label, s.name))
    t0 = time.perf_counter()
    runs = _cuda._run_all(cmds, max(1, len(os.sched_getaffinity(0)) - 1))
    print(f"probe: {len(cmds)} sources compiled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    logs = {}
    for (label, name), (err, sec) in zip(jobs, runs):
        logs.setdefault(label, {})[name] = err
        print(f"probe: {label} {name} nvcc {sec:.1f} s", flush=True)
    libs = {}
    for label, _, _ in variants:
        out = ROOT / "build" / "probe" / label
        lib = out / "libprobe.so"
        _cuda._run_all([[nvcc, "-shared", "-o", str(lib),
                         *map(str, sorted(out.glob("*.o")))]], 1)
        libs[label] = (lib, logs[label])
    return libs


def ptxas_resources(log: str) -> dict:
    """{mangled entry: {"registers", "stack", "spill_stores",
    "spill_loads", "smem", "callees"}} from a ``-Xptxas -v`` log: a frame
    line belongs to the function its "Function properties for" line names,
    the entry's own or an out-of-line callee's (under "callees")."""
    out, entry, fn = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {"callees": {}}
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            fn = m.group(1)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = [int(g) for g in m.groups()]
            if fn == entry:
                out[entry].update(zip(("stack", "spill_stores",
                                       "spill_loads"), frame))
            elif fn:
                out[entry]["callees"][fn] = frame
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[entry]["smem"] = int(s.group(1)) if s else 0
    return out


def entry_name(entries, kernel: str, struct: str):
    """The mangled entry of mc::<kernel><struct, VanillaCall>."""
    base, _, cap = struct.partition("<")
    pat = f"{len(kernel)}{kernel}INS_{len(base)}{base}"
    if cap:
        pat += f"ILi{cap.rstrip('>')}EEE"
    else:
        pat += "E"
    pat += "NS_11VanillaCallE"
    hits = [e for e in entries if pat in e]
    return hits[0] if hits else None


# --- SASS --------------------------------------------------------------------

_CLASSES = (("MUFU", r"^MUFU"), ("load", r"^(LDG|LDS|LD|LDC|ULDC|LDL)\b"),
            ("f64", r"^(DADD|DMUL|DFMA|DSETP|F2F)"),
            ("f32", r"^(FADD|FMUL|FFMA|FMNMX|FSETP|FSEL|FCHK|FRND|F2I|I2F)"),
            ("int", r"^(IADD3|LOP3|SHF|IMAD|ISETP|LEA|SEL|IABS|PRMT|UIADD3|"
                    r"ULOP3|USHF|UIMAD|ISCADD)"),
            ("branch", r"^(BRA|BSYNC|BSSY|EXIT|CALL|RET)"),
            ("call", r"^CALL"))


def _sass_ins(text: str):
    """[(address, opcode, operands, guard)] of a SASS listing (guard: the
    predicate, e.g. "@!P0", or "")."""
    ins = []
    for line in text.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                     r"(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(3), m.group(4),
                        (m.group(2) or "").strip()))
    return ins


def sass_classes(ins) -> dict:
    """The instructions of ``ins`` by class, and their count."""
    by = {c: sum(1 for _, o, _, _ in ins if re.match(p, o))
          for c, p in _CLASSES}
    return dict(n=len(ins), **by)


def sass_functions(lib: Path, want) -> dict:
    """{function name: its instructions} of the functions in ``lib``'s SASS
    whose name ``want(name)`` accepts (the first copy of a name that several
    objects define), streamed from ``cuobjdump``."""
    funcs, name, body = {}, None, []
    proc = subprocess.Popen(["cuobjdump", "-sass", str(lib)],
                            stdout=subprocess.PIPE, text=True)
    for line in proc.stdout:
        m = re.match(r"\s*Function : (\S+)", line)
        if m or "Fatbin" in line:
            if name is not None:
                funcs.setdefault(name, _sass_ins("".join(body)))
            name = m.group(1) if m and want(m.group(1)) else None
            body = []
        elif name is not None:
            body.append(line)
    if name is not None:
        funcs.setdefault(name, _sass_ins("".join(body)))
    proc.wait()
    return funcs


def sass_loops(lib: Path, entry: str, ins=None):
    """The SASS of ``entry`` (or the instructions ``ins``) and its loops:
    [{start, end, n, by class, predicated, branches}] for each backward
    branch, innermost first: ``predicated`` counts the instructions issued
    under a guard other than the always-true PT, ``branches`` the forward
    branches (a guard that skips code rather than predicating it)."""
    if ins is None:
        ins = _sass_ins(subprocess.run(
            ["cuobjdump", "-sass", "-fun", entry, str(lib)],
            capture_output=True, text=True).stdout)
    loops = []
    for i, (addr, op, rest, _) in enumerate(ins):
        if op.startswith("BRA"):
            t = re.search(r"0x([0-9a-f]+)", rest)
            if t and int(t.group(1), 16) <= addr:
                start = int(t.group(1), 16)
                body = [x for x in ins if start <= x[0] <= addr]
                by = {c: sum(1 for _, o, _, _ in body if re.match(p, o))
                      for c, p in _CLASSES}
                fwd = 0
                for a, o, r, _ in body:
                    t2 = re.search(r"0x([0-9a-f]+)", r)
                    fwd += bool(o.startswith("BRA") and t2
                                and int(t2.group(1), 16) > a)
                loops.append(dict(start=hex(start), end=hex(addr),
                                  n=len(body), **by,
                                  predicated=sum(1 for _, _, _, g in body
                                                 if g and g != "@PT"),
                                  branches=fwd))
    loops.sort(key=lambda lp: lp["n"])
    return len(ins), loops


def write_listing(out: str, label: str, name: str, ins) -> None:
    """A kernel's SASS (address, guard, instruction) beside ``out``."""
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).with_suffix(f".{label}.{name[-60:]}.sass").write_text("".join(
        f"{a:05x} {g} {o}{rest}\n" for a, o, rest, g in ins))


# --- runs --------------------------------------------------------------------


def bind(lib_path: Path, new_abi: bool):
    from mc_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    for name in ("mc_family_fused", "mc_family_inner",
                 "mc_family_trajectories", "mc_family_block_threads"):
        argtypes, restype = _cuda._SIGNATURES[name]
        getattr(lib, name).restype = restype
        if new_abi:
            getattr(lib, name).argtypes = argtypes
    if not new_abi:  # the entry points before the launch geometry was
        # passed in: no n_groups and stage_floats after n_inner
        X = _cuda.FamilyExtras
        lib.mc_family_fused.argtypes = [
            _int, _int, _u32, _u32, _u32, _u32, _ptr, X, _int, _int, _u32,
            _u32, _u32, _ptr, _ptr, _ptr]
        lib.mc_family_inner.argtypes = [
            _int, _int, _u32, _u32, _ptr, X, _int, _int, _u32, _u32, _u32,
            ctypes.POINTER(ctypes.c_void_p), _int, _ptr, _ptr, _ptr]
        lib.mc_family_trajectories.argtypes = \
            _cuda._SIGNATURES["mc_family_trajectories"][0]
    if hasattr(lib, "mc_family_occupancy"):
        lib.mc_family_occupancy.argtypes = [_int, _int, _cuda.FamilyExtras,
                                            _int, _int,
                                            ctypes.POINTER(ctypes.c_int)]
        lib.mc_family_occupancy.restype = _int
    return lib


def run_kernels(lib, new_abi, legs, fam, prm, keys, shape):
    """(fused surface, inner surface, fused ms, inner ms) of one call each
    at ``shape``, through ``lib``'s entry points (``legs``: the variant's
    MC_FAMILY_LEGS, or None)."""
    from mc_tpu_torch import nmc_engine as ne
    from mc_tpu_torch.ops import _cuda
    from mc_tpu_torch.ops.payoffs import get_payoff

    n_out, n_steps, n_inner = shape
    cfg = ne.FamilyConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
    po = get_payoff(PAYOFF)
    (ko0, ko1), (ki0, ki1) = keys
    stream = torch.cuda.current_stream().cuda_stream
    ex = _cuda.family_extras(fam.extras)
    if fam.name == "heston":  # its own trajectories kernel: the plain one
        from mc_tpu_torch.models import heston as hm
        grids = torch.stack(hm.heston_trajectories_plain(
            po, hm.HestonConfig(n_paths=n_out, n_steps=n_steps), keys[0],
            prm)[:3])
    else:
        grids = torch.empty((fam.n_grids + 1, n_steps, n_out),
                            dtype=torch.float32, device=prm.device)
        parts = torch.empty((8192, 2), dtype=torch.float64, device=prm.device)
        _check(lib.mc_family_trajectories(
            fam.cuda_id, po.cuda_id, ko0, ko1, prm.data_ptr(), ex, n_steps,
            n_out, 0, n_out, _cuda.pointer_array(grids[:fam.n_grids]),
            fam.n_grids, grids[fam.n_grids].data_ptr(), parts.data_ptr(),
            min(-(-n_out // 128), 8192), stream), "trajectories")
    surf_f = torch.empty((n_steps, n_out), dtype=torch.float32,
                         device=prm.device)
    surf_i = torch.empty_like(surf_f)
    outer = torch.empty((-(-n_out // 128), 2), dtype=torch.float64,
                        device=prm.device)
    if new_abi:  # the geometry at the variant's legs (its -D, or the family's)
        geo = ne.family_launch(fam, n_inner, prm.numel())
        geometry = (-(-n_inner // (legs or fam.legs)), geo.stage_floats)
    else:
        geometry = ()
    t = _events()
    _check(lib.mc_family_fused(
        fam.cuda_id, po.cuda_id, ko0, ko1, ki0, ki1, prm.data_ptr(), ex,
        n_steps, n_inner, *geometry, n_out, 0, n_out, surf_f.data_ptr(),
        outer.data_ptr(), stream), "fused")
    t.append(_event())
    _check(lib.mc_family_inner(
        fam.cuda_id, po.cuda_id, ki0, ki1, prm.data_ptr(), ex, n_steps,
        n_inner, *geometry, n_out, 0, n_out,
        _cuda.pointer_array(grids[:fam.n_grids]), fam.n_grids,
        grids[fam.n_grids].data_ptr(), surf_i.data_ptr(), stream), "inner")
    t.append(_event())
    torch.cuda.synchronize()
    return surf_f, surf_i, t[0].elapsed_time(t[1]), t[1].elapsed_time(t[2])


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _events():
    return [_event()]


def same_bits(a, b) -> bool:
    """a and b (f32 or f64) bit for bit, but that a NaN may carry another
    payload."""
    nan = a.isnan()
    word = torch.int32 if a.dtype == torch.float32 else torch.int64
    return bool(a.shape == b.shape and torch.equal(nan, b.isnan())
                and torch.equal(a[~nan].view(word), b[~nan].view(word)))


def _check(status, what):
    if status:
        raise RuntimeError(f"{what}: CUDA error {status}")


# --- the QMC kernels (--qmc) -------------------------------------------------

QMC_MAIN = (1 << 20, 100, 16)   # points, steps, shifts (chip_smoke.py's)
QMC_WARM = 4096
QMC_MODELS = (("heston", "HestonQmcLeg"), ("bates", "BatesQmcLeg"),
              ("basket", "BasketQmcLeg<8>"), ("cev", "CEVQmcLeg"),
              ("sabr", "SABRQmcLeg"), ("localvol", "LocalVolQmcLeg"),
              ("vasicek", "VasicekQmcLeg"), ("merton", "MertonQmcLeg"),
              ("term", "TermQmcLeg"))
QMC_GBM = (("euler sobol", "sobol", False), ("euler lattice", "lattice", False),
           ("bridge sobol", "sobol", True), ("bridge lattice", "lattice", True))


def qmc_cases(n_points: int, dev):
    """[(label, kind, payoff, point set, params, extra, family id)]: each
    family's call and the GBM Asian's four routes at n_points x 100 x 16."""
    from mc_tpu_torch import qmc
    from mc_tpu_torch.config import OptionParams, SimParams
    from mc_tpu_torch.ops import path_kernels as pk
    from mc_tpu_torch.ops.payoffs import get_payoff

    _, steps, shifts = QMC_MAIN
    sim = SimParams(n_paths=n_points, n_steps=steps)
    opt = OptionParams()
    cases = []
    for model, _ in QMC_MODELS:
        po, dyn, extra, ps = qmc.qmc_model_pointset(
            model, opt, None, sim, "vanilla_call", n_shifts=shifts,
            family="sobol", device=dev)
        m = qmc.QMC_MODELS[model]
        cases.append((model, "model", po, ps, m.pack(opt, dyn, steps, dev),
                      extra, m.family_id))
    asian = get_payoff("asian_call")
    for label, family, bridge in QMC_GBM:
        _, ps = qmc.qmc_pointset(asian, sim, shifts, "euler", family, bridge,
                                 0.1, 0, sim.seed, dev)
        cases.append((f"asian {label}", "bridge" if bridge else "gbm", asian,
                      ps, pk.pack_params(opt, steps, dev), 0, -1))
    return cases


def bind_qmc(lib_path: Path, new_abi: bool):
    from mc_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in _cuda._SIGNATURES.items():
        if name.startswith("mc_qmc") and hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype
    if not new_abi:  # the entry points before the shift groups were passed in
        lib.mc_qmc_sums.argtypes = [_int] * 5 + [_ptr, _ptr, _int, _ptr, _int,
                                                 _ptr, _int, _ptr]
        lib.mc_qmc_model_sums.argtypes = [_int] * 5 + [_ptr, _ptr, _int, _ptr,
                                                       _int, _int, _ptr, _int,
                                                       _ptr]
    if not hasattr(lib, "mc_qmc_bridge_shifts"):  # the W-buffer bridge's
        lib.mc_qmc_bridge_sums.argtypes = [_int, _int, _int, _int, _ptr, _ptr,
                                           _int, _ptr, _int, _ptr, _ptr, _ptr,
                                           _int, _ptr]
    return lib


def qmc_geometry(lib, case):
    """The variant's QmcLaunch of ``case`` (qmc.qmc_launch on its exported
    shifts)."""
    from mc_tpu_torch import qmc

    ps = case[3]
    return qmc.qmc_launch(ps.n, ps.n_shifts, qmc_shifts_of(lib, case))


def qmc_shifts_of(lib, case) -> int:
    """The variant's shifts a thread for ``case`` (1 before the export)."""
    _, kind, _, _, _, extra, fid = case
    if kind == "model" and hasattr(lib, "mc_qmc_model_shifts"):
        return lib.mc_qmc_model_shifts(fid, extra)
    if kind == "gbm" and hasattr(lib, "mc_qmc_shifts"):
        return lib.mc_qmc_shifts()
    if kind == "bridge" and hasattr(lib, "mc_qmc_bridge_shifts"):
        return lib.mc_qmc_bridge_shifts()
    return 1


def run_qmc(lib, new_abi: bool, case):
    """(partials, ms) of one call of ``case``'s kernel through ``lib``."""
    from mc_tpu_torch import qmc
    from mc_tpu_torch.ops import _cuda

    _, kind, po, ps, prm, extra, fid = case
    n_steps, r = QMC_MAIN[1], ps.n_shifts
    stream = torch.cuda.current_stream().cuda_stream
    fam = qmc.FAMILIES[ps.family]
    if kind == "bridge":
        threads = lib.mc_qmc_bridge_threads(n_steps)
    elif kind == "model":
        threads = lib.mc_qmc_model_block_threads()
    else:
        threads = lib.mc_qmc_block_threads()
    n_bx = min(_cuda.cdiv(ps.n, threads), _cuda.MAX_BLOCKS)
    partials = torch.empty((n_bx, r), dtype=torch.float64, device=prm.device)
    geo = ()
    streamed = kind == "bridge" and hasattr(lib, "mc_qmc_bridge_shifts")
    if (kind != "bridge" and new_abi) or streamed:
        geo = (qmc_geometry(lib, case).groups,)
    pts = (fam, ps.n, ps.d, ps.table.data_ptr(), ps.shifts.data_ptr(), r)
    t = _events()
    if kind == "model":
        status = lib.mc_qmc_model_sums(fid, po.cuda_id, *pts, prm.data_ptr(),
                                       n_steps, extra, partials.data_ptr(),
                                       n_bx, *geo, stream)
    elif kind == "gbm":
        status = lib.mc_qmc_sums(po.cuda_id, fam, 1, *pts[1:], prm.data_ptr(),
                                 n_steps, partials.data_ptr(), n_bx, *geo,
                                 stream)
    elif streamed:  # the bridge's entries depth first (bridge_stream)
        st = qmc.bridge_stream(n_steps)
        ent, pairs = (torch.from_numpy(x).to(prm.device)
                      for x in st.tables())
        t = _events()
        status = lib.mc_qmc_bridge_sums(po.cuda_id, fam, *pts[1:],
                                        prm.data_ptr(), n_steps, ent.data_ptr(),
                                        pairs.data_ptr(), st.n_slots,
                                        partials.data_ptr(), n_bx, *geo, stream)
    else:  # the breadth-first schedule and a W buffer (an older csrc)
        from mc_tpu_torch.qmc import bridge_schedule
        bidx, bcoef = bridge_schedule(n_steps)
        bi = torch.from_numpy(bidx.reshape(-1)).to(prm.device)
        bc = torch.from_numpy(bcoef.reshape(-1)).to(prm.device)
        t = _events()
        status = lib.mc_qmc_bridge_sums(po.cuda_id, fam, *pts[1:],
                                        prm.data_ptr(), n_steps, bi.data_ptr(),
                                        bc.data_ptr(), partials.data_ptr(),
                                        n_bx, stream)
    t.append(_event())
    _check(status, f"{case[0]} kernel")
    torch.cuda.synchronize()
    return partials, t[0].elapsed_time(t[1])


def qmc_entry(res, kernel: str, struct: str, payoff: str):
    """The mangled entry of mc::<kernel><struct, payoff> (no struct: the
    GBM kernels' <payoff>)."""
    if struct is None:
        pat = f"{len(kernel)}{kernel}INS_{len(payoff)}{payoff}E"
        hits = [e for e in res if pat in e]
        return hits[0] if hits else None
    return entry_name(res, kernel, struct)


def qmc_main(args, variants, card) -> dict:
    """The --qmc probe: resources, SASS and times of the QMC kernels."""
    libs = build(variants, "qmc")
    dev = torch.device("cuda")
    report = {"card": card, "variants": {}}
    bound = {}
    cases = qmc_cases(QMC_MAIN[0], dev) if args.time else []
    warm = {c[0]: c for c in qmc_cases(QMC_WARM, dev)}
    main_of = {"gbm": "asian euler sobol", "bridge": "asian bridge sobol"}
    kernels = [(m, "qmc_model_kernel", struct, "VanillaCall")
               for m, struct in QMC_MODELS]
    kernels += [("gbm", "qmc_kernel", None, "AsianCall"),
                ("bridge", "qmc_bridge_kernel", None, "AsianCall")]
    for label, src, defines in variants:
        lib_path, logs = libs[label]
        # the shift groups are passed in where the library exports kShifts
        new_abi = hasattr(ctypes.CDLL(str(lib_path)), "mc_qmc_shifts")
        lib = bind_qmc(lib_path, new_abi)
        bound[label] = (lib, new_abi)
        res = {}
        for log in logs.values():
            res.update(ptxas_resources(log))
        entries = {name: qmc_entry(res, kernel, struct, payoff)
                    for name, kernel, struct, payoff in kernels}
        funcs = (sass_functions(lib_path, lambda f: f in entries.values())
                 if args.sass else {})
        rows = {}
        for name, kernel, struct, payoff in kernels:
            e = entries[name]
            r = dict(res.get(e, {}))
            streamed = hasattr(lib, "mc_qmc_bridge_shifts")
            if hasattr(lib, "mc_qmc_occupancy") and (name != "bridge"
                                                     or streamed):
                case = warm[main_of.get(name, name)]  # its payoff and extra
                fid, extra = case[6], case[5]
                if name == "bridge":  # 128 threads, the stream's slots
                    from mc_tpu_torch.qmc import bridge_stream
                    fid, extra = -2, bridge_stream(QMC_MAIN[1]).n_slots
                    r["live_slots"] = extra
                blocks = ctypes.c_int(0)
                st = lib.mc_qmc_occupancy(fid, case[2].cuda_id, extra,
                                          ctypes.addressof(blocks))
                r.update(blocks_per_sm=blocks.value if st == 0 else None,
                         shifts=qmc_shifts_of(lib, case))
            if args.sass and e in funcs:
                n_ins, loops = sass_loops(lib_path, e, funcs[e])
                r["sass"] = dict(instructions=n_ins, loops=loops,
                                 total=sass_classes(funcs[e]))
                write_listing(args.out, label, name, funcs[e])
            rows[name] = r
            print(f"probe {label}: {name} {kernel}<{struct or payoff}>: "
                  f"{ {k: v for k, v in r.items() if k != 'sass'} } {card}",
                  flush=True)
            for lp in r.get("sass", {}).get("loops", []):
                print(f"  loop {lp}")
        report["variants"][label] = dict(src=str(src), defines=defines,
                                         kernels=rows, ptxas=logs)
    if args.time:
        times = {}
        for case in cases:
            ref = None
            order = list(bound) + list(bound)[::-1]
            for label in order:
                lib, new_abi = bound[label]
                run_qmc(lib, new_abi, warm[case[0]])
                part, ms = run_qmc(lib, new_abi, case)
                if ref is None:
                    ref = part
                same = bool(torch.equal(part, ref))
                times.setdefault(case[0], {}).setdefault(label, []).append(
                    dict(ms=ms, bitwise=same))
                print(f"probe time {case[0]} {label}: {ms:.3f} ms, bitwise "
                      f"vs {order[0]}: {same} {card}", flush=True)
                if not same:
                    print(f"FAIL: {case[0]} {label} disagrees", flush=True)
        report["times"] = times
    return report


# --- the GBM nested-MC kernels (--gbm) ---------------------------------------

GBM_PAYOFFS = (("bullet_call", "BulletCall"), ("vanilla_call", "VanillaCall"))
GBM_KERNELS = ("nmc_fused_kernel", "nmc_inner_kernel")
# --gbm's parts (--kernels): #3/#5, the book #7, simulate #2, terminal_pair
# #1, the ladder #6
GBM_PARTS = ("nmc", "book", "simulate", "terminal_pair", "ladder")
# The entry points before the leg groups were passed in (no n_groups after
# n_inner): an older commit's csrc.
_OLD_GBM_ABI = {
    "mc_nmc_fused": [_int, _int, _u32, _u32, _u32, _u32, _ptr, _int, _int,
                     _u32, _u32, _u32, _ptr, _ptr, _ptr],
    "mc_nmc_inner": [_int, _int, _u32, _u32, _ptr, _int, _int, _u32, _u32,
                     _u32, _ptr, _ptr, _ptr, _ptr]}


def bind_gbm(lib_path: Path):
    """(library, legs a thread or None): the GBM NMC entry points, with the
    leg groups passed in where the library exports its legs (``mc_nmc_legs``)
    and as they were before where it does not."""
    from mc_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    new_abi = hasattr(lib, "mc_nmc_legs")
    for name in ("mc_nmc_fused", "mc_nmc_inner", "mc_nmc_block_threads",
                 "mc_book_partials", *(("mc_nmc_legs",) if new_abi else ())):
        if not hasattr(lib, name):  # --kernels without nmc and book
            continue
        argtypes, restype = _cuda._SIGNATURES[name]
        fn = getattr(lib, name)
        fn.argtypes = argtypes if new_abi else _OLD_GBM_ABI.get(name, argtypes)
        fn.restype = restype
    if hasattr(lib, "probe_nmc_occupancy"):
        lib.probe_nmc_occupancy.argtypes = [_int, _int,
                                            ctypes.POINTER(ctypes.c_int)]
        lib.probe_nmc_occupancy.restype = _int
        lib.mc_book_occupancy.argtypes = [_int, _int, _int, _int,
                                          ctypes.POINTER(ctypes.c_int)]
        lib.mc_book_occupancy.restype = _int
    for name in ("mc_nmc_libm_check", "mc_simulate_partials",
                 "mc_terminal_pair"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes, getattr(lib, name).restype = (
                _cuda._SIGNATURES[name])
    if hasattr(lib, "mc_simulate_occupancy"):
        lib.mc_simulate_occupancy.argtypes = [_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.mc_simulate_occupancy.restype = _int
    if hasattr(lib, "mc_terminal_pair_occupancy"):
        lib.mc_terminal_pair_occupancy.argtypes = [
            ctypes.POINTER(ctypes.c_int)]
        lib.mc_terminal_pair_occupancy.restype = _int
    for name in ("mc_block_threads", "mc_simulate_block_paths",
                 "mc_terminal_pair_block_elems",
                 "mc_terminal_pair_elems_per_thread"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes, getattr(lib, name).restype = [], _int
    return lib, (lib.mc_nmc_legs() if new_abi else None)


# --- the simulate kernel (#2, --gbm) -----------------------------------------

SIMULATE_WARM = 4096
SIMULATE_EDGE = 4_099   # a ragged last block
IS_STRIKE = 180.0       # chip_smoke.py's importance-sampling call
# The mode combinations the occupancy rows list: (euler, antithetic, cv).
SIMULATE_MODES = ((1, 0, 0), (1, 1, 1), (0, 0, 0), (0, 1, 1))


def simulate_block_paths(lib) -> int:
    """Paths a block of simulate_kernel (the parent's: its threads)."""
    fn = getattr(lib, "mc_simulate_block_paths", None) or lib.mc_block_threads
    return fn()


def simulate_resume_state(payoff: str, n: int, start: int, s_edge):
    """Resume inputs at step ``start`` of ``n`` paths from default_rng(5):
    spots U(60, 140) (``s_edge``: values written over paths 0, 7, 14, ...)
    and the payoff's state words, plausible for its kind (counts, running
    sums, flags, spots)."""
    import math

    from mc_tpu_torch.ops.payoffs import get_payoff

    gen = np.random.default_rng(5)
    s = gen.uniform(60.0, 140.0, n).astype(np.float32)
    if s_edge:
        s[::7] = np.resize(np.asarray(s_edge, np.float32), s[::7].shape)
    words = {"bullet_call": [gen.integers(0, start, n)],
             "asian_call": [gen.uniform(60, 140, n) * start],
             "up_out_call": [gen.integers(0, 2, n)],
             "down_out_call": [gen.integers(0, 2, n)],
             "down_in_call": [gen.integers(0, 2, n)],
             "lookback_call": [gen.uniform(100, 160, n)],
             "up_out_call_bb": [gen.uniform(60, 140, n), gen.uniform(0, 1, n)],
             "down_out_call_bb": [gen.uniform(60, 140, n),
                                  gen.uniform(0, 1, n)],
             "variance_swap": [gen.uniform(60, 140, n),
                               gen.uniform(0, 0.1, n)],
             "forward_start_call": [np.full(n, start), gen.uniform(60, 140, n)],
             "cliquet": [np.full(n, start), gen.uniform(60, 140, n),
                         gen.uniform(-0.1, 0.1, n)],
             "asian_call_geo_cv": [gen.uniform(60, 140, n) * start,
                                   np.full(n, start * math.log(100.0))]}
    st = [np.asarray(w, np.float32) for w in
          words.get(payoff, [])][:get_payoff(payoff).n_state]
    return s, st


def simulate_edge_cases(timed: bool):
    """simulate_kernel's cases: (label, payoff, KernelConfig fields, option
    fields, extra).  Timed: chip_smoke.py's phase-5 rows (the bullet at
    100,000 x 100, the call by Euler at 1M x 100 plain, antithetic with the
    control variate and at K = 180 under importance sampling, the terminal
    antithetic call at 1M, the bullet resumed at step 50) and the bullet at
    1M x 100.  Else every payoff by Euler, plain, antithetic, with the
    control variate and both, under threefry-13 (plain and both also -20);
    the six terminal-only payoffs by the terminal draw the same way;
    importance sampling on the Euler and terminal legs; 0, 1, 2, 7 and 33
    steps; resume at steps 50 and 51 of 100 and 101 (the odd start takes
    the tail of its pair) with resume spots +-0, -50, +inf and NaN among
    them, every payoff's state words; the barrier payoffs at barriers +-0,
    -1, +-inf, NaN and spots +-0, -50 (under a barrier of -60, struck at
    -100), +inf, NaN; 1, 255, 257 and 2^21 + 4,099 paths; an offset past
    2^20 with a bound inside the run; a bound past the last path.  A
    resumed spot below 0 under a barrier of -60, struck at -100, is where
    its own threshold and S at each step part (the kernel steps S there)."""
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    inf, nan = float("inf"), float("nan")
    n_main, steps = PARTIALS_MAIN
    if timed:
        import math

        shift = math.log(IS_STRIKE / 100.0) / 0.2
        return [
            ("simulate bullet euler", "bullet_call",
             dict(n_paths=100_000, n_steps=steps), {}, {}),
            ("simulate call euler", "vanilla_call",
             dict(n_paths=n_main, n_steps=steps), {}, {}),
            ("simulate call euler antithetic+cv", "vanilla_call",
             dict(n_paths=n_main, n_steps=steps, antithetic=True,
                  with_cv=True), {}, {}),
            ("simulate call K=180 euler IS", "vanilla_call",
             dict(n_paths=n_main, n_steps=steps, is_shift=shift),
             dict(k=IS_STRIKE), {}),
            ("simulate call terminal antithetic", "vanilla_call",
             dict(n_paths=n_main, n_steps=steps, method="terminal",
                  antithetic=True), {}, {}),
            ("simulate bullet resumed at step 50", "bullet_call",
             dict(n_paths=100_000, n_steps=steps, start_step=50), {},
             dict(resume=())),
            ("simulate bullet euler 1M", "bullet_call",
             dict(n_paths=n_main, n_steps=steps), {}, {})]
    e = SIMULATE_EDGE
    out = []
    modes = (dict(), dict(antithetic=True), dict(with_cv=True),
             dict(antithetic=True, with_cv=True))

    def add(label, payoff, cfg=None, opt=None, **extra):
        out.append((f"simulate {label}", payoff,
                    {"n_paths": e, "n_steps": steps, **(cfg or {})},
                    {**SPECIAL_OPTIONS.get(payoff, {}), **(opt or {})},
                    extra))

    for name, po in sorted(PAYOFFS.items()):
        for m in modes:
            add(f"{name} euler {m}", name, m)
        for m in (modes[0], modes[3]):
            add(f"{name} euler {m} r20", name, dict(m, rng_source="threefry"))
        if po.terminal_only:
            for m in modes:
                add(f"{name} terminal {m}", name, dict(m, method="terminal"))
                add(f"{name} terminal {m} r20", name,
                    dict(m, method="terminal", rng_source="threefry"))
        for start, n_steps in ((50, 100), (51, 100), (50, 101), (51, 101)):
            add(f"{name} resumed at {start} of {n_steps}", name,
                dict(n_steps=n_steps, start_step=start), resume=())
        add(f"{name} resumed at 51 anti cv r20", name,
            dict(start_step=51, antithetic=True, with_cv=True,
                 rng_source="threefry"), resume=())
    for name in ("vanilla_call", "bullet_call", "asian_call", "up_out_call"):
        for m in modes:
            add(f"{name} euler IS {m}", name, dict(m, is_shift=1.5),
                dict(k=130.0))
            if name == "vanilla_call":
                add(f"{name} terminal IS {m}", name,
                    dict(m, method="terminal", is_shift=2.9), dict(k=180.0))
        for st in (0, 1, 2, 7, 33):
            if st:  # no theta at 0 steps
                add(f"{name} {st} steps IS anti", name,
                    dict(n_steps=st, is_shift=0.7, antithetic=True))
            for m in (modes[0], modes[3]):
                add(f"{name} {st} steps {m}", name, dict(m, n_steps=st))
        for n in (1, 255, 257):
            add(f"{name} {n} paths anti cv", name,
                dict(n_paths=n, antithetic=True, with_cv=True))
        add(f"{name} offset bound anti", name,
            dict(n_paths=50_001, antithetic=True),
            offset=(1 << 20) + 12_345, bound=(1 << 20) + 12_345 + 40_000)
        add(f"{name} bound past the end", name, dict(n_paths=5003),
            offset=7, bound=0xFFFFFFFF)
        add(f"{name} {GRID_PAST} paths", name,
            dict(n_paths=GRID_PAST, n_steps=4))
    for name in ("bullet_call", "up_out_call", "down_in_call",
                 "down_out_call"):
        for fix in (dict(barrier=0.0), dict(barrier=-0.0),
                    dict(barrier=-1.0), dict(barrier=inf), dict(barrier=-inf),
                    dict(barrier=nan), dict(s0=0.0), dict(s0=-0.0),
                    dict(s0=-50.0), dict(s0=-50.0, barrier=-60.0, k=-100.0),
                    dict(s0=inf), dict(s0=nan)):
            for m in (modes[0], modes[3]):
                add(f"{name} {fix} {m}", name, m, fix)
        for s_edge in ((0.0, -0.0, -50.0, inf, nan), (-0.0,), (-50.0,),
                       (nan,), (inf,)):
            for start in (50, 51):
                add(f"{name} resumed at {start} spots {s_edge}", name,
                    dict(start_step=start, antithetic=True), resume=s_edge)
            for fix in (dict(barrier=0.0), dict(barrier=inf),
                        dict(barrier=nan), dict(barrier=-60.0, k=-100.0)):
                add(f"{name} resumed at 51 spots {s_edge} {fix}", name,
                    dict(start_step=51), fix, resume=s_edge)
    return out


def simulate_inputs(payoff: str, cfg: dict, opt: dict, extra: dict, dev):
    """(KernelConfig, params, key, s_init, state block) of a simulate case."""
    from mc_tpu_torch import engines, rng
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.ops import path_kernels as pk

    kc = pk.KernelConfig(**cfg)
    prm = pk.pack_params(OptionParams(**opt), kc.n_steps, dev)
    key = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER))
    s_init = block = None
    if "resume" in extra:
        s, st = simulate_resume_state(payoff, kc.n_paths, kc.start_step,
                                      extra["resume"])
        s_init = torch.from_numpy(s).to(dev)
        if st:
            block = torch.from_numpy(np.stack(st)).contiguous().to(dev)
    return kc, prm, key, s_init, block


def run_simulate(lib, payoff: str, inputs, extra: dict, n_paths=None,
                 batch: int = 1):
    """(partials, ms) of ``batch`` back-to-back simulate calls through
    ``lib``'s entry point (ms: a call's share of the events' span)."""
    kc, prm, (k0, k1), s_init, block = inputs
    n = n_paths or kc.n_paths
    offset = extra.get("offset", 0)
    bound = extra.get("bound", offset + n)
    n_blocks = min(-(-n // simulate_block_paths(lib)), 8192)
    part = torch.empty((n_blocks, kc.n_moments), dtype=torch.float64,
                       device=prm.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (_payoff_id(payoff), kc.rng_rounds, int(kc.method == "euler"),
            int(kc.antithetic), int(kc.with_cv), k0, k1, prm.data_ptr(),
            kc.n_steps, kc.start_step, kc.is_shift, n, offset, bound,
            None if s_init is None else s_init.data_ptr(),
            None if block is None else block.data_ptr(), part.data_ptr(),
            kc.n_moments, n_blocks, stream)
    t = _events()
    for _ in range(batch):
        _check(lib.mc_simulate_partials(*args), "simulate_partials")
    t.append(_event())
    torch.cuda.synchronize()
    return part, t[0].elapsed_time(t[1]) / batch


def simulate_layout(lib) -> dict:
    """Blocks per SM of simulate_kernel for the bullet and the call under
    SIMULATE_MODES, and its paths a block."""
    out = {}
    blocks = ctypes.c_int(0)
    for name in ("bullet_call", "vanilla_call"):
        for euler, anti, cv in SIMULATE_MODES:
            st = lib.mc_simulate_occupancy(_payoff_id(name), euler, anti, cv,
                                           ctypes.byref(blocks))
            out[f"{name} euler={euler} anti={anti} cv={cv}"] = (
                blocks.value if st == 0 else None)
    out["paths a block"] = simulate_block_paths(lib)
    return out


def simulate_probe(args, bound, libs, card) -> dict:
    """--gbm's simulate_kernel half: resources and blocks per SM (the
    bullet's and the call's kernels; a tree's call is its TerminalOnly), the
    bitwise edges through every variant and (--time) the phase-5 rows in
    turns, each call's time a batch's share (the first call's span sizes a
    batch of >= 5 ms)."""
    dev = torch.device("cuda")
    report = {"variants": {}}
    want = re.compile(r"15simulate_kernelI.*NS_(10BulletCall|11VanillaCall|12TerminalOnly)E"
                      r".*Li13E")
    for label, (lib, _) in bound.items():
        lib_path, logs = libs[label]
        rows = kernel_rows(args, label, lib_path, logs, want, card)
        layout = simulate_layout(lib)
        print(f"probe {label}: simulate layout {layout} {card}", flush=True)
        report["variants"][label] = dict(kernels=rows, layout=layout)
    edges, bad = {}, 0
    for case, payoff, cfg, opt, extra in simulate_edge_cases(False):
        inputs = simulate_inputs(payoff, cfg, opt, extra, dev)
        ref = None
        for label, (lib, _) in bound.items():
            part, _ = run_simulate(lib, payoff, inputs, extra)
            ref = part if ref is None else ref
            same = same_bits(part, ref)
            edges.setdefault(case, {})[label] = same
            if not same:
                bad += 1
                print(f"FAIL: {case} {label} disagrees with "
                      f"{next(iter(bound))}", flush=True)
    print(f"probe simulate edges: {len(edges)} cases x {len(bound)} variants, "
          f"{bad} disagree {card}", flush=True)
    report["edges"] = edges
    if args.time:
        from mc_tpu_torch.ops import path_kernels as pk
        from mc_tpu_torch.ops.payoffs import get_payoff

        times = {}
        order = list(bound) + list(bound)[::-1]
        for case, payoff, cfg, opt, extra in simulate_edge_cases(True):
            inputs = simulate_inputs(payoff, cfg, opt, extra, dev)
            if "resume" in extra:  # the plain trajectories' states
                kc = inputs[0]
                s_g, c_g, _ = pk.simulate_trajectories_plain(
                    get_payoff(payoff), pk.KernelConfig(
                        n_paths=kc.n_paths, n_steps=kc.n_steps), inputs[2],
                    inputs[1])
                inputs = (*inputs[:3], s_g[kc.start_step - 1].contiguous(),
                          c_g[kc.start_step - 1][None].contiguous())
            ref = None
            for label in order:
                lib = bound[label][0]
                run_simulate(lib, payoff, inputs, extra, SIMULATE_WARM)
                part, first = run_simulate(lib, payoff, inputs, extra)
                batch = max(1, int(np.ceil(5.0 / max(first, 1e-3))))
                _, ms = run_simulate(lib, payoff, inputs, extra, batch=batch)
                ref = part if ref is None else ref
                same = same_bits(part, ref)
                times.setdefault(case, {}).setdefault(label, []).append(
                    dict(ms=ms, single_ms=first, batch=batch, bitwise=same))
                print(f"probe time {case} {cfg['n_paths']}x{cfg['n_steps']} "
                      f"{label}: {ms:.5f} ms a call in a batch of {batch} "
                      f"(one call alone {first:.5f}), partials bitwise vs "
                      f"{order[0]}: {same} {card}", flush=True)
                if not same:
                    print(f"FAIL: {case} {label} disagrees", flush=True)
        report["times"] = times
    return report


def libm_check(lib, dev) -> dict:
    """The library's mc_nmc_libm_check: the neighbouring finite floats whose
    expf are out of order, and the Box-Muller thetas where sincosf is not
    cosf and sinf bit for bit."""
    bad = torch.zeros(2, dtype=torch.int64, device=dev)
    _check(lib.mc_nmc_libm_check(bad.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream),
           "mc_nmc_libm_check")
    n_order, n_trig = (int(x) for x in bad.tolist())
    return {"expf out of order": n_order, "sincosf != cosf, sinf": n_trig}


def gbm_inputs(payoff: str, shape, dev):
    """(NMCConfig, params, outer and inner keys, s grid, state grid) of the
    demo option at ``shape``; the grids are the plain trajectories'."""
    from mc_tpu_torch import engines, rng
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.ops import nmc_kernels as nk
    from mc_tpu_torch.ops import path_kernels as pk
    from mc_tpu_torch.ops.payoffs import get_payoff

    n_out, n_steps, n_inner = shape
    cfg = nk.NMCConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
    prm = pk.pack_params(OptionParams(), n_steps, dev)
    keys = tuple(tuple(int(k) for k in rng.derive_key(1234, s))
                 for s in (engines.STREAM_OUTER, engines.STREAM_INNER))
    s_g, c_g, _ = pk.simulate_trajectories_plain(
        get_payoff(payoff), nk.outer_config(cfg), keys[0], prm)
    return cfg, prm, keys, s_g, c_g


def run_gbm(lib, legs, payoff: str, inputs):
    """(fused surface, outer partials, inner surface, fused ms, inner ms) of
    one call of each kernel through ``lib`` (``legs``: its legs a thread, or
    None before they were passed in)."""
    from mc_tpu_torch.ops import nmc_kernels as nk
    from mc_tpu_torch.ops.payoffs import get_payoff

    cfg, prm, ((ko0, ko1), (ki0, ki1)), s_g, c_g = inputs
    pid = get_payoff(payoff).cuda_id
    stream = torch.cuda.current_stream().cuda_stream
    tiles = -(-cfg.n_paths // lib.mc_nmc_block_threads())
    surf_f = torch.empty((cfg.n_steps, cfg.n_paths), dtype=torch.float32,
                         device=prm.device)
    surf_i = torch.empty_like(surf_f)
    outer = torch.empty((tiles, 2), dtype=torch.float64, device=prm.device)
    geo = () if legs is None else (nk.nmc_launch(cfg.n_inner, legs).groups,)
    point = (cfg.n_paths, 0, cfg.n_paths)
    t = _events()
    _check(lib.mc_nmc_fused(pid, 0, ko0, ko1, ki0, ki1, prm.data_ptr(),
                            cfg.n_steps, cfg.n_inner, *geo, *point,
                            surf_f.data_ptr(), outer.data_ptr(), stream),
           "nmc_fused")
    t.append(_event())
    _check(lib.mc_nmc_inner(pid, 0, ki0, ki1, prm.data_ptr(), cfg.n_steps,
                            cfg.n_inner, *geo, *point, s_g.data_ptr(),
                            c_g.data_ptr(), surf_i.data_ptr(), stream),
           "nmc_inner")
    t.append(_event())
    torch.cuda.synchronize()
    return (surf_f, outer, surf_i, t[0].elapsed_time(t[1]),
            t[1].elapsed_time(t[2]))


BOOK_MAIN = (64, 1 << 20, 100)  # contracts, paths, steps: chip_smoke's book64


def book_threads(cfg) -> int:
    from mc_tpu_torch.ops import path_kernels as pk

    return pk.book_block_threads(cfg)


def book_inputs(dev):
    """(KernelConfig, parameter rows) of chip_smoke.py's book64 bullet book:
    strikes U(80, 120) and vols U(0.1, 0.4) from default_rng(7), S0 = 100,
    T = 1, r = 0.1, B = 120, window [10, 50]."""
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.ops import path_kernels as pk

    b, n_paths, n_steps = BOOK_MAIN
    gen = np.random.default_rng(7)
    opt = OptionParams(
        s0=np.full(b, 100.0, np.float32), t=np.full(b, 1.0, np.float32),
        k=gen.uniform(80, 120, b).astype(np.float32),
        r=np.full(b, 0.1, np.float32),
        sigma=gen.uniform(0.1, 0.4, b).astype(np.float32),
        barrier=np.full(b, 120.0, np.float32),
        p1=np.full(b, 10.0, np.float32), p2=np.full(b, 50.0, np.float32),
        q=np.zeros(b, np.float32))
    cfg = pk.KernelConfig(n_paths=n_paths, n_steps=n_steps)
    return cfg, pk.pack_params_rows(opt, n_steps, dev)


def run_book(lib, inputs, payoff: str = "bullet_call"):
    """(partials, ms) of one book kernel call through ``lib``: paths 0 ..
    n_paths-1 of key (1234, 5678), every one valid."""
    from mc_tpu_torch.ops import path_kernels as pk
    from mc_tpu_torch.ops.payoffs import get_payoff

    cfg, rows = inputs
    threads = pk.book_block_threads(cfg)
    n_blocks = -(-cfg.n_paths // threads)
    part = torch.empty((n_blocks, rows.shape[0], cfg.n_moments),
                       dtype=torch.float64, device=rows.device)
    t = _events()
    _check(lib.mc_book_partials(
        get_payoff(payoff).cuda_id, int(cfg.method == "euler"),
        int(cfg.antithetic), int(cfg.with_cv), 1234, 5678,
        rows.data_ptr(), rows.shape[0], cfg.n_steps, cfg.n_paths, 0,
        cfg.n_paths, threads, part.data_ptr(), cfg.n_moments, n_blocks,
        torch.cuda.current_stream().cuda_stream), "book")
    t.append(_event())
    torch.cuda.synchronize()
    return part, t[0].elapsed_time(t[1])


BOOK_EDGE_PATHS = 4_099  # a ragged last block


def book_edge_cases(dev):
    """The book's bitwise edges: (label, payoff, (KernelConfig, rows)).
    Every payoff on 5 contracts (a ragged contract group), plain,
    antithetic and with the control variate, and the terminal draw; book64
    bullet on the main parameters with 1, 3, 63 and 300 contracts (more
    than a block's threads), 33 and 217 steps (a 128-thread block); the
    barrier books (bullet, up-and-out, down-and-in) with barriers 0, -1,
    +-inf and NaN, spots 0, -0, -50, +inf and NaN, sigma 0 and 1e19 (an
    infinite log-price) and an infinite drift."""
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.ops import path_kernels as pk
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    def book(n, at=None, **fix):
        """n contracts from default_rng(11), the fields of ``fix`` set on
        contracts ``at`` (default all)."""
        gen = np.random.default_rng(11)
        f = dict(s0=gen.uniform(80, 120, n), t=np.full(n, 1.0),
                 k=gen.uniform(80, 120, n), r=np.full(n, 0.05),
                 sigma=gen.uniform(0.1, 0.4, n),
                 barrier=gen.uniform(90, 130, n), p1=np.full(n, 10.0),
                 p2=np.full(n, 50.0), q=np.full(n, 0.01))
        for name, v in fix.items():
            f[name][slice(None) if at is None else list(at)] = v
        return OptionParams(**{k: v.astype(np.float32) for k, v in f.items()})

    special = {"variance_swap": dict(k=0.04),
               "forward_start_call": dict(k=1.0, p1=30.0),
               "cliquet": dict(k=10.0, p1=-0.05, p2=0.05)}
    out = []

    def add(label, payoff, opts, steps=100, n=BOOK_EDGE_PATHS, **kw):
        cfg = pk.KernelConfig(n_paths=n, n_steps=steps, **kw)
        out.append((label, payoff, (cfg, pk.pack_params_rows(opts, steps,
                                                              dev))))

    for name, po in sorted(PAYOFFS.items()):
        opts = book(5, **special.get(name, {}))
        for kw in (dict(), dict(antithetic=True), dict(with_cv=True),
                   dict(antithetic=True, with_cv=True)):
            add(f"book {name} 5 contracts {kw}", name, opts, **kw)
        if po.terminal_only:
            for anti in (False, True):
                add(f"book {name} terminal anti={anti}", name, opts,
                    method="terminal", antithetic=anti)
    main = book_inputs(dev)[1].cpu()
    for n in (1, 3, 63):
        out.append((f"book64 bullet first {n} contracts", "bullet_call",
                    (pk.KernelConfig(n_paths=BOOK_EDGE_PATHS, n_steps=100),
                     main[:n].contiguous().to(dev))))
    add("book bullet 300 contracts", "bullet_call", book(300))
    add("book bullet 300 contracts cv", "bullet_call", book(300),
        with_cv=True)
    for steps in (1, 2, 33, 217):
        add(f"book bullet 5 contracts {steps} steps anti", "bullet_call",
            book(5), steps=steps, antithetic=True)
        add(f"book asian 5 contracts {steps} steps", "asian_call", book(5),
            steps=steps)
    edges = [dict(barrier=0.0), dict(barrier=-1.0), dict(barrier=np.inf),
             dict(barrier=-np.inf), dict(barrier=np.nan), dict(s0=0.0),
             dict(s0=-0.0), dict(s0=-50.0), dict(s0=-50.0, barrier=-60.0),
             dict(s0=np.inf), dict(s0=np.nan), dict(sigma=0.0),
             dict(sigma=1e19), dict(r=1e38)]
    for name in ("bullet_call", "up_out_call", "down_in_call"):
        for fix in edges:
            for at in (None, (1, 4)):
                opts = book(5, at, **fix)
                add(f"book {name} {fix} on {at or 'all'}", name, opts)
                add(f"book {name} {fix} on {at or 'all'} anti cv", name,
                    opts, antithetic=True, with_cv=True)
    return out


def gbm_main(args, variants, card) -> dict:
    """The --gbm probe: resources, SASS and times of the GBM NMC kernels."""
    from mc_tpu_torch.ops.payoffs import get_payoff

    parts = set(args.kernels or GBM_PARTS)
    libs = build(variants, "gbm", tuple(parts))
    dev = torch.device("cuda")
    report = {"card": card, "variants": {}}
    bound = {}
    for label, src, defines in variants:
        lib_path, logs = libs[label]
        lib, legs = bind_gbm(lib_path)
        bound[label] = (lib, legs)
        if not {"nmc", "book"} & parts:
            continue
        res = {}
        for log in logs.values():
            res.update(ptxas_resources(log))
        entries = {(k, struct): qmc_entry(res, k, None, struct)
                   for k in GBM_KERNELS for _, struct in GBM_PAYOFFS}
        funcs = (sass_functions(lib_path, lambda f: f in entries.values())
                 if args.sass else {})
        rows = {}
        for name, struct in GBM_PAYOFFS:
            for kernel in GBM_KERNELS:
                e = entries[(kernel, struct)]
                r = dict(res.get(e, {}), legs=legs)
                blocks = ctypes.c_int(0)
                st = lib.probe_nmc_occupancy(
                    get_payoff(name).cuda_id, int(kernel == "nmc_fused_kernel"),
                    ctypes.byref(blocks))
                r["blocks_per_sm"] = blocks.value if st == 0 else None
                if args.sass and e in funcs:
                    n_ins, loops = sass_loops(lib_path, e, funcs[e])
                    r["sass"] = dict(instructions=n_ins, loops=loops,
                                     total=sass_classes(funcs[e]))
                rows[f"{kernel} {name}"] = r
                print(f"probe {label}: {kernel}<{struct}>: "
                      f"{ {k: v for k, v in r.items() if k != 'sass'} } "
                      f"{card}", flush=True)
                if "sass" in r:
                    print(f"  total {r['sass']['total']}")
                    for lp in r["sass"]["loops"]:
                        print(f"  loop {lp}")
                    write_listing(args.out, label, f"{kernel}.{name}", funcs[e])
        book_rows = {}
        book_cfg = book_inputs(torch.device("cpu"))[0]
        threads = book_threads(book_cfg)
        for e in sorted(x for x in res if re.search(
                r"11book_kernelINS_(10BulletCall|11VanillaCall)E", x)):
            r = dict(res[e])
            if args.sass:
                ins = sass_functions(lib_path, lambda f, e=e: f == e).get(e)
                if ins:
                    n_ins, loops = sass_loops(lib_path, e, ins)
                    r["sass"] = dict(instructions=n_ins, loops=loops,
                                     total=sass_classes(ins))
                    write_listing(args.out, label, e, ins)
            book_rows[e] = r
            print(f"probe {label}: {e}: "
                  f"{ {k: v for k, v in r.items() if k != 'sass'} } {card}",
                  flush=True)
            if "sass" in r:
                print(f"  total {r['sass']['total']}")
                for lp in r["sass"]["loops"]:
                    print(f"  loop {lp}")
        for name in ("bullet_call", "vanilla_call"):
            blocks = ctypes.c_int(0)
            st = lib.mc_book_occupancy(get_payoff(name).cuda_id, 1,
                                       book_cfg.n_steps, threads,
                                       ctypes.byref(blocks))
            book_rows[f"{name} blocks_per_sm"] = (blocks.value if st == 0
                                                  else None)
        print(f"probe {label}: book at {book_cfg.n_steps} steps, {threads} "
              f"threads: blocks/SM bullet "
              f"{book_rows['bullet_call blocks_per_sm']}, vanilla "
              f"{book_rows['vanilla_call blocks_per_sm']} {card}", flush=True)
        report["variants"][label] = dict(src=str(src), defines=defines,
                                         kernels=rows, book=book_rows,
                                         ptxas=logs)
    edges, bad = {}, 0
    for case, payoff, inputs in (book_edge_cases(dev) if "book" in parts
                                 else ()):
        ref = None
        for label in bound:
            part, _ = run_book(bound[label][0], inputs, payoff)
            ref = part if ref is None else ref
            same = same_bits(part, ref)
            edges.setdefault(case, {})[label] = same
            if not same:
                bad += 1
                print(f"FAIL: {case} {label} disagrees with "
                      f"{next(iter(bound))}", flush=True)
    if "book" in parts:
        print(f"probe book edges: {len(edges)} cases x {len(bound)} "
              f"variants, {bad} disagree {card}", flush=True)
    report["book_edges"] = edges
    if "simulate" in parts:
        report["simulate"] = simulate_probe(args, bound, libs, card)
    if "terminal_pair" in parts:
        report["terminal_pair"] = terminal_pair_probe(args, bound, libs, card)
    if "ladder" in parts:
        report["ladder"] = ladder_probe(args, bound, libs, card)
    checker = next((lib for lib, _ in bound.values()
                    if hasattr(lib, "mc_nmc_libm_check")), None)
    if checker is not None:
        report["libm"] = libm_check(checker, dev)
        print(f"probe libm, every finite float and Box-Muller theta: "
              f"{report['libm']} {card}", flush=True)
    if args.time:
        times = {}
        for name, _ in (GBM_PAYOFFS if "nmc" in parts else ()):
            warm = gbm_inputs(name, NMC_WARM, dev)
            main_in = gbm_inputs(name, NMC_MAIN, dev)
            ref = None
            order = list(bound) + list(bound)[::-1]
            for label in order:
                lib, legs = bound[label]
                run_gbm(lib, legs, name, warm)
                sf, outer, si, f_ms, i_ms = run_gbm(lib, legs, name, main_in)
                if ref is None:
                    ref = (sf, outer)
                same = bool(torch.equal(sf, ref[0]) and torch.equal(sf, si)
                            and torch.equal(outer, ref[1]))
                times.setdefault(name, {}).setdefault(label, []).append(
                    dict(fused_ms=f_ms, inner_ms=i_ms, bitwise=same))
                print(f"probe time {name} {label}: fused {f_ms:.3f} ms, "
                      f"inner {i_ms:.3f} ms, surface and outer moments "
                      f"bitwise vs {order[0]} and grid == fused: {same} "
                      f"{card}", flush=True)
                if not same:
                    print(f"FAIL: {name} {label} disagrees", flush=True)
        book, ref = (book_inputs(dev) if "book" in parts else None), None
        for label in (list(bound) + list(bound)[::-1]) if book else ():
            part, ms = run_book(bound[label][0], book)
            ref = part if ref is None else ref
            same = bool(torch.equal(part, ref))
            times.setdefault("book", {}).setdefault(label, []).append(
                dict(ms=ms, bitwise=same))
            print(f"probe time book bullet {'x'.join(map(str, BOOK_MAIN))} "
                  f"{label}: {ms:.3f} ms, partials bitwise vs the first: "
                  f"{same} {card}", flush=True)
            if not same:
                print(f"FAIL: book {label} disagrees", flush=True)
        report["times"] = times
    return report


# --- the terminal-pair kernel (#1, --gbm) ------------------------------------

TP_PAYOFFS = ("vanilla_call", "vanilla_put", "digital_call", "digital_put",
              "best_of_cash", "zcb")
TP_EDGE_ELEMS = (1, 255, 256, 257, 4_099, 1 << 23)
# chip_smoke.py's 1M-path call (500,000 elements) and 2^24 paths (the grid
# strides 4 rounds at the 8,192-block cap)
TP_TIMED = (1_000_000, 1 << 24)
# A call at 1M paths lasts ~7 us, of the order of a launch: its batches
# last >= 20 ms and the variants take 3 pairs of turns.
TP_BATCH_MS, TP_TURNS = 20.0, 3
# A path_kernels.cu that predates mc_terminal_pair_occupancy (256 elements
# a block, one a thread): this adds it, for VanillaCall at threefry-13.
TP_OCCUPANCY_SHIM = """
extern "C" int mc_terminal_pair_occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mc::terminal_pair_kernel<mc::VanillaCall, 13>, mc_block_threads(), 0);
}
"""


def terminal_pair_sources(src: Path, out: Path, srcs):
    """``srcs`` with TP_OCCUPANCY_SHIM added where ``src``'s
    ``path_kernels.cu`` does not export ``mc_terminal_pair_occupancy``: a
    unit including it takes its place (or, where a SIMULATE_SHIM unit
    includes it, that unit gets the addition)."""
    path = src / "path_kernels.cu"
    if "mc_terminal_pair_occupancy" in path.read_text():
        return srcs
    out_srcs = []
    for s in srcs:
        if s == path:
            s = out / "path_probe.cu"
            s.write_text(f'#include "{path}"\n' + TP_OCCUPANCY_SHIM)
        elif s.name == "simulate_probe.cu":
            s.write_text(s.read_text() + TP_OCCUPANCY_SHIM)
        out_srcs.append(s)
    return out_srcs


def tp_block_elems(lib) -> int:
    """Elements a block of terminal_pair_kernel (the parent's: its
    threads)."""
    fn = (getattr(lib, "mc_terminal_pair_block_elems", None)
          or lib.mc_block_threads)
    return fn()


def tp_cases(timed: bool):
    """terminal_pair_kernel's cases: (label, payoff, rounds, elements, paths,
    option fields).  Timed: the call at TP_TIMED paths.  Else each of the
    six terminal payoffs under threefry-13 and -20 at TP_EDGE_ELEMS
    elements with an even and an odd path count; s0 +-0, -50, +inf, NaN;
    sigma 0; a drift that overflows expf (r = 100); more paths than two
    an element (the wrapper refuses them; the entry point masks them)."""
    inf, nan = float("inf"), float("nan")
    if timed:
        return [(f"terminal_pair call {n} paths", "vanilla_call", 13,
                 (n + 1) // 2, n, {}) for n in TP_TIMED]
    out = []
    for name in TP_PAYOFFS:
        for rounds in (13, 20):
            for e in TP_EDGE_ELEMS:
                for total in (2 * e, 2 * e - 1):
                    out.append((f"terminal_pair {name} r{rounds} {e} elements "
                                f"{total} paths", name, rounds, e, total, {}))
            for fix in (dict(s0=0.0), dict(s0=-0.0), dict(s0=-50.0),
                        dict(s0=inf), dict(s0=nan), dict(sigma=0.0),
                        dict(r=100.0)):
                out.append((f"terminal_pair {name} r{rounds} {fix}", name,
                            rounds, 4_099, 8_197, fix))
            # a path count past two an element: the entry point's own mask
            out.append((f"terminal_pair {name} r{rounds} 257 elements "
                        f"1,514 paths", name, rounds, 257, 1_514, {}))
    return out


def run_terminal_pair(lib, payoff: str, rounds: int, n_elems: int,
                      total: int, prm, batch: int = 1):
    """(partials, ms) of ``batch`` back-to-back terminal_pair calls."""
    from mc_tpu_torch import engines, rng

    k0, k1 = (int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER))
    n_blocks = min(-(-n_elems // tp_block_elems(lib)), 8192)
    part = torch.empty((n_blocks, 2), dtype=torch.float64, device=prm.device)
    args = (_payoff_id(payoff), rounds, k0, k1, prm.data_ptr(), n_elems,
            total, part.data_ptr(), n_blocks,
            torch.cuda.current_stream().cuda_stream)
    t = _events()
    for _ in range(batch):
        _check(lib.mc_terminal_pair(*args), "terminal_pair")
    t.append(_event())
    torch.cuda.synchronize()
    return part, t[0].elapsed_time(t[1]) / batch


def terminal_pair_probe(args, bound, libs, card) -> dict:
    """--gbm's terminal_pair_kernel half: resources, blocks per SM and
    (--sass) the loops of its VanillaCall threefry-13 instantiation, the
    bitwise edges through every variant and (--time) the call at TP_TIMED
    paths in TP_TURNS pairs of turns, each call's time a batch's share
    (>= TP_BATCH_MS a batch)."""
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.ops import path_kernels as pk

    dev = torch.device("cuda")
    report = {"variants": {}}
    want = re.compile(r"20terminal_pair_kernelINS_11VanillaCallELi13E")
    for label, (lib, _) in bound.items():
        lib_path, logs = libs[label]
        rows = kernel_rows(args, label, lib_path, logs, want, card)
        blocks = ctypes.c_int(0)
        st = lib.mc_terminal_pair_occupancy(ctypes.byref(blocks))
        layout = dict(blocks_per_sm=blocks.value if st == 0 else None,
                      elements_a_block=tp_block_elems(lib))
        if hasattr(lib, "mc_terminal_pair_elems_per_thread"):
            layout["elements_a_thread"] = (
                lib.mc_terminal_pair_elems_per_thread())
        print(f"probe {label}: terminal_pair layout {layout} {card}",
              flush=True)
        report["variants"][label] = dict(kernels=rows, layout=layout)
    edges, bad = {}, 0
    for case, payoff, rounds, n_elems, total, fix in tp_cases(False):
        prm = pk.pack_params(OptionParams(**fix), 100, dev)
        ref = None
        for label, (lib, _) in bound.items():
            part, _ = run_terminal_pair(lib, payoff, rounds, n_elems, total,
                                        prm)
            ref = part if ref is None else ref
            same = same_bits(part, ref)
            edges.setdefault(case, {})[label] = same
            if not same:
                bad += 1
                print(f"FAIL: {case} {label} disagrees with "
                      f"{next(iter(bound))}", flush=True)
    print(f"probe terminal_pair edges: {len(edges)} cases x {len(bound)} "
          f"variants, {bad} disagree {card}", flush=True)
    report["edges"] = edges
    if args.time:
        prms = {}

        def run(label, a, batch, warm=False):
            if a["label"] not in prms:
                prms[a["label"]] = pk.pack_params(OptionParams(**a["fix"]),
                                                  100, dev)
            prm = prms[a["label"]]
            lib = bound[label][0]
            shape = (4096, 8192) if warm else (a["n_elems"], a["total"])
            part, ms = run_terminal_pair(lib, a["payoff"], a["rounds"], *shape,
                                         prm, batch=batch)
            return (part,), ms

        cases = [dict(label=case, payoff=payoff, rounds=rounds,
                      n_elems=n_elems, total=total, fix=fix)
                 for case, payoff, rounds, n_elems, total, fix
                 in tp_cases(True)]
        report["times"] = batched_turns(bound, cases, run, TP_BATCH_MS,
                                        TP_TURNS, card, "partials")
    return report


# --- the strike ladder (#6, --gbm --kernels ladder) ---------------------------

LADDER_STRIKES = (60.0, 140.0)  # chip_smoke.py's vol-surface row, M points
# The timed calls: the call by the terminal draw at 1M paths (the main path's
# price_ladder) at M = 1, 4, 17, 64 strikes, and the bullet by Euler at
# 16,384 and 1M paths x 100 steps at M = 17: (payoff, euler, paths, steps, M)
LADDER_TIMED = tuple(("vanilla_call", 0, 1_000_000, 100, m)
                     for m in (1, 4, 17, 64)) + tuple(
    ("bullet_call", 1, n, 100, 17) for n in (16_384, 1_000_000))
# The bitwise edges: M = 1, 3, 17, 64 and 67 (ragged passes at any pass size
# up to 64), n_paths 1, 255, 257 and 2^20 + 3, both modes (the terminal draw
# for the payoffs without state), antithetic and not, path_offset and bound
LADDER_EDGE_M = (1, 3, 17, 64, 67)
LADDER_EDGE_PATHS = (1, 255, 257, (1 << 20) + 3)
LADDER_EDGE_PAYOFFS = ("vanilla_call", "vanilla_put", "bullet_call",
                       "asian_call")
LADDER_EDGE_STEPS = 7  # odd: the Euler leg's last half-pair
LADDER_OFFSETS = ((1_000, 5_000, 1_000 + 4_321), ((1 << 32) - 300, 1_000,
                                                   None))
LADDER_BATCH_MS, LADDER_TURNS = 5.0, 3
# A batch_kernels.cu that predates mc_ladder_occupancy (ladder_kernel<P>, 256
# threads, one path each): this adds it to the unit that includes it.
LADDER_OCCUPANCY_SHIM = """
template <class P>
static int probe_ladder_occupancy(int* blocks) {{
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mc::ladder_kernel<P>,
                                                       mc::kLadderThreads, 0);
}}

extern "C" int mc_ladder_occupancy(int payoff_id, int euler, int* blocks) {{
  (void)euler;
  switch (payoff_id) {{
    case mc::PAYOFF_BULLET_CALL: return probe_ladder_occupancy<mc::BulletCall>(blocks);
    case mc::PAYOFF_VANILLA_CALL: return probe_ladder_occupancy<mc::VanillaCall>(blocks);
    default: return cudaErrorInvalidValue;
  }}
}}
"""


def ladder_sources(src: Path, out: Path, srcs):
    """``srcs`` with ``src``'s ``batch_kernels.cu`` (the ladder's): where
    the --gbm unit already includes it (nmc or book), that unit gets
    LADDER_OCCUPANCY_SHIM if the source lacks mc_ladder_occupancy; else a
    unit of its own includes it (with the shim where needed)."""
    path = src / "batch_kernels.cu"
    shim = ("" if "mc_ladder_occupancy" in path.read_text()
            else LADDER_OCCUPANCY_SHIM.format())
    unit = next((s for s in srcs if s.name == "nmc_probe.cu"), None)
    if unit is not None:
        unit.write_text(unit.read_text() + shim)
        return srcs
    unit = out / "ladder_probe.cu"
    unit.write_text(f'#include "{path}"\n' + shim)
    return [*srcs, unit]


def ladder_block_paths(lib) -> int:
    """Paths a block of ladder_kernel (the parent's: its threads, one path
    each)."""
    fn = (getattr(lib, "mc_ladder_block_paths", None)
          or lib.mc_ladder_block_threads)
    return fn()


def ladder_layout(lib) -> dict:
    """The ladder's paths a block and, where exported, its paths a thread by
    mode and strikes a pass, and its resident blocks per SM (the call by the
    terminal draw, the bullet by Euler)."""
    out = {"paths_a_block": ladder_block_paths(lib)}
    for name in ("mc_ladder_paths_per_thread",):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            out["paths_a_thread terminal"] = fn(0)
            out["paths_a_thread euler"] = fn(1)
    if hasattr(lib, "mc_ladder_strikes_per_pass"):
        out["strikes_a_pass terminal"] = lib.mc_ladder_strikes_per_pass(0)
        out["strikes_a_pass euler"] = lib.mc_ladder_strikes_per_pass(1)
    for payoff, euler in (("vanilla_call", 0), ("bullet_call", 1)):
        blocks = ctypes.c_int(0)
        st = lib.mc_ladder_occupancy(_payoff_id(payoff), euler,
                                     ctypes.byref(blocks))
        out[f"blocks_per_sm {payoff} {'euler' if euler else 'terminal'}"] = (
            blocks.value if st == 0 else None)
    return out


def ladder_cases(timed: bool):
    """The ladder's cases: dicts of label, payoff, euler, anti, n (paths),
    steps, m (strikes), offset, bound (None: the run's end).  Timed:
    LADDER_TIMED.  Else the edges of LADDER_EDGE_*: every payoff by Euler
    and the two without state by the terminal draw, antithetic and not, at
    every M and path count; the call and the bullet at LADDER_OFFSETS."""
    from mc_tpu_torch.ops.payoffs import get_payoff

    def case(payoff, euler, n, steps, m, anti=0, offset=0, bound=None):
        label = (f"ladder {payoff} {'euler' if euler else 'terminal'}"
                 f"{' anti' if anti else ''} {n}x{steps} M={m}"
                 + (f" offset {offset} bound {bound}" if offset or bound
                    else ""))
        return dict(label=label, payoff=payoff, euler=euler, anti=anti, n=n,
                    steps=steps, m=m, offset=offset, bound=bound)

    if timed:
        return [case(p, e, n, s, m) for p, e, n, s, m in LADDER_TIMED]
    out = []
    for payoff in LADDER_EDGE_PAYOFFS:
        modes = (1,) if get_payoff(payoff).n_state else (0, 1)
        for euler in modes:
            for anti in (0, 1):
                out += [case(payoff, euler, n, LADDER_EDGE_STEPS, m, anti)
                        for m in LADDER_EDGE_M for n in LADDER_EDGE_PATHS]
    for off, n, b in LADDER_OFFSETS:
        for payoff, euler in (("vanilla_call", 0), ("bullet_call", 1)):
            out += [case(payoff, euler, n, 16, m, anti, off, b)
                    for m in (1, 17) for anti in (0, 1)]
    return out


def ladder_inputs(a: dict, dev):
    """(params, strikes, key) of a ladder case: the demo option (the
    bullet's window reachable in the case's steps), M strikes evenly over
    LADDER_STRIKES, the outer key at seed 1234."""
    from mc_tpu_torch import engines, rng
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.ops import path_kernels as pk

    opt = (OptionParams(p1=1.0, p2=6.0) if a["steps"] < 50 else
           OptionParams())
    prm = pk.pack_params(opt, a["steps"], dev)
    strikes = torch.tensor(np.linspace(*LADDER_STRIKES, a["m"]),
                           dtype=torch.float32, device=dev)
    key = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER))
    return prm, strikes, key


def run_ladder(lib, a: dict, inputs, batch: int = 1, n=None):
    """(partials, ms) of ``batch`` back-to-back mc_ladder_partials calls of
    case ``a`` (``n``: its path count, or another)."""
    prm, strikes, (k0, k1) = inputs
    n = a["n"] if n is None else n
    bound = (a["offset"] + n if a["bound"] is None else a["bound"]) & 0xFFFFFFFF
    n_blocks = -(-n // ladder_block_paths(lib))
    part = torch.empty((n_blocks, a["m"], 2), dtype=torch.float64,
                       device=prm.device)
    args = (_payoff_id(a["payoff"]), a["euler"], a["anti"], k0, k1,
            prm.data_ptr(), strikes.data_ptr(), a["m"], a["steps"], n,
            a["offset"] & 0xFFFFFFFF, bound, part.data_ptr(), n_blocks,
            torch.cuda.current_stream().cuda_stream)
    t = _events()
    for _ in range(batch):
        _check(lib.mc_ladder_partials(*args), "ladder")
    t.append(_event())
    torch.cuda.synchronize()
    return part, t[0].elapsed_time(t[1]) / batch


def ladder_probe(args, bound, libs, card) -> dict:
    """--gbm's ladder half: resources and (--sass) loops of its VanillaCall
    and BulletCall instantiations, its layout, the bitwise edges through
    every variant (rows bitwise against the first variant's: both keep the
    one-path-a-thread block tree's order) and (--time) LADDER_TIMED in
    LADDER_TURNS pairs of turns, each call's time a batch's share (>=
    LADDER_BATCH_MS a batch), beside chip_smoke.py's bound."""
    from mc_tpu_torch.ops import _cuda

    dev = torch.device("cuda")
    report = {"variants": {}}
    want = re.compile(r"13ladder_kernelINS_(11VanillaCall|10BulletCall)E")
    for label, (lib, _) in bound.items():
        for name in ("mc_ladder_block_paths", "mc_ladder_block_threads"):
            if hasattr(lib, name):
                getattr(lib, name).argtypes, getattr(lib, name).restype = (
                    [], _int)
        for name in ("mc_ladder_paths_per_thread",
                     "mc_ladder_strikes_per_pass"):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = [_int]
                getattr(lib, name).restype = _int
        lib.mc_ladder_occupancy.argtypes = [_int, _int,
                                            ctypes.POINTER(ctypes.c_int)]
        lib.mc_ladder_occupancy.restype = _int
        lib.mc_ladder_partials.argtypes, lib.mc_ladder_partials.restype = (
            _cuda._SIGNATURES["mc_ladder_partials"])
        lib_path, logs = libs[label]
        rows = kernel_rows(args, label, lib_path, logs, want, card)
        layout = ladder_layout(lib)
        print(f"probe {label}: ladder layout {layout} {card}", flush=True)
        report["variants"][label] = dict(kernels=rows, layout=layout)
    edges, bad = {}, 0
    for a in ladder_cases(False):
        inputs = ladder_inputs(a, dev)
        ref = None
        for label, (lib, _) in bound.items():
            part, _ = run_ladder(lib, a, inputs)
            ref = part if ref is None else ref
            same = same_bits(part, ref)
            edges.setdefault(a["label"], {})[label] = same
            if not same:
                bad += 1
                print(f"FAIL: {a['label']} {label} disagrees with "
                      f"{next(iter(bound))}", flush=True)
    print(f"probe ladder edges: {len(edges)} cases x {len(bound)} variants, "
          f"{bad} disagree {card}", flush=True)
    report["edges"] = edges
    if args.time:
        cache = {}

        def run(label, a, batch, warm=False):
            if a["label"] not in cache:
                cache.clear()
                cache[a["label"]] = ladder_inputs(a, dev)
            part, ms = run_ladder(bound[label][0], a, cache[a["label"]],
                                  batch, 4096 if warm else None)
            return (part,), ms

        cases = ladder_cases(True)
        times = batched_turns(bound, cases, run, LADDER_BATCH_MS,
                              LADDER_TURNS, card, "partials")
        bounds = {}
        for a in cases:
            b_ms, by = bound_of("ladder", payoff=a["payoff"],
                                euler=a["euler"], n_paths=a["n"],
                                n_steps=a["steps"], n_strikes=a["m"])
            bounds[a["label"]] = (b_ms, by)
            med = {label: float(np.median([r["ms"] for r in rows]))
                   for label, rows in times[a["label"]].items()}
            print(f"probe bound {a['label']}: {b_ms:.5f} ms ({by}); share "
                  + ", ".join(f"{k} {b_ms / v:.1%}" for k, v in med.items())
                  + f" {card}", flush=True)
        report["times"] = times
        report["bounds"] = bounds
    return report


# --- the FX and rainbow kernels (--fx) ----------------------------------------

FX_TIMED_CONTRACTS = ("quanto_call", "gk_call", "compo_call")
FX_TIMED = (1_000_000, 1 << 24)   # chip_smoke.py's FAMILY_MAIN and 2^24
FX_EDGE_PATHS = (1, 255, 256, 257, 100_001, 1 << 24)
# (path_offset, n_paths, bound or None for the run's end): a block cut by
# the offset and the bound; ids that wrap past 2^32, masked at the run's
# wrapped end and at a bound before the wrap
FX_OFFSETS = ((1_000, 5_000, 1_000 + 4_321), ((1 << 32) - 300, 1_000, None),
              ((1 << 32) - 300, 1_000, (1 << 32) - 1))
# (option fields, FX fields) of the degenerate cases, at FX_EDGE_FIX_PATHS
FX_EDGE_FIX = tuple(
    [({}, dict(rho=v)) for v in (1.0, -1.0, 0.0)]
    + [(dict(sigma=0.0), {}), ({}, dict(sigma_x=0.0))]
    + [(dict(s0=v), {}) for v in (0.0, -0.0, float("inf"), float("nan"))]
    + [({}, dict(x0=v)) for v in (0.0, -0.0, float("inf"), float("nan"))]
    + [({}, dict(r_f=100.0)), (dict(r=100.0), {})])  # drifts past expf's range
FX_EDGE_FIX_PATHS = 4_099
# #27 at chip_smoke.py's FAMILY_MAIN paths, threefry-13: (payoff, d,
# antithetic): the best-of call about every capacity, its antithetic leg at
# d = 4, the d = 2 exchange and worst-of call antithetic (price_rainbow's
# Margrabe and Stulz gates), every other payoff at d = 4
RAINBOW_MAIN = 1_000_000
RAINBOW_TIMED = tuple(
    [("call_on_max", d, False) for d in (1, 2, 4, 5, 8, 9, 16, 32)]
    + [("call_on_max", 4, True), ("exchange", 2, True), ("call_on_min", 2, True)]
    + [(name, 4, False) for name in ("call_on_min", "put_on_max", "put_on_min",
                                     "exchange", "best_of_cash")])
# #27's bitwise edges: every payoff at the d about each capacity (at
# RAINBOW_EDGE_N paths), ragged path counts past the capped grid, FX_OFFSETS'
# offsets and bounds, and an s0, a drift or a Cholesky entry of +-inf or NaN
RAINBOW_EDGE_D = (1, 2, 3, 4, 5, 8, 9, 16, 17, 32)
RAINBOW_EDGE_N = 4_099
RAINBOW_EDGE_PATHS = (1, 255, 256, 257, 100_001, (1 << 21) + 3)
RAINBOW_PATHS_D = (2, 4, 9, 32)
RAINBOW_FIX_VALUES = (float("inf"), float("-inf"), float("nan"))
# A call lasts ~0.01 ms at 1M paths, of the order of a launch: its batches
# last >= 20 ms and the variants take 3 pairs of turns (as --gbm's #1).
FX_BATCH_MS, FX_TURNS = 20.0, 3
# An fx_kernels.cu that predates mc_fx_occupancy (one path a thread, the
# contract a runtime argument): this unit adds it (threefry-13, every
# contract the one kernel).
FX_SHIM = """#include "{src}/fx_kernels.cu"

extern "C" int mc_fx_occupancy(int contract, int* blocks) {{
  (void)contract;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mc::fx_partials_kernel<13>, mc_fx_block_threads(), 0);
}}
"""
# The rainbow kernel (#27) of a csrc that predates mc_rainbow_occupancy
# (capacities 8 and 32, one path a thread, the antithetic leg a runtime
# flag): this unit adds its resident blocks per SM (threefry-13, the
# capacity of d).
RAINBOW_SHIM = """#include "{src}/rainbow_kernels.cu"

extern "C" int mc_rainbow_occupancy(int d, int antithetic, int* blocks) {{
  (void)antithetic;
  const int threads = mc_rainbow_block_threads();
  return d <= 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, mc::rainbow_partials_kernel<8, 13>, threads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, mc::rainbow_partials_kernel<32, 13>, threads, 0);
}}
"""
FX_PARTS = ("fx", "rainbow")


def fx_sources(src: Path, out: Path, kernels=FX_PARTS):
    """``src``'s fx_kernels.cu (through FX_SHIM where it has no
    ``mc_fx_occupancy``) and its rainbow sources (rainbow_kernels.cu and
    rainbow32_kernels.cu; through RAINBOW_SHIM where it has
    no ``mc_rainbow_occupancy``), those of ``kernels``."""
    srcs = []
    fx = src / "fx_kernels.cu"
    if "fx" not in kernels:
        pass
    elif "mc_fx_occupancy" in fx.read_text():
        srcs.append(fx)
    else:
        unit = out / "fx_probe.cu"
        unit.write_text(FX_SHIM.format(src=src))
        srcs.append(unit)
    if "rainbow" not in kernels:
        return srcs
    if "mc_rainbow_occupancy" in (src / "rainbow_kernels.cu").read_text():
        return [*srcs, *(q for q in sorted(src.glob("rainbow*_kernels.cu"))
                         if "_nmc" not in q.name)]
    unit = out / "rainbow_probe.cu"
    unit.write_text(RAINBOW_SHIM.format(src=src))
    return [*srcs, unit]


def bind_fx(lib_path: Path):
    """The FX and rainbow entry points of a variant's library (those it
    has), its FX paths a block (``mc_fx_block_paths``; the parent's: its
    threads, one path each) and its rainbow paths a block
    (``mc_rainbow_block_paths``; the parent's: its threads)."""
    from mc_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    for name in ("mc_fx_partials", "mc_rainbow_partials"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes, getattr(lib, name).restype = \
                _cuda._SIGNATURES[name]
    if hasattr(lib, "mc_fx_occupancy"):
        lib.mc_fx_occupancy.argtypes = [_int, ctypes.POINTER(ctypes.c_int)]
        lib.mc_fx_occupancy.restype = _int
    if hasattr(lib, "mc_rainbow_occupancy"):
        lib.mc_rainbow_occupancy.argtypes = [_int, _int,
                                             ctypes.POINTER(ctypes.c_int)]
        lib.mc_rainbow_occupancy.restype = _int
    tile = (lib.mc_fx_block_paths() if hasattr(lib, "mc_fx_block_paths")
            else lib.mc_fx_block_threads() if hasattr(lib, "mc_fx_block_threads")
            else None)
    rtile = (lib.mc_rainbow_block_paths()
             if hasattr(lib, "mc_rainbow_block_paths")
             else lib.mc_rainbow_block_threads()
             if hasattr(lib, "mc_rainbow_block_threads") else None)
    return lib, (tile, rtile)


def fx_layout(lib, tiles) -> dict:
    """Each contract's resident blocks per SM (threefry-13), the paths a
    block and a thread (where exported); the rainbow's paths a block, and
    at each capacity's edge d its paths a thread (where exported; else 1)
    and resident blocks per SM, plain and antithetic."""
    out = {}
    if tiles[0] is not None:
        from mc_tpu_torch.models.fx import FX_CONTRACTS

        out["paths_a_block"] = tiles[0]
        if hasattr(lib, "mc_fx_paths_per_thread"):
            out["paths_a_thread"] = lib.mc_fx_paths_per_thread()
        for name, cid in FX_CONTRACTS.items():
            blocks = ctypes.c_int(0)
            st = lib.mc_fx_occupancy(cid, ctypes.byref(blocks))
            out[f"blocks_per_sm {name}"] = blocks.value if st == 0 else None
    if tiles[1] is not None:
        out["rainbow paths_a_block"] = tiles[1]
        for d in (1, 2, 4, 5, 8, 9, 16, 17, 32):
            row = dict(
                paths_a_thread=(lib.mc_rainbow_paths_per_thread(d)
                                if hasattr(lib, "mc_rainbow_paths_per_thread")
                                else 1))
            for anti in (0, 1):
                blocks = ctypes.c_int(0)
                st = lib.mc_rainbow_occupancy(d, anti, ctypes.byref(blocks))
                row[f"blocks_per_sm anti={anti}"] = (blocks.value if st == 0
                                                     else None)
            out[f"rainbow d={d}"] = row
    return out


def fx_cases(timed: bool):
    """#28's cases: dicts of contract, rounds, n (paths), offset, bound
    (None: the run's end), opt and fx (fields over OptionParams() and
    DEMO_FX).  Timed: FX_TIMED_CONTRACTS at FX_TIMED paths, threefry-13.
    Else every contract under threefry-13 and -20 at FX_EDGE_PATHS paths,
    at FX_OFFSETS and at FX_EDGE_FIX."""
    from mc_tpu_torch.models.fx import FX_CONTRACTS

    def case(contract, rounds, n, offset=0, bound=None, opt=None, fx=None):
        label = (f"fx {contract} r{rounds} {n} paths"
                 + (f" offset {offset} bound {bound}" if offset or bound
                    else "") + (f" {opt}" if opt else "")
                 + (f" {fx}" if fx else ""))
        return dict(label=label, contract=contract, rounds=rounds, n=n,
                    offset=offset, bound=bound, opt=opt or {}, fx=fx or {})

    if timed:
        return [case(c, 13, n) for c in FX_TIMED_CONTRACTS for n in FX_TIMED]
    out = []
    for contract in FX_CONTRACTS:
        for rounds in (13, 20):
            out += [case(contract, rounds, n) for n in FX_EDGE_PATHS]
            out += [case(contract, rounds, n, off, b)
                    for off, n, b in FX_OFFSETS]
            out += [case(contract, rounds, FX_EDGE_FIX_PATHS, opt=o, fx=f)
                    for o, f in FX_EDGE_FIX]
    return out


def fx_inputs(a: dict, dev):
    """(params, key) of an FX case: pack_fx of its fields, price_fx's key at
    seed 1234."""
    from mc_tpu_torch import engines, rng
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.models import fx as fxm

    prm = fxm.pack_fx(OptionParams(**a["opt"]),
                      dataclasses.replace(fxm.DEMO_FX, **a["fx"]), dev)
    key = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER,
                                                fxm.FX_TAG))
    return prm, key


def run_fx(lib, tile: int, a: dict, inputs, batch: int = 1, n=None):
    """(partials, ms) of ``batch`` back-to-back fx_partials calls of case
    ``a`` (``n``: its path count, or another)."""
    from mc_tpu_torch.models.fx import FX_CONTRACTS

    prm, (k0, k1) = inputs
    n = a["n"] if n is None else n
    bound = (a["offset"] + n if a["bound"] is None else a["bound"]) & 0xFFFFFFFF
    n_blocks = min(-(-n // tile), 8192)
    part = torch.empty((n_blocks, 2), dtype=torch.float64, device=prm.device)
    args = (FX_CONTRACTS[a["contract"]], a["rounds"], k0, k1, prm.data_ptr(),
            n, a["offset"] & 0xFFFFFFFF, bound, part.data_ptr(), n_blocks,
            torch.cuda.current_stream().cuda_stream)
    t = _events()
    for _ in range(batch):
        _check(lib.mc_fx_partials(*args), "fx_partials")
    t.append(_event())
    torch.cuda.synchronize()
    return part, t[0].elapsed_time(t[1]) / batch


def rainbow_fix_entries(d: int):
    """The pack entries an edge case sets to +-inf or NaN (pack_basket's
    layout): asset 1's s0, asset 2's drift, L[2][1] and, at d = 32, L[20][13]
    (in the third block of 8 rows)."""
    from mc_tpu_torch.models.basket import packed_length

    head, chol = 10, 10 + 3 * d
    out = [head + 1, head + 2 * d + 2, chol + 3 + 1]
    if d == 32:
        out.append(chol + 20 * 21 // 2 + 13)
    assert max(out) < packed_length(d)
    return tuple(out)


def rainbow_cases(timed: bool):
    """#27's cases: dicts of payoff, d, anti, rounds, n (paths), offset,
    bound (None: the run's end) and fix ((pack index, value), ...).  Timed:
    RAINBOW_TIMED at RAINBOW_MAIN paths.  Else every payoff, plain and
    antithetic, under threefry-13 and -20, at RAINBOW_EDGE_D (the exchange
    from d = 2); RAINBOW_EDGE_PATHS at RAINBOW_PATHS_D; FX_OFFSETS at d = 4
    and 32; and the non-finite entries of rainbow_fix_entries."""
    from mc_tpu_torch.models.rainbow import RAINBOW_PAYOFFS

    def case(payoff, d, anti=False, rounds=13, n=RAINBOW_EDGE_N, offset=0,
             bound=None, fix=()):
        label = (f"rainbow {payoff} d={d} anti={int(anti)} r{rounds} {n} paths"
                 + (f" offset {offset} bound {bound}" if offset or bound
                    else "") + (f" fix {fix}" if fix else ""))
        return dict(label=label, contract="rainbow", payoff=payoff, d=d,
                    anti=anti, rounds=rounds, n=n, offset=offset, bound=bound,
                    fix=fix)

    if timed:
        return [case(p, d, a, n=RAINBOW_MAIN) for p, d, a in RAINBOW_TIMED]
    out = []
    for payoff, (_, min_d) in RAINBOW_PAYOFFS.items():
        for anti in (False, True):
            for rounds in (13, 20):
                out += [case(payoff, d, anti, rounds) for d in RAINBOW_EDGE_D
                        if d >= min_d]
    for anti in (False, True):
        for d in RAINBOW_PATHS_D:
            out += [case("call_on_max", d, anti, n=n)
                    for n in RAINBOW_EDGE_PATHS]
        for d in (4, 32):
            out += [case("put_on_min", d, anti, n=n, offset=off, bound=b)
                    for off, n, b in FX_OFFSETS]
    for d in (4, 9, 32):
        payoffs = RAINBOW_PAYOFFS if d == 4 else ("call_on_max", "put_on_min")
        for payoff in payoffs:
            for anti in (False, True):
                out += [case(payoff, d, anti, fix=((i, v),))
                        for i in rainbow_fix_entries(d)
                        for v in RAINBOW_FIX_VALUES]
    return out


def rainbow_inputs(a: dict, dev):
    """(params, key) of a rainbow case: pack_basket at n_steps = 1 of
    OptionParams() and demo_basket(d, 0.5), its fix entries set;
    price_rainbow's key at seed 1234."""
    from mc_tpu_torch import engines, rng
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.models import basket as bm
    from mc_tpu_torch.models.rainbow import RAINBOW_TAG

    prm = bm.pack_basket(OptionParams(), bm.demo_basket(a["d"], 0.5), 1, dev)
    for i, v in a["fix"]:
        prm[i] = v
    key = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER,
                                                RAINBOW_TAG))
    return prm, key


def run_rainbow(lib, tile: int, a: dict, inputs, batch: int = 1, n=None):
    """(partials, ms) of ``batch`` back-to-back rainbow_partials calls (#27)
    of case ``a`` (``n``: its path count, or another)."""
    from mc_tpu_torch.models.rainbow import RAINBOW_PAYOFFS

    prm, (k0, k1) = inputs
    n = a["n"] if n is None else n
    bound = (a["offset"] + n if a["bound"] is None else a["bound"]) & 0xFFFFFFFF
    n_blocks = min(-(-n // tile), 8192)
    part = torch.empty((n_blocks, 2), dtype=torch.float64, device=prm.device)
    args = (RAINBOW_PAYOFFS[a["payoff"]][0], a["rounds"], int(a["anti"]), k0,
            k1, prm.data_ptr(), a["d"], n, a["offset"] & 0xFFFFFFFF, bound,
            part.data_ptr(), n_blocks, torch.cuda.current_stream().cuda_stream)
    t = _events()
    for _ in range(batch):
        _check(lib.mc_rainbow_partials(*args), "rainbow_partials")
    t.append(_event())
    torch.cuda.synchronize()
    return part, t[0].elapsed_time(t[1]) / batch


def batched_turns(bound, cases, run, batch_ms: float, turns: int, card,
                  what: str) -> dict:
    """Each case through every variant in ``turns`` pairs of turns (A B ..
    B A), each call's time a batch's share (the batch sized from one call
    alone to last >= batch_ms), its result bitwise against the first
    variant's: {case: {label: [{ms, single_ms, batch, bitwise}]}}.
    ``run(label, case, batch)`` -> (result tensors, ms); ``case`` has a
    "label"."""
    times = {}
    order = (list(bound) + list(bound)[::-1]) * turns
    for a in cases:
        ref = None
        for label in order:
            run(label, a, 1, warm=True)
            out, first = run(label, a, 1)
            batch = max(1, int(np.ceil(batch_ms / max(first, 1e-3))))
            _, ms = run(label, a, batch)
            ref = out if ref is None else ref
            same = all(same_bits(x, y) for x, y in zip(out, ref))
            times.setdefault(a["label"], {}).setdefault(label, []).append(
                dict(ms=ms, single_ms=first, batch=batch, bitwise=same))
            print(f"probe time {a['label']} {label}: {ms:.5f} ms a call in a "
                  f"batch of {batch} (one call alone {first:.5f}), {what} "
                  f"bitwise vs {order[0]}: {same} {card}", flush=True)
            if not same:
                print(f"FAIL: {a['label']} {label} disagrees", flush=True)
    for case, by in times.items():
        med = {label: float(np.median([r["ms"] for r in rows]))
               for label, rows in by.items()}
        print(f"probe time {case} medians: "
              + ", ".join(f"{k} {v:.5f} ms" for k, v in med.items())
              + f" {card}", flush=True)
    return times


def bound_of(row: str, **kw):
    """chip_smoke.py's (bound_ms, bound_by) of ``row`` (its counts, the
    card's published rates)."""
    import chip_smoke as cs

    return cs.probe_bound(row, **kw)


def kernel_rows(args, label: str, lib_path: Path, logs: dict, want, card):
    """The ptxas resources of the entries matching ``want`` (and, with
    --sass, their loops, instructions by class and MUFU kinds, the listing
    written beside --out), printed: {entry: row}."""
    res = {}
    for log in logs.values():
        res.update(ptxas_resources(log))
    entries = sorted(e for e in res if want.search(e))
    funcs = (sass_functions(lib_path, lambda f: f in entries)
             if args.sass else {})
    rows = {}
    for e in entries:
        r = dict(res[e])
        if args.sass and e in funcs:
            n_ins, loops = sass_loops(lib_path, e, funcs[e])
            for lp in loops:
                lp["mufu"] = mufu_kinds(funcs[e], lp)
            r["sass"] = dict(instructions=n_ins, loops=loops,
                             total=sass_classes(funcs[e]))
            write_listing(args.out, label, e, funcs[e])
        rows[e] = r
        print(f"probe {label}: {e}: "
              f"{ {k: v for k, v in r.items() if k != 'sass'} } {card}",
              flush=True)
        if "sass" in r:
            print(f"  total {r['sass']['total']}")
            for lp in r["sass"]["loops"]:
                print(f"  loop {lp}")
    return rows


def fx_main(args, variants, card) -> dict:
    """The --fx probe: resources, SASS, the bitwise edges and the times of
    the FX kernel (#28) and the rainbow kernel (#27), those of
    ``--kernels`` (fx, rainbow; both by default)."""
    parts = args.kernels or FX_PARTS
    libs = build(variants, "fx", parts)
    dev = torch.device("cuda")
    report = {"card": card, "variants": {}}
    bound = {}
    want = re.compile(r"(18fx_partials_kernel|23rainbow_partials_kernelILi\d+"
                      r"ELi13E)")
    for label, src, defines in variants:
        lib_path, logs = libs[label]
        lib, tiles = bind_fx(lib_path)
        bound[label] = (lib, tiles)
        rows = kernel_rows(args, label, lib_path, logs, want, card)
        layout = fx_layout(lib, tiles)
        print(f"probe {label}: fx layout {layout} {card}", flush=True)
        report["variants"][label] = dict(src=str(src), defines=defines,
                                         kernels=rows, layout=layout)
    cases = {"edges": [], "times": []}
    if "fx" in parts:
        cases["edges"] += fx_cases(False)
        cases["times"] += fx_cases(True)
    if "rainbow" in parts:
        cases["edges"] += rainbow_cases(False)
        cases["times"] += rainbow_cases(True)

    def inputs_of(a):
        return (rainbow_inputs(a, dev) if a["contract"] == "rainbow"
                else fx_inputs(a, dev))

    def run(label, a, inputs, batch=1, n=None):
        lib, (tile, rtile) = bound[label]
        if a["contract"] == "rainbow":
            return run_rainbow(lib, rtile, a, inputs, batch, n)
        return run_fx(lib, tile, a, inputs, batch, n)

    edges, bad = {}, 0
    for a in cases["edges"]:
        inputs = inputs_of(a)
        ref = None
        for label in bound:
            part, _ = run(label, a, inputs)
            ref = part if ref is None else ref
            same = same_bits(part, ref)
            edges.setdefault(a["label"], {})[label] = same
            if not same:
                bad += 1
                print(f"FAIL: {a['label']} {label} disagrees with "
                      f"{next(iter(bound))}", flush=True)
    print(f"probe fx edges: {len(edges)} cases x {len(bound)} variants, "
          f"{bad} disagree {card}", flush=True)
    report["edges"] = edges
    if args.time:
        cache = {}

        def timed(label, a, batch, warm=False):
            if a["label"] not in cache:
                cache[a["label"]] = inputs_of(a)
            part, ms = run(label, a, cache[a["label"]], batch,
                           4096 if warm else None)
            return (part,), ms

        times = batched_turns(bound, cases["times"], timed, FX_BATCH_MS,
                              FX_TURNS, card, "partials")
        bounds = {a["label"]: (bound_of("rainbow_partials", d=a["d"],
                                        n_paths=a["n"], antithetic=a["anti"])
                               if a["contract"] == "rainbow" else
                               bound_of("fx_partials", contract=a["contract"],
                                        n_paths=a["n"]))
                  for a in cases["times"]}
        for case, (b_ms, by) in bounds.items():
            med = {label: float(np.median([r["ms"] for r in rows]))
                   for label, rows in times[case].items()}
            print(f"probe bound {case}: {b_ms:.5f} ms ({by}); share "
                  + ", ".join(f"{k} {b_ms / v:.1%}" for k, v in med.items())
                  + f" {card}", flush=True)
        report["times"] = times
        report["bounds"] = bounds
    return report


# --- the family trajectories kernel (--trajectories) -------------------------

# The instantiations of family_trajectories_kernel (family.cuh): (label,
# family, d or None, device struct, source).  The basket and the rainbow at
# each capacity's timed d (the demo's 4 at capacity 8, the full 32 at 32).
TRAJ_INSTANCES = (
    ("heston", "heston", None, "HestonFamily", "family_nmc_kernels.cu"),
    ("merton", "merton", None, "MertonFamily", "merton_nmc_kernels.cu"),
    ("localvol", "localvol", None, "LocalVolFamily",
     "localvol_nmc_kernels.cu"),
    ("vasicek", "vasicek", None, "VasicekFamily", "vasicek_nmc_kernels.cu"),
    ("cev", "cev", None, "CEVFamily", "cev_nmc_kernels.cu"),
    ("sabr", "sabr", None, "SABRFamily", "sabr_nmc_kernels.cu"),
    ("term", "term", None, "TermFamily", "term_nmc_kernels.cu"),
    ("bates", "bates", None, "BatesFamily", "bates_nmc_kernels.cu"),
    ("basket8", "basket", 4, "BasketFamily<8>", "basket_nmc_kernels.cu"),
    ("basket32", "basket", 32, "BasketFamily<32>", "basket_nmc32_kernels.cu"),
    ("rainbow8", "rainbow", 4, "RainbowFamily<8>", "rainbow_nmc_kernels.cu"),
    ("rainbow32", "rainbow", 32, "RainbowFamily<32>",
     "rainbow_nmc32_kernels.cu"))
# (paths, steps) timed: chip_smoke.py's NMC_MAIN outer grid, NMC_SMALL's and
# nmc --model's 2,048 outer paths at 16 and 100 steps, grids of 157, 258 and
# 391 blocks of 128 paths (1.2, 2 and 3 an SM: where the draw warps stop
# paying) and one that fills the card (782 blocks, SimParams' default)
TRAJ_TIMED = ((16_384, 100), (2_048, 16), (2_048, 100), (20_000, 100),
              (33_000, 100), (50_000, 100), (100_000, 100))
TRAJ_PAYOFFS = ("vanilla_call", "bullet_call")
# The bitwise edges: every instantiation's call and bullet at TRAJ_EDGE_STEPS
# x TRAJ_EDGE_PATHS (a ragged last draw chunk and an odd last step pair among
# them), every one-word payoff on Merton and the basket, the basket and the
# rainbow at TRAJ_EDGE_D (both folds), 1,000 paths on a grid capped at 3
# blocks (grid-stride rounds), FX_OFFSETS' offsets and bounds (ids past
# 2^32, a bound below the run's end), the last packed field at +-inf and NaN
TRAJ_EDGE_STEPS = (1, 2, 3, 16, 100, 217)
TRAJ_EDGE_PATHS = (1, 127, 128, 129, 2_048, 16_385)
TRAJ_EDGE_D = (1, 3, 8, 9, 32)
TRAJ_CAPPED = (1_000, 3)  # paths, blocks
TRAJ_FIX_VALUES = (float("inf"), float("-inf"), float("nan"))
TRAJ_BATCH_MS, TRAJ_TURNS = 5.0, 3
# A family NMC source whose family_nmc_kernels.cu predates
# mc_family_trajectories_occupancy (one path a thread, 128 threads a block):
# this unit adds the resident blocks per SM of its trajectories kernel for
# each one-word payoff.
TRAJ_SHIM = """#include "{src}/{source}"

extern "C" int probe_traj_occupancy_{label}(int payoff_id, int* blocks) {{
  switch (payoff_id) {{
#define MC_CASE(ID, PAYOFF)                                                  \\
  case mc::ID:                                                               \\
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \\
        blocks, mc::family_trajectories_kernel<mc::{struct}, mc::PAYOFF>,    \\
        mc::kFamilyThreads, 0);
    MC_ONE_WORD_PAYOFFS(MC_CASE)
#undef MC_CASE
    default: return cudaErrorInvalidValue;
  }}
}}
"""


# A heston_kernels.cu whose heston_trajectories_kernel stores #13's grids
# (before Heston joined the family template): this unit adds its resident
# blocks per SM for each one-word payoff; heston_qe_kernels.cu, which the
# partials' launcher calls, is built beside it.
HESTON_TRAJ_SHIM = """#include "{src}/heston_kernels.cu"

extern "C" int probe_heston_traj_occupancy(int payoff_id, int* blocks) {{
  switch (payoff_id) {{
#define MC_CASE(ID, PAYOFF)                                                  \\
  case mc::ID:                                                               \\
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \\
        blocks, mc::heston_trajectories_kernel<mc::PAYOFF>, mc::kHestonThreads, 0);
    MC_ONE_WORD_PAYOFFS(MC_CASE)
#undef MC_CASE
    default: return cudaErrorInvalidValue;
  }}
}}
"""
# The entry point of that kernel (mc_heston_trajectories): payoff, k0, k1,
# params, n_steps, n_paths, path_offset, bound, the S, v and state grids,
# partials, n_blocks, stream.
_HESTON_TRAJ_ABI = [_int, _u32, _u32, _ptr, _int, _u32, _u32, _u32, _ptr,
                    _ptr, _ptr, _ptr, _int, _ptr]


def traj_sources(src: Path, out: Path):
    """The family NMC sources of ``src``; where its entry points have no
    ``mc_family_trajectories_occupancy``, each family's source through
    TRAJ_SHIM; where Heston stores its grids with a kernel of its own
    (``mc_heston_trajectories``), its sources through HESTON_TRAJ_SHIM."""
    srcs = probe_sources(src, "family", out)
    if "mc_heston_trajectories" in (src / "heston_kernels.cu").read_text():
        unit = out / "heston_traj_probe.cu"
        unit.write_text(HESTON_TRAJ_SHIM.format(src=src))
        srcs += [unit, src / "heston_qe_kernels.cu"]
    if "mc_family_trajectories_occupancy" in (
            src / "family_nmc_kernels.cu").read_text():
        return srcs
    shimmed = {source: (label, struct)
               for label, _, _, struct, source in TRAJ_INSTANCES}
    out_srcs = []
    for s in srcs:
        if s.name not in shimmed:
            out_srcs.append(s)
            continue
        label, struct = shimmed[s.name]
        unit = out / f"traj_probe_{label}.cu"
        unit.write_text(TRAJ_SHIM.format(src=src, source=s.name, label=label,
                                         struct=struct))
        out_srcs.append(unit)
    return out_srcs


def bind_traj(lib_path: Path):
    """The trajectories entry point of a variant's library and its paths a
    block (``mc_family_trajectories_block_paths``; the parent's: its
    threads, one path each)."""
    from mc_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    argtypes, restype = _cuda._SIGNATURES["mc_family_trajectories"]
    lib.mc_family_trajectories.argtypes = argtypes
    lib.mc_family_trajectories.restype = restype
    if hasattr(lib, "mc_family_trajectories_occupancy"):
        lib.mc_family_trajectories_occupancy.argtypes = [
            _int, _int, _cuda.FamilyExtras, _int,
            ctypes.POINTER(ctypes.c_int)]
        lib.mc_family_trajectories_occupancy.restype = _int
        lib.mc_family_trajectories_geometry.argtypes = [
            _int, _cuda.FamilyExtras, _int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.mc_family_trajectories_geometry.restype = _int
        tile = lib.mc_family_trajectories_block_paths()
    else:
        tile = lib.mc_family_block_threads()
    if hasattr(lib, "mc_heston_trajectories"):
        lib.mc_heston_trajectories.argtypes = _HESTON_TRAJ_ABI
        lib.mc_heston_trajectories.restype = _int
        lib.mc_heston_block_paths.argtypes = []
        lib.mc_heston_block_paths.restype = _int
        lib.probe_heston_traj_occupancy.argtypes = [
            _int, ctypes.POINTER(ctypes.c_int)]
        lib.probe_heston_traj_occupancy.restype = _int
    return lib, tile


def heston_own_kernel(lib, a: dict) -> bool:
    """Whether case ``a`` runs Heston's trajectories kernel of its own (a
    parent's library: #13 before the family template), not the family
    entry point."""
    return a["family"] == "heston" and hasattr(lib, "mc_heston_trajectories")


def traj_family(a: dict, dev):
    """(NMCFamily, params, key) of a trajectories case: the family's
    NMC_FAMILY_BUILDERS entry at the case's steps (the demo dynamics; the
    basket and the rainbow demo_basket(d, 0.5), the rainbow's fold; local
    vol and term, whose entries take an even count only, packed for the
    next even count and read at the odd one), its pack with the case's fix
    entries set, the outer key at seed 1234."""
    steps = a["steps"] + (a["steps"] % 2 * (a["family"] in ("localvol",
                                                             "term")))
    fam, prm, key = _traj_pack(a["family"], a["d"], a["fold"], steps)
    prm = prm.to(dev)
    for i, v in a["fix"]:
        prm[i % prm.numel()] = v
    return fam, prm, key


@functools.lru_cache(maxsize=None)
def _traj_pack(family: str, d, fold: int, steps: int):
    """traj_family's family, its pack on the CPU and its key."""
    from mc_tpu_torch import engines, rng
    from mc_tpu_torch import nmc_engine as ne
    from mc_tpu_torch.config import OptionParams, SimParams

    ne.ensure_family(family)
    opt = OptionParams()
    sim = SimParams(n_paths=1, n_steps=steps)
    if family in ("basket", "rainbow"):
        from mc_tpu_torch.models.basket import demo_basket
        from mc_tpu_torch.nmc_rainbow import RainbowNMC

        fam, dyn = ne.NMC_FAMILY_BUILDERS[family](opt, demo_basket(d, 0.5),
                                                  sim)
        if family == "rainbow":
            fam = RainbowNMC(extras=(d, fold))
    else:
        fam, dyn = ne.NMC_FAMILY_BUILDERS[family](opt, None, sim)
    key = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER,
                                                fam.tag))
    return fam, fam.pack(opt, dyn, steps, torch.device("cpu")), key


def traj_cases(timed: bool, insts=None):
    """The trajectories kernel's cases: dicts of label, inst (the
    TRAJ_INSTANCES label), family, d, fold, payoff, n (paths), steps,
    offset, bound (None: the run's end), blocks (None: the wrapper's grid)
    and fix ((pack index, value), ...; a negative index from the end).
    Timed: TRAJ_TIMED x TRAJ_PAYOFFS for every instantiation of ``insts``
    (default all).  Else the edges of TRAJ_EDGE_*."""
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    def case(inst, payoff, n, steps, d=None, fold=0, offset=0, bound=None,
             blocks=None, fix=()):
        _, family, d0, _, _ = next(t for t in TRAJ_INSTANCES if t[0] == inst)
        d = d0 if d is None else d
        label = (f"family_trajectories {inst} {payoff}"
                 + (f" d={d}" if d else "") + (" min" if fold else "")
                 + f" {n}x{steps}"
                 + (f" offset {offset} bound {bound}" if offset or bound
                    else "") + (f" blocks {blocks}" if blocks else "")
                 + (f" fix {fix}" if fix else ""))
        return dict(label=label, inst=inst, family=family, d=d, fold=fold,
                    payoff=payoff, n=n, steps=steps, offset=offset,
                    bound=bound, blocks=blocks, fix=tuple(fix))

    insts = [t[0] for t in TRAJ_INSTANCES if insts is None or t[0] in insts]
    if timed:
        return [case(i, p, n, s) for n, s in TRAJ_TIMED for i in insts
                for p in TRAJ_PAYOFFS]
    one_word = [n for n, po in PAYOFFS.items() if po.n_state <= 1]
    out = [case(i, p, n, s) for i in insts for p in TRAJ_PAYOFFS
           for s in TRAJ_EDGE_STEPS for n in TRAJ_EDGE_PATHS]
    out += [case(i, p, 129, s) for i in ("heston", "merton", "basket8",
                                         "basket32") if i in insts
            for p in one_word if p not in TRAJ_PAYOFFS for s in (3, 16)]
    for d in TRAJ_EDGE_D if "basket8" in insts else ():
        cap = 8 if d <= 8 else 32
        for fold in (0, 1):
            out += [case(f"rainbow{cap}", p, 2_049, s, d=d, fold=fold)
                    for p in TRAJ_PAYOFFS for s in (3, 17)]
        out += [case(f"basket{cap}", p, 2_049, s, d=d)
                for p in TRAJ_PAYOFFS for s in (3, 17)]
    for i in insts:
        out.append(case(i, "vanilla_call", TRAJ_CAPPED[0], 17,
                        blocks=TRAJ_CAPPED[1]))
        out += [case(i, p, n, 17, offset=off, bound=b) for p in TRAJ_PAYOFFS
                for off, n, b in FX_OFFSETS]
        out += [case(i, "vanilla_call", 129, 17, fix=((-1, v),))
                for v in TRAJ_FIX_VALUES]
    return out


def run_traj(lib, tile: int, a: dict, inputs, batch: int = 1, n=None):
    """(grids and state grid, partials, ms) of ``batch`` back-to-back
    mc_family_trajectories calls of case ``a`` (``n``: its path count, or
    another)."""
    from mc_tpu_torch.ops import _cuda
    from mc_tpu_torch.ops.payoffs import get_payoff

    fam, prm, (k0, k1) = inputs
    n = a["n"] if n is None else n
    bound = (a["offset"] + n if a["bound"] is None else a["bound"]) & 0xFFFFFFFF
    own = heston_own_kernel(lib, a)
    if own:
        tile = lib.mc_heston_block_paths()
    n_blocks = a["blocks"] or min(-(-n // tile), _cuda.MAX_BLOCKS)
    out = torch.empty((fam.n_grids + 1, a["steps"], n), dtype=torch.float32,
                      device=prm.device)
    part = torch.empty((n_blocks, 2), dtype=torch.float64, device=prm.device)
    pid = get_payoff(a["payoff"]).cuda_id
    stream = torch.cuda.current_stream().cuda_stream
    if own:
        args = (pid, k0, k1, prm.data_ptr(), a["steps"], n,
                a["offset"] & 0xFFFFFFFF, bound, out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(), part.data_ptr(),
                n_blocks, stream)
        entry = lib.mc_heston_trajectories
    else:
        args = (fam.cuda_id, pid, k0, k1, prm.data_ptr(),
                _cuda.family_extras(fam.extras), a["steps"], n,
                a["offset"] & 0xFFFFFFFF, bound,
                _cuda.pointer_array(out[:fam.n_grids]), fam.n_grids,
                out[fam.n_grids].data_ptr(), part.data_ptr(), n_blocks,
                stream)
        entry = lib.mc_family_trajectories
    t = _events()
    for _ in range(batch):
        _check(entry(*args), "family_trajectories")
    t.append(_event())
    torch.cuda.synchronize()
    return out, part, t[0].elapsed_time(t[1]) / batch


def traj_layout(lib, tile: int, insts) -> dict:
    """Per instantiation of ``insts`` and timed path count its blocks,
    threads a block, dynamic shared bytes and resident blocks per SM for the
    call and the bullet (the parent's: 128 threads, no dynamic shared memory,
    its blocks through TRAJ_SHIM's units; Heston's own kernel 256 threads,
    through HESTON_TRAJ_SHIM's)."""
    from mc_tpu_torch.ops import _cuda
    from mc_tpu_torch.ops.payoffs import get_payoff

    out = {"paths_a_block": tile}
    new = hasattr(lib, "mc_family_trajectories_occupancy")
    for label, family, d, _, _ in TRAJ_INSTANCES:
        if label not in insts:
            continue
        fam, _, _ = traj_family(dict(family=family, d=d, fold=0, n=1,
                                     steps=2, fix=()), torch.device("cpu"))
        ex = _cuda.family_extras(fam.extras)
        own = heston_own_kernel(lib, dict(family=family))
        own_tile = lib.mc_heston_block_paths() if own else tile
        for n in sorted({n for n, _ in TRAJ_TIMED}):
            n_blocks = min(-(-n // own_tile), _cuda.MAX_BLOCKS)
            threads, smem = ctypes.c_int(own_tile), ctypes.c_int(0)
            if own:
                row = dict(blocks=n_blocks, threads=threads.value,
                           smem_dynamic=0)
                for payoff in TRAJ_PAYOFFS:
                    blocks = ctypes.c_int(0)
                    st = lib.probe_heston_traj_occupancy(
                        get_payoff(payoff).cuda_id, ctypes.byref(blocks))
                    row[f"blocks_per_sm {payoff}"] = (blocks.value if st == 0
                                                      else None)
                out[f"{label} {n}"] = row
                continue
            if new:
                _check(lib.mc_family_trajectories_geometry(
                    fam.cuda_id, ex, n_blocks, ctypes.byref(threads),
                    ctypes.byref(smem)), "trajectories geometry")
            row = dict(blocks=n_blocks, threads=threads.value,
                       smem_dynamic=smem.value)
            for payoff in TRAJ_PAYOFFS:
                blocks = ctypes.c_int(0)
                pid = get_payoff(payoff).cuda_id
                if new:
                    st = lib.mc_family_trajectories_occupancy(
                        fam.cuda_id, pid, ex, n_blocks, ctypes.byref(blocks))
                else:
                    fn = getattr(lib, f"probe_traj_occupancy_{label}")
                    fn.argtypes = [_int, ctypes.POINTER(ctypes.c_int)]
                    st = fn(pid, ctypes.byref(blocks))
                row[f"blocks_per_sm {payoff}"] = (blocks.value if st == 0
                                                  else None)
            out[f"{label} {n}"] = row
    return out


def traj_main(args, variants, card) -> dict:
    """The --trajectories probe: resources, SASS, the bitwise edges and the
    times of the family trajectories kernel, every instantiation."""
    libs = build(variants, "trajectories")
    dev = torch.device("cuda")
    report = {"card": card, "variants": {}}
    bound = {}
    insts = args.kernels or tuple(t[0] for t in TRAJ_INSTANCES)
    structs = "|".join(t[3].split("<")[0] for t in TRAJ_INSTANCES
                       if t[0] in insts)
    heston = "|26heston_trajectories_kernel" if "heston" in insts else ""
    want = re.compile(rf"(26family_trajectories_kernelINS_\d+({structs})"
                      rf"{heston}).*(11VanillaCall|10BulletCall)")
    for label, src, defines in variants:
        lib_path, logs = libs[label]
        lib, tile = bind_traj(lib_path)
        bound[label] = (lib, tile)
        rows = kernel_rows(args, label, lib_path, logs, want, card)
        layout = traj_layout(lib, tile, insts)
        print(f"probe {label}: trajectories layout {layout} {card}",
              flush=True)
        report["variants"][label] = dict(src=str(src), defines=defines,
                                         kernels=rows, layout=layout)

    def run(label, a, inputs, batch=1, n=None):
        lib, tile = bound[label]
        return run_traj(lib, tile, a, inputs, batch, n)

    def paths_a_block(label, a):
        lib, tile = bound[label]
        return lib.mc_heston_block_paths() if heston_own_kernel(lib, a) else tile

    def same_rows(part, ref, same_blocks):
        """Rows bitwise; or, where the variants' blocks hold other paths
        (Heston's own kernel: 256 a block, the template's 128), their sums
        to f64 rounding."""
        if same_blocks:
            return same_bits(part, ref)
        got, want = part.sum(0), ref.sum(0)
        nan = want.isnan()
        if not torch.equal(got.isnan(), nan):
            return False
        close = (got - want).abs() <= 1e-12 * want.abs()
        return bool(torch.all(close | nan | (got == want)))

    edges, bad = {}, 0
    for a in traj_cases(False, insts):
        inputs = traj_family(a, dev)
        ref, first = None, next(iter(bound))
        for label in bound:
            grids, part, _ = run(label, a, inputs)
            ref = (grids, part) if ref is None else ref
            same = same_bits(grids, ref[0]) and same_rows(
                part, ref[1], paths_a_block(label, a) == paths_a_block(first, a))
            edges.setdefault(a["label"], {})[label] = same
            if not same:
                bad += 1
                print(f"FAIL: {a['label']} {label} disagrees with "
                      f"{next(iter(bound))}", flush=True)
        del inputs, grids, part, ref
    print(f"probe trajectories edges: {len(edges)} cases x {len(bound)} "
          f"variants, {bad} disagree {card}", flush=True)
    report["edges"] = edges
    if args.time:
        cases = traj_cases(True, insts)
        cache = {}

        def timed(label, a, batch, warm=False):
            if a["label"] not in cache:
                cache.clear()
                cache[a["label"]] = traj_family(a, dev)
            grids, part, ms = run(label, a, cache[a["label"]], batch,
                                  256 if warm else None)
            # Heston's rows are held to the parent's sums in the edges
            return ((grids,) if a["family"] == "heston" else (grids, part)), ms

        times = batched_turns(bound, cases, timed, TRAJ_BATCH_MS, TRAJ_TURNS,
                              card, "grids and partials")
        bounds = {}
        for a in cases:
            fam, _, _ = traj_family(dict(a, n=1), torch.device("cpu"))
            bounds[a["label"]] = bound_of(
                "family_trajectories", family=a["family"], n_paths=a["n"],
                n_steps=a["steps"], d=a["d"], kmax=(fam.extras[0] if
                                                    a["family"] in
                                                    ("merton", "bates")
                                                    else 0))
        for case, (b_ms, by) in bounds.items():
            med = {label: float(np.median([r["ms"] for r in rows]))
                   for label, rows in times[case].items()}
            print(f"probe bound {case}: {b_ms:.5f} ms ({by}); share "
                  + ", ".join(f"{k} {b_ms / v:.1%}" for k, v in med.items())
                  + f" {card}", flush=True)
        report["times"] = times
        report["bounds"] = bounds
    return report


# --- the pathwise-greek kernel (--greeks) ------------------------------------

# #8 at chip_smoke.py's shapes (phase 5 and the main path's greeks()):
# (payoff, method, paths, steps), threefry-13
GREEK_TIMED = (("vanilla_call", "terminal", 1_000_000, 100),
               ("asian_call", "euler", 100_000, 100),
               ("vanilla_call", "euler", 100_000, 100))
# greeks()'s fused-kernel route (chip_smoke.py's kernel_which)
GREEK_WHICH = ("delta", "vega", "rho", "epsilon")
# #8's bitwise edges: ragged path counts past the capped grid (2^21 paths:
# 8,192 blocks of 256) at 100 steps, step counts odd and even at
# GREEK_EDGE_N paths, and sigma = 0 (sqrt_dt = 0/0) and an infinite s0
GREEK_EDGE_PATHS = (1, 255, 256, 257, 100_001, (1 << 21) + 3)
GREEK_EDGE_STEPS = (1, 2, 99, 217)
GREEK_EDGE_N = 4_099
GREEK_EDGE_FIX = ({"sigma": 0.0}, {"s0": float("inf")})
# A call lasts 0.03-0.05 ms: batches of >= 5 ms, 3 pairs of turns.
GREEK_BATCH_MS, GREEK_TURNS = 5.0, 3
# A greek_kernels.cu that predates mc_greek_occupancy (one path a thread,
# the mode a runtime argument, a block of kGreekThreads paths): this unit
# adds it (threefry-13, either mode the one kernel), its paths a block and
# a thread.
GREEK_SHIM = """#include "{src}/greek_kernels.cu"

template <class P>
static int probe_greek_occupancy(int* blocks) {{
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mc::greek_kernel<P, 13>,
                                                       mc::kGreekThreads, 0);
}}

extern "C" int mc_greek_block_paths() {{ return mc::kGreekThreads; }}
extern "C" int mc_greek_paths_per_thread(int euler) {{ (void)euler; return 1; }}
extern "C" int mc_greek_occupancy(int payoff_id, int euler, int* blocks) {{
  (void)euler;
#define MC_CASE(ID, PAYOFF) \\
  case mc::ID:              \\
    return probe_greek_occupancy<mc::PAYOFF>(blocks);
  switch (payoff_id) {{
    MC_PATHWISE_PAYOFFS(MC_CASE)
    default: return cudaErrorInvalidValue;
  }}
#undef MC_CASE
}}
"""


def greek_sources(src: Path, out: Path):
    """``src``'s greek_kernels.cu, through GREEK_SHIM where it has no
    ``mc_greek_occupancy``."""
    own = src / "greek_kernels.cu"
    if "mc_greek_occupancy" in own.read_text():
        return [own]
    unit = out / "greek_probe.cu"
    unit.write_text(GREEK_SHIM.format(src=src))
    return [unit]


def bind_greeks(lib_path: Path):
    """The greek kernel's entry points of a variant's library."""
    from mc_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    lib.mc_greek_partials.argtypes, lib.mc_greek_partials.restype = \
        _cuda._SIGNATURES["mc_greek_partials"]
    lib.mc_greek_occupancy.argtypes = [_int, _int,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.mc_greek_occupancy.restype = _int
    return lib, lib.mc_greek_block_paths()


def greek_layout(lib, tile: int) -> dict:
    """The paths a block, the paths a thread of each mode and the resident
    blocks per SM of each pathwise payoff's threefry-13 kernels (terminal
    where it takes the terminal draw, Euler)."""
    from mc_tpu_torch.ops.payoffs import PATHWISE, get_payoff

    lib.mc_greek_paths_per_thread.argtypes = [_int]
    out = dict(paths_a_block=tile,
               paths_a_thread_terminal=lib.mc_greek_paths_per_thread(0),
               paths_a_thread_euler=lib.mc_greek_paths_per_thread(1))
    for name in PATHWISE:
        po = get_payoff(name)
        for euler in ((1,) if not po.terminal_only else (0, 1)):
            blocks = ctypes.c_int(0)
            st = lib.mc_greek_occupancy(po.cuda_id, euler,
                                        ctypes.byref(blocks))
            out[f"blocks_per_sm {name} {'euler' if euler else 'terminal'}"] = \
                blocks.value if st == 0 else None
    return out


def greek_cases(timed: bool):
    """#8's cases: dicts of payoff, method, rounds, n (paths), steps and fix
    (fields over OptionParams()).  Timed: GREEK_TIMED.  Else each pathwise
    payoff by each method it takes (the Asian and the lookback by Euler
    only) under threefry-13 and -20: GREEK_EDGE_PATHS at 100 steps,
    GREEK_EDGE_STEPS (Euler) and GREEK_EDGE_FIX at GREEK_EDGE_N paths."""
    from mc_tpu_torch.ops.payoffs import PATHWISE, get_payoff

    def case(payoff, method, n, steps, rounds=13, fix=None):
        label = (f"greek {payoff} {method} r{rounds} {n}x{steps}"
                 + (f" {fix}" if fix else ""))
        return dict(label=label, payoff=payoff, method=method, rounds=rounds,
                    n=n, steps=steps, fix=fix or {})

    if timed:
        return [case(*t) for t in GREEK_TIMED]
    out = []
    for payoff in PATHWISE:
        methods = (("terminal", "euler") if get_payoff(payoff).terminal_only
                   else ("euler",))
        for method in methods:
            for rounds in (13, 20):
                out += [case(payoff, method, n, 100, rounds)
                        for n in GREEK_EDGE_PATHS]
                if method == "euler":
                    out += [case(payoff, method, GREEK_EDGE_N, steps, rounds)
                            for steps in GREEK_EDGE_STEPS]
                out += [case(payoff, method, GREEK_EDGE_N, 100, rounds, fix)
                        for fix in GREEK_EDGE_FIX]
    return out


def greek_inputs(a: dict, dev):
    """(params, key) of a greek case: pack_params of its option fields at
    its steps; a fixed key."""
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.ops import path_kernels as pk

    return (pk.pack_params(OptionParams(**a["fix"]), a["steps"], dev),
            (0x1234ABCD, 0x5A97))


def run_greek(lib, tile: int, a: dict, inputs, batch: int = 1, n=None):
    """(partials, ms) of ``batch`` back-to-back greek_partials calls (#8) of
    case ``a`` (``n``: its path count, or another)."""
    from mc_tpu_torch.ops.payoffs import get_payoff

    prm, (k0, k1) = inputs
    n = a["n"] if n is None else n
    n_blocks = min(-(-n // tile), 8192)
    part = torch.empty((n_blocks, 10), dtype=torch.float64, device=prm.device)
    args = (get_payoff(a["payoff"]).cuda_id, a["rounds"],
            int(a["method"] == "euler"), k0, k1, prm.data_ptr(), a["steps"],
            n, part.data_ptr(), n_blocks,
            torch.cuda.current_stream().cuda_stream)
    t = _events()
    for _ in range(batch):
        _check(lib.mc_greek_partials(*args), "greek_partials")
    t.append(_event())
    torch.cuda.synchronize()
    return part, t[0].elapsed_time(t[1]) / batch


def greeks_main(args, variants, card) -> dict:
    """The --greeks probe: resources, SASS, the bitwise edges and the times
    of the pathwise-greek kernel (#8)."""
    libs = build(variants, "greeks")
    dev = torch.device("cuda")
    report = {"card": card, "variants": {}}
    bound = {}
    want = re.compile(r"12greek_kernelI.*Li13E")
    for label, src, defines in variants:
        lib_path, logs = libs[label]
        lib, tile = bind_greeks(lib_path)
        bound[label] = (lib, tile)
        rows = kernel_rows(args, label, lib_path, logs, want, card)
        layout = greek_layout(lib, tile)
        print(f"probe {label}: greek layout {layout} {card}", flush=True)
        report["variants"][label] = dict(src=str(src), defines=defines,
                                         kernels=rows, layout=layout)
    edges, bad = {}, 0
    for a in greek_cases(False):
        inputs = greek_inputs(a, dev)
        ref = None
        for label, (lib, tile) in bound.items():
            part, _ = run_greek(lib, tile, a, inputs)
            ref = part if ref is None else ref
            same = same_bits(part, ref)
            edges.setdefault(a["label"], {})[label] = same
            if not same:
                bad += 1
                print(f"FAIL: {a['label']} {label} disagrees with "
                      f"{next(iter(bound))}", flush=True)
    print(f"probe greek edges: {len(edges)} cases x {len(bound)} variants, "
          f"{bad} disagree {card}", flush=True)
    report["edges"] = edges
    if args.time:
        cache = {}

        def timed(label, a, batch, warm=False):
            lib, tile = bound[label]
            if a["label"] not in cache:
                cache[a["label"]] = greek_inputs(a, dev)
            part, ms = run_greek(lib, tile, a, cache[a["label"]], batch,
                                 4096 if warm else None)
            return (part,), ms

        cases = greek_cases(True)
        times = batched_turns(bound, cases, timed, GREEK_BATCH_MS,
                              GREEK_TURNS, card, "partials")
        bounds = {a["label"]: bound_of("greek_partials", payoff=a["payoff"],
                                       method=a["method"], n_paths=a["n"],
                                       n_steps=a["steps"])
                  for a in cases}
        for case, (b_ms, by) in bounds.items():
            med = {label: float(np.median([r["ms"] for r in rows]))
                   for label, rows in times[case].items()}
            print(f"probe bound {case}: {b_ms:.5f} ms ({by}); share "
                  + ", ".join(f"{k} {b_ms / v:.1%}" for k, v in med.items())
                  + f" {card}", flush=True)
        report["times"] = times
        report["bounds"] = bounds
    return report


# --- the basket kernels (--basket) -------------------------------------------

BASKET_MAIN = (1_000_000, 100)  # paths, steps: price_basket's kernel (phase 5)
BASKET_WARM = 4096
BASKET_D = (1, 4, 8, 9, 16, 32)
# #26 at chip_smoke.py's GRID_PATHS x MAIN_STEPS: the call and the bullet
BASKET_GRID = (100_000, 100)
BASKET_GRID_D = (1, 4, 9, 16, 32)
BASKET_GRID_PAYOFFS = ("vanilla_call", "bullet_call")
BASKET_GRID_BATCH_MS, BASKET_GRID_TURNS = 5.0, 2
# #26's bitwise edges: d about each capacity, ragged path and step counts,
# more paths than the capped grid's (8,192 blocks of 256) so blocks stride
BASKET_EDGE_D = (1, 2, 3, 4, 5, 8, 9, 16, 17, 32)
BASKET_EDGE_PATHS = (1, 255, 256, 257, 100_001)
BASKET_EDGE_STEPS = (1, 2, 217)
BASKET_GRID_PAST = (1 << 21) + 4_099
# The basket's partials kernel of a csrc that predates mc_basket_occupancy
# (the parent's capacities 8 and 32, one path a thread): this unit adds it,
# for VanillaCall.
BASKET_SHIM = """#include "{src}/basket_kernels.cu"

extern "C" int mc_basket_occupancy(int payoff_id, int d, int antithetic, int* blocks) {{
  (void)antithetic;
  if (payoff_id != mc::PAYOFF_VANILLA_CALL) return cudaErrorInvalidValue;
  const int threads = mc_basket_block_threads();
  return d <= 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, mc::basket_partials_kernel<mc::VanillaCall, 8>, threads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, mc::basket_partials_kernel<mc::VanillaCall, 32>, threads, 0);
}}
"""
# The trajectories kernel (#26) of a csrc that predates
# mc_basket_trajectories_occupancy (capacities 8 and 32, one path a thread,
# a block of mc_basket_block_threads()): this adds it, for the call and the
# bullet.
BASKET_GRID_SHIM = """
template <class P>
static int probe_grid_occupancy(int d, int* blocks) {{
  const int threads = mc_basket_block_threads();
  return d <= 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, mc::basket_trajectories_kernel<P, 8>, threads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, mc::basket_trajectories_kernel<P, 32>, threads, 0);
}}

extern "C" int mc_basket_trajectories_occupancy(int payoff_id, int d, int* blocks) {{
  switch (payoff_id) {{
    case mc::PAYOFF_VANILLA_CALL: return probe_grid_occupancy<mc::VanillaCall>(d, blocks);
    case mc::PAYOFF_BULLET_CALL: return probe_grid_occupancy<mc::BulletCall>(d, blocks);
    default: return cudaErrorInvalidValue;
  }}
}}
"""


def basket_sources(src: Path, out: Path):
    """The basket sources of ``src`` (basket_kernels.cu and a capacity's
    own basket<N>_kernels.cu, not the NMC's), through BASKET_SHIM where the
    source has no partials occupancy entry point and BASKET_GRID_SHIM where
    it has no trajectories one."""
    main = src / "basket_kernels.cu"
    text = main.read_text()
    shim = ""
    if "mc_basket_occupancy" not in text:
        shim = BASKET_SHIM
    elif "mc_basket_trajectories_occupancy" not in text:
        shim = f'#include "{{src}}/basket_kernels.cu"\n'
    if "mc_basket_trajectories_occupancy" not in text:
        shim += BASKET_GRID_SHIM
    if shim:
        main = out / "basket_probe.cu"
        main.write_text(shim.format(src=src))
    return [main, *(q for q in src.glob("basket*_kernels.cu")
                    if q.name != "basket_kernels.cu" and "nmc" not in q.name)]


def bind_basket(lib_path: Path):
    """The basket entry points of a variant's library, its partials kernel's
    paths a block (``mc_basket_block_paths``; before it: its threads, one
    path each) and its trajectories kernel's
    (``mc_basket_trajectories_block_paths``; before it: its threads)."""
    from mc_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    for name in ("mc_basket_partials", "mc_basket_trajectories"):
        getattr(lib, name).argtypes, getattr(lib, name).restype = \
            _cuda._SIGNATURES[name]
    # the trajectories kernel's threads a block: at d since it has its own
    # paths a block, a constant before
    new = hasattr(lib, "mc_basket_trajectories_block_paths")
    lib.mc_basket_block_threads.argtypes = [_int] if new else []
    lib.mc_basket_occupancy.argtypes = [_int, _int, _int,
                                        ctypes.POINTER(ctypes.c_int)]
    lib.mc_basket_occupancy.restype = _int
    lib.mc_basket_trajectories_occupancy.argtypes = [
        _int, _int, ctypes.POINTER(ctypes.c_int)]
    lib.mc_basket_trajectories_occupancy.restype = _int
    tile = (lib.mc_basket_block_paths() if hasattr(lib, "mc_basket_block_paths")
            else lib.mc_basket_block_threads())
    grid_tile = (lib.mc_basket_trajectories_block_paths() if new
                 else lib.mc_basket_block_threads())
    return lib, tile, grid_tile


def basket_layout(lib, d: int, anti: bool) -> dict:
    """The variant's capacity and paths a thread at d (where it exports
    them) and its partials kernel's resident blocks per SM (VanillaCall)."""
    blocks = ctypes.c_int(0)
    st = lib.mc_basket_occupancy(_payoff_id("vanilla_call"), d, int(anti),
                                 ctypes.byref(blocks))
    out = dict(blocks_per_sm=blocks.value if st == 0 else None)
    if hasattr(lib, "mc_basket_capacity"):
        out.update(capacity=lib.mc_basket_capacity(d),
                   paths_a_thread=lib.mc_basket_paths_per_thread(d))
    return out


def basket_grid_layout(lib, d: int, payoff: str) -> dict:
    """The trajectories kernel's resident blocks per SM at d (``payoff``)
    and its threads a block there."""
    blocks = ctypes.c_int(0)
    st = lib.mc_basket_trajectories_occupancy(_payoff_id(payoff), d,
                                              ctypes.byref(blocks))
    out = dict(blocks_per_sm=blocks.value if st == 0 else None)
    out["threads"] = (lib.mc_basket_block_threads(d)
                      if lib.mc_basket_block_threads.argtypes
                      else lib.mc_basket_block_threads())
    return out


def _payoff_id(name: str) -> int:
    from mc_tpu_torch.ops.payoffs import get_payoff
    return get_payoff(name).cuda_id


def basket_inputs(n_steps: int, d: int, dev, fix=()):
    """(params, key) of price_basket's call at d (demo_basket(d, 0.5)), the
    packed entries ``fix`` ((index, value) pairs) overwritten."""
    from mc_tpu_torch import engines, rng
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.models import basket as bm

    prm = bm.pack_basket(OptionParams(), bm.demo_basket(d, 0.5), n_steps, dev)
    for i, v in fix:
        prm[i] = v
    key = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER,
                                                bm.BASKET_TAG))
    return prm, key


def run_basket(lib, tile, d, anti, n_paths, inputs):
    """(partials, ms) of one basket_partials call through ``lib``."""
    prm, (k0, k1) = inputs
    n_blocks = min(-(-n_paths // tile), 8192)
    part = torch.empty((n_blocks, 2), dtype=torch.float64, device=prm.device)
    t = _events()
    _check(lib.mc_basket_partials(
        _payoff_id("vanilla_call"), int(anti), k0, k1, prm.data_ptr(), d,
        BASKET_MAIN[1], n_paths, 0, n_paths, part.data_ptr(), n_blocks,
        torch.cuda.current_stream().cuda_stream), "basket_partials")
    t.append(_event())
    torch.cuda.synchronize()
    return part, t[0].elapsed_time(t[1])


def basket_grid_cases(timed: bool):
    """#26's cases: dicts of payoff, d, n (paths), steps, offset, bound
    (None: the run's end) and fix (packed entries overwritten).  Timed:
    BASKET_GRID_PAYOFFS at BASKET_GRID, d in BASKET_GRID_D.  Else every
    one-word payoff at each BASKET_EDGE_D; the call at ragged path and step
    counts and past the capped grid; offsets and bounds that cut a block and
    ids that wrap past 2^32; a Cholesky entry, weight or s0 of +-inf or
    NaN."""
    from mc_tpu_torch.models.basket import HEAD_FIELDS
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    def case(payoff, d, n, steps, offset=0, bound=None, fix=()):
        label = (f"basket_trajectories {payoff} d={d} {n}x{steps}"
                 + (f" offset {offset} bound {bound}" if offset or bound
                    else "") + (f" fix {fix}" if fix else ""))
        return dict(label=label, payoff=payoff, d=d, n=n, steps=steps,
                    offset=offset, bound=bound, fix=tuple(fix))

    if timed:
        return [case(p, d, *BASKET_GRID) for p in BASKET_GRID_PAYOFFS
                for d in BASKET_GRID_D]
    one_word = [n for n, po in PAYOFFS.items() if po.n_state <= 1]
    out = [case(p, d, 257, 3) for d in BASKET_EDGE_D for p in one_word]
    for d in (1, 4, 5, 9, 17, 32):
        out += [case("vanilla_call", d, n, s) for n in BASKET_EDGE_PATHS
                for s in BASKET_EDGE_STEPS]
    for d in (4, 9, 32):
        out.append(case("vanilla_call", d, BASKET_GRID_PAST, 2))
        for payoff in ("vanilla_call", "bullet_call"):
            out += [case(payoff, d, n, 5, off, b) for off, n, b in FX_OFFSETS]
        h, row = len(HEAD_FIELDS), min(2, d - 1)
        # L's entry (row, 0), the last weight, the first s0
        for at in (h + 3 * d + row * (row + 1) // 2, h + 2 * d - 1, h):
            out += [case("vanilla_call", d, 4_099, 5, fix=((at, v),))
                    for v in (float("inf"), float("-inf"), float("nan"))]
    return out


def run_basket_grid(lib, grid_tile: int, a: dict, inputs, batch: int = 1,
                    n=None):
    """(grids, partials, ms) of ``batch`` basket_trajectories calls (#26) of
    case ``a`` (``n``: its path count, or another)."""
    prm, (k0, k1) = inputs
    n = a["n"] if n is None else n
    bound = (a["offset"] + n if a["bound"] is None else a["bound"]) & 0xFFFFFFFF
    n_blocks = min(-(-n // grid_tile), 8192)
    grids = torch.empty((2, a["steps"], n), dtype=torch.float32,
                        device=prm.device)
    part = torch.empty((n_blocks, 2), dtype=torch.float64, device=prm.device)
    args = (_payoff_id(a["payoff"]), k0, k1, prm.data_ptr(), a["d"],
            a["steps"], n, a["offset"] & 0xFFFFFFFF, bound,
            grids[0].data_ptr(), grids[1].data_ptr(), part.data_ptr(),
            n_blocks, torch.cuda.current_stream().cuda_stream)
    t = _events()
    for _ in range(batch):
        _check(lib.mc_basket_trajectories(*args), "basket_trajectories")
    t.append(_event())
    torch.cuda.synchronize()
    return grids, part, t[0].elapsed_time(t[1]) / batch


def basket_main(args, variants, card) -> dict:
    """The --basket probe: resources, SASS, the bitwise edges and times of
    the basket's partials kernel (#25) and trajectories kernel (#26)."""
    libs = build(variants, "basket")
    dev = torch.device("cuda")
    report = {"card": card, "variants": {}}
    bound = {}
    want = re.compile(r"(22basket_partials_kernel|26basket_trajectories_kernel)"
                      r"INS_(11VanillaCall|10BulletCall)E")
    for label, src, defines in variants:
        lib_path, logs = libs[label]
        lib, tile, grid_tile = bind_basket(lib_path)
        bound[label] = (lib, tile, grid_tile)
        rows = kernel_rows(args, label, lib_path, logs, want, card)
        layout = {}
        for d in BASKET_D:
            for anti in (False, True):
                layout[f"d={d} anti={anti}"] = basket_layout(lib, d, anti)
        print(f"probe {label}: basket_partials layout (VanillaCall) {layout} "
              f"{card}", flush=True)
        grid_layout = dict(paths_a_block=grid_tile)
        for d in BASKET_GRID_D:
            for payoff in BASKET_GRID_PAYOFFS:
                grid_layout[f"{payoff} d={d}"] = basket_grid_layout(lib, d,
                                                                    payoff)
        print(f"probe {label}: basket_trajectories layout {grid_layout} "
              f"{card}", flush=True)
        report["variants"][label] = dict(src=str(src), defines=defines,
                                         kernels=rows, layout=layout,
                                         grid_layout=grid_layout, ptxas=logs)
    edges, bad = {}, 0
    for a in basket_grid_cases(False):
        inputs = basket_inputs(a["steps"], a["d"], dev, a["fix"])
        ref = None
        for label, (lib, _, grid_tile) in bound.items():
            grids, part, _ = run_basket_grid(lib, grid_tile, a, inputs)
            ref = (grids, part) if ref is None else ref
            same = same_bits(grids, ref[0]) and same_bits(part, ref[1])
            edges.setdefault(a["label"], {})[label] = same
            if not same:
                bad += 1
                print(f"FAIL: {a['label']} {label} disagrees with "
                      f"{next(iter(bound))}", flush=True)
            del grids
        del ref
    print(f"probe basket_trajectories edges: {len(edges)} cases x "
          f"{len(bound)} variants, {bad} disagree {card}", flush=True)
    report["edges"] = edges
    if args.time:
        times = {}
        order = list(bound) + list(bound)[::-1]
        for d in BASKET_D:
            main_in = basket_inputs(BASKET_MAIN[1], d, dev)
            for anti in (False, True):
                case = f"basket_partials call d={d} anti={anti}"
                ref = None
                for label in order:
                    lib, tile, _ = bound[label]
                    run_basket(lib, tile, d, anti, BASKET_WARM, main_in)
                    part, ms = run_basket(lib, tile, d, anti, BASKET_MAIN[0],
                                          main_in)
                    ref = part if ref is None else ref
                    same = bool(torch.equal(part, ref))
                    times.setdefault(case, {}).setdefault(label, []).append(
                        dict(ms=ms, bitwise=same))
                    print(f"probe time {case} {BASKET_MAIN[0]}x"
                          f"{BASKET_MAIN[1]} {label}: {ms:.3f} ms, partials "
                          f"bitwise vs {order[0]}: {same} {card}", flush=True)
                    if not same:
                        print(f"FAIL: {case} {label} disagrees", flush=True)
        cache = {}

        def run(label, a, batch, warm=False):
            lib, _, grid_tile = bound[label]
            if a["label"] not in cache:
                cache[a["label"]] = basket_inputs(a["steps"], a["d"], dev)
            inputs = cache[a["label"]]
            grids, part, ms = run_basket_grid(lib, grid_tile, a, inputs,
                                              batch, BASKET_WARM if warm
                                              else None)
            return (grids, part), ms

        cases = basket_grid_cases(True)
        times.update(batched_turns(bound, cases, run, BASKET_GRID_BATCH_MS,
                                   BASKET_GRID_TURNS, card,
                                   "grids and partials"))
        bounds = {a["label"]: bound_of("basket_trajectories", d=a["d"],
                                       payoff=a["payoff"], n_paths=a["n"],
                                       n_steps=a["steps"]) for a in cases}
        for case, (b_ms, by) in bounds.items():
            print(f"probe bound {case}: {b_ms:.5f} ms ({by}) {card}",
                  flush=True)
        report["times"] = times
        report["bounds"] = bounds
    return report



# --- the local-vol and Merton partials kernels (--partials) ------------------

PARTIALS_MAIN = (1_000_000, 100)  # paths, steps: price_localvol/price_merton
PARTIALS_WARM = 4096
PARTIALS_EDGE = 16_411            # the bitwise cases' paths: a ragged block
LV_KNOTS = (2, 9, 10, 11, 16, 25, 33)
DIVS_LAYOUT_STEPS = (2, 100, 2048, 2050)  # about the table's capacity
# A csrc that predates the occupancy entry points (the parent's one path a
# thread): these units add them, for VanillaCall at threefry-13.
LOCALVOL_SHIM = """#include "{src}/localvol_kernels.cu"

extern "C" int mc_localvol_occupancy(int payoff_id, int n_knots, int antithetic, int* blocks) {{
  (void)n_knots; (void)antithetic;
  if (payoff_id != mc::PAYOFF_VANILLA_CALL) return cudaErrorInvalidValue;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mc::localvol_partials_kernel<mc::VanillaCall, 13>, mc_localvol_block_threads(), 0);
}}
"""
MERTON_SHIM = """#include "{src}/merton_kernels.cu"

extern "C" int mc_merton_occupancy(int payoff_id, int terminal, int antithetic, int* blocks) {{
  (void)antithetic;
  if (payoff_id != mc::PAYOFF_VANILLA_CALL) return cudaErrorInvalidValue;
  const int threads = mc_merton_block_threads();
  return terminal ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        blocks, mc::merton_partials_kernel<mc::VanillaCall, mc::MertonTerminal, 13>,
                        threads, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        blocks, mc::merton_partials_kernel<mc::VanillaCall, mc::MertonEuler, 13>,
                        threads, 0);
}}
"""


# A csrc that predates mc_cev_occupancy or mc_divs_occupancy (the parent's
# one path a thread): these units add them, for VanillaCall.
CEV_SHIM = """#include "{src}/cev_kernels.cu"

extern "C" int mc_cev_occupancy(int antithetic, int* blocks) {{
  (void)antithetic;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mc::cev_partials_kernel<mc::VanillaCall>, mc_cev_block_threads(), 0);
}}
"""
DIVS_SHIM = """#include "{src}/divs_kernels.cu"

extern "C" int mc_divs_occupancy(int antithetic, int n_steps, int* blocks) {{
  (void)antithetic; (void)n_steps;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mc::divs_partials_kernel<mc::VanillaCall>, mc_divs_block_threads(), 0);
}}
"""
# A csrc that predates mc_heston_occupancy or mc_bates_occupancy (the QE
# kernels' one loop for both legs): these units add them, for VanillaCall at
# threefry-13, by scheme (qe 1: the QE kernel, 0: the Euler one).
HESTON_SHIM = """#include "{src}/heston_kernels.cu"

extern "C" int mc_heston_occupancy(int qe, int antithetic, int* blocks) {{
  (void)antithetic;
  const int threads = mc_heston_block_threads();
  return qe ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks, mc::heston_qe_kernel<mc::VanillaCall, 13>, threads, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks, mc::heston_euler_kernel<mc::VanillaCall, 13>, threads, 0);
}}
"""
BATES_SHIM = """#include "{src}/bates_kernels.cu"

extern "C" int mc_bates_occupancy(int qe, int antithetic, int* blocks) {{
  (void)antithetic;
  const int threads = mc_bates_block_threads();
  return qe ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks, mc::bates_partials_kernel<mc::VanillaCall, mc::BatesQe, 13>,
                  threads, 0)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  blocks, mc::bates_partials_kernel<mc::VanillaCall, mc::BatesEuler, 13>,
                  threads, 0);
}}
"""
PARTIALS_KERNELS = ("localvol", "merton", "cev", "divs", "heston_qe",
                    "bates_qe", "heston_euler")
# The family of a kernel name: its sources' stem and its entry points'
# infix (mc_<family>_partials); the QE and Euler kernels are their families'.
_PARTIALS_FAMILY = {"heston_qe": "heston", "bates_qe": "bates",
                    "heston_euler": "heston"}
_PARTIALS_SHIMS = {"localvol": LOCALVOL_SHIM, "merton": MERTON_SHIM,
                   "cev": CEV_SHIM, "divs": DIVS_SHIM, "heston": HESTON_SHIM,
                   "bates": BATES_SHIM}
# the occupancy entry points' arguments before the blocks pointer
_OCCUPANCY_ARGS = {"localvol": 3, "merton": 3, "cev": 1, "divs": 2,
                   "heston_qe": 2, "bates_qe": 2, "heston_euler": 2}


def partials_family(name: str) -> str:
    return _PARTIALS_FAMILY.get(name, name)


def partials_sources(src: Path, out: Path, kernels=PARTIALS_KERNELS):
    """The partials sources of ``kernels`` in ``src`` (each capacity's own
    ``<family><N>_kernels.cu`` and the QE kernels' ``<family>_qe_kernels.cu``
    too, not the NMC's), through a shim where the sources have no occupancy
    entry point."""
    srcs = []
    for fam in dict.fromkeys(partials_family(name) for name in kernels):
        own = [src / f"{fam}_kernels.cu",
               *src.glob(f"{fam}[0-9]*_kernels.cu"),
               *src.glob(f"{fam}_qe_kernels.cu")]
        if any(f"mc_{fam}_occupancy" in q.read_text() for q in own):
            srcs += own
        else:
            unit = out / f"{fam}_probe.cu"
            unit.write_text(_PARTIALS_SHIMS[fam].format(src=src))
            srcs.append(unit)
    return srcs


def bind_partials(lib_path: Path, kernels=PARTIALS_KERNELS):
    """The partials entry points of ``kernels`` in a variant's library and
    each kernel's paths a block (``mc_<name>_block_paths``; the parent's:
    its threads, one path each)."""
    from mc_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    tiles = {}
    for name in kernels:
        fam = partials_family(name)
        fn = getattr(lib, f"mc_{fam}_partials")
        fn.argtypes, fn.restype = _cuda._SIGNATURES[f"mc_{fam}_partials"]
        tile = getattr(lib, f"mc_{fam}_block_paths", None) or getattr(
            lib, f"mc_{fam}_block_threads")
        tile.argtypes, tile.restype = [], _int
        tiles[name] = tile()
        occ = getattr(lib, f"mc_{fam}_occupancy")
        occ.argtypes = [_int] * _OCCUPANCY_ARGS[name] + [
            ctypes.POINTER(ctypes.c_int)]
        occ.restype = _int
    for name in ("mc_localvol_capacity", "mc_localvol_paths_per_thread",
                 "mc_divs_paths_per_thread", "mc_divs_table_steps"):
        if hasattr(lib, name):
            getattr(lib, name).restype = _int
    if hasattr(lib, "mc_cev_logf_check"):
        lib.mc_cev_logf_check.argtypes, lib.mc_cev_logf_check.restype = (
            _cuda._SIGNATURES["mc_cev_logf_check"])
    return lib, tiles


def partials_layout(lib, kernels=PARTIALS_KERNELS) -> dict:
    """Per shape: the resident blocks per SM of the VanillaCall kernel and,
    where the variant exports them, local vol's knot capacity and paths a
    thread, the dividends' paths a thread and table capacity in steps."""
    out = {}
    blocks = ctypes.c_int(0)
    call = _payoff_id("vanilla_call")

    def row(st, name, anti):
        r = dict(blocks_per_sm=blocks.value if st == 0 else None)
        if name == "divs" and hasattr(lib, "mc_divs_paths_per_thread"):
            r["paths_a_thread"] = lib.mc_divs_paths_per_thread(int(anti))
        return r

    for k in LV_KNOTS if "localvol" in kernels else ():
        for anti in (False, True):
            st = lib.mc_localvol_occupancy(call, k, int(anti),
                                           ctypes.byref(blocks))
            r = row(st, "localvol", anti)
            if hasattr(lib, "mc_localvol_capacity"):
                r.update(capacity=lib.mc_localvol_capacity(k),
                         paths_a_thread=lib.mc_localvol_paths_per_thread(
                             int(anti)))
            out[f"localvol K={k} anti={anti}"] = r
    for terminal in (False, True) if "merton" in kernels else ():
        for anti in (False, True):
            st = lib.mc_merton_occupancy(call, int(terminal), int(anti),
                                         ctypes.byref(blocks))
            out[f"merton terminal={terminal} anti={anti}"] = row(st, "merton",
                                                                 anti)
    for anti in (False, True) if "cev" in kernels else ():
        st = lib.mc_cev_occupancy(int(anti), ctypes.byref(blocks))
        out[f"cev anti={anti}"] = row(st, "cev", anti)
    for steps in DIVS_LAYOUT_STEPS if "divs" in kernels else ():
        for anti in (False, True):
            st = lib.mc_divs_occupancy(int(anti), steps, ctypes.byref(blocks))
            r = row(st, "divs", anti)
            if hasattr(lib, "mc_divs_table_steps"):
                r["table_steps"] = lib.mc_divs_table_steps()
            out[f"divs steps={steps} anti={anti}"] = r
    for name in ("heston_qe", "bates_qe", "heston_euler"):
        if name not in kernels:
            continue
        fam = partials_family(name)
        if name == "heston_qe" and "heston_euler" in kernels:
            continue  # heston_euler's rows list both schemes
        for qe in (1, 0):
            for anti in (False, True):
                st = getattr(lib, f"mc_{fam}_occupancy")(
                    qe, int(anti), ctypes.byref(blocks))
                out[f"{fam} {'qe' if qe else 'euler'} anti={anti}"] = row(
                    st, name, anti)
    return out


def lv_surface(n_knots: int, n_steps: int):
    """The demo surface's smile on ``n_knots`` knots (K = 25:
    chip_smoke.py's CEV-shaped gate surface, sigma 0.2 (S/S0)^-0.3 over
    [-1.5, 1.5])."""
    import math

    from mc_tpu_torch.models import localvol as lm

    if n_knots == 25:
        return lm.LocalVolSurface.from_function(
            lambda x, t: 0.2 * math.exp(-0.3 * x), n_steps, x_lo=-1.5,
            x_hi=1.5, n_knots=25)
    return lm.LocalVolSurface.from_function(
        lambda x, t: 0.2 + 0.1 * x * x + 0.05 * t, n_steps, n_knots=n_knots)


def partials_cases(timed: bool, kernels=PARTIALS_KERNELS):
    """The --partials cases of ``kernels``: (label, kernel, arguments).
    Timed: the main shapes; else the bitwise edges (every payoff, each K
    around the capacities, K = 25 at 300 steps, kmax 1, 4, 10, 53,
    threefry-20, an offset and a bound, ragged counts; CEV's and the
    dividends' edges: cev_edge_cases, divs_edge_cases)."""
    out = [c for c in _lv_merton_cases(timed)
           if c[1] in kernels]
    if "cev" in kernels:
        out += cev_edge_cases(timed)
    if "divs" in kernels:
        out += divs_edge_cases(timed)
    if "heston_qe" in kernels:
        out += qe_edge_cases(timed, "heston_qe")
    if "bates_qe" in kernels:
        out += qe_edge_cases(timed, "bates_qe")
    if "heston_euler" in kernels:
        out += heston_euler_edge_cases(timed)
    return out


def _lv_merton_cases(timed: bool):
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    n, steps = PARTIALS_MAIN
    if timed:
        out = []
        for k in (9, 25):
            for anti in (False, True):
                out.append((f"localvol K={k} anti={anti}", "localvol",
                            dict(k=k, steps=steps, anti=anti, n=n)))
        for anti in (False, True):
            out.append((f"merton euler anti={anti}", "merton",
                        dict(terminal=False, anti=anti, n=n, steps=steps)))
        for anti in (False, True):
            out.append((f"merton terminal anti={anti}", "merton",
                        dict(terminal=True, anti=anti, n=n, steps=steps)))
        return out
    e = PARTIALS_EDGE
    out = []
    for name, po in sorted(PAYOFFS.items()):
        for anti in (False, True):
            out.append((f"localvol {name} K=9 anti={anti}", "localvol",
                        dict(k=9, steps=steps, anti=anti, n=e, payoff=name)))
            out.append((f"merton {name} euler anti={anti}", "merton",
                        dict(terminal=False, anti=anti, n=e, steps=steps,
                             payoff=name)))
            if po.terminal_only:
                out.append((f"merton {name} terminal anti={anti}", "merton",
                            dict(terminal=True, anti=anti, n=e, steps=steps,
                                 payoff=name)))
    for k in LV_KNOTS:
        for anti in (False, True):
            for rounds in (13, 20):
                for payoff in ("vanilla_call", "asian_call"):
                    out.append((f"localvol {payoff} K={k} anti={anti} "
                                f"rounds={rounds}", "localvol",
                                dict(k=k, steps=steps, anti=anti, n=e,
                                     rounds=rounds, payoff=payoff)))
    for anti in (False, True):
        out.append((f"localvol K=25 300 steps anti={anti}", "localvol",
                    dict(k=25, steps=300, anti=anti, n=e)))
        out.append((f"localvol K=9 offset bound anti={anti}", "localvol",
                    dict(k=9, steps=steps, anti=anti, n=50_001,
                         offset=12_345, bound=12_345 + 40_000)))
    for lam_dt, kmax in ((0.003, 1), (0.003, 4), (0.3, 10), (17.0, 53)):
        for terminal in (False, True):
            for anti in (False, True):
                for rounds in (13, 20):
                    out.append((f"merton lam_dt={lam_dt} kmax={kmax} "
                                f"terminal={terminal} anti={anti} "
                                f"rounds={rounds}", "merton",
                                dict(terminal=terminal, anti=anti, n=e,
                                     steps=steps, lam=lam_dt * steps,
                                     kmax=kmax, rounds=rounds)))
    for terminal in (False, True):
        out.append((f"merton offset bound terminal={terminal}", "merton",
                    dict(terminal=terminal, anti=True, n=50_001,
                         steps=steps, offset=12_345,
                         bound=12_345 + 40_000)))
    return out


# Options that keep a payoff's window or strike live (the SABR, CEV and
# dividend edges').
SPECIAL_OPTIONS = {"variance_swap": dict(k=0.04),
                   "forward_start_call": dict(k=1.0, p1=30.0),
                   "cliquet": dict(k=10.0, p1=-0.05, p2=0.05),
                   "down_out_call": dict(barrier=90.0),
                   "down_in_call": dict(barrier=90.0)}
# More paths than the grid's threads (8,192 blocks of 256), a ragged tail.
GRID_PAST = (1 << 21) + 4099


def cev_edge_cases(timed: bool):
    """CEV's (#18) cases.  Timed: price_cev's call at 1M x 100 under the
    demo dynamics (beta 0.5), plain and antithetic, and the Asian.  Else
    every payoff CEV prices, plain and antithetic; beta 0, 0.5 and 1;
    paths absorbed at 0 (sigma_lv 60 at beta 1); a spot that overflows to
    +inf (s0 3e38, r 0.5); s0 0, -1, NaN, 1e-30, +inf; 2, 4 and 300 steps;
    an offset and a bound past 2^20; a bound past the last path (the paths
    past n_paths add zeros all the same); more paths than the grid's
    threads."""
    from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    n, steps = PARTIALS_MAIN
    if timed:
        return [(f"cev call anti={anti}", "cev",
                 dict(anti=anti, n=n, steps=steps)) for anti in (False, True)
                ] + [("cev asian_call anti=False", "cev",
                      dict(anti=False, n=n, steps=steps, payoff="asian_call"))]
    e = PARTIALS_EDGE
    out = []
    for name in sorted(set(PAYOFFS) - set(SIGMA_PAYOFFS)):
        for anti in (False, True):
            out.append((f"cev {name} anti={anti}", "cev",
                        dict(anti=anti, n=e, steps=steps, payoff=name,
                             option=SPECIAL_OPTIONS.get(name, {}))))
    dyn_edges = [dict(beta=0.0, sigma_lv=20.0), dict(beta=1.0, sigma_lv=0.2),
                 dict(beta=1.0, sigma_lv=60.0), dict(beta=0.5, sigma_lv=0.0),
                 dict(beta=0.5, sigma_lv=float("inf")),
                 dict(beta=0.5, sigma_lv=float("nan"))]
    opt_edges = [dict(s0=3e38, r=0.5), dict(s0=0.0), dict(s0=-1.0),
                 dict(s0=float("nan")), dict(s0=1e-30), dict(s0=float("inf"))]
    for fix in dyn_edges + opt_edges:
        for payoff in ("vanilla_call", "bullet_call", "asian_call"):
            for anti in (False, True):
                dyn = {k: v for k, v in fix.items() if k in ("beta",
                                                             "sigma_lv")}
                opt = {k: v for k, v in fix.items() if k not in dyn}
                out.append((f"cev {payoff} {fix} anti={anti}", "cev",
                            dict(anti=anti, n=4099, steps=steps,
                                 payoff=payoff, option=opt, dyn=dyn)))
    for anti in (False, True):
        for st in (2, 4, 300):
            out.append((f"cev asian {st} steps anti={anti}", "cev",
                        dict(anti=anti, n=e, steps=st, payoff="asian_call")))
        out.append((f"cev offset bound anti={anti}", "cev",
                    dict(anti=anti, n=50_001, steps=steps,
                         offset=(1 << 20) + 12_345,
                         bound=(1 << 20) + 12_345 + 40_000)))
        out.append((f"cev {GRID_PAST} paths anti={anti}", "cev",
                    dict(anti=anti, n=GRID_PAST, steps=4)))
        out.append((f"cev bound past the end anti={anti}", "cev",
                    dict(anti=anti, n=5003, steps=steps, offset=7,
                         bound=0xFFFFFFFF)))
    return out


def divs_schedules(steps: int):
    """The dividends' edge schedules at ``steps``: {label: amounts}."""
    two = np.zeros(steps, np.float32)
    two[steps // 4 - 1], two[3 * steps // 4 - 1] = 3.0, 4.0
    out = {"two payments": two, "none": np.zeros(steps, np.float32)}
    ends = np.zeros(steps, np.float32)
    ends[0], ends[-1] = 2.0, 5.0
    out["first and last step"] = ends
    out["every step"] = np.full(steps, 0.05, np.float32)
    signed = two.copy()
    signed[1::3] = -0.0
    out["-0.0 between"] = signed
    for label, v in (("NaN", np.nan), ("negative", -3.0), ("above spot", 500.0),
                     ("+inf", np.inf)):
        d = two.copy()
        d[steps // 2] = v
        out[label] = d
    return out


def divs_edge_cases(timed: bool):
    """The dividends' (#22) cases.  Timed: price_divs's call at 1M x 100 on
    the two payments (chip_smoke.py's), plain and antithetic, and the
    Asian.  Else every payoff on the two payments, plain and antithetic;
    each schedule of divs_schedules (none, the first and last step, every
    step, -0.0 between, NaN, negative, above the spot, +inf) on the call,
    the bullet, the Asian and the bridge barrier; 2 and 300 steps; the
    table's capacity and past it; an offset and a bound past 2^20; a bound
    past the last path; more paths than the grid's threads."""
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    n, steps = PARTIALS_MAIN
    if timed:
        return [(f"divs call two payments anti={anti}", "divs",
                 dict(anti=anti, n=n, steps=steps, sched="two payments"))
                for anti in (False, True)] + [
            ("divs asian_call two payments anti=False", "divs",
             dict(anti=False, n=n, steps=steps, payoff="asian_call",
                  sched="two payments"))]
    e = PARTIALS_EDGE
    out = []
    for name in sorted(PAYOFFS):
        for anti in (False, True):
            out.append((f"divs {name} anti={anti}", "divs",
                        dict(anti=anti, n=e, steps=steps, payoff=name,
                             sched="two payments",
                             option=SPECIAL_OPTIONS.get(name, {}))))
    for sched in divs_schedules(steps):
        for payoff in ("vanilla_call", "bullet_call", "asian_call",
                       "up_out_call_bb"):
            for anti in (False, True):
                out.append((f"divs {payoff} {sched} anti={anti}", "divs",
                            dict(anti=anti, n=4099, steps=steps,
                                 payoff=payoff, sched=sched)))
    for anti in (False, True):
        for st in (2, 300, 2048, 2050):
            for sched in ("first and last step", "every step"):
                out.append((f"divs asian {st} steps {sched} anti={anti}",
                            "divs", dict(anti=anti, n=4099 if st > 300 else e,
                                         steps=st, payoff="asian_call",
                                         sched=sched)))
        out.append((f"divs offset bound anti={anti}", "divs",
                    dict(anti=anti, n=50_001, steps=steps,
                         sched="two payments", offset=(1 << 20) + 12_345,
                         bound=(1 << 20) + 12_345 + 40_000)))
        out.append((f"divs {GRID_PAST} paths anti={anti}", "divs",
                    dict(anti=anti, n=GRID_PAST, steps=4,
                         sched="first and last step")))
        out.append((f"divs bound past the end anti={anti}", "divs",
                    dict(anti=anti, n=5003, steps=steps, offset=7,
                         bound=0xFFFFFFFF, sched="two payments")))
    return out


# Heston's variance dynamics at the QE edges: the Feller-violating stress
# regime of tests/test_heston_qe.py, where psi crosses 1.5 inside a warp;
# rho = +0.9 from v0 = 3 at dt = 0.5 (tests/test_torch_heston.py's
# fall-back case, which keeps A*a and A/beta inside the correction's
# validity), and xi = 2, kappa = 1 at dt = 2 from v0 = 17 and 30, where
# both samplers fall back to the plain K0 on a share of the paths (quadratic
# above v ~ 16.2, exponential over v ~ 5-16.2); (option fields, dynamics,
# steps) each.  v0 = 0, and degenerate dynamics (psi NaN: theta = v0 = 0;
# xi = 0; kappa = 0).
QE_STRESS = dict(v0=0.09, kappa=1.0, theta=0.09, xi=1.0, rho=-0.9)
QE_FALLBACKS = (
    (dict(t=1.0), dict(v0=3.0, kappa=1.0, theta=0.09, xi=1.0, rho=0.9), 2),
    (dict(t=4.0), dict(v0=17.0, kappa=1.0, theta=0.09, xi=2.0, rho=0.9), 2),
    (dict(t=20.0), dict(v0=17.0, kappa=1.0, theta=0.09, xi=2.0, rho=0.9), 10),
    (dict(t=4.0), dict(v0=30.0, kappa=1.0, theta=0.09, xi=2.0, rho=0.9), 2))
QE_DEGENERATE = (dict(v0=0.0, theta=0.0), dict(xi=0.0), dict(kappa=0.0))


def qe_edge_cases(timed: bool, kernel: str):
    """The QE kernels' (#12's heston_qe_kernel, #16's QE instantiation)
    cases.  Timed: price_heston's (price_bates's) call at 1M x 100 under the
    demo dynamics, plain and antithetic, the Asian, and the Euler kernel's
    call (qe 0).  Else every payoff Heston prices, plain and antithetic;
    the stress regime (both samplers in a warp) and rho = +0.9 at large v
    (QE_FALLBACKS: the plain-K0 fall-backs), under threefry-13 and -20,
    plain and antithetic; v0 = 0 and the degenerate dynamics; 1, 2 and 453 steps;
    an offset past 2^20 with a bound inside the run; a bound past the last
    path; more paths than the grid's threads; the bullet and the down-and-in
    call at barriers 0, -1, +-inf, NaN and spots 0, -0, -50 (also under a
    barrier of -60, where the spot falls below it as w rises, struck at
    -100), +inf, NaN.
    Under Bates also lam*dt from 0.003 to 17 and kmax 1 to 256, and mu_j,
    sigma_j at +-0, +-inf and NaN (the call and the Asian)."""
    from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    fam = partials_family(kernel)
    n, steps = PARTIALS_MAIN
    if timed:
        return [(f"{fam} qe call anti={anti}", kernel,
                 dict(anti=anti, n=n, steps=steps)) for anti in (False, True)
                ] + [(f"{fam} qe asian_call anti=False", kernel,
                      dict(anti=False, n=n, steps=steps, payoff="asian_call")),
                     (f"{fam} euler call anti=False", kernel,
                      dict(anti=False, n=n, steps=steps, qe=0))]
    e = PARTIALS_EDGE
    out = []

    def add(label, **a):
        out.append((f"{fam} qe {label}", kernel, {"n": e, "steps": steps,
                                                  **a}))

    for name in sorted(set(PAYOFFS) - set(SIGMA_PAYOFFS)):
        for anti in (False, True):
            add(f"{name} anti={anti}", anti=anti, payoff=name,
                option=SPECIAL_OPTIONS.get(name, {}))
    for rounds in (13, 20):
        for anti in (False, True):
            for payoff in ("vanilla_call", "bullet_call", "asian_call"):
                add(f"stress {payoff} r{rounds} anti={anti}", anti=anti,
                    payoff=payoff, rounds=rounds, dyn=QE_STRESS)
            for opt, dyn, st in QE_FALLBACKS:
                add(f"fall-back {opt} {dyn} {st} steps r{rounds} "
                    f"anti={anti}", anti=anti, rounds=rounds, dyn=dyn,
                    option=opt, steps=st)
    for anti in (False, True):
        for dyn in (dict(v0=0.0), dict(QE_STRESS, v0=0.0), *QE_DEGENERATE):
            add(f"{dyn} anti={anti}", anti=anti, dyn=dyn)
        for st in (1, 2, 453):
            add(f"stress asian {st} steps anti={anti}", anti=anti,
                payoff="asian_call", dyn=QE_STRESS, steps=st)
        add(f"offset bound anti={anti}", anti=anti, n=50_001,
            dyn=QE_STRESS, offset=(1 << 20) + 12_345,
            bound=(1 << 20) + 12_345 + 40_000)
        add(f"bound past the end anti={anti}", anti=anti, n=5003, offset=7,
            bound=0xFFFFFFFF)
        add(f"{GRID_PAST} paths anti={anti}", anti=anti, n=GRID_PAST, steps=4)
        for payoff in ("bullet_call", "down_in_call"):
            for fix in (dict(barrier=0.0), dict(barrier=-1.0),
                        dict(barrier=float("inf")),
                        dict(barrier=float("-inf")),
                        dict(barrier=float("nan")), dict(s0=0.0),
                        dict(s0=-0.0), dict(s0=-50.0),
                        dict(s0=-50.0, barrier=-60.0, k=-100.0),
                        dict(s0=float("inf")),
                        dict(s0=float("nan"))):
                add(f"{payoff} {fix} anti={anti}", anti=anti, n=4099,
                    payoff=payoff,
                    option={**SPECIAL_OPTIONS.get(payoff, {}), **fix})
    if kernel != "bates_qe":
        return out
    inf, nan = float("inf"), float("nan")
    for anti in (False, True):
        for lam, kmax in ((0.3, None), (30.0, None), (1700.0, None),
                          (1700.0, 256), (0.3, 1), (0.3, 256)):
            add(f"lam {lam} kmax {kmax} anti={anti}", anti=anti,
                dyn=dict(lam=lam), **({} if kmax is None else dict(kmax=kmax)))
        for jump in (dict(mu_j=0.0, sigma_j=0.0), dict(mu_j=-0.0, sigma_j=-0.0),
                     dict(mu_j=0.0), dict(mu_j=-0.0), dict(mu_j=inf),
                     dict(mu_j=-inf), dict(mu_j=nan), dict(sigma_j=0.0),
                     dict(sigma_j=-0.0), dict(sigma_j=inf),
                     dict(sigma_j=-inf), dict(sigma_j=nan)):
            for payoff in ("vanilla_call", "asian_call"):
                add(f"{payoff} {jump} anti={anti}", anti=anti, n=4099,
                    payoff=payoff, dyn=jump)
    return out


def heston_euler_edge_cases(timed: bool):
    """The Heston Euler kernel's (#12's heston_euler_kernel) cases, through
    mc_heston_partials at qe 0.  Timed: price_heston's call and the bullet
    at 1M x 100, plain and antithetic.  Else every payoff Heston
    prices, plain and antithetic, under threefry-13 and -20; the stress
    regime (v crosses 0); 0, 1, 2, 7 and 453 steps; an offset past 2^20
    with a bound inside the run; a bound past the last path; more paths
    than the grid's threads; the bullet, the up-and-out and the down-and-in
    calls at barriers +-0, -1, +-inf, NaN and spots +-0, -50 (also under a
    barrier of -60, struck at -100), +inf, NaN."""
    from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    n, steps = PARTIALS_MAIN
    if timed:
        return [(f"heston euler {payoff} anti={anti}", "heston_euler",
                 dict(anti=anti, n=n, steps=steps, payoff=payoff))
                for payoff in ("vanilla_call", "bullet_call")
                for anti in (False, True)]
    e = PARTIALS_EDGE
    out = []

    def add(label, **a):
        out.append((f"heston euler {label}", "heston_euler",
                    {"n": e, "steps": steps, **a}))

    inf, nan = float("inf"), float("nan")
    for name in sorted(set(PAYOFFS) - set(SIGMA_PAYOFFS)):
        for rounds in (13, 20):
            for anti in (False, True):
                add(f"{name} r{rounds} anti={anti}", anti=anti, payoff=name,
                    rounds=rounds, option=SPECIAL_OPTIONS.get(name, {}))
    for anti in (False, True):
        for payoff in ("vanilla_call", "bullet_call", "asian_call"):
            add(f"stress {payoff} anti={anti}", anti=anti, payoff=payoff,
                dyn=QE_STRESS, option=SPECIAL_OPTIONS.get(payoff, {}))
            for st in (0, 1, 2, 7, 453):
                add(f"{payoff} {st} steps anti={anti}", anti=anti,
                    payoff=payoff, steps=st, n=4099,
                    option=SPECIAL_OPTIONS.get(payoff, {}))
        add(f"offset bound anti={anti}", anti=anti, n=50_001,
            offset=(1 << 20) + 12_345, bound=(1 << 20) + 12_345 + 40_000)
        add(f"bound past the end anti={anti}", anti=anti, n=5003, offset=7,
            bound=0xFFFFFFFF)
        add(f"{GRID_PAST} paths anti={anti}", anti=anti, n=GRID_PAST, steps=4)
        for payoff in ("bullet_call", "up_out_call", "down_in_call"):
            for fix in (dict(barrier=0.0), dict(barrier=-0.0),
                        dict(barrier=-1.0), dict(barrier=inf),
                        dict(barrier=-inf), dict(barrier=nan), dict(s0=0.0),
                        dict(s0=-0.0), dict(s0=-50.0),
                        dict(s0=-50.0, barrier=-60.0, k=-100.0),
                        dict(s0=inf), dict(s0=nan)):
                add(f"{payoff} {fix} anti={anti}", anti=anti, n=4099,
                    payoff=payoff,
                    option={**SPECIAL_OPTIONS.get(payoff, {}), **fix})
    return out


def partials_inputs(kernel: str, a: dict, dev):
    """(params, key, count) of a --partials case: the packed vector, the
    key price_<family> derives from seed 1234 and the knot count or kmax
    (CEV and the dividends: None)."""
    import dataclasses

    from mc_tpu_torch import engines, rng
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.models import bates as bm
    from mc_tpu_torch.models import cev as cm
    from mc_tpu_torch.models import dividends as dm
    from mc_tpu_torch.models import heston as hm
    from mc_tpu_torch.models import localvol as lm
    from mc_tpu_torch.models import merton as mm

    opt = OptionParams(**a.get("option", {}))
    count = None
    if kernel == "localvol":
        prm = lm.pack_localvol(opt, lv_surface(a["k"], a["steps"]),
                               a["steps"], dev)
        tag, count = lm.LOCALVOL_TAG, a["k"]
    elif kernel == "merton":
        dyn = mm.MertonDynamics(lam=a.get("lam", mm.DEMO_MERTON.lam))
        prm = mm.pack_merton(opt, dyn, a["steps"], dev)
        lam = dyn.lam if a["terminal"] else dyn.lam / a["steps"]
        count = a["kmax"] if "kmax" in a else mm.poisson_kmax(lam)
        tag = mm.MERTON_TAG
    elif kernel == "cev":
        dyn = dataclasses.replace(cm.DEMO_CEV, **a.get("dyn", {}))
        prm = cm.pack_cev(opt, dyn, a["steps"], dev)
        tag = cm.CEV_TAG
    elif kernel in ("heston_qe", "heston_euler"):
        dyn = dataclasses.replace(hm.DEMO_HESTON, **a.get("dyn", {}))
        prm = hm.pack_heston(opt, dyn, a["steps"], dev)
        tag = hm.HESTON_TAG
    elif kernel == "bates_qe":
        dyn = dataclasses.replace(bm.DEMO_BATES, **a.get("dyn", {}))
        prm = bm.pack_bates(opt, dyn, a["steps"], dev)
        count = a.get("kmax") or mm.poisson_kmax(
            float(dyn.lam) * float(opt.t) / a["steps"])
        tag = bm.BATES_TAG
    else:
        prm = dm.pack_divs(opt, divs_schedules(a["steps"])[a["sched"]],
                           a["steps"], dev)
        tag = dm.DIVS_TAG
    key = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER,
                                                tag))
    return prm, key, count


def run_partials(lib, tiles, kernel: str, a: dict, inputs, n_paths=None):
    """(partials, ms) of one partials call of ``kernel``."""
    prm, (k0, k1), count = inputs
    n = n_paths or a["n"]
    offset = a.get("offset", 0)
    bound = a.get("bound", offset + n)
    n_blocks = min(-(-n // tiles[kernel]), 8192)
    part = torch.empty((n_blocks, 2), dtype=torch.float64, device=prm.device)
    pid = _payoff_id(a.get("payoff", "vanilla_call"))
    rounds, anti = a.get("rounds", 13), int(a["anti"])
    stream = torch.cuda.current_stream().cuda_stream
    t = _events()
    if kernel == "localvol":
        st = lib.mc_localvol_partials(pid, rounds, anti, k0, k1, prm.data_ptr(),
                                      count, a["steps"], n, offset, bound,
                                      part.data_ptr(), n_blocks, stream)
    elif kernel == "merton":
        st = lib.mc_merton_partials(pid, int(a["terminal"]), rounds, anti, k0,
                                    k1, prm.data_ptr(), count, a["steps"], n,
                                    offset, bound, part.data_ptr(), n_blocks,
                                    stream)
    elif kernel in ("heston_qe", "heston_euler"):
        qe = a.get("qe", int(kernel == "heston_qe"))
        st = lib.mc_heston_partials(pid, qe, rounds, anti, k0, k1,
                                    prm.data_ptr(), a["steps"], n, offset,
                                    bound, part.data_ptr(), n_blocks, stream)
    elif kernel == "bates_qe":
        st = lib.mc_bates_partials(pid, a.get("qe", 1), rounds, anti, k0, k1,
                                   prm.data_ptr(), count, a["steps"], n,
                                   offset, bound, part.data_ptr(), n_blocks,
                                   stream)
    else:
        st = getattr(lib, f"mc_{kernel}_partials")(
            pid, anti, k0, k1, prm.data_ptr(), a["steps"], n, offset, bound,
            part.data_ptr(), n_blocks, stream)
    t.append(_event())
    _check(st, f"{kernel}_partials")
    torch.cuda.synchronize()
    return part, t[0].elapsed_time(t[1])


# The VanillaCall threefry-13 kernels the partials probe lists (CEV and
# the dividends have no rounds parameter).
PARTIALS_ENTRIES = {
    "localvol": r"24localvol_partials_kernelINS_11VanillaCallE.*Li13E",
    "merton": r"22merton_partials_kernelINS_11VanillaCallE.*Li13E",
    "cev": r"19cev_partials_kernelINS_11VanillaCallE",
    "divs": r"20divs_partials_kernelINS_11VanillaCallE",
    # the QE kernel and, beside it, the family's Euler kernel
    "heston_qe": r"(16heston_qe|19heston_euler)_kernelINS_11VanillaCallE.*Li13E",
    "bates_qe": r"(21bates_partials_kernelINS_11VanillaCallENS_\d+Bates(Qe|Euler)"
                r"|15bates_qe_kernelINS_11VanillaCallE).*Li13E",
    # the Euler kernel (one, or a plain and an antithetic one) and the
    # bullet's, whose barrier legs test w against the block's threshold
    "heston_euler": r"19heston_euler_kernelINS_(11VanillaCall|10BulletCall)E.*Li13E"}


def cev_logf_check(lib, dev) -> dict:
    """The library's mc_cev_logf_check: the floats of [1e-12, FLT_MAX] and
    +inf on which the CEV step's logf is not the toolkit's, and the
    first."""
    bad = torch.tensor([0, -1], dtype=torch.int64, device=dev)
    _check(lib.mc_cev_logf_check(bad.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream),
           "mc_cev_logf_check")
    n_bad, first = (int(x) for x in bad.tolist())
    return dict(mismatches=n_bad, first=hex(first) if n_bad else None)


def partials_main(args, variants, card) -> dict:
    """The --partials probe: resources, SASS, the bitwise edges and the
    times of the local-vol (#19), Merton (#14), CEV (#18) and dividend
    (#22) partials kernels (``--kernels``: a subset)."""
    kernels = args.kernels or PARTIALS_KERNELS
    libs = build(variants, "partials", kernels)
    dev = torch.device("cuda")
    report = {"card": card, "variants": {}}
    bound = {}
    want = re.compile("|".join(PARTIALS_ENTRIES[k] for k in kernels))
    for label, src, defines in variants:
        lib_path, logs = libs[label]
        lib, tiles = bind_partials(lib_path, kernels)
        bound[label] = (lib, tiles)
        rows = kernel_rows(args, label, lib_path, logs, want, card)
        layout = partials_layout(lib, kernels)
        print(f"probe {label}: partials layout (VanillaCall) tiles {tiles} "
              f"{layout} {card}", flush=True)
        report["variants"][label] = dict(src=str(src), defines=defines,
                                         kernels=rows, layout=layout,
                                         tiles=tiles, ptxas=logs)
        if "cev" in kernels and hasattr(lib, "mc_cev_logf_check"):
            chk = cev_logf_check(lib, dev)
            report["variants"][label]["cev_logf_check"] = chk
            print(f"probe {label}: mc_cev_logf_check {chk} {card}", flush=True)
            if chk["mismatches"]:
                print(f"FAIL: {label}'s CEV logf is not the toolkit's",
                      flush=True)
    order = list(bound) + list(bound)[::-1]
    # the bitwise edges: once per variant, each against the first's
    edges, bad = {}, 0
    for case, kernel, a in partials_cases(False, kernels):
        inputs = partials_inputs(kernel, a, dev)
        ref = None
        for label in bound:
            lib, tiles = bound[label]
            part, _ = run_partials(lib, tiles, kernel, a, inputs)
            ref = part if ref is None else ref
            same = same_bits(part, ref)
            edges.setdefault(case, {})[label] = same
            if not same:
                bad += 1
                print(f"FAIL: {case} {label} disagrees with "
                      f"{next(iter(bound))}", flush=True)
    print(f"probe edges: {len(edges)} cases x {len(bound)} variants, "
          f"{bad} disagree {card}", flush=True)
    report["edges"] = edges
    if args.time:
        times = {}
        for case, kernel, a in partials_cases(True, kernels):
            inputs = partials_inputs(kernel, a, dev)
            ref = None
            for label in order:
                lib, tiles = bound[label]
                run_partials(lib, tiles, kernel, a, inputs, PARTIALS_WARM)
                part, ms = run_partials(lib, tiles, kernel, a, inputs)
                ref = part if ref is None else ref
                same = same_bits(part, ref)
                times.setdefault(case, {}).setdefault(label, []).append(
                    dict(ms=ms, bitwise=same))
                print(f"probe time {case} {a['n']}x{a['steps']} {label}: "
                      f"{ms:.4f} ms, partials bitwise vs {order[0]}: {same} "
                      f"{card}", flush=True)
                if not same:
                    print(f"FAIL: {case} {label} disagrees", flush=True)
        report["times"] = times
    return report


# --- the SABR partials kernel (--sabr) ----------------------------------------

SABR_MAIN = (1_000_000, 100)  # paths, steps: price_sabr's kernel (phase 5)
SABR_WARM = 4096
SABR_EDGE = 16_411            # the bitwise cases' paths: a ragged block
# A csrc that predates mc_sabr_occupancy (one path a thread, no unit-beta
# instantiations): this unit adds it, for VanillaCall at threefry-13.
SABR_SHIM = """#include "{src}/sabr_kernels.cu"

extern "C" int mc_sabr_occupancy(int unit_beta, int antithetic, int* blocks) {{
  (void)unit_beta; (void)antithetic;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mc::sabr_partials_kernel<mc::VanillaCall, 13>, mc_sabr_block_threads(), 0);
}}
"""
# The entry point before the unit-beta argument (an older commit's csrc).
_OLD_SABR_ABI = [_int, _int, _int, _u32, _u32, _ptr, _int, _u32, _u32, _u32,
                 _ptr, _int, _ptr]


def sabr_sources(src: Path, out: Path):
    """The SABR partials sources of ``src`` (``sabr_kernels.cu`` and each
    ``sabr<N>_kernels.cu``), through a shim where the source has no
    occupancy entry point."""
    main = src / "sabr_kernels.cu"
    if "mc_sabr_occupancy" in main.read_text():
        return [main, *src.glob("sabr[0-9]*_kernels.cu")]
    unit = out / "sabr_probe.cu"
    unit.write_text(SABR_SHIM.format(src=src))
    return [unit]


def bind_sabr(lib_path: Path):
    """(library, new ABI, paths a block): the SABR partials entry point,
    with the unit-beta argument where the library exports its paths a block
    (``mc_sabr_block_paths``) and as it was before where it does not."""
    from mc_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    new_abi = hasattr(lib, "mc_sabr_block_paths")
    fn = lib.mc_sabr_partials
    fn.argtypes = (_cuda._SIGNATURES["mc_sabr_partials"][0] if new_abi
                   else _OLD_SABR_ABI)
    fn.restype = _int
    tile = lib.mc_sabr_block_paths if new_abi else lib.mc_sabr_block_threads
    tile.argtypes, tile.restype = [], _int
    lib.mc_sabr_occupancy.argtypes = [_int, _int, ctypes.POINTER(ctypes.c_int)]
    lib.mc_sabr_occupancy.restype = _int
    if hasattr(lib, "mc_sabr_paths_per_thread"):
        lib.mc_sabr_paths_per_thread.argtypes = []
        lib.mc_sabr_paths_per_thread.restype = _int
    return lib, new_abi, tile()


def sabr_cases(timed: bool):
    """The --sabr cases: (label, arguments).  Timed: price_sabr's call at
    1M x 100 under the demo dynamics (beta = 1) and beta = 0.5, plain and
    antithetic, the bullet and the Asian at beta = 1, and (``general``) the
    beta = 1 call through the general-beta kernel.  Else the bitwise edges:
    every payoff at beta 1 and 0.5, plain and antithetic; threefry-20; an
    offset and a bound; 1, 2 and 7 steps; more paths than the grid's
    threads; and at beta = 1 the edges of the step (alpha 0, -0, 1e19,
    inf, NaN; a forward of 0, 1e38, inf, NaN; nu 0 and 60; rho +-1) and of
    the barrier test (barriers 0, -1, +-inf, NaN)."""
    from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    n, steps = SABR_MAIN
    if timed:
        out = []
        for beta in (1.0, 0.5):
            for anti in (False, True):
                out.append((f"sabr call beta={beta} anti={anti}",
                            dict(beta=beta, anti=anti, n=n, steps=steps)))
        for payoff in ("bullet_call", "asian_call"):
            out.append((f"sabr {payoff} beta=1.0 anti=False",
                        dict(beta=1.0, anti=False, n=n, steps=steps,
                             payoff=payoff)))
        for anti in (False, True):
            out.append((f"sabr call beta=1.0 anti={anti} general",
                        dict(beta=1.0, anti=anti, n=n, steps=steps,
                             general=True)))
        return out
    e = SABR_EDGE
    out = []
    for name in sorted(set(PAYOFFS) - set(SIGMA_PAYOFFS)):
        for beta in (1.0, 0.5):
            for anti in (False, True):
                out.append((f"sabr {name} beta={beta} anti={anti}",
                            dict(beta=beta, anti=anti, n=e, steps=steps,
                                 payoff=name,
                                 option=SPECIAL_OPTIONS.get(name, {}))))
    for beta in (1.0, 0.5):
        for anti in (False, True):
            for payoff in ("vanilla_call", "bullet_call", "asian_call"):
                out.append((f"sabr {payoff} beta={beta} anti={anti} "
                            f"rounds=20", dict(beta=beta, anti=anti, n=e,
                                               steps=steps, payoff=payoff,
                                               rounds=20)))
            out.append((f"sabr beta={beta} anti={anti} offset bound",
                        dict(beta=beta, anti=anti, n=50_001, steps=steps,
                             offset=12_345, bound=12_345 + 40_000)))
            for st in (1, 2, 7):
                out.append((f"sabr bullet beta={beta} anti={anti} {st} steps",
                            dict(beta=beta, anti=anti, n=e, steps=st,
                                 payoff="bullet_call")))
            out.append((f"sabr beta={beta} anti={anti} 2^21+4099 paths",
                        dict(beta=beta, anti=anti, n=(1 << 21) + 4099,
                             steps=4)))
    dyn_edges = [dict(alpha=0.0), dict(alpha=-0.0), dict(alpha=1e19),
                 dict(alpha=float("inf")), dict(alpha=float("nan")),
                 dict(nu=0.0), dict(nu=60.0), dict(rho=1.0),
                 dict(rho=-1.0)]
    opt_edges = [dict(s0=0.0), dict(s0=1e38), dict(s0=float("inf")),
                 dict(s0=float("nan")), dict(barrier=0.0),
                 dict(barrier=-1.0), dict(barrier=float("inf")),
                 dict(barrier=float("-inf")), dict(barrier=float("nan"))]
    for fix in dyn_edges + opt_edges:
        for payoff in ("vanilla_call", "bullet_call", "up_out_call",
                       "down_in_call", "asian_call"):
            for anti in (False, True):
                dyn = {k: v for k, v in fix.items() if k in ("alpha", "nu",
                                                             "rho")}
                opt = {k: v for k, v in fix.items() if k not in dyn}
                out.append((f"sabr {payoff} beta=1 {fix} anti={anti}",
                            dict(beta=1.0, anti=anti, n=4099, steps=steps,
                                 payoff=payoff, option=opt, dyn=dyn)))
    return out


def sabr_inputs(a: dict, dev):
    """(params, key, unit beta) of a --sabr case: the packed vector of the
    demo option and dynamics at the case's beta (and its option and
    dynamics fields), the key price_sabr derives from seed 1234."""
    import dataclasses

    from mc_tpu_torch import engines, rng
    from mc_tpu_torch.config import OptionParams
    from mc_tpu_torch.models import sabr as sm

    dyn = dataclasses.replace(sm.DEMO_SABR, beta=a["beta"], **a.get("dyn", {}))
    prm = sm.pack_sabr(OptionParams(**a.get("option", {})), dyn, a["steps"],
                       dev)
    key = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER,
                                                sm.SABR_TAG))
    unit = float(np.float32(dyn.beta)) == 1.0 and not a.get("general")
    return prm, key, unit


def run_sabr(lib, new_abi: bool, tile: int, a: dict, inputs, n_paths=None):
    """(partials, ms) of one SABR partials call."""
    prm, (k0, k1), unit = inputs
    n = n_paths or a["n"]
    offset = a.get("offset", 0)
    bound = a.get("bound", offset + n)
    n_blocks = min(-(-n // tile), 8192)
    part = torch.empty((n_blocks, 2), dtype=torch.float64, device=prm.device)
    head = (_payoff_id(a.get("payoff", "vanilla_call")), a.get("rounds", 13),
            int(a["anti"]))
    if new_abi:
        head += (int(unit),)
    stream = torch.cuda.current_stream().cuda_stream
    t = _events()
    st = lib.mc_sabr_partials(*head, k0, k1, prm.data_ptr(), a["steps"], n,
                              offset, bound, part.data_ptr(), n_blocks, stream)
    t.append(_event())
    _check(st, "sabr_partials")
    torch.cuda.synchronize()
    return part, t[0].elapsed_time(t[1])


def mufu_kinds(ins, loop) -> dict:
    """The MUFU instructions of ``loop`` (a sass_loops entry) by function."""
    lo, hi = int(loop["start"], 16), int(loop["end"], 16)
    kinds = {}
    for addr, op, _, _ in ins:
        if lo <= addr <= hi and op.startswith("MUFU"):
            kinds[op] = kinds.get(op, 0) + 1
    return kinds


def sabr_main(args, variants, card) -> dict:
    """The --sabr probe: resources, SASS, the bitwise edges and the times
    of the SABR partials kernel (#17)."""
    libs = build(variants, "sabr")
    dev = torch.device("cuda")
    report = {"card": card, "variants": {}}
    bound = {}
    want = re.compile(r"20sabr_partials_kernelINS_(11VanillaCall|10BulletCall)"
                      r"ELi13E")
    for label, src, defines in variants:
        lib_path, logs = libs[label]
        lib, new_abi, tile = bind_sabr(lib_path)
        bound[label] = (lib, new_abi, tile)
        rows = kernel_rows(args, label, lib_path, logs, want, card)
        layout = {}
        for unit in (0, 1):
            for anti in (0, 1):
                blocks = ctypes.c_int(0)
                st = lib.mc_sabr_occupancy(unit, anti, ctypes.byref(blocks))
                row = dict(blocks_per_sm=blocks.value if st == 0 else None)
                if hasattr(lib, "mc_sabr_paths_per_thread"):
                    row["paths_a_thread"] = lib.mc_sabr_paths_per_thread()
                layout[f"unit_beta={unit} anti={anti}"] = row
        print(f"probe {label}: sabr layout (VanillaCall) paths a block "
              f"{tile} {layout} {card}", flush=True)
        report["variants"][label] = dict(src=str(src), defines=defines,
                                         kernels=rows, layout=layout,
                                         tile=tile, ptxas=logs)
    order = list(bound) + list(bound)[::-1]
    edges, bad = {}, 0
    for case, a in sabr_cases(timed=False):
        inputs = sabr_inputs(a, dev)
        ref = None
        for label in bound:
            part, _ = run_sabr(*bound[label], a, inputs)
            ref = part if ref is None else ref
            same = same_bits(part, ref)
            edges.setdefault(case, {})[label] = same
            if not same:
                bad += 1
                print(f"FAIL: {case} {label} disagrees with "
                      f"{next(iter(bound))}", flush=True)
    print(f"probe sabr edges: {len(edges)} cases x {len(bound)} variants, "
          f"{bad} disagree {card}", flush=True)
    report["edges"] = edges
    if args.time:
        times, refs = {}, {}
        for case, a in sabr_cases(timed=True):
            inputs = sabr_inputs(a, dev)
            # the general-beta kernel's call against the first variant's
            same_as = (a["beta"], a["anti"], a.get("payoff"))
            for label in order:
                lib, new_abi, tile = bound[label]
                if a.get("general") and not new_abi:
                    continue
                run_sabr(lib, new_abi, tile, a, inputs, SABR_WARM)
                part, ms = run_sabr(lib, new_abi, tile, a, inputs)
                same = same_bits(part, refs.setdefault(same_as, part))
                times.setdefault(case, {}).setdefault(label, []).append(
                    dict(ms=ms, bitwise=same))
                print(f"probe time {case} {a['n']}x{a['steps']} {label}: "
                      f"{ms:.4f} ms, partials bitwise vs the first: {same} "
                      f"{card}", flush=True)
                if not same:
                    print(f"FAIL: {case} {label} disagrees", flush=True)
        report["times"] = times
    return report



# --- the rates kernel (#11, --rates) -----------------------------------------

RATES_TILES = ("va", "hw", "hw_mc", "g2", "g2_mc")
RATES_STRUCTS = {"va": "VaSwpt", "hw": "HwSwpt", "hw_mc": "HwSwptMc",
                 "g2": "G2Swpt", "g2_mc": "G2SwptMc"}
RATES_MAIN = 1 << 20           # mc_tpu's default n_paths for every price_*
RATES_BIG = 1 << 24            # chip_smoke.py's RATES_BIG
RATES_TIMED = ((RATES_MAIN, 10), (RATES_BIG, 10), (RATES_MAIN, 60))
RATES_EDGE_PATHS = (1, 255, 256, 257, 100_001)
RATES_EDGE_N = (1, 2, 3, 10, 60)
# chip_smoke.py's RATES_OFFSET (paths, path_offset, bound), ids that wrap
# past 2^32, and a bound past the last path (a lane past the end adds zeros)
RATES_OFFSETS = ((500_000, 1_234_567, 1_234_567 + 499_000),
                 (5_000, (1 << 32) - 1_000, (1 << 32) - 1),
                 (5_003, 7, 0xFFFFFFFF))
# The staging cap's stand-in where no variant exports one (an older csrc).
RATES_CAP_DEFAULT = 512
# A csrc that predates mc_rates_occupancy (one path a thread, the pack read
# in place): this unit adds it (n_pay ignored).
RATES_SHIM = """#include "{src}/rates_kernels.cu"

template <class T>
static int probe_rates_occupancy(int* blocks) {{
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mc::rates_partials_kernel<T>,
                                                       mc::kRatesThreads, 0);
}}

extern "C" int mc_rates_occupancy(int tile, int n_pay, int* blocks) {{
  (void)n_pay;
  switch (tile) {{
    case 0: return probe_rates_occupancy<mc::VaSwpt>(blocks);
    case 1: return probe_rates_occupancy<mc::HwSwpt>(blocks);
    case 2: return probe_rates_occupancy<mc::HwSwptMc>(blocks);
    case 3: return probe_rates_occupancy<mc::G2Swpt>(blocks);
    case 4: return probe_rates_occupancy<mc::G2SwptMc>(blocks);
    default: return cudaErrorInvalidValue;
  }}
}}
"""

def rates_sources(src: Path, out: Path):
    """``rates_kernels.cu`` of ``src``, through RATES_SHIM where it does not
    export ``mc_rates_occupancy``."""
    main = src / "rates_kernels.cu"
    if "mc_rates_occupancy" in main.read_text():
        return [main]
    unit = out / "rates_probe.cu"
    unit.write_text(RATES_SHIM.format(src=src))
    return [unit]


def bind_rates(lib_path: Path):
    """(library, new ABI): the rates entry points, and whether the library
    exports its paths a thread and staging cap (``mc_rates_paths_per_thread``;
    an older csrc does not).  The library picks the staged or in-place path
    by n itself."""
    from mc_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    new_abi = hasattr(lib, "mc_rates_paths_per_thread")
    for name in ("mc_rates_partials", "mc_rates_occupancy"):
        getattr(lib, name).argtypes, getattr(lib, name).restype = (
            _cuda._SIGNATURES[name])
    for name in ("mc_rates_paths_per_thread", "mc_rates_stage_payments"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes, getattr(lib, name).restype = [], _int
    return lib, new_abi


def rates_cap(bound) -> int:
    """The largest staging cap a variant exports (a variant with the cap
    set to 0, the tables in place at every n, among them)."""
    caps = [lib.mc_rates_stage_payments() for lib, new_abi in bound.values()
            if new_abi]
    return max(caps, default=RATES_CAP_DEFAULT)


def rates_real_pack(tile: str, n_pay: int, payer: bool, dev):
    """(pv, key) price_<model>() hands #11 on the demo specs (the multi-curve
    tiles at a 25 bp projection spread): chip_smoke.py's rates_pack."""
    import mc_tpu_torch as mt
    from mc_tpu_torch import rng
    from mc_tpu_torch.models import g2pp, hullwhite, swaption

    spec = mt.SwaptionSpec(n_payments=n_pay, payer=payer)
    proj = (mt.DiscountCurve(mt.DEMO_CURVE.times, mt.DEMO_CURVE.zeros + 0.0025)
            if tile.endswith("_mc") else None)
    if tile == "va":
        d = mt.DEMO_VASICEK.as_f32()
        pv = swaption.pack_va_swpt(spec, d.a, d.b, d.sigma_r, 0.05, dev)
        tag = swaption.SWAPTION_TAG
    elif tile.startswith("hw"):
        pv = hullwhite.pack_hw_swpt(
            mt.DEMO_HW.a, mt.DEMO_HW.sigma_r, spec,
            *hullwhite.hw_tables(spec, mt.DEMO_HW, mt.DEMO_CURVE), dev)
        tag = hullwhite.HW_TAG
    else:
        pv = g2pp.pack_g2_swpt(spec, mt.DEMO_G2, g2pp.g2_tables(
            spec, mt.DEMO_G2, mt.DEMO_CURVE), dev)
        tag = g2pp.G2_TAG
    if proj is not None:
        pv = hullwhite.pack_multicurve(pv, *hullwhite.hw_mc_weights(
            spec, mt.DEMO_CURVE, proj))
    return pv.contiguous(), tuple(int(k) for k in rng.derive_key(1234, 0, tag))


def rates_synthetic_pack(tile: str, n: int, seed: int, payer: bool,
                         special=None):
    """A pack of ``tile`` at ``n`` payments from default_rng(seed), each
    field in a plausible range (numpy f32; the layout of csrc/rates.cuh).
    ``special``: "inf" (an entry of a middle payment +inf), "nan" (an entry
    of the last payment NaN) or "overflow" (a middle bond's expf to +inf)."""
    g = np.random.default_rng(seed)
    u = g.uniform
    sign = 1.0 if payer else -1.0
    if tile == "va":
        head = [u(-0.05, 0.05), u(0.5, 1.0), u(0.0, 5.0), u(0.005, 0.02),
                u(0.0, 0.05), u(0.0, 0.02), u(0.0, 0.2), u(0.0, 0.05), sign,
                u(0.0, 0.08)]
        tables = [u(-2.0, 0.0, n), u(0.0, 20.0, n)]
    elif tile.startswith("hw"):
        head = [u(0.005, 0.02), u(0.0, 0.05), u(0.0, 0.02), u(0.5, 1.0),
                u(0.0, 0.01), u(0.0, 0.05), sign]
        tables = [u(0.3, 1.0, n), u(0.0, 20.0, n), u(0.0, 0.05, n)]
    else:
        head = [u(0.005, 0.02), u(0.0, 0.02), u(0.005, 0.02), u(0.0, 0.02),
                u(0.0, 0.02), u(0.005, 0.02), u(0.5, 1.0), u(0.0, 0.01),
                u(0.0, 0.05), sign]
        tables = [u(0.3, 1.0, n), u(-0.01, 0.01, n), u(0.0, 20.0, n),
                  u(0.0, 20.0, n)]
    if special == "inf":
        tables[1][n // 2] = np.inf
    elif special == "nan":
        tables[0][n - 1] = np.nan
    elif special == "overflow":  # the bond's exponent past log(FLT_MAX)
        if tile == "va":
            tables[0][n // 2] = 200.0
        elif tile.startswith("hw"):
            tables[2][n // 2] = -200.0
        else:
            tables[1][n // 2] = 200.0
    parts = [np.asarray(head), *tables]
    if tile.endswith("_mc"):
        parts += [np.asarray([u(-1.0, 1.0)]), u(-0.2, 0.2, n)]
    return np.concatenate(parts).astype(np.float32)


def rates_cases(timed: bool, cap: int):
    """The --rates cases: (label, tile, arguments).  Timed: each tile at
    RATES_TIMED on the demo packs, payer, and at 2^20 paths with ``cap``
    payments on a synthetic pack (a variant whose cap is 0 times the
    tables read in place at every n).  Else every tile,
    payer and receiver, at n = 1, 2, 3, 10, 60, the cap and one past it on
    synthetic packs over 1, 255, 256, 257 and 100,001 paths; the demo packs
    at n = 10 and 60; RATES_OFFSETS; a pack with a +inf entry, one with a NaN
    entry and one whose bond overflows expf, at n = 10 and past the cap;
    and 2^24 paths at n = 10."""
    out = []
    if timed:
        for tile in RATES_TILES:
            for n_paths, n_pay in RATES_TIMED:
                out.append((f"rates {tile} {n_paths} paths n={n_pay}", tile,
                            dict(n_paths=n_paths, n=n_pay, real=True)))
            out.append((f"rates {tile} {RATES_MAIN} paths n={cap}", tile,
                        dict(n_paths=RATES_MAIN, n=cap, seed=7)))
        return out
    seed = 0
    for tile in RATES_TILES:
        for payer in (True, False):
            for n in (*RATES_EDGE_N, cap, cap + 1):
                for n_paths in RATES_EDGE_PATHS:
                    seed += 1
                    out.append((f"rates {tile} payer={payer} n={n} "
                                f"{n_paths} paths", tile,
                                dict(n_paths=n_paths, n=n, seed=seed,
                                     payer=payer)))
            for n in (10, 60):
                out.append((f"rates {tile} payer={payer} n={n} demo", tile,
                            dict(n_paths=100_001, n=n, real=True,
                                 payer=payer)))
            for n_paths, offset, bnd in RATES_OFFSETS:
                out.append((f"rates {tile} payer={payer} offset {offset} "
                            f"bound {bnd}", tile,
                            dict(n_paths=n_paths, n=10, real=True,
                                 payer=payer, offset=offset, bound=bnd)))
        for special in ("inf", "nan", "overflow"):
            for n in (10, cap + 1):
                seed += 1
                out.append((f"rates {tile} {special} n={n}", tile,
                            dict(n_paths=4099, n=n, seed=seed,
                                 special=special)))
        out.append((f"rates {tile} {RATES_BIG} paths n=10", tile,
                    dict(n_paths=RATES_BIG, n=10, real=True)))
    return out


def rates_inputs(tile: str, a: dict, dev):
    """(pv, key) of a --rates case."""
    if a.get("real"):
        return rates_real_pack(tile, a["n"], a.get("payer", True), dev)
    pv = rates_synthetic_pack(tile, a["n"], a["seed"], a.get("payer", True),
                              a.get("special"))
    return torch.from_numpy(pv).to(dev), (0x1234ABCD, 0x5A97 + a["seed"])


def run_rates(lib, tile: str, a: dict, inputs, n_paths=None,
              batch: int = 1):
    """(partials, ms) of ``batch`` back-to-back rates calls through ``lib``
    (ms: a call's share of the events' span)."""
    from mc_tpu_torch.ops import fused

    pv, (k0, k1) = inputs
    n = n_paths or a["n_paths"]
    offset = a.get("offset", 0)
    bnd = a.get("bound", (offset + n) & 0xFFFFFFFF)
    n_blocks = min(-(-n // 256), 8192)
    part = torch.empty((n_blocks, 2), dtype=torch.float64, device=pv.device)
    args = (fused.TILES[tile].cuda_id, a["n"], k0, k1, pv.data_ptr(), n, offset, bnd, part.data_ptr(),
            n_blocks, torch.cuda.current_stream().cuda_stream)
    t = _events()
    for _ in range(batch):
        _check(lib.mc_rates_partials(*args), f"rates_partials {tile}")
    t.append(_event())
    torch.cuda.synchronize()
    return part, t[0].elapsed_time(t[1]) / batch


def rates_main(args, variants, card) -> dict:
    """The --rates probe: resources, blocks per SM, SASS, the bitwise edges
    and the times of the rates kernel (#11)."""
    libs = build(variants, "rates")
    dev = torch.device("cuda")
    report = {"card": card, "variants": {}}
    bound = {}
    want = re.compile(r"21rates_partials_kernelINS_\d+(VaSwpt|HwSwpt|HwSwptMc|"
                      r"G2Swpt|G2SwptMc)E")
    for label, src, defines in variants:
        lib_path, logs = libs[label]
        lib, new_abi = bind_rates(lib_path)
        bound[label] = (lib, new_abi)
        rows = kernel_rows(args, label, lib_path, logs, want, card)
        layout = {}
        for tile in RATES_TILES:
            for n_pay in (10, 60, RATES_CAP_DEFAULT + 1):
                blocks = ctypes.c_int(0)
                st = lib.mc_rates_occupancy(RATES_TILES.index(tile), n_pay,
                                            ctypes.byref(blocks))
                layout[f"{tile} n={n_pay}"] = (blocks.value if st == 0
                                               else None)
        if new_abi:
            layout.update(paths_a_thread=lib.mc_rates_paths_per_thread(),
                          stage_payments=lib.mc_rates_stage_payments())
        print(f"probe {label}: rates layout (blocks/SM) {layout} {card}",
              flush=True)
        report["variants"][label] = dict(src=str(src), defines=defines,
                                         kernels=rows, layout=layout,
                                         ptxas=logs)
    cap = rates_cap(bound)
    order = list(bound) + list(bound)[::-1]
    edges, bad = {}, 0
    for case, tile, a in rates_cases(False, cap):
        inputs = rates_inputs(tile, a, dev)
        ref = None
        for label in bound:
            part, _ = run_rates(bound[label][0], tile, a, inputs)
            ref = part if ref is None else ref
            same = same_bits(part, ref)
            edges.setdefault(case, {})[label] = same
            if not same:
                bad += 1
                print(f"FAIL: {case} {label} disagrees with "
                      f"{next(iter(bound))}", flush=True)
    print(f"probe rates edges: {len(edges)} cases x {len(bound)} variants, "
          f"{bad} disagree {card}", flush=True)
    report["edges"] = edges
    if args.time:
        times, refs = {}, {}
        for case, tile, a in rates_cases(True, cap):
            inputs = rates_inputs(tile, a, dev)
            for label in order:
                lib = bound[label][0]
                run_rates(lib, tile, a, inputs, 4096)
                part, first = run_rates(lib, tile, a, inputs)
                batch = max(1, int(np.ceil(5.0 / max(first, 1e-3))))
                _, ms = run_rates(lib, tile, a, inputs, batch=batch)
                same = same_bits(part, refs.setdefault(
                    (tile, a["n_paths"], a["n"]), part))
                times.setdefault(case, {}).setdefault(label, []).append(
                    dict(ms=ms, single_ms=first, batch=batch, bitwise=same))
                print(f"probe time {case} {label}: {ms:.5f} ms a call in a "
                      f"batch of {batch} (one call alone {first:.5f}), "
                      f"partials bitwise vs the first: {same} {card}",
                      flush=True)
                if not same:
                    print(f"FAIL: {case} {label} disagrees", flush=True)
        report["times"] = times
    return report


# --- host-owned rows (--wrappers) --------------------------------------------

WRAP_REPS = 21
WRAP_BATCH_MS = 5.0


def wrappers_main(args, card) -> dict:
    """The --wrappers probe: the host-owned rows of the package at DIR."""
    import statistics

    import mc_tpu_torch as mt
    from mc_tpu_torch.models import basket as bm
    from mc_tpu_torch.models import fx
    from mc_tpu_torch.models import rainbow as rb
    from mc_tpu_torch.ops import _cuda, fused
    from mc_tpu_torch.ops import path_kernels as pk
    from mc_tpu_torch.ops.payoffs import get_payoff

    root = Path(args.wrappers).resolve()
    if root not in Path(mt.__file__).resolve().parents:
        raise SystemExit(f"mc_tpu_torch came from {mt.__file__}, not {root}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _cuda.load()
    load_s = time.perf_counter() - t0

    def batch_ms(fn):
        """(device ms, host ms) a call: CUDA events and the host clock over
        a batch of back-to-back calls, the host's read before the batch's
        synchronize; medians of WRAP_REPS batches."""
        fn()
        torch.cuda.synchronize()
        start = _event()
        fn()
        end = _event()
        torch.cuda.synchronize()
        n = max(1, int(np.ceil(WRAP_BATCH_MS / max(start.elapsed_time(end),
                                                   1e-3))))
        dev_ms, host_ms = [], []
        for _ in range(WRAP_REPS):
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            start = _event()
            for _ in range(n):
                fn()
            end = _event()
            h1 = time.perf_counter()
            torch.cuda.synchronize()
            dev_ms.append(start.elapsed_time(end) / n)
            host_ms.append((h1 - h0) * 1e3 / n)
        return statistics.median(dev_ms), statistics.median(host_ms), n

    def e2e_ms(fn):
        fn()
        secs = []
        for _ in range(WRAP_REPS):
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - h0)
        return statistics.median(secs) * 1e3, min(secs) * 1e3, max(secs) * 1e3

    rows = {}
    n_tp = 1_000_000
    call = get_payoff("vanilla_call")
    cfg = pk.KernelConfig(n_paths=n_tp // 2, n_steps=100, method="terminal")
    params = pk.pack_params(mt.DEMO_OPTION, 100, dev)
    key = (0x1234ABCD, 0x5A97)
    rows[f"terminal_pair {n_tp} paths"] = batch_ms(
        lambda: pk.terminal_pair_partials(call, cfg, key, params, n_tp))
    for tile in RATES_TILES:
        pv, k = rates_real_pack(tile, 10, True, dev)
        rows[f"rates_partials {tile} {RATES_MAIN} paths n=10"] = batch_ms(
            lambda pv=pv, k=k, tile=tile: fused.fused_moment_partials(
                tile, 10, k, pv, RATES_MAIN))
    fx_cfg = fx.FXConfig(n_paths=n_tp)
    fx_prm = fx.pack_fx(mt.DEMO_OPTION, fx.DEMO_FX, dev)
    rows[f"fx_partials quanto_call {n_tp} paths"] = batch_ms(
        lambda: fx.fx_partials("quanto_call", fx_cfg, key, fx_prm))
    grid_cfg = bm.BasketConfig(n_paths=BASKET_GRID[0], n_steps=BASKET_GRID[1],
                               d=4)
    grid_prm = bm.pack_basket(mt.DEMO_OPTION, bm.DEMO_BASKET, BASKET_GRID[1],
                              dev)
    rows[f"basket_trajectories call d=4 {BASKET_GRID[0]}x{BASKET_GRID[1]}"] = \
        batch_ms(lambda: bm.basket_trajectories(call, grid_cfg, key, grid_prm))
    for d, anti in ((4, False), (2, True)):
        rb_cfg = rb.RainbowConfig(n_paths=n_tp, d=d, antithetic=anti)
        rb_prm = bm.pack_basket(mt.DEMO_OPTION, bm.demo_basket(d, 0.5), 1, dev)
        rows[f"rainbow_partials call_on_max d={d} anti={int(anti)} {n_tp} "
             f"paths"] = batch_ms(lambda rb_cfg=rb_cfg, rb_prm=rb_prm:
                                  rb.rainbow_partials("call_on_max", rb_cfg,
                                                      key, rb_prm))
    for payoff, method, n, steps in GREEK_TIMED:
        g_cfg = pk.KernelConfig(n_paths=n, n_steps=steps, method=method)
        g_po = get_payoff(payoff)
        rows[f"greek_partials {payoff} {method} {n}x{steps}"] = batch_ms(
            lambda g_cfg=g_cfg, g_po=g_po: pk.simulate_greek_partials(
                g_po, g_cfg, key, params))
    for label, (d_ms, h_ms, n) in rows.items():
        print(f"probe wrappers {root.name}: {label}: device {d_ms:.5f} ms, "
              f"host {h_ms:.5f} ms a call (batches of {n}, median of "
              f"{WRAP_REPS}) {card}", flush=True)
    sim = mt.SimParams(n_paths=n_tp, n_steps=100)
    rsim = mt.SimParams(n_paths=RATES_MAIN, n_steps=1)
    curve, spec = mt.DEMO_CURVE, mt.SwaptionSpec(payer=True)
    proj = mt.DiscountCurve(curve.times, [z + 25 * 1e-4 for z in curve.zeros])
    tenor, mats = mt.DEMO_SWAPTION.tenor, [0.5, 1.0, 2.0, 3.0, 5.0, 10.0]

    def par_rate(t_m):  # chip_smoke.py's par-swap curve
        dfs = [curve.df(tenor * j) for j in range(1, round(t_m / tenor) + 1)]
        return (1.0 - dfs[-1]) / (tenor * sum(dfs))

    boot = mt.DiscountCurve.from_par_swaps(mats, [par_rate(m) for m in mats],
                                           tenor=tenor)
    hw, g2 = mt.DEMO_HW, mt.DEMO_G2
    e2e = {
        "price() call 1M paths default":
            lambda: mt.price(mt.DEMO_OPTION, sim, device="cuda"),
        "price_fx() quanto call 1M paths": lambda: mt.price_fx(
            mt.DEMO_OPTION, fx.DEMO_FX, mt.SimParams(n_paths=n_tp),
            device="cuda"),
        "price_rainbow() call_on_max d=4 1M paths": lambda: mt.price_rainbow(
            mt.DEMO_OPTION, bm.DEMO_BASKET, mt.SimParams(n_paths=n_tp),
            device="cuda"),
        "greeks() pathwise (fused kernel) call 1M terminal": lambda: mt.greeks(
            mt.DEMO_OPTION, sim, which=GREEK_WHICH, device="cuda"),
        "greeks() pathwise (fused kernel) asian 100000x100": lambda: mt.greeks(
            mt.DEMO_OPTION, mt.SimParams(n_paths=100_000, n_steps=100),
            "asian_call", which=GREEK_WHICH, device="cuda"),
        "price_swaption() Vasicek": lambda: mt.price_swaption(
            spec, mt.DEMO_VASICEK, rsim, device="cuda"),
        "price_hw_swaption() demo curve": lambda: mt.price_hw_swaption(
            spec, hw, curve, rsim, device="cuda"),
        "price_hw_swaption() par-swap curve": lambda: mt.price_hw_swaption(
            spec, hw, boot, rsim, device="cuda"),
        "price_hw_swaption() multi-curve +25bp": lambda: mt.price_hw_swaption(
            spec, hw, curve, rsim, projection_curve=proj, device="cuda"),
        "price_g2_swaption() demo curve": lambda: mt.price_g2_swaption(
            spec, g2, curve, rsim, device="cuda"),
        "price_g2_swaption() multi-curve +25bp": lambda: mt.price_g2_swaption(
            spec, g2, curve, rsim, projection_curve=proj, device="cuda"),
    }
    out = {"root": str(root), "load_s": load_s, "reps": WRAP_REPS,
           "card": card, "wrappers": {
               k: dict(device_ms=d, host_ms=h, batch=n)
               for k, (d, h, n) in rows.items()}, "e2e": {}}
    for label, fn in e2e.items():
        med, lo, hi = e2e_ms(fn)
        out["e2e"][label] = dict(ms=med, min_ms=lo, max_ms=hi)
        print(f"probe wrappers {root.name}: e2e {label}: median {med:.4f} ms "
              f"(min {lo:.4f}, max {hi:.4f}, {WRAP_REPS} calls) {card}",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--qmc", action="store_true")
    mode.add_argument("--gbm", action="store_true")
    mode.add_argument("--basket", action="store_true")
    mode.add_argument("--fx", action="store_true")
    mode.add_argument("--greeks", action="store_true")
    mode.add_argument("--partials", action="store_true")
    mode.add_argument("--sabr", action="store_true")
    mode.add_argument("--rates", action="store_true")
    mode.add_argument("--trajectories", action="store_true")
    mode.add_argument("--wrappers", metavar="DIR", default=None)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--kernels", default=None,
                    help="--partials: a comma list of localvol, merton, cev, "
                         "divs, heston_qe, bates_qe, heston_euler (all by "
                         "default); --gbm: of nmc, book, simulate, "
                         "terminal_pair, ladder (all by default); "
                         "--trajectories: of TRAJ_INSTANCES' labels (all "
                         "by default); --fx: of fx, "
                         "rainbow (both by default)")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--out", default="build/family_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("family_nmc_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.wrappers:  # the checkout's package before this one's
        sys.path.insert(0, str(Path(args.wrappers).resolve()))
    from mc_tpu_torch import nmc_engine as ne
    from mc_tpu_torch.ops import _cuda
    from mc_tpu_torch.ops.payoffs import get_payoff
    from mc_tpu_torch.utils import nvidia_smi_name_power

    card = nvidia_smi_name_power()
    print(card, flush=True)
    if args.wrappers:
        return write_report(args.out, wrappers_main(args, card))
    own = _cuda.CSRC.resolve()
    variants = []
    for spec in args.variant or [f"tree={own}"]:
        label, _, rest = spec.partition("=")
        src, _, defs = rest.partition(":")
        variants.append((label, Path(src).resolve(),
                         [d for d in defs.split(",") if d]))
    if args.kernels is not None:
        args.kernels = tuple(k for k in args.kernels.split(",") if k)
    if args.qmc:
        return write_report(args.out, qmc_main(args, variants, card))
    if args.gbm:
        return write_report(args.out, gbm_main(args, variants, card))
    if args.basket:
        return write_report(args.out, basket_main(args, variants, card))
    if args.fx:
        return write_report(args.out, fx_main(args, variants, card))
    if args.greeks:
        return write_report(args.out, greeks_main(args, variants, card))
    if args.partials:
        return write_report(args.out, partials_main(args, variants, card))
    if args.sabr:
        return write_report(args.out, sabr_main(args, variants, card))
    if args.rates:
        return write_report(args.out, rates_main(args, variants, card))
    if args.trajectories:
        return write_report(args.out, traj_main(args, variants, card))
    libs = build(variants)
    fams = families()
    dev = torch.device("cuda")
    report = {"card": card, "variants": {}}
    bound = {}
    for label, src, defines in variants:
        lib_path, logs = libs[label]
        # the launch geometry is passed in where the library has the
        # occupancy entry point, which came with it
        new_abi = hasattr(ctypes.CDLL(str(lib_path)), "mc_family_occupancy")
        lib = bind(lib_path, new_abi)
        legs = next((int(d.split("=")[1]) for d in defines
                     if d.startswith("MC_FAMILY_LEGS=")), None)
        bound[label] = (lib, new_abi, legs)
        res = {}
        for log in logs.values():
            res.update(ptxas_resources(log))
        rows = {}
        for name, fam, pack, _, struct in fams:
            row = {}
            for kernel in ("family_fused_kernel", "family_inner_kernel"):
                e = entry_name(res, kernel, struct)
                r = dict(res.get(e, {}))
                if hasattr(lib, "mc_family_occupancy"):
                    blocks = ctypes.c_int(0)
                    smem = (ne.family_launch(fam, NMC_MAIN[2], pack(
                        NMC_MAIN[1], torch.device("cpu")).numel()).smem_bytes
                        if new_abi else 0)
                    r["smem_dynamic"] = smem
                    st = lib.mc_family_occupancy(
                        fam.cuda_id, get_payoff(PAYOFF).cuda_id,
                        _cuda.family_extras(fam.extras),
                        int(kernel == "family_fused_kernel"), smem,
                        ctypes.byref(blocks))
                    r["blocks_per_sm"] = blocks.value if st == 0 else None
                else:
                    r["blocks_per_sm"] = None
                row[kernel.split("_")[1]] = r
                print(f"probe {label}: {name} {kernel}<{struct}, VanillaCall>"
                      f": {r} {card}", flush=True)
            if args.sass and name in SASS_FAMILIES:
                e = entry_name(res, "family_inner_kernel", struct)
                n_ins, loops = sass_loops(lib_path, e)
                row["sass"] = dict(instructions=n_ins, loops=loops)
                print(f"probe {label}: {name} family_inner_kernel SASS: "
                      f"{n_ins} instructions; loops (innermost first):")
                for lp in loops:
                    print(f"  {lp}")
            rows[name] = row
        report["variants"][label] = dict(src=str(src), defines=defines,
                                         families=rows)
    if args.time:
        times = {}
        for name, fam, pack, keys, _ in fams:
            prm = pack(NMC_MAIN[1], dev)
            warm = pack(NMC_WARM[1], dev)
            ref = None
            order = list(bound) + list(bound)[::-1]
            for rep, label in enumerate(order):
                lib, new_abi, legs = bound[label]
                run_kernels(lib, new_abi, legs, fam, warm, keys, NMC_WARM)
                sf, si, f_ms, i_ms = run_kernels(lib, new_abi, legs, fam, prm,
                                                 keys, NMC_MAIN)
                if ref is None:
                    ref = (sf, si)
                same = bool(torch.equal(sf, ref[0])
                            and torch.equal(si, ref[1])
                            and torch.equal(sf, si))
                times.setdefault(name, {}).setdefault(label, []).append(
                    dict(fused_ms=f_ms, inner_ms=i_ms, bitwise=same))
                print(f"probe time {name} {label}: fused {f_ms:.3f} ms, inner "
                      f"{i_ms:.3f} ms, bitwise vs {order[0]} and grid == "
                      f"fused: {same} {card}", flush=True)
                if not same:
                    print(f"FAIL: {name} {label} disagrees", flush=True)
        report["times"] = times
    return write_report(args.out, report)


def write_report(path: str, report: dict) -> int:
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"probe: wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
