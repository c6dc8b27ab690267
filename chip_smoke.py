"""Run mc_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

from the root of a checkout.  It drives ``mc_tpu_torch`` only (never JAX or
``mc_tpu``) through six phases and exits nonzero at the first failure:

1. the card (``nvidia-smi`` name and power limit) and the build of
   ``mc_tpu_torch/csrc`` with ``nvcc`` (one compiler fewer than the host
   has CPUs), in a thread while phase 2's first pass runs;
2. in two passes (the families' plain versions on the card while nvcc
   builds, then every kernel against its stored plain result),
   each CUDA kernel against its plain PyTorch version on
   the card, same key, with the tolerances of the parity contract, at the
   contract's sizes and at the main path's shapes: the simulate kernel for
   all 18 payoffs (with resume, multi-word resume, importance sampling and
   the geometric control variate too; its edges, BARRIER_EDGES and
   EDGE_STEPS: the barrier payoffs' threshold at barriers +-0, -1, +-inf,
   NaN and spots 0, -0, -50, resume spots +-0 and -50 at an odd start of
   an odd count, 0, 1 and 7 steps), the terminal kernels for the six
   terminal-only payoffs, trajectories and both NMC kernels for the payoffs
   with one state word, the strike ladder and the batched book (bullet,
   Asian, down-and-in and vanilla Euler books, antithetic and with the
   control variate, a ragged last contract group, and book64), the greek
   kernel for the five pathwise payoffs and the two reductions up to 2^26
   elements (one view misaligned); the Heston kernel for its 16 payoffs
   (Euler and QE, threefry-13 and -20, antithetic, 1M x 100 plain and, for
   Euler, antithetic; Euler also at BARRIER_EDGES, 1 and 7 steps; QE also in
   QE_EDGES' stress regime and plain-K0 fall-backs), the Heston
   trajectories for the one-word payoffs and both family NMC kernels; the
   Merton kernel (every payoff, Euler and the terminal draw, threefry-13
   and -20, antithetic, 1M x 100 and 1M), the Merton trajectories and the
   generic trajectories under Bates (every one-word payoff), the Bates
   kernel (16 payoffs, Euler and QE, 1M x 100; QE also at QE_EDGES) and
   the Merton and Bates
   family NMC kernels; the CEV kernel (16 payoffs, antithetic, 1M x 100;
   its edges: ragged lockstep groups, an offset past 2^20 with a bound
   inside the run and past its end, beta 0 and 1, paths absorbed at 0) and
   its clamped-spot logf against the toolkit's on every float of [1e-12,
   FLT_MAX] and +inf (mc_cev_logf_check),
   the local-vol kernel (18 payoffs, antithetic, threefry-20, the K = 25
   CEV-gate surface, 1M x 100), the local-vol trajectories and the generic
   trajectories under CEV (every one-word payoff) and the CEV and local-vol
   family NMC kernels; the SABR kernel (16 payoffs, threefry-13 and -20,
   antithetic, 1M x 100, at the demo's beta = 1 and at beta = 0.5, the two
   instantiations), the term-structure and cash-dividend kernels (18
   payoffs each, on steep curves and two payments, antithetic, 1M x 100;
   the dividends' edges as CEV's and its edge schedules: a payment at step
   0 and the last, every step, -0.0 between, negative, above the spot,
   +inf, 2 steps and 2,050, past its block table),
   the generic trajectories under SABR and term and their family NMC
   kernels; the Vasicek kernel (18 payoffs, threefry-13 and -20,
   antithetic, 1M x 100), the Vasicek trajectories, the basket kernel (18
   payoffs at d = 4; the call and the bullet at d = 1, 5, 8, 9, 16, 17 and
   32, each capacity's edges, antithetic and not; 1M x 100),
   the basket's (B, state) trajectories at 100,000 x 100 and, for the call
   and the bullet, at d = 1, 4, 5, 8, 9, 16, 17 and 32 on 4,099 paths, the
   generic trajectories of its d asset grids and both families' NMC
   kernels; the FX kernel (8 contracts, threefry-13 and -20, 1M; each at 1,
   255, 257 and 100,001 paths, an offset and a bound cutting a block and
   2^24 paths), the rainbow kernel (6
   payoffs at d = 4, 1M, antithetic; the call at d = 1, 2, 8, 9, 32), the
   rainbow's generic trajectories and NMC kernels (both folds), the QMC
   kernels (terminal and Euler on the lattice and Sobol, the Brownian
   bridge, every payoff at a small point count, the call and the Asian at
   2^20 points x 100) on two shifts, #32 also on 3 and 17 shifts (a ragged
   last shift group), the bridge's Asian on both families at 1, 2, 3 and
   453 steps and on 3 and 17 shifts and, at 2^20 points x 100 x 16, #32's
   first and last
   block's rows against the plain sums of their points; the model-QMC
   kernel #33 under all nine families (the call and the Asian on both
   point families, every payoff of Heston and of the basket at d = 4, the
   basket at d = 1, 9, 32) at 4,096 / 4,099 points x 100 on two shifts and
   each family on 3 and 17, its sums bitwise or within 2e-16; #32 and #33
   at the main shape against one launch of their first and last shift
   alone (no other shift beside it), bitwise; the rates kernel
   #11 under its five European swaption tiles
   (Vasicek, Hull-White and G2++, the last two also multi-curve), payer and
   receiver, at 1, 10 and 60 payments on 2^20 paths, 100,001 paths and an
   offset run whose bound falls short of its end, its rows bitwise; their
   sums to f64 rounding and their
   grids and surfaces bit for bit (every NMC at NMC_SMALL in full, at the
   main shape against the plain row 99, the GBM and rainbow NMC rows 0 and
   99; the GBM NMC, bullet and call, also at 300 x 7 x 7 (odd steps, a
   ragged last leg group), its grid surface == its fused one, after a
   check of the CUDA libm on every input #3/#5 can give it: expf keeps the
   floats' order and sincosf is cosf and sinf bit for bit; each family's
   #29/#30 also at 300 x 7 x 7, 8 steps under Merton,
   local vol and Vasicek, in full, a ragged last leg group, with Vasicek's
   bond and the basket's exchange at d = 2 there, and local vol's K = 25
   pack over the shared budget at 300 x 300 x 3, rows 0 and 299; the fused
   surface equal to the inner one in every row);
3. the main path at the size users run: the 1M-path European call by five
   methods and with importance sampling against Black-Scholes, every
   payoff at 1M paths (terminal-only) or 100,000 x 100 steps against its
   closed form or its parity identity, the 100k x 100-step bullet, the
   100k x 100 trajectories and a resume from their step 50, the
   16,384 x 100 x 500 nested-MC surface by both strategies with its
   exposure and XVA figures, the 17-strike ladder at 1M paths, the
   64-contract x 2^20-path x 100-step book, the greeks of the 1M-path call
   (fused kernel) against Black-Scholes, the Asian's and the lookback's at
   100,000 x 100 by kernel and autograd, theta by autograd, the bullet's
   delta and gamma by CRN-FD against LRM, the digital's LRM gamma, a
   4 x 2^20-path chunked run stopped and resumed, and the reductions over
   a payoff array and 2^26 normals; then, its launch counts set to 0
   again, the Heston path: price_heston at 1M x 100 (Euler and QE) against
   the CF oracle, every Heston payoff at 100,000 x 100, the 16,384 x 100 x
   500 Heston NMC by both strategies (grid == fused, the tower property),
   its XVA figures and the ``heston`` and ``nmc --model heston`` commands;
   then, the counts set to 0 before each, the Merton path and the Bates
   path: price_merton at 1M x 100 (Euler) and 1M (terminal) against the
   series, price_bates at 1M x 100 (Euler and QE) against the CF oracle,
   every payoff at 100,000 x 100, the 16,384 x 100 x 500 NMC by both
   strategies (grid == fused, the outer price, the tower property), its XVA
   figures and the ``merton``/``bates`` and ``nmc --model`` commands;
   then, the counts set to 0 before each, the CEV path and the local-vol
   path: price_cev at 1M x 100 against the noncentral chi-squared price,
   price_localvol at 1M x 100 on a flat surface against Black-Scholes and
   on the CEV-shaped surface against the CEV price, every payoff at
   100,000 x 100, the 16,384 x 100 x 500 NMC by both strategies (grid ==
   fused, the outer price, the flat EE profile), its XVA figures and the
   ``cev``, ``localvol --beta 0.7`` and ``nmc --model`` commands; then,
   the counts set to 0 before each, the SABR, term and dividend paths:
   price_sabr at 1M x 100 against Black-Scholes at nu -> 0 and Hagan's
   price, price_term on the demo curves against Black-Scholes at the
   averaged parameters, price_divs with one payment against the
   quadrature price and with two against put-call parity on the scheme's
   forward, every payoff at 100,000 x 100, the SABR and term NMC at 16,384
   x 100 x 500 by both strategies with their XVA figures, and the
   ``sabr``, ``term``, ``divs`` and ``nmc --model`` commands; then, the
   counts set to 0 before each, the Vasicek and basket paths:
   price_vasicek at 1M x 100 against Merton's (1973) call and the affine
   bond, price_basket at d = 1 and at perfect correlation against
   Black-Scholes, every payoff at 100,000 x 100, both NMCs at 16,384 x 100
   x 500 by both strategies (grid == fused, the outer price, the last row,
   the tower property) with the bond's EE flat at P(0,T) and the Margrabe
   exchange EE flat at its closed form, their XVA figures, and the
   ``vasicek``, ``basket`` and ``nmc --model`` commands; then, the counts
   set to 0 before each, the FX path (every contract at 1M against its
   closed form, ``fx``), the rainbow path (Margrabe and the four Stulz
   prices at d = 2 and 1M, the d = 4 best-of call, the NMC at 16,384 x 100
   x 500 by both strategies with its best-of EE flat at Stulz's price,
   ``rainbow`` and ``nmc --model rainbow``) and the QMC path (the terminal
   call on 2^20 points x 16 shifts of both families against Black-Scholes,
   its stderr against plain MC's on the same budget, the Asian by Euler and
   by the bridge, ``qmc``); then the model-QMC path, each family's block
   with the counts at 0: every family's call on 2^20 Sobol points x 100 x
   16 shifts against its oracle where the scheme is exact in law (term,
   flat local vol, Vasicek's call and bond, the basket at d = 1, Merton)
   or against its own MC kernel on the same scheme (Heston and Bates with
   the CF price beside, CEV also on the lattice, SABR, the basket at
   d = 4), its stderr against plain MC's at the same budget, and
   ``qmc --model heston|bates --family sobol``; then, the counts set to 0,
   the rates path: price_swaption, price_hw_swaption (on the demo curve,
   on a curve bootstrapped from par swaps, and multi-curve at a 25 bp
   projection spread) and price_g2_swaption (single- and multi-curve) at
   2^20 paths, payer and receiver, each within 4 stderr of its oracle
   (Jamshidian, the curve-consistent Jamshidian, the conditional-Jamshidian
   G2++ price, the multi-curve quadratures), and ``swaption``,
   ``hullwhite --proj-spread-bp 25`` and ``g2pp`` against the library call
   bit for bit;
4. the kernels' launch counts over each of the sixteen paths (#33's per
   family; #11's per tile, one per price_* call; Heston's and Bates's
   partials by scheme, Euler and QE);
5. kernel and plain-version times with CUDA events (median of >= 5 runs
   after a warm-up; the NMC kernels and calls once, in phases 2 and 3; the
   plain versions once), the
   ladder and the book beside the single-contract
   launches they replace, the simulate kernel per payoff with its
   registers (its timed rows with their registers, spills and resident
   blocks per SM), the greek kernel beside the simulate kernel on its shape,
   the reductions beside ``torch.sum``, the Heston kernels beside the GBM
   kernels of the same shapes (the Euler and QE calls antithetic too, with
   registers, spills and resident blocks per SM), the Merton and Bates
   kernels beside the
   Heston kernels of their shapes, the CEV and local-vol kernels beside
   the Heston and Merton kernels of their shapes, the SABR kernels beside
   Heston's, the term and dividend kernels beside CEV's, the Vasicek
   kernels beside Merton's, the basket kernels beside Heston's (the
   trajectories kernel also at d = 9 and 32), the FX kernel beside
   terminal_pair (and at 2^24 paths, beside its share of the bound, its
   paths a thread and resident blocks per SM), the rainbow kernels beside
   the basket's,
   the QMC kernels on both families and #33 per family (each beside its
   share of the bound, its registers and spills, its resident blocks per
   SM, its shifts a thread and its shared bytes; the bridge's live slots),
   the basket's partials kernel at d = 1, 4, 9, 16, 32, antithetic and not
   (beside its share of the bound, its capacity, paths a thread,
   registers, spills and resident blocks per SM), the CEV and dividend
   kernels antithetic and not (beside the same, and paths a thread),
   #11 per tile at 2^20
   and 2^24 paths with 10 payments and at 2^20 with 60 (the NMC kernels' times are their
   phase-2 calls' and the NMC calls' their phase-3 calls'; #3/#5 beside
   their legs a thread, registers, spills and resident blocks per SM; each family's
   #29/#30 beside its share of the bound, its registers and spills, its
   resident blocks per SM, its shared bytes and its legs a thread), and
   end-to-end
   times of the phase-3 calls (greeks() by route, chunked_price(),
   price_heston(), price_nmc_heston(), price_merton(), price_bates(),
   price_nmc_merton(), price_nmc_bates(), price_cev(), price_localvol(),
   price_nmc_cev(), price_nmc_localvol(), price_sabr(), price_term(),
   price_divs(), price_nmc_sabr(), price_nmc_term(), price_vasicek(),
   price_nmc_vasicek(), price_basket(), price_nmc_basket(), price_fx(),
   price_rainbow(), price_nmc_rainbow(), price_qmc(), price_qmc_model()
   (its phase-3 calls), price_swaption(), price_hw_swaption(),
   price_g2_swaption());
6. the bounds' int32, f32 and SFU terms of the recounted rows (the book,
   SABR, CEV, the dividends, the QE kernels, call and antithetic) and the
   QE kernels', the simulate kernel's timed rows' and #12's Euler call's
   (and antithetic call's) bounds beside their phase-5 times,
   one JSON line of per-kernel results (with each kernel's
   bound), then the JSON status line.

Without a CUDA device it prints no result and exits 2.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import re
import statistics
import sys
import tempfile
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

# Phase-2 (kernel vs plain) and phase-3 (main path) sizes.
TP_PATHS = 1 << 20
# phase 2: terminal_pair at ragged element counts (256, 257, 4,100, 50,001
# and 2^23 + 1 elements, the last past the grid's 2^21 elements a round),
# each an odd path count; phase 5: the call at TP_BIG paths too
TP_EDGE_PATHS = (511, 513, 8_199, 100_001, (1 << 24) + 1)
TP_BIG = 1 << 24
TERM_PATHS = 1 << 18
EULER_PATHS, EULER_STEPS = 1 << 16, 100
NMC_SMALL = (2048, 16, 64)          # outer paths, steps, inner paths
MAIN_PATHS, MAIN_STEPS = 1_000_000, 100
BULLET_PATHS = 100_000
TRAJ_PATHS = (65_536, BULLET_PATHS)
RESUME_STEPS = (50, 51)             # even and odd resume points
IS_STRIKE = 180.0                   # deep out of the money: IS pays off
NMC_MAIN = (16384, 100, 500)        # README quickstart: 4.1e10 inner steps
# phase 2: a part-full tile, odd steps and a ragged last leg group (7 legs
# in groups of 2 or 4) for every family, every row; 8 steps under Merton,
# local vol and Vasicek, whose plain outer paths take steps in pairs
NMC_RAGGED = (300, 7, 7)
NMC_RAGGED_EVEN = ("merton", "localvol", "vasicek")
# phase 2: local vol at K = 25 on 300 steps, a pack (30 KB) over the
# shared budget, read where it lies; the plain rows 0 and 299
NMC_OVER_BUDGET = (300, 300, 3)
NMC_ROWS = (0, 99)                   # phase 2: the plain rows at NMC_MAIN
# Phase 2: the plain row of the earlier slices' family NMC at NMC_MAIN (the
# last: grid == fused is held bitwise in phase 3, and every row of every
# family at NMC_SMALL).
EARLIER_NMC_ROWS = (99,)
CLI_NMC_PATHS = 2048                 # phase 3: nmc --model's outer paths
PAYOFF_PATHS = 16_384                # phase 2: every payoff, 100 steps
LADDER_STRIKES = (60.0, 140.0, 17)   # linspace: the CLI's vol-surface row
LADDER_PATHS = 1_000_000
BOOK_SMALL = (16, 1 << 16)           # phase 2: contracts, paths (100 steps)
BOOK_MAIN = (64, 1 << 20)            # bench.py:586-609 book64 (100 steps)
GREEK_TERM_PATHS = 1 << 20           # phase 2: terminal pathwise payoffs
GREEK_EULER_PATHS = 65_536           # phase 2: Asian, lookback (100, 99 steps)
GREEK_PATHS = 1_000_000              # phases 2-3: the call's greeks, terminal
GREEK_STEP_PATHS = 100_000           # phases 2-3: 100,000 x 100, the CLI default
# phase 2: past the capped grid (MAX_BLOCKS x 256 = 2^21 paths), so blocks
# grid-stride: the terminal call, the Euler call and Asian over 2 steps
GREEK_PAST = (1 << 21) + 4_099
FD_BUMP = 0.05                       # the bullet's CRN-FD bump (h = 5 at S0)
CHUNK_PATHS, N_CHUNKS = 1 << 20, 4   # phase 3: chunked_price, resume after 2
REDUCE_SIZES = (1, 1_000_003, 1 << 20, 1 << 26)  # 2^20 misaligned too
PAY_ARRAY = 1 << 20                  # phase 3: the call's payoff array
NORMALS = 1 << 26                    # phase 3: normals through sum_sumsq
REPS = 5
DEVICE = "cuda"
# The model families (bench.py's Heston rows are 1M x 100, and every family
# since has taken that size; the README's NMC).
FAMILY_PATHS = 16_384                # phase 2: every payoff, 100 steps
EDGE_PATHS = FAMILY_PATHS + 27       # phase 2: a ragged last block (#14, #19)
# phase 2: the family trajectories kernel at a ragged outer grid: a part-full
# block, a ragged last draw chunk and an odd last step (18 steps under the
# families whose plain outer path takes steps in pairs)
TRAJ_RAGGED = (2_049, 17)
# ... and at a grid past every family's split (782 blocks of 128 paths, more
# than 4 an SM): the blocks of one thread a path
TRAJ_WIDE = (100_000, 4)
FAMILY_MAIN = 1_000_000              # price_<family> at 1M (x 100)
PAYOFF_MAIN = 100_000                # phase 3: every payoff of each family
HESTON_PAYOFF_MAIN = PAYOFF_MAIN     # #13's shape
HESTON_KERNELS = ("heston_partials", "heston_trajectories", "family_inner",
                  "family_fused")
MERTON_KERNELS = ("merton_partials", "merton_trajectories", "family_inner",
                  "family_fused")
BATES_KERNELS = ("bates_partials", "family_trajectories", "family_inner",
                 "family_fused")
# The kernels line's rows of the jump slice (the family kernels' rows per
# family: their launches are read on that family's path).
JUMP_ROWS = ("merton_partials", "merton_trajectories", "bates_partials",
             "family_trajectories", "family_inner_merton",
             "family_fused_merton", "family_inner_bates", "family_fused_bates")
# The single-asset families (single_families; local vol on its demo surface,
# K = 9, and the CEV-gate surface, K = 25; in phase 2 term on steep curves,
# dividends on a two-payment schedule).
CEV_KERNELS = ("cev_partials", "family_trajectories", "family_inner",
               "family_fused")
LOCALVOL_KERNELS = ("localvol_partials", "localvol_trajectories",
                    "family_inner", "family_fused")
SABR_KERNELS = ("sabr_partials", "family_trajectories", "family_inner",
                "family_fused")
TERM_KERNELS = ("term_partials", "family_trajectories", "family_inner",
                "family_fused")
DIVS_KERNELS = ("divs_partials",)
VASICEK_KERNELS = ("vasicek_partials", "vasicek_trajectories", "family_inner",
                   "family_fused")
BASKET_KERNELS = ("basket_partials", "family_trajectories", "family_inner",
                  "family_fused", "basket_trajectories")
GRID_PATHS = 100_000                 # #26: the (B, state) grids, 100 steps
GRID_EDGE_PATHS = 4_099              # #26's d edges: a ragged last block
# Phase 2: the basket's d at each capacity's edges (basket_partials.cuh: 4,
# 8, 16, 32), antithetic and not; phase 5 times #25 at BASKET_TIMED_D.
BASKET_EDGES = (1, 5, 8, 9, 16, 17, 32)
BASKET_TIMED_D = (1, 4, 9, 16, 32)
# Phase 2: the edges of the legs that form S only where the payoff reads it
# (#2 and #12's Euler kernel, barrier.cuh): the barrier payoffs' threshold
# at barriers +-0, -1, +-inf and NaN and at spots 0, -0 and -50 (under a
# barrier of -60, struck at -100: S falls below it as w rises); 0, 1 and 7
# steps.  The plain versions' clamps keep a NaN or an infinite spot that
# fmaxf drops, so those spots are held only parent to tree
# (family_nmc_probe.py).
BARRIER_EDGES = (dict(barrier=0.0), dict(barrier=-0.0), dict(barrier=-1.0),
                 dict(barrier=math.inf), dict(barrier=-math.inf),
                 dict(barrier=math.nan), dict(s0=0.0), dict(s0=-0.0),
                 dict(s0=-50.0, barrier=-60.0, k=-100.0))
EDGE_STEPS = (0, 1, 7)


def edge_steps(payoff: str):
    """EDGE_STEPS a payoff runs against its plain version: not the Asian at
    0 steps, whose mean of no spots is NaN (the plain clamp keeps it,
    fmaxf drops it)."""
    return tuple(n for n in EDGE_STEPS if n or payoff != "asian_call")

# Options that make each payoff live at 100 steps, and the contracts its
# closed form prices: the down barriers at 90, the variance swap's variance
# strike 0, the forward start fixing at step 50 (t1 = 0.5) at the money,
# the cliquet's 4 periods of 25 steps with floor -2% and cap 4%.
PAYOFF_OPTIONS = {
    "down_out_call": dict(barrier=90.0),
    "down_in_call": dict(barrier=90.0),
    "down_out_call_bb": dict(barrier=90.0),
    "variance_swap": dict(k=0.0),
    "forward_start_call": dict(k=1.0, p1=50.0),
    "cliquet": dict(k=25.0, p1=-0.02, p2=0.04),
}
# Payoffs whose value jumps where S crosses K or B: a path can flip where S
# lands within an ulp, so they take the bullet's tolerance.
FLIP_PAYOFFS = {"digital_call", "digital_put", "bullet_call", "up_out_call",
                "down_out_call", "down_in_call"}

# Parity contract.  Vanilla: same stream, same f32 arithmetic; the only
# differences are CUDA's libm against PyTorch's and the order of f64 sums.
VANILLA_RTOL = 1e-5
# Bullet and NMC: a barrier count can flip where S lands within an ulp of B.
BULLET_SE_TOL = 0.05                # |d price|, |d stderr| in stderrs
SURF_TOL, SURF_FRAC = 1e-4, 0.999   # rtol = atol, share of points
SURF_MEAN_RTOL = 1e-4
TRAJ_S_RTOL = 2e-6                  # stored prices: a few f32 ulp
XVA_RTOL = 1e-4                     # cva_wwr_spot(beta=0) against cva
# The greek kernel and the reductions against their plain versions: the
# same f32 values per path (element), f64 sums in another order.
SUMS_RTOL = 1e-12
GREEK_ROUTE_RTOL = 1e-3             # fused kernel vs autograd (mc_tpu's own)

# The least time of a kernel: the larger of its bytes over the memory rate
# and its operations over the issue rate of their type.  H100 SXM: 3.35 TB/s
# and 67 TFLOP/s f32 (NVIDIA's H100 datasheet); that f32 rate is 132
# SMs x 128 lanes x 2 (an FMA) at 1.98 GHz, and the same SMs issue 64 int32
# lanes and 16 special-function (transcendental) lanes per clock.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# f64 outside the tensor cores: 132 SMs x 64 lanes x 2 (an FMA) at 1.98 GHz
# (34 TFLOP/s on the datasheet).
F64_OPS_PER_S = 132 * 64 * 2 * 1.98e9


def process_seconds() -> float:
    """Seconds since this process started (Linux /proc): the interpreter's
    and PyTorch's start-up included."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# --- operation counts, per lane, from the kernels' source ----------------
# (int32, f32, transcendental) operations.


def _add(*terms):
    return tuple(sum(t) for t in zip(*terms))


def _scale(ops, k):
    return tuple(k * o for o in ops)


def pair_ops(rounds: int):
    """One threefry2x32 call and Box-Muller: 2 key adds, 3 ops a round
    (add, rotate, xor), 2 adds per key injection, 2 ops per bits_to_unit;
    7 f32 ops; log1p, sqrt, cos, sin."""
    return (2 + 3 * rounds + 2 * (rounds // 4) + 4, 7, 4)


STEP_OPS = (0, 4, 1)       # w += drift_dt + vol_dt*z; s = base*exp(w)
UPDATE_OPS = {"vanilla_call": (0, 0, 0), "vanilla_put": (0, 0, 0),
              "bullet_call": (0, 2, 0),   # count += (s < B)
              "asian_call": (0, 1, 0)}    # acc += s
TERMINAL_OPS = (0, 3, 0)   # payoff and pay^2
TERMINAL_DRAW_OPS = (0, 3, 1)  # S_T = s0 * exp(drift_t + vol_t * z)
# The greek kernel on top of the step: sum_z += z, and for a payoff with
# state t_j (2), the four spot tangents (a division and 7) and the Asian's
# four state-tangent adds and its update; at maturity the tangents again,
# the payoff's five values and their squares.
GREEK_STEP_OPS = (0, 1 + 2 + 8 + 5, 0)
GREEK_TERMINAL_OPS = (0, 8 + 4 * 3 + 2 + 10, 0)
# ... and for a payoff without state (the call, the put, best-of-cash) the
# Euler loop moves w (3) and sum_z (1) a step and forms S once, at maturity
# (SPOT_OPS): no tangent and no S at the steps.
GREEK_STATELESS_STEP_OPS = (0, 3 + 1, 0)
# A Heston Euler step on top of its whole threefry pair (heston.cuh): z_s
# (3), v+ (1), sq (2 and a sqrtf), w (6), v (7).
HESTON_EULER_STEP_OPS = (0, 19, 1)
# ... and S = s0*expf(w) (a mul and an expf) at each step: the step of the
# trajectories (#13), the family NMC's legs (#29/#30) and Bates's Euler
# kernel.  #12's Euler kernel forms S only where the payoff reads it
# (heston_euler_path).
HESTON_EULER_OPS = _add(HESTON_EULER_STEP_OPS, (0, 1, 1))
# A Heston QE step on top of its pair (heston.cuh), the least work at the
# demo dynamics, whose psi never exceeds psi(0) = xi^2 / (2 kappa theta) =
# 0.5625: the quadratic sampler at each step (m (3), s2 (2), psi (1 and a
# division), the switch (1), 2/psi and its floor (1 and a division), b2 (4
# and a sqrtf), a (1 and a division), b + z (1 and a sqrtf), v' (2)) and its
# martingale correction (9, a division and a logf); var_s (4), w (6 and a
# sqrtf).  The exponential sampler's uniform is drawn only where a lane
# takes that sampler, so never here; S is formed where the payoff reads it
# (the call: once, at maturity).
HESTON_QE_OPS = (0, 35, 8)
# An inner leg's end: its counter base (2), the call's payoff (2) and the
# Kahan step (4).
KAHAN_LEG_OPS = (2, 6, 0)


def path_ops(payoff: str, n_steps: int, rounds: int):
    """A log-Euler path of n_steps and its payoff."""
    return _add(_scale(pair_ops(rounds), (n_steps + 1) // 2),
                _scale(_add(STEP_OPS, UPDATE_OPS[payoff]), n_steps),
                TERMINAL_OPS)


# An inner pair of the GBM NMC kernels: both key adds leave the pair loop
# (id + k0 is the thread's, c + k1 the leg's), the counter's add of q stays.
NMC_PAIR_OPS = _add(pair_ops(13), (-1, 0, 0))
# An inner step moves w (3 f32 ops); S = base*exp(w) (SPOT_OPS) is formed at
# each step only where the payoff's update reads S itself (the Asian, the
# lookback, the down-and-out call), else once at the leg's end.  The payoffs
# that test S < B (the bullet, the up-and-out and down-and-in calls) test w
# against their point's threshold, a bisection of 32 halvings (an exp, a
# mul, a compare and ~5 int ops each).
NMC_STEP_OPS = (0, 3, 0)
SPOT_OPS = (0, 1, 1)
NMC_SPOT_EACH_STEP = {"asian_call", "lookback_call", "down_out_call"}
NMC_BARRIER_PAYOFFS = {"bullet_call", "up_out_call", "down_in_call"}
THRESHOLD_OPS = (5 * 32, 2 * 32, 32)


def inner_ops(payoff: str, n_steps: int, n_inner: int):
    """The inner sweeps of one outer path over all its steps: at step j,
    n_inner paths of the n_steps-j-1 remaining steps (threefry-13)."""
    each = payoff in NMC_SPOT_EACH_STEP
    step = _add(NMC_STEP_OPS, UPDATE_OPS[payoff], SPOT_OPS if each else (0, 0, 0))
    total = (0, 0, 0)
    for j in range(n_steps):
        rem = n_steps - j - 1
        one = _add(_scale(NMC_PAIR_OPS, (rem + 1) // 2), _scale(step, rem),
                   SPOT_OPS if rem and not each else (0, 0, 0), (0, 2, 0))
        point = (0, 3, 1)  # the mean, the discount
        if rem and payoff in NMC_BARRIER_PAYOFFS:
            point = _add(point, THRESHOLD_OPS)
        total = _add(total, _scale(one, n_inner), point)
    return total


def spot_each_step(payoff: str) -> bool:
    """Whether a leg that forms S only where the payoff reads it (#2, #12's
    Euler kernel; barrier.cuh) forms it at each step: a payoff whose update
    reads S (not a terminal-only one, and not the bullet, the up-and-out or
    the down-and-in call, which test w against a threshold)."""
    from mc_tpu_torch.ops.payoffs import get_payoff

    return not (get_payoff(payoff).terminal_only
                or payoff in NMC_BARRIER_PAYOFFS)


def simulate_path_ops(payoff: str, n_steps: int, rounds: int = 13,
                      legs: int = 1):
    """A log-Euler path of the simulate kernel (#2, simulate.cuh) and its
    payoff: a pair per two steps; each leg's step moves w (NMC_STEP_OPS),
    updates the payoff state (UPDATE_OPS; the barrier payoffs' compare is
    against w) and forms S (SPOT_OPS) where the payoff reads it, else once
    at maturity; the payoff (and the pair's mean) at maturity.  The kBarrier
    payoffs' block threshold is simulate_block_ops."""
    each = spot_each_step(payoff)
    step = _add(NMC_STEP_OPS, UPDATE_OPS[payoff],
                SPOT_OPS if each else (0, 0, 0))
    end = _add(TERMINAL_OPS, (0, 0, 0) if each else SPOT_OPS)
    return _add(_scale(pair_ops(rounds), (n_steps + 1) // 2),
                _scale(step, legs * n_steps), _scale(end, legs))


def simulate_block_ops(payoff: str, n_paths: int):
    """The kBarrier payoffs' threshold, a bisection (THRESHOLD_OPS) once a
    block of 256 paths; other payoffs: none."""
    if payoff not in NMC_BARRIER_PAYOFFS:
        return (0, 0, 0)
    return _scale(THRESHOLD_OPS, -(-n_paths // 256))


def heston_euler_path(payoff: str, n_steps: int, legs: int = 1):
    """A path of #12's Euler kernel (heston_kernels.cu) and its payoff: a
    whole pair and each leg's step (HESTON_EULER_STEP_OPS) each step, S
    (SPOT_OPS) at each step where the payoff reads it (else once, at
    maturity; the barrier payoffs' compare against w, their threshold once
    a block: simulate_block_ops), the payoff at maturity."""
    each = spot_each_step(payoff)
    step = _add(pair_ops(13), _scale(_add(
        HESTON_EULER_STEP_OPS, UPDATE_OPS[payoff],
        SPOT_OPS if each else (0, 0, 0)), legs))
    end = _add(TERMINAL_OPS, (0, 0, 0) if each else SPOT_OPS)
    return _add(_scale(step, n_steps), _scale(end, legs))


def bound(n_bytes: float, ops, f64_ops: float = 0.0):
    """(bound_ms, bound_by) of one call moving n_bytes and doing ops (and
    f64_ops f64 adds and multiplies)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(ops[0] / INT32_OPS_PER_S, ops[1] / F32_OPS_PER_S,
                ops[2] / SFU_OPS_PER_S, f64_ops / F64_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --- timing ----------------------------------------------------------------


def cuda_ms(fn, reps: int = REPS, min_ms: float = 5.0, warm: bool = True):
    """Device time of one call of fn in ms: median over reps, relative
    spread, and the calls batched into each timed rep (enough back-to-back
    calls that a rep lasts at least min_ms, so launch jitter averages out).
    ``warm=False``: fn ran already (an NMC kernel of ~0.1-0.6 s a call), so
    no warm-up call.  A call that lasts min_ms alone is a rep of one call:
    the call that sized the reps counts as the first."""
    def timed(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    if warm:
        fn()
        torch.cuda.synchronize()
    first = timed(1)
    inner = max(1, math.ceil(min_ms / max(first, 1e-3)))
    times = [first] if inner == 1 else []
    times += [timed(inner) for _ in range(reps - len(times))]
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med, inner


def e2e_seconds(fn, reps: int = REPS, warm: bool = True):
    """Host-clock seconds of ``reps`` calls of fn, each ended by a
    synchronize, after one warm-up call (none if ``warm=False``: fn ran
    already); sorted."""
    if warm:
        fn()
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return sorted(secs)


def e2e_report(rows, tag: str) -> None:
    """Phase 5: each (label, unit, work, fn) end to end on the host clock
    (e2e_seconds: REPS after a warm-up call), its median and its rate.  An
    NMC call's fn is the seconds its phase-3 call took (host clock, ended by
    a synchronize, warm from phase 2): that one call is its time."""
    for label, unit, work, fn in rows:
        reps = REPS
        if isinstance(fn, float):
            secs, reps = [fn], "1 (its phase-3 call)"
        else:
            secs = e2e_seconds(fn, reps)
        med = statistics.median(secs)
        print(f"phase 5: e2e {label}: median {med * 1e3:.4f} ms over {reps} "
              f"(min {secs[0] * 1e3:.4f}, max {secs[-1] * 1e3:.4f}), "
              f"{work / med:.4e} {unit} {tag}")


def nmc_e2e_rows(family, e2e_nmc):
    """The e2e rows of price_nmc_<family>() fused and grid at NMC_MAIN: the
    seconds of their phase-3 calls (``e2e_nmc[(family, strategy)]``)."""
    n_out, n_steps, n_inner = NMC_MAIN
    inner_steps = n_out * n_inner * n_steps * (n_steps - 1) // 2
    name = "price_nmc" if family == "gbm" else f"price_nmc_{family}"
    return tuple((f"{name}() {strategy} {n_out}x{n_steps}x{n_inner}",
                  "inner path-steps/s", inner_steps,
                  e2e_nmc[(family, strategy)])
                 for strategy in ("fused", "grid"))


def partials_times(rows, n_paths: int, time_pair, regs, tag):
    """Phase 5: each (row, label, kernel fn, plain fn or None, registers
    key, (ref label, ref ms)) at n_paths x MAIN_STEPS beside its plain
    version where given, and beside the reference, a kernel of the same
    shape.  Returns {row: (ms, plain ms or None)} of the rows named."""
    out = {}
    for row, label, fn, plain, regs_key, (ref_label, ref_ms) in rows:
        if plain is None:
            k_ms, sp, _ = cuda_ms(fn)
            print(f"phase 5: {label} {n_paths}x{MAIN_STEPS}: kernel "
                  f"{k_ms:.4f} ms (spread {sp:.1%}) {tag}")
            if row is not None:
                out[row] = (k_ms, None)
        else:
            out[row] = time_pair(label, fn, plain, f"{n_paths}x{MAIN_STEPS}")
            k_ms = out[row][0]
        print(f"phase 5: {label}: {n_paths * MAIN_STEPS / k_ms * 1e3:.4e} "
              f"path-steps/s; {k_ms / ref_ms:.2f}x {ref_label} on the same "
              f"shape ({ref_ms:.4f} ms); registers {regs.get(regs_key)} "
              f"{tag}")
    return out


def family_nmc_times(families, call, time_pair, regs, tag):
    """Phase 5: per (family, NMCFamily, params, (key, key_in), trajectories
    row, device struct, nmc_ms, (ref label, {"family_fused": ms,
    "family_inner": ms})), its outer trajectories at NMC_MAIN's outer shape
    beside their plain version, and its fused and inner kernels at NMC_MAIN
    (``nmc_ms``: family_nmc_case's CUDA-event times of its phase-2 calls,
    warm from NMC_SMALL) beside the reference family's kernels, each with
    family_nmc_report's line.  Returns {row: (ms, plain ms or None)}."""
    from mc_tpu_torch import nmc_engine as ne

    n_out, n_steps, n_inner = NMC_MAIN
    cfg = ne.FamilyConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
    inner_steps = n_out * n_inner * n_steps * (n_steps - 1) // 2
    out = {}
    for (family, fam, prm, (key, key_in), traj_row, struct, nmc_ms,
         (ref_label, ref_ms)) in families:
        out[traj_row] = time_pair(
            f"{traj_row} {family} call",
            lambda fam=fam, prm=prm, key=key: fam.trajectories(call, cfg, key,
                                                               prm),
            lambda fam=fam, prm=prm, key=key: fam.trajectories_plain(
                call, cfg, key, prm),
            f"{n_out}x{n_steps}")
        grid_bytes = (fam.n_grids + 1) * 4 * n_out * n_steps
        k_ms = out[traj_row][0]
        traj_regs = {split: regs.get((f"family_trajectories_kernel<{struct}>",
                                      "VanillaCall", split))
                     for split in (1, 0)}
        print(f"phase 5: {traj_row} writes {grid_bytes / 1e6:.1f} MB in "
              f"{k_ms:.4f} ms: {grid_bytes / k_ms / 1e6:.1f} GB/s; registers "
              f"{traj_regs} {tag}")
        traj_alone_report(family, fam, prm, key, call, cfg, traj_row,
                          traj_regs, tag)
        for name in ("family_fused", "family_inner"):
            ms = nmc_ms[name.split("_")[1]]
            out[f"{name}_{family}"] = (ms, None)
            print(f"phase 5: {name} {family} call {n_out}x{n_steps}x{n_inner}"
                  f": kernel {ms:.3f} ms (its phase-2 call), "
                  f"{inner_steps / ms * 1e3:.4e} inner path-steps/s = "
                  f"{ms / ref_ms[name]:.2f}x the {ref_label} kernel "
                  f"({ref_ms[name]:.3f} ms) {tag}")
            family_nmc_report(family, fam, prm, struct, name, ms, tag)
    return out


def traj_alone_report(family, fam, prm, key, call, cfg, row, regs, tag):
    """Phase 5: the family trajectories kernel alone at cfg's outer grid,
    launched through the library's entry point in batches of >= 5 ms (a
    call through its wrapper is mostly host time at 16,384 x 100), beside
    its bound (probe_bound), its block's threads, dynamic shared bytes and
    resident blocks per SM."""
    from mc_tpu_torch import nmc_engine as ne
    from mc_tpu_torch.ops import _cuda

    lib = _cuda.load()
    n_blocks = min(_cuda.cdiv(cfg.n_paths,
                              lib.mc_family_trajectories_block_paths()),
                   _cuda.MAX_BLOCKS)
    out = torch.empty((fam.n_grids + 1, cfg.n_steps, cfg.n_paths),
                      dtype=torch.float32, device=prm.device)
    part = torch.empty((n_blocks, 2), dtype=torch.float64, device=prm.device)
    args = (fam.cuda_id, call.cuda_id, int(key[0]), int(key[1]),
            prm.data_ptr(), _cuda.family_extras(fam.extras), cfg.n_steps,
            cfg.n_paths, 0, cfg.n_paths, _cuda.pointer_array(out[:fam.n_grids]),
            fam.n_grids, out[fam.n_grids].data_ptr(), part.data_ptr(), n_blocks,
            _cuda.stream_handle(prm.device))
    ms, spread, batch = cuda_ms(lambda: _cuda.check(
        lib.mc_family_trajectories(*args), "family_trajectories kernel"))
    b_ms, by = probe_bound("family_trajectories", family=family,
                           n_paths=cfg.n_paths, n_steps=cfg.n_steps,
                           d=fam.extras[0] if family in ("basket", "rainbow")
                           else None,
                           kmax=fam.extras[0] if family in ("merton", "bates")
                           else 0)
    lay = ne.family_trajectories_layout(fam, call, cfg.n_paths)
    print(f"phase 5: {row} {family} call {cfg.n_paths}x{cfg.n_steps}, the "
          f"kernel alone: {ms:.5f} ms (spread {spread:.1%}, batches of "
          f"{batch}), {b_ms / ms:.1%} of its bound ({b_ms:.5f} ms, {by}); "
          f"{lay['threads']} threads a block, {lay['blocks_per_sm']} "
          f"blocks/SM, {lay['smem_bytes']} B dynamic shared; registers "
          f"{regs} {tag}")


@functools.lru_cache(maxsize=None)
def family_nmc_bounds() -> dict:
    """bound_ms of every family's #29/#30 row at NMC_MAIN (phase 6's)."""
    import mc_tpu_torch as mt

    rows = {**heston_bounds(), **jump_bounds(),
            **single_bounds(single_families(mt)), **fx_rainbow_qmc_bounds()}
    return {k: v[0] for k, v in rows.items()
            if k.startswith(("family_fused", "family_inner"))}


@functools.lru_cache(maxsize=None)
def build_resources() -> dict:
    """ptxas_resources of the whole build."""
    from mc_tpu_torch.ops import _cuda

    return ptxas_resources(_cuda.build_info.get("ptxas", ""))


def family_nmc_report(family, fam, prm, struct, name, ms, tag) -> None:
    """Phase 5: a family's fused or inner kernel (``name``) at NMC_MAIN, its
    time ``ms`` beside its share of the bound, its registers and spills
    (VanillaCall, ptxas), its resident blocks per SM, its shared memory
    (the staged pack and table at this call's geometry, and ptxas's static
    bytes) and its legs a thread."""
    from mc_tpu_torch import nmc_engine as ne
    from mc_tpu_torch.ops.payoffs import get_payoff

    b_ms = family_nmc_bounds()[name if family == "heston"
                               else f"{name}_{family}"]
    res = build_resources().get((f"{name}_kernel<{struct}>", "VanillaCall",
                                 None), {})
    geo = ne.family_launch(fam, NMC_MAIN[2], prm.numel())
    blocks = ne.family_occupancy(fam, get_payoff("vanilla_call"),
                                 name == "family_fused", geo.smem_bytes)
    print(f"phase 5: {name} {family} call {'x'.join(map(str, NMC_MAIN))}: "
          f"{ms:.3f} ms, {b_ms / ms:.1%} of its bound ({b_ms:.2f} ms); "
          f"registers {res.get('registers')}, spill stores/loads "
          f"{res.get('spill_stores')}/{res.get('spill_loads')} B (stack "
          f"{res.get('stack')} B), {blocks} blocks/SM, shared "
          f"{geo.smem_bytes} B dynamic "
          f"({'pack staged' if geo.staged else 'pack read in place'}) + "
          f"{res.get('smem')} B static, kLegs {fam.legs} {tag}")


def sim_key(po, cfg=None):
    """The ptxas key of simulate_kernel<Payoff, rounds, Euler, antithetic,
    moments> (#2, simulate.cuh: a kernel per mode; the six terminal-only
    payoffs share TerminalOnly's) that a config launches (default:
    threefry-13 Euler, plain, 2 moments)."""
    struct = "TerminalOnly" if po.terminal_only else type(po).__name__
    if cfg is None:
        return ("simulate_kernel", struct, (13, 1, 0, 2))
    return ("simulate_kernel", struct, (cfg.rng_rounds,
                                        int(cfg.method == "euler"),
                                        int(cfg.antithetic), cfg.n_moments))


def tp_occupancy() -> int:
    """Resident blocks per SM of terminal_pair_kernel (the call, threefry-13)."""
    from mc_tpu_torch.ops import _cuda

    blocks = ctypes.c_int(0)
    _cuda.check(_cuda.load().mc_terminal_pair_occupancy(ctypes.byref(blocks)),
                "mc_terminal_pair_occupancy")
    return blocks.value


def simulate_layout(po, cfg) -> str:
    """Phase 5: the registers and spills (ptxas) and resident blocks per SM
    of the simulate kernel a config launches."""
    from mc_tpu_torch.ops import _cuda

    res = build_resources().get(sim_key(po, cfg), {})
    blocks = ctypes.c_int(0)
    _cuda.check(_cuda.load().mc_simulate_occupancy(
        po.cuda_id, int(cfg.method == "euler"), int(cfg.antithetic),
        int(cfg.with_cv), ctypes.byref(blocks)), "mc_simulate_occupancy")
    return (f"registers {res.get('registers')}, spill stores/loads "
            f"{res.get('spill_stores')}/{res.get('spill_loads')} B, "
            f"{blocks.value} blocks/SM")


def share(mask) -> float:
    return float(mask.double().mean())


def ptxas_resources(log: str) -> dict:
    """{(kernel, payoff struct, rounds or None): {"registers", "stack",
    "spill_stores", "spill_loads", "smem"}} from the ``-Xptxas -v`` log:
    each "Compiling entry function" line names a mangled
    mc::kernel<Payoff[, ROUNDS]>, its frame and "Used N registers" follow
    (the basket's partials kernel<Payoff, capacity, antithetic>: rounds
    (capacity, 0 or 1))."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN2mc(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            kernel, rest = m.group(2)[:n], m.group(2)[n:]
            p = re.match(r"INS_(\d+)", rest)
            b = re.match(r"ILb(\d)E", rest)  # sum_kernel<bool>
            payoff = (rest[p.end():p.end() + int(p.group(1))] if p
                      else f"bool{b.group(1)}" if b else None)
            f = (re.match(r"(?:ILi(\d+)EE)?ENS_(\d+)",
                          rest[p.end() + len(payoff):]) if p else None)
            if f and payoff.endswith("Family"):  # kernel<Family[<N>], Payoff>
                cap = f"<{f.group(1)}>" if f.group(1) else ""
                kernel = f"{kernel}<{payoff}{cap}>"
                at = p.end() + len(payoff) + f.end()
                payoff = rest[at:at + int(f.group(2))]
            elif f and kernel.endswith("_partials_kernel"):
                # merton_partials_kernel<Payoff, Method, R, bool>,
                # bates_partials_kernel<Payoff, Scheme, R>
                at = p.end() + len(payoff) + f.end()
                kernel = f"{kernel}<{rest[at:at + int(f.group(2))]}>"
            r = re.search(r"ELi(\d+)E(?:Lb(\d)E)?", rest)
            rounds = int(r.group(1)) if r else None
            if r and r.group(2) is not None:  # kernel<P, N, bool>
                rounds = (rounds, int(r.group(2)))
            ints = re.findall(r"L[ib](\d+)E", rest[p.end():]) if p else []
            if len(ints) > 2:  # localvol_partials_kernel<P, R, C, bool>,
                # sabr_partials_kernel<P, R, unit beta, antithetic>,
                # simulate_kernel<P, R, Euler, antithetic, moments>
                rounds = tuple(int(i) for i in ints)
            if kernel in ("book_kernel", "ladder_kernel") and ints:
                rounds = int(ints[0])  # book_kernel<P, CV>, ladder_kernel<P, euler>
            if kernel in ("cev_partials_kernel", "divs_partials_kernel"):
                # cev_partials_kernel<P, A>, divs_partials_kernel<P, A, table>
                rounds = tuple(int(i) for i in ints)
            if kernel == "fx_partials_kernel":  # <contract, rounds>
                rounds = tuple(int(i) for i in re.findall(r"Li(\d+)E", rest))
            if kernel.startswith("family_trajectories_kernel<") and ints:
                rounds = int(ints[-1])  # <Family, Payoff, split>
            entry = (kernel, payoff, rounds)
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[entry].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            s = re.search(r"(\d+) bytes smem", line)
            out[entry].update(registers=int(m.group(1)),
                              smem=int(s.group(1)) if s else 0)
            entry = None
    return out


def ladder_regs(lib, regs, po) -> dict:
    """The registers of a payoff's ladder kernels, by mode and paths a
    thread (ladder_kernel<Payoff, euler>: the terminal one for a payoff
    without state, the Euler one)."""
    modes = (0, 1) if po.terminal_only else (1,)
    return {f"{('terminal', 'euler')[e]} P={lib.mc_ladder_paths_per_thread(e)}":
            regs.get(("ladder_kernel", type(po).__name__, e)) for e in modes}


def ptxas_registers(log: str) -> dict:
    """{(kernel, payoff struct, rounds or None): registers} from the
    ``-Xptxas -v`` log (ptxas_resources)."""
    return {k: v["registers"] for k, v in ptxas_resources(log).items()
            if "registers" in v}


def book_options(mt, n_contracts: int):
    """bench.py:586-609's book: strikes U(80, 120) and vols U(0.1, 0.4) from
    default_rng(7), S0 = 100, T = 1, r = 0.1, B = 120, window [10, 50]."""
    rng_np = np.random.default_rng(7)
    b = n_contracts
    return mt.OptionParams(
        s0=np.full(b, 100.0, np.float32), t=np.full(b, 1.0, np.float32),
        k=rng_np.uniform(80, 120, b).astype(np.float32),
        r=np.full(b, 0.1, np.float32),
        sigma=rng_np.uniform(0.1, 0.4, b).astype(np.float32),
        barrier=np.full(b, 120.0, np.float32),
        p1=np.full(b, 10.0, np.float32), p2=np.full(b, 50.0, np.float32),
        q=np.zeros(b, np.float32))


def contract(mt, book, b: int):
    return mt.OptionParams(*(float(v[b]) for v in book.astuple()))


def payoff_option(mt, name):
    return mt.OptionParams(**PAYOFF_OPTIONS.get(name, {}))


def check_sums(name, got, want, rtol: float = SUMS_RTOL) -> float:
    """Phase 2: finished f64 sums of a kernel against its plain version's,
    to f64 rounding (the same f32 values per path, added in another
    order), within ``rtol``.  Returns the largest relative difference."""
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-300)).max())
    ok = rel <= rtol
    print(f"phase 2: {name}: {share(got == want):.2f} of the sums bitwise,"
          f" max rel {rel:.3e} (limit {rtol}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: the kernel disagrees with its plain version")
    return rel


# --- phase 2 in two passes ---------------------------------------------------
# A family's check is a generator: its plain versions run up to its
# ``yield``, its kernels after it.  ``defer`` runs the plain half at once, on
# the card while nvcc builds the kernels on the host's other cores, and keeps
# the rest; ``run_deferred`` runs the kernel halves in the
# same order once the library has loaded.  Every check keeps its inputs,
# shape and tolerance; only its halves run apart.

_DEFERRED = []


def defer(check, sink=None) -> None:
    """Run ``check``'s plain half now; its kernel half, whose return value
    goes to ``sink``, waits for ``run_deferred``."""
    next(check)
    _DEFERRED.append((check, sink))


def run_deferred() -> int:
    """Run every deferred check's kernel half, in order; returns their
    count."""
    done = len(_DEFERRED)
    for check, sink in _DEFERRED:
        try:
            next(check)
        except StopIteration as end:
            if sink is not None:
                sink(end.value)
        else:
            raise RuntimeError("a phase-2 check yielded twice")
    _DEFERRED.clear()
    return done


# --- #2's edges, deferred --------------------------------------------------


def simulate_edge_checks(mt, dev, key, check, errs):
    """Phase 2 of #2's edges (BARRIER_EDGES, EDGE_STEPS), each check
    deferred (its plain half in the first pass): the barrier payoffs' block
    threshold and a resumed path's own (resume spots +-0 and -50 among the
    plain trajectories' at an odd start of an odd count), the spot formed
    once at maturity or at each step, plain and antithetic with the
    control.  ``check(name, label, got, want)`` holds a row to its plain
    version (the GBM tolerances); its errors go to ``errs``."""
    from mc_tpu_torch import engines
    from mc_tpu_torch.ops import path_kernels as pk
    from mc_tpu_torch.ops.payoffs import get_payoff
    from mc_tpu_torch.ops.reduce import finish_sum

    def case(po, cfg, opt, **resume):
        prm = pk.pack_params(opt, cfg.n_steps, dev)
        ex = (engines.control_mean(po, prm)
              if cfg.with_cv and po.has_control else None)
        want = engines.finish_price(finish_sum(pk.simulate_partials_plain(
            po, cfg, key, prm, **resume)), cfg.n_paths, opt, cfg.with_cv, ex)
        yield
        got = engines.finish_price(finish_sum(pk.simulate_partials(
            po, cfg, key, prm, **resume)), cfg.n_paths, opt, cfg.with_cv, ex)
        return check(po.name, f"simulate_partials {po.name} {cfg.method} "
                     f"{cfg.n_paths}x{cfg.n_steps} anti={cfg.antithetic} "
                     f"cv={cfg.with_cv} start={cfg.start_step} {opt}",
                     got, want)

    start = RESUME_STEPS[1]
    grid_s, grid_c, _ = pk.simulate_trajectories_plain(
        get_payoff("bullet_call"), pk.KernelConfig(
            n_paths=EDGE_PATHS, n_steps=MAIN_STEPS), key,
        pk.pack_params(mt.DEMO_OPTION, MAIN_STEPS, dev))
    s_edge = grid_s[start - 1].clone()
    s_edge[::7] = torch.tensor([0.0, -0.0, -50.0], device=dev).repeat(
        len(s_edge[::7]))[:len(s_edge[::7])]
    resume = dict(s_init=s_edge, state_init=grid_c[start - 1].contiguous())
    for kw in (dict(), dict(antithetic=True, with_cv=True)):
        for name in ("vanilla_call", "bullet_call", "asian_call"):
            for n_steps in edge_steps(name):
                defer(case(get_payoff(name), pk.KernelConfig(
                    n_paths=EDGE_PATHS, n_steps=n_steps, **kw),
                    payoff_option(mt, name)), errs.append)
        for name in ("bullet_call", "up_out_call", "down_in_call"):
            for fix in BARRIER_EDGES:
                defer(case(get_payoff(name), pk.KernelConfig(
                    n_paths=EDGE_PATHS, n_steps=MAIN_STEPS, **kw),
                    dataclasses.replace(payoff_option(mt, name), **fix)),
                    errs.append)
            for fix in ({}, dict(barrier=0.0), dict(barrier=math.inf)):
                defer(case(get_payoff(name), pk.KernelConfig(
                    n_paths=EDGE_PATHS, n_steps=MAIN_STEPS + 1,
                    start_step=start, **kw),
                    dataclasses.replace(payoff_option(mt, name), **fix),
                    **resume), errs.append)


# --- the Heston slice: kernels #12, #13, #29, #30 ---------------------------


def price_err(got, want, n_paths, opt) -> float:
    """Largest |d price|, |d stderr| of two finished moment sums."""
    from mc_tpu_torch.engines import finish_price

    g = finish_price(got, n_paths, opt)
    w = finish_price(want, n_paths, opt)
    return max(abs(float(g.price) - float(w.price)),
               abs(float(g.stderr) - float(w.stderr)))


def check_bitwise(name, got, want) -> float:
    """Phase 2: grids and surfaces, kernel against plain version, bit for
    bit.  Returns the largest absolute difference."""
    same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    print(f"phase 2: {name}: " + ", ".join(
        f"{share(a == b):.6f}" for a, b in zip(got, want))
          + f" of entries bitwise, max |d| {err:.3e} "
          f"{'ok' if all(same) else 'MISMATCH'}")
    if not all(same):
        fail(f"{name}: the kernel's grids disagree with its plain version")
    return err


def timed_call(fn):
    """(fn(), its device ms by CUDA events): one call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def family_nmc_case(mt, dev, fam, pack, dyn, keys, name, shape, note,
                    rows=None, what=""):
    """Phase 2: family ``fam``'s fused and inner kernels and its outer
    trajectories at ``shape`` against their plain versions: grids, the
    surface (whole, or only its ``rows``), the trajectories' payoff sums
    and the outer moments bitwise or to f64 rounding, and the fused surface == the inner's (grid == fused)
    in every row.  ``note(kind, err)`` takes the kinds "trajectories",
    "fused" and "inner"; ``what`` names the case's dynamics.  A deferred check (its plain half first); returns
    {"plain": the plain rows' ms, "fused", "inner": the kernels' ms (CUDA
    events, this one call each: phase 5's times of the family kernels)}."""
    from mc_tpu_torch import nmc_engine as ne
    from mc_tpu_torch.ops.payoffs import get_payoff
    from mc_tpu_torch.ops.reduce import finish_sum

    key, key_in = keys
    po, opt = get_payoff(name), payoff_option(mt, name)
    n_out, n_steps, n_inner = shape
    cfg = ne.FamilyConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
    prm = pack(opt, dyn, n_steps, dev)
    label = spaced(fam.name, what, name, "x".join(map(str, shape)))
    *g_p, st_p, outer_p = fam.trajectories_plain(po, cfg, key, prm)
    rows = list(range(n_steps)) if rows is None else list(rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ne.family_rows_plain(fam, po, cfg, key_in, prm, g_p, st_p, rows)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    yield
    (surf_f, outer_f), fused_ms = timed_call(
        lambda: ne.family_fused(fam, po, cfg, key, key_in, prm))
    *g_k, st_k, traj_k = fam.trajectories(po, cfg, key, prm)
    surf_i, inner_ms = timed_call(
        lambda: ne.family_inner(fam, po, cfg, key_in, prm, g_k, st_k))
    note("trajectories", check_bitwise(
        f"{fam.name} trajectories {label} (grids, state)", (*g_k, st_k),
        (*g_p, st_p)))
    got, want_o = finish_sum(traj_k), finish_sum(outer_p)
    check_sums(f"{fam.name} trajectories {label} payoff", got, want_o)
    note("trajectories", price_err(got, want_o, n_out, opt))
    which = "" if len(rows) == n_steps else f" rows {rows}"
    note("fused", check_bitwise(
        f"family_fused {label}{which} (plain {plain_ms:.1f} ms)",
        (surf_f[rows],), (want,)))
    note("inner", check_bitwise(f"family_inner {label}{which}",
                                (surf_i[rows],), (want,)))
    check_bitwise(f"grid == fused {label} (every row)", (surf_i,), (surf_f,))
    got, want_o = finish_sum(outer_f), finish_sum(outer_p)
    check_sums(f"family_fused {label} outer moments", got, want_o)
    note("fused", price_err(got, want_o, n_out, opt))
    return {"plain": plain_ms, "fused": fused_ms, "inner": inner_ms}


def heston_kernel_checks(mt, dev, keys):
    """Phase 2 of the Heston slice: kernels #12 (QE also at QE_EDGES), #13,
    #29 and #30 against their plain versions on the card, each check
    deferred.  Returns
    ({kernel: max abs error}, family_nmc_case's ms at NMC_MAIN), filled by
    the kernel pass."""
    from mc_tpu_torch.models import heston as hm
    from mc_tpu_torch.nmc_heston import HestonNMC
    from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff
    from mc_tpu_torch.ops.reduce import finish_sum

    key, key_in = keys
    err = dict.fromkeys(HESTON_KERNELS, 0.0)
    dyn = hm.DEMO_HESTON

    def note(kernel, e):
        err[kernel] = max(err[kernel], e)

    def partials_case(name, n_paths, dynamics=dyn, option=None,
                      n_steps=MAIN_STEPS, label="", **kw):
        po = get_payoff(name)
        opt = option or payoff_option(mt, name)
        cfg = hm.HestonConfig(n_paths=n_paths, n_steps=n_steps, **kw)
        prm = hm.pack_heston(opt, dynamics, n_steps, dev)
        want = finish_sum(hm.heston_partials_plain(po, cfg, key, prm))
        yield
        got = finish_sum(hm.heston_partials(po, cfg, key, prm))
        check_sums(f"heston_partials {name} {cfg.scheme}{label} {n_paths}x"
                   f"{n_steps} {cfg.rng_source} anti={cfg.antithetic}",
                   got, want)
        note("heston_partials", price_err(got, want, n_paths, opt))

    for name in sorted(PAYOFFS):
        if name not in hm.SIGMA_PAYOFFS:
            defer(partials_case(name, FAMILY_PATHS))
    for name in ("vanilla_call", "asian_call", "bullet_call"):
        for kw in (dict(scheme="qe"), dict(rng_source="threefry"),
                   dict(antithetic=True),
                   dict(scheme="qe", rng_source="threefry", antithetic=True)):
            defer(partials_case(name, FAMILY_PATHS, **kw))
    for scheme in ("euler", "qe"):  # the main shape: a partly filled block
        defer(partials_case("vanilla_call", FAMILY_MAIN, scheme=scheme))
    # #12 Euler's antithetic kernel at the main shape, and the edges of its
    # legs (BARRIER_EDGES, EDGE_STEPS), plain and antithetic
    defer(partials_case("vanilla_call", FAMILY_MAIN, antithetic=True))
    for anti in (False, True):
        for name in ("vanilla_call", "asian_call", "bullet_call"):
            for n_steps in (n for n in EDGE_STEPS if n):  # HestonConfig
                defer(partials_case(name, EDGE_PATHS, n_steps=n_steps,
                                    antithetic=anti))
        for name in ("bullet_call", "up_out_call", "down_in_call"):
            for fix in BARRIER_EDGES:
                defer(partials_case(
                    name, EDGE_PATHS, option=dataclasses.replace(
                        payoff_option(mt, name), **fix), label=f" {fix}",
                    antithetic=anti))
    # #12 QE's other branches: the exponential sampler and the plain-K0
    # fall-backs (QE_EDGES)
    for edge, (dynamics, option, n_steps) in qe_edges(mt, hm).items():
        for name, kw in qe_edge_runs(edge):
            defer(partials_case(name, FAMILY_PATHS, dynamics, option, n_steps,
                                f" {edge}", scheme="qe", **kw))

    def traj_case(name, n_paths):
        po, opt = get_payoff(name), payoff_option(mt, name)
        cfg = hm.HestonConfig(n_paths=n_paths, n_steps=MAIN_STEPS)
        prm = hm.pack_heston(opt, dyn, MAIN_STEPS, dev)
        *g_p, part_p = hm.heston_trajectories_plain(po, cfg, key, prm)
        yield
        *g_k, part_k = hm.heston_trajectories(po, cfg, key, prm)
        label = f"heston_trajectories {name} {n_paths}x{MAIN_STEPS}"
        note("heston_trajectories",
             check_bitwise(f"{label} (S, v, state)", g_k, g_p))
        got, want = finish_sum(part_k), finish_sum(part_p)
        check_sums(f"{label} payoff", got, want)
        note("heston_trajectories", price_err(got, want, n_paths, opt))

    for name, po in sorted(PAYOFFS.items()):
        if po.n_state <= 1:
            defer(traj_case(name, FAMILY_PATHS))
    defer(traj_case("bullet_call", HESTON_PAYOFF_MAIN))

    fam = HestonNMC()
    # #13 is the family template's: its ragged and wide edges
    traj_ragged(mt, dev, note, "heston_trajectories", fam, hm.pack_heston,
                dyn, key)
    kinds = {"trajectories": "heston_trajectories", "fused": "family_fused",
             "inner": "family_inner"}

    def family_note(kind, e):
        note(kinds[kind], e)

    for name in ("bullet_call", "asian_call", "vanilla_call"):
        defer(family_nmc_case(mt, dev, fam, hm.pack_heston, dyn, keys, name,
                              NMC_SMALL, family_note))
    defer(family_nmc_case(mt, dev, fam, hm.pack_heston, dyn, keys,
                          "vanilla_call", ragged_shape("heston"), family_note))
    nmc_ms = {}
    defer(family_nmc_case(mt, dev, fam, hm.pack_heston, dyn, keys,
                          "vanilla_call", NMC_MAIN, family_note,
                          EARLIER_NMC_ROWS), nmc_ms.update)
    return err, nmc_ms


# The QE kernels' (#12, #16) phase-2 edges beyond the demo dynamics, whose
# psi stays under 0.5625: Heston's variance in the Feller-violating stress
# regime of tests/test_heston_qe.py (psi crosses 1.5 inside a warp: both
# samplers), and at rho = +0.9, xi = 2, kappa = 1 from v0 = 17 at dt = 2,
# where both samplers' martingale corrections fall back to the plain K0 on a
# share of the paths: {edge: (dynamics fields, option fields, steps)}.
QE_EDGES = {
    "stress": (dict(v0=0.09, kappa=1.0, theta=0.09, xi=1.0, rho=-0.9), {},
               MAIN_STEPS),
    "rho+0.9 fall-backs": (dict(v0=17.0, kappa=1.0, theta=0.09, xi=2.0,
                                rho=0.9), dict(t=4.0), 2)}


def qe_edges(mt, hm):
    """QE_EDGES as (HestonDynamics, OptionParams, steps)."""
    return {edge: (hm.HestonDynamics(**d), mt.OptionParams(**o), n)
            for edge, (d, o, n) in QE_EDGES.items()}


def qe_edge_runs(edge: str):
    """The payoffs and configurations a QE edge runs: the stress regime
    the call, the Asian and the bullet, plain and antithetic, and the call
    at threefry-20; the fall-backs the call, plain and antithetic."""
    if edge != "stress":
        return [("vanilla_call", dict(antithetic=a)) for a in (False, True)]
    return [(name, dict(antithetic=a))
            for name in ("vanilla_call", "asian_call", "bullet_call")
            for a in (False, True)] + [
        ("vanilla_call", dict(antithetic=True, rng_source="threefry"))]


def run_cli(argv) -> dict:
    """The last JSON line ``python -m mc_tpu_torch <argv>`` prints, run in
    this process (its launches count with the path's)."""
    import contextlib
    import io

    from mc_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"python -m mc_tpu_torch {' '.join(argv)} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def heston_times(mt, dev, keys, regs, tag, time_pair, gbm_ms, nmc_ms,
                 e2e_nmc):
    """Phase 5 of the Heston slice: each kernel (CUDA events) beside its
    plain version and beside the GBM kernel of the same shape (``gbm_ms``:
    trajectories at 100,000 x 100, the two NMC kernels at NMC_MAIN), the
    registers, and the e2e calls.  The family kernels' times are their
    phase-2 calls' (``nmc_ms``), the NMC calls' their phase-3 calls'
    (``e2e_nmc``).  Returns {kernel: (ms, plain ms)} (the family kernels'
    plain ms is measured in phase 2)."""
    from mc_tpu_torch import nmc_engine as ne
    from mc_tpu_torch.models import heston as hm
    from mc_tpu_torch.nmc_heston import HestonNMC
    from mc_tpu_torch.ops import _cuda
    from mc_tpu_torch.ops import path_kernels as pk
    from mc_tpu_torch.ops.payoffs import get_payoff

    key = keys[0]
    call = get_payoff("vanilla_call")
    dyn = mt.DEMO_HESTON
    prm = hm.pack_heston(mt.DEMO_OPTION, dyn, MAIN_STEPS, dev)
    out = {}
    gbm_cfg = pk.KernelConfig(n_paths=FAMILY_MAIN, n_steps=MAIN_STEPS)
    gbm_sim, sp, _ = cuda_ms(lambda: pk.simulate_partials(
        call, gbm_cfg, key, pk.pack_params(mt.DEMO_OPTION, MAIN_STEPS, dev)))
    steps = FAMILY_MAIN * MAIN_STEPS
    # Euler, QE and QE antithetic (the kernel alone: its plain version
    # repeats the call's)
    for scheme, anti, row in (("euler", False, "heston_partials"),
                              ("euler", True, "euler_anti"),
                              ("qe", False, "qe"), ("qe", True, "qe_anti")):
        cfg = hm.HestonConfig(n_paths=FAMILY_MAIN, n_steps=MAIN_STEPS,
                              scheme=scheme, antithetic=anti)
        label = f"heston_partials call {scheme}{' antithetic' if anti else ''}"
        if anti:
            k_ms, k_sp, _ = cuda_ms(lambda cfg=cfg: hm.heston_partials(
                call, cfg, key, prm))
            print(f"phase 5: {label} {FAMILY_MAIN}x{MAIN_STEPS}: kernel "
                  f"{k_ms:.4f} ms (spread {k_sp:.1%}) {tag}")
            out[row] = (k_ms, None)
        else:
            out[row] = time_pair(
                label, lambda cfg=cfg: hm.heston_partials(call, cfg, key, prm),
                lambda cfg=cfg: hm.heston_partials_plain(call, cfg, key, prm),
                f"{FAMILY_MAIN}x{MAIN_STEPS}")
            k_ms = out[row][0]
        res = build_resources().get((f"heston_{scheme}_kernel", "VanillaCall",
                                     (13, int(anti))), {})
        blocks = ctypes.c_int(0)
        _cuda.check(_cuda.load().mc_heston_occupancy(
            int(scheme == "qe"), int(anti), ctypes.byref(blocks)),
            "mc_heston_occupancy")
        print(f"phase 5: {label}: {steps / k_ms * 1e3:.4e}"
              f" path-steps/s; {k_ms / gbm_sim:.2f}x the GBM simulate_partials"
              f" call euler on the same shape ({gbm_sim:.4f} ms, spread "
              f"{sp:.1%}); registers {res.get('registers')}, spill "
              f"stores/loads {res.get('spill_stores')}/"
              f"{res.get('spill_loads')} B, {blocks.value} blocks/SM {tag}")
    bullet = get_payoff("bullet_call")
    cfg_t = hm.HestonConfig(n_paths=HESTON_PAYOFF_MAIN, n_steps=MAIN_STEPS)
    out["heston_trajectories"] = time_pair(
        "heston_trajectories bullet",
        lambda: hm.heston_trajectories(bullet, cfg_t, key, prm),
        lambda: hm.heston_trajectories_plain(bullet, cfg_t, key, prm),
        f"{HESTON_PAYOFF_MAIN}x{MAIN_STEPS}")
    k_ms = out["heston_trajectories"][0]
    grid_bytes = 3 * 4 * HESTON_PAYOFF_MAIN * MAIN_STEPS
    # #13 is the family template's: its split and one-thread-a-path kernels
    traj_regs = {split: regs.get(("family_trajectories_kernel<HestonFamily>",
                                  "BulletCall", split)) for split in (1, 0)}
    print(f"phase 5: heston_trajectories writes {grid_bytes / 1e6:.1f} MB in "
          f"{k_ms:.4f} ms: {grid_bytes / k_ms / 1e6:.1f} GB/s; "
          f"{k_ms / gbm_ms['trajectories']:.2f}x the GBM trajectories kernel "
          f"({gbm_ms['trajectories']:.4f} ms); registers {traj_regs} {tag}")
    # alone at the grid NMC's outer grid, the split kernel
    traj_alone_report("heston", HestonNMC(), prm, key, call,
                      ne.FamilyConfig(n_paths=NMC_MAIN[0], n_steps=MAIN_STEPS,
                                      n_inner=1), "heston_trajectories",
                      {split: regs.get((
                          "family_trajectories_kernel<HestonFamily>",
                          "VanillaCall", split)) for split in (1, 0)}, tag)

    n_out, n_steps, n_inner = NMC_MAIN
    inner_steps = n_out * n_inner * n_steps * (n_steps - 1) // 2
    for name in ("family_fused", "family_inner"):
        ms = nmc_ms[name.split("_")[1]]
        print(f"phase 5: {name} heston call {n_out}x{n_steps}x{n_inner}: "
              f"kernel {ms:.3f} ms (its phase-2 call), "
              f"{inner_steps / ms * 1e3:.4e} inner path-steps/s {tag}")
        gbm = gbm_ms["nmc_fused" if name == "family_fused" else "nmc_inner"]
        out[name] = (ms, None)
        print(f"phase 5: {name} heston: {ms:.3f} ms = {ms / gbm:.2f}x the GBM"
              f" bullet NMC kernel on the same shape ({gbm:.3f} ms) {tag}")
        family_nmc_report("heston", HestonNMC(), prm, "HestonFamily", name,
                          ms, tag)

    osim = mt.SimParams(n_paths=FAMILY_MAIN, n_steps=MAIN_STEPS)
    e2e_report((
            (f"price_heston() euler {FAMILY_MAIN}x{MAIN_STEPS}",
             "path-steps/s", steps,
             lambda: mt.price_heston(sim=osim, device=DEVICE)),
            (f"price_heston() qe {FAMILY_MAIN}x{MAIN_STEPS}", "path-steps/s",
             steps, lambda: mt.price_heston(sim=osim, scheme="qe",
                                            device=DEVICE)),
            *nmc_e2e_rows("heston", e2e_nmc)), tag)
    return out


def heston_bounds():
    """bound() of the four Heston rows at the shapes the kernels line
    reports: #12 Euler at 1M x 100, #13 at 100,000 x 100, the family
    kernels at NMC_MAIN (vanilla)."""
    euler_path = _add(_scale(_add(pair_ops(13), HESTON_EULER_OPS), MAIN_STEPS),
                      TERMINAL_OPS)  # S at each step: #13, the outer legs
    n_out, n_steps, n_inner = NMC_MAIN
    substeps = n_out * n_inner * n_steps * (n_steps - 1) // 2
    legs = n_out * n_inner * n_steps
    inner = _add(_scale(_add(pair_ops(13), HESTON_EULER_OPS), substeps),
                 _scale(KAHAN_LEG_OPS, legs))
    outer = _scale(euler_path, n_out)
    surface = 4 * n_out * n_steps
    return {
        "heston_partials": bound(68, _scale(
            heston_euler_path("vanilla_call", MAIN_STEPS), FAMILY_MAIN)),
        "heston_trajectories": bound(
            3 * 4 * HESTON_PAYOFF_MAIN * MAIN_STEPS,
            _scale(euler_path, HESTON_PAYOFF_MAIN)),
        "family_fused": bound(surface, _add(inner, outer)),
        # the S and v grids and the surface (a vanilla call has no state)
        "family_inner": bound(3 * surface, inner),
    }


# --- the jump slice: kernels #14, #15, #16, the generic trajectories and
# the Merton and Bates instantiations of #29 and #30 ------------------------


def unit_ops(rounds: int, words: int):
    """One threefry2x32 call and bits_to_unit of ``words`` of its words."""
    return (2 + 3 * rounds + 2 * (rounds // 4) + 2 * words, words, 0)


def table_ops(kmax: int):
    """The Poisson count against the block's cdf table: a compare-select
    and an add per entry (the table itself is built once a block; the
    scan's recurrence, its expf and kmax divisions, no longer run a
    draw)."""
    return _scale((0, 2, 0), kmax)


# A Merton step on top of its draws and count: w (3), S = base*expf(w) (1);
# the jump n*mu_j + (sigma_j*sqrtf(n))*e (4 and a sqrtf) and w + jump (1).
MERTON_DIFF_OPS = (0, 4, 1)
MERTON_JUMP_OPS = (0, 5, 1)
MERTON_STEP_OPS = _add(MERTON_DIFF_OPS, MERTON_JUMP_OPS)
# Bates's jump on top of Heston's Euler step (HESTON_EULER_OPS): the jump
# (4 and a sqrtf) and w += jump (1).
BATES_JUMP_OPS = (0, 5, 1)


def merton_path(n_steps: int, rounds: int, kmax: int, lam_dt: float):
    """A Merton Euler path: per step pair the diffusion normals and both
    Poisson uniforms (two threefry calls), a compare of each uniform with
    the table's least entry F(0) = exp(-lam*dt), the two diffusion steps;
    and only where a uniform of the pair reaches the table (a share 1 -
    F(0)^2 of the pairs: the count is 0 below it, and a count of 0 is no
    jump whatever the jump sizes) the jump-size normals, the counts against
    the table and the jumps; its payoff."""
    reach = 1.0 - math.exp(-lam_dt) ** 2
    jumps = _add(pair_ops(rounds),
                 _scale(_add(table_ops(kmax), MERTON_JUMP_OPS), 2))
    pair = _add(pair_ops(rounds), unit_ops(rounds, 2), (0, 2, 0),
                _scale(MERTON_DIFF_OPS, 2), _scale(jumps, reach))
    return _add(_scale(pair, n_steps // 2), TERMINAL_OPS)


def merton_substep(kmax: int):
    """An inner Merton substep: the (z, e) pair, the uniform, the step, the
    count against the table."""
    return _add(pair_ops(13), unit_ops(13, 1), MERTON_STEP_OPS, table_ops(kmax))


def bates_step(rounds: int, kmax: int):
    """A Bates Euler step: two normal pairs, a uniform, Heston's step, the
    jump and the scan."""
    return _add(_scale(pair_ops(rounds), 2), unit_ops(rounds, 1),
                HESTON_EULER_OPS, BATES_JUMP_OPS, table_ops(kmax))


def qe_path(n_steps: int, kmax: int = 0, lam_dt: float = 0.0, legs: int = 1):
    """A Heston (kmax 0) or Bates QE path of ``legs`` legs on one draw (2:
    an antithetic path): per step the diffusion pair and each leg's
    quadratic QE step (HESTON_QE_OPS); under Bates also the Poisson
    uniform, each leg's compare with the table's least entry F(0) and its w
    += jump, and only where a leg's uniform reaches the table (a share 1 -
    F(0) of the steps a leg, at most ``legs`` times that for the path: a
    count of 0 is no jump whatever the jump size) the jump-size pair and
    each leg's count against the table and its jump; per leg S =
    s0*expf(w) once and the payoff (the call reads S at maturity only)."""
    step = _add(pair_ops(13), _scale(HESTON_QE_OPS, legs))
    if kmax:
        reach = legs * (1.0 - math.exp(-lam_dt))
        jump = _add(pair_ops(13), _scale(_add(table_ops(kmax), (0, 4, 1)), legs))
        step = _add(step, unit_ops(13, 1), _scale((0, 2, 0), legs),
                    _scale(jump, reach))
    return _add(_scale(step, n_steps), _scale(_add((0, 1, 1), TERMINAL_OPS), legs))


def bates_substep(kmax: int):
    """An inner Bates substep: bates_step's draws, Heston's step and the
    jump, the count against the table."""
    return _add(_scale(pair_ops(13), 2), unit_ops(13, 1), HESTON_EULER_OPS,
                BATES_JUMP_OPS, table_ops(kmax))


def family_bounds(prefix: str, substep, path, n_grids: int):
    """bound() of a family's fused and inner kernels at NMC_MAIN (vanilla)
    from its inner substep's and outer path's operations."""
    n_out, n_steps, n_inner = NMC_MAIN
    substeps = n_out * n_inner * n_steps * (n_steps - 1) // 2
    legs = n_out * n_inner * n_steps
    inner = _add(_scale(substep, substeps), _scale(KAHAN_LEG_OPS, legs))
    surface = 4 * n_out * n_steps
    return {f"family_fused_{prefix}": bound(surface,
                                            _add(inner, _scale(path, n_out))),
            # the market grids and the surface (a vanilla call has no state)
            f"family_inner_{prefix}": bound((n_grids + 1) * surface, inner)}


def jump_kmax():
    """(kmax at lam*dt, kmax at lam*T) of the demo jumps at MAIN_STEPS."""
    from mc_tpu_torch.models.merton import DEMO_MERTON, poisson_kmax

    return (poisson_kmax(DEMO_MERTON.lam / MAIN_STEPS),
            poisson_kmax(DEMO_MERTON.lam))


def jump_bounds():
    """bound() of the jump slice's rows at the shapes the kernels line
    reports: #14 Euler at 1M x 100, #15 and the generic trajectories at
    NMC_MAIN's outer 16,384 x 100 (vanilla), #16 Euler at 1M x 100, the
    family kernels at NMC_MAIN (vanilla)."""
    k_dt, _ = jump_kmax()
    n_out, n_steps, _ = NMC_MAIN
    m_path, _ = family_traj_path("merton", MAIN_STEPS, kmax=k_dt)
    b_path, _ = family_traj_path("bates", MAIN_STEPS, kmax=k_dt)
    return {
        "merton_partials": bound(76, _scale(m_path, FAMILY_MAIN)),
        "merton_trajectories": bound(2 * 4 * n_out * n_steps,
                                     _scale(m_path, n_out)),
        "bates_partials": bound(80, _scale(b_path, FAMILY_MAIN)),
        "family_trajectories": bound(3 * 4 * n_out * n_steps,
                                     _scale(b_path, n_out)),
        **family_bounds("merton", merton_substep(k_dt), m_path, 1),
        **family_bounds("bates", bates_substep(k_dt), b_path, 2),
    }


def partials_check(note, row, fn, plain, cfg, key, prm, name, opt, label,
                   path_offset=0, n_valid=None):
    """Phase 2: a partials kernel (``fn``) against its plain version on one
    payoff (paths ``path_offset + i``, masked at ``n_valid``): the finished
    sums to f64 rounding; ``note(row, err)`` takes the largest price or
    stderr difference.  A deferred check."""
    from mc_tpu_torch.ops.payoffs import get_payoff
    from mc_tpu_torch.ops.reduce import finish_sum

    po = get_payoff(name)
    at = () if path_offset == 0 and n_valid is None else (path_offset,
                                                          n_valid)
    want = finish_sum(plain(po, cfg, key, prm, *at))
    yield
    got = finish_sum(fn(po, cfg, key, prm, *at))
    check_sums(f"{row} {name} {label} {cfg.n_paths}x{cfg.n_steps} "
               f"{getattr(cfg, 'rng_source', 'threefry13')} "
               f"anti={cfg.antithetic}"
               + (f" offset {path_offset} bound {n_valid}" if at else ""),
               got, want)
    note(row, price_err(got, want, cfg.n_paths, opt))


def traj_ragged(mt, dev, note, row, fam, pack, dyn, key):
    """Phase 2: traj_check's call and bullet at TRAJ_RAGGED and its call at
    TRAJ_WIDE, deferred."""
    n_paths, n_steps = TRAJ_RAGGED
    n_steps += n_steps % 2 * fam.even_steps
    for name in ("vanilla_call", "bullet_call"):
        defer(traj_check(mt, dev, note, row, fam, pack, dyn, key, name,
                         n_paths, n_steps))
    defer(traj_check(mt, dev, note, row, fam, pack, dyn, key, "vanilla_call",
                     *TRAJ_WIDE))


def traj_check(mt, dev, note, row, fam, pack, dyn, key, name, n_paths,
               n_steps=MAIN_STEPS):
    """Phase 2: a family's outer trajectories (its own kernel or the
    generic one) against their plain version: the grids bitwise, the payoff
    sums to f64 rounding.  A deferred check."""
    from mc_tpu_torch import nmc_engine as ne
    from mc_tpu_torch.ops.payoffs import get_payoff
    from mc_tpu_torch.ops.reduce import finish_sum

    po, opt = get_payoff(name), payoff_option(mt, name)
    cfg = ne.FamilyConfig(n_paths=n_paths, n_steps=n_steps, n_inner=1)
    prm = pack(opt, dyn, n_steps, dev)
    *g_p, part_p = fam.trajectories_plain(po, cfg, key, prm)
    yield
    *g_k, part_k = fam.trajectories(po, cfg, key, prm)
    label = f"{row} {fam.name} {name} {n_paths}x{n_steps}"
    note(row, check_bitwise(f"{label} (grids, state)", g_k, g_p))
    got, want = finish_sum(part_k), finish_sum(part_p)
    check_sums(f"{label} payoff", got, want)
    note(row, price_err(got, want, n_paths, opt))


def ragged_shape(family: str):
    """NMC_RAGGED, at 8 steps where the family's plain outer path takes
    steps in pairs."""
    n_out, n_steps, n_inner = NMC_RAGGED
    return (n_out, n_steps + (family in NMC_RAGGED_EVEN), n_inner)


def family_nmc_checks(mt, dev, note, family, fam, pack, dyn, keys,
                      traj_row, rows=None, extra=()):
    """Phase 2: a family's #29/#30 at NMC_SMALL (bullet, Asian, vanilla), at
    its ragged shape (every row) and at NMC_MAIN against the plain ``rows``
    (default EARLIER_NMC_ROWS), and the ``extra`` cases (fam, pack, payoff,
    shape, rows, what), deferred; returns family_nmc_case's ms at NMC_MAIN
    (filled by the kernel pass)."""
    kinds = {"trajectories": traj_row, "fused": f"family_fused_{family}",
             "inner": f"family_inner_{family}"}

    def family_note(kind, e):
        note(kinds[kind], e)

    for name in ("bullet_call", "asian_call", "vanilla_call"):
        defer(family_nmc_case(mt, dev, fam, pack, dyn, keys, name, NMC_SMALL,
                              family_note))
    defer(family_nmc_case(mt, dev, fam, pack, dyn, keys, "vanilla_call",
                          ragged_shape(family), family_note))
    for x_fam, x_pack, name, shape, x_rows, what in extra:
        defer(family_nmc_case(mt, dev, x_fam, x_pack, dyn, keys, name, shape,
                              family_note, x_rows, what))
    ms = {}
    defer(family_nmc_case(mt, dev, fam, pack, dyn, keys, "vanilla_call",
                          NMC_MAIN, family_note,
                          EARLIER_NMC_ROWS if rows is None else rows),
          ms.update)
    return ms


def jump_kernel_checks(mt, dev, merton_keys, bates_keys):
    """Phase 2 of the jump slice: #14 (every payoff, both methods,
    threefry-13/-20, antithetic; the main shapes 1M x 100 and 1M terminal),
    #15 and the generic trajectories (every one-word payoff), #16 (its 16
    payoffs, Euler and QE; 1M x 100; QE at QE_EDGES), and both families'
    #29/#30 at
    NMC_SMALL and at NMC_MAIN against the plain rows NMC_ROWS, each
    against its plain version on the card, deferred.  Returns ({row: max
    abs error}, {family: ms of the plain version's rows at NMC_MAIN}),
    filled by the kernel pass."""
    from mc_tpu_torch.models import bates as bm
    from mc_tpu_torch.models import heston as hm
    from mc_tpu_torch.models import merton as mm
    from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
    from mc_tpu_torch.nmc_bates import BatesNMC
    from mc_tpu_torch.nmc_merton import MertonNMC
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    err = dict.fromkeys(JUMP_ROWS, 0.0)
    k_dt, k_t = jump_kmax()

    def note(row, e):
        err[row] = max(err[row], e)

    def merton_case(name, n_paths, method="euler", dyn=mm.DEMO_MERTON,
                    kmax=None, **kw):
        opt = payoff_option(mt, name)
        if kmax is None:
            kmax = k_t if method == "terminal" else k_dt
        cfg = mm.MertonConfig(n_paths=n_paths, n_steps=MAIN_STEPS, kmax=kmax,
                              method=method, **kw)
        defer(partials_check(note, "merton_partials", mm.merton_partials,
                             mm.merton_partials_plain, cfg, merton_keys[0],
                             mm.pack_merton(opt, dyn, MAIN_STEPS, dev), name,
                             opt, f"{method} kmax={kmax}"))

    def bates_case(name, n_paths, dyn=bm.DEMO_BATES, opt=None,
                   n_steps=MAIN_STEPS, label="", **kw):
        kmax = (k_dt if opt is None
                else mm.poisson_kmax(dyn.lam * opt.t / n_steps))
        opt = opt or payoff_option(mt, name)
        cfg = bm.BatesConfig(n_paths=n_paths, n_steps=n_steps, kmax=kmax,
                             **kw)
        defer(partials_check(note, "bates_partials", bm.bates_partials,
                             bm.bates_partials_plain, cfg, bates_keys[0],
                             bm.pack_bates(opt, dyn, n_steps, dev), name, opt,
                             cfg.scheme + label))

    for name, po in sorted(PAYOFFS.items()):
        merton_case(name, FAMILY_PATHS)
        if po.terminal_only:  # the main shape of the terminal draw
            merton_case(name, FAMILY_MAIN, "terminal")
        if name not in SIGMA_PAYOFFS:
            bates_case(name, FAMILY_PATHS)
    for kw in (dict(rng_source="threefry"), dict(antithetic=True),
               dict(rng_source="threefry", antithetic=True)):
        for method in ("euler", "terminal"):
            merton_case("vanilla_call", FAMILY_PATHS, method, **kw)
    for kw in (dict(scheme="qe"), dict(rng_source="threefry"),
               dict(antithetic=True),
               dict(scheme="qe", rng_source="threefry", antithetic=True)):
        bates_case("vanilla_call", FAMILY_PATHS, **kw)
    merton_case("vanilla_call", FAMILY_MAIN)  # the main shape: a partial block
    # #14's edges: the table at kmax 1 and 53 (lam*dt = 17; the terminal
    # draw's at lam*T = 17), each jump-size skip's premise, a ragged last
    # block, antithetic and threefry-20
    for method, deep in (("euler", mm.MertonDynamics(lam=17.0 * MAIN_STEPS)),
                         ("terminal", mm.MertonDynamics(lam=17.0))):
        merton_case("vanilla_call", EDGE_PATHS, method, kmax=1,
                    antithetic=True)
        merton_case("vanilla_call", EDGE_PATHS, method, dyn=deep,
                    kmax=53, rng_source="threefry",
                    antithetic=method == "euler")
    for scheme in ("euler", "qe"):
        bates_case("vanilla_call", FAMILY_MAIN, scheme=scheme)
    # #16 QE's other branches (QE_EDGES), Heston's variance under the demo
    # jumps
    for edge, (heston, option, n_steps) in qe_edges(mt, hm).items():
        dyn = dataclasses.replace(bm.DEMO_BATES, **dataclasses.asdict(heston))
        for name, kw in qe_edge_runs(edge):
            bates_case(name, FAMILY_PATHS, dyn, option, n_steps, f" {edge}",
                       scheme="qe", **kw)

    fams = {"merton": (MertonNMC(extras=(k_dt,)), mm.pack_merton,
                       mm.DEMO_MERTON, merton_keys, "merton_trajectories"),
            "bates": (BatesNMC(extras=(k_dt,)), bm.pack_bates,
                      bm.DEMO_BATES, bates_keys, "family_trajectories")}
    for name, po in sorted(PAYOFFS.items()):
        if po.n_state <= 1:
            for fam, pack, dyn, (key, _), row in fams.values():
                defer(traj_check(mt, dev, note, row, fam, pack, dyn, key,
                                 name, FAMILY_PATHS))
    for fam, pack, dyn, (key, _), row in fams.values():
        traj_ragged(mt, dev, note, row, fam, pack, dyn, key)
    rows_ms = {family: family_nmc_checks(mt, dev, note, family, fam, pack,
                                         dyn, keys, row)
               for family, (fam, pack, dyn, keys, row) in fams.items()}
    return err, rows_ms


@contextlib.contextmanager
def scheme_split(_cuda, family):
    """Under Heston and Bates, each launch of ``<family>_partials`` within
    the block counted by its config's scheme: {"euler": n, "qe": m} (the
    kernels line's row holds both kernels).  Other families: {}."""
    from mc_tpu_torch.models import bates, heston

    model = {"heston": heston, "bates": bates}.get(family)
    split = {}
    if model is None:
        yield split
        return
    row = f"{family}_partials"
    fn = getattr(model, row)

    def counted(payoff, cfg, *args, **kw):
        before = _cuda.launch_counts.get(row, 0)
        try:
            return fn(payoff, cfg, *args, **kw)
        finally:
            split[cfg.scheme] = (split.get(cfg.scheme, 0)
                                 + _cuda.launch_counts.get(row, 0) - before)

    setattr(model, row, counted)
    try:
        yield split
    finally:
        setattr(model, row, fn)


def family_main_path(mt, dev, _cuda, family, e2e_nmc):
    """Phase 3 of a model family ("heston", "merton", "bates", "cev",
    "localvol", "sabr", "term", "divs", "vasicek" or "basket") at full
    width: the call at 1M (x 100) against its oracle by each scheme, method,
    gate surface or dynamics (Vasicek's bond too), with and without the
    antithetic twin (and, for dividends, two-payment put-call parity against
    the scheme's forward), every payoff at 100,000 x 100 with ordering and
    parity gates, the basket's (B, state) trajectories at 100,000 x 100, the
    NMC at NMC_MAIN by both strategies (grid == fused bitwise, the outer
    price == the family's price on the outer key up to f64 sums, the last
    step, the tower property: every column of the surface, the call's EE
    profile, flat at the time-0 price; Vasicek's bond EE flat at P(0,T),
    the basket's Margrabe exchange EE flat at its closed form), its XVA
    figures and the family's two CLI commands (dividends have no NMC: its
    one command).  The launch counts are set to 0 before it and read after
    it: {kernel: launches}; the NMC calls' host-clock seconds go to
    ``e2e_nmc[(family, strategy)]`` (phase 5's e2e times)."""
    from mc_tpu_torch import nmc_engine as ne
    from mc_tpu_torch import rng
    from mc_tpu_torch.models import basket as bm
    from mc_tpu_torch.models import dividends as dm
    from mc_tpu_torch.models import localvol as lm
    from mc_tpu_torch.models import term as tm
    from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
    from mc_tpu_torch.oracle import bs_call
    from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff
    from mc_tpu_torch.ops.reduce import finish_sum

    _cuda.reset_launch_counts()
    option = o = mt.DEMO_OPTION
    sv_names = [n for n in sorted(PAYOFFS) if n not in SIGMA_PAYOFFS]
    # gates: (label, dynamics, price_fn keywords, oracle, n stderr, the
    # absolute allowance for the scheme's bias)
    if family in ("heston", "bates"):
        if family == "heston":
            dyn, price_fn, nmc_fn = (mt.DEMO_HESTON, mt.price_heston,
                                     mt.price_nmc_heston)
            ref = mt.heston_call_cf(o.s0, o.k, o.t, o.r, *dyn.astuple(),
                                    q=o.q)
            kernels = HESTON_KERNELS
        else:
            dyn, price_fn, nmc_fn = (mt.DEMO_BATES, mt.price_bates,
                                     mt.price_nmc_bates)
            ref = mt.bates_call_cf(o.s0, o.k, o.t, o.r, *dyn.astuple(),
                                   q=o.q)
            kernels = BATES_KERNELS
        # Euler's O(dt) bias (4 se + 0.5%), QE's smaller one
        gates = [(s, dyn, dict(scheme=s), ref, n_se, bias * ref)
                 for s, n_se, bias in (("euler", 4.0, 0.005),
                                       ("qe", 3.0, 0.003))]
        names = sv_names
    elif family == "merton":
        dyn, price_fn, nmc_fn = mt.DEMO_MERTON, mt.price_merton, mt.price_nmc_merton
        ref = mt.merton_call_closed_form(o.s0, o.k, o.t, o.r, o.sigma,
                                         *dyn.astuple(), q=o.q)
        # exact in law: no discretization bias, 3 stderr
        gates = [(m, dyn, dict(method=m), ref, 3.0, 0.0)
                 for m in ("euler", "terminal")]
        names, kernels = sorted(PAYOFFS), MERTON_KERNELS
    elif family == "cev":
        dyn, price_fn, nmc_fn = mt.DEMO_CEV, mt.price_cev, mt.price_nmc_cev
        ref = mt.cev_call_closed_form(o.s0, o.k, o.t, o.r, *dyn.astuple(),
                                      q=o.q)
        # level-space Euler's O(dt) bias: tests/test_cev.py's 4 se + 0.5%
        gates = [("euler", dyn, {}, ref, 4.0, 0.005 * ref)]
        names, kernels = sv_names, CEV_KERNELS
    elif family == "sabr":
        dyn, price_fn, nmc_fn = mt.DEMO_SABR, mt.price_sabr, mt.price_nmc_sabr
        hagan = mt.sabr_call_hagan(o.s0, o.k, o.t, o.r, *dyn.astuple(),
                                   q=o.q)
        # tests/test_sabr.py: nu -> 0 at beta = 1 is exact lognormal
        # stepping (4 se); Hagan's expansion carries its ~1% (4 se + 1%)
        gates = [("nu->0 vs BS", mt.SABRDynamics(0.2, 1.0, 1e-6, 0.0), {},
                  bs_call(o.s0, o.k, o.t, o.r, 0.2, o.q), 4.0, 0.0),
                 ("demo vs Hagan", dyn, {}, hagan, 4.0, 0.01 * hagan)]
        ref = None  # the EE profile is held to the demo's 1M-path price
        names, kernels = sv_names, SABR_KERNELS
    elif family == "term":  # the demo curves (nmc --model term's)
        dyn, price_fn, nmc_fn = (tm.demo_term(MAIN_STEPS), mt.price_term,
                                 mt.price_nmc_term)
        rs, sg = (np.asarray(a, np.float64) for a in (dyn.rates, dyn.sigmas))
        # exact in law at the averaged parameters: 4 se
        ref = bs_call(o.s0, o.k, o.t, float(rs.mean()),
                      float(np.sqrt((sg * sg).mean())), o.q)
        gates = [("curves vs averaged BS", dyn, {}, ref, 4.0, 0.0)]
        names, kernels = sorted(PAYOFFS), TERM_KERNELS
    elif family == "vasicek":
        dyn, price_fn, nmc_fn = (mt.DEMO_VASICEK, mt.price_vasicek,
                                 mt.price_nmc_vasicek)
        a, b, sr, rho = dyn.astuple()
        ref = mt.bsv_call(o.s0, o.k, o.t, o.r, o.sigma, a, b, sr, rho, o.q)
        # exact in law at any step count: tests/test_vasicek.py's 3.5 se
        gates = [("call vs Merton 1973", dyn, {}, ref, 3.5, 0.0),
                 ("zcb vs the affine bond", dyn, dict(payoff="zcb"),
                  mt.vasicek_zcb(o.r, a, b, sr, o.t), 3.5, 0.0)]
        names, kernels = sorted(PAYOFFS), VASICEK_KERNELS
    elif family == "basket":
        dyn, price_fn, nmc_fn = (mt.DEMO_BASKET, mt.price_basket,
                                 mt.price_nmc_basket)
        one = mt.BasketDynamics(*(np.array(v, np.float32) for v in (
            [o.s0], [0.2], [1.0], [[1.0]])))
        perfect = mt.BasketDynamics(
            np.full(3, o.s0, np.float32), np.full(3, 0.2, np.float32),
            np.full(3, 1.0 / 3, np.float32), np.ones((3, 3), np.float32))
        bs = bs_call(o.s0, o.k, o.t, o.r, 0.2, o.q)
        # tests/test_basket.py: log-Euler is exact in law, 4 se
        gates = [("d=1 vs BS", one, {}, bs, 4.0, 0.0),
                 ("perfect correlation d=3 vs BS", perfect, {}, bs, 4.0,
                  0.0)]
        ref = None  # the demo basket: its 1M-path price
        names, kernels = sorted(PAYOFFS), BASKET_KERNELS
    elif family == "divs":
        dyn, price_fn, nmc_fn = (mt.div_schedule(
            MAIN_STEPS, [MAIN_STEPS // 2 - 1], [5.0]), mt.price_divs, None)
        # one payment at tau = 0.5: the quadrature is exact for the scheme
        ref = mt.bs_call_cash_div(o.s0, o.k, o.t, o.r, o.sigma, 5.0, 0.5,
                                  q=o.q)
        gates = [("one payment vs quadrature", dyn, {}, ref, 4.0, 0.0)]
        names, kernels = sorted(PAYOFFS), DIVS_KERNELS
    else:
        dyn, price_fn, nmc_fn = (lm.LocalVolSurface.demo(MAIN_STEPS),
                                 mt.price_localvol, mt.price_nmc_localvol)
        beta = 0.7
        # tests/test_localvol.py: log-Euler is exact on a flat surface (3.5
        # se); the CEV-shaped one adds its Euler and knot bias (+ 0.02)
        gates = [("flat 0.2", lm.LocalVolSurface.flat(0.2, MAIN_STEPS), {},
                  bs_call(o.s0, o.k, o.t, o.r, 0.2, o.q), 3.5, 0.0),
                 ("CEV-shaped beta 0.7 K=25", cev_gate_surface(lm, MAIN_STEPS),
                  {}, mt.cev_call_closed_form(o.s0, o.k, o.t, o.r,
                                              0.2 * o.s0 ** (1.0 - beta),
                                              beta, q=o.q), 3.5, 0.02)]
        ref = None  # the demo surface has no oracle: its 1M-path price
        names, kernels = sorted(PAYOFFS), LOCALVOL_KERNELS
    n_main = FAMILY_MAIN
    sim = mt.SimParams(n_paths=n_main, n_steps=MAIN_STEPS)
    for which, gdyn, kw, gref, n_se, allow in gates:
        se = {}
        for anti in (False, True):
            r = price_fn(option, gdyn, sim, **kw, antithetic=anti,
                         device=DEVICE)
            se[anti] = float(r.stderr)
            tol = n_se * float(r.stderr) + allow
            d = abs(float(r.price) - gref)
            print(f"phase 3: price_{family} {which} antithetic={anti} "
                  f"{n_main}x{MAIN_STEPS}: {float(r.price):.5f} +/- "
                  f"{float(r.stderr):.5f} vs oracle {gref:.5f}: |d| {d:.5f} "
                  f"(limit {n_se:g} se + {allow:.5f} = {tol:.5f})")
            if not (math.isfinite(d) and d <= tol):
                fail(f"price_{family} {which} misses its oracle")
        if not se[True] < se[False]:
            fail(f"price_{family} {which}: antithetic does not cut the "
                 "stderr")
    if ref is None:
        r = price_fn(option, dyn, sim, antithetic=True, device=DEVICE)
        ref = float(r.price)
        print(f"phase 3: price_{family} demo antithetic "
              f"{n_main}x{MAIN_STEPS}: {ref:.5f} +/- {float(r.stderr):.5f} "
              "(the time-0 price the NMC's EE profile is held to)")
    r32 = float(np.float32(option.r))
    if family == "term":  # every price is discounted at the curve average
        r32 = float(tm.pack_term(option, dyn, MAIN_STEPS, "cpu")[
            tm.HEAD_FIELDS.index("r")])
    if family == "divs":  # two payments: C - P = e^{-rT} (E[S_T] - K)
        two = two_payments(dm, MAIN_STEPS)
        c, p = (price_fn(option, two, sim, name, device=DEVICE)
                for name in ("vanilla_call", "vanilla_put"))
        fwd = mt.cash_div_forward(o.s0, o.t, o.r, o.sigma, two, MAIN_STEPS,
                                  q=o.q)
        d_par = abs(float(c.price) - float(p.price)
                    - math.exp(-o.r * o.t) * (fwd - o.k))
        joint = math.hypot(float(c.stderr), float(p.stderr))
        print(f"phase 3: price_divs two payments {n_main}x{MAIN_STEPS}: call "
              f"{float(c.price):.5f} - put {float(p.price):.5f} vs "
              f"e^-rT (forward {fwd:.5f} - K): |d| {d_par:.5f} (limit 4 se = "
              f"{4.0 * joint:.5f})")
        if not d_par <= 4.0 * joint:
            fail("price_divs breaks put-call parity on its forward")

    psim = mt.SimParams(n_paths=PAYOFF_MAIN, n_steps=MAIN_STEPS)
    pay = {name: price_fn(payoff_option(mt, name), dyn, psim, name,
                          device=DEVICE) for name in names}
    print(f"phase 3: price_{family} euler {PAYOFF_MAIN}x{MAIN_STEPS}: "
          + ", ".join(f"{n} {float(r.price):.6f} +/- {float(r.stderr):.6f}"
                      for n, r in pay.items()))
    van = float(pay["vanilla_call"].price)
    van_down = float(price_fn(payoff_option(mt, "down_out_call"), dyn, psim,
                              device=DEVICE).price)
    d_inout = abs(float(pay["down_in_call"].price)
                  + float(pay["down_out_call"].price) - van_down)
    disc = math.exp(-r32 * float(np.float32(option.t)))
    zcb_ok = float(pay["zcb"].price) == disc
    if family == "vasicek":  # discounted pathwise: the bond's own price
        disc = float(pay["zcb"].price)
        zcb_ok = abs(disc - gates[1][3]) <= 4.0 * float(pay["zcb"].stderr)
    d_dig = abs(float(pay["digital_call"].price)
                + float(pay["digital_put"].price) - disc)
    # on the same paths the bridge weight is at most the discrete flag
    bridged = "up_out_call_bb" in names
    bridge_ok = all(float(pay[f"{side}_call_bb"].price)
                    <= float(pay[f"{side}_call"].price)
                    for side in ("up_out", "down_out") if bridged)
    print(f"phase 3: {family} ordering and parity: asian "
          f"{float(pay['asian_call'].price):.6f}, up-and-out "
          f"{float(pay['up_out_call'].price):.6f} < vanilla {van:.6f}; "
          f"down-in + down-out - vanilla {d_inout:.3e}; digital call + put "
          f"- e^-rT {d_dig:.3e}; zcb {float(pay['zcb'].price):.15f}"
          + ("; the bridge barriers at most the discrete ones: "
             f"{'ok' if bridge_ok else 'NO'}" if bridged else ""))
    if not (all(math.isfinite(float(r.price)) and math.isfinite(
            float(r.stderr)) for r in pay.values())
            and 0.0 < float(pay["asian_call"].price) < van
            and 0.0 < float(pay["up_out_call"].price) < van
            and d_inout <= 1e-12 * van_down and d_dig <= 2e-6 * disc
            and zcb_ok and bridge_ok):
        fail(f"a {family} payoff is not finite or breaks its ordering or "
             "parity gate")
    if family == "basket":  # #26: the (B, state) grids the basket LSMC reads
        bullet = get_payoff("bullet_call")
        bkey = rng.derive_key(5, 0, bm.BASKET_TAG)
        cfg = bm.BasketConfig(n_paths=GRID_PATHS, n_steps=MAIN_STEPS,
                              d=dyn.d)
        b_grid, st_grid, parts = bm.basket_trajectories(
            bullet, cfg, bkey, bm.pack_basket(option, dyn, MAIN_STEPS, dev))
        traj_price = mt.engines.finish_price(finish_sum(parts), GRID_PATHS,
                                             option)
        own = price_fn(option, dyn, mt.SimParams(n_paths=GRID_PATHS,
                                                 n_steps=MAIN_STEPS),
                       "bullet_call", key=bkey, device=DEVICE)
        d_traj = abs(float(traj_price.price) - float(own.price))
        counts = st_grid[-1]
        print(f"phase 3: basket_trajectories bullet {GRID_PATHS}x{MAIN_STEPS}"
              f": price {float(traj_price.price):.6f} vs price_basket on the "
              f"same key {float(own.price):.6f} (|d| {d_traj:.3e}); B grid "
              f"min {float(b_grid.min()):.4f} max {float(b_grid.max()):.4f};"
              f" barrier counts at T in [{float(counts.min()):g}, "
              f"{float(counts.max()):g}]")
        if not (d_traj <= SUMS_RTOL * abs(float(own.price))
                and bool(torch.isfinite(b_grid).all())
                and float(b_grid.min()) > 0.0
                and bool((counts == counts.round()).all())
                and 0.0 <= float(counts.min()) <= float(counts.max())
                <= MAIN_STEPS):
            fail("the basket trajectories disagree with price_basket or "
                 "their grids are off")
    if nmc_fn is None:  # dividends: no NMC; the divs command
        c = run_cli(["divs", "--device", DEVICE])
        print(f"phase 3: python -m mc_tpu_torch divs --device {DEVICE}: {c}")
        if not (c["payoff"] == "vanilla_call" and c["dividends"] == [[24, 5.0]]
                and abs(c["z_score"]) <= 4.0):
            fail("the divs command is off")
        return {k: _cuda.launch_counts[k] for k in kernels}

    n_out, n_steps, n_inner = NMC_MAIN
    nsim = mt.SimParams(n_paths=n_out, n_steps=n_steps, n_paths_inner=n_inner)
    t0 = time.perf_counter()
    fused = nmc_fn(option, dyn, nsim, strategy="fused", device=DEVICE)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    grid = nmc_fn(option, dyn, nsim, strategy="grid", device=DEVICE)
    torch.cuda.synchronize()
    e2e_nmc[(family, "fused")] = fused_s
    e2e_nmc[(family, "grid")] = time.perf_counter() - t0 - fused_s
    surf = fused.surface_matrix()
    if (tuple(surf.shape) != (n_out, n_steps)
            or not bool(torch.isfinite(surf).all())):
        fail(f"{family} NMC surface has shape {tuple(surf.shape)} or "
             "non-finite values")
    same = bool(torch.equal(grid.surface, fused.surface))
    d_outer = abs(float(grid.outer.price) - float(fused.outer.price))
    standalone = price_fn(option, dyn, mt.SimParams(n_paths=n_out,
                                                    n_steps=n_steps),
                          device=DEVICE)
    d_sa = max(abs(float(r.outer.price) - float(standalone.price))
               for r in (fused, grid)) / float(standalone.price)
    p32 = mt.engines.pk.unpack_params(mt.engines.pk.pack_params(
        option, n_steps, dev))
    s_last = grid.spot_surface[-1]
    if family in ("vasicek", "basket"):
        # the last row prices from every grid (y's discount, the d assets):
        # the plain leg on the outer grids, which equal the kernels' bit
        # for bit (phase 2)
        fam, dyn32 = ne.NMC_FAMILY_BUILDERS[family](option, dyn, nsim)
        ncfg = ne.FamilyConfig(n_paths=n_out, n_steps=n_steps,
                               n_inner=n_inner)
        nkeys = [rng.derive_key(nsim.seed, st, fam.tag) for st in (0, 1)]
        nprm = fam.pack(option, dyn32, n_steps, dev)
        *g_p, st_p, _ = fam.trajectories_plain(get_payoff("vanilla_call"),
                                               ncfg, nkeys[0], nprm)
        want = ne.family_rows_plain(fam, get_payoff("vanilla_call"), ncfg,
                                    nkeys[1], nprm, g_p, st_p,
                                    [n_steps - 1])[0]
    elif family in ("localvol", "term"):  # pays on s0*exp(log(S_T/s0))
        s_last = p32.s0 * torch.exp(torch.log(s_last / p32.s0))
    elif family == "sabr":  # the inner leg pays on exp(log(F_T))
        s_last = torch.exp(torch.log(s_last))
    r_t = torch.tensor(r32, dtype=torch.float32, device=dev)
    if family not in ("vasicek", "basket"):
        want = torch.exp(-r_t * p32.t) * torch.clamp(s_last - p32.k, min=0.0)
    last_ok = bool(torch.allclose(grid.surface[-1], want, rtol=1e-5, atol=0.0))
    cols = surf.double().mean(dim=0)
    tol_ref = 0.02 * ref + 4 * 0.15  # tests/test_nmc.py:147
    # the call's EE profile (the surface is non-negative): flat at ref
    d_ee = float((grid.exposure_profile()[0].double() - ref).abs().max())
    d_cols = float((cols - ref).abs().max())
    d_mean = abs(float(fused.surface_mean) - ref)
    d_out_ref = abs(float(fused.outer.price) - ref)
    print(f"phase 3: price_nmc_{family} {n_out}x{n_steps}x{n_inner} "
          f"(fused {fused_s:.2f} s): grid == fused "
          f"{'bitwise' if same else 'NOT bitwise'} "
          f"({share(grid.surface == fused.surface):.6f}), outer "
          f"{float(fused.outer.price):.6f} +/- {float(fused.outer.stderr):.6f}"
          f" (grid's |d| {d_outer:.3e}; price_{family} on the outer "
          f"key {float(standalone.price):.6f}, rel {d_sa:.2e}); last step == "
          f"e^-rT payoff(S_T): {'ok' if last_ok else 'MISMATCH'} "
          f"({share(grid.surface[-1] == want):.6f} bitwise); tower vs oracle "
          f"{ref:.5f}: surface mean |d| {d_mean:.5f}, max column |d| "
          f"{d_cols:.5f}, max EE |d| {d_ee:.5f} (limit {tol_ref:.5f}), "
          f"outer |d| {d_out_ref:.5f}")
    if not (same and last_ok and d_sa <= SUMS_RTOL
            and d_outer <= SUMS_RTOL * float(fused.outer.price)
            and d_mean < tol_ref and d_cols < tol_ref and d_ee < tol_ref
            and d_out_ref <= 4.0 * float(fused.outer.stderr) + 0.02 * ref):
        fail(f"the {family} NMC breaks grid == fused, its last step, the "
             "tower property or its outer price")
    if family in ("vasicek", "basket"):
        # a martingale's EE is flat at its closed form: Vasicek's bond at
        # P(0,T); the exchange option on weights (1, -1), K = 0 at
        # Margrabe's price (tests/test_nmc_vasicek.py's 5e-4, and
        # test_nmc_basket.py's 4%)
        if family == "vasicek":
            label, flat, flat_ref = "zcb", nmc_fn(
                option, dyn, nsim, "zcb", strategy="fused",
                device=DEVICE), gates[1][3]
            flat_tol = 5e-4
        else:
            exch = mt.BasketDynamics(*(np.array(v, np.float32) for v in (
                [100.0, 95.0], [0.25, 0.2], [1.0, -1.0],
                [[1.0, 0.4], [0.4, 1.0]])))
            label, flat, flat_ref = "Margrabe exchange", nmc_fn(
                mt.OptionParams(k=0.0), exch, nsim, strategy="fused",
                device=DEVICE), mt.margrabe(100.0, 95.0, 1.0, 0.25, 0.2,
                                            0.4)
            flat_tol = 0.04 * flat_ref
        d_flat = float((flat.exposure_profile()[0].double()
                        - flat_ref).abs().max())
        d_flat_mean = abs(float(flat.surface_mean) - flat_ref)
        print(f"phase 3: price_nmc_{family} {label} fused "
              f"{n_out}x{n_steps}x{n_inner}: EE flat at the closed form "
              f"{flat_ref:.6f}: max |d| {d_flat:.6f}, surface mean |d| "
              f"{d_flat_mean:.6f} (limit {flat_tol:.6f})")
        if not (d_flat < flat_tol and d_flat_mean < flat_tol):
            fail(f"the {family} NMC's {label} exposure is not flat at its "
                 "closed form")

    cva = float(grid.cva(0.02))
    fca, fba = grid.fva(0.01)
    xva = {
        "cva(0.02)": cva, "dva(0.01)": float(grid.dva(0.01)),
        "bilateral_cva(0.02, 0.01)": float(grid.bilateral_cva(0.02, 0.01)),
        "fca(0.01)": float(fca), "fba(0.01)": float(fba),
        "mva(0.01, 99%, mpor 2)": float(grid.mva(0.01, 0.99, 2)),
        "collateralized cva (H=1, mta=0.1, mpor 2)": float(
            grid.collateralized(1.0, mta=0.1, mpor_steps=2).cva(0.02)),
        "cva_wwr(0.02, beta=0.05)": float(grid.cva_wwr(0.02, 0.05)),
        "cva_wwr_spot(0.02, beta=0)": float(grid.cva_wwr_spot(0.02, 0.0)),
    }
    print(f"phase 3: xva of the {family} grid surface: " + ", ".join(
        f"{k} {v:.7f}" for k, v in xva.items()))
    if not (all(math.isfinite(v) for v in xva.values()) and cva > 0.0
            and abs(xva["cva_wwr_spot(0.02, beta=0)"] - cva)
            <= XVA_RTOL * cva):
        fail(f"the {family} exposure metrics are not finite, or "
             "cva_wwr_spot(beta=0) is not cva")

    argv = [family, "--device", DEVICE]
    # nmc --model <family> at CLI_NMC_PATHS outer paths: its outer price is
    # price_<family>'s on the command's dynamics, on the outer key
    csim = mt.SimParams(n_paths=CLI_NMC_PATHS, n_steps=n_steps)
    nmc_outer = float(price_fn(option, dyn, csim, device=DEVICE).price)
    if family == "merton":  # exact in law: 3 stderr
        argv += ["--method", "terminal", "-N", str(FAMILY_MAIN)]
        oracle_key, n_se, allow = "merton_series_oracle", 3.0, 0.0
    elif family == "cev":  # at the CLI's 100,000 x 100, test_cev.py's gate
        oracle_key, n_se, allow = "ncx2_oracle", 4.0, 0.005 * ref
    elif family == "sabr":  # Hagan's ~1% at the CLI's 100,000 x 100
        oracle_key, n_se, allow = "hagan_oracle", 4.0, 0.01 * hagan
        # nmc --model sabr takes rho from --rho-sv (-0.7): its outer price
        # is price_sabr's on those dynamics, on the outer key
        nmc_outer = float(price_fn(option, mt.SABRDynamics(rho=-0.7), csim,
                                   device=DEVICE).price)
    elif family == "term":  # nmc --model term's curves are DEMO_TERM's
        oracle_key, n_se, allow = "oracle", 4.0, 0.0
    elif family == "vasicek":  # Merton's (1973) call at 100,000 x 100
        oracle_key, n_se, allow = "oracle", 4.0, 0.0
    elif family == "basket":  # no oracle: price_basket's own call
        argv += ["--n-assets", "4", "--corr", "0.5"]
        oracle_key, n_se, allow = None, 0.0, 0.0
    elif family == "localvol":  # the CEV-shaped surface, 9 knots
        argv += ["--beta", "0.7"]
        oracle_key, n_se, allow = "cev_oracle", 3.5, 0.02
        # nmc --model localvol's surface is sigma + curv*x^2: its outer
        # price is price_localvol's on that surface, on the outer key
        nmc_outer = float(price_fn(option, lm.LocalVolSurface.from_function(
            lambda x, t: 0.2 + 0.1 * x * x, n_steps), csim,
            device=DEVICE).price)
    else:  # QE at the CLI's 100,000 x 100
        argv += ["--scheme", "qe"]
        oracle_key, n_se, allow = "cf_oracle", 4.0, 0.003 * ref
    c = run_cli(argv)
    n = run_cli(["nmc", "--model", family, "--strategy", "grid", "--exposure",
                 "--cva-hazard", "0.02", "--payoff", "vanilla_call",
                 "--n-paths", str(CLI_NMC_PATHS), "--n-steps", str(n_steps),
                 "--n-inner", str(n_inner), "--device", DEVICE])
    d_cli = abs(c["price"] - (c[oracle_key] if oracle_key else float(
        price_fn(option, dyn, mt.SimParams(n_paths=100_000, n_steps=100),
                 device=DEVICE).price)))  # the command's default size
    print(f"phase 3: python -m mc_tpu_torch {' '.join(argv)}: {c}; nmc "
          f"--model {family} --strategy grid --exposure: outer "
          f"{n['outer_price']:.6f}, cva {n['cva']:.7f}, EE at t_n "
          f"{n['expected_exposure'][-1]:.6f}")
    if not (c["payoff"] == "vanilla_call"
            and d_cli <= n_se * c["stderr"] + allow
            and len(n["expected_exposure"]) == n_steps and n["cva"] > 0.0
            and abs(n["outer_price"] - nmc_outer) <= SUMS_RTOL * nmc_outer):
        fail(f"the {family} or nmc --model {family} command is off")
    return {k: _cuda.launch_counts[k] for k in kernels}


def jump_times(mt, dev, merton_keys, bates_keys, regs, tag, time_pair,
               gbm_ms, nmc_ms, e2e_nmc):
    """Phase 5 of the jump slice: each kernel (CUDA events) beside its plain
    version and beside the Heston kernel of its shape (``gbm_ms``: Heston's
    partials at 1M x 100 and its NMC kernels at NMC_MAIN), the registers,
    and the e2e calls.  Returns {row: (ms, plain ms)} (the family kernels'
    plain ms is measured in phase 2; the family kernels' and the NMC
    calls' times are their phase-2 and phase-3 calls', ``nmc_ms`` and
    ``e2e_nmc``)."""
    from mc_tpu_torch.models import bates as bm
    from mc_tpu_torch.models import merton as mm
    from mc_tpu_torch.nmc_bates import BatesNMC
    from mc_tpu_torch.nmc_merton import MertonNMC
    from mc_tpu_torch.ops.payoffs import get_payoff

    call = get_payoff("vanilla_call")
    k_dt, k_t = jump_kmax()
    steps = FAMILY_MAIN * MAIN_STEPS
    m_prm = mm.pack_merton(mt.DEMO_OPTION, mm.DEMO_MERTON, MAIN_STEPS, dev)
    b_prm = bm.pack_bates(mt.DEMO_OPTION, bm.DEMO_BATES, MAIN_STEPS, dev)
    m_cfg = {m: mm.MertonConfig(n_paths=FAMILY_MAIN, n_steps=MAIN_STEPS,
                                kmax=k, method=m)
             for m, k in (("euler", k_dt), ("terminal", k_t))}
    b_cfg = {sc: bm.BatesConfig(n_paths=FAMILY_MAIN, n_steps=MAIN_STEPS,
                                kmax=k_dt, scheme=sc)
             for sc in ("euler", "qe")}
    b_cfg["qe_anti"] = bm.BatesConfig(n_paths=FAMILY_MAIN, n_steps=MAIN_STEPS,
                                      kmax=k_dt, scheme="qe", antithetic=True)
    # Each kernel at its main shape, beside Heston's partials of its scheme
    # (the terminal draw: Euler's); the plain versions of the Euler rows
    # (the terminal draw and QE: the kernel alone).  Registers: ROUNDS=13,
    # each method's or scheme's kernel (Merton's not antithetic).
    euler = ("heston_partials call euler", gbm_ms["heston_partials"])
    qe = ("heston_partials call qe", gbm_ms["qe"])
    out = partials_times((
        ("merton_partials", "merton_partials call euler",
         lambda: mm.merton_partials(call, m_cfg["euler"], merton_keys[0],
                                    m_prm),
         lambda: mm.merton_partials_plain(call, m_cfg["euler"],
                                          merton_keys[0], m_prm),
         ("merton_partials_kernel<MertonEuler>", "VanillaCall", (13, 0)),
         euler),
        (None, "merton_partials call terminal",
         lambda: mm.merton_partials(call, m_cfg["terminal"], merton_keys[0],
                                    m_prm), None,
         ("merton_partials_kernel<MertonTerminal>", "VanillaCall", (13, 0)),
         euler),
        ("bates_partials", "bates_partials call euler",
         lambda: bm.bates_partials(call, b_cfg["euler"], bates_keys[0],
                                   b_prm),
         lambda: bm.bates_partials_plain(call, b_cfg["euler"], bates_keys[0],
                                         b_prm),
         ("bates_partials_kernel<BatesEuler>", "VanillaCall", 13), euler),
        ("bates_qe", "bates_partials call qe",
         lambda: bm.bates_partials(call, b_cfg["qe"], bates_keys[0], b_prm),
         None, ("bates_qe_kernel", "VanillaCall", (13, 0)), qe),
        ("bates_qe_anti", "bates_partials call qe antithetic",
         lambda: bm.bates_partials(call, b_cfg["qe_anti"], bates_keys[0],
                                   b_prm),
         None, ("bates_qe_kernel", "VanillaCall", (13, 1)),
         ("heston_partials call qe antithetic", gbm_ms["qe_anti"]))),
        FAMILY_MAIN, time_pair, regs, tag)

    heston_nmc = ("Heston", {name: gbm_ms[name]
                             for name in ("family_fused", "family_inner")})
    out.update(family_nmc_times(
        (("merton", MertonNMC(extras=(k_dt,)), m_prm, merton_keys,
          "merton_trajectories", "MertonFamily", nmc_ms["merton"],
          heston_nmc),
         ("bates", BatesNMC(extras=(k_dt,)), b_prm, bates_keys,
          "family_trajectories", "BatesFamily", nmc_ms["bates"],
          heston_nmc)), call, time_pair, regs, tag))

    osim = mt.SimParams(n_paths=FAMILY_MAIN, n_steps=MAIN_STEPS)
    e2e_report((
            (f"price_merton() euler {FAMILY_MAIN}x{MAIN_STEPS}",
             "path-steps/s", steps,
             lambda: mt.price_merton(sim=osim, device=DEVICE)),
            (f"price_merton() terminal {FAMILY_MAIN}", "paths/s", FAMILY_MAIN,
             lambda: mt.price_merton(sim=osim, method="terminal",
                                     device=DEVICE)),
            (f"price_bates() euler {FAMILY_MAIN}x{MAIN_STEPS}", "path-steps/s",
             steps, lambda: mt.price_bates(sim=osim, device=DEVICE)),
            (f"price_bates() qe {FAMILY_MAIN}x{MAIN_STEPS}", "path-steps/s",
             steps, lambda: mt.price_bates(sim=osim, scheme="qe",
                                           device=DEVICE)),
            *nmc_e2e_rows("merton", e2e_nmc),
            *nmc_e2e_rows("bates", e2e_nmc)), tag)
    return out


# --- the single-asset families (CEV, local vol, SABR, term, dividends):
# kernels #17-#22, the generic trajectories under CEV, SABR and term, and
# their #29/#30, all driven from one table (single_families) --------------

# A CEV substep on top of its half pair: the alive test and the floor (2),
# S^beta = expf(beta*logf(S)) (1, a logf and an expf), diff (1), S +
# growth_dt*S (2), (diff*sqrt_dt)*z (2), the floor at 0 and the select (2).
CEV_STEP_OPS = (0, 10, 2)
# A SABR step on top of its whole threefry pair (sabr.cuh): z_f (3), the
# local vol sig*expf((beta-1)*lf) (3 and an expf), lf (7), the vol factor
# (7 and an expf), F = expf(lf) (an expf): the family NMC's leg.
SABR_STEP_OPS = (0, 20, 3)
# #17's least work a step at the demo's beta = 1, where the local vol is sig:
# z_f (3), lf (7), the vol factor (7 and an expf); the call reads F =
# expf(lf) once a path (SPOT_OPS).
SABR_UNIT_STEP_OPS = (0, 17, 1)
# A cash-dividend step on top of its half pair (divs.cuh): the factor's
# exponent (2), S*expf (1 and an expf), the floor (1); a step that pays
# adds the drop (DIVS_PAY_OPS), a step with no payment costs its floor
# alone.
DIVS_STEP_OPS = (0, 4, 1)
DIVS_PAY_OPS = (0, 1, 0)
# A Vasicek step on top of its three normals (vasicek.cuh): eps (1), eta
# (3), u (5), dy (4), w (3), y (1), x (2), S = s0*expf(w) (1 and an expf).
VASICEK_STEP_OPS = (0, 20, 1)
# The Vasicek payoff's pathwise discount, payoff * expf(-y).
VASICEK_DISCOUNT_OPS = (0, 2, 1)


def vasicek_path(n_steps: int, rounds: int = 13):
    """A Vasicek path: one and a half threefry pairs a step, the step, the
    discounted payoff."""
    return _add(_scale(pair_ops(rounds), 3 * n_steps // 2),
                _scale(VASICEK_STEP_OPS, n_steps), TERMINAL_OPS,
                VASICEK_DISCOUNT_OPS)


def basket_step_ops(d: int, antithetic: bool = False):
    """The least work of a basket step on top of its ceil(d/2) pairs (no
    sign multiplies: no leg needs them): the mix's d(d+1)/2 multiplies and
    d(d-1)/2 adds, the increments (3d), the levels and the weighted sum
    (3d - 1), d expf; an antithetic twin on the same draw and mix (the
    negated normals' mix is the mix negated) its own increments (2d),
    levels and sum (3d - 1) and d expf."""
    twin = (0, 5 * d - 1, d) if antithetic else (0, 0, 0)
    return _add((0, d * (d + 1) // 2 + d * (d - 1) // 2 + 6 * d - 1, d), twin)


def basket_path(d: int, n_steps: int, antithetic: bool = False):
    """A basket path of n_steps steps and its payoff (the antithetic twin's
    and their mean)."""
    return _add(_scale(_add(_scale(pair_ops(13), (d + 1) // 2),
                            basket_step_ops(d, antithetic)), n_steps),
                TERMINAL_OPS, (0, 3, 0) if antithetic else (0, 0, 0))


def lv_step_ops(n_knots: int):
    """A local-vol step on top of its half pair: the lookup (per ramp a
    subtract, max, min, multiply and add; the floor), the drift (4), the
    diffusion (3), w (1) and S = s0*expf(w) (1 and an expf)."""
    return (0, 5 * (n_knots - 1) + 1 + 9, 1)


def half_pair_path(step, n_steps: int):
    """A path of n_steps steps that share one threefry pair per two, and
    its payoff."""
    return _add(_scale(pair_ops(13), n_steps // 2), _scale(step, n_steps),
                TERMINAL_OPS)


def divs_path(n_steps: int, n_payments: int):
    """A cash-dividend path: its steps, the drop at each payment, its
    payoff."""
    return _add(half_pair_path(DIVS_STEP_OPS, n_steps),
                _scale(DIVS_PAY_OPS, n_payments))


def cev_gate_surface(lm, n_steps: int, beta: float = 0.7,
                     sigma_atm: float = 0.2):
    """tests/test_localvol.py's CEV-shaped surface: sigma_atm (S/S0)^(beta-1)
    on K = 25 knots over x in [-1.5, 1.5]."""
    return lm.LocalVolSurface.from_function(
        lambda x, t: sigma_atm * math.exp((beta - 1.0) * x), n_steps,
        x_lo=-1.5, x_hi=1.5, n_knots=25)


def two_payments(dm, n_steps: int):
    """Two payments: 3.0 after step 24 and 4.0 after step 74 (of 100)."""
    return dm.div_schedule(n_steps, [n_steps // 4 - 1, 3 * n_steps // 4 - 1],
                           [3.0, 4.0])


class SingleNMC(NamedTuple):
    """A family's NMC as phases 2, 5 and 6 read it."""
    fam: object           # its NMCFamily
    dyn: object           # n_steps -> its default dynamics
    traj_tpu: str         # what its trajectories kernel replaces
    struct: str           # its family struct in csrc/<family>.cuh
    n_grids: int          # its market grids
    substep: tuple        # phase 6: an inner substep's operations
    ref: tuple            # phase 5: (label, family) of the NMC kernels beside
    traj_ref: str         # phase 5: the trajectories row of the same shape


class Single(NamedTuple):
    """A single-asset family as phases 2, 5 and 6 and the kernels line read
    it; its partials row is ``<family>_partials``."""
    family: str
    kernels: tuple        # its launch counters (the *_KERNELS tuple)
    model: object         # its models module: <family>_partials(_plain)
    config: object        # (n_paths, dyn, **kw) -> its partials config
    pack: object          # (option, dyn, n_steps, device) -> its params
    tpu: str              # the Pallas kernel its partials kernel replaces
    checks: tuple         # phase 2: ((label, dyn), ...), the first sweeps
    payoffs: tuple        # phase 2's payoff sweep
    variants: tuple       # phase 2: keywords run on the vanilla and bullet
    timed: tuple          # phase 5: ((label, dyn), ...) at FAMILY_MAIN; the
                          # first beside its plain version, the e2e dynamics
    ref: str              # phase 5: the partials row of the same shape
    rounds: object        # the registers key's ROUNDS (None: no template)
    path: tuple           # phase 6: a path's operations (the first timed)
    nmc: object           # SingleNMC, or None
    grid: object = None   # GridKernel: a trajectories kernel beside the NMC's
    main_checks: int = 2  # phase 2: the checks also run at the main shape
    edges: tuple = ()     # phase 2: (payoff, n_paths, (label, dyn), keywords)
    edge_variants: bool = False  # phase 2: the variants on every dynamics
    partials_src: str = ""  # the partials kernel's source, if not its own


class GridKernel(NamedTuple):
    """A family's trajectories kernel outside its NMC (the basket's #26:
    the (B, state) grids its LSMC reads), checked for every one-word payoff
    and timed at ``n_paths`` x MAIN_STEPS on the family's first check; its
    ``edges`` checked at GRID_EDGE_PATHS for the call and the bullet, its
    ``wide`` dynamics timed beside the first."""
    row: str
    fn: object            # (payoff, config, key, params) -> (*grids, partials)
    plain: object
    tpu: str
    n_paths: int
    rounds: object = None  # its registers key's integer
    edges: tuple = ()      # phase 2: ((label, dyn), ...)
    wide: tuple = ()       # phase 5: ((label, dyn), ...)


def single_families(mt):
    """The table of the CEV, local-vol, SABR, term, dividend, Vasicek and
    basket families."""
    from mc_tpu_torch.models import basket as bm
    from mc_tpu_torch.models import cev as cm
    from mc_tpu_torch.models import dividends as dm
    from mc_tpu_torch.models import localvol as lm
    from mc_tpu_torch.models import sabr as sm
    from mc_tpu_torch.models import term as tm
    from mc_tpu_torch.models import vasicek as vm
    from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
    from mc_tpu_torch.nmc_basket import BasketNMC
    from mc_tpu_torch.nmc_cev import CEVNMC
    from mc_tpu_torch.nmc_localvol import LocalVolNMC
    from mc_tpu_torch.nmc_sabr import SABRNMC
    from mc_tpu_torch.nmc_term import TermNMC
    from mc_tpu_torch.nmc_vasicek import VasicekNMC
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    def config(cls):
        return lambda n, _, **kw: cls(n_paths=n, n_steps=MAIN_STEPS, **kw)

    every, sv = tuple(sorted(PAYOFFS)), tuple(
        n for n in sorted(PAYOFFS) if n not in SIGMA_PAYOFFS)
    anti = (dict(antithetic=True),)
    rng20 = (dict(antithetic=True), dict(rng_source="threefry"),
             dict(rng_source="threefry", antithetic=True))
    generic = ("nmc_engine.py:445 (no Pallas counterpart: the XLA scan "
               "xla_family_trajectories)")
    half = _scale(pair_ops(13), 0.5)
    cev = (("", cm.DEMO_CEV),)
    lv = (("K=9", lm.LocalVolSurface.demo(MAIN_STEPS)),
          ("K=25", cev_gate_surface(lm, MAIN_STEPS)))

    def smile(k):
        return (f"K={k}", lm.LocalVolSurface.from_function(
            lambda x, t: 0.2 + 0.1 * x * x + 0.05 * t, MAIN_STEPS,
            n_knots=k))

    # #19's edges: K at the knot capacity and one past it (11 and up: runtime
    # K), 32 and 33, a ragged last lockstep group, antithetic and threefry-20
    def lv_key(surf):  # the kernel's template: <P, 13, capacity, false>
        from mc_tpu_torch.ops import _cuda

        return 13, _cuda.load().mc_localvol_capacity(surf.n_knots), 0

    lv_edges = (("vanilla_call", EDGE_PATHS, smile(2), {}),
                ("vanilla_call", EDGE_PATHS, smile(10), anti[0]),
                ("bullet_call", EDGE_PATHS, smile(11), rng20[1]),
                ("vanilla_call", EDGE_PATHS, smile(32), rng20[2]),
                ("asian_call", EDGE_PATHS, smile(33), anti[0]))
    # the demo (beta = 1: the unit-beta kernel) and beta = 0.5 (the general)
    sabr = (("", sm.DEMO_SABR),
            ("beta=0.5", dataclasses.replace(sm.DEMO_SABR, beta=0.5)))

    def sabr_key(dyn):  # the kernel's template: <P, 13, unit beta, false>
        return 13, int(sm.sabr_unit_beta(sm.pack_sabr(
            mt.DEMO_OPTION, dyn, MAIN_STEPS, "cpu"))), 0

    # rates 12% down to 2%, vols 10% up to 40%
    steep = (("steep curves", tm.TermStructure.from_knots(
        [0.12, 0.08, 0.04, 0.02], [0.1, 0.2, 0.3, 0.4], MAIN_STEPS)),)
    two = (("two payments", two_payments(dm, MAIN_STEPS)),)
    vas = (("", vm.DEMO_VASICEK),)
    # the demo basket (d = 4, rho = 0.5), then every capacity's edges
    baskets = tuple((f"d={d}", bm.demo_basket(d, 0.5))
                    for d in (4,) + BASKET_EDGES)
    # the inner leg's start under local vol and term (w = logf(S_t/s0), S =
    # s0*expf(w)) is under 1% of its steps: left out of the substep
    return (
        Single(family="cev", kernels=CEV_KERNELS, model=cm,
               config=config(cm.CEVConfig), pack=cm.pack_cev,
               tpu="models/cev.py:150", checks=cev, payoffs=sv,
               variants=anti, timed=cev, ref="heston_partials", rounds=(0,),
               path=family_traj_path("cev", MAIN_STEPS)[0],
               nmc=SingleNMC(
                   fam=CEVNMC(), dyn=lambda n: cm.DEMO_CEV, traj_tpu=generic,
                   struct="CEVFamily", n_grids=1,
                   substep=_add(half, CEV_STEP_OPS), ref=("Heston", "heston"),
                   traj_ref="merton_trajectories")),
        Single(family="localvol", kernels=LOCALVOL_KERNELS, model=lm,
               config=lambda n, surf, **kw: lm.LocalVolConfig(
                   n_paths=n, n_steps=MAIN_STEPS, n_knots=surf.n_knots, **kw),
               pack=lm.pack_localvol, tpu="models/localvol.py:264",
               checks=lv, payoffs=every, variants=rng20, timed=lv,
               ref="heston_partials", rounds=lv_key,
               path=family_traj_path("localvol", MAIN_STEPS)[0],
               nmc=SingleNMC(
                   fam=LocalVolNMC(extras=(9,)), dyn=lm.LocalVolSurface.demo,
                   traj_tpu="models/localvol.py:406", struct="LocalVolFamily",
                   n_grids=1, substep=_add(half, lv_step_ops(9)),
                   ref=("Heston", "heston"), traj_ref="merton_trajectories"),
               edges=lv_edges, partials_src="localvol_partials.cuh"),
        Single(family="sabr", kernels=SABR_KERNELS, model=sm,
               config=config(sm.SABRConfig), pack=sm.pack_sabr,
               tpu="models/sabr.py:177", checks=sabr, payoffs=sv,
               variants=rng20, timed=sabr, ref="heston_partials",
               rounds=sabr_key,
               path=family_traj_path("sabr", MAIN_STEPS)[0],
               edge_variants=True, partials_src="sabr_partials.cuh",
               nmc=SingleNMC(
                   fam=SABRNMC(), dyn=lambda n: sm.DEMO_SABR,
                   traj_tpu=generic, struct="SABRFamily", n_grids=2,
                   substep=_add(pair_ops(13), SABR_STEP_OPS),
                   ref=("Heston", "heston"),
                   traj_ref="family_trajectories_cev")),
        Single(family="term", kernels=TERM_KERNELS, model=tm,
               config=config(tm.TermConfig), pack=tm.pack_term,
               tpu="models/term.py:178", checks=steep, payoffs=every,
               variants=anti,
               timed=(("demo curves", tm.demo_term(MAIN_STEPS)),),
               ref="cev_partials", rounds=None,
               path=family_traj_path("term", MAIN_STEPS)[0],
               nmc=SingleNMC(
                   fam=TermNMC(), dyn=tm.demo_term, traj_tpu=generic,
                   struct="TermFamily", n_grids=1,
                   substep=_add(half, STEP_OPS), ref=("CEV", "cev"),
                   traj_ref="family_trajectories_cev")),
        Single(family="divs", kernels=DIVS_KERNELS, model=dm,
               config=config(dm.DivsConfig), pack=dm.pack_divs,
               tpu="models/dividends.py:146", checks=two, payoffs=every,
               variants=anti, timed=two, ref="cev_partials", rounds=(0, 1),
               path=divs_path(MAIN_STEPS, 2), nmc=None),
        Single(family="vasicek", kernels=VASICEK_KERNELS, model=vm,
               config=config(vm.VasicekConfig), pack=vm.pack_vasicek,
               tpu="models/vasicek.py:266", checks=vas, payoffs=every,
               variants=rng20, timed=vas, ref="merton_partials", rounds=13,
               path=family_traj_path("vasicek", MAIN_STEPS)[0],
               nmc=SingleNMC(
                   fam=VasicekNMC(), dyn=lambda n: vm.DEMO_VASICEK,
                   traj_tpu="models/vasicek.py:405", struct="VasicekFamily",
                   n_grids=3, substep=_add(_scale(pair_ops(13), 2),
                                           VASICEK_STEP_OPS),
                   ref=("Merton", "merton"), traj_ref="merton_trajectories")),
        Single(family="basket", kernels=BASKET_KERNELS, model=bm,
               config=lambda n, b, **kw: bm.BasketConfig(
                   n_paths=n, n_steps=MAIN_STEPS, d=b.d, **kw),
               pack=bm.pack_basket, tpu="models/basket.py:268",
               checks=baskets, payoffs=every, variants=anti,
               timed=baskets[:1], ref="heston_partials",
               rounds=(4, 0), path=family_traj_path("basket", MAIN_STEPS, 4)[0],
               nmc=SingleNMC(
                   fam=BasketNMC(extras=(4,)), dyn=lambda n: bm.DEMO_BASKET,
                   traj_tpu=generic, struct="BasketFamily<8>", n_grids=4,
                   substep=_add(_scale(pair_ops(13), 2), basket_step_ops(4)),
                   ref=("Heston", "heston"),
                   traj_ref="family_trajectories_sabr"),
               grid=GridKernel(row="basket_trajectories",
                               fn=bm.basket_trajectories,
                               plain=bm.basket_trajectories_plain,
                               tpu="models/basket.py:393",
                               n_paths=GRID_PATHS, rounds=4,
                               edges=tuple((f"d={d}", bm.demo_basket(d, 0.5))
                                           for d in (1, 4, 5, 8, 9, 16, 17,
                                                     32)),
                               wide=tuple((f"d={d}", bm.demo_basket(d, 0.5))
                                          for d in (9, 32))),
               main_checks=1,  # the d edges at FAMILY_PATHS
               edge_variants=True, partials_src="basket_partials.cuh"),
    )


def spaced(*parts) -> str:
    return " ".join(p for p in parts if p)


def traj_row(s: Single) -> str:
    """The kernels line's row of a family's trajectories kernel (the
    generic kernel's rows carry the family)."""
    k = s.kernels[1]
    return f"{k}_{s.family}" if k == "family_trajectories" else k


def single_rows(s: Single):
    """A family's rows on the kernels line."""
    return (f"{s.family}_partials",) + ((
        traj_row(s), f"family_inner_{s.family}", f"family_fused_{s.family}")
        if s.nmc else ()) + ((s.grid.row,) if s.grid else ())


def nmc_pack(s: Single):
    """The NMC's pack: its default dynamics at the run's steps."""
    return lambda opt, _, n_steps, dev: s.pack(opt, s.nmc.dyn(n_steps),
                                               n_steps, dev)


def single_kernel_checks(mt, dev, singles, keys):
    """Phase 2 of the single-asset families: each partials kernel on its
    payoff sweep, its variants on the vanilla and bullet, its other
    dynamics (local vol's K = 25 CEV-gate surface) and the main shape, the
    trajectories (every one-word payoff), and the #29/#30 at NMC_SMALL and
    at NMC_MAIN against the plain rows NMC_ROWS, each against its plain
    version on the card, deferred.  Returns ({row: max abs error}, {family:
    ms of the plain version's rows at NMC_MAIN}), filled by the kernel
    pass."""
    from mc_tpu_torch.ops.payoffs import PAYOFFS

    err = {row: 0.0 for s in singles for row in single_rows(s)}

    def note(row, e):
        err[row] = max(err[row], e)

    rows_ms = {}
    for s in singles:
        row = f"{s.family}_partials"

        def case(name, n_paths, label_dyn, **kw):
            label, dyn = label_dyn
            opt = payoff_option(mt, name)
            defer(partials_check(note, row, getattr(s.model, row),
                                 getattr(s.model, f"{row}_plain"),
                                 s.config(n_paths, dyn, **kw),
                                 keys[s.family][0],
                                 s.pack(opt, dyn, MAIN_STEPS, dev), name,
                                 opt, label))

        for name in s.payoffs:
            case(name, FAMILY_PATHS, s.checks[0])
        for name in ("vanilla_call", "bullet_call"):
            for kw in s.variants:
                case(name, FAMILY_PATHS, s.checks[0], **kw)
            for label_dyn in s.checks[1:]:
                case(name, FAMILY_PATHS, label_dyn)
                for kw in s.variants if s.edge_variants else ():
                    case(name, FAMILY_PATHS, label_dyn, **kw)
        for label_dyn in s.checks[:s.main_checks]:  # the main shape: a
            # partly filled block
            case("vanilla_call", FAMILY_MAIN, label_dyn)
        for name, n_paths, label_dyn, kw in s.edges:
            case(name, n_paths, label_dyn, **kw)
        if s.family in ("cev", "divs"):
            cev_divs_edge_checks(mt, dev, note, s, keys[s.family][0])
        if s.nmc is None:
            continue
        for name, po in sorted(PAYOFFS.items()):
            if po.n_state <= 1:
                defer(traj_check(mt, dev, note, traj_row(s), s.nmc.fam,
                                 nmc_pack(s), None, keys[s.family][0], name,
                                 FAMILY_PATHS))
        traj_ragged(mt, dev, note, traj_row(s), s.nmc.fam, nmc_pack(s), None,
                    keys[s.family][0])
        rows_ms[s.family] = family_nmc_checks(
            mt, dev, note, s.family, s.nmc.fam, nmc_pack(s), None,
            keys[s.family], traj_row(s), extra=nmc_extra_cases(mt, s))
        if s.grid is not None:
            for name, po in sorted(PAYOFFS.items()):
                if po.n_state <= 1:
                    defer(grid_check(mt, dev, note, s, keys[s.family][0],
                                     name))
            for label_dyn in s.grid.edges:
                for name in ("vanilla_call", "bullet_call"):
                    defer(grid_check(mt, dev, note, s, keys[s.family][0],
                                     name, label_dyn, GRID_EDGE_PATHS))
    return err, rows_ms


# #18's and #22's edge shapes beside their main ones (phase 2, each against
# its plain version on the card; family_nmc_probe.py --partials holds them
# to the parent kernels): ragged lockstep groups, an offset past 2^20 with
# a bound inside the run and one past its last path, CEV at beta 0 and 1
# and absorbed at 0, the dividends' edge schedules (a payment at step 0
# and the last, every step paying, -0.0 between, negative, above the spot,
# +inf: family_nmc_probe.py's divs_schedules but NaN, whose plain clamp keeps
# the NaN that the kernel's fmaxf drops), 2 steps and a schedule past the
# block table's 2,048 steps.
EDGE_OFFSET = (1 << 20) + 12_345
DIVS_EDGE_SCHEDULES = ("first and last step", "every step", "-0.0 between",
                       "negative", "above spot", "+inf")


def cev_divs_edge_checks(mt, dev, note, s: Single, key):
    """Phase 2: #18's or #22's edge shapes (EDGE_OFFSET, the schedules)
    against the plain version, deferred."""
    from family_nmc_probe import divs_schedules
    from mc_tpu_torch.models import cev as cm
    from mc_tpu_torch.models import dividends as dm

    row = f"{s.family}_partials"
    fn, plain = getattr(s.model, row), getattr(s.model, f"{row}_plain")

    def check(name, cfg, prm, label, offset=0, n_valid=None):
        defer(partials_check(note, row, fn, plain, cfg, key, prm, name,
                             payoff_option(mt, name), label, offset,
                             n_valid))

    for anti in (False, True):
        for n_valid, label in ((EDGE_OFFSET + EDGE_PATHS - 1000,
                                "offset, bound inside"),
                               (0xFFFFFFFF, "offset, bound past the end")):
            dyn = s.checks[0][1]
            check("asian_call", s.config(EDGE_PATHS, dyn, antithetic=anti),
                  s.pack(payoff_option(mt, "asian_call"), dyn, MAIN_STEPS,
                         dev), label, EDGE_OFFSET, n_valid)
    if s.family == "cev":
        for label, dyn in (("beta=0", cm.CEVDynamics(sigma_lv=20.0, beta=0.0)),
                           ("beta=1", cm.CEVDynamics(sigma_lv=0.2, beta=1.0)),
                           ("absorbed", cm.CEVDynamics(sigma_lv=60.0,
                                                       beta=1.0))):
            for name in ("vanilla_call", "bullet_call", "asian_call"):
                for anti in (False, True):
                    check(name, s.config(EDGE_PATHS, dyn, antithetic=anti),
                          s.pack(payoff_option(mt, name), dyn, MAIN_STEPS,
                                 dev), label)
        return
    for label in DIVS_EDGE_SCHEDULES:
        d = divs_schedules(MAIN_STEPS)[label]
        for name in ("vanilla_call", "bullet_call", "asian_call",
                     "up_out_call_bb"):
            for anti in (False, True):
                check(name, s.config(EDGE_PATHS, d, antithetic=anti),
                      s.pack(payoff_option(mt, name), d, MAIN_STEPS, dev),
                      label)
    # 2 steps, and a schedule past the block table (its loop without it)
    for n_steps in (2, 2050):
        d = divs_schedules(n_steps)["first and last step"]
        for anti in (False, True):
            check("asian_call", dm.DivsConfig(n_paths=4099, n_steps=n_steps,
                                              antithetic=anti),
                  dm.pack_divs(payoff_option(mt, "asian_call"), d, n_steps,
                               dev), f"{n_steps} steps")


def nmc_extra_cases(mt, s: Single):
    """family_nmc_checks' extra cases of a single-asset family: the second
    fused path of phase 3 at the ragged shape (Vasicek's bond, the basket's
    Margrabe exchange at d = 2) and local vol's pack over the shared budget
    (NMC_OVER_BUDGET at K = 25, rows 0 and 299)."""
    from mc_tpu_torch.models import basket as bm
    from mc_tpu_torch.models import localvol as lm
    from mc_tpu_torch.nmc_basket import BasketNMC
    from mc_tpu_torch.nmc_localvol import LocalVolNMC

    shape = ragged_shape(s.family)
    if s.family == "vasicek":
        return ((s.nmc.fam, nmc_pack(s), "zcb", shape, None, "bond"),)
    if s.family == "basket":
        exch = mt.BasketDynamics(*(np.array(v, np.float32) for v in (
            [100.0, 95.0], [0.25, 0.2], [1.0, -1.0],
            [[1.0, 0.4], [0.4, 1.0]])))
        return ((BasketNMC(extras=(2,)),
                 lambda _, __, n, d: bm.pack_basket(mt.OptionParams(k=0.0),
                                                    exch, n, d),
                 "vanilla_call", shape, None, "d=2 exchange"),)
    if s.family == "localvol":
        n_steps = NMC_OVER_BUDGET[1]
        surf = cev_gate_surface(lm, n_steps)
        return ((LocalVolNMC(extras=(surf.n_knots,)),
                 lambda o, _, n, d: lm.pack_localvol(o, surf, n, d),
                 "vanilla_call", NMC_OVER_BUDGET, (0, n_steps - 1),
                 "K=25 over the shared budget"),)
    return ()


def grid_check(mt, dev, note, s: Single, key, name, label_dyn=None,
               n_paths=None):
    """Phase 2: a family's GridKernel on ``label_dyn`` (its first
    dynamics) at ``n_paths`` (its own) x MAIN_STEPS against its plain
    version: the grids bitwise, the payoff sums to f64 rounding.  A
    deferred check."""
    from mc_tpu_torch.ops.payoffs import get_payoff
    from mc_tpu_torch.ops.reduce import finish_sum

    g = s.grid
    po, opt = get_payoff(name), payoff_option(mt, name)
    label, dyn = label_dyn or s.checks[0]
    n_paths = n_paths or g.n_paths
    cfg = s.config(n_paths, dyn)
    prm = s.pack(opt, dyn, MAIN_STEPS, dev)
    *g_p, part_p = g.plain(po, cfg, key, prm)
    yield
    *g_k, part_k = g.fn(po, cfg, key, prm)
    text = spaced(g.row, label, name, f"{n_paths}x{MAIN_STEPS}")
    note(g.row, check_bitwise(f"{text} (grids, state)", g_k, g_p))
    got, want = finish_sum(part_k), finish_sum(part_p)
    check_sums(f"{text} payoff", got, want)
    note(g.row, price_err(got, want, n_paths, opt))


def single_times(mt, dev, singles, keys, regs, tag, time_pair, ref_ms,
                 nmc_ms, e2e_nmc):
    """Phase 5 of the single-asset families: each kernel (CUDA events)
    beside its plain version and beside the kernel of its shape one family
    down (``ref_ms``: Heston's Euler partials and NMC kernels, Merton's
    #15; the table's earlier families as they come), the registers, and
    the e2e calls (the family kernels' and the NMC calls' times are their
    phase-2 and phase-3 calls', ``nmc_ms`` and ``e2e_nmc``).  Returns {row:
    (ms, plain ms)} (the family kernels' plain ms is measured in phase
    2)."""
    from mc_tpu_torch.ops.payoffs import get_payoff

    call, opt = get_payoff("vanilla_call"), mt.DEMO_OPTION
    osim = mt.SimParams(n_paths=FAMILY_MAIN, n_steps=MAIN_STEPS)
    known = dict(ref_ms)  # {row: ms}
    out = {}
    for s in singles:
        row, key = f"{s.family}_partials", keys[s.family][0]
        fn, plain = getattr(s.model, row), getattr(s.model, f"{row}_plain")
        rows = []
        for i, (label, dyn) in enumerate(s.timed):
            cfg = s.config(FAMILY_MAIN, dyn)
            prm = s.pack(opt, dyn, MAIN_STEPS, dev)
            rows.append((
                row if i == 0 else None, spaced(row, "call", label),
                lambda cfg=cfg, prm=prm: fn(call, cfg, key, prm),
                (lambda cfg=cfg, prm=prm: plain(call, cfg, key, prm))
                if i == 0 else None,
                (f"{row}_kernel", "VanillaCall",
                 s.rounds(dyn) if callable(s.rounds) else s.rounds),
                (f"{s.ref} call euler", known[s.ref])))
        out.update(partials_times(rows, FAMILY_MAIN, time_pair, regs, tag))
        price_fn = getattr(mt, f"price_{s.family}")
        label, dyn = s.timed[0]
        e2e = [(spaced(f"price_{s.family}()", label,
                      f"{FAMILY_MAIN}x{MAIN_STEPS}"), "path-steps/s",
                FAMILY_MAIN * MAIN_STEPS,
                lambda dyn=dyn: price_fn(opt, dyn, osim, device=DEVICE))]
        if s.nmc is not None:
            n = s.nmc
            ref_label, ref_family = n.ref
            out.update(family_nmc_times(
                ((s.family, n.fam, s.pack(opt, n.dyn(MAIN_STEPS), MAIN_STEPS,
                                          dev), keys[s.family], traj_row(s),
                  n.struct, nmc_ms[s.family],
                  (ref_label, {name: known[f"{name}_{ref_family}"]
                               for name in ("family_fused", "family_inner")})),
                 ), call, time_pair, regs, tag))
            t_ms = known[n.traj_ref]
            print(f"phase 5: {traj_row(s)}: {out[traj_row(s)][0] / t_ms:.2f}x "
                  f"{n.traj_ref} on the same shape ({t_ms:.4f} ms) {tag}")
            e2e += nmc_e2e_rows(s.family, e2e_nmc)
        if s.grid is not None:
            g, (label, dyn) = s.grid, s.timed[0]
            cfg = s.config(g.n_paths, dyn)
            prm = s.pack(opt, dyn, MAIN_STEPS, dev)
            out[g.row] = time_pair(
                spaced(g.row, "call", label),
                lambda cfg=cfg, prm=prm: g.fn(call, cfg, key, prm),
                lambda cfg=cfg, prm=prm: g.plain(call, cfg, key, prm),
                f"{g.n_paths}x{MAIN_STEPS}")
            grid_bytes = 2 * 4 * g.n_paths * MAIN_STEPS
            print(f"phase 5: {g.row} writes {grid_bytes / 1e6:.1f} MB in "
                  f"{out[g.row][0]:.4f} ms: "
                  f"{grid_bytes / out[g.row][0] / 1e6:.1f} GB/s; registers "
                  f"{regs.get((f'{g.row}_kernel', 'VanillaCall', g.rounds))}"
                  f" {tag}")
            for w_label, w_dyn in g.wide:
                cfg = s.config(g.n_paths, w_dyn)
                prm = s.pack(opt, w_dyn, MAIN_STEPS, dev)
                k_ms, sp, _ = cuda_ms(lambda cfg=cfg, prm=prm: g.fn(
                    call, cfg, key, prm))
                b_ms = probe_bound(g.row, payoff="vanilla_call", d=w_dyn.d,
                                   n_paths=g.n_paths, n_steps=MAIN_STEPS)[0]
                print(f"phase 5: {spaced(g.row, 'call', w_label)} "
                      f"{g.n_paths}x{MAIN_STEPS}: kernel {k_ms:.4f} ms "
                      f"(spread {sp:.1%}), {b_ms / k_ms:.1%} of its bound "
                      f"({b_ms:.4f} ms) {tag}")
        known.update({k: v[0] for k, v in out.items()})
        e2e_report(e2e, tag)
    return out


def single_bounds(singles):
    """bound() of the single-asset families' rows at the shapes the kernels
    line reports: each partials kernel at FAMILY_MAIN x 100 (its packed
    vector read once), the trajectories at NMC_MAIN's outer 16,384 x 100
    (vanilla: the market grids and a state grid written), the family
    kernels at NMC_MAIN (vanilla)."""
    from mc_tpu_torch.config import DEMO_OPTION

    n_out, n_steps, _ = NMC_MAIN
    out = {}
    for s in singles:
        prm = s.pack(DEMO_OPTION, s.timed[0][1], MAIN_STEPS, "cpu")
        out[f"{s.family}_partials"] = bound(4 * prm.numel(),
                                            _scale(s.path, FAMILY_MAIN))
        if s.nmc is not None:
            out[traj_row(s)] = bound((s.nmc.n_grids + 1) * 4 * n_out * n_steps,
                                     _scale(s.path, n_out))
            out.update(family_bounds(s.family, s.nmc.substep, s.path,
                                     s.nmc.n_grids))
        if s.grid is not None:  # the level and state grids written
            out[s.grid.row] = bound(
                4 * prm.numel() + 2 * 4 * s.grid.n_paths * MAIN_STEPS,
                _scale(s.path, s.grid.n_paths))
    return out


# --- the rainbow, FX and QMC slice: kernels #27, #28, #31, #32 and the
# rainbow's #29/#30 ---------------------------------------------------------

FX_KERNELS = ("fx_partials",)
# phase 2: #27 about each capacity (basket_capacity: 4, 8, 16, 32), at a
# ragged path count (its last block cut)
RAINBOW_EDGE_D = (1, 4, 5, 8, 9, 16, 17, 32)
RAINBOW_RAGGED = 4_099
RAINBOW_KERNELS = ("rainbow_partials", "family_trajectories", "family_inner",
                   "family_fused")
QMC_KERNELS = ("qmc_sums", "qmc_bridge_sums")
QMC_MODEL_KERNELS = ("qmc_model_sums",)
FX_RAINBOW_QMC_ROWS = ("fx_partials", "rainbow_partials",
                "family_trajectories_rainbow", "family_inner_rainbow",
                "family_fused_rainbow", "qmc_sums", "qmc_bridge_sums")
QMC_POINTS = 1 << 20        # bench.py:505-527: n = prev_prime(2^20), or 2^20
QMC_SHIFTS = 16
QMC_CHECK_SHIFTS = 2        # phase 2: each QMC kernel on two shifts
QMC_RAGGED = (3, 17)        # phase 2: shift counts with a ragged last group
QMC_RAGGED_GBM = (("asian_call", "euler", "sobol", 3),
                  ("asian_call", "euler", "lattice", 17),
                  ("vanilla_call", "terminal", "sobol", 17),
                  ("vanilla_call", "terminal", "lattice", 3))
QMC_SMALL = 4099            # phase 2: every payoff (4096 points for Sobol)
# phase 2: the bridge's step counts beside MAIN_STEPS: its fewest nodes, an
# odd count's clamped half, and 64-thread blocks (453 steps)
BRIDGE_STEPS = (1, 2, 3, 453)
# The terminal QMC call's allowance beside its 3 stderr: the f32 inverse
# CDF's bias (|dz| up to ~2e-6, delta * S0 * sigma * 2e-6 < 3e-5) and its
# clamp at 1 - 1e-6; at 1,048,573 x 16 the stderr is ~1e-5.
QMC_BIAS = 1e-4
# A QMC coordinate (qmc.cuh), the least work for R shifts whatever computes
# it: its shift-independent part once per (point, dimension), the lattice
# residue (two float-assisted reductions, the split's shifts and adds) and
# t * (1/n), or the Sobol XOR of the direction numbers over the Gray code's
# set bits (10 on average for ids below 2^20: an XOR and a bit cleared
# each); then per (point, shift, dimension) the lattice's + shift and frac,
# or the Sobol shift's XOR and bits_to_unit, and the inverse CDF (~84 f32
# operations with its four divisions; logf, sqrtf and two expf).
LATTICE_BASE_OPS = (20, 5, 0)
LATTICE_SHIFT_OPS = (0, 3, 0)
SOBOL_BASE_OPS = (2 * 10, 0, 0)
SOBOL_SHIFT_OPS = (4, 1, 0)
INV_CDF_OPS = (0, 84, 4)
QMC_COORD_OPS = {"lattice": (LATTICE_BASE_OPS, LATTICE_SHIFT_OPS),
                 "sobol": (SOBOL_BASE_OPS, SOBOL_SHIFT_OPS)}
# A bridge entry: (c_l W[l] + c_r W[r]) + s z (5), and a step's increment
# (1).
BRIDGE_OPS = (0, 6, 0)
# Phase 2: #28 for every contract at ragged path counts, a block cut by an
# offset and a bound, and 2^24 paths (the grid strides): (n_paths,
# path_offset, n_valid).
FX_EDGE_SHAPES = ((1, 0, None), (255, 0, None), (257, 0, None),
                  (100_001, 0, None), (5_000, 1_000, 1_000 + 4_321),
                  (1 << 24, 0, None))
# FX, the least work of a path on top of its pair, by contract kind (gk,
# quanto, compo, flexo): z_x (3) and X_T (3 and an expf) where the payoff
# reads X_T, S_T (3 and an expf) where it reads S_T, the payoff and its
# square (gk 3, quanto, compo and flexo 4; a put's sign is free).
FX_KIND_OPS = ((0, 9, 1), (0, 7, 1), (0, 13, 2), (0, 13, 2))


def fx_path_ops(contract: str):
    """An FX path of ``contract``: its pair and its kind's work."""
    from mc_tpu_torch.models.fx import FX_CONTRACTS

    return _add(pair_ops(13), FX_KIND_OPS[FX_CONTRACTS[contract] >> 1])


def greek_path_ops(payoff: str, method: str, n_steps: int):
    """A path of the greek kernel (#8, greek_kernels.cu) and its finish:
    the terminal draw; or the log-Euler loop, a pair per two steps, which
    for a payoff with state (the Asian) takes the step of path_ops and
    GREEK_STEP_OPS each step and for one without (the call, the put)
    GREEK_STATELESS_STEP_OPS, S once at maturity; then the tangents, the
    five values and their squares (GREEK_TERMINAL_OPS)."""
    from mc_tpu_torch.ops.payoffs import get_payoff

    if method == "terminal":
        return _add(pair_ops(13), TERMINAL_DRAW_OPS, GREEK_TERMINAL_OPS)
    if get_payoff(payoff).n_state == 0:
        return _add(_scale(pair_ops(13), (n_steps + 1) // 2),
                    _scale(GREEK_STATELESS_STEP_OPS, n_steps), SPOT_OPS,
                    GREEK_TERMINAL_OPS)
    return _add(path_ops(payoff, n_steps, 13),
                _scale(GREEK_STEP_OPS, n_steps), GREEK_TERMINAL_OPS)


def rainbow_path(d: int, antithetic: bool = False):
    """A rainbow path: ceil(d/2) pairs, the mix (d(d+1)/2 multiplies, d(d-1)/2
    adds), per asset (per leg) 2 f32, an expf and the max and min folds
    (2), the payoff and its square."""
    leg = (0, 4 * d, d)
    return _add(_scale(pair_ops(13), (d + 1) // 2),
                (0, d * (d + 1) // 2 + d * (d - 1) // 2, 0),
                _scale(leg, 2 if antithetic else 1), TERMINAL_OPS)


def qmc_point_ops(family: str, n_shifts: int, dims: int, per_shift):
    """One point under n_shifts shifts: the coordinate's base of each of its
    ``dims`` dimensions once, and per shift ``per_shift`` (its dimensions'
    shift parts and normals, its steps and payoff)."""
    base, _ = QMC_COORD_OPS[family]
    return _add(_scale(base, dims), _scale(per_shift, n_shifts))


def qmc_path(family: str, n_steps: int, bridge: bool, payoff: str,
             n_shifts: int):
    """A QMC point's paths under n_shifts shifts (qmc_point_ops): n_steps
    normals, the bridge's entries and increments, the log-Euler steps and
    the payoff (the terminal draw at n_steps = 0)."""
    _, shift = QMC_COORD_OPS[family]
    if n_steps == 0:
        return qmc_point_ops(family, n_shifts, 1, _add(
            shift, INV_CDF_OPS, TERMINAL_DRAW_OPS, TERMINAL_OPS))
    step = _add(shift, INV_CDF_OPS, STEP_OPS, UPDATE_OPS[payoff],
                BRIDGE_OPS if bridge else (0, 0, 0))
    return qmc_point_ops(family, n_shifts, n_steps,
                         _add(_scale(step, n_steps), TERMINAL_OPS))


def fx_rainbow_qmc_setup(mt):
    """The slice's shared inputs: the FX dynamics of tests/test_fx.py, the
    demo basket (d = 4), the two-asset basket of tests/test_rainbow.py."""
    import numpy as np

    two = mt.BasketDynamics(
        s0s=np.array([100.0, 105.0], np.float32),
        sigmas=np.array([0.2, 0.25], np.float32),
        weights=np.array([0.5, 0.5], np.float32),
        corr=np.array([[1.0, 0.5], [0.5, 1.0]], np.float32))
    return (mt.FXDynamics(x0=1.2, sigma_x=0.15, r_f=0.03, rho=-0.35),
            mt.demo_basket(4, 0.5), two)


def qmc_case(mt, dev, name, n_paths, n_steps, method, family, bridge,
             n_shifts):
    """(payoff, config, point set with its first n_shifts shifts, params)
    of price_qmc's call."""
    from mc_tpu_torch import qmc
    from mc_tpu_torch.ops import path_kernels as pk
    from mc_tpu_torch.ops.payoffs import get_payoff

    po = get_payoff(name)
    sim = mt.SimParams(n_paths=n_paths, n_steps=n_steps)
    m, ps = qmc.qmc_pointset(po, sim, max(QMC_SHIFTS, n_shifts), method,
                             family, bridge, 0.1, 0, sim.seed, dev)
    ps = ps.shifted(ps.shifts[:n_shifts])
    cfg = pk.KernelConfig(n_paths=ps.n, n_steps=n_steps, method=m)
    return po, cfg, ps, pk.pack_params(payoff_option(mt, name), n_steps, dev)


def block_sums(pay, blocks: dict) -> dict:
    """{block: (R, 1) f64 sums of its points} from one plain leg's (R, n)
    payoffs over the blocks' points laid end to end (``blocks``: {block:
    its point ids}, in order): one plain run for all the blocks."""
    out, at = {}, 0
    for b, ids in blocks.items():
        n = ids.shape[0]
        out[b] = pay[:, at:at + n].contiguous().double().sum(dim=1,
                                                             keepdim=True)
        at += n
    return out


def qmc_block_plain(po, cfg, ps, prm, blocks: dict) -> dict:
    """qmc_sums_plain's sums over each block's points alone: {block: (R, 1)
    f64}, one plain run over the blocks' points together."""
    from mc_tpu_torch import qmc
    from mc_tpu_torch.ops import path_kernels as pk

    ids = torch.cat(list(blocks.values()))
    p = pk.unpack_params(prm)
    pay, _ = pk._payoff_leg(po, cfg, p, p.s0.expand(ps.n_shifts, ids.shape[0]),
                            qmc.qmc_draw_pair(ps, ids, cfg.method))
    return block_sums(pay, blocks)


def qmc_model_block_plain(model, po, ps, prm, extra, blocks: dict) -> dict:
    """qmc_model_sums_plain's sums over each block's points alone, as
    qmc_block_plain: one plain run of the family's leg over them together."""
    from mc_tpu_torch import qmc

    return block_sums(qmc.qmc_model_payoffs(model, po, ps, prm, MAIN_STEPS,
                                            extra,
                                            torch.cat(list(blocks.values()))),
                      blocks)


def qmc_block_plan(ps):
    """The QMC kernels' path blocks of ``ps`` before the library is built:
    a point's block depends on the block's threads (qmc.QMC_THREADS) and n
    alone, not on the shifts a thread; the kernel half holds the library's
    launch to it (check_block_plan)."""
    from mc_tpu_torch import qmc

    return qmc.qmc_launch(ps.n, ps.n_shifts, 1, qmc.QMC_THREADS)


def check_block_plan(label, geo, plan) -> None:
    if (geo.threads, geo.n_bx) != (plan.threads, plan.n_bx):
        fail(f"{label}: the kernel's blocks ({geo.threads} threads, "
             f"{geo.n_bx} blocks) are not the plain half's ({plan.threads}, "
             f"{plan.n_bx})")


def qmc_block_ids(geo, n: int, dev) -> dict:
    """{block: its point ids} of the first and the last path block of a
    QMC kernel's launch (``geo.point_blocks``: the kernel's grid-strided
    blocks)."""
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    block = geo.point_blocks(ids)
    return {b: ids[block == b] for b in (0, geo.n_bx - 1)}


def qmc_shift_identity(label, partials, one_shift, n_shifts) -> None:
    """A QMC kernel's main-shape partials against one launch a shift (the
    shift alone, the rest of its group surplus legs): the first and the
    last shift's columns bitwise."""
    for r in (0, n_shifts - 1):
        same = bool(torch.equal(one_shift(r)[:, 0], partials[:, r]))
        print(f"phase 2: {label}, shift {r} launched alone: its "
              f"{partials.shape[0]} rows bitwise {same}")
        if not same:
            fail(f"{label}: shift {r}'s rows depend on the shifts beside it")


def fx_rainbow_qmc_checks(mt, dev, keys, lattice_ready):
    """Phase 2 of the rainbow, FX and QMC slice, each kernel against its
    plain version on the card: #28 (every contract, threefry-13 and -20, at
    1M), #27 (every payoff at d = 4 and 1M, antithetic; the bench's call
    without; threefry-20; the call at d = 1, 2, 8, 9, 32 at 16,384), the
    rainbow's generic trajectories (every one-word payoff) and #29/#30 at
    NMC_SMALL (both folds) and at NMC_MAIN against the plain rows NMC_ROWS,
    #32 (the terminal call at the full 2^20 points of both families, every
    payoff at QMC_SMALL on the lattice and some on Sobol, the Asian at the
    full points x 100; QMC_RAGGED_GBM's ragged shift groups; at the main
    shape the first and the last block's rows against the plain sums of
    their points and each shift's rows against a launch of that shift
    alone, bitwise) and #31 (the Asian at the full shape, every payoff at
    QMC_SMALL), the QMC kernels on two shifts, each check deferred (the
    full-width ones after ``lattice_ready()`` returns: the CBC vector is
    built in a thread).  Sums to f64 rounding, grids and surfaces bitwise.
    Returns ({row: max abs error}, the rainbow NMC's family_nmc_case ms),
    filled by the kernel pass."""
    from mc_tpu_torch import qmc
    from mc_tpu_torch.models import basket as bm
    from mc_tpu_torch.models import fx
    from mc_tpu_torch.models import rainbow as rb
    from mc_tpu_torch.nmc_rainbow import RainbowNMC
    from mc_tpu_torch.ops.payoffs import PAYOFFS
    from mc_tpu_torch.ops.reduce import finish_sum

    err = dict.fromkeys(FX_RAINBOW_QMC_ROWS, 0.0)

    def note(row, e):
        err[row] = max(err[row], e)

    opt = mt.DEMO_OPTION

    def sums_case(row, fn, plain, n_paths, label):
        want = finish_sum(plain())
        yield
        got = finish_sum(fn())
        check_sums(f"{row} {label} {n_paths} paths", got, want)
        note(row, price_err(got, want, n_paths, opt))

    fxd, demo, _ = fx_rainbow_qmc_setup(mt)
    fx_prm = fx.pack_fx(opt, fxd, dev)
    for contract in sorted(fx.FX_CONTRACTS):
        shapes = [(FAMILY_MAIN, src, 0, None)
                  for src in ("threefry13", "threefry")]
        shapes += [(n, "threefry13", off, n_valid)
                   for n, off, n_valid in FX_EDGE_SHAPES]
        for n, src, off, n_valid in shapes:
            cfg = fx.FXConfig(n, src)
            defer(sums_case(
                "fx_partials",
                lambda contract=contract, cfg=cfg, off=off, nv=n_valid:
                    fx.fx_partials(contract, cfg, keys["fx"][0], fx_prm, off,
                                   nv),
                lambda contract=contract, cfg=cfg, off=off, nv=n_valid:
                    fx.fx_partials_plain(contract, cfg, keys["fx"][0], fx_prm,
                                         off, nv),
                n, f"{contract} {src}"
                + (f" offset {off} bound {n_valid}" if off else "")))

    def rainbow_case(name, n_paths, dyn, **kw):
        cfg = rb.RainbowConfig(n_paths=n_paths, d=dyn.d, **kw)
        prm = bm.pack_basket(opt, dyn, 1, dev)
        defer(sums_case(
            "rainbow_partials",
            lambda: rb.rainbow_partials(name, cfg, keys["rainbow"][0], prm),
            lambda: rb.rainbow_partials_plain(name, cfg, keys["rainbow"][0],
                                              prm),
            n_paths, f"{name} d={dyn.d} {cfg.rng_source} "
            f"anti={cfg.antithetic}"))

    for name in sorted(rb.RAINBOW_PAYOFFS):
        rainbow_case(name, FAMILY_MAIN, demo, antithetic=True)
    rainbow_case("call_on_max", FAMILY_MAIN, demo)
    rainbow_case("put_on_min", FAMILY_PATHS, demo, rng_source="threefry",
                 antithetic=True)
    for d in (1, 2, 8, 9, 32):
        rainbow_case("call_on_max", FAMILY_PATHS, bm.demo_basket(d, 0.5))
    # each capacity's edges (4, 8, 16, 32), the plain and the antithetic
    # kernel, at a ragged path count
    for d in RAINBOW_EDGE_D:
        for anti in (False, True):
            rainbow_case("put_on_min" if anti else "call_on_max",
                         RAINBOW_RAGGED, bm.demo_basket(d, 0.5),
                         antithetic=anti)

    def pack(o, _, n_steps, dv):
        return bm.pack_basket(o, demo, n_steps, dv)

    fam = RainbowNMC(extras=(4, 0))
    row = "family_trajectories_rainbow"
    for name, po in sorted(PAYOFFS.items()):
        if po.n_state <= 1:
            defer(traj_check(mt, dev, note, row, fam, pack, None,
                             keys["rainbow_nmc"][0], name, FAMILY_PATHS))
    traj_ragged(mt, dev, note, row, fam, pack, None, keys["rainbow_nmc"][0])
    kinds = {"trajectories": row, "fused": "family_fused_rainbow",
             "inner": "family_inner_rainbow"}
    defer(family_nmc_case(mt, dev, RainbowNMC(extras=(4, 1)), pack, None,
                          keys["rainbow_nmc"], "vanilla_call", NMC_SMALL,
                          lambda kind, e: note(kinds[kind], e)))
    nmc_ms = family_nmc_checks(mt, dev, note, "rainbow", fam, pack, None,
                               keys["rainbow_nmc"], row, rows=NMC_ROWS)

    def check_qmc(name, n_paths, n_steps, method, family, bridge,
                  n_shifts=QMC_CHECK_SHIFTS):
        po, cfg, ps, prm = qmc_case(mt, dev, name, n_paths, n_steps, method,
                                    family, bridge, n_shifts)
        want = finish_sum(qmc.qmc_sums_plain(po, cfg, ps, prm, bridge))
        yield
        got = finish_sum(qmc.qmc_sums(po, cfg, ps, prm, bridge))
        row = "qmc_bridge_sums" if bridge else "qmc_sums"
        check_sums(f"{row} {name} {family} {cfg.method} {ps.n}x{n_steps} "
                   f"{ps.n_shifts} shifts", got, want)
        note(row, float((got - want).abs().max()) / ps.n)

    def main_blocks(family):
        """#32 at the main shape: the first and the last block's rows
        against the plain sums of their points, and each shift's rows
        against a launch of that shift alone, bitwise."""
        po, cfg, ps, prm = qmc_case(mt, dev, "asian_call", QMC_POINTS,
                                    MAIN_STEPS, "euler", family, False,
                                    QMC_SHIFTS)
        plan = qmc_block_plan(ps)
        want = qmc_block_plain(po, cfg, ps, prm, qmc_block_ids(plan, ps.n,
                                                              dev))
        yield
        geo = qmc.kernel_launch(ps)
        partials = qmc.qmc_sums(po, cfg, ps, prm)
        label = (f"qmc_sums asian_call {family} euler {ps.n}x{MAIN_STEPS} "
                 f"{ps.n_shifts} shifts")
        check_block_plan(label, geo, plan)
        if partials.shape[0] != geo.n_bx:
            fail(f"{label}: {partials.shape[0]} blocks, kernel_launch's "
                 f"{geo.n_bx}")
        for b, w in want.items():
            check_sums(f"{label}, block {b} of {geo.n_bx}", partials[b], w)
            note("qmc_sums", float((partials[b] - w).abs().max()) / ps.n)
        qmc_shift_identity(label, partials, lambda r: qmc.qmc_sums(
            po, cfg, ps.shifted(ps.shifts[r:r + 1]), prm), ps.n_shifts)

    for name, po in sorted(PAYOFFS.items()):
        if po.terminal_only:
            for family in ("lattice", "sobol"):
                defer(check_qmc(name, QMC_SMALL, MAIN_STEPS, "terminal",
                                family, False))
        defer(check_qmc(name, QMC_SMALL, MAIN_STEPS, "euler", "lattice",
                        False))
        defer(check_qmc(name, QMC_SMALL, MAIN_STEPS, "euler", "lattice",
                        True))
    for name in ("bullet_call", "lookback_call", "cliquet"):
        defer(check_qmc(name, QMC_SMALL, MAIN_STEPS, "euler", "sobol", False))
        defer(check_qmc(name, QMC_SMALL, MAIN_STEPS, "euler", "sobol", True))
    defer(check_qmc("asian_call", QMC_SMALL, MAIN_STEPS - 1, "euler",
                    "lattice", True))  # an odd step count: the clamped half
    for family in ("lattice", "sobol"):  # the streamed bridge's edges
        for n_steps in BRIDGE_STEPS:
            defer(check_qmc("asian_call", QMC_SMALL, n_steps, "euler",
                            family, True))
        for r in QMC_RAGGED:
            defer(check_qmc("asian_call", QMC_SMALL, MAIN_STEPS, "euler",
                            family, True, r))
    for name, method, family, r in QMC_RAGGED_GBM:  # a ragged last group
        defer(check_qmc(name, QMC_SMALL, MAIN_STEPS, method, family, False, r))
    lattice_ready()  # the full-width lattice reads the CBC vector
    for family in ("lattice", "sobol"):
        defer(check_qmc("vanilla_call", QMC_POINTS, MAIN_STEPS, "terminal",
                        family, False))
        defer(check_qmc("asian_call", QMC_POINTS, MAIN_STEPS, "euler",
                        family, False))
        defer(check_qmc("asian_call", QMC_POINTS, MAIN_STEPS, "euler",
                        family, True))
        defer(main_blocks(family))
    return err, nmc_ms


def fx_rainbow_qmc_path(mt, dev, _cuda, path, e2e_nmc):
    """Phase 3 of the slice at full size, ``path`` one of "fx", "rainbow",
    "qmc", the launch counts set to 0 before it and read after it:
    {kernel: launches}.
    fx: every contract at 1M paths within 3 stderr of its closed form
    (tests/test_fx.py's dynamics; the composite struck at 120), and the
    ``fx`` command.
    rainbow: at d = 2 and 1M paths with the antithetic twin, the exchange
    within 3 stderr of Margrabe and the four min/max options of Stulz; the
    demo basket's best-of call at d = 4; the rainbow NMC at NMC_MAIN by
    both strategies (grid == fused bitwise; the fully discounted best-of
    call's EE flat at its Stulz price, 4%), its XVA figures, and the
    ``rainbow`` and ``nmc --model rainbow`` commands (the NMC calls' seconds
    go to ``e2e_nmc``).
    qmc: the terminal call on 2^20 points x 16 shifts of both families
    within 3 stderr + QMC_BIAS of Black-Scholes with a stderr at most 0.2x
    plain MC's on the same budget; the Asian at the full points x 100 by
    Euler and by the bridge on both families (the bridge's stderr below the
    Euler one's, the two within their errors), and the ``qmc`` command."""
    from mc_tpu_torch import oracle, qmc
    from mc_tpu_torch.models import fx

    _cuda.reset_launch_counts()
    o = mt.DEMO_OPTION
    fxd, demo, two = fx_rainbow_qmc_setup(mt)
    sim = mt.SimParams(n_paths=FAMILY_MAIN, n_steps=MAIN_STEPS)
    bs = oracle.bs_call(o.s0, o.k, o.t, o.r, o.sigma, o.q)

    def gate(label, res, ref, n_se=3.0, allow=0.0):
        z = abs(float(res.price) - ref) / float(res.stderr)
        print(f"phase 3: {label}: {float(res.price):.7f} +/- "
              f"{float(res.stderr):.7f} vs {ref:.7f}: {z:.2f} se (limit "
              f"{n_se:g} se + {allow:g})")
        if not (math.isfinite(z) and abs(float(res.price) - ref)
                <= n_se * float(res.stderr) + allow):
            fail(f"{label} misses its closed form")

    if path == "fx":
        x0, sx, rf, rho = fxd.x0, fxd.sigma_x, fxd.r_f, fxd.rho
        for contract in sorted(fx.FX_CONTRACTS):
            opt = mt.OptionParams(k=120.0) if contract.startswith(
                "compo") else o
            kind, side = contract.split("_")
            call = side == "call"
            ref = {"gk": lambda: oracle.gk_call(x0, x0, o.t, o.r, rf, sx,
                                                call),
                   "quanto": lambda: oracle.quanto_call(
                       o.s0, o.k, o.t, o.r, rf, o.sigma, sx, rho, o.q, x0,
                       call),
                   "compo": lambda: oracle.compo_call(
                       o.s0, x0, 120.0, o.t, o.r, o.sigma, sx, rho, o.q,
                       call),
                   "flexo": lambda: oracle.flexo_call(
                       o.s0, x0, o.k, o.t, rf, o.sigma, o.q, call)}[kind]()
            gate(f"price_fx {contract} {FAMILY_MAIN} paths",
                 mt.price_fx(opt, fxd, sim, contract, device=DEVICE), ref)
        c = run_cli(["fx", "--device", DEVICE, "-N", str(FAMILY_MAIN)])
        own = mt.price_fx(o, mt.DEMO_FX, sim, "quanto_call", device=DEVICE)
        print(f"phase 3: python -m mc_tpu_torch fx: {c}")
        if not (c["price"] == float(own.price) and abs(c["z"]) <= 3.0):
            fail("the fx command is off")
        return {k: _cuda.launch_counts[k] for k in FX_KERNELS}

    if path == "rainbow":
        s1, s2 = (float(v) for v in two.s0s)
        sg1, sg2 = (float(v) for v in two.sigmas)
        gate(f"price_rainbow exchange d=2 antithetic {FAMILY_MAIN}",
             mt.price_rainbow(o, two, sim, "exchange", antithetic=True,
                              device=DEVICE),
             oracle.margrabe(s1, s2, o.t, sg1, sg2, 0.5))
        k98 = mt.OptionParams(k=98.0)
        for name, fn in (("call_on_min", oracle.stulz_min_call),
                         ("call_on_max", oracle.stulz_max_call),
                         ("put_on_min", oracle.stulz_min_put),
                         ("put_on_max", oracle.stulz_max_put)):
            gate(f"price_rainbow {name} K=98 d=2 antithetic {FAMILY_MAIN}",
                 mt.price_rainbow(k98, two, sim, name, antithetic=True,
                                  device=DEVICE),
                 fn(s1, s2, 98.0, o.t, o.r, sg1, sg2, 0.5))
        best = mt.price_rainbow(o, demo, sim, device=DEVICE)
        print(f"phase 3: price_rainbow call_on_max d=4 {FAMILY_MAIN}: "
              f"{float(best.price):.6f} +/- {float(best.stderr):.6f} (above "
              f"the single-asset BS {bs:.6f})")
        if not float(best.price) > bs:
            fail("the d = 4 best-of call is not above the single-asset call")
        # the NMC at d = 2 (the demo spots, vols 15% and 30%, rho 0.4):
        # the fully discounted best-of call's EE flat at Stulz's price
        dyn2 = mt.demo_basket(2, 0.4)
        ref = oracle.stulz_max_call(100.0, 100.0, o.k, o.t, o.r, 0.15, 0.3,
                                    0.4)
        n_out, n_steps, n_inner = NMC_MAIN
        nsim = mt.SimParams(n_paths=n_out, n_steps=n_steps,
                            n_paths_inner=n_inner)
        res = {}
        for strategy in ("fused", "grid"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[strategy] = mt.price_nmc_rainbow(o, dyn2, nsim, "call_on_max",
                                                 strategy=strategy,
                                                 device=DEVICE)
            torch.cuda.synchronize()
            e2e_nmc[("rainbow", strategy)] = time.perf_counter() - t0
        fused, grid = res["fused"], res["grid"]
        same = bool(torch.equal(grid.surface, fused.surface))
        ee = grid.exposure_profile()[0].double()
        d_ee = float((ee - ref).abs().max())
        d_mean = abs(float(fused.surface_mean) - ref)
        cva = float(grid.cva(0.02))
        print(f"phase 3: price_nmc_rainbow call_on_max d=2 "
              f"{n_out}x{n_steps}x{n_inner} (fused "
              f"{e2e_nmc[('rainbow', 'fused')]:.2f} s): grid == fused "
              f"{'bitwise' if same else 'NOT bitwise'}; outer "
              f"{float(fused.outer.price):.6f} +/- "
              f"{float(fused.outer.stderr):.6f}; EE flat at Stulz "
              f"{ref:.6f}: max |d| {d_ee:.6f}, surface mean |d| "
              f"{d_mean:.6f} (limit {0.04 * ref:.6f}); cva(0.02) {cva:.7f}")
        if not (same and d_ee < 0.04 * ref and d_mean < 0.04 * ref
                and abs(float(fused.outer.price) - ref)
                <= 4.0 * float(fused.outer.stderr) and cva > 0.0):
            fail("the rainbow NMC breaks grid == fused or its EE is not "
                 "flat at the Stulz price")
        c = run_cli(["rainbow", "--device", DEVICE, "-N", str(FAMILY_MAIN),
                     "--antithetic"])
        n = run_cli(["nmc", "--model", "rainbow", "--strategy", "grid",
                     "--exposure", "--cva-hazard", "0.02", "--payoff",
                     "call_on_max", "--n-paths", str(CLI_NMC_PATHS),
                     "--n-steps", str(n_steps), "--n-inner", str(n_inner),
                     "--n-assets", "2", "--corr", "0.4", "--device", DEVICE])
        own = mt.price_nmc_rainbow(o, dyn2, nsim.replace(
            n_paths=CLI_NMC_PATHS), "call_on_max", strategy="grid",
            device=DEVICE)
        print(f"phase 3: python -m mc_tpu_torch rainbow --antithetic: {c}; "
              f"nmc --model rainbow --n-assets 2: outer "
              f"{n['outer_price']:.6f}, cva {n['cva']:.7f}")
        if not (abs(c["z_score"]) <= 3.0
                and n["outer_price"] == float(own.outer.price)
                and n["cva"] > 0.0):
            fail("the rainbow or nmc --model rainbow command is off")
        return {k: _cuda.launch_counts[k] for k in RAINBOW_KERNELS}

    qsim = mt.SimParams(n_paths=QMC_POINTS, n_steps=MAIN_STEPS)
    for family in ("lattice", "sobol"):
        q = mt.price_qmc(o, qsim, family=family, device=DEVICE)
        n_pts = int(float(q.n_paths)) // QMC_SHIFTS
        plain = mt.price(o, mt.SimParams(n_paths=n_pts * QMC_SHIFTS,
                                         n_steps=MAIN_STEPS),
                         method="terminal", device=DEVICE)
        gate(f"price_qmc call {family} {n_pts} x {QMC_SHIFTS} shifts", q, bs,
             allow=QMC_BIAS)
        ratio = float(q.stderr) / float(plain.stderr)
        print(f"phase 3: price_qmc call {family}: stderr {ratio:.5f}x plain "
              f"MC's on {n_pts * QMC_SHIFTS} paths ({float(plain.stderr):.6f}"
              f"; limit 0.2)")
        if not ratio <= 0.2:
            fail(f"QMC ({family}) does not beat plain MC at the same budget")
        r = {b: mt.price_qmc(o, qsim, "asian_call", family=family, bridge=b,
                             device=DEVICE) for b in (False, True)}
        d = abs(float(r[True].price) - float(r[False].price))
        tol = 5.0 * (float(r[True].stderr) + float(r[False].stderr)) + 1e-3
        print(f"phase 3: price_qmc asian {family} {n_pts}x{MAIN_STEPS}x"
              f"{QMC_SHIFTS}: euler {float(r[False].price):.7f} +/- "
              f"{float(r[False].stderr):.7f}, bridge "
              f"{float(r[True].price):.7f} +/- {float(r[True].stderr):.7f} "
              f"(|d| {d:.2e}, limit {tol:.2e})")
        if not (float(r[True].stderr) < float(r[False].stderr) and d <= tol
                and 0.0 < float(r[True].price) < bs):
            fail(f"the bridge does not cut the Asian's stderr ({family}) or "
                 "the two disagree")
    c = run_cli(["qmc", "--device", DEVICE, "-N", str(QMC_POINTS)])
    print(f"phase 3: python -m mc_tpu_torch qmc: {c}")
    if not (c["lattice_n"] == qmc.prev_prime(QMC_POINTS)
            and abs(c["price"] - bs) <= 3.0 * c["stderr"] + QMC_BIAS):
        fail("the qmc command is off")
    return {k: _cuda.launch_counts[k] for k in QMC_KERNELS}


def entry_resources(log: str, kernel: str) -> dict:
    """{mangled entry: {"registers", "stack", "spill_stores", "spill_loads",
    "smem", "callees"}} of the ptxas log's entries of ``kernel`` (the
    rainbow's, templated on two integers, and #33's, on a leg and a payoff,
    which ptxas_resources does not tell apart).  A frame line belongs to
    the function its "Function properties for" line names: the entry's own,
    or an out-of-line callee's ({name: (stack, spill stores, spill loads)}
    under "callees")."""
    out, entry, fn = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1) if re.match(r"_ZN2mc\d+" + kernel,
                                           m.group(1)) else None
            if entry:
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
            frame = tuple(int(g) for g in m.groups())
            if fn == entry:
                out[entry].update(zip(("stack", "spill_stores",
                                       "spill_loads"), frame))
            elif fn:
                out[entry]["callees"][fn] = frame
        m = re.search(r"Used (\d+) registers", line)
        if m:
            s = re.search(r"(\d+) bytes smem", line)
            out[entry].update(registers=int(m.group(1)),
                              smem=int(s.group(1)) if s else 0)
    return out


# The antithetic pair's end: two payoffs (2 each), their mean (2), its
# square (1).
ANTI_TERMINAL_OPS = (0, 7, 0)


def cev_divs_report(mt, dev, keys, tag) -> None:
    """Phase 5: #18 and #22 at FAMILY_MAIN x 100 (CEV's demo dynamics, the
    dividends' two payments), the call plain and antithetic (CUDA events):
    each one's share of its least work's bound, its paths a thread (the
    library's), ptxas's registers, spills and stack, its resident blocks/SM
    (the library's occupancy; #22 at MAIN_STEPS' table)."""
    from mc_tpu_torch.models import cev as cm
    from mc_tpu_torch.models import dividends as dm
    from mc_tpu_torch.ops import _cuda
    from mc_tpu_torch.ops.payoffs import get_payoff

    lib, call, res = _cuda.load(), get_payoff("vanilla_call"), build_resources()
    sched = two_payments(dm, MAIN_STEPS)
    for family, model, dyn, step, extra in (
            ("cev", cm, cm.DEMO_CEV, CEV_STEP_OPS, (0, 0, 0)),
            ("divs", dm, sched, DIVS_STEP_OPS, _scale(DIVS_PAY_OPS, 2))):
        prm = getattr(model, f"pack_{family}")(mt.DEMO_OPTION, dyn, MAIN_STEPS,
                                               dev)
        cls = cm.CEVConfig if family == "cev" else dm.DivsConfig
        fn = getattr(model, f"{family}_partials")
        for anti in (False, True):
            cfg = cls(n_paths=FAMILY_MAIN, n_steps=MAIN_STEPS, antithetic=anti)
            k_ms, sp, _ = cuda_ms(lambda cfg=cfg: fn(call, cfg, keys[family][0],
                                                     prm))
            legs = 2 if anti else 1
            path = _add(_scale(pair_ops(13), MAIN_STEPS // 2),
                        _scale(_add(_scale(step, MAIN_STEPS), extra), legs),
                        ANTI_TERMINAL_OPS if anti else TERMINAL_OPS)
            b_ms, b_by = bound(4 * prm.numel(), _scale(path, FAMILY_MAIN))
            blocks = ctypes.c_int(0)
            if family == "cev":
                st = lib.mc_cev_occupancy(int(anti), ctypes.byref(blocks))
                r = res.get(("cev_partials_kernel", "VanillaCall",
                             (int(anti),)), {})
            else:
                st = lib.mc_divs_occupancy(int(anti), MAIN_STEPS,
                                           ctypes.byref(blocks))
                r = res.get(("divs_partials_kernel", "VanillaCall",
                             (int(anti), 1)), {})
            _cuda.check(st, f"{family} occupancy")
            paths = (lib.mc_divs_paths_per_thread(int(anti))
                     if family == "divs" else 1)
            print(f"phase 5: {family}_partials call anti={anti} "
                  f"{FAMILY_MAIN}x{MAIN_STEPS}: kernel {k_ms:.4f} ms (spread "
                  f"{sp:.1%}), {b_ms / k_ms:.1%} of its bound ({b_ms:.4f} ms, "
                  f"{b_by}); {paths} paths a thread, registers "
                  f"{r.get('registers')}, spill stores/loads "
                  f"{r.get('spill_stores')}/{r.get('spill_loads')} B, stack "
                  f"{r.get('stack')} B, {blocks.value} blocks/SM"
                  + (f", a table of up to {lib.mc_divs_table_steps()} steps"
                     if family == "divs" else "") + f" {tag}")


def basket_partials_report(mt, dev, key, ptxas: str, tag) -> None:
    """Phase 5: #25 at FAMILY_MAIN x 100 for each of BASKET_TIMED_D (the
    demo basket at that d), antithetic and not (CUDA events): its share of
    the least work's bound, its capacity and paths a thread (the
    library's), ptxas's registers, spills and stack, resident blocks/SM."""
    import ctypes

    from mc_tpu_torch.models import basket as bm
    from mc_tpu_torch.ops import _cuda
    from mc_tpu_torch.ops.payoffs import get_payoff

    lib, call = _cuda.load(), get_payoff("vanilla_call")
    res = entry_resources(ptxas, "basket_partials_kernel")
    for d in BASKET_TIMED_D:
        prm = bm.pack_basket(mt.DEMO_OPTION, bm.demo_basket(d, 0.5),
                             MAIN_STEPS, dev)
        cap = lib.mc_basket_capacity(d)
        for anti in (False, True):
            cfg = bm.BasketConfig(n_paths=FAMILY_MAIN, n_steps=MAIN_STEPS,
                                  d=d, antithetic=anti)
            k_ms, sp, _ = cuda_ms(lambda cfg=cfg, prm=prm: bm.basket_partials(
                call, cfg, key, prm))
            b_ms, b_by = bound(4 * prm.numel(), _scale(
                basket_path(d, MAIN_STEPS, anti), FAMILY_MAIN))
            r = next((v for e, v in res.items() if f"11VanillaCallELi{cap}E"
                      f"Lb{int(anti)}E" in e), {})
            blocks = ctypes.c_int(0)
            _cuda.check(lib.mc_basket_occupancy(call.cuda_id, d, int(anti),
                                                ctypes.byref(blocks)),
                        "basket occupancy")
            print(f"phase 5: basket_partials call d={d} anti={anti} "
                  f"{FAMILY_MAIN}x{MAIN_STEPS}: kernel {k_ms:.4f} ms (spread "
                  f"{sp:.1%}), {b_ms / k_ms:.1%} of its bound ({b_ms:.4f} ms, "
                  f"{b_by}); capacity {cap}, "
                  f"{lib.mc_basket_paths_per_thread(d)} paths a "
                  f"thread, registers {r.get('registers')}, spill "
                  f"stores/loads {r.get('spill_stores')}/"
                  f"{r.get('spill_loads')} B, stack {r.get('stack')} B, "
                  f"{blocks.value} blocks/SM {tag}")


def entry_registers(log: str, kernel: str) -> dict:
    """{mangled entry: registers} of the ptxas log's entries of ``kernel``
    (entry_resources)."""
    return {e: r["registers"] for e, r in entry_resources(log, kernel).items()
            if "registers" in r}


def qmc_launch_report(res: dict, geo, family_id: int, payoff, extra: int,
                      table_bytes: int = 0):
    """Phase 5's resources of a QMC kernel: ptxas's registers, spills and
    static shared bytes (``res``), its dynamic shared bytes (Merton's and
    Bates's Poisson table, the bridge's slab), its resident blocks per SM,
    its shifts a thread (``geo``: qmc.kernel_launch, qmc.bridge_launch)."""
    from mc_tpu_torch import qmc

    blocks = qmc.qmc_occupancy(family_id, payoff, extra)
    callees = "; ".join(
        f"{re.search(r'[0-9](qmc_[a-z_]+)', name).group(1)} stack/spill "
        f"stores/loads {'/'.join(map(str, frame))} B"
        for name, frame in res.get("callees", {}).items())
    return (f"registers {res.get('registers')}, spill stores/loads "
            f"{res.get('spill_stores')}/{res.get('spill_loads')} B (stack "
            f"{res.get('stack')} B; out of line: {callees or 'none'}), "
            f"{blocks} blocks/SM, kShifts {geo.k_shifts} ({geo.groups} shift "
            f"groups), shared {table_bytes} B dynamic + {res.get('smem')} B "
            f"static")


def fx_rainbow_qmc_times(mt, dev, keys, regs, ptxas, tag, time_pair, ref_ms,
                  nmc_ms, e2e_nmc):
    """Phase 5 of the slice: each kernel (CUDA events) at its main shape
    beside its plain version and a kernel of its kind (``ref_ms``: GBM's
    terminal_pair at 1M, the basket's partials and NMC kernels), the
    registers, the e2e calls.  Returns {row: (ms, plain ms)} (the rainbow
    NMC kernels' plain ms is measured in phase 2)."""
    from mc_tpu_torch import qmc
    from mc_tpu_torch.models import basket as bm
    from mc_tpu_torch.models import fx
    from mc_tpu_torch.models import rainbow as rb
    from mc_tpu_torch.nmc_rainbow import RainbowNMC
    from mc_tpu_torch.ops import _cuda
    from mc_tpu_torch.ops.payoffs import get_payoff

    o = mt.DEMO_OPTION
    fxd, demo, _ = fx_rainbow_qmc_setup(mt)
    out = {}
    cfg = fx.FXConfig(FAMILY_MAIN)
    prm = fx.pack_fx(o, fx.DEMO_FX, dev)
    out["fx_partials"] = time_pair(
        "fx_partials quanto_call",
        lambda: fx.fx_partials("quanto_call", cfg, keys["fx"][0], prm),
        lambda: fx.fx_partials_plain("quanto_call", cfg, keys["fx"][0], prm),
        f"{FAMILY_MAIN} paths")
    big = fx.FXConfig(TP_BIG)
    big_ms, big_sp, _ = cuda_ms(lambda: fx.fx_partials(
        "quanto_call", big, keys["fx"][0], prm), reps=3)
    big_bound = probe_bound("fx_partials", contract="quanto_call",
                            n_paths=TP_BIG)[0]
    lib = _cuda.load()
    blocks = ctypes.c_int(0)
    _cuda.check(lib.mc_fx_occupancy(fx.FX_CONTRACTS["quanto_call"],
                                    ctypes.byref(blocks)), "mc_fx_occupancy")
    print(f"phase 5: fx_partials quanto_call {TP_BIG} paths: kernel "
          f"{big_ms:.4f} ms (spread {big_sp:.1%}, 3 reps), "
          f"{big_bound / big_ms:.1%} of its bound ({big_bound:.4f} ms) {tag}")
    print(f"phase 5: fx_partials: "
          f"{out['fx_partials'][0] / ref_ms['terminal_pair']:.2f}x "
          f"terminal_pair on 1M paths ({ref_ms['terminal_pair']:.4f} ms); "
          f"registers {regs.get(('fx_partials_kernel', None, (2, 13)))}, "
          f"{lib.mc_fx_paths_per_thread()} paths a thread, {blocks.value} "
          f"blocks/SM {tag}")
    for d, kw in ((4, {}), (4, dict(antithetic=True)), (32, {})):
        rcfg = rb.RainbowConfig(FAMILY_MAIN, d, **kw)
        rprm = bm.pack_basket(o, bm.demo_basket(d, 0.5), 1, dev)
        label = f"rainbow_partials call_on_max d={d} anti={bool(kw)}"
        if d == 4 and not kw:
            out["rainbow_partials"] = time_pair(
                label,
                lambda: rb.rainbow_partials("call_on_max", rcfg,
                                            keys["rainbow"][0], rprm),
                lambda: rb.rainbow_partials_plain("call_on_max", rcfg,
                                                  keys["rainbow"][0], rprm),
                f"{FAMILY_MAIN} paths")
            continue
        k_ms, sp, _ = cuda_ms(lambda rcfg=rcfg, rprm=rprm: rb.rainbow_partials(
            "call_on_max", rcfg, keys["rainbow"][0], rprm))
        print(f"phase 5: {label} {FAMILY_MAIN} paths: kernel {k_ms:.4f} ms "
              f"(spread {sp:.1%}) {tag}")
    for d in (2, 4, 9, 32):
        for anti in (0, 1):
            blocks = ctypes.c_int(0)
            _cuda.check(lib.mc_rainbow_occupancy(d, anti,
                                                 ctypes.byref(blocks)),
                        "mc_rainbow_occupancy")
            b_ms = probe_bound("rainbow_partials", d=d, n_paths=FAMILY_MAIN,
                               antithetic=bool(anti))[0]
            print(f"phase 5: rainbow_partials d={d} anti={anti}: "
                  f"{lib.mc_rainbow_paths_per_thread(d)} paths a thread, "
                  f"{blocks.value} blocks/SM; bound at {FAMILY_MAIN} paths "
                  f"{b_ms:.5f} ms {tag}")
    print(f"phase 5: rainbow_partials d=4: "
          f"{out['rainbow_partials'][0] / ref_ms['basket_partials']:.4f}x the "
          f"basket's 1M x 100 partials ({ref_ms['basket_partials']:.4f} ms); "
          f"registers {entry_registers(ptxas, 'rainbow_partials_kernel')} "
          f"{tag}")
    call = get_payoff("vanilla_call")
    out.update(family_nmc_times(
        (("rainbow", RainbowNMC(extras=(4, 0)),
          bm.pack_basket(o, demo, MAIN_STEPS, dev), keys["rainbow_nmc"],
          "family_trajectories_rainbow", "RainbowFamily<8>", nmc_ms,
          ("basket", {name: ref_ms[f"{name}_basket"]
                      for name in ("family_fused", "family_inner")})),),
        call, time_pair, regs, tag))
    for label, name, family, method, bridge, plain in (
            ("terminal call lattice", "vanilla_call", "lattice", "terminal",
             False, False),
            ("terminal call sobol", "vanilla_call", "sobol", "terminal",
             False, False),
            ("euler asian lattice", "asian_call", "lattice", "euler", False,
             True),
            ("euler asian sobol", "asian_call", "sobol", "euler", False,
             False),
            ("bridge asian lattice", "asian_call", "lattice", "euler", True,
             True),
            ("bridge asian sobol", "asian_call", "sobol", "euler", True,
             False)):
        po, qcfg, ps, qprm = qmc_case(mt, dev, name, QMC_POINTS, MAIN_STEPS,
                                      method, family, bridge, QMC_SHIFTS)
        row = "qmc_bridge_sums" if bridge else "qmc_sums"
        shape = f"{ps.n}x{MAIN_STEPS if method == 'euler' else 1}x{QMC_SHIFTS}"
        kernel_fn = (lambda po=po, qcfg=qcfg, ps=ps, qprm=qprm, bridge=bridge:
                     qmc.qmc_sums(po, qcfg, ps, qprm, bridge))
        if plain:
            out[row] = time_pair(
                f"{row} {label}", kernel_fn,
                lambda po=po, qcfg=qcfg, ps=ps, qprm=qprm, bridge=bridge:
                qmc.qmc_sums_plain(po, qcfg, ps, qprm, bridge), shape)
            k_ms = out[row][0]
        else:
            k_ms, sp, _ = cuda_ms(kernel_fn)
            print(f"phase 5: {row} {label} {shape}: kernel {k_ms:.4f} ms "
                  f"(spread {sp:.1%}) {tag}")
        steps = ps.n * QMC_SHIFTS * (MAIN_STEPS if method == "euler" else 1)
        kern = "qmc_bridge_kernel" if bridge else "qmc_kernel"
        b_ms = bound(0, _scale(qmc_path(
            family, MAIN_STEPS if method == "euler" else 0, bridge, name,
            QMC_SHIFTS), ps.n))[0]
        struct = type(po).__name__
        res = next((r for e, r in entry_resources(ptxas, kern).items()
                    if f"{len(struct)}{struct}E" in e), {})
        if bridge:
            slots = qmc.bridge_stream(MAIN_STEPS).n_slots
            geo = qmc.bridge_launch(ps, MAIN_STEPS)
            launch = (qmc_launch_report(res, geo, -2, po, slots,
                                        slots * geo.k_shifts * geo.threads * 4)
                      + f", {slots} live slots")
        else:
            launch = qmc_launch_report(res, qmc.kernel_launch(ps), -1, po, 0)
        print(f"phase 5: {row} {label}: {steps / k_ms * 1e3:.4e} "
              f"path-steps/s, {b_ms / k_ms:.1%} of its bound ({b_ms:.3f} ms);"
              f" {launch} {tag}")
    qsim = mt.SimParams(n_paths=QMC_POINTS, n_steps=MAIN_STEPS)
    e2e_report((
        (f"price_fx() quanto_call {FAMILY_MAIN}", "paths/s", FAMILY_MAIN,
         lambda: mt.price_fx(o, fx.DEMO_FX, mt.SimParams(n_paths=FAMILY_MAIN),
                             device=DEVICE)),
        (f"price_rainbow() call_on_max d=4 {FAMILY_MAIN}", "paths/s",
         FAMILY_MAIN, lambda: mt.price_rainbow(
             o, demo, mt.SimParams(n_paths=FAMILY_MAIN), device=DEVICE)),
        *((label.replace("()", "() call_on_max d=2"), unit, work, secs)
          for label, unit, work, secs in nmc_e2e_rows("rainbow", e2e_nmc)),
        *((f"price_qmc() {label} {QMC_POINTS // 1024}Ki x {QMC_SHIFTS}",
           "path-steps/s", QMC_POINTS * QMC_SHIFTS * steps,
           lambda kw=kw: mt.price_qmc(o, qsim, device=DEVICE, **kw))
          for label, steps, kw in (
              ("terminal call lattice", 1, {}),
              ("terminal call sobol", 1, dict(family="sobol")),
              ("asian euler lattice", MAIN_STEPS, dict(payoff="asian_call")),
              ("asian euler sobol", MAIN_STEPS,
               dict(payoff="asian_call", family="sobol")),
              ("asian bridge lattice", MAIN_STEPS,
               dict(payoff="asian_call", bridge=True)),
              ("asian bridge sobol", MAIN_STEPS,
               dict(payoff="asian_call", family="sobol", bridge=True))))),
        tag)
    return out


def fx_rainbow_qmc_bounds():
    """bound() of the slice's rows at the shapes the kernels line reports:
    #28 quanto_call at 1M (44 bytes of parameters), #27 call_on_max d = 4 at
    1M, the rainbow's trajectories at NMC_MAIN's outer 16,384 x 100 and its
    family kernels at NMC_MAIN (the basket's substep), #32 the Euler Asian
    and #31 the bridge's on the lattice at 1,048,573 x 100 x 16."""
    from mc_tpu_torch.models.basket import packed_length

    n_out, n_steps, _ = NMC_MAIN
    path4, _ = family_traj_path("rainbow", MAIN_STEPS, 4)
    n_qmc = 1_048_573
    return {
        "fx_partials": bound(44, _scale(fx_path_ops("quanto_call"),
                                        FAMILY_MAIN)),
        "rainbow_partials": bound(4 * packed_length(4),
                                  _scale(rainbow_path(4), FAMILY_MAIN)),
        "family_trajectories_rainbow": bound(5 * 4 * n_out * n_steps,
                                             _scale(path4, n_out)),
        **family_bounds("rainbow", _add(_scale(pair_ops(13), 2),
                                        basket_step_ops(4)), path4, 4),
        "qmc_sums": bound(0, _scale(qmc_path("lattice", MAIN_STEPS, False,
                                             "asian_call", QMC_SHIFTS),
                                    n_qmc)),
        "qmc_bridge_sums": bound(0, _scale(qmc_path("lattice", MAIN_STEPS,
                                                    True, "asian_call",
                                                    QMC_SHIFTS), n_qmc)),
    }


def family_traj_path(family: str, n_steps: int, d=None, kmax: int = 0):
    """(the outer path's operations, market grids) of the family
    trajectories kernel under ``family`` at n_steps (the call; the
    demo dynamics, Merton's and Bates's Poisson depth ``kmax``, the
    basket's and the rainbow's d): each family's one count of a path,
    which the kernels line's rows (jump_bounds, single_families'
    paths, fx_rainbow_qmc_bounds) read at MAIN_STEPS and probe_bound
    at the probe's shapes."""
    if family == "merton":
        from mc_tpu_torch.models.merton import DEMO_MERTON

        return merton_path(n_steps, 13, kmax, DEMO_MERTON.lam / n_steps), 1
    if family == "bates":
        return _add(_scale(bates_step(13, kmax), n_steps), TERMINAL_OPS), 2
    if family in ("basket", "rainbow"):
        return basket_path(d, n_steps), d
    if family == "heston":  # S at each step
        return _add(_scale(_add(pair_ops(13), HESTON_EULER_OPS), n_steps),
                    TERMINAL_OPS), 2
    return {"cev": (half_pair_path(CEV_STEP_OPS, n_steps), 1),
            "localvol": (half_pair_path(lv_step_ops(9), n_steps), 1),
            "sabr": (_add(_scale(_add(pair_ops(13), SABR_UNIT_STEP_OPS),
                                 n_steps), SPOT_OPS, TERMINAL_OPS), 2),
            "term": (half_pair_path(STEP_OPS, n_steps), 1),
            "vasicek": (vasicek_path(n_steps), 3)}[family]


def ladder_bound(payoff: str, euler: bool, n_paths: int, n_steps: int,
                 n_strikes: int):
    """bound() of a ladder call: each path simulated once (the terminal
    draw, or the log-Euler leg with its payoff), then the payoff at each
    further strike; the parameters and strikes read once, a row of M x 2
    f64 a block of 256 paths written."""
    from mc_tpu_torch.ops import _cuda

    if euler:
        path = _add(path_ops(payoff, n_steps, 13),
                    _scale(TERMINAL_OPS, n_strikes - 1))
    else:
        path = _add(pair_ops(13), TERMINAL_DRAW_OPS,
                    _scale(TERMINAL_OPS, n_strikes))
    return bound(60 + 4 * n_strikes
                 + 16 * n_strikes * _cuda.cdiv(n_paths, 256),
                 _scale(path, n_paths))


def probe_bound(row: str, **kw):
    """bound() of a call that family_nmc_probe.py times at a shape of its
    own: fx_partials (contract, n_paths), greek_partials (payoff, method,
    n_paths, n_steps), rainbow_partials (d, n_paths, antithetic: False by
    default; every payoff counted as call_on_max) and basket_trajectories
    (payoff, d, n_paths, n_steps: the level and state grids written) and
    family_trajectories (family, n_paths, n_steps, d, kmax: the market and
    state grids written, family_traj_path's work) and ladder (payoff, euler,
    n_paths, n_steps, n_strikes: ladder_bound)."""
    from mc_tpu_torch.models.basket import packed_length

    n = kw["n_paths"]
    if row == "ladder":
        return ladder_bound(kw["payoff"], kw["euler"], n, kw["n_steps"],
                            kw["n_strikes"])
    if row == "fx_partials":
        return bound(44, _scale(fx_path_ops(kw["contract"]), n))
    if row == "greek_partials":
        return bound(0, _scale(greek_path_ops(kw["payoff"], kw["method"],
                                              kw["n_steps"]), n))
    if row == "family_trajectories":
        path, n_grids = family_traj_path(kw["family"], kw["n_steps"],
                                         kw.get("d"), kw.get("kmax", 0))
        return bound((n_grids + 1) * 4 * n * kw["n_steps"], _scale(path, n))
    d = kw["d"]
    if row == "rainbow_partials":
        return bound(4 * packed_length(d), _scale(
            rainbow_path(d, kw.get("antithetic", False)), n))
    if row == "basket_trajectories":
        steps = kw["n_steps"]
        path = _add(basket_path(d, steps),
                    _scale(UPDATE_OPS.get(kw["payoff"], (0, 0, 0)), steps))
        return bound(4 * packed_length(d) + 2 * 4 * n * steps,
                     _scale(path, n))
    raise KeyError(row)


# --- the model half of QMC: kernel #33 --------------------------------------

QMC_MODEL_FAMILIES = ("heston", "bates", "basket", "cev", "sabr", "localvol",
                      "vasicek", "merton", "term")
QMC_MODEL_ROWS = tuple(f"qmc_model_sums_{m}" for m in QMC_MODEL_FAMILIES)
QMC_MODEL_D = (1, 9, 32)   # phase 2: the basket's d-edges (32: capacity 32)
QMC_MODEL_RTOL = 2e-16     # phase 2: #33's sums, bitwise or f64 rounding
QMC_MODEL_JOINT_SE = 3.5   # phase 3: against the family's own kernel
# phase 3: QMC's stderr over plain MC's at the same budget, where mc_tpu's
# tests gate it (tests/test_qmc.py:246-272)
QMC_MODEL_SE_RATIO = {"heston": 0.55, "basket": 0.4}


def qmc_model_case(mt, dev, model, name, family, n_paths, n_shifts, dyn=None):
    """(payoff, point set, params, extra) of price_qmc_model's call at
    n_paths x MAIN_STEPS on n_shifts shifts."""
    from mc_tpu_torch import qmc

    opt = payoff_option(mt, name)
    sim = mt.SimParams(n_paths=n_paths, n_steps=MAIN_STEPS)
    po, d32, extra, ps = qmc.qmc_model_pointset(
        model, opt, dyn, sim, name, n_shifts=n_shifts, family=family,
        device=dev)
    return po, ps, qmc.QMC_MODELS[model].pack(opt, d32, MAIN_STEPS,
                                               dev), extra


def qmc_model_checks(mt, dev):
    """Phase 2 of the model half of QMC: #33 against its plain version on
    the card at QMC_SMALL points x 100 steps x 2 shifts (4,096 Sobol points,
    4,099 on the lattice): the call and the Asian under every family on both
    point families, every payoff Heston and the basket (d = 4) accept, the
    basket at d = 1, 9 and 32, every family at QMC_RAGGED shifts (a ragged
    last shift group); and at the main shape (the call on 2^20 Sobol points
    x 100 x 16 shifts under every family, CEV on the lattice too), the rows
    of the first and the last block under every shift against the plain
    version over those blocks' points, and the first and the last shift's
    rows against a launch of that shift alone, bitwise; the sums bitwise or within QMC_MODEL_RTOL.  Each
    check is deferred (its plain half runs
    now; the lattice's CBC vector is ready, fx_rainbow_qmc_checks waited
    for it).  Returns ({row: max abs error of a shift mean}, {family: the
    plain version's ms on the call, Sobol, host clock}), filled by the
    kernel pass."""
    from mc_tpu_torch import qmc
    from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
    from mc_tpu_torch.ops.payoffs import PAYOFFS
    from mc_tpu_torch.ops.reduce import finish_sum

    err = dict.fromkeys(QMC_MODEL_ROWS, 0.0)
    plain_ms = {}

    def check(model, name, family, dyn=None, label="",
              n_shifts=QMC_CHECK_SHIFTS):
        po, ps, prm, extra = qmc_model_case(mt, dev, model, name, family,
                                            QMC_SMALL, n_shifts, dyn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = finish_sum(qmc.qmc_model_sums_plain(model, po, ps, prm,
                                                   MAIN_STEPS, extra))
        torch.cuda.synchronize()
        if (name, family, dyn, n_shifts) == ("vanilla_call", "sobol", None,
                                             QMC_CHECK_SHIFTS):
            plain_ms[model] = (time.perf_counter() - t0) * 1e3
        yield
        got = finish_sum(qmc.qmc_model_sums(model, po, ps, prm, MAIN_STEPS,
                                            extra))
        row = f"qmc_model_sums_{model}"
        check_sums(f"{row} {name} {family}{label} {ps.n}x{MAIN_STEPS} "
                   f"d={ps.d} {ps.n_shifts} shifts", got, want,
                   QMC_MODEL_RTOL)
        err[row] = max(err[row], float((got - want).abs().max()) / ps.n)

    def main_blocks(model, family):
        """At the main shape: the first and the last block's rows against
        the plain version over their points, and each shift's rows
        against a launch of that shift alone, bitwise."""
        po, ps, prm, extra = qmc_model_case(mt, dev, model, "vanilla_call",
                                            family, QMC_POINTS, QMC_SHIFTS)
        plan = qmc_block_plan(ps)
        want = qmc_model_block_plain(model, po, ps, prm, extra,
                                     qmc_block_ids(plan, ps.n, dev))
        yield
        geo = qmc.kernel_launch(ps, model, extra)
        partials = qmc.qmc_model_sums(model, po, ps, prm, MAIN_STEPS, extra)
        row = f"qmc_model_sums_{model}"
        label = (f"{row} vanilla_call {family} {ps.n}x{MAIN_STEPS} d={ps.d} "
                 f"{ps.n_shifts} shifts")
        check_block_plan(label, geo, plan)
        if partials.shape[0] != geo.n_bx:
            fail(f"{label}: {partials.shape[0]} blocks, kernel_launch's "
                 f"{geo.n_bx}")
        for b, w in want.items():
            got = partials[b]
            check_sums(f"{label}, block {b} of {geo.n_bx}", got, w,
                       QMC_MODEL_RTOL)
            err[row] = max(err[row], float((got - w).abs().max()) / ps.n)
        qmc_shift_identity(label, partials, lambda r: qmc.qmc_model_sums(
            model, po, ps.shifted(ps.shifts[r:r + 1]), prm, MAIN_STEPS,
            extra), ps.n_shifts)

    for model in QMC_MODEL_FAMILIES:
        for family in ("sobol", "lattice"):
            for name in ("vanilla_call", "asian_call"):
                defer(check(model, name, family))
        for n_shifts, name in zip(QMC_RAGGED, ("vanilla_call", "asian_call")):
            defer(check(model, name, "sobol", label=" ragged",
                        n_shifts=n_shifts))
        for family in ("sobol", "lattice") if model == "cev" else ("sobol",):
            defer(main_blocks(model, family))
    for name in sorted(PAYOFFS):
        if name in ("vanilla_call", "asian_call"):
            continue
        if name not in SIGMA_PAYOFFS:
            defer(check("heston", name, "sobol"))
        defer(check("basket", name, "sobol"))
    for d in QMC_MODEL_D:
        defer(check("basket", "vanilla_call", "sobol", mt.demo_basket(d, 0.5),
                    f" d={d}"))
    return err, plain_ms


def qmc_model_path(mt, dev, _cuda, e2e):
    """Phase 3 of the model half of QMC at full width: every family's call
    on QMC_POINTS Sobol points x 100 steps x 16 shifts (the demo dynamics;
    local vol flat, the basket at d = 1 and 4), each family's block driven
    with the launch counts set to 0 before it and read after it: {row:
    launches}.  Where the scheme is exact in law the price is held to its
    oracle within 3 stderr + QMC_BIAS (term at the averaged parameters,
    local vol flat at 0.2, Vasicek's call and bond, the basket at d = 1,
    Merton's series); elsewhere to the family's own price_<family> kernel
    on the same scheme and step count within QMC_MODEL_JOINT_SE joint
    stderr (Heston and Bates with their CF prices beside, CEV, SABR, the
    basket at d = 4), Euler's bias at 100 steps being larger than the QMC
    stderr.  Beside each, the stderr against plain MC's at the same budget
    (gated at QMC_MODEL_SE_RATIO).  The lattice at the main shape under CEV
    (the 100-dimension CBC vector built beside nvcc); ``qmc --model
    heston|bates --family sobol`` at the full points.  ``e2e[model]``: the
    (label, seconds) of each family's last Sobol call (host clock, ended by
    a synchronize)."""
    from mc_tpu_torch import oracle, qmc
    from mc_tpu_torch.models.bates import bates_call_cf
    from mc_tpu_torch.models.heston import heston_call_cf
    from mc_tpu_torch.models.localvol import LocalVolSurface
    from mc_tpu_torch.models.merton import merton_call_closed_form

    o = mt.DEMO_OPTION
    sim = mt.SimParams(n_paths=QMC_POINTS, n_steps=MAIN_STEPS)
    mc_sim = mt.SimParams(n_paths=QMC_POINTS * QMC_SHIFTS,
                          n_steps=MAIN_STEPS)
    bs = oracle.bs_call(o.s0, o.k, o.t, o.r, o.sigma, o.q)
    one = mt.BasketDynamics(*(np.array(v, np.float32) for v in (
        [o.s0], [0.2], [1.0], [[1.0]])))
    flat = LocalVolSurface.flat(0.2, MAIN_STEPS)
    term, _ = qmc.qmc_model_dynamics("term", None, MAIN_STEPS)
    rs, sg = (np.asarray(a, np.float64) for a in (term.rates, term.sigmas))
    vd, md, hd, bd = mt.DEMO_VASICEK, mt.DEMO_MERTON, mt.DEMO_HESTON, \
        mt.DEMO_BATES
    a, b, sr, rho = vd.astuple()
    # (model, label, dyn, payoff, exact oracle or None, plain MC at the
    # same budget and the same scheme)
    cases = (
        ("term", "demo curves", term, "vanilla_call",
         oracle.bs_call(o.s0, o.k, o.t, float(rs.mean()),
                        float(np.sqrt((sg * sg).mean())), o.q),
         lambda: mt.price_term(o, term, mc_sim, device=DEVICE)),
        ("localvol", "flat 0.2", flat, "vanilla_call",
         oracle.bs_call(o.s0, o.k, o.t, o.r, 0.2, o.q),
         lambda: mt.price_localvol(o, flat, mc_sim, device=DEVICE)),
        ("vasicek", "demo", None, "vanilla_call",
         mt.bsv_call(o.s0, o.k, o.t, o.r, o.sigma, a, b, sr, rho, o.q),
         lambda: mt.price_vasicek(o, vd, mc_sim, device=DEVICE)),
        ("vasicek", "demo", None, "zcb", mt.vasicek_zcb(o.r, a, b, sr, o.t),
         lambda: mt.price_vasicek(o, vd, mc_sim, "zcb", device=DEVICE)),
        ("basket", "d=1", one, "vanilla_call", bs,
         lambda: mt.price_basket(o, one, mc_sim, device=DEVICE)),
        ("merton", "demo", None, "vanilla_call",
         merton_call_closed_form(o.s0, o.k, o.t, o.r, o.sigma, md.lam,
                                 md.mu_j, md.sigma_j, o.q),
         lambda: mt.price_merton(o, md, mc_sim, device=DEVICE)),
        ("heston", "demo Euler", None, "vanilla_call", None,
         lambda: mt.price_heston(o, hd, mc_sim, device=DEVICE)),
        ("bates", "demo Euler", None, "vanilla_call", None,
         lambda: mt.price_bates(o, bd, mc_sim, device=DEVICE)),
        ("cev", "demo", None, "vanilla_call", None,
         lambda: mt.price_cev(o, mt.DEMO_CEV, mc_sim, device=DEVICE)),
        ("sabr", "demo", None, "vanilla_call", None,
         lambda: mt.price_sabr(o, mt.DEMO_SABR, mc_sim, device=DEVICE)),
        ("basket", "demo d=4", None, "vanilla_call", None,
         lambda: mt.price_basket(o, mt.DEMO_BASKET, mc_sim, device=DEVICE)))
    cf = {"heston": heston_call_cf(o.s0, o.k, o.t, o.r, *hd.astuple(),
                                   q=o.q),
          "bates": bates_call_cf(o.s0, o.k, o.t, o.r, *bd.astuple(), q=o.q)}
    launches = {}
    for model in QMC_MODEL_FAMILIES:
        _cuda.reset_launch_counts()
        for cm, label, dyn, payoff, exact, mc_fn in cases:
            if cm != model:
                continue
            families = ("sobol", "lattice") if model == "cev" else ("sobol",)
            mc = mc_fn()
            for family in families:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                q = mt.price_qmc_model(model, o, dyn, sim, payoff,
                                       family=family, device=DEVICE)
                torch.cuda.synchronize()
                if (payoff, family) == ("vanilla_call", "sobol"):  # the last
                    e2e[model] = (label, time.perf_counter() - t0)
                n_pts = int(float(q.n_paths)) // QMC_SHIFTS
                ratio = float(q.stderr) / float(mc.stderr)
                text = (f"phase 3: price_qmc_model {model} {label} {payoff} "
                        f"{family} {n_pts}x{MAIN_STEPS}x{QMC_SHIFTS}: "
                        f"{float(q.price):.7f} +/- {float(q.stderr):.3e}")
                if exact is not None:
                    d = abs(float(q.price) - exact)
                    tol = 3.0 * float(q.stderr) + QMC_BIAS
                    text += (f" vs its oracle {exact:.7f}: |d| {d:.3e} "
                             f"(limit 3 se + {QMC_BIAS:g} = {tol:.3e})")
                else:
                    d = abs(float(q.price) - float(mc.price))
                    tol = QMC_MODEL_JOINT_SE * math.hypot(float(q.stderr),
                                                          float(mc.stderr))
                    text += (f" vs price_{model} {float(mc.price):.7f} +/- "
                             f"{float(mc.stderr):.3e} on {mc_sim.n_paths}x"
                             f"{MAIN_STEPS}: |d| {d:.3e} (limit "
                             f"{QMC_MODEL_JOINT_SE:g} joint se = {tol:.3e})")
                    if model in cf:
                        text += f"; CF price {cf[model]:.7f}"
                limit = QMC_MODEL_SE_RATIO.get(model) if exact is None else None
                text += (f"; stderr {ratio:.5f}x plain MC's at the same "
                         f"budget" + (f" (limit {limit:g})" if limit else ""))
                print(text)
                if not (math.isfinite(d) and d <= tol):
                    fail(f"price_qmc_model {model} {label} {payoff} "
                         f"({family}) misses its reference")
                if limit and not ratio < limit:
                    fail(f"price_qmc_model {model}: QMC does not cut the "
                         "stderr against plain MC at the same budget")
        if model in cf:  # the command, at the full points on Sobol
            c = run_cli(["qmc", "--model", model, "--family", "sobol", "-N",
                         str(QMC_POINTS), "--n-steps", str(MAIN_STEPS),
                         "--device", DEVICE])
            own = mt.price_qmc_model(model, o, None, sim, device=DEVICE)
            print(f"phase 3: python -m mc_tpu_torch qmc --model {model} "
                  f"--family sobol -N {QMC_POINTS}: {c}")
            if not (c["price"] == float(own.price) and c["point_n"]
                    == QMC_POINTS and c["cf_oracle"] == cf[model]):
                fail(f"the qmc --model {model} command is off")
        launches[f"qmc_model_sums_{model}"] = _cuda.launch_counts[
            "qmc_model_sums"]
    return launches


def qmc_model_point_ops(model: str, family: str, n_steps: int, kmax: int,
                        n_shifts: int, d_assets: int = 4):
    """#33's operations for one point of ``model`` under the call and
    n_shifts shifts (qmc_point_ops): each coordinate's base once, and per
    shift its normals (the shift part and the inverse CDF) and raw units
    (the shift part), its steps (Merton's and Bates's jump counts against the
    block's cdf table, table_ops) and the payoff."""
    _, coord = QMC_COORD_OPS[family]
    normal = _add(coord, INV_CDF_OPS)
    step, normals, units = {
        "heston": (HESTON_EULER_OPS, 2, 0),
        "bates": (_add(HESTON_EULER_OPS, BATES_JUMP_OPS, table_ops(kmax)),
                  3, 1),
        "basket": (basket_step_ops(d_assets), 2 * ((d_assets + 1) // 2), 0),
        "cev": (CEV_STEP_OPS, 1, 0),
        "sabr": (SABR_STEP_OPS, 2, 0),
        "localvol": (lv_step_ops(9), 1, 0),
        "vasicek": (VASICEK_STEP_OPS, 3, 0),
        "merton": (_add(MERTON_STEP_OPS, table_ops(kmax)), 2, 1),
        "term": (STEP_OPS, 1, 0)}[model]
    per_step = _add(_scale(normal, normals), _scale(coord, units), step)
    extra = VASICEK_DISCOUNT_OPS if model == "vasicek" else (0, 0, 0)
    return qmc_point_ops(family, n_shifts, (normals + units) * n_steps,
                         _add(_scale(per_step, n_steps), TERMINAL_OPS, extra))


def qmc_model_bounds():
    """bound() of #33 per family: the call on 2^20 Sobol points x 100 steps
    x 16 shifts (a few kB of tables and parameters: operations bound)."""
    k_dt, _ = jump_kmax()
    return {f"qmc_model_sums_{m}": bound(0, _scale(qmc_model_point_ops(
        m, "sobol", MAIN_STEPS, k_dt, QMC_SHIFTS), QMC_POINTS))
        for m in QMC_MODEL_FAMILIES}


def qmc_model_times(mt, dev, ptxas, tag, plain_ms, e2e):
    """Phase 5 of #33: each family's kernel (CUDA events, 3 reps) at the
    phase-3 shape (the demo call on 2^20 Sobol points x 100 x 16; CEV on the
    lattice too) beside the #32 Sobol Euler Asian of the same points, its
    registers (``ptxas``: {source: its ptxas log}), and price_qmc_model()'s
    e2e time (its phase-3 call).  Returns {row: (ms, plain ms at the
    phase-2 shape)}."""
    from mc_tpu_torch import qmc

    out = {}
    for model in QMC_MODEL_FAMILIES:
        for family in ("sobol", "lattice") if model == "cev" else ("sobol",):
            po, ps, prm, extra = qmc_model_case(mt, dev, model,
                                                "vanilla_call", family,
                                                QMC_POINTS, QMC_SHIFTS)
            k_ms, sp, _ = cuda_ms(
                lambda: qmc.qmc_model_sums(model, po, ps, prm, MAIN_STEPS,
                                           extra), reps=3)
            res = next((r for e, r in entry_resources(
                ptxas.get(f"qmc_{model}_kernels.cu", ""),
                "qmc_model_kernel").items() if "VanillaCall" in e), {})
            k_dt, _ = jump_kmax()
            b_ms = bound(0, _scale(qmc_model_point_ops(
                model, family, MAIN_STEPS, k_dt, QMC_SHIFTS), ps.n))[0]
            geo = qmc.kernel_launch(ps, model, extra)
            launch = qmc_launch_report(
                res, geo, qmc.QMC_MODELS[model].family_id, po, extra,
                4 * extra if model in ("merton", "bates") else 0)
            steps = ps.n * QMC_SHIFTS * MAIN_STEPS
            print(f"phase 5: qmc_model_sums {model} call {family} "
                  f"{ps.n}x{MAIN_STEPS}x{QMC_SHIFTS} d={ps.d}: kernel "
                  f"{k_ms:.3f} ms (spread {sp:.1%}, 3 reps), "
                  f"{steps / k_ms * 1e3:.4e} path-steps/s, "
                  f"{k_ms / ps.d:.4f} ms a dimension, {b_ms / k_ms:.1%} of "
                  f"its bound ({b_ms:.3f} ms); {launch}; plain "
                  f"{plain_ms[model]:.1f} ms at {QMC_SMALL}x"
                  f"{MAIN_STEPS}x{QMC_CHECK_SHIFTS} (phase 2) {tag}")
            if family == "sobol":
                out[f"qmc_model_sums_{model}"] = (k_ms, plain_ms[model])
    e2e_report(tuple(
        (f"price_qmc_model() {model} ({e2e[model][0]}) call sobol "
         f"{QMC_POINTS // 1024}Ki x {MAIN_STEPS} x {QMC_SHIFTS}",
         "path-steps/s", QMC_POINTS * QMC_SHIFTS * MAIN_STEPS, e2e[model][1])
        for model in QMC_MODEL_FAMILIES), tag)
    return out


# --- the rates slice: kernel #11 (the European swaptions) -------------------

RATES_TILES = ("va", "hw", "hw_mc", "g2", "g2_mc")
RATES_ROWS = tuple(f"rates_partials_{t}" for t in RATES_TILES)
RATES_PATHS = 1 << 20          # mc_tpu's default n_paths for every price_*
RATES_BIG = 1 << 24            # phase 5: the kernel at 2^24 paths too
RATES_N_PAY = (1, 10, 60)      # 60: a 30-year semiannual swap
RATES_OVERHANG = 100_001       # a part-full last block
# phase 2: (paths, path_offset, bound): ids past 2^20, the bound short of
# the end
RATES_OFFSET = (500_000, 1_234_567, 1_234_567 + 499_000)
# phase 2: past the staging cap (csrc/rates_kernels.cu kRatesStagePayments,
# checked against the library's): the tables read in place
RATES_CAP = 512
RATES_PAST_CAP = RATES_CAP + 1
RATES_RTOL = 2e-16             # phase 2: bitwise, or one f64 rounding
RATES_SE = 4.0                 # phase 3: tests/test_rates_fused.py:42,59,103
RATES_SPREAD = 0.0025          # the multi-curve tiles' projection spread
# A bond (rates.cuh): ratio * expf(-B x - c) or expf(logA - B r) and the
# fixed leg's add (3 f32, an expf); the draw's x and y (G2++: and z), the
# swap, its sign, the max and the discount (~10 f32 and an expf).
RATES_BOND_OPS = (0, 3, 1)
RATES_PATH_OPS = (0, 10, 1)


def rates_demo(mt, tile: str, n_pay: int, payer: bool):
    """(spec, pricer kwargs) of ``tile`` on the demo dynamics and curve, the
    multi-curve tiles at a RATES_SPREAD projection spread."""
    spec = mt.SwaptionSpec(n_payments=n_pay, payer=payer)
    kw = {}
    if tile.endswith("_mc"):
        kw["projection_curve"] = mt.DiscountCurve(
            mt.DEMO_CURVE.times, mt.DEMO_CURVE.zeros + RATES_SPREAD)
    return spec, kw


@functools.lru_cache(maxsize=None)
def rates_tables(mt, model: str, n_pay: int, payer: bool):
    """The host tables of ``model`` ("hw" or "g2") on the demo curve, built
    once for both of its tiles (their cost grows as n_pay^2)."""
    from mc_tpu_torch.models import g2pp, hullwhite

    spec = mt.SwaptionSpec(n_payments=n_pay, payer=payer)
    if model == "hw":
        return hullwhite.hw_tables(spec, mt.DEMO_HW, mt.DEMO_CURVE)
    return g2pp.g2_tables(spec, mt.DEMO_G2, mt.DEMO_CURVE)


def rates_pack(mt, dev, tile: str, n_pay: int, payer: bool):
    """(pv on dev, key) that price_<model>() hands #11 for ``tile``."""
    from mc_tpu_torch import rng
    from mc_tpu_torch.models import g2pp, hullwhite, swaption

    spec, kw = rates_demo(mt, tile, n_pay, payer)
    proj = kw.get("projection_curve")
    if tile == "va":
        d = mt.DEMO_VASICEK.as_f32()
        pv = swaption.pack_va_swpt(spec, d.a, d.b, d.sigma_r, 0.05, dev)
        tag = swaption.SWAPTION_TAG
    elif tile.startswith("hw"):
        hw, curve = mt.DEMO_HW, mt.DEMO_CURVE
        pv = hullwhite.pack_hw_swpt(hw.a, hw.sigma_r, spec,
                                    *rates_tables(mt, "hw", n_pay, payer),
                                    dev)
        if proj is not None:
            pv = hullwhite.pack_multicurve(pv, *hullwhite.hw_mc_weights(
                spec, curve, proj))
        tag = hullwhite.HW_TAG
    else:
        g2, curve = mt.DEMO_G2, mt.DEMO_CURVE
        pv = g2pp.pack_g2_swpt(spec, g2, rates_tables(mt, "g2", n_pay, payer),
                               dev)
        if proj is not None:
            pv = hullwhite.pack_multicurve(pv, *hullwhite.hw_mc_weights(
                spec, curve, proj))
        tag = g2pp.G2_TAG
    return pv, tuple(int(k) for k in rng.derive_key(1234, 0, tag))


def rates_checks(mt, dev):
    """Phase 2 of the rates slice: #11 against its plain version on the card
    for all five tiles, payer and receiver, at n_payments 1, 10 and 60, on
    RATES_PATHS paths, RATES_OVERHANG paths and RATES_OFFSET (a nonzero
    path_offset, the bound short of the end); and, payer, at RATES_PAST_CAP
    payments on RATES_OVERHANG paths (the tables read in place; the
    library's cap checked to be RATES_CAP) and at 10 on RATES_BIG paths (the
    grid strides): the rows bitwise (the plain version adds in the kernel's
    order), the sums within RATES_RTOL.  Each check is deferred (its plain
    half runs now).  Returns ({row: max abs error of a price}, {tile: the
    plain version's ms at RATES_PATHS, n = 10, payer, host clock}), filled
    by the kernel pass."""
    from mc_tpu_torch.ops import fused
    from mc_tpu_torch.ops.reduce import finish_sum

    err = dict.fromkeys(RATES_ROWS, 0.0)
    plain_ms = {}

    def check(tile, n_pay, payer, n_paths, offset=0, bound=None):
        pv, key = rates_pack(mt, dev, tile, n_pay, payer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fused.fused_moment_partials_plain(tile, n_pay, key, pv,
                                                 n_paths, offset, bound)
        torch.cuda.synchronize()
        if (n_pay, payer, n_paths, offset) == (10, True, RATES_PATHS, 0):
            plain_ms[tile] = (time.perf_counter() - t0) * 1e3
        yield
        if n_pay == RATES_PAST_CAP:
            from mc_tpu_torch.ops import _cuda

            cap = _cuda.load().mc_rates_stage_payments()
            if cap != RATES_CAP:
                fail(f"the rates kernel stages up to {cap} payments; "
                     f"RATES_PAST_CAP assumes {RATES_CAP}")
        got = fused.fused_moment_partials(tile, n_pay, key, pv, n_paths,
                                          offset, bound)
        row = f"rates_partials_{tile}"
        rows_same = got.shape == want.shape and share(got == want)
        check_sums(f"{row} {'payer' if payer else 'receiver'} n={n_pay} "
                   f"{n_paths} paths offset {offset} bound {bound} (rows "
                   f"{rows_same:.4f} bitwise)", finish_sum(got),
                   finish_sum(want), RATES_RTOL)
        err[row] = max(err[row], float(
            (finish_sum(got) - finish_sum(want)).abs().max()) / n_paths)

    for tile in RATES_TILES:
        for payer in (True, False):
            for n_pay in RATES_N_PAY:
                for shape in ((RATES_PATHS,), (RATES_OVERHANG,),
                              RATES_OFFSET):
                    defer(check(tile, n_pay, payer, *shape))
        defer(check(tile, RATES_PAST_CAP, True, RATES_OVERHANG))
        defer(check(tile, 10, True, RATES_BIG))
    return err, plain_ms


def rates_path(mt, dev, _cuda, e2e):
    """Phase 3 of the rates slice at full width: every pricer at mc_tpu's
    default RATES_PATHS on the demo specs, payer and receiver, within
    RATES_SE stderr of its oracle: Vasicek against Jamshidian, Hull-White
    on the demo curve and on one bootstrapped from par swaps, Hull-White
    multi-curve at a 25 bp projection spread, G2++ and G2++ multi-curve;
    ``swaption``, ``hullwhite --proj-spread-bp 25`` and ``g2pp`` against
    the library call with the command's arguments, bit for bit.  The counts
    set to 0 before and read after: {row: launches}, each equal to the
    price_* calls of its tile.  ``e2e[label]``: a pricer (payer) for phase
    5."""
    from mc_tpu_torch import oracle

    _cuda.reset_launch_counts()
    sim = mt.SimParams(n_paths=RATES_PATHS, n_steps=1)
    curve = mt.DEMO_CURVE
    tenor = mt.DEMO_SWAPTION.tenor
    mats = [0.5, 1.0, 2.0, 3.0, 5.0, 10.0]

    def par_rate(t_m):
        dfs = [curve.df(tenor * j) for j in range(1, round(t_m / tenor) + 1)]
        return (1.0 - dfs[-1]) / (tenor * sum(dfs))

    boot = mt.DiscountCurve.from_par_swaps(mats, [par_rate(m) for m in mats],
                                           tenor=tenor)
    # the projection curve as the hullwhite command builds it
    proj = mt.DiscountCurve(curve.times, [z + 25 * 1e-4 for z in curve.zeros])
    va, hw, g2 = mt.DEMO_VASICEK, mt.DEMO_HW, mt.DEMO_G2
    g2a = (g2.a, g2.sigma, g2.b_mr, g2.eta, g2.rho)
    calls = dict.fromkeys(RATES_TILES, 0)

    def args(spec):
        return (spec.expiry, spec.tenor, spec.n_payments, spec.k_rate,
                spec.payer)

    # (label, tile, pricer of a spec, oracle of a spec)
    cases = (
        ("price_swaption() Vasicek", "va",
         lambda s: mt.price_swaption(s, va, sim, device=DEVICE),
         lambda s: oracle.vasicek_swaption(0.05, va.a, va.b, va.sigma_r,
                                           *args(s))),
        ("price_hw_swaption() demo curve", "hw",
         lambda s: mt.price_hw_swaption(s, hw, curve, sim, device=DEVICE),
         lambda s: oracle.hw_swaption(hw.a, hw.sigma_r, curve.df, *args(s))),
        ("price_hw_swaption() par-swap curve", "hw",
         lambda s: mt.price_hw_swaption(s, hw, boot, sim, device=DEVICE),
         lambda s: oracle.hw_swaption(hw.a, hw.sigma_r, boot.df, *args(s))),
        ("price_hw_swaption() multi-curve +25bp", "hw_mc",
         lambda s: mt.price_hw_swaption(s, hw, curve, sim,
                                        projection_curve=proj, device=DEVICE),
         lambda s: oracle.hw_swaption_multicurve(hw.a, hw.sigma_r, curve.df,
                                                 proj.df, *args(s))),
        ("price_g2_swaption() demo curve", "g2",
         lambda s: mt.price_g2_swaption(s, g2, curve, sim, device=DEVICE),
         lambda s: oracle.g2_swaption(*g2a, curve.df, *args(s))),
        ("price_g2_swaption() multi-curve +25bp", "g2_mc",
         lambda s: mt.price_g2_swaption(s, g2, curve, sim,
                                        projection_curve=proj, device=DEVICE),
         lambda s: oracle.g2_swaption_multicurve(*g2a, curve.df, proj.df,
                                                 *args(s))))
    for label, tile, price, ref in cases:
        for payer in (True, False):
            spec = mt.SwaptionSpec(payer=payer)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = price(spec)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            calls[tile] += 1
            want = ref(spec)
            p, se = float(res.price), float(res.stderr)
            d = abs(p - want)
            print(f"phase 3: {label} {'payer' if payer else 'receiver'} "
                  f"{RATES_PATHS} paths: {p:.8f} +/- {se:.3e} vs its oracle "
                  f"{want:.8f}: |d| {d:.3e} = {d / se:.2f} se (limit "
                  f"{RATES_SE:g}); {secs * 1e3:.2f} ms")
            if not (math.isfinite(p) and se > 0 and d <= RATES_SE * se):
                fail(f"{label} misses its oracle")
            if payer:
                e2e[label] = lambda price=price, spec=spec: price(spec)
    n = str(RATES_PATHS)
    for argv, tile, own in (
            (["swaption", "-N", n], "va",
             lambda: mt.price_swaption(sim=mt.SimParams(n_paths=RATES_PATHS),
                                       r0=0.1, device=DEVICE)),
            (["hullwhite", "-N", n, "--proj-spread-bp", "25"], "hw_mc",
             lambda: mt.price_hw_swaption(
                 mt.SwaptionSpec(k_rate=0.04), sim=mt.SimParams(
                     n_paths=RATES_PATHS), projection_curve=proj,
                 device=DEVICE)),
            (["g2pp", "-N", n], "g2",
             lambda: mt.price_g2_swaption(
                 mt.SwaptionSpec(k_rate=0.04),
                 sim=mt.SimParams(n_paths=RATES_PATHS), device=DEVICE))):
        c = run_cli(argv + ["--device", DEVICE])
        lib = own()
        calls[tile] += 2
        print(f"phase 3: python -m mc_tpu_torch {' '.join(argv)}: {c}; the "
              f"library call {float(lib.price)!r}")
        if not (c["price"] == float(lib.price) and abs(c["z_score"])
                <= RATES_SE):
            fail(f"the {argv[0]} command is off")
    launches = {f"rates_partials_{t}": _cuda.launch_counts[
        f"rates_partials_{t}"] for t in RATES_TILES}
    if launches != {f"rates_partials_{t}": n for t, n in calls.items()}:
        fail(f"#11 launched {launches} times over {calls} price_* calls")
    return launches


def rates_bounds():
    """bound() of #11 per tile at RATES_PATHS, 10 payments (a few hundred
    bytes of pack and 16 bytes a block: operations bound): the pair, the
    bonds, the path's own work and two f64 adds; G2++ its third normal."""
    out = {}
    for tile in RATES_TILES:
        ops = _add(pair_ops(13), _scale(RATES_BOND_OPS, 10), RATES_PATH_OPS)
        if tile.startswith("g2"):
            ops = _add(ops, unit_ops(13, 1), INV_CDF_OPS)
        out[f"rates_partials_{tile}"] = bound(0, _scale(ops, RATES_PATHS),
                                              2 * RATES_PATHS)
    return out


def rates_times(mt, dev, ptxas, tag, plain_ms, e2e):
    """Phase 5 of #11: each tile (CUDA events) at RATES_PATHS and RATES_BIG
    paths with 10 payments and at RATES_PATHS with 60, its registers
    (``ptxas``: rates_kernels.cu's log), the plain version's phase-2 time,
    and each pricer end to end (e2e_report).  Returns {row: (ms at
    RATES_PATHS, n = 10; plain ms)}."""
    from mc_tpu_torch.ops import fused

    regs = entry_registers(ptxas, "rates_partials_kernel")
    out = {}
    for tile in RATES_TILES:
        times = {}
        for n_paths, n_pay in ((RATES_PATHS, 10), (RATES_BIG, 10),
                               (RATES_PATHS, 60)):
            pv, key = rates_pack(mt, dev, tile, n_pay, True)
            k_ms, sp, _ = cuda_ms(lambda: fused.fused_moment_partials(
                tile, n_pay, key, pv, n_paths), reps=3)
            times[(n_paths, n_pay)] = k_ms
            print(f"phase 5: rates_partials {tile} {n_paths} paths n={n_pay}:"
                  f" kernel {k_ms:.4f} ms (spread {sp:.1%}, 3 reps), "
                  f"{n_paths / k_ms * 1e3:.4e} paths/s {tag}")
        b_ms, _ = rates_bounds()[f"rates_partials_{tile}"]
        print(f"phase 5: rates_partials {tile}: {RATES_PATHS} paths n=10 "
              f"{times[(RATES_PATHS, 10)]:.4f} ms against its bound "
              f"{b_ms:.4f} ms ({b_ms / times[(RATES_PATHS, 10)]:.1%}), "
              f"2^24 paths {times[(RATES_BIG, 10)] / times[(RATES_PATHS, 10)]:.2f}x"
              f" the 2^20 time, n=60 {times[(RATES_PATHS, 60)] / times[(RATES_PATHS, 10)]:.2f}x"
              f" n=10; plain {plain_ms[tile]:.2f} ms (phase 2, host clock) "
              f"{tag}")
        out[f"rates_partials_{tile}"] = (times[(RATES_PATHS, 10)],
                                         plain_ms[tile])
    print(f"phase 5: rates_partials registers {regs} {tag}")
    from mc_tpu_torch.ops import _cuda

    lib = _cuda.load()
    occ = {}
    for tile in RATES_TILES:
        for n_pay in (10, RATES_PAST_CAP):
            blocks = ctypes.c_int(0)
            _cuda.check(lib.mc_rates_occupancy(
                fused.TILES[tile].cuda_id, n_pay, ctypes.byref(blocks)),
                "mc_rates_occupancy")
            occ[f"{tile} n={n_pay}"] = blocks.value
    print(f"phase 5: rates_partials {lib.mc_rates_paths_per_thread()} paths a "
          f"thread, tables staged up to {lib.mc_rates_stage_payments()} "
          f"payments; blocks/SM {occ} {tag}")
    e2e_report(tuple((f"{label} payer {RATES_PATHS} paths", "paths/s",
                      RATES_PATHS, fn) for label, fn in e2e.items()), tag)
    return out


# --- the composed entry points: model table, family/CVA greeks, books ------

GREEK_FD_PATHS = 1 << 20              # phase 3: the FD family greeks (x 100)
GREEK_SE_SEEDS = 8                    # delta's stderr: 8 replicas of 2^17
MULTI_GREEK_PATHS = 1 << 20           # rainbow (d = 4, 2), basket (d = 4)
BASKET_D1_PATHS = 1 << 18             # basket d = 1 against GBM's greeks()
# cva_greeks at nmc --model's shape.  At 16 steps paths cross Heston's
# variance truncation within a bump of v0, and the CRN difference's bias
# falls with h (3.06e-2 off the tangent at h = 5e-4, as mc_tpu's own
# differences sit: tests/test_torch_cva_greeks.py, the 16-step case), so
# v0 is held to the differences at h = 2e-5 and 1e-5 (the bumps'
# denominators the f32-rounded v0 +/- h), the larger h's printed beside.
CVA_SHAPE = NMC_SMALL
CVA_V0_SHOWN = (5e-4, 1e-4)
# the CLI's nmc --cva-greeks leg checks its wiring (keys, finite values) at
# a cut depth: the same greeks at CVA_SHAPE are held in cva_greeks' check
CLI_CVA_SHAPE = (2048, 8, 16)
BOOK_SHAPE = NMC_MAIN                 # price_nmc_book B = 1 == price_nmc
COMPOSED_KERNELS = {
    # kernel row (its launch-count key) -> the call of the block it serves
    "heston_partials": "chunked_price(model='heston'), heston_greeks",
    "vasicek_partials": "chunked_price(model='vasicek'), vasicek_greeks",
    "merton_partials": "merton_greeks", "sabr_partials": "sabr_greeks",
    "rainbow_partials": "rainbow_greeks", "basket_partials": "basket_greeks",
    "nmc_fused": "cva_greeks()", "family_fused": "cva_greeks(model='heston')",
    "trajectories": "price_nmc_book()", "nmc_inner": "price_nmc_book()",
    "heston_trajectories": "price_nmc_book(model='heston')",
    "family_inner": "price_nmc_book(model='heston')"}


def composed_path(mt, dev, _cuda, tag, e2e):
    """Phase 3, the entry points that compose ported kernels (the model
    table's chunked_price(model=...), the family and multi-asset greeks,
    cva_greeks, price_nmc_book and their CLI legs), the counts set to 0
    before it; returns its launches by kernel row (the family kernels it
    launches run under Heston, whose rows the kernels line leaves
    unsuffixed).  ``e2e``: (label, unit, work, seconds)
    of each call, one timed call each (host clock, ended by a
    synchronize)."""
    import importlib

    from mc_tpu_torch import oracle, rng
    from mc_tpu_torch.checkpoint import load_checkpoint
    from mc_tpu_torch.models.basket import BasketDynamics

    tg = importlib.import_module("mc_tpu_torch.greeks")
    _cuda.reset_launch_counts()
    option = mt.DEMO_OPTION
    sections, t_sec = [], [time.perf_counter()]

    def section(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        sections.append(f"{name} {now - t_sec[0]:.2f} s")
        t_sec[0] = now

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # chunked_price(model=...): Heston (its steps take no pairs) and
    # Vasicek (discounted pathwise), 4 x 2^20 x 100 in 2^20-path chunks,
    # stopped after chunk 2 and resumed; each against price_<family>.
    csim = mt.SimParams(n_paths=N_CHUNKS * CHUNK_PATHS, n_steps=MAIN_STEPS)
    for model, dyn, price_fn in (("heston", mt.DEMO_HESTON, mt.price_heston),
                                 ("vasicek", mt.DEMO_VASICEK,
                                  mt.price_vasicek)):
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "run.npz")
            full, secs = timed(lambda: mt.chunked_price(
                option, csim, chunk_paths=CHUNK_PATHS, model=model,
                device=DEVICE))
            mt.chunked_price(option, csim.replace(n_paths=2 * CHUNK_PATHS),
                             chunk_paths=CHUNK_PATHS, model=model,
                             checkpoint_path=ck, device=DEVICE)
            mid = load_checkpoint(ck)
            mid.n_paths = csim.n_paths
            mid.save(ck)
            resumed = mt.chunked_price(option, csim, chunk_paths=CHUNK_PATHS,
                                       model=model, checkpoint_path=ck,
                                       resume=True, device=DEVICE)
        straight = price_fn(option, dyn, csim, device=DEVICE)
        bitwise = (float(resumed.price) == float(full.price)
                   and float(resumed.stderr) == float(full.stderr))
        d = max(abs(float(full.price) / float(straight.price) - 1.0),
                abs(float(full.stderr) / float(straight.stderr) - 1.0))
        e2e.append((f"chunked_price(model='{model}') {N_CHUNKS}x"
                    f"{CHUNK_PATHS}x{MAIN_STEPS}", "path-steps/s",
                    csim.n_paths * MAIN_STEPS, secs))
        print(f"phase 3: chunked_price(model='{model}') {N_CHUNKS}x"
              f"{CHUNK_PATHS}x{MAIN_STEPS}: {float(full.price):.9f} +/- "
              f"{float(full.stderr):.9f}; resumed after chunk 2: "
              f"{'bitwise' if bitwise else 'NOT bitwise'}; price_{model} "
              f"{float(straight.price):.9f} (rel {d:.2e}); {secs:.3f} s")
        if not (bitwise and d <= SUMS_RTOL):
            fail(f"chunked_price(model={model!r}) is not resumed bitwise or "
                 f"differs from price_{model}")

    section("chunked_price(model=...)")

    # The FD family greeks at 2^20 x 100 (antithetic, as mc_tpu's cases):
    # each greek bitwise (up - dn) / (2h) of two direct price_<family>
    # calls; delta within 4 stderr (GREEK_SE_SEEDS replicas) of the
    # oracle's central difference, plus its discretization allowance.
    gsim = mt.SimParams(n_paths=GREEK_FD_PATHS, n_steps=MAIN_STEPS)
    base_opt = dict(s0=option.s0, k=option.k, t=option.t)
    families = (
        ("merton", tg.MERTON_GREEK_FIELDS, mt.DEMO_MERTON, 0x3E44,
         lambda o, d, sim, key: mt.price_merton(
             o, d, sim, method="euler", antithetic=True, key=key,
             device=DEVICE),
         lambda **kw: mt.merton_call_closed_form(
             r=option.r, sigma=option.sigma, **mt.DEMO_MERTON.__dict__, **kw),
         0.0),
        ("sabr", tg.SABR_GREEK_FIELDS, mt.DEMO_SABR, 0x5AB4,
         lambda o, d, sim, key: mt.price_sabr(
             o, d, sim, antithetic=True, key=key, device=DEVICE), None, 0.0),
        ("heston", tg.HESTON_GREEK_FIELDS, mt.DEMO_HESTON, 0x4E57,
         lambda o, d, sim, key: mt.price_heston(
             o, d, sim, antithetic=True, key=key, device=DEVICE),
         lambda **kw: mt.heston_call_cf(r=option.r, **mt.DEMO_HESTON.__dict__,
                                        **kw),
         0.003),  # full-truncation Euler at 100 steps: 0.3% of delta
        ("vasicek", tg.VASICEK_GREEK_FIELDS, mt.DEMO_VASICEK, 0x7A51,
         lambda o, d, sim, key: mt.price_vasicek(
             o, d, sim, antithetic=True, key=key, device=DEVICE),
         lambda **kw: oracle.bsv_call(r0=option.r, sigma_s=option.sigma,
                                      **mt.DEMO_VASICEK.__dict__, **kw),
         0.0))
    for family, fields, dyn, ftag, price_fn, oracle_fn, allow in families:
        greek_fn = getattr(tg, f"{family}_greeks")
        g, secs = timed(lambda: greek_fn(sim=gsim, antithetic=True,
                                         device=DEVICE))
        e2e.append((f"{family}_greeks() {GREEK_FD_PATHS}x{MAIN_STEPS} "
                    f"{'/'.join(g)}", "paths/s", gsim.n_paths, secs))
        key = tuple(int(k) for k in rng.derive_key(gsim.seed, 0, ftag))
        d32 = dyn.as_f32()
        for name in g:
            tree, fld, sgn = fields[name]
            obj = option if tree == "option" else d32
            x = np.float32(getattr(obj, fld))
            h = np.float32(1e-3) * np.maximum(np.abs(x), np.float32(1e-2))

            def bumped(v):
                if tree == "option":
                    return dataclasses.replace(option, **{fld: float(v)}), d32
                return option, dataclasses.replace(d32, **{fld: float(v)})

            up, dn = (price_fn(*bumped(v), gsim, key).price
                      for v in (x + h, x - h))
            want = sgn * (up - dn) / (2.0 * float(h))
            if float(g[name]) != float(want):
                fail(f"{family}_greeks {name} is not its two prices' "
                     f"difference: {float(g[name])!r} != {float(want)!r}")
        text = (f"phase 3: {family}_greeks {GREEK_FD_PATHS}x{MAIN_STEPS}: "
                + ", ".join(f"{k} {float(v):.6f}" for k, v in g.items())
                + f" (each bitwise its two prices); {secs:.3f} s")
        if oracle_fn is not None:
            reps = [float(greek_fn(sim=gsim.replace(
                n_paths=GREEK_FD_PATHS // GREEK_SE_SEEDS, seed=seed),
                which=("delta",), antithetic=True, device=DEVICE)["delta"])
                for seed in range(GREEK_SE_SEEDS)]
            se = statistics.stdev(reps) / math.sqrt(GREEK_SE_SEEDS)
            s0 = option.s0
            ref = (oracle_fn(s0=s0 + 0.1, **{k: v for k, v in base_opt.items()
                                             if k != "s0"})
                   - oracle_fn(s0=s0 - 0.1, **{k: v for k, v in
                                               base_opt.items()
                                               if k != "s0"})) / 0.2
            err = abs(float(g["delta"]) - ref)
            text += (f"; delta vs the oracle's {ref:.6f}: {err:.2e} = "
                     f"{err / se:.2f} se (se {se:.2e} from {GREEK_SE_SEEDS} "
                     f"replicas) + allowance {allow * ref:.2e}")
            if not err <= 4.0 * se + allow * ref:
                print(text)
                fail(f"{family}_greeks delta is off its oracle")
        print(text)

    section("the FD greeks")

    # rainbow_greeks at d = 4 and d = 2 (2^20 paths): the value through the
    # greeks' path is price_rainbow's bitwise; at d = 2 delta and cega
    # against central differences of Stulz's call on the max.
    rsim = mt.SimParams(n_paths=MULTI_GREEK_PATHS, n_steps=1)
    d2 = BasketDynamics(s0s=np.array([100.0, 100.0], np.float32),
                        sigmas=np.array([0.25, 0.2], np.float32),
                        weights=np.array([0.5, 0.5], np.float32),
                        corr=np.array([[1.0, 0.4], [0.4, 1.0]], np.float32))
    for label, dyn in (("d=4", mt.demo_basket(4, 0.5)), ("d=2", d2)):
        g, secs = timed(lambda: tg.rainbow_greeks(option, dyn, rsim,
                                                  device=DEVICE))
        e2e.append((f"rainbow_greeks() call_on_max {label} "
                    f"{MULTI_GREEK_PATHS}", "paths/s", rsim.n_paths, secs))
        live = dataclasses.replace(dyn, s0s=torch.tensor(dyn.s0s,
                                                         requires_grad=True))
        v_live = mt.price_rainbow(option, live, rsim, device=DEVICE).price
        v = mt.price_rainbow(option, dyn, rsim, device=DEVICE).price
        c = g["cega"].cpu()
        ok = (float(v_live.detach()) == float(v)
              and bool(torch.isfinite(g["delta"]).all())
              and bool(torch.isfinite(g["vega"]).all())
              and torch.equal(c, c.T) and not bool(torch.diag(c).any()))
        text = (f"phase 3: rainbow_greeks call_on_max {label} "
                f"{MULTI_GREEK_PATHS}: delta {g['delta'].tolist()}, vega "
                f"{g['vega'].tolist()}, cega[0,1] {float(c[0, 1]):.6f}; "
                f"value with grad {'==' if ok else '!='} price_rainbow; "
                f"{secs:.3f} s")
        if label == "d=2":
            fn = lambda s1, s2, rho=0.4: oracle.stulz_max_call(
                s1, s2, 100.0, 1.0, 0.1, 0.25, 0.2, rho)
            ref_d = [(fn(100.01, 100.0) - fn(99.99, 100.0)) / 0.02,
                     (fn(100.0, 100.01) - fn(100.0, 99.99)) / 0.02]
            ref_c = (fn(100.0, 100.0, 0.401) - fn(100.0, 100.0, 0.399)) / 2e-3
            d_err = max(abs(float(g["delta"][i]) - ref_d[i])
                        for i in range(2))
            c_err = abs(float(c[0, 1]) - ref_c)
            text += (f"; vs Stulz: delta {d_err:.2e} (gate 5e-3), cega "
                     f"{c_err:.2e} (gate 0.12)")
            ok = ok and d_err < 5e-3 and c_err < 0.12
        print(text)
        if not ok:
            fail(f"rainbow_greeks {label} is off")

    section("rainbow_greeks")

    # basket_greeks at d = 4, 2^20 x 100; at d = 1, weight 1, GBM's
    # pathwise greeks() within 4 joint stderr.
    bsim = mt.SimParams(n_paths=MULTI_GREEK_PATHS, n_steps=MAIN_STEPS)
    b4 = mt.demo_basket(4, 0.5)
    g, secs = timed(lambda: tg.basket_greeks(option, b4, bsim,
                                             device=DEVICE))
    e2e.append((f"basket_greeks() vanilla_call d=4 {MULTI_GREEK_PATHS}x"
                f"{MAIN_STEPS}", "paths/s", bsim.n_paths, secs))
    live = dataclasses.replace(b4, s0s=torch.tensor(b4.s0s,
                                                    requires_grad=True))
    same = (float(mt.price_basket(option, live, bsim,
                                  device=DEVICE).price.detach())
            == float(mt.price_basket(option, b4, bsim, device=DEVICE).price))
    c = g["cega"].cpu()
    b1 = BasketDynamics(s0s=np.array([100.0], np.float32),
                        sigmas=np.array([0.2], np.float32),
                        weights=np.array([1.0], np.float32),
                        corr=np.array([[1.0]], np.float32))
    s1 = mt.SimParams(n_paths=BASKET_D1_PATHS, n_steps=MAIN_STEPS)
    g1 = tg.basket_greeks(option, b1, s1, which=("delta", "vega"),
                          device=DEVICE)
    pw = mt.greeks(option, s1, "vanilla_call", which=("delta", "vega"),
                   device=DEVICE)
    z = {k: abs(float(g1[k][0]) - float(pw[k]))
         / (math.sqrt(2.0) * float(pw[f"{k}_stderr"])) for k in g1}
    ok = (same and torch.equal(c, c.T) and not bool(torch.diag(c).any())
          and all(bool(torch.isfinite(v).all()) for v in g.values())
          and max(z.values()) <= 4.0)
    print(f"phase 3: basket_greeks vanilla_call d=4 {MULTI_GREEK_PATHS}x"
          f"{MAIN_STEPS}: delta {g['delta'].tolist()}, vega "
          f"{g['vega'].tolist()}, cega[0,1] {float(c[0, 1]):.6f}; value with "
          f"grad {'==' if same else '!='} price_basket; {secs:.3f} s; d=1 "
          f"{BASKET_D1_PATHS}x{MAIN_STEPS} vs greeks() pathwise: "
          + ", ".join(f"{k} {float(g1[k][0]):.6f} vs {float(pw[k]):.6f} "
                      f"({z[k]:.2f} joint se)" for k in z))
    if not ok:
        fail("basket_greeks is off")

    section("basket_greeks")

    # cva_greeks, GBM and Heston, at CVA_SHAPE: forward mode against CRN
    # central differences of the kernel NMC's CVA on the same keys
    # (tests/test_xva.py's bumps and tolerances; v0's bumps CVA_SHAPE's).
    cases = (("gbm", None, (("delta", "s0", (0.05,), 1e-3, "option"),
                            ("vega", "sigma", (1e-3,), 2e-3, "option"))),
             ("heston", "heston", (("delta", "s0", (0.05,), 2e-3, "option"),
                                   ("v0", "v0", (2e-5, 1e-5), 1e-2,
                                    "dyn"))))
    n_out, n_steps, n_inner = CVA_SHAPE
    for label, model, greeks in cases:
        vsim = mt.SimParams(n_paths=n_out, n_steps=n_steps,
                            n_paths_inner=n_inner)
        g, secs = timed(lambda: tg.cva_greeks(
            option, vsim, "vanilla_call", hazard_rate=0.02,
            which=tuple(x[0] for x in greeks), model=model, device=DEVICE))
        e2e.append((f"cva_greeks({'' if model is None else 'heston'}) "
                    f"{n_out}x{n_steps}x{n_inner} {'/'.join(g)}", "calls/s",
                    1, secs))

        def cva_at(opt, dyn=mt.DEMO_HESTON):
            res = (mt.price_nmc(opt, vsim, "vanilla_call", strategy="fused",
                                device=DEVICE) if model is None else
                   mt.price_nmc_heston(opt, dyn, vsim, "vanilla_call",
                                       strategy="fused", device=DEVICE))
            return float(res.cva(0.02, t_horizon=1.0))

        def crn_fd(fld, tree, h):
            base = option if tree == "option" else mt.DEMO_HESTON
            x = getattr(base, fld)
            up, dn = (float(np.float32(x + h)), float(np.float32(x - h)))
            at = ((lambda v: cva_at(dataclasses.replace(option, **{fld: v})))
                  if tree == "option" else
                  (lambda v: cva_at(option, dataclasses.replace(
                      base, **{fld: v}))))
            return (at(up) - at(dn)) / (up - dn)

        parts, ok = [], True
        for name, fld, hs, rel, tree in greeks:
            tangent = float(g[name])
            ok = ok and tangent > 0.0
            for h in hs + (CVA_V0_SHOWN if name == "v0" else ()):
                fd = crn_fd(fld, tree, h)
                r = abs(tangent / fd - 1.0)
                ok = ok and (r <= rel or h not in hs)
                parts.append(f"{name} {tangent:.7f} vs CRN-FD {fd:.7f} at h "
                             f"{h:g} (rel {r:.2e}, " + (
                                 f"gate {rel:g})" if h in hs
                                 else "not gated)"))
        print(f"phase 3: cva_greeks {label} {n_out}x{n_steps}x{n_inner}: "
              + ", ".join(parts) + f"; {secs:.3f} s")
        if not ok:
            fail(f"cva_greeks {label} is off its CRN central differences")

    section("cva_greeks")

    # price_nmc_book, GBM and Heston: B = 1 at the main NMC shape is the
    # grid price_nmc bitwise on every point; at the small shape a long
    # against the same short nets to zero and the netted EE is at most
    # the standalone EEs' sum.
    n_out, n_steps, n_inner = BOOK_SHAPE
    msim = mt.SimParams(n_paths=n_out, n_steps=n_steps, n_paths_inner=n_inner)
    n_out_s, n_steps_s, n_inner_s = NMC_SMALL
    ssim = mt.SimParams(n_paths=n_out_s, n_steps=n_steps_s,
                        n_paths_inner=n_inner_s)
    for model, payoff, ref_fn in (
            ("gbm", "bullet_call", lambda: mt.price_nmc(
                option, msim, "bullet_call", strategy="grid",
                device=DEVICE)),
            ("heston", "vanilla_call", lambda: mt.price_nmc_heston(
                option, mt.DEMO_HESTON, msim, "vanilla_call",
                strategy="grid", device=DEVICE))):
        one, secs = timed(lambda: mt.price_nmc_book(
            mt.OptionParams(k=np.array([option.k], np.float32)), msim,
            payoff, model=model, device=DEVICE))
        e2e.append((f"price_nmc_book(model='{model}') B=1 {n_out}x{n_steps}"
                    f"x{n_inner}", "inner path-steps/s",
                    n_out * n_inner * n_steps * (n_steps - 1) // 2, secs))
        ref = ref_fn()
        b1_ok = (torch.equal(one.net_surface, ref.surface)
                 and float(one.outers.price[0]) == float(ref.outer.price))
        ls = mt.price_nmc_book(mt.OptionParams(k=np.array([100.0, 100.0],
                                                          np.float32)),
                               ssim, payoff, [1.0, -1.0], model=model,
                               device=DEVICE)
        zero = (not bool(ls.net_surface.any())
                and float(ls.net_outer_price) == 0.0)
        book = mt.price_nmc_book(
            mt.OptionParams(k=np.array([90.0, 100.0, 110.0], np.float32)),
            ssim, payoff, [1.0, -2.0, 1.0], model=model, device=DEVICE)
        ee_net, _ = book.exposure_profile()
        gap = float((ee_net - book.ee_contract.sum(dim=0)).max())
        print(f"phase 3: price_nmc_book({model!r}) {payoff} B=1 {n_out}x"
              f"{n_steps}x{n_inner}: {'bitwise' if b1_ok else 'NOT bitwise'}"
              f" the grid NMC ({secs:.3f} s); long/short {n_out_s}x"
              f"{n_steps_s}x{n_inner_s}: {'zero' if zero else 'NOT zero'}; "
              f"3-contract netted EE - sum of standalone EEs: max {gap:.3e}")
        if not (b1_ok and zero and gap <= 1e-5 * float(ee_net.max())):
            fail(f"price_nmc_book({model!r}) is off")

    section("price_nmc_book")

    # The CLI legs, in this process.
    from mc_tpu_torch import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["info", "--device", DEVICE])
    info = out.getvalue()
    small = ["--n-paths", str(NMC_SMALL[0]), "--n-steps", str(NMC_SMALL[1]),
             "--n-inner", str(NMC_SMALL[2]), "--payoff", "vanilla_call",
             "--device", DEVICE]
    rb = run_cli(["rainbow", "--greeks", "--n-paths", str(MULTI_GREEK_PATHS),
                  "--device", DEVICE])
    h_out, h_steps, h_inner = CLI_CVA_SHAPE
    cg = run_cli(["nmc", "--model", "heston", "--cva-hazard", "0.02",
                  "--cva-greeks", "delta,v0,dyn.rho", "--n-paths", str(h_out),
                  "--n-steps", str(h_steps), "--n-inner", str(h_inner),
                  "--payoff", "vanilla_call", "--device", DEVICE])
    bk = run_cli(["nmc", "--book-strikes", "90,100,110", "--book-weights",
                  "1,-2,1", "--cva-hazard", "0.02"] + small)
    ok = (rc == 0 and torch.cuda.get_device_name(0) in info
          and len(rb["delta"]) == 2 and math.isfinite(rb["cega_01"])
          and set(cg["cva_greeks"]) == {"delta", "v0", "dyn.rho"}
          and all(math.isfinite(v) for v in cg["cva_greeks"].values())
          and len(bk["netted_ee"]) == NMC_SMALL[1]
          and all(a <= b + 1e-5 for a, b in zip(bk["netted_ee"],
                                                 bk["sum_of_standalone_ee"]))
          and bk["netted_cva"] > 0.0)
    print(f"phase 3: python -m mc_tpu_torch info: "
          f"{info.strip().splitlines()[-1]}; rainbow --greeks: delta "
          f"{rb['delta']}, cega_01 {rb['cega_01']:.6f}; nmc --model heston "
          f"--cva-greeks delta,v0,dyn.rho: {cg['cva_greeks']}; nmc "
          f"--book-strikes 90,100,110: netted cva {bk['netted_cva']:.6f}")
    if not ok:
        fail("the info, rainbow --greeks, nmc --cva-greeks or nmc "
             "--book-strikes command is off")

    section("the CLI")
    print("phase 3: the composed block by section, its checks included: "
          + ", ".join(sections))
    counts = dict(_cuda.launch_counts)
    missing = [k for k in COMPOSED_KERNELS if not counts.get(k)]
    if missing:
        fail(f"the composed entry points never launched {missing}")
    return {k: counts[k] for k in COMPOSED_KERNELS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing run", file=sys.stderr)
        return 2

    import mc_tpu_torch as mt
    from mc_tpu_torch import engines, oracle, rng
    from mc_tpu_torch.checkpoint import load_checkpoint
    from mc_tpu_torch.ops import _cuda
    from mc_tpu_torch.ops import nmc_kernels as nk
    from mc_tpu_torch.ops import path_kernels as pk
    from mc_tpu_torch.ops import reduce
    from mc_tpu_torch.ops.payoffs import PATHWISE, PAYOFFS, get_payoff
    from mc_tpu_torch.ops.reduce import finish_sum
    from mc_tpu_torch.models.basket import BASKET_TAG
    from mc_tpu_torch.models.bates import BATES_TAG
    from mc_tpu_torch.models.cev import CEV_TAG
    from mc_tpu_torch.models.heston import HESTON_TAG
    from mc_tpu_torch.models.localvol import LOCALVOL_TAG
    from mc_tpu_torch.models.merton import MERTON_TAG
    from mc_tpu_torch.models.dividends import DIVS_TAG
    from mc_tpu_torch.models.sabr import SABR_TAG
    from mc_tpu_torch.models.term import TERM_TAG
    from mc_tpu_torch.models.vasicek import VASICEK_TAG
    from mc_tpu_torch.models.fx import FX_TAG
    from mc_tpu_torch.models.rainbow import RAINBOW_TAG
    from mc_tpu_torch.nmc_rainbow import RAINBOW_NMC_TAG
    from mc_tpu_torch import qmc
    from mc_tpu_torch.oracle import bs_call
    from mc_tpu_torch.utils import nvidia_smi_name_power

    dev = torch.device(DEVICE)
    t_start = t0 = time.perf_counter()

    # The kernels build in a thread (the CPUs less one) from here, while
    # the families' checks run their plain versions on the card (step 0).
    built = {}

    def build():
        try:
            _cuda.load()
        except Exception as e:  # reported, and the run fails, below
            built["error"] = repr(e)
        built["seconds"] = time.perf_counter() - t0

    build_thread = threading.Thread(target=build)
    build_thread.start()

    laps = [t_start]

    def stamp(phase: int) -> None:
        laps.append(time.perf_counter())
        print(f"phase {phase}: starts {laps[-1] - t_start:.1f} s into the "
              "run")

    def lap(what: str, phase: int = 2) -> None:
        laps.append(time.perf_counter())
        print(f"phase {phase}: {what} took {laps[-1] - laps[-2]:.1f} s")

    card = nvidia_smi_name_power()
    kind = torch.cuda.get_device_name(0)
    tag = f"[{card}]"

    # --- Phase 1: device and build -------------------------------------
    print(card)
    print(f"phase 1: starts {process_seconds():.1f} s after the process")
    print(f"phase 1: torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s); device 0 = {kind}")
    # The QMC point sets' tables (the lattice's CBC vectors by numpy FFTs,
    # scipy's Sobol directions; host work, cached for the run) are built
    # beside nvcc, which leaves the GPU idle.
    cbc = {}

    def build_lattice():
        t = time.perf_counter()
        try:
            for family in ("lattice", "sobol"):
                for method, name in (("terminal", "vanilla_call"),
                                     ("euler", "asian_call")):
                    qmc.qmc_pointset(get_payoff(name), mt.SimParams(
                        n_paths=QMC_POINTS, n_steps=MAIN_STEPS), QMC_SHIFTS,
                        method, family, False, 0.1, 0, 1234, "cpu")
        except Exception as e:  # reported, and the run fails, below
            cbc["error"] = repr(e)
        cbc["seconds"] = time.perf_counter() - t

    lattice = threading.Thread(target=build_lattice)
    lattice.start()

    def lattice_ready():
        lattice.join()
        if "error" in cbc:
            fail(f"the QMC point sets' tables: {cbc['error']}")

    option = mt.DEMO_OPTION
    otm = mt.OptionParams(k=IS_STRIKE)
    is_shift = math.log(IS_STRIKE / option.s0) / option.sigma  # S_T at K
    call, bullet = get_payoff("vanilla_call"), get_payoff("bullet_call")
    key = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER))
    key_in = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_INNER))
    keys = {family: tuple(
        tuple(int(k) for k in rng.derive_key(1234, stream, tag))
        for stream in (engines.STREAM_OUTER, engines.STREAM_INNER))
        for family, tag in (("heston", HESTON_TAG), ("merton", MERTON_TAG),
                            ("bates", BATES_TAG), ("cev", CEV_TAG),
                            ("localvol", LOCALVOL_TAG), ("sabr", SABR_TAG),
                            ("term", TERM_TAG), ("divs", DIVS_TAG),
                            ("vasicek", VASICEK_TAG), ("basket", BASKET_TAG),
                            ("fx", FX_TAG), ("rainbow", RAINBOW_TAG),
                            ("rainbow_nmc", RAINBOW_NMC_TAG))}

    singles = single_families(mt)

    # --- Phase 2, first pass: the families' plain versions -------------
    stamp(2)
    # The families' checks keep no tensor past their return, so they run
    # without autograd's bookkeeping: their plain versions are launch-bound.
    with torch.inference_mode():
        sim_edge_errs = []
        simulate_edge_checks(
            mt, dev, key, lambda name, label, got, want: check_for(name)(
                label, got, want), sim_edge_errs)
        lap("#2's edge checks' plain versions")
        heston_err, family_rows_ms = heston_kernel_checks(mt, dev,
                                                          keys["heston"])
        lap("the Heston checks' plain versions")
        jump_err, jump_rows_ms = jump_kernel_checks(mt, dev, keys["merton"],
                                                    keys["bates"])
        lap("the Merton and Bates checks' plain versions")
        single_err, single_rows_ms = single_kernel_checks(mt, dev, singles,
                                                          keys)
        lap("the CEV, local-vol, SABR, term, dividend, Vasicek and basket "
            "checks' plain versions")
        frq_err, rainbow_nmc_ms = fx_rainbow_qmc_checks(mt, dev, keys,
                                                        lattice_ready)
        lap("the FX, rainbow and QMC checks' plain versions")
        qm_err, qm_plain_ms = qmc_model_checks(mt, dev)
        lap("the model-QMC checks' plain versions")
        rates_err, rates_plain_ms = rates_checks(mt, dev)
        lap("the rates checks' plain versions")
    print(f"phase 2: {len(_DEFERRED)} checks' plain halves done "
          f"{time.perf_counter() - t0:.1f} s after the build started")
    # forward mode's one-time cost, beside nvcc rather than in phase 3's
    # first cva_greeks: torch's first operation on a dual tensor imports
    # torch._dynamo (7.0 s in a first cva_greeks call, 0.2 s once warmed;
    # NVIDIA H100 80GB HBM3, 700 W)
    with fwAD.dual_level():
        fwAD.make_dual(torch.ones(()), torch.ones(())) * 2.0
    lap("forward mode's first use (beside nvcc)")
    build_thread.join()
    if "error" in built:
        fail(f"the kernels' build: {built['error']}")
    print(f"phase 1: built and loaded {_cuda.build_info['path']} in "
          f"{built['seconds']:.1f} s (nvcc "
          f"{_cuda.build_info.get('seconds') or 0.0:.1f} s, beside phase 2's "
          "plain pass)")
    lattice_ready()
    print(f"phase 1: the QMC point sets' tables (the lattice's CBC vectors, n "
          f"= {qmc.prev_prime(QMC_POINTS)}, d = 1 and {MAIN_STEPS}; Sobol's "
          f"directions) built on the host beside nvcc in "
          f"{cbc['seconds']:.1f} s")
    lap("waiting for the build")
    for line in _cuda.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"phase 1: ptxas {line.strip()}")
    print(f"phase 1: {_cuda.build_info.get('ptxas', '').count('Compiling entry')}"
          " kernel instantiations compiled (PR 10: 1,010)")
    secs = sorted(_cuda.build_info.get("source_seconds", {}).items(),
                  key=lambda kv: -kv[1])
    if secs:  # each source's nvcc
        print("phase 1: nvcc seconds by source: " + ", ".join(
            f"{name} {sec:.1f}" for name, sec in secs))

    p100 = pk.pack_params(option, MAIN_STEPS, dev)

    # --- Phase 2, second pass: each kernel against its plain version ----
    def vanilla_check(name, got, want):
        dp = abs(float(got.price) - float(want.price))
        ds = abs(float(got.stderr) - float(want.stderr))
        ok = (dp <= VANILLA_RTOL * abs(float(want.price))
              and ds <= VANILLA_RTOL * float(want.stderr))
        print(f"phase 2: {name}: kernel {float(got.price):.7f} +/- "
              f"{float(got.stderr):.7f}  plain {float(want.price):.7f} +/- "
              f"{float(want.stderr):.7f}  |dprice| {dp:.3e} |dse| {ds:.3e} "
              f"(rtol {VANILLA_RTOL}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} kernel disagrees with its plain version")
        return max(dp, ds)

    def bullet_check(name, got, want):
        se = float(want.stderr)
        dp = abs(float(got.price) - float(want.price))
        ds = abs(float(got.stderr) - se)
        ok = dp <= BULLET_SE_TOL * se and ds <= BULLET_SE_TOL * se
        print(f"phase 2: {name}: kernel {float(got.price):.7f} +/- "
              f"{float(got.stderr):.7f}  plain {float(want.price):.7f} +/- "
              f"{se:.7f}  |dprice| {dp:.3e} |dse| {ds:.3e} "
              f"(<= {BULLET_SE_TOL} se) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} kernel disagrees with its plain version")
        return max(dp, ds)

    def check_for(name):
        return bullet_check if name in FLIP_PAYOFFS else vanilla_check

    def terminal_pair_case(n_paths, po=call, opt=option):
        cfg = pk.KernelConfig(n_paths=(n_paths + 1) // 2, n_steps=MAIN_STEPS,
                              method="terminal")
        prm = pk.pack_params(opt, MAIN_STEPS, dev)
        got = engines.finish_price(finish_sum(pk.terminal_pair_partials(
            po, cfg, key, prm, n_paths)), n_paths, opt)
        want = engines.finish_price(finish_sum(
            pk.terminal_pair_partials_plain(po, cfg, key, prm, n_paths)),
            n_paths, opt)
        return check_for(po.name)(f"terminal_pair {po.name} {n_paths} paths",
                                  got, want)

    def simulate_case(po, cfg, check, opt=option, **resume):
        prm = pk.pack_params(opt, cfg.n_steps, dev)
        ex = (engines.control_mean(po, prm)
              if cfg.with_cv and po.has_control else None)
        got = engines.finish_price(finish_sum(pk.simulate_partials(
            po, cfg, key, prm, **resume)), cfg.n_paths, opt, cfg.with_cv, ex)
        want = engines.finish_price(finish_sum(pk.simulate_partials_plain(
            po, cfg, key, prm, **resume)), cfg.n_paths, opt, cfg.with_cv, ex)
        name = (f"simulate_partials {po.name} {cfg.method} "
                f"{cfg.n_paths}x{cfg.n_steps} anti={cfg.antithetic} "
                f"cv={cfg.with_cv} {cfg.rng_source} "
                f"start={cfg.start_step} is_shift={cfg.is_shift:.4f}")
        return check(name, got, want)

    def traj_case(n_paths, rng_source, po=bullet, opt=option):
        cfg = pk.KernelConfig(n_paths=n_paths, n_steps=MAIN_STEPS,
                              rng_source=rng_source)
        prm = pk.pack_params(opt, MAIN_STEPS, dev)
        s_k, c_k, part_k = pk.simulate_trajectories(po, cfg, key, prm)
        s_p, c_p, part_p = pk.simulate_trajectories_plain(po, cfg, key, prm)
        s_err = float(((s_k - s_p).abs() / s_p.abs()).max())
        paths_same = share((c_k == c_p).all(dim=0))
        name = f"trajectories {po.name} {n_paths}x{MAIN_STEPS} {rng_source}"
        print(f"phase 2: {name}: S {share(s_k == s_p):.6f} bitwise "
              f"(max rel err {s_err:.3e}, limit {TRAJ_S_RTOL}), state "
              f"{share(c_k == c_p):.6f} bitwise, {paths_same:.6f} of paths "
              f"with every state equal (need {SURF_FRAC})")
        if not (s_err <= TRAJ_S_RTOL and paths_same >= SURF_FRAC):
            fail(f"{name}: the stored grids disagree with the plain version")
        err = check_for(po.name)(
            f"{name} payoff",
            engines.finish_price(finish_sum(part_k), n_paths, opt),
            engines.finish_price(finish_sum(part_p), n_paths, opt))
        return max(err, float((s_k - s_p).abs().max()))

    def surface_check(name, surf_k, surf_p):
        close = torch.isclose(surf_k, surf_p, rtol=SURF_TOL, atol=SURF_TOL)
        frac = share(close)
        err = float((surf_k - surf_p).abs().max())
        mean_k = float(surf_k.double().mean())
        mean_p = float(surf_p.double().mean())
        ok = (frac >= SURF_FRAC
              and abs(mean_k - mean_p) <= SURF_MEAN_RTOL * abs(mean_p))
        print(f"phase 2: {name}: {frac:.6f} of points within "
              f"rtol=atol={SURF_TOL} (need {SURF_FRAC}), "
              f"{share(surf_k == surf_p):.6f} bitwise, max |d| {err:.3e}; "
              f"surface mean {mean_k:.7f} vs {mean_p:.7f} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name}: the kernel disagrees with its plain version")
        return err

    def outer_check(name, outer_k, outer_p, n_out, opt=option):
        ok_k = engines.finish_price(finish_sum(outer_k), n_out, opt)
        ok_p = engines.finish_price(finish_sum(outer_p), n_out, opt)
        d_outer = abs(float(ok_k.price) - float(ok_p.price))
        print(f"phase 2: {name}: outer {float(ok_k.price):.7f} vs "
              f"{float(ok_p.price):.7f}")
        if not d_outer <= BULLET_SE_TOL * float(ok_p.stderr):
            fail(f"{name}: the outer price disagrees with its plain version")
        return d_outer

    def nmc_small_cases(shape, po=bullet, opt=option):
        n_out, n_steps, n_inner = shape
        cfg = nk.NMCConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
        prm = pk.pack_params(opt, n_steps, dev)
        label = f"{po.name} " + "x".join(map(str, shape))
        surf_k, outer_k = nk.nmc_fused(po, cfg, key, key_in, prm)
        surf_p, outer_p = nk.nmc_fused_plain(po, cfg, key, key_in, prm)
        err = surface_check(f"nmc_fused {label}", surf_k, surf_p)
        err = max(err, outer_check(f"nmc_fused {label}", outer_k, outer_p,
                                   n_out, opt))
        s, c, _ = pk.simulate_trajectories(po, nk.outer_config(cfg), key,
                                           prm)
        surf_i = nk.nmc_inner(po, cfg, key_in, prm, s, c)
        inner_err = surface_check(
            f"nmc_inner {label}", surf_i,
            nk.nmc_inner_plain(po, cfg, key_in, prm, s, c))
        same = bool(torch.equal(surf_i, surf_k))
        print(f"phase 2: nmc {label}: grid == fused bitwise: {same}")
        if not same:
            fail(f"nmc {label}: the inner kernel's surface is not the fused "
                 "kernel's")
        return err, inner_err

    def batch_check(name, got, want, n_paths, opt, flip, cv=False, ex=None):
        """got/want: (n_mom, M) finished sums of M strikes or contracts; each
        price and stderr held to the vanilla or the bullet tolerance."""
        g = engines.finish_price(got, n_paths, opt, cv, ex)
        w = engines.finish_price(want, n_paths, opt, cv, ex)
        dp = (g.price - w.price).abs()
        ds = (g.stderr - w.stderr).abs()
        if flip:
            tol_p = tol_s = BULLET_SE_TOL * w.stderr
            rule = f"<= {BULLET_SE_TOL} se"
        else:
            tol_p, tol_s = VANILLA_RTOL * w.price.abs(), VANILLA_RTOL * w.stderr
            rule = f"rtol {VANILLA_RTOL}"
        ok = bool((dp <= tol_p).all() and (ds <= tol_s).all())
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-300)).max())
        print(f"phase 2: {name}: sums {share(got == want):.4f} bitwise (max "
              f"rel {rel:.3e}); max |dprice| {float(dp.max()):.3e}, max |dse| "
              f"{float(ds.max()):.3e} ({rule}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name}: the kernel disagrees with its plain version")
        return float(torch.maximum(dp, ds).max())

    def ladder_case(po, cfg, strikes_t, opt=option):
        prm = pk.pack_params(opt, cfg.n_steps, dev)
        got = finish_sum(pk.simulate_ladder_partials(po, cfg, key, prm,
                                                     strikes_t))
        want = finish_sum(pk.simulate_ladder_partials_plain(po, cfg, key, prm,
                                                            strikes_t))
        return batch_check(
            f"ladder {po.name} {cfg.method} {cfg.n_paths}x{cfg.n_steps} "
            f"{strikes_t.numel()} strikes anti={cfg.antithetic}",
            got.T, want.T, cfg.n_paths, opt, po.name in FLIP_PAYOFFS)

    def book_case(po, cfg, rows):
        """(max error, the plain version's ms in this one run: CUDA events)"""
        got = finish_sum(pk.simulate_book_partials(po, cfg, key, rows))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = pk.simulate_book_partials_plain(po, cfg, key, rows)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        ex = (engines.control_mean(po, rows)
              if cfg.with_cv and po.has_control else None)
        return batch_check(
            f"book {po.name} {cfg.method} {rows.shape[0]} contracts x "
            f"{cfg.n_paths}x{cfg.n_steps} anti={cfg.antithetic} "
            f"cv={cfg.with_cv} (plain {plain_ms:.1f} ms, one run)", got.T,
            finish_sum(want).T, cfg.n_paths, pk.unpack_params(rows.T),
            po.name in FLIP_PAYOFFS, cfg.with_cv, ex), plain_ms

    def nmc_main_case(shape, rows=NMC_ROWS):
        """Both NMC kernels against one plain run at the main shape: the
        plain trajectories and the plain inner sweep's ``rows`` (the plain
        fused version IS the two), so one plain run checks and times both
        kernels; the kernel calls' CUDA-event ms are phase 5's times."""
        n_out, n_steps, n_inner = shape
        cfg = nk.NMCConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
        prm = pk.pack_params(option, n_steps, dev)
        label = "x".join(map(str, shape))
        rows = list(rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_p, c_p, outer_p = pk.simulate_trajectories_plain(
            bullet, nk.outer_config(cfg), key, prm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        surf_p = nk.nmc_inner_plain(bullet, cfg, key_in, prm, s_p, c_p,
                                    steps=rows)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"phase 2: nmc plain {label}: trajectories {t1 - t0:.3f} s, "
              f"inner sweep rows {rows} {t2 - t1:.3f} s (host clock, one run)")
        (surf_k, outer_k), fused_ms = timed_call(
            lambda: nk.nmc_fused(bullet, cfg, key, key_in, prm))
        err = surface_check(f"nmc_fused {label} rows {rows}", surf_k[rows],
                            surf_p)
        err = max(err, outer_check(f"nmc_fused {label}", outer_k, outer_p,
                                   n_out))
        surf_i, inner_ms = timed_call(
            lambda: nk.nmc_inner(bullet, cfg, key_in, prm, s_p, c_p))
        inner_err = surface_check(
            f"nmc_inner {label} rows {rows} (on the plain grids)",
            surf_i[rows], surf_p)
        return (err, inner_err, (t2 - t0) * 1e3, (t2 - t1) * 1e3,
                {"nmc_fused": fused_ms, "nmc_inner": inner_ms})

    # At the sizes of the parity contract, then at the main path's shapes.
    tp_err = max(terminal_pair_case(TP_PATHS), terminal_pair_case(MAIN_PATHS),
                 *(terminal_pair_case(n) for n in TP_EDGE_PATHS))
    cases = [(call, pk.KernelConfig(n_paths=TERM_PATHS, n_steps=MAIN_STEPS,
                                    method="terminal", antithetic=True),
              vanilla_check)]
    for src in ("threefry13", "threefry"):
        cases.append((bullet, pk.KernelConfig(
            n_paths=EULER_PATHS, n_steps=EULER_STEPS, rng_source=src),
            bullet_check))
        cases.append((call, pk.KernelConfig(
            n_paths=EULER_PATHS, n_steps=EULER_STEPS, antithetic=True,
            with_cv=True, rng_source=src), vanilla_check))
    for kw in (dict(method="terminal"),
               dict(method="terminal", antithetic=True), dict(),
               dict(antithetic=True, with_cv=True)):
        cases.append((call, pk.KernelConfig(n_paths=MAIN_PATHS,
                                            n_steps=MAIN_STEPS, **kw),
                      vanilla_check))
    for anti in (False, True):
        cases.append((bullet, pk.KernelConfig(
            n_paths=BULLET_PATHS, n_steps=MAIN_STEPS, antithetic=anti),
            bullet_check))
    sim_err = max(simulate_case(*c) for c in cases)

    traj_err = max(traj_case(n_paths, src) for n_paths in TRAJ_PATHS
                   for src in ("threefry13", "threefry"))
    s_grid, c_grid, _ = pk.simulate_trajectories(
        bullet, pk.KernelConfig(n_paths=BULLET_PATHS, n_steps=MAIN_STEPS),
        key, p100)
    for start in RESUME_STEPS:  # resume from the stored states
        sim_err = max(sim_err, simulate_case(
            bullet, pk.KernelConfig(n_paths=BULLET_PATHS, n_steps=MAIN_STEPS,
                                    start_step=start), bullet_check,
            s_init=s_grid[start - 1].contiguous(),
            state_init=c_grid[start - 1].contiguous()))
    for kw in (dict(method="terminal"), dict(),
               dict(antithetic=True), dict(antithetic=True, with_cv=True)):
        sim_err = max(sim_err, simulate_case(
            call, pk.KernelConfig(n_paths=MAIN_PATHS, n_steps=MAIN_STEPS,
                                  is_shift=is_shift, **kw),
            vanilla_check, opt=otm))
    # The libm premises of #3/#5 (csrc/nmc_kernels.cu), on every input they
    # can meet: expf keeps the order of the finite floats (the bullet's, the
    # up-and-out and the down-and-in call's legs test w against a
    # threshold), and sincosf is cosf and sinf bit for bit (every kernel's
    # Box-Muller draw).
    bad = torch.zeros(2, dtype=torch.int64, device=dev)
    _cuda.check(_cuda.load().mc_nmc_libm_check(bad.data_ptr(),
                                                _cuda.stream_handle(dev)),
                "nmc_libm_check")
    n_order, n_trig = (int(x) for x in bad.tolist())
    print(f"phase 2: libm: expf out of order on {n_order} neighbouring pairs "
          f"of the finite floats, sincosf != cosf, sinf on {n_trig} of the "
          f"2^23 Box-Muller thetas")
    if n_order or n_trig:
        fail("the CUDA libm breaks a premise of the NMC kernels (expf's "
             "order or sincosf == cosf, sinf)")
    # #18's logf on the clamped spot (csrc/cev.cuh cev_logf) against the
    # toolkit's logf on every float max(S, 1e-12) can be: [1e-12, FLT_MAX]
    # and +inf
    bad = torch.tensor([0, -1], dtype=torch.int64, device=dev)
    _cuda.check(_cuda.load().mc_cev_logf_check(bad.data_ptr(),
                                                _cuda.stream_handle(dev)),
                "cev_logf_check")
    n_logf, first_logf = (int(x) for x in bad.tolist())
    n_domain = 0x7F800000 - int(np.array(1e-12, np.float32).view(np.uint32)) + 1
    print(f"phase 2: cev_logf != logf on {n_logf} of the {n_domain} floats "
          f"of [1e-12, FLT_MAX] and +inf"
          + (f" (the least: bits {first_logf:#010x})" if n_logf else ""))
    if n_logf:
        fail("the CEV kernel's clamped-spot logf is not the toolkit's logf")
    fused_err, inner_err = nmc_small_cases(NMC_SMALL)
    # odd steps, a ragged last leg group; the bullet's window within reach
    # of 7 steps
    for po, opt in ((bullet, mt.OptionParams(p1=1.0, p2=6.0)), (call, option)):
        err_f, err_i = nmc_small_cases(NMC_RAGGED, po, opt)
        fused_err, inner_err = max(fused_err, err_f), max(inner_err, err_i)
    (err_f, err_i, fused_plain_ms, inner_plain_ms,
     nmc_main) = nmc_main_case(NMC_MAIN)
    fused_err, inner_err = max(fused_err, err_f), max(inner_err, err_i)

    # Every payoff through the simulate kernel (Euler, 100 steps); the six
    # terminal-only ones through both terminal kernels at 1M paths; the
    # geometric control variate with antithetic; multi-word resume.
    for name, po in sorted(PAYOFFS.items()):
        opt = payoff_option(mt, name)
        sim_err = max(sim_err, simulate_case(po, pk.KernelConfig(
            n_paths=PAYOFF_PATHS, n_steps=MAIN_STEPS), check_for(name), opt))
        if po.terminal_only:
            sim_err = max(sim_err, simulate_case(po, pk.KernelConfig(
                n_paths=MAIN_PATHS, n_steps=MAIN_STEPS, method="terminal"),
                check_for(name), opt))
            tp_err = max(tp_err, terminal_pair_case(MAIN_PATHS, po, opt))
    sim_err = max(sim_err, simulate_case(
        get_payoff("asian_call_geo_cv"), pk.KernelConfig(
            n_paths=PAYOFF_PATHS, n_steps=MAIN_STEPS, antithetic=True,
            with_cv=True), vanilla_check))
    gen = torch.Generator(device=dev).manual_seed(7)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(PAYOFF_PATHS, device=dev,
                                           generator=gen)

    start = RESUME_STEPS[1]  # odd: the tail half of its pair first
    s_res = 100.0 * torch.exp(0.1 * torch.randn(PAYOFF_PATHS, device=dev,
                                                generator=gen))
    for name, words in (
            ("variance_swap", (s_res, uniform(0.0, 0.03))),
            ("cliquet", (torch.full_like(s_res, float(start)),
                         s_res * uniform(0.9, 1.1), uniform(-0.04, 0.08)))):
        sim_err = max(sim_err, simulate_case(
            get_payoff(name), pk.KernelConfig(
                n_paths=PAYOFF_PATHS, n_steps=MAIN_STEPS, start_step=start),
            vanilla_check, payoff_option(mt, name),
            s_init=s_res.contiguous(),
            state_init=tuple(w.contiguous() for w in words)))

    # Trajectories for every payoff with one state word (the bullet ran
    # above); both NMC kernels for a discrete barrier and the Asian.
    for name, po in sorted(PAYOFFS.items()):
        if po.n_state <= 1 and name != "bullet_call":
            traj_err = max(traj_err, traj_case(PAYOFF_PATHS, "threefry13", po,
                                               payoff_option(mt, name)))
    for name in ("down_out_call", "asian_call", "vanilla_call",
                 "up_out_call", "down_in_call"):
        err_f, err_i = nmc_small_cases(NMC_SMALL, get_payoff(name),
                                       payoff_option(mt, name))
        fused_err, inner_err = max(fused_err, err_f), max(inner_err, err_i)

    # The ladder (17 strikes on shared paths) and the book (16 contracts on
    # shared draws), then both at the main path's shapes: the 1M-path call
    # ladder, and book64's bullet and vanilla books with the simulate kernel
    # at their 2^20 x 100 (each contract's standalone price()).
    strikes = np.linspace(*LADDER_STRIKES)
    strikes_t = torch.tensor(strikes, dtype=torch.float32, device=dev)
    ladder_err = max(
        ladder_case(call, pk.KernelConfig(n_paths=PAYOFF_PATHS,
                                          n_steps=MAIN_STEPS,
                                          method="terminal"), strikes_t),
        ladder_case(bullet, pk.KernelConfig(n_paths=PAYOFF_PATHS,
                                            n_steps=MAIN_STEPS,
                                            antithetic=True), strikes_t),
        ladder_case(call, pk.KernelConfig(n_paths=LADDER_PATHS,
                                          n_steps=MAIN_STEPS,
                                          method="terminal"), strikes_t))
    # The small books: each way a contract's leg reads the spot (the
    # bullet's and the down-and-in's barrier test on w, the Asian's spot at
    # each step, the call's at the end; csrc/barrier.cuh StateRead), a
    # ragged last contract group (13 contracts in groups of 8), antithetic
    # and the control variate.
    nb, nb_paths = BOOK_SMALL
    small = book_options(mt, nb)
    rows_small = pk.pack_params_rows(small, MAIN_STEPS, dev)
    rows_down = pk.pack_params_rows(dataclasses.replace(
        small, barrier=np.full(nb, 90.0, np.float32)), MAIN_STEPS, dev)
    asian, down_in = get_payoff("asian_call"), get_payoff("down_in_call")
    anti_cv = dict(antithetic=True, with_cv=True)
    book_err = max(book_case(po, pk.KernelConfig(
        n_paths=nb_paths, n_steps=MAIN_STEPS, **kw), rows)[0]
        for po, kw, rows in ((bullet, {}, rows_small),
                             (bullet, dict(antithetic=True), rows_small),
                             (call, dict(with_cv=True), rows_small),
                             (call, {}, rows_small),
                             (asian, {}, rows_small),
                             (asian, anti_cv, rows_small),
                             (down_in, {}, rows_down),
                             (down_in, anti_cv, rows_down),
                             (bullet, anti_cv, rows_small[:13])))
    nb, nb_paths = BOOK_MAIN
    book64 = book_options(mt, nb)
    rows_main = pk.pack_params_rows(book64, MAIN_STEPS, dev)
    err, book_plain_ms = book_case(bullet, pk.KernelConfig(
        n_paths=nb_paths, n_steps=MAIN_STEPS), rows_main)
    book_err = max(book_err, err, book_case(call, pk.KernelConfig(
        n_paths=nb_paths, n_steps=MAIN_STEPS, method="terminal"),
        rows_main)[0])
    sim_err = max(sim_err, simulate_case(
        bullet, pk.KernelConfig(n_paths=nb_paths, n_steps=MAIN_STEPS),
        bullet_check, contract(mt, book64, 0)))

    # The greek kernel (the five pathwise payoffs: the terminal-only ones
    # at 2^20, the Asian and the lookback over 100 and 99 steps; and the
    # main path's shapes, whose last blocks are partly filled: the
    # terminal-only ones at GREEK_PATHS, the Asian, the lookback and the
    # call at GREEK_STEP_PATHS x 100) and the reductions (aligned and
    # misaligned views up to 2^26 elements): every sum to f64 rounding of
    # the plain version's.
    def greek_results(sums, n_paths):
        """(price, stderr) of pay, delta, vega, rho, epsilon: (5, 2)."""
        return torch.stack([torch.stack([r.price, r.stderr]) for r in (
            engines.finish_price(sums[2 * i:2 * i + 2], n_paths, option)
            for i in range(5))])

    def greek_case(name, method, n_paths, n_steps):
        po = get_payoff(name)
        cfg = pk.KernelConfig(n_paths=n_paths, n_steps=n_steps, method=method)
        prm = pk.pack_params(option, n_steps, dev)
        got = finish_sum(pk.simulate_greek_partials(po, cfg, key, prm))
        want = finish_sum(pk.simulate_greek_partials_plain(po, cfg, key, prm))
        check_sums(f"greek_partials {name} {method} {n_paths}x{n_steps}",
                   got, want)
        return float((greek_results(got, n_paths)
                      - greek_results(want, n_paths)).abs().max())

    greek_err = 0.0
    for name in PATHWISE:
        if get_payoff(name).terminal_only:
            shapes = [("terminal", n, MAIN_STEPS)
                      for n in (GREEK_TERM_PATHS, GREEK_PATHS)]
        else:
            shapes = [("euler", GREEK_EULER_PATHS, n_steps)
                      for n_steps in (MAIN_STEPS, MAIN_STEPS - 1)]
        if name == "vanilla_call" or not get_payoff(name).terminal_only:
            shapes.append(("euler", GREEK_STEP_PATHS, MAIN_STEPS))
        if name == "vanilla_call":
            shapes.append(("terminal", GREEK_PAST, MAIN_STEPS))
        if name in ("vanilla_call", "asian_call"):
            shapes.append(("euler", GREEK_PAST, 2))
        for method, n_paths, n_steps in shapes:
            greek_err = max(greek_err, greek_case(name, method, n_paths,
                                                  n_steps))
    reduce_err = dict.fromkeys(("tile_partials", "sum_sumsq"), 0.0)
    for n in REDUCE_SIZES:
        x = torch.randn(n + 1, device=dev, generator=gen)
        views = ((("aligned", x[:n]), ("misaligned", x[1:]))
                 if n == REDUCE_SIZES[2] else (("aligned", x[:n]),))
        for label, v in views:
            for name, fn, plain in (
                    ("tile_partials", reduce.tile_partials,
                     reduce.tile_partials_plain),
                    ("sum_sumsq", reduce.sum_sumsq_partials,
                     reduce.sum_sumsq_partials_plain)):
                got, want = finish_sum(fn(v)), finish_sum(plain(v))
                check_sums(f"{name} {n} elements {label}", got, want)
                reduce_err[name] = max(reduce_err[name],
                                       float((got - want).abs().max()))
    del x, v
    lap("checking the GBM kernels")
    with torch.inference_mode():
        n_checks = run_deferred()
    lap(f"the kernel halves of the families' {n_checks} deferred checks")
    sim_err = max([sim_err, *sim_edge_errs])

    # --- Phase 3: the main path at a size users run --------------------
    stamp(3)
    _cuda.reset_launch_counts()
    bs = bs_call(option.s0, option.k, option.t, option.r, option.sigma,
                 option.q)
    sim = mt.SimParams(n_paths=MAIN_PATHS, n_steps=MAIN_STEPS)
    variants = (
        ("default (terminal_pair)", {}),
        ("terminal", dict(method="terminal")),
        ("euler", dict(method="euler")),
        ("antithetic", dict(antithetic=True)),
        ("antithetic + control variate",
         dict(method="euler", antithetic=True, control_variate=True)),
    )
    vanilla_price = None
    for label, kw in variants:
        res = mt.price(option, sim, device=DEVICE, **kw)
        z = abs(float(res.price) - bs) / float(res.stderr)
        print(f"phase 3: call {label}: {float(res.price):.5f} +/- "
              f"{float(res.stderr):.5f}, {z:.2f} se from BS {bs:.5f}")
        if not (math.isfinite(z) and z <= 3.0):
            fail(f"call {label} is {z:.2f} se from Black-Scholes")
        vanilla_price = vanilla_price or float(res.price)
    bs_otm = bs_call(otm.s0, otm.k, otm.t, otm.r, otm.sigma, otm.q)
    plain_otm = mt.price(otm, sim, method="terminal", device=DEVICE)
    is_otm = mt.price(otm, sim, importance_shift="auto", device=DEVICE)
    z = abs(float(is_otm.price) - bs_otm) / float(is_otm.stderr)
    print(f"phase 3: call K={IS_STRIKE:g} importance_shift='auto': "
          f"{float(is_otm.price):.7f} +/- {float(is_otm.stderr):.7f}, "
          f"{z:.2f} se from BS {bs_otm:.7f}; unshifted terminal "
          f"{float(plain_otm.price):.7f} +/- {float(plain_otm.stderr):.7f} "
          f"({float(plain_otm.stderr) / float(is_otm.stderr):.1f}x the "
          "stderr)")
    if not (math.isfinite(z) and z <= 3.0
            and float(is_otm.stderr) < float(plain_otm.stderr)):
        fail("the importance-sampled OTM call misses Black-Scholes or does "
             "not cut the stderr")
    bsim = mt.SimParams(n_paths=BULLET_PATHS, n_steps=MAIN_STEPS)
    bullet_res = None
    for anti in (False, True):
        res = mt.price(option, bsim, payoff="bullet_call", antithetic=anti,
                       device=DEVICE)
        p = float(res.price)
        print(f"phase 3: bullet {BULLET_PATHS}x{MAIN_STEPS} antithetic={anti}: "
              f"{p:.5f} +/- {float(res.stderr):.5f}")
        if not (math.isfinite(p) and 0.0 < p < vanilla_price):
            fail(f"bullet price {p} is not in (0, {vanilla_price})")
        bullet_res = bullet_res or res

    traj = mt.simulate_trajectories(option, bsim, device=DEVICE)
    path, state = traj.path_matrix(), traj.state_matrix()
    counts = torch.cumsum((path < option.barrier).float(), dim=1)
    mean_pay = float(traj.pay_sum) / BULLET_PATHS
    d_pay = abs(mean_pay - float(bullet_res.payoff_mean))
    counts_ok = bool(torch.equal(state, counts))
    finite = bool(torch.isfinite(path).all())
    print(f"phase 3: trajectories {BULLET_PATHS}x{MAIN_STEPS}: state == "
          f"cumsum(S < B) {'exactly' if counts_ok else 'NOT'}; mean payoff "
          f"{mean_pay:.7f} vs price(bullet_call) "
          f"{float(bullet_res.payoff_mean):.7f}"
          f" (|d| {d_pay:.3e}, limit 1e-5 relative)")
    if not (counts_ok and finite
            and d_pay <= 1e-5 * abs(float(bullet_res.payoff_mean))):
        fail("the trajectories break the barrier-count or payoff check")
    start = RESUME_STEPS[0]
    resumed = engines.finish_price(finish_sum(pk.simulate_partials(
        bullet, pk.KernelConfig(n_paths=BULLET_PATHS, n_steps=MAIN_STEPS,
                                start_step=start), key, p100,
        s_init=traj.s[start - 1].contiguous(),
        state_init=traj.state[start - 1].contiguous())), BULLET_PATHS, option)
    d_res = abs(float(resumed.price) - float(bullet_res.price))
    print(f"phase 3: resume at step {start} of the stored grid: "
          f"{float(resumed.price):.7f} vs straight "
          f"{float(bullet_res.price):.7f}"
          f" ({d_res / float(bullet_res.stderr):.4f} se, limit "
          f"{BULLET_SE_TOL})")
    if not d_res <= BULLET_SE_TOL * float(bullet_res.stderr):
        fail("the resumed bullet disagrees with the straight run")

    n_out, n_steps, n_inner = NMC_MAIN
    nsim = mt.SimParams(n_paths=n_out, n_steps=n_steps, n_paths_inner=n_inner)
    t0 = time.perf_counter()
    res = mt.price_nmc(option, nsim, device=DEVICE)
    torch.cuda.synchronize()
    nmc_first_s = time.perf_counter() - t0
    surf = res.surface_matrix()
    if tuple(surf.shape) != (n_out, n_steps) or not bool(torch.isfinite(surf).all()):
        fail(f"NMC surface has shape {tuple(surf.shape)} or non-finite values")
    # Last step: remaining = 0, so every inner path IS the stored state and
    # the point is e^{-rT} * payoff(S_T, count_T) of the outer path.
    ntraj = mt.simulate_trajectories(option, nsim, device=DEVICE)
    p32 = pk.unpack_params(pk.pack_params(option, n_steps, dev))
    want = torch.exp(-p32.r * p32.t) * bullet.terminal(
        (ntraj.state[-1],), ntraj.s[-1], p32)
    last = surf[:, -1]
    last_ok = bool(torch.allclose(last, want, rtol=1e-5, atol=0.0))
    print(f"phase 3: nmc {n_out}x{n_steps}x{n_inner} ({nmc_first_s:.2f} s): "
          f"outer {float(res.outer.price):.5f} +/- {float(res.outer.stderr):.5f}"
          f", surface mean {float(res.surface_mean):.5f}; last step == "
          f"e^-rT*payoff: {'ok' if last_ok else 'MISMATCH'} "
          f"({share(last == want):.6f} bitwise)")
    if not last_ok:
        fail("NMC last step is not the discounted terminal payoff")
    cols = surf.double().mean(dim=0)
    dev_se = ((cols - float(res.outer.price)).abs()
              / float(res.outer.stderr)).max()
    print(f"phase 3: nmc tower property: max |column mean - outer| = "
          f"{float(dev_se):.2f} outer stderr (limit 4)")
    if not float(dev_se) <= 4.0:
        fail("NMC surface columns break the tower property")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_g = mt.price_nmc(option, nsim, strategy="grid", device=DEVICE)
    torch.cuda.synchronize()
    e2e_nmc = {("gbm", "fused"): nmc_first_s,
               ("gbm", "grid"): time.perf_counter() - t0}
    g_close = share(torch.isclose(res_g.surface, res.surface, rtol=SURF_TOL,
                                  atol=SURF_TOL))
    spot_ok = bool(torch.equal(res_g.spot_matrix(), ntraj.path_matrix()))
    print(f"phase 3: nmc strategy='grid': {share(res_g.surface == res.surface):.6f}"
          f" of points bitwise equal to 'fused', {g_close:.6f} within "
          f"rtol=atol={SURF_TOL} (need {SURF_FRAC}); surface mean "
          f"{float(res_g.surface_mean):.7f} vs {float(res.surface_mean):.7f}; "
          f"spot_matrix() == trajectories: {spot_ok}")
    if not (g_close >= SURF_FRAC and spot_ok
            and bool(torch.equal(res_g.surface, res.surface))
            and abs(float(res_g.surface_mean) - float(res.surface_mean))
            <= SURF_MEAN_RTOL * abs(float(res.surface_mean))):
        fail("the grid strategy disagrees with the fused one (grid == "
             "fused is bitwise)")

    ee, pfe = res_g.exposure_profile(0.95)
    for j in (0, n_steps // 4, n_steps // 2, 3 * n_steps // 4, n_steps - 1):
        print(f"phase 3: exposure t_{j + 1} = {float(res_g.observation_dates()[j]):.2f}"
              f" y: EE {float(ee[j]):.6f}, PFE(95%) {float(pfe[j]):.6f}")
    cva = float(res_g.cva(0.02))
    fca, fba = res_g.fva(0.01)
    xva = {
        "cva(0.02)": cva,
        "dva(0.01)": float(res_g.dva(0.01)),
        "bilateral_cva(0.02, 0.01)": float(res_g.bilateral_cva(0.02, 0.01)),
        "fca(0.01)": float(fca), "fba(0.01)": float(fba),
        "mva(0.01, 99%, mpor 2)": float(res_g.mva(0.01, 0.99, 2)),
        "collateralized cva (H=1, mta=0.1, mpor 2)": float(
            res_g.collateralized(1.0, mta=0.1, mpor_steps=2).cva(0.02)),
        "cva_wwr(0.02, beta=0.05)": float(res_g.cva_wwr(0.02, 0.05)),
        "cva_wwr_spot(0.02, beta=0)": float(res_g.cva_wwr_spot(0.02, 0.0)),
    }
    im = res_g.im_profile(0.99, 2)
    print("phase 3: xva of the grid surface: " + ", ".join(
        f"{k} {v:.7f}" for k, v in xva.items())
        + f"; IM(99%, mpor 2) at t_1 {float(im[0]):.6f}, at t_n "
        f"{float(im[-1]):.6f}")
    d_wwr = abs(xva["cva_wwr_spot(0.02, beta=0)"] - cva)
    if not (all(math.isfinite(v) for v in xva.values()) and cva > 0.0
            and d_wwr <= XVA_RTOL * cva):
        fail("the exposure metrics are not finite, or cva_wwr_spot(beta=0) "
             "is not cva")
    flips = {}
    for name in ("vanilla_call", "vanilla_put"):
        r = mt.price_nmc(option, nsim, name, strategy="grid", device=DEVICE)
        flips[name] = (float(r.cva(0.02)), float(r.cva_wwr_spot(0.02, 2.0)))
    print(f"phase 3: spot-linked WWR at beta=2 (cva -> cva_wwr_spot): call "
          f"{flips['vanilla_call'][0]:.7f} -> {flips['vanilla_call'][1]:.7f},"
          f" put {flips['vanilla_put'][0]:.7f} -> "
          f"{flips['vanilla_put'][1]:.7f}")
    if not (flips["vanilla_call"][1] > flips["vanilla_call"][0]
            and flips["vanilla_put"][1] < flips["vanilla_put"][0]):
        fail("spot-linked WWR does not flip sign between call and put")

    # Every payoff through price(): terminal-only at 1M paths, the others at
    # 100,000 x 100 steps; each against its closed form or identity.
    def z_gate(label, res, want):
        z = abs(float(res.price) - want) / float(res.stderr)
        print(f"phase 3: {label}: {float(res.price):.7f} +/- "
              f"{float(res.stderr):.7f}, {z:.2f} se from {want:.7f}")
        if not (math.isfinite(z) and z <= 3.0):
            fail(f"{label} is {z:.2f} se from its closed form")

    pay = {}
    for name, po in sorted(PAYOFFS.items()):
        res = mt.price(payoff_option(mt, name),
                       sim if po.terminal_only else bsim,
                       name, control_variate=po.has_control, device=DEVICE)
        pay[name] = res
        if not (math.isfinite(float(res.price))
                and math.isfinite(float(res.stderr))):
            fail(f"{name}: non-finite price or stderr")
    print("phase 3: payoffs (terminal-only 1M paths, others "
          f"{BULLET_PATHS}x{MAIN_STEPS}): " + ", ".join(
              f"{n} {float(r.price):.6f} +/- {float(r.stderr):.6f}"
              for n, r in pay.items()))
    disc = math.exp(-float(np.float32(option.r)) * option.t)
    mu = option.r - 0.5 * option.sigma ** 2
    bs_args = (option.s0, option.k, option.t, option.r, option.sigma)
    for name, want in (
            ("digital_call", oracle.bs_digital_call(*bs_args)),
            ("digital_put", oracle.bs_digital_put(*bs_args)),
            ("best_of_cash", option.k * math.exp(-option.r * option.t) + bs),
            ("up_out_call_bb", oracle.bs_up_out_call(*bs_args, 120.0)),
            ("down_out_call_bb", oracle.bs_down_out_call(*bs_args, 90.0)),
            ("forward_start_call", oracle.bs_forward_start_call(
                option.s0, 1.0, 0.5, option.t, option.r, option.sigma)),
            ("cliquet", oracle.bs_cliquet(4, 0.25, -0.02, 0.04, option.t,
                                          option.r, option.sigma)),
            ("variance_swap", math.exp(-option.r * option.t)
             * (option.sigma ** 2 + mu * mu / MAIN_STEPS))):
        z_gate(f"{name} vs its closed form", pay[name], want)
    zcb = pay["zcb"]
    d_sum = float(pay["digital_call"].price) + float(pay["digital_put"].price)
    van = mt.price(payoff_option(mt, "down_out_call"), bsim, "vanilla_call",
                   method="euler", device=DEVICE)
    d_inout = float(pay["down_in_call"].price) + float(pay["down_out_call"]
                                                       .price)
    print(f"phase 3: zcb {float(zcb.price):.15f} vs e^-rT {disc:.15f} (stderr "
          f"{float(zcb.stderr):.3e}); digital call + put {d_sum:.9f}; "
          f"down-in + down-out {d_inout:.9f} vs vanilla euler "
          f"{float(van.price):.9f}")
    if not (abs(float(zcb.price) - disc) <= 1e-12 * disc
            and float(zcb.stderr) <= 1e-6
            and abs(d_sum - disc) <= 2e-6 * disc
            and abs(d_inout - float(van.price)) <= 1e-5 * float(van.price)):
        fail("a parity identity (zcb, digital call + put, in + out) fails")
    geo, asian = pay["asian_call_geo_cv"], pay["asian_call"]
    ratio = float(asian.stderr) / float(geo.stderr)
    d_geo = abs(float(geo.price) - float(asian.price)) / float(asian.stderr)
    print(f"phase 3: asian_call_geo_cv with CV {float(geo.price):.7f} +/- "
          f"{float(geo.stderr):.7f} vs plain asian_call {float(asian.price):.7f}"
          f" +/- {float(asian.stderr):.7f}: {d_geo:.2f} plain se apart, "
          f"stderr {ratio:.1f}x smaller")
    if not (d_geo <= 3.0 and ratio >= 3.0):
        fail("the geometric control variate misses the plain Asian or does "
             "not cut its stderr")

    # The ladder: 17 strikes at 1M paths, each against Black-Scholes and
    # against price() at its strike on the same key.
    lsim = mt.SimParams(n_paths=LADDER_PATHS, n_steps=MAIN_STEPS)
    lad = mt.price_ladder(strikes, option, lsim, device=DEVICE)
    z_max, rel_max, same = 0.0, 0.0, 0
    for m, k in enumerate(strikes):
        bs_k = bs_call(option.s0, k, option.t, option.r, option.sigma)
        z_max = max(z_max, abs(float(lad.price[m]) - bs_k)
                    / float(lad.stderr[m]))
        one = mt.price(mt.OptionParams(k=float(k)), lsim, method="terminal",
                       device=DEVICE)
        rel_max = max(rel_max, abs(float(lad.price[m]) - float(one.price))
                      / float(one.price))
        same += float(lad.price[m]) == float(one.price)
    falling = bool((torch.diff(lad.price) < 0).all())
    print(f"phase 3: ladder {len(strikes)} strikes {strikes[0]:g}..."
          f"{strikes[-1]:g} x {LADDER_PATHS} paths: max {z_max:.2f} se from "
          f"Black-Scholes, prices fall with the strike: {falling}; each strike"
          f" vs price(k, method='terminal'): {same}/{len(strikes)} bitwise, "
          f"max rel {rel_max:.3e}")
    if not (z_max <= 3.0 and falling and rel_max <= 1e-12):
        fail("the ladder misses Black-Scholes, is not monotone, or differs "
             "from the single-strike prices")

    # The book (bench.py's book64): 64 contracts x 2^20 paths x 100 steps.
    msim =mt.SimParams(n_paths=nb_paths, n_steps=MAIN_STEPS)
    t0 = time.perf_counter()
    bk = mt.price_portfolio(book64, msim, "bullet_call", device=DEVICE)
    torch.cuda.synchronize()
    book_first_s = time.perf_counter() - t0
    lines, rel_max = [], 0.0
    for b in (0, 1, nb // 2 - 1, nb - 1):  # 0, 1, 31 and 63
        one = mt.price(contract(mt, book64, b), msim, "bullet_call",
                       method="euler", device=DEVICE)
        rel = abs(float(bk.price[b]) - float(one.price)) / float(one.price)
        rel_max = max(rel_max, rel,
                      abs(float(bk.stderr[b]) - float(one.stderr))
                      / float(one.stderr))
        lines.append(f"#{b} {float(bk.price[b]):.7f} vs {float(one.price):.7f}"
                     f" ({'bitwise' if rel == 0.0 else f'rel {rel:.2e}'})")
    print(f"phase 3: book {nb} bullet x {nb_paths} x {MAIN_STEPS} "
          f"({book_first_s:.3f} s): contract vs standalone price(): "
          + "; ".join(lines))
    if not (rel_max <= 1e-12 and bool(torch.isfinite(bk.price).all())):
        fail("a book contract differs from its standalone price")
    vb = mt.price_portfolio(book64, msim, "vanilla_call", device=DEVICE)
    bs_b = torch.tensor([bs_call(100.0, float(k), 1.0, 0.1, float(v))
                         for k, v in zip(book64.k, book64.sigma)],
                        dtype=torch.float64, device=dev)
    z_b = ((vb.price - bs_b).abs() / vb.stderr)
    frac = share(z_b < 5.0)
    print(f"phase 3: book {nb} vanilla_call terminal x {nb_paths}: "
          f"{frac:.4f} of contracts within 5 se of Black-Scholes (need > "
          f"0.95), max {float(z_b.max()):.2f} se")
    if not frac > 0.95:
        fail("the vanilla book misses Black-Scholes")

    # Greeks.  The 1M-path call's through the fused kernel against
    # Black-Scholes (epsilon = -S0 T delta at q = 0).
    kernel_which = ("delta", "vega", "rho", "epsilon")
    bs_delta = oracle.bs_delta_call(*bs_args)
    bs_vega = oracle.bs_vega(*bs_args)
    bs_rho = option.k * option.t * oracle.bs_digital_call(*bs_args)
    bs_greek = dict(delta=bs_delta, vega=bs_vega, rho=bs_rho,
                    epsilon=-option.s0 * option.t * bs_delta,
                    theta=-(option.sigma / (2 * option.t) * bs_vega
                            + option.r / option.t * bs_rho))
    gsim = mt.SimParams(n_paths=GREEK_PATHS, n_steps=MAIN_STEPS)
    g = mt.greeks(option, gsim, which=kernel_which, device=DEVICE)
    one = mt.price(option, gsim, method="terminal", device=DEVICE)
    zs = {k: abs(float(g[k]) - bs_greek[k]) / float(g[f"{k}_stderr"])
          for k in kernel_which}
    d_price = abs(float(g["price"]) - float(one.price)) / float(one.price)
    print(f"phase 3: greeks() call {GREEK_PATHS} terminal (fused kernel): "
          + ", ".join(f"{k} {float(g[k]):.6f} +/- {float(g[k + '_stderr']):.6f}"
                      f" ({zs[k]:.2f} se from {bs_greek[k]:.6f})"
                      for k in kernel_which)
          + f"; its price vs price(method='terminal') rel {d_price:.2e}")
    if not (max(zs.values()) <= 3.0 and d_price <= SUMS_RTOL):
        fail("the fused greeks miss Black-Scholes, or their price is not "
             "price()'s")

    # The Asian and the lookback at 100,000 x 100: the fused kernel against
    # autograd through price() on the same draws.
    asim = mt.SimParams(n_paths=GREEK_STEP_PATHS, n_steps=MAIN_STEPS)

    def route_gap(gk, ga, keys):
        return max(abs(float(gk[k]) - float(ga[k]))
                   / (max(1.0, abs(float(ga[k]))) * GREEK_ROUTE_RTOL + 1e-4)
                   for k in keys)

    for name in ("asian_call", "lookback_call"):
        gk = mt.greeks(option, asim, name, which=kernel_which, device=DEVICE)
        ga = mt.greeks(option, asim, name, which=kernel_which + ("theta",),
                       device=DEVICE)
        gap = route_gap(gk, ga, kernel_which)
        print(f"phase 3: greeks() {name} {GREEK_STEP_PATHS}x{MAIN_STEPS}: "
              + ", ".join(f"{k} kernel {float(gk[k]):.6f} autograd "
                          f"{float(ga[k]):.6f}" for k in kernel_which)
              + f", theta {float(ga['theta']):.6f}; largest gap "
              f"{gap:.3f} of the limit ({GREEK_ROUTE_RTOL} rel)")
        if not (gap <= 1.0 and math.isfinite(float(ga["theta"]))):
            fail(f"{name}: the fused greeks and autograd disagree")

    # The default which (with theta) through autograd, the call over 100
    # Euler steps.  Per path dP/dT = sigma/(2T) dP/dsigma + r/T dP/dr
    # (q = 0), so theta is held to that combination of the fused kernel's
    # vega and rho on the same draws, and to Black-Scholes within 3 of
    # its stderr's bound sigma/(2T) se_vega + r/T se_rho.
    ga = mt.greeks(option, asim, sim_method="euler", device=DEVICE)
    gk = mt.greeks(option, asim, which=kernel_which, sim_method="euler",
                   device=DEVICE)
    theta_k = -(option.sigma / (2 * option.t) * float(gk["vega"])
                + option.r / option.t * float(gk["rho"]))
    theta_se = (option.sigma / (2 * option.t) * float(gk["vega_stderr"])
                + option.r / option.t * float(gk["rho_stderr"]))
    gap = max(route_gap(gk, ga, ("delta", "vega", "rho")),
              abs(float(ga["theta"]) - theta_k)
              / (max(1.0, abs(theta_k)) * GREEK_ROUTE_RTOL + 1e-4))
    z_theta = abs(float(ga["theta"]) - bs_greek["theta"]) / theta_se
    print(f"phase 3: greeks() call euler {GREEK_STEP_PATHS}x{MAIN_STEPS} "
          f"default which (autograd): " + ", ".join(
              f"{k} {float(ga[k]):.6f}" for k in ("delta", "vega", "rho",
                                                  "theta"))
          + f"; theta from the kernel's vega and rho {theta_k:.6f}, largest "
          f"gap {gap:.3f} of the limit; theta {z_theta:.2f} se from "
          f"Black-Scholes {bs_greek['theta']:.6f}")
    if not (gap <= 1.0 and z_theta <= 3.0):
        fail("autograd greeks disagree with the fused kernel or theta "
             "misses Black-Scholes")

    # The bullet's delta and gamma by CRN-FD (the simulate kernel) against
    # LRM.  FD's stderr comes from the per-path differences of three
    # trajectory runs at S0 - h, S0, S0 + h (the same draws), whose means
    # are greeks()'s FD values up to the order of the sums.
    gf = mt.greeks(option, asim, "bullet_call", method="fd",
                   which=("delta", "gamma"), rel_bump=FD_BUMP, device=DEVICE)
    gl = mt.greeks(option, asim, "bullet_call", method="lrm",
                   which=("delta", "gamma"), device=DEVICE)
    h = np.float32(FD_BUMP) * np.float32(option.s0)
    pays = []
    for sgn in (-1, 0, 1):
        bumped = mt.OptionParams(s0=float(np.float32(option.s0) + sgn * h))
        tr = mt.simulate_trajectories(bumped, asim, device=DEVICE)
        pays.append(bullet.terminal((tr.state[-1],), tr.s[-1], p32).double())
    per_path = {"delta": (pays[2] - pays[0]) / (2.0 * float(h)),
                "gamma": (pays[2] - 2.0 * pays[1] + pays[0])
                / (float(h) * float(h))}
    fd_line = []
    for k, v in per_path.items():
        mean = disc * float(v.mean())
        se = disc * float(v.std()) / math.sqrt(GREEK_STEP_PATHS)
        joint = math.hypot(se, float(gl[f"{k}_stderr"]))
        z = abs(float(gf[k]) - float(gl[k])) / joint
        d_traj = abs(float(gf[k]) - mean) / max(abs(mean), 1e-12)
        fd_line.append(f"{k} fd {float(gf[k]):.6f} +/- {se:.6f} (paths' "
                       f"mean {mean:.6f}, rel {d_traj:.1e}), lrm "
                       f"{float(gl[k]):.6f} +/- {float(gl[k + '_stderr']):.6f}"
                       f": {z:.2f} joint se")
        if not (z <= 3.0 and d_traj <= 1e-6):
            fail(f"the bullet's FD {k} misses LRM, or is not its paths' mean")
    print(f"phase 3: bullet {GREEK_STEP_PATHS}x{MAIN_STEPS} (h = {h:g}): "
          + "; ".join(fd_line))

    # The digital's LRM gamma, the unbiased gamma of a discontinuous payoff.
    gd = mt.greeks(option, gsim, "digital_call", method="lrm",
                   which=("gamma",), device=DEVICE)
    st = option.sigma * math.sqrt(option.t)
    d2 = (math.log(option.s0 / option.k)
          + (option.r - 0.5 * option.sigma ** 2) * option.t) / st
    gamma_cf = (math.exp(-option.r * option.t)
                * math.exp(-0.5 * d2 * d2) / math.sqrt(2 * math.pi)
                * (-d2 / st - 1.0) / (option.s0 * option.s0 * st))
    z = abs(float(gd["gamma"]) - gamma_cf) / float(gd["gamma_stderr"])
    print(f"phase 3: digital_call LRM gamma {GREEK_PATHS} terminal: "
          f"{float(gd['gamma']):.7f} +/- {float(gd['gamma_stderr']):.7f}, "
          f"{z:.2f} se from {gamma_cf:.7f}")
    if not z <= 3.0:
        fail("the digital's LRM gamma misses its closed form")

    # chunked_price: 4 x 2^20 Euler paths in 2^20-path chunks, stopped
    # after chunk 2 (a two-chunk run writes that state) and resumed.
    csim = mt.SimParams(n_paths=N_CHUNKS * CHUNK_PATHS, n_steps=MAIN_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "run.npz")
        full = mt.chunked_price(option, csim, chunk_paths=CHUNK_PATHS,
                                method="euler", device=DEVICE)
        mt.chunked_price(option, csim.replace(n_paths=2 * CHUNK_PATHS),
                         chunk_paths=CHUNK_PATHS, method="euler",
                         checkpoint_path=ck, device=DEVICE)
        mid = load_checkpoint(ck)
        mid.n_paths = csim.n_paths
        mid.save(ck)
        resumed = mt.chunked_price(option, csim, chunk_paths=CHUNK_PATHS,
                                   method="euler", checkpoint_path=ck,
                                   resume=True, device=DEVICE)
        done = load_checkpoint(ck).paths_done
    straight = mt.price(option, csim, method="euler", device=DEVICE)
    bitwise = (float(resumed.price) == float(full.price)
               and float(resumed.stderr) == float(full.stderr))
    d_chunk = abs(float(full.price) - float(straight.price)) / float(
        straight.price)
    print(f"phase 3: chunked_price {N_CHUNKS}x{CHUNK_PATHS}x{MAIN_STEPS}: "
          f"{float(full.price):.9f} +/- {float(full.stderr):.9f}; resumed "
          f"after chunk 2 ({done} paths done): {float(resumed.price):.9f} "
          f"({'bitwise' if bitwise else 'NOT bitwise'}); price(method="
          f"'euler') {float(straight.price):.9f} (rel {d_chunk:.2e})")
    if not (bitwise and d_chunk <= SUMS_RTOL and done == csim.n_paths):
        fail("the resumed chunked run differs from the uninterrupted one or "
             "from price()")

    # The reductions: the 2^20-path call's payoff array through
    # sum_sumsq_pallas and sum_pallas gives price()'s price and stderr;
    # 2^26 normals give their f64 sums and moments.
    n_pay = PAY_ARRAY
    ids = torch.arange(n_pay, dtype=torch.int64, device=dev)
    z0, _ = rng.normal_pair(key[0], key[1], ids, torch.zeros_like(ids))
    pay_arr = call.terminal((), p32.s0 * torch.exp(p32.drift_t
                                                   + p32.vol_t * z0), p32)
    del ids, z0
    s, s2 = reduce.sum_sumsq_pallas(pay_arr)
    s_only = reduce.sum_pallas(pay_arr)
    via = oracle.summarize(s, s2, float(n_pay), disc)
    ref = mt.price(option, mt.SimParams(n_paths=n_pay, n_steps=MAIN_STEPS),
                   method="terminal", device=DEVICE)
    d_red = max(abs(float(via.price) - float(ref.price)) / float(ref.price),
                abs(float(via.stderr) - float(ref.stderr)) / float(ref.stderr),
                abs(float(s_only) - float(s)) / float(s))
    x26 = torch.randn(NORMALS, device=dev, generator=gen)
    n26 = float(x26.numel())
    t_s, t_s2 = reduce.sum_sumsq_pallas(x26)
    lib_s = torch.sum(x26, dtype=torch.float64)
    lib_s2 = torch.sum((x26 * x26).double())
    mean26, var26 = float(t_s) / n26, float(t_s2) / n26 - (float(t_s) / n26) ** 2
    d26 = max(abs(float(t_s) - float(lib_s)) / abs(float(lib_s)),
              abs(float(t_s2) - float(lib_s2)) / float(lib_s2))
    print(f"phase 3: sum_sumsq_pallas over the {n_pay}-path call's payoffs: "
          f"price {float(via.price):.9f} +/- {float(via.stderr):.9f} vs "
          f"price() {float(ref.price):.9f} +/- {float(ref.stderr):.9f}, "
          f"sum_pallas == its sum: max rel {d_red:.2e}; over {NORMALS} normals: "
          f"mean {mean26:.3e}, variance {var26:.6f}, vs torch.sum f64 rel "
          f"{d26:.2e}")
    if not (d_red <= SUMS_RTOL and d26 <= SUMS_RTOL
            and abs(mean26) <= 5.0 / math.sqrt(n26)
            and abs(var26 - 1.0) <= 5.0 * math.sqrt(2.0 / n26)):
        fail("the reductions disagree with price() or torch.sum, or the "
             "normals' moments are off")

    # The GBM path's launches; then the Heston, Merton, Bates, CEV,
    # local-vol, SABR, term, dividend, Vasicek and basket paths, each driven
    # with the counts set to 0 before it and read after it.
    launches = {k: n for k, n in _cuda.launch_counts.items()
                if k not in HESTON_KERNELS + MERTON_KERNELS + BATES_KERNELS
                + CEV_KERNELS + LOCALVOL_KERNELS + SABR_KERNELS
                + TERM_KERNELS + DIVS_KERNELS + VASICEK_KERNELS
                + BASKET_KERNELS + FX_KERNELS + RAINBOW_KERNELS
                + QMC_KERNELS + QMC_MODEL_KERNELS + RATES_ROWS}
    families = ("heston", "merton", "bates", "cev", "localvol", "sabr",
                "term", "divs", "vasicek", "basket")
    lap("the GBM path", 3)
    family_launches, by_scheme = {}, {}
    for family in families:
        with scheme_split(_cuda, family) as split:
            family_launches[family] = family_main_path(mt, dev, _cuda, family,
                                                       e2e_nmc)
        by_scheme[family] = split
        lap(f"the {family} path", 3)
    for path in ("fx", "rainbow", "qmc"):
        family_launches[path] = fx_rainbow_qmc_path(mt, dev, _cuda, path,
                                                  e2e_nmc)
        lap(f"the {path} path", 3)
    qm_e2e = {}
    family_launches["qmc_model"] = qmc_model_path(mt, dev, _cuda, qm_e2e)
    lap("the model-QMC path (each family's block with the counts at 0)", 3)
    rates_e2e = {}
    family_launches["rates"] = rates_path(mt, dev, _cuda, rates_e2e)
    lap("the rates path", 3)
    composed_e2e = []
    family_launches["composed"] = composed_path(mt, dev, _cuda, tag,
                                                composed_e2e)
    lap("the composed entry points (model table, family and CVA greeks, "
        "books)", 3)

    # --- Phase 4: launch counts over phase 3 ----------------------------
    print(f"phase 4: launches over phase 3's GBM path: {launches}")
    for family, path in family_launches.items():
        print(f"phase 4: launches over phase 3's {family} path: {path}")
    for family in ("heston", "bates"):
        print(f"phase 4: {family}_partials launches over phase 3's {family} "
              f"path by scheme (#12's and #16's Euler and QE kernels): "
              f"{by_scheme[family]}")
    if not all(n > 0 for path in (launches, *family_launches.values())
               for n in path.values()):
        fail("a kernel of the main path was never launched")
    launches.update(family_launches["heston"])
    # the kernels line's rows: the family kernels per family (and the
    # generic trajectories' rows under CEV, SABR, term and the basket)
    for family in families[1:] + ("fx", "rainbow", "qmc", "qmc_model",
                                  "rates"):
        for k, n in family_launches[family].items():
            suffixed = (k.startswith("family_i") or k.startswith("family_f")
                        or (family in ("cev", "sabr", "term", "basket",
                                       "rainbow")
                            and k == "family_trajectories"))
            launches[f"{k}_{family}" if suffixed else k] = n
    # the composed entry points launch rows of the GBM and Heston paths
    for k, n in family_launches["composed"].items():
        launches[k] += n

    # --- Phase 5: times -------------------------------------------------
    stamp(5)
    def time_pair(label, kernel_fn, plain_fn, shape):
        """The kernel (REPS reps) beside its plain version (one rep, no
        warm-up: a yardstick of correctness, not of speed)."""
        k_ms, k_sp, k_n = cuda_ms(kernel_fn)
        p_ms, p_sp, p_n = cuda_ms(plain_fn, reps=1, warm=False)
        print(f"phase 5: {label} {shape}: kernel {k_ms:.4f} ms "
              f"(spread {k_sp:.1%}, {REPS} reps of {k_n} calls), plain "
              f"{p_ms:.4f} ms (1 rep of {p_n})"
              f" {tag}")
        return k_ms, p_ms

    cfg_tp = pk.KernelConfig(n_paths=MAIN_PATHS // 2, n_steps=MAIN_STEPS,
                             method="terminal")
    tp_ms = time_pair(
        "terminal_pair",
        lambda: pk.terminal_pair_partials(call, cfg_tp, key, p100, MAIN_PATHS),
        lambda: pk.terminal_pair_partials_plain(call, cfg_tp, key, p100,
                                                MAIN_PATHS),
        f"{MAIN_PATHS} paths")
    cfg_big = pk.KernelConfig(n_paths=TP_BIG // 2, n_steps=MAIN_STEPS,
                              method="terminal")
    tp_big_ms, tp_big_sp, _ = cuda_ms(lambda: pk.terminal_pair_partials(
        call, cfg_big, key, p100, TP_BIG), reps=3)
    tp_big_bound = bound(0, _scale(_add(pair_ops(13), (0, 14, 2)),
                                   TP_BIG // 2))[0]
    print(f"phase 5: terminal_pair {TP_BIG} paths: kernel {tp_big_ms:.4f} ms "
          f"(spread {tp_big_sp:.1%}, 3 reps), {TP_BIG / tp_big_ms * 1e3:.4e} "
          f"paths/s, {tp_big_bound / tp_big_ms:.1%} of its bound "
          f"({tp_big_bound:.4f} ms); {_cuda.load().mc_terminal_pair_elems_per_thread()}"
          f" elements a thread, {tp_occupancy()} blocks/SM {tag}")
    cfg_b = pk.KernelConfig(n_paths=BULLET_PATHS, n_steps=MAIN_STEPS)
    sim_ms = time_pair(
        "simulate_partials bullet euler",
        lambda: pk.simulate_partials(bullet, cfg_b, key, p100),
        lambda: pk.simulate_partials_plain(bullet, cfg_b, key, p100),
        f"{BULLET_PATHS}x{MAIN_STEPS}")
    print(f"phase 5: simulate_partials bullet euler: "
          f"{simulate_layout(bullet, cfg_b)} {tag}")
    # the phase-5 simulate rows' kernel ms, for phase 6's shares
    sim_rows = {"bullet euler": (sim_ms[0], cfg_b, "bullet_call")}
    p_otm = pk.pack_params(otm, MAIN_STEPS, dev)
    for label, cfg, prm in (
            ("simulate_partials call terminal antithetic",
             pk.KernelConfig(n_paths=MAIN_PATHS, n_steps=MAIN_STEPS,
                             method="terminal", antithetic=True), p100),
            ("simulate_partials call euler", pk.KernelConfig(
                n_paths=MAIN_PATHS, n_steps=MAIN_STEPS), p100),
            ("simulate_partials call euler antithetic+cv", pk.KernelConfig(
                n_paths=MAIN_PATHS, n_steps=MAIN_STEPS, antithetic=True,
                with_cv=True), p100),
            ("simulate_partials call K=180 euler IS", pk.KernelConfig(
                n_paths=MAIN_PATHS, n_steps=MAIN_STEPS, is_shift=is_shift),
             p_otm)):
        k_ms, _ = time_pair(
            label,
            lambda cfg=cfg, prm=prm: pk.simulate_partials(call, cfg, key, prm),
            lambda cfg=cfg, prm=prm: pk.simulate_partials_plain(
                call, cfg, key, prm),
            f"{cfg.n_paths}x{cfg.n_steps}")
        print(f"phase 5: {label}: {simulate_layout(call, cfg)} {tag}")
        sim_rows[label.removeprefix("simulate_partials ")] = (
            k_ms, cfg, "vanilla_call")
    start = RESUME_STEPS[0]
    cfg_r = pk.KernelConfig(n_paths=BULLET_PATHS, n_steps=MAIN_STEPS,
                            start_step=start)
    resume = dict(s_init=traj.s[start - 1].contiguous(),
                  state_init=traj.state[start - 1].contiguous())
    k_ms, _ = time_pair(
        f"simulate_partials bullet resumed at step {start}",
        lambda: pk.simulate_partials(bullet, cfg_r, key, p100, **resume),
        lambda: pk.simulate_partials_plain(bullet, cfg_r, key, p100,
                                           **resume),
        f"{BULLET_PATHS}x{MAIN_STEPS}")
    print(f"phase 5: simulate_partials bullet resumed at step {start}: "
          f"{simulate_layout(bullet, cfg_r)} (each path's own threshold) "
          f"{tag}")
    sim_rows[f"bullet resumed at step {start}"] = (k_ms, cfg_r, "bullet_call")
    traj_ms = time_pair(
        "trajectories bullet",
        lambda: pk.simulate_trajectories(bullet, cfg_b, key, p100),
        lambda: pk.simulate_trajectories_plain(bullet, cfg_b, key, p100),
        f"{BULLET_PATHS}x{MAIN_STEPS}")
    grid_bytes = 2 * 4 * BULLET_PATHS * MAIN_STEPS
    print(f"phase 5: trajectories grid writes {grid_bytes / 1e6:.1f} MB in "
          f"{traj_ms[0]:.4f} ms: {grid_bytes / traj_ms[0] / 1e6:.1f} GB/s "
          f"{tag}")

    n_out, n_steps, n_inner = NMC_SMALL
    ncfg_s = nk.NMCConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
    p_s = pk.pack_params(option, n_steps, dev)
    s_s, c_s, _ = pk.simulate_trajectories(bullet, nk.outer_config(ncfg_s),
                                           key, p_s)
    time_pair("nmc_fused",
              lambda: nk.nmc_fused(bullet, ncfg_s, key, key_in, p_s),
              lambda: nk.nmc_fused_plain(bullet, ncfg_s, key, key_in, p_s),
              f"{n_out}x{n_steps}x{n_inner}")
    time_pair("nmc_inner",
              lambda: nk.nmc_inner(bullet, ncfg_s, key_in, p_s, s_s, c_s),
              lambda: nk.nmc_inner_plain(bullet, ncfg_s, key_in, p_s, s_s,
                                         c_s),
              f"{n_out}x{n_steps}x{n_inner}")
    n_out, n_steps, n_inner = NMC_MAIN
    inner_steps = n_out * n_inner * n_steps * (n_steps - 1) // 2
    for name, ms in nmc_main.items():  # the phase-2 calls at NMC_MAIN
        res = build_resources().get((f"{name}_kernel", "BulletCall", None),
                                    {})
        print(f"phase 5: {name} {n_out}x{n_steps}x{n_inner}: kernel "
              f"{ms:.3f} ms (its phase-2 call), "
              f"{inner_steps / ms * 1e3:.4e} inner path-steps/s; bullet: "
              f"kLegs {_cuda.load().mc_nmc_legs()}, registers "
              f"{res.get('registers')}, spill stores/loads "
              f"{res.get('spill_stores')}/{res.get('spill_loads')} B, "
              f"{nk.nmc_occupancy(bullet, name == 'nmc_fused')} blocks/SM "
              f"{tag}")

    # The ladder beside the 17 single-strike launches it replaces.
    cfg_l = pk.KernelConfig(n_paths=LADDER_PATHS, n_steps=MAIN_STEPS,
                            method="terminal")
    ladder_ms = time_pair(
        "ladder call terminal",
        lambda: pk.simulate_ladder_partials(call, cfg_l, key, p100, strikes_t),
        lambda: pk.simulate_ladder_partials_plain(call, cfg_l, key, p100,
                                                  strikes_t),
        f"{LADDER_PATHS} paths x {len(strikes)} strikes")
    p_strikes = [pk.pack_params(mt.OptionParams(k=float(k)), MAIN_STEPS, dev)
                 for k in strikes]
    singles_ms, sp, _ = cuda_ms(lambda: [pk.simulate_partials(
        call, cfg_l, key, prm) for prm in p_strikes])
    print(f"phase 5: {len(strikes)} single-strike simulate_partials launches "
          f"(terminal, {LADDER_PATHS} paths each): {singles_ms:.4f} ms "
          f"(spread {sp:.1%}); the ladder kernel takes "
          f"{ladder_ms[0] / singles_ms:.3f}x their time {tag}")
    # The ladder alone (the library's entry point in batches of >= 5 ms: a
    # call through its wrapper is mostly host time) at M = 1 beside M = 17.
    lib = _cuda.load()
    n_lb = _cuda.cdiv(LADDER_PATHS, lib.mc_ladder_block_paths())
    blocks = ctypes.c_int(0)
    _cuda.check(lib.mc_ladder_occupancy(call.cuda_id, 0, ctypes.byref(blocks)),
                "mc_ladder_occupancy")
    for m in (1, len(strikes)):
        part = torch.empty((n_lb, m, 2), dtype=torch.float64, device=dev)
        args = (call.cuda_id, 0, 0, int(key[0]), int(key[1]), p100.data_ptr(),
                strikes_t.data_ptr(), m, MAIN_STEPS, LADDER_PATHS, 0,
                LADDER_PATHS, part.data_ptr(), n_lb, _cuda.stream_handle(dev))
        ms, sp, batch = cuda_ms(lambda args=args: _cuda.check(
            lib.mc_ladder_partials(*args), "ladder kernel"))
        b_ms, by = ladder_bound("vanilla_call", False, LADDER_PATHS,
                                MAIN_STEPS, m)
        print(f"phase 5: ladder call terminal {LADDER_PATHS} paths x {m} "
              f"strikes, the kernel alone: {ms:.5f} ms (spread {sp:.1%}, "
              f"batches of {batch}), {b_ms / ms:.1%} of its bound "
              f"({b_ms:.5f} ms, {by}); {lib.mc_ladder_block_paths()} paths a "
              f"block, {lib.mc_ladder_paths_per_thread(0)} a thread, "
              f"{lib.mc_ladder_strikes_per_pass(0)} strikes a pass, "
              f"{blocks.value} blocks/SM {tag}")

    # The book beside 64 sequential single-contract launches (its plain
    # version was timed once in phase 2).
    cfg_bk =pk.KernelConfig(n_paths=nb_paths, n_steps=MAIN_STEPS)
    book_ms, sp, _ = cuda_ms(lambda: pk.simulate_book_partials(
        bullet, cfg_bk, key, rows_main))
    seq_ms, sp_seq, _ = cuda_ms(lambda: [pk.simulate_partials(
        bullet, cfg_bk, key, rows_main[b]) for b in range(nb)])
    book_steps = nb * nb_paths * MAIN_STEPS
    lib = _cuda.load()
    blocks = ctypes.c_int(0)
    _cuda.check(lib.mc_book_occupancy(
        bullet.cuda_id, 1, MAIN_STEPS, pk.book_block_threads(cfg_bk),
        ctypes.byref(blocks)), "mc_book_occupancy")
    print(f"phase 5: book bullet {nb} x {nb_paths} x {MAIN_STEPS}: "
          f"{pk.book_block_threads(cfg_bk)} threads a block, {blocks.value} "
          f"blocks/SM, {lib.mc_book_contracts(bullet.cuda_id)} contracts a "
          f"replayed draw {tag}")
    print(f"phase 5: book bullet {nb} x {nb_paths} x {MAIN_STEPS}: kernel "
          f"{book_ms:.4f} ms (spread {sp:.1%}), {book_steps / book_ms * 1e3:.4e}"
          f" contract-path-steps/s; {nb} sequential simulate_partials "
          f"launches {seq_ms:.4f} ms (spread {sp_seq:.1%}): the book takes "
          f"{book_ms / seq_ms:.3f}x the sequential time ({seq_ms / book_ms:.2f}"
          f"x faster); plain {book_plain_ms:.1f} ms (one run) {tag}")

    # The simulate kernel per payoff (100,000 x 100 Euler) and the
    # registers of every instantiation the main path launches.
    regs = ptxas_registers(_cuda.build_info.get("ptxas", ""))
    for name, po in sorted(PAYOFFS.items()):
        struct = type(po).__name__
        prm = pk.pack_params(payoff_option(mt, name), MAIN_STEPS, dev)
        line = (f"registers simulate {regs.get(sim_key(po))}"
                f", ladder {ladder_regs(lib, regs, po)}, book "
                f"{regs.get(('book_kernel', struct, 0))} (CV "
                f"{regs.get(('book_kernel', struct, 1))}, "
                f"{lib.mc_book_contracts(po.cuda_id)} contracts a draw)")
        if not po.terminal_only:
            ms, sp, _ = cuda_ms(lambda po=po, prm=prm: pk.simulate_partials(
                po, cfg_b, key, prm))
            line = (f"simulate_partials {BULLET_PATHS}x{MAIN_STEPS} {ms:.4f} ms"
                    f" (spread {sp:.1%}), " + line)
        print(f"phase 5: {name}: {line} {tag}")

    # The greek kernel beside the simulate kernel on its shape (what the
    # tangents cost): the call over the 1M-path terminal draw, the Asian
    # and the call over 100,000 x 100.
    asian = get_payoff("asian_call")
    greek_ms = {}
    lib = _cuda.load()
    for label, po, cfg in (
            (f"call terminal {GREEK_PATHS} paths", call, pk.KernelConfig(
                n_paths=GREEK_PATHS, n_steps=MAIN_STEPS, method="terminal")),
            (f"asian euler {GREEK_STEP_PATHS}x{MAIN_STEPS}", asian,
             pk.KernelConfig(n_paths=GREEK_STEP_PATHS, n_steps=MAIN_STEPS)),
            (f"call euler {GREEK_STEP_PATHS}x{MAIN_STEPS}", call,
             pk.KernelConfig(n_paths=GREEK_STEP_PATHS, n_steps=MAIN_STEPS))):
        euler = int(cfg.method == "euler")
        if (po.name, euler) == ("vanilla_call", 1):  # no plain time: greek_ms
            # holds the phase-6 rows, the terminal call and the Asian
            g_ms, sp_g, _ = cuda_ms(lambda po=po, cfg=cfg:
                                    pk.simulate_greek_partials(po, cfg, key,
                                                               p100))
            line = f"{g_ms:.4f} ms (spread {sp_g:.1%})"
        else:
            greek_ms[po.name] = time_pair(
                "greek_partials",
                lambda po=po, cfg=cfg: pk.simulate_greek_partials(po, cfg, key,
                                                                  p100),
                lambda po=po, cfg=cfg: pk.simulate_greek_partials_plain(
                    po, cfg, key, p100), label)
            g_ms = greek_ms[po.name][0]
            line = f"{g_ms:.4f} ms"
        sim_only, sp, _ = cuda_ms(lambda po=po, cfg=cfg: pk.simulate_partials(
            po, cfg, key, p100))
        struct = type(po).__name__
        blocks = ctypes.c_int(0)
        _cuda.check(lib.mc_greek_occupancy(po.cuda_id, euler,
                                           ctypes.byref(blocks)),
                    "mc_greek_occupancy")
        b_ms = probe_bound("greek_partials", payoff=po.name,
                           method=cfg.method, n_paths=cfg.n_paths,
                           n_steps=cfg.n_steps)[0]
        print(f"phase 5: greek_partials {label}: {line} = "
              f"{g_ms / sim_only:.2f}x simulate_partials on the same paths "
              f"({sim_only:.4f} ms, spread {sp:.1%}), {b_ms / g_ms:.1%} of "
              f"its bound ({b_ms:.5f} ms); registers greek "
              f"{regs.get(('greek_kernel', struct, (13, euler)))}, "
              f"{lib.mc_greek_paths_per_thread(euler)} paths a thread, "
              f"{blocks.value} blocks/SM; simulate {regs.get(sim_key(po, cfg))} "
              f"{tag}")

    # The reductions beside torch.sum(dtype=float64), the one PyTorch call
    # that computes the sum (and one of sum_sumsq's two moments).
    reduce_ms = {}
    for n, x in ((n_pay, pay_arr), (NORMALS, x26)):
        lib_ms, lib_sp, _ = cuda_ms(lambda x=x: torch.sum(
            x, dtype=torch.float64))
        for name, fn, plain in (
                ("tile_partials", reduce.tile_partials,
                 reduce.tile_partials_plain),
                ("sum_sumsq", reduce.sum_sumsq_partials,
                 reduce.sum_sumsq_partials_plain)):
            k_ms, p_ms = time_pair(name, lambda fn=fn, x=x: fn(x),
                                   lambda plain=plain, x=x: plain(x),
                                   f"{n} f32")
            reduce_ms[name] = (k_ms, p_ms, lib_ms)
            print(f"phase 5: {name} {n} f32: {4 * n / k_ms / 1e6:.1f} GB/s; "
                  f"torch.sum(dtype=float64) {lib_ms:.4f} ms (spread "
                  f"{lib_sp:.1%}, {4 * n / lib_ms / 1e6:.1f} GB/s); registers"
                  f" {regs.get(('sum_kernel', 'bool' + str(int(name == 'sum_sumsq')), None))} "
                  f"{tag}")

    heston_ms = heston_times(mt, dev, keys["heston"], regs, tag, time_pair, {
        "trajectories": traj_ms[0], "nmc_fused": nmc_main["nmc_fused"],
        "nmc_inner": nmc_main["nmc_inner"]}, family_rows_ms, e2e_nmc)
    for name in ("family_fused", "family_inner"):
        heston_ms[name] = (heston_ms[name][0], family_rows_ms["plain"])
    jump_ms = jump_times(mt, dev, keys["merton"], keys["bates"], regs, tag,
                         time_pair, {k: v[0] for k, v in heston_ms.items()},
                         jump_rows_ms, e2e_nmc)
    single_ms = single_times(mt, dev, singles, keys, regs, tag, time_pair, {
        "heston_partials": heston_ms["heston_partials"][0],
        "family_fused_heston": heston_ms["family_fused"][0],
        "family_inner_heston": heston_ms["family_inner"][0],
        "merton_partials": jump_ms["merton_partials"][0],
        "merton_trajectories": jump_ms["merton_trajectories"][0],
        "family_fused_merton": jump_ms["family_fused_merton"][0],
        "family_inner_merton": jump_ms["family_inner_merton"][0]},
        single_rows_ms, e2e_nmc)
    cev_divs_report(mt, dev, keys, tag)
    basket_partials_report(mt, dev, keys["basket"][0],
                           _cuda.build_info.get("ptxas", ""), tag)
    frq_ms = fx_rainbow_qmc_times(
        mt, dev, keys, regs, _cuda.build_info.get("ptxas", ""), tag,
        time_pair, {"terminal_pair": tp_ms[0], **{
            row: single_ms[row][0] for row in (
                "basket_partials", "family_fused_basket",
                "family_inner_basket")}},
        rainbow_nmc_ms, e2e_nmc)
    for name in ("family_fused", "family_inner"):
        row = f"{name}_rainbow"
        frq_ms[row] = (frq_ms[row][0], rainbow_nmc_ms["plain"])
    qm_ms = qmc_model_times(mt, dev, _cuda.build_info.get("ptxas_by_source",
                                                          {}), tag,
                            qm_plain_ms, qm_e2e)
    rates_ms = rates_times(mt, dev, _cuda.build_info.get(
        "ptxas_by_source", {}).get("rates_kernels.cu", ""), tag,
        rates_plain_ms, rates_e2e)
    # the composed entry points: the one timed call of each in phase 3
    e2e_report(composed_e2e, tag)
    # the family kernels' plain ms: their rows in phase 2
    for ms, rows_ms in ((jump_ms, jump_rows_ms), (single_ms, single_rows_ms)):
        for family, nmc_ms in rows_ms.items():
            for name in ("family_fused", "family_inner"):
                row = f"{name}_{family}"
                ms[row] = (ms[row][0], nmc_ms["plain"])

    e2e = (
        ("price() call 1M paths default", "paths/s", MAIN_PATHS,
         lambda: mt.price(option, sim, device=DEVICE)),
        ("price() call K=180 1M paths importance_shift='auto'", "paths/s",
         MAIN_PATHS, lambda: mt.price(otm, sim, importance_shift="auto",
                                      device=DEVICE)),
        (f"price() bullet {BULLET_PATHS}x{MAIN_STEPS}", "path-steps/s",
         BULLET_PATHS * MAIN_STEPS,
         lambda: mt.price(option, bsim, payoff="bullet_call", device=DEVICE)),
        (f"simulate_trajectories() {BULLET_PATHS}x{MAIN_STEPS}",
         "path-steps/s", BULLET_PATHS * MAIN_STEPS,
         lambda: mt.simulate_trajectories(option, bsim, device=DEVICE)),
        *nmc_e2e_rows("gbm", e2e_nmc),
        (f"price_ladder() call {LADDER_PATHS} paths x {len(strikes)} strikes",
         "strike-paths/s", LADDER_PATHS * len(strikes),
         lambda: mt.price_ladder(strikes, option, lsim, device=DEVICE)),
        (f"price_portfolio() bullet {nb} x {nb_paths} x {MAIN_STEPS}",
         "contract-path-steps/s", book_steps,
         lambda: mt.price_portfolio(book64, msim, "bullet_call",
                                    device=DEVICE)),
        (f"greeks() pathwise (fused kernel) call {GREEK_PATHS} terminal",
         "paths/s", GREEK_PATHS,
         lambda: mt.greeks(option, gsim, which=kernel_which, device=DEVICE)),
        (f"greeks() pathwise (fused kernel) asian {GREEK_STEP_PATHS}x"
         f"{MAIN_STEPS}", "path-steps/s", GREEK_STEP_PATHS * MAIN_STEPS,
         lambda: mt.greeks(option, asim, "asian_call", which=kernel_which,
                           device=DEVICE)),
        (f"greeks() pathwise (autograd) call euler {GREEK_STEP_PATHS}x"
         f"{MAIN_STEPS}, default which", "path-steps/s",
         GREEK_STEP_PATHS * MAIN_STEPS,
         lambda: mt.greeks(option, asim, sim_method="euler", device=DEVICE)),
        (f"greeks() fd bullet {GREEK_STEP_PATHS}x{MAIN_STEPS} delta+gamma",
         "path-steps/s", GREEK_STEP_PATHS * MAIN_STEPS,
         lambda: mt.greeks(option, asim, "bullet_call", method="fd",
                           which=("delta", "gamma"), rel_bump=FD_BUMP,
                           device=DEVICE)),
        (f"greeks() lrm bullet {GREEK_STEP_PATHS}x{MAIN_STEPS} delta+gamma",
         "path-steps/s", GREEK_STEP_PATHS * MAIN_STEPS,
         lambda: mt.greeks(option, asim, "bullet_call", method="lrm",
                           which=("delta", "gamma"), device=DEVICE)),
        (f"chunked_price() call euler {N_CHUNKS}x{CHUNK_PATHS}x{MAIN_STEPS}",
         "path-steps/s", csim.n_paths * MAIN_STEPS,
         lambda: mt.chunked_price(option, csim, chunk_paths=CHUNK_PATHS,
                                  method="euler", device=DEVICE)),
        (f"price() call euler {csim.n_paths}x{MAIN_STEPS}", "path-steps/s",
         csim.n_paths * MAIN_STEPS,
         lambda: mt.price(option, csim, method="euler", device=DEVICE)),
    )
    e2e_report(e2e, tag)

    # --- Phase 6: results -----------------------------------------------
    stamp(6)
    nmc_bytes = 4 * n_out * n_steps  # the surface
    nmc_ops = _scale(inner_ops("bullet_call", n_steps, n_inner), n_out)
    # The book: the draws once per path; per contract a step moves w (3)
    # and counts it against the contract's threshold (2), with no expf, and
    # the leg forms S once, at maturity; each block finds each contract's
    # threshold once.
    book_ops = _add(
        _scale(_add(_scale(pair_ops(13), (MAIN_STEPS + 1) // 2),
                    _scale(_add(_scale(_add(NMC_STEP_OPS,
                                            UPDATE_OPS["bullet_call"]),
                                       MAIN_STEPS), SPOT_OPS, TERMINAL_OPS),
                           nb)), nb_paths),
        _scale(THRESHOLD_OPS, nb * _cuda.cdiv(nb_paths, 256)))
    single_ops = {f"{s.family}_partials": _scale(s.path, FAMILY_MAIN)
                  for s in singles if s.family in ("sabr", "cev", "divs")}
    k_dt, _ = jump_kmax()
    lam_dt = mt.DEMO_BATES.lam * mt.DEMO_OPTION.t / MAIN_STEPS
    # the QE kernels (#12's heston_qe_kernel, #16's bates_qe_kernel) at 1M
    # x 100, call and antithetic: (ops, parameter bytes, phase-5 ms)
    qe_rows = {
        "heston_partials qe": (qe_path(MAIN_STEPS), 68, heston_ms["qe"][0]),
        "heston_partials qe antithetic": (qe_path(MAIN_STEPS, legs=2), 68,
                                          heston_ms["qe_anti"][0]),
        "bates_partials qe": (qe_path(MAIN_STEPS, k_dt, lam_dt), 80,
                              jump_ms["bates_qe"][0]),
        "bates_partials qe antithetic": (qe_path(MAIN_STEPS, k_dt, lam_dt, 2),
                                         80, jump_ms["bates_qe_anti"][0])}
    qe_ops = {row: _scale(ops, FAMILY_MAIN)
              for row, (ops, _, _) in qe_rows.items()}
    for row, ops in (("book", book_ops), *single_ops.items(),
                     *qe_ops.items()):
        print(f"phase 6: {row} bound terms: int32 "
              f"{ops[0] / INT32_OPS_PER_S * 1e3:.4f} ms, f32 "
              f"{ops[1] / F32_OPS_PER_S * 1e3:.4f} ms, SFU "
              f"{ops[2] / SFU_OPS_PER_S * 1e3:.4f} ms {tag}")
    # #2's phase-5 rows and #12's Euler call and antithetic call
    # (recounted: S only where the payoff reads it, the barrier payoffs'
    # threshold once a block, or once a resumed path)
    for row, (ms, cfg, name) in sim_rows.items():
        legs = 2 if cfg.antithetic else 1
        if cfg.method == "terminal":
            ops = _scale(_add(pair_ops(13), _scale(_add(
                TERMINAL_DRAW_OPS, TERMINAL_OPS), legs)), cfg.n_paths)
        else:
            ops = _scale(simulate_path_ops(
                name, cfg.n_steps - cfg.start_step, cfg.rng_rounds, legs),
                cfg.n_paths)
            if cfg.start_step:
                ops = _add(ops, _scale(THRESHOLD_OPS, cfg.n_paths))
            else:
                ops = _add(ops, simulate_block_ops(name, cfg.n_paths))
            if cfg.is_shift:  # a shifted draw a leg-step, a weight a leg
                ops = _add(ops, _scale((0, 1, 0),
                                       legs * cfg.n_steps * cfg.n_paths),
                           _scale((0, 6, 1), legs * cfg.n_paths))
        if cfg.with_cv:
            ops = _add(ops, _scale((0, 4, 0), cfg.n_paths))
        b_ms, b_by = bound(60, ops)
        print(f"phase 6: simulate_partials {row} {cfg.n_paths}x"
              f"{cfg.n_steps}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"int32 {ops[0] / INT32_OPS_PER_S * 1e3:.4f}, f32 "
              f"{ops[1] / F32_OPS_PER_S * 1e3:.4f}, SFU "
              f"{ops[2] / SFU_OPS_PER_S * 1e3:.4f} ms), {b_ms / ms:.1%} of it "
              f"{tag}")
    for row, legs in (("heston_partials", 1), ("euler_anti", 2)):
        ops = _scale(heston_euler_path("vanilla_call", MAIN_STEPS, legs),
                     FAMILY_MAIN)
        b_ms, b_by = bound(68, ops)
        ms = heston_ms[row][0]
        print(f"phase 6: heston_partials euler{' antithetic' * (legs - 1)} "
              f"{FAMILY_MAIN}x{MAIN_STEPS}: {ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; int32 {ops[0] / INT32_OPS_PER_S * 1e3:.4f}, f32 "
              f"{ops[1] / F32_OPS_PER_S * 1e3:.4f}, SFU "
              f"{ops[2] / SFU_OPS_PER_S * 1e3:.4f} ms), {b_ms / ms:.1%} of it "
              f"{tag}")
    # their phase-5 times against their bounds
    for row, (_, n_bytes, ms) in qe_rows.items():
        b_ms, b_by = bound(n_bytes, qe_ops[row])
        print(f"phase 6: {row} {FAMILY_MAIN}x{MAIN_STEPS}: {ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it {tag}")
    outer_ops = _scale(path_ops("bullet_call", n_steps, 13), n_out)
    bounds = {
        "terminal_pair": bound(
            0, _scale(_add(pair_ops(13), (0, 14, 2)), MAIN_PATHS // 2)),
        "simulate_partials": bound(0, _add(
            _scale(simulate_path_ops("bullet_call", MAIN_STEPS), BULLET_PATHS),
            simulate_block_ops("bullet_call", BULLET_PATHS))),
        "trajectories": bound(
            grid_bytes,
            _scale(path_ops("bullet_call", MAIN_STEPS, 13), BULLET_PATHS)),
        "nmc_fused": bound(nmc_bytes, _add(nmc_ops, outer_ops)),
        "nmc_inner": bound(3 * nmc_bytes, nmc_ops),
        # one terminal draw per path, then the payoff at each strike
        "ladder": ladder_bound("vanilla_call", False, LADDER_PATHS,
                               MAIN_STEPS, len(strikes)),
        "book": bound(60 * nb + 16 * nb * _cuda.cdiv(nb_paths, 256),
                      book_ops),
        # the Asian's path and its tangents
        "greek_partials": bound(0, _scale(_add(
            path_ops("asian_call", MAIN_STEPS, 13),
            _scale(GREEK_STEP_OPS, MAIN_STEPS), GREEK_TERMINAL_OPS),
            GREEK_STEP_PATHS)),
        # each element read once; one f64 add (and an f32 square and an add)
        "tile_partials": bound(4 * n26, (0, 0, 0), n26),
        "sum_sumsq": bound(4 * n26, (0, n26, 0), 2 * n26),
        **heston_bounds(),
        **jump_bounds(),
        **single_bounds(singles),
        **fx_rainbow_qmc_bounds(),
        **qmc_model_bounds(),
        **rates_bounds(),
    }
    nmc_shape = "x".join(map(str, NMC_MAIN))
    rows = (
        ("terminal_pair", "path_kernels.cu", "ops/path_kernels.py:1015",
         tp_err, tp_ms, f"{MAIN_PATHS} paths"),
        ("simulate_partials", "simulate.cuh", "ops/path_kernels.py:395",
         sim_err, sim_ms, f"bullet {BULLET_PATHS}x{MAIN_STEPS}"),
        ("trajectories", "path_kernels.cu", "ops/path_kernels.py:524",
         traj_err, traj_ms, f"bullet {BULLET_PATHS}x{MAIN_STEPS}"),
        ("nmc_fused", "nmc_kernels.cu", "ops/nmc_kernels.py:264", fused_err,
         (nmc_main["nmc_fused"], fused_plain_ms),
         f"bullet {nmc_shape} (plain: trajectories and rows "
         f"{list(NMC_ROWS)})"),
        ("nmc_inner", "nmc_kernels.cu", "ops/nmc_kernels.py:338", inner_err,
         (nmc_main["nmc_inner"], inner_plain_ms),
         f"bullet {nmc_shape} (plain: rows {list(NMC_ROWS)})"),
        ("ladder", "batch_kernels.cu", "ops/path_kernels.py:634", ladder_err,
         ladder_ms, f"call terminal {LADDER_PATHS} x {len(strikes)} strikes"),
        ("book", "batch_kernels.cu", "ops/path_kernels.py:760", book_err,
         (book_ms, book_plain_ms), f"bullet {nb} x {nb_paths} x {MAIN_STEPS}"),
        ("greek_partials", "greek_kernels.cu", "ops/path_kernels.py:932",
         greek_err, greek_ms["asian_call"],
         f"asian {GREEK_STEP_PATHS}x{MAIN_STEPS}"),
        ("tile_partials", "reduce_kernels.cu", "ops/reduce.py:78",
         reduce_err["tile_partials"], reduce_ms["tile_partials"][:2],
         f"{int(n26)} f32"),
        ("sum_sumsq", "reduce_kernels.cu", "ops/reduce.py:195",
         reduce_err["sum_sumsq"], reduce_ms["sum_sumsq"][:2],
         f"{int(n26)} f32"),
        ("heston_partials", "heston_kernels.cu", "models/heston.py:332",
         heston_err["heston_partials"], heston_ms["heston_partials"],
         f"call euler {FAMILY_MAIN}x{MAIN_STEPS}"),
        ("heston_trajectories", "family_nmc_kernels.cu", "models/heston.py:527",
         heston_err["heston_trajectories"], heston_ms["heston_trajectories"],
         f"bullet {HESTON_PAYOFF_MAIN}x{MAIN_STEPS}"),
        ("family_inner", "family_nmc_kernels.cu", "nmc_engine.py:314",
         heston_err["family_inner"], heston_ms["family_inner"],
         f"heston call {nmc_shape} (plain: rows {list(EARLIER_NMC_ROWS)})"),
        ("family_fused", "family_nmc_kernels.cu", "nmc_engine.py:407",
         heston_err["family_fused"], heston_ms["family_fused"],
         f"heston call {nmc_shape} (plain: rows {list(EARLIER_NMC_ROWS)})"),
        ("merton_partials", "merton_kernels.cu", "models/merton.py:278",
         jump_err["merton_partials"], jump_ms["merton_partials"],
         f"call euler {FAMILY_MAIN}x{MAIN_STEPS}"),
        ("merton_trajectories", "merton_nmc_kernels.cu",
         "models/merton.py:392",
         jump_err["merton_trajectories"], jump_ms["merton_trajectories"],
         f"call {NMC_MAIN[0]}x{NMC_MAIN[1]}"),
        ("bates_partials", "bates_kernels.cu", "models/bates.py:257",
         jump_err["bates_partials"], jump_ms["bates_partials"],
         f"call euler {FAMILY_MAIN}x{MAIN_STEPS}"),
        ("family_trajectories", "bates_nmc_kernels.cu",
         "nmc_engine.py:445 (no Pallas counterpart: the XLA scan "
         "xla_family_trajectories)",
         jump_err["family_trajectories"], jump_ms["family_trajectories"],
         f"bates call {NMC_MAIN[0]}x{NMC_MAIN[1]}"),
    ) + tuple(
        (f"{name}_{family}", f"{family}_nmc_kernels.cu", tpu,
         jump_err[f"{name}_{family}"], jump_ms[f"{name}_{family}"],
         f"{family} call {nmc_shape} (plain: rows {list(EARLIER_NMC_ROWS)})")
        for family in ("merton", "bates")
        for name, tpu in (("family_inner", "nmc_engine.py:314"),
                          ("family_fused", "nmc_engine.py:407")))
    for sf in singles:  # partials, trajectories, inner, fused, grid
        srcs = (sf.partials_src or f"{sf.family}_kernels.cu",) + (
            f"{sf.family}_nmc_kernels.cu",) * 3
        tpus = (sf.tpu,) + ((sf.nmc.traj_tpu, "nmc_engine.py:314",
                             "nmc_engine.py:407") if sf.nmc else ())
        shapes = (spaced("call", sf.timed[0][0],
                        f"{FAMILY_MAIN}x{MAIN_STEPS}"),
                  f"{sf.family} call {NMC_MAIN[0]}x{NMC_MAIN[1]}") + (
            f"{sf.family} call {nmc_shape} (plain: rows "
            f"{list(EARLIER_NMC_ROWS)})",
        ) * 2
        if sf.grid is not None:  # after the NMC's three rows, beside its
            srcs = srcs + srcs[:1]  # partials kernel
            tpus = tpus + (sf.grid.tpu,)
            shapes = shapes + (spaced("call", sf.timed[0][0],
                                      f"{sf.grid.n_paths}x{MAIN_STEPS}"),)
        rows += tuple((row, src, tpu, single_err[row], single_ms[row], shape)
                      for row, src, tpu, shape in zip(
                          single_rows(sf), srcs, tpus, shapes))
    rows += tuple(
        (row, src, tpu, frq_err[row], frq_ms[row], shape)
        for row, src, tpu, shape in (
            ("fx_partials", "fx_kernels.cu", "models/fx.py:208",
             f"quanto_call {FAMILY_MAIN} paths"),
            ("rainbow_partials", "rainbow_partials.cuh",
             "models/rainbow.py:135", f"call_on_max d=4 {FAMILY_MAIN} paths"),
            ("family_trajectories_rainbow", "rainbow_nmc_kernels.cu",
             "nmc_engine.py:445 (no Pallas counterpart: the XLA scan "
             "xla_family_trajectories)",
             f"rainbow call d=4 {NMC_MAIN[0]}x{NMC_MAIN[1]}"),
            ("family_inner_rainbow", "rainbow_nmc_kernels.cu",
             "nmc_engine.py:314",
             f"rainbow call d=4 {nmc_shape} (plain: rows {list(NMC_ROWS)})"),
            ("family_fused_rainbow", "rainbow_nmc_kernels.cu",
             "nmc_engine.py:407",
             f"rainbow call d=4 {nmc_shape} (plain: rows {list(NMC_ROWS)})"),
            ("qmc_sums", "qmc_kernels.cu", "qmc.py:463",
             f"asian euler lattice 1048573x{MAIN_STEPS}x{QMC_SHIFTS}"),
            ("qmc_bridge_sums", "qmc_kernels.cu", "qmc.py:403",
             f"asian bridge lattice 1048573x{MAIN_STEPS}x{QMC_SHIFTS}")))
    rows += tuple(
        (row, f"qmc_{model}_kernels.cu", "qmc.py:824", qm_err[row], qm_ms[row],
         f"{model} call sobol {QMC_POINTS}x{MAIN_STEPS}x{QMC_SHIFTS} (plain: "
         f"{1 << QMC_SMALL.bit_length() - 1}x{MAIN_STEPS}x{QMC_CHECK_SHIFTS})")
        for model, row in zip(QMC_MODEL_FAMILIES, QMC_MODEL_ROWS))
    rows += tuple(
        (row, "rates_kernels.cu", "ops/_pallas.py:107", rates_err[row],
         rates_ms[row], f"{tile} demo payer {RATES_PATHS} paths n=10")
        for tile, row in zip(RATES_TILES, RATES_ROWS))
    kernels = []
    for name, src, tpu, err, (k_ms, p_ms), shape in rows:
        b_ms, b_by = bounds[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"mc_tpu_torch/csrc/{src}",
            replaces=f"mc_tpu/{tpu}", launches=launches[name],
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
            bound_by=b_by,
            library_ms=reduce_ms[name][2] if name in reduce_ms else None,
            shape=shape))
    print(f"phase 6: done {time.perf_counter() - t_start:.1f} s into the run,"
          f" {process_seconds():.1f} s after the process started")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
