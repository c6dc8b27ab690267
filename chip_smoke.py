"""Run mc_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

from the root of a checkout.  It drives ``mc_tpu_torch`` only (never JAX or
``mc_tpu``) through six phases and exits nonzero at the first failure:

1. the card (``nvidia-smi`` name and power limit) and the build of
   ``mc_tpu_torch/csrc`` with ``nvcc``;
2. each of the seven CUDA kernels against its plain PyTorch version on the
   card, same key, with the tolerances of the parity contract, at the
   contract's sizes and at the main path's shapes: the simulate kernel for
   all 18 payoffs (with resume, multi-word resume, importance sampling and
   the geometric control variate too), the terminal kernels for the six
   terminal-only payoffs, trajectories and both NMC kernels for the payoffs
   with one state word, the strike ladder and the batched book;
3. the main path at the size users run: the 1M-path European call by five
   methods and with importance sampling against Black-Scholes, every
   payoff at 1M paths (terminal-only) or 100,000 x 100 steps against its
   closed form or its parity identity, the 100k x 100-step bullet, the
   100k x 100 trajectories and a resume from their step 50, the
   16,384 x 100 x 500 nested-MC surface by both strategies with its
   exposure and XVA figures, the 17-strike ladder at 1M paths and the
   64-contract x 2^20-path x 100-step book;
4. the kernels' launch counts over phase 3;
5. kernel and plain-version times with CUDA events (median of >= 5 runs
   after a warm-up), the ladder and the book beside the single-contract
   launches they replace, the simulate kernel per payoff with its
   registers, and end-to-end times of the phase-3 calls;
6. one JSON line of per-kernel results (with each kernel's bound), then the
   JSON status line.

Without a CUDA device it prints no result and exits 2.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import sys
import time

import numpy as np
import torch

# Phase-2 (kernel vs plain) and phase-3 (main path) sizes.
TP_PATHS = 1 << 20
TERM_PATHS = 1 << 18
EULER_PATHS, EULER_STEPS = 1 << 16, 100
NMC_SMALL = (2048, 16, 64)          # outer paths, steps, inner paths
MAIN_PATHS, MAIN_STEPS = 1_000_000, 100
BULLET_PATHS = 100_000
TRAJ_PATHS = (65_536, BULLET_PATHS)
RESUME_STEPS = (50, 51)             # even and odd resume points
IS_STRIKE = 180.0                   # deep out of the money: IS pays off
NMC_MAIN = (16384, 100, 500)        # README quickstart: 4.1e10 inner steps
PAYOFF_PATHS = 65_536                # phase 2: every payoff, 100 steps
LADDER_STRIKES = (60.0, 140.0, 17)   # linspace: the CLI's vol-surface row
LADDER_PATHS = 1_000_000
BOOK_SMALL = (16, 1 << 16)           # phase 2: contracts, paths (100 steps)
BOOK_MAIN = (64, 1 << 20)            # bench.py:586-609 book64 (100 steps)
REPS = 5
DEVICE = "cuda"

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

# The least time of a kernel: the larger of its bytes over the memory rate
# and its operations over the issue rate of their type.  H100 SXM: 3.35 TB/s
# and 67 TFLOP/s f32 (NVIDIA's H100 datasheet); that f32 rate is 132
# SMs x 128 lanes x 2 (an FMA) at 1.98 GHz, and the same SMs issue 64 int32
# lanes and 16 special-function (transcendental) lanes per clock.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SFU_OPS_PER_S = 132 * 16 * 1.98e9


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
              "bullet_call": (0, 2, 0)}   # count += (s < B)
TERMINAL_OPS = (0, 3, 0)   # payoff and pay^2
TERMINAL_DRAW_OPS = (0, 3, 1)  # S_T = s0 * exp(drift_t + vol_t * z)


def path_ops(payoff: str, n_steps: int, rounds: int):
    """A log-Euler path of n_steps and its payoff."""
    return _add(_scale(pair_ops(rounds), (n_steps + 1) // 2),
                _scale(_add(STEP_OPS, UPDATE_OPS[payoff]), n_steps),
                TERMINAL_OPS)


def inner_ops(payoff: str, n_steps: int, n_inner: int):
    """The inner sweeps of one outer path over all its steps: at step j,
    n_inner paths of the n_steps-j-1 remaining steps (threefry-13)."""
    total = (0, 0, 0)
    for j in range(n_steps):
        rem = n_steps - j - 1
        one = _add(_scale(pair_ops(13), (rem + 1) // 2),
                   _scale(_add(STEP_OPS, UPDATE_OPS[payoff]), rem),
                   (0, 2, 0))
        total = _add(total, _scale(one, n_inner), (0, 3, 1))  # mean, discount
    return total


def bound(n_bytes: float, ops):
    """(bound_ms, bound_by) of one call moving n_bytes and doing ops."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(ops[0] / INT32_OPS_PER_S, ops[1] / F32_OPS_PER_S,
                ops[2] / SFU_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --- timing ----------------------------------------------------------------


def cuda_ms(fn, reps: int = REPS, min_ms: float = 5.0):
    """Device time of one call of fn in ms: median over reps, relative
    spread, and the calls batched into each timed rep (enough back-to-back
    calls that a rep lasts at least min_ms, so launch jitter averages out).
    """
    def timed(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    fn()  # warm-up
    torch.cuda.synchronize()
    inner = max(1, math.ceil(min_ms / max(timed(1), 1e-3)))
    times = [timed(inner) for _ in range(reps)]
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med, inner


def wall_s(fn):
    """Host-clock seconds of fn, ended by a synchronize (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def share(mask) -> float:
    return float(mask.double().mean())


def ptxas_registers(log: str) -> dict:
    """{(kernel, payoff struct, rounds or None): registers} from the
    ``-Xptxas -v`` log: each "Compiling entry function" line names a
    mangled mc::kernel<Payoff[, ROUNDS]>, its "Used N registers" follows."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN2mc(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            kernel, rest = m.group(2)[:n], m.group(2)[n:]
            p = re.match(r"INS_(\d+)", rest)
            payoff = rest[p.end():p.end() + int(p.group(1))] if p else None
            r = re.search(r"ELi(\d+)E", rest)
            entry = (kernel, payoff, int(r.group(1)) if r else None)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = int(m.group(1))
            entry = None
    return out


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing run", file=sys.stderr)
        return 2

    import mc_tpu_torch as mt
    from mc_tpu_torch import engines, oracle, rng
    from mc_tpu_torch.ops import _cuda
    from mc_tpu_torch.ops import nmc_kernels as nk
    from mc_tpu_torch.ops import path_kernels as pk
    from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff
    from mc_tpu_torch.ops.reduce import finish_sum
    from mc_tpu_torch.oracle import bs_call
    from mc_tpu_torch.utils import nvidia_smi_name_power

    dev = torch.device(DEVICE)
    card = nvidia_smi_name_power()
    kind = torch.cuda.get_device_name(0)
    tag = f"[{card}]"

    # --- Phase 1: device and build -------------------------------------
    print(card)
    print(f"phase 1: torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s); device 0 = {kind}")
    t0 = time.perf_counter()
    _cuda.load()
    print(f"phase 1: built and loaded {_cuda.build_info['path']} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{_cuda.build_info.get('seconds') or 0.0:.1f} s)")
    for line in _cuda.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"phase 1: ptxas {line.strip()}")

    option = mt.DEMO_OPTION
    otm = mt.OptionParams(k=IS_STRIKE)
    is_shift = math.log(IS_STRIKE / option.s0) / option.sigma  # S_T at K
    call, bullet = get_payoff("vanilla_call"), get_payoff("bullet_call")
    key = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER))
    key_in = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_INNER))
    p100 = pk.pack_params(option, MAIN_STEPS, dev)

    def payoff_option(name):
        return mt.OptionParams(**PAYOFF_OPTIONS.get(name, {}))

    # --- Phase 2: each kernel against its plain version ----------------
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
        inner_err = surface_check(
            f"nmc_inner {label}", nk.nmc_inner(po, cfg, key_in, prm, s, c),
            nk.nmc_inner_plain(po, cfg, key_in, prm, s, c))
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

    def nmc_main_case(shape):
        """Both NMC kernels against one plain run at the main shape: the
        plain fused version IS the plain trajectories + plain inner sweep,
        so one plain run (tens of seconds) checks and times both kernels."""
        n_out, n_steps, n_inner = shape
        cfg = nk.NMCConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
        prm = pk.pack_params(option, n_steps, dev)
        label = "x".join(map(str, shape))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_p, c_p, outer_p = pk.simulate_trajectories_plain(
            bullet, nk.outer_config(cfg), key, prm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        surf_p = nk.nmc_inner_plain(bullet, cfg, key_in, prm, s_p, c_p)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"phase 2: nmc plain {label}: trajectories {t1 - t0:.3f} s, "
              f"inner sweep {t2 - t1:.3f} s (host clock, one run)")
        surf_k, outer_k = nk.nmc_fused(bullet, cfg, key, key_in, prm)
        err = surface_check(f"nmc_fused {label}", surf_k, surf_p)
        err = max(err, outer_check(f"nmc_fused {label}", outer_k, outer_p,
                                   n_out))
        inner_err = surface_check(
            f"nmc_inner {label} (on the plain grids)",
            nk.nmc_inner(bullet, cfg, key_in, prm, s_p, c_p), surf_p)
        return err, inner_err, (t2 - t0) * 1e3, (t2 - t1) * 1e3

    # At the sizes of the parity contract, then at the main path's shapes.
    tp_err = max(terminal_pair_case(TP_PATHS), terminal_pair_case(MAIN_PATHS))
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
    fused_err, inner_err = nmc_small_cases(NMC_SMALL)
    err_f, err_i, fused_plain_ms, inner_plain_ms = nmc_main_case(NMC_MAIN)
    fused_err, inner_err = max(fused_err, err_f), max(inner_err, err_i)

    # Every payoff through the simulate kernel (Euler, 100 steps); the six
    # terminal-only ones through both terminal kernels at 1M paths; the
    # geometric control variate with antithetic; multi-word resume.
    for name, po in sorted(PAYOFFS.items()):
        opt = payoff_option(name)
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
            vanilla_check, payoff_option(name), s_init=s_res.contiguous(),
            state_init=tuple(w.contiguous() for w in words)))

    # Trajectories for every payoff with one state word (the bullet ran
    # above); both NMC kernels for a discrete barrier and the Asian.
    for name, po in sorted(PAYOFFS.items()):
        if po.n_state <= 1 and name != "bullet_call":
            traj_err = max(traj_err, traj_case(PAYOFF_PATHS, "threefry13", po,
                                               payoff_option(name)))
    for name in ("down_out_call", "asian_call"):
        err_f, err_i = nmc_small_cases(NMC_SMALL, get_payoff(name),
                                       payoff_option(name))
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
    nb, nb_paths = BOOK_SMALL
    rows_small = pk.pack_params_rows(book_options(mt, nb), MAIN_STEPS, dev)
    book_err = max(book_case(po, pk.KernelConfig(
        n_paths=nb_paths, n_steps=MAIN_STEPS, **kw), rows_small)[0]
        for po, kw in ((bullet, {}), (bullet, dict(antithetic=True)),
                       (call, dict(with_cv=True))))
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

    # --- Phase 3: the main path at a size users run --------------------
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

    res_g = mt.price_nmc(option, nsim, strategy="grid", device=DEVICE)
    g_close = share(torch.isclose(res_g.surface, res.surface, rtol=SURF_TOL,
                                  atol=SURF_TOL))
    spot_ok = bool(torch.equal(res_g.spot_matrix(), ntraj.path_matrix()))
    print(f"phase 3: nmc strategy='grid': {share(res_g.surface == res.surface):.6f}"
          f" of points bitwise equal to 'fused', {g_close:.6f} within "
          f"rtol=atol={SURF_TOL} (need {SURF_FRAC}); surface mean "
          f"{float(res_g.surface_mean):.7f} vs {float(res.surface_mean):.7f}; "
          f"spot_matrix() == trajectories: {spot_ok}")
    if not (g_close >= SURF_FRAC and spot_ok
            and abs(float(res_g.surface_mean) - float(res.surface_mean))
            <= SURF_MEAN_RTOL * abs(float(res.surface_mean))):
        fail("the grid strategy disagrees with the fused one")

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
        res = mt.price(payoff_option(name), sim if po.terminal_only else bsim,
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
    van = mt.price(payoff_option("down_out_call"), bsim, "vanilla_call",
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

    # --- Phase 4: launch counts over phase 3 ----------------------------
    launches = dict(_cuda.launch_counts)
    print(f"phase 4: launches over phase 3: {launches}")
    if not all(launches[k] > 0 for k in _cuda.KERNELS):
        fail("a kernel of the main path was never launched")

    # --- Phase 5: times -------------------------------------------------
    def time_pair(label, kernel_fn, plain_fn, shape):
        k_ms, k_sp, k_n = cuda_ms(kernel_fn)
        p_ms, p_sp, p_n = cuda_ms(plain_fn)
        print(f"phase 5: {label} {shape}: kernel {k_ms:.4f} ms "
              f"(spread {k_sp:.1%}, {REPS} reps of {k_n} calls), plain "
              f"{p_ms:.4f} ms (spread {p_sp:.1%}, {REPS} reps of {p_n}) {tag}")
        return k_ms, p_ms

    cfg_tp = pk.KernelConfig(n_paths=MAIN_PATHS // 2, n_steps=MAIN_STEPS,
                             method="terminal")
    tp_ms = time_pair(
        "terminal_pair",
        lambda: pk.terminal_pair_partials(call, cfg_tp, key, p100, MAIN_PATHS),
        lambda: pk.terminal_pair_partials_plain(call, cfg_tp, key, p100,
                                                MAIN_PATHS),
        f"{MAIN_PATHS} paths")
    cfg_b = pk.KernelConfig(n_paths=BULLET_PATHS, n_steps=MAIN_STEPS)
    sim_ms = time_pair(
        "simulate_partials bullet euler",
        lambda: pk.simulate_partials(bullet, cfg_b, key, p100),
        lambda: pk.simulate_partials_plain(bullet, cfg_b, key, p100),
        f"{BULLET_PATHS}x{MAIN_STEPS}")
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
        time_pair(label,
                  lambda cfg=cfg, prm=prm: pk.simulate_partials(call, cfg, key,
                                                                prm),
                  lambda cfg=cfg, prm=prm: pk.simulate_partials_plain(
                      call, cfg, key, prm),
                  f"{cfg.n_paths}x{cfg.n_steps}")
    start = RESUME_STEPS[0]
    cfg_r = pk.KernelConfig(n_paths=BULLET_PATHS, n_steps=MAIN_STEPS,
                            start_step=start)
    resume = dict(s_init=traj.s[start - 1].contiguous(),
                  state_init=traj.state[start - 1].contiguous())
    time_pair(f"simulate_partials bullet resumed at step {start}",
              lambda: pk.simulate_partials(bullet, cfg_r, key, p100, **resume),
              lambda: pk.simulate_partials_plain(bullet, cfg_r, key, p100,
                                                 **resume),
              f"{BULLET_PATHS}x{MAIN_STEPS}")
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
    ncfg_m = nk.NMCConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
    p_m = pk.pack_params(option, n_steps, dev)
    inner_steps = n_out * n_inner * n_steps * (n_steps - 1) // 2
    nmc_main = {}
    for name, fn in (
            ("nmc_fused", lambda: nk.nmc_fused(bullet, ncfg_m, key, key_in,
                                               p_m)),
            ("nmc_inner", lambda: nk.nmc_inner(bullet, ncfg_m, key_in, p_m,
                                               ntraj.s, ntraj.state)),
            ("nmc_inner", lambda: nk.nmc_inner(bullet, ncfg_m, key_in, p_m,
                                               ntraj.s, ntraj.state)),
            ("nmc_fused", lambda: nk.nmc_fused(bullet, ncfg_m, key, key_in,
                                               p_m))):
        ms, sp, _ = cuda_ms(fn)  # in turns: fused, inner, inner, fused
        nmc_main.setdefault(name, []).append(ms)
        print(f"phase 5: {name} {n_out}x{n_steps}x{n_inner}: kernel "
              f"{ms:.3f} ms (spread {sp:.1%}), "
              f"{inner_steps / ms * 1e3:.4e} inner path-steps/s {tag}")
    nmc_main = {k: statistics.median(v) for k, v in nmc_main.items()}

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

    # The book beside 64 sequential single-contract launches (its plain
    # version was timed once in phase 2).
    cfg_bk =pk.KernelConfig(n_paths=nb_paths, n_steps=MAIN_STEPS)
    book_ms, sp, _ = cuda_ms(lambda: pk.simulate_book_partials(
        bullet, cfg_bk, key, rows_main))
    seq_ms, sp_seq, _ = cuda_ms(lambda: [pk.simulate_partials(
        bullet, cfg_bk, key, rows_main[b]) for b in range(nb)])
    book_steps = nb * nb_paths * MAIN_STEPS
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
        prm = pk.pack_params(payoff_option(name), MAIN_STEPS, dev)
        line = (f"registers simulate {regs.get(('simulate_kernel', struct, 13))}"
                f", ladder {regs.get(('ladder_kernel', struct, None))}, book "
                f"{regs.get(('book_kernel', struct, None))}")
        if not po.terminal_only:
            ms, sp, _ = cuda_ms(lambda po=po, prm=prm: pk.simulate_partials(
                po, cfg_b, key, prm))
            line = (f"simulate_partials {BULLET_PATHS}x{MAIN_STEPS} {ms:.4f} ms"
                    f" (spread {sp:.1%}), " + line)
        print(f"phase 5: {name}: {line} {tag}")

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
        (f"price_nmc() fused {n_out}x{n_steps}x{n_inner}",
         "inner path-steps/s", inner_steps,
         lambda: mt.price_nmc(option, nsim, device=DEVICE)),
        (f"price_nmc() grid {n_out}x{n_steps}x{n_inner}",
         "inner path-steps/s", inner_steps,
         lambda: mt.price_nmc(option, nsim, strategy="grid", device=DEVICE)),
        (f"price_ladder() call {LADDER_PATHS} paths x {len(strikes)} strikes",
         "strike-paths/s", LADDER_PATHS * len(strikes),
         lambda: mt.price_ladder(strikes, option, lsim, device=DEVICE)),
        (f"price_portfolio() bullet {nb} x {nb_paths} x {MAIN_STEPS}",
         "contract-path-steps/s", book_steps,
         lambda: mt.price_portfolio(book64, msim, "bullet_call",
                                    device=DEVICE)),
    )
    for label, unit, work, fn in e2e:
        secs = sorted(wall_s(fn) for _ in range(REPS))
        med = statistics.median(secs)
        print(f"phase 5: e2e {label}: median {med * 1e3:.4f} ms over {REPS} "
              f"(min {secs[0] * 1e3:.4f}, max {secs[-1] * 1e3:.4f}), "
              f"{work / med:.4e} {unit} {tag}")

    # --- Phase 6: results -----------------------------------------------
    nmc_bytes = 4 * n_out * n_steps  # the surface
    nmc_ops = _scale(inner_ops("bullet_call", n_steps, n_inner), n_out)
    outer_ops = _scale(path_ops("bullet_call", n_steps, 13), n_out)
    bounds = {
        "terminal_pair": bound(
            0, _scale(_add(pair_ops(13), (0, 14, 2)), MAIN_PATHS // 2)),
        "simulate_partials": bound(
            0, _scale(path_ops("bullet_call", MAIN_STEPS, 13), BULLET_PATHS)),
        "trajectories": bound(
            grid_bytes,
            _scale(path_ops("bullet_call", MAIN_STEPS, 13), BULLET_PATHS)),
        "nmc_fused": bound(nmc_bytes, _add(nmc_ops, outer_ops)),
        "nmc_inner": bound(3 * nmc_bytes, nmc_ops),
        # one terminal draw per path, then the payoff at each strike
        "ladder": bound(
            60 + 4 * len(strikes)
            + 16 * len(strikes) * _cuda.cdiv(LADDER_PATHS, 256),
            _scale(_add(pair_ops(13), TERMINAL_DRAW_OPS,
                        _scale(TERMINAL_OPS, len(strikes))), LADDER_PATHS)),
        # the draws once per path, the step loop once per contract
        "book": bound(
            60 * nb + 16 * nb * _cuda.cdiv(nb_paths, 256),
            _scale(_add(_scale(pair_ops(13), (MAIN_STEPS + 1) // 2),
                        _scale(_add(_scale(_add(STEP_OPS,
                                                UPDATE_OPS["bullet_call"]),
                                           MAIN_STEPS), TERMINAL_OPS), nb)),
                   nb_paths)),
    }
    rows = (
        ("terminal_pair", "path_kernels.cu", "path_kernels.py:1015", tp_err,
         tp_ms, f"{MAIN_PATHS} paths"),
        ("simulate_partials", "path_kernels.cu", "path_kernels.py:395",
         sim_err, sim_ms, f"bullet {BULLET_PATHS}x{MAIN_STEPS}"),
        ("trajectories", "path_kernels.cu", "path_kernels.py:524", traj_err,
         traj_ms, f"bullet {BULLET_PATHS}x{MAIN_STEPS}"),
        ("nmc_fused", "nmc_kernels.cu", "nmc_kernels.py:264", fused_err,
         (nmc_main["nmc_fused"], fused_plain_ms), "x".join(map(str, NMC_MAIN))),
        ("nmc_inner", "nmc_kernels.cu", "nmc_kernels.py:338", inner_err,
         (nmc_main["nmc_inner"], inner_plain_ms), "x".join(map(str, NMC_MAIN))),
        ("ladder", "batch_kernels.cu", "path_kernels.py:634", ladder_err,
         ladder_ms, f"call terminal {LADDER_PATHS} x {len(strikes)} strikes"),
        ("book", "batch_kernels.cu", "path_kernels.py:760", book_err,
         (book_ms, book_plain_ms), f"bullet {nb} x {nb_paths} x {MAIN_STEPS}"),
    )
    kernels = []
    for name, src, tpu, err, (k_ms, p_ms), shape in rows:
        b_ms, b_by = bounds[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"mc_tpu_torch/csrc/{src}",
            replaces=f"mc_tpu/ops/{tpu}", launches=launches[name],
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, shape=shape))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
