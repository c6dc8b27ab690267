"""Run mc_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

from the root of a checkout.  It drives ``mc_tpu_torch`` only (never JAX or
``mc_tpu``) through six phases and exits nonzero at the first failure:

1. the card (``nvidia-smi`` name and power limit) and the build of
   ``mc_tpu_torch/csrc`` with ``nvcc``;
2. each of the three CUDA kernels against its plain PyTorch version on the
   card, same key, with the tolerances of the parity contract, at the
   contract's sizes and at the main path's shapes;
3. the main path at the size users run: the 1M-path European call by five
   methods against Black-Scholes, the 100k x 100-step bullet, and the
   16,384 x 100 x 500 nested-MC surface (last-step and tower checks);
4. the kernels' launch counts over phase 3;
5. kernel and plain-version times with CUDA events (median of >= 5 runs
   after a warm-up) and end-to-end times of the phase-3 calls;
6. one JSON line of per-kernel results, then the JSON status line.

Without a CUDA device it prints no result and exits 2.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
import time

import torch

# Phase-2 (kernel vs plain) and phase-3 (main path) sizes.
TP_PATHS = 1 << 20
TERM_PATHS = 1 << 18
EULER_PATHS, EULER_STEPS = 1 << 16, 100
NMC_SMALL = (2048, 16, 64)          # outer paths, steps, inner paths
MAIN_PATHS, MAIN_STEPS = 1_000_000, 100
BULLET_PATHS = 100_000
NMC_MAIN = (16384, 100, 500)        # README quickstart: 4.1e10 inner steps
REPS = 5
DEVICE = "cuda"

# Parity contract.  Vanilla: same stream, same f32 arithmetic; the only
# differences are CUDA's libm against PyTorch's and the order of f64 sums.
VANILLA_RTOL = 1e-5
# Bullet and NMC: a barrier count can flip where S lands within an ulp of B.
BULLET_SE_TOL = 0.05                # |d price|, |d stderr| in stderrs
SURF_TOL, SURF_FRAC = 1e-4, 0.999   # rtol = atol, share of points
SURF_MEAN_RTOL = 1e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing run", file=sys.stderr)
        return 2

    import mc_tpu_torch as mt
    from mc_tpu_torch import engines, rng
    from mc_tpu_torch.ops import _cuda
    from mc_tpu_torch.ops import nmc_kernels as nk
    from mc_tpu_torch.ops import path_kernels as pk
    from mc_tpu_torch.ops.payoffs import get_payoff
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
    call, bullet = get_payoff("vanilla_call"), get_payoff("bullet_call")
    key = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_OUTER))
    key_in = tuple(int(k) for k in rng.derive_key(1234, engines.STREAM_INNER))

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

    def terminal_pair_case(n_paths):
        prm = pk.pack_params(option, MAIN_STEPS, dev)
        cfg = pk.KernelConfig(n_paths=(n_paths + 1) // 2, n_steps=MAIN_STEPS,
                              method="terminal")
        got = engines.finish_price(finish_sum(pk.terminal_pair_partials(
            call, cfg, key, prm, n_paths)), n_paths, option)
        want = engines.finish_price(finish_sum(
            pk.terminal_pair_partials_plain(call, cfg, key, prm, n_paths)),
            n_paths, option)
        return vanilla_check(f"terminal_pair {n_paths} paths", got, want)

    def simulate_case(po, cfg, check):
        prm = pk.pack_params(option, cfg.n_steps, dev)
        got = engines.finish_price(finish_sum(pk.simulate_partials(
            po, cfg, key, prm)), cfg.n_paths, option, cfg.with_cv)
        want = engines.finish_price(finish_sum(pk.simulate_partials_plain(
            po, cfg, key, prm)), cfg.n_paths, option, cfg.with_cv)
        name = (f"simulate_partials {po.name} {cfg.method} "
                f"{cfg.n_paths}x{cfg.n_steps} anti={cfg.antithetic} "
                f"cv={cfg.with_cv} {cfg.rng_source}")
        return check(name, got, want)

    def nmc_case(shape):
        n_out, n_steps, n_inner = shape
        cfg = nk.NMCConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
        prm = pk.pack_params(option, n_steps, dev)
        surf_k, outer_k = nk.nmc_fused(bullet, cfg, key, key_in, prm)
        t0 = time.perf_counter()
        surf_p, outer_p = nk.nmc_fused_plain(bullet, cfg, key, key_in, prm)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        close = torch.isclose(surf_k, surf_p, rtol=SURF_TOL, atol=SURF_TOL)
        frac = float(close.double().mean())
        bitwise = float((surf_k == surf_p).double().mean())
        err = float((surf_k - surf_p).abs().max())
        mean_k = float(surf_k.double().mean())
        mean_p = float(surf_p.double().mean())
        ok_k = engines.finish_price(finish_sum(outer_k), n_out, option)
        ok_p = engines.finish_price(finish_sum(outer_p), n_out, option)
        d_outer = abs(float(ok_k.price) - float(ok_p.price))
        ok = (frac >= SURF_FRAC
              and abs(mean_k - mean_p) <= SURF_MEAN_RTOL * abs(mean_p)
              and d_outer <= BULLET_SE_TOL * float(ok_p.stderr))
        print(f"phase 2: nmc_fused {n_out}x{n_steps}x{n_inner}: {frac:.6f} of "
              f"points within rtol=atol={SURF_TOL} (need {SURF_FRAC}), "
              f"{bitwise:.6f} bitwise, max |d| {err:.3e}; surface mean "
              f"{mean_k:.7f} vs {mean_p:.7f}; outer {float(ok_k.price):.7f} "
              f"vs {float(ok_p.price):.7f}; plain took {plain_s:.2f} s "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("nmc_fused kernel disagrees with its plain version")
        return err

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
    nmc_err = max(nmc_case(NMC_SMALL), nmc_case(NMC_MAIN))

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
    bsim = mt.SimParams(n_paths=BULLET_PATHS, n_steps=MAIN_STEPS)
    for anti in (False, True):
        res = mt.price(option, bsim, payoff="bullet_call", antithetic=anti,
                       device=DEVICE)
        p = float(res.price)
        print(f"phase 3: bullet {BULLET_PATHS}x{MAIN_STEPS} antithetic={anti}: "
              f"{p:.5f} +/- {float(res.stderr):.5f}")
        if not (math.isfinite(p) and 0.0 < p < vanilla_price):
            fail(f"bullet price {p} is not in (0, {vanilla_price})")

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
    ncfg = nk.NMCConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
    prm = pk.pack_params(option, n_steps, dev)
    s_hist, c_hist = nk.outer_history(bullet, ncfg, key, prm)
    p32 = pk.unpack_params(prm)
    want = (torch.exp(-p32.r * p32.t)
            * bullet.terminal((c_hist[-1],), s_hist[-1], p32))
    last = surf[:, -1]
    last_ok = bool(torch.allclose(last, want, rtol=1e-5, atol=0.0))
    print(f"phase 3: nmc {n_out}x{n_steps}x{n_inner} ({nmc_first_s:.2f} s): "
          f"outer {float(res.outer.price):.5f} +/- {float(res.outer.stderr):.5f}"
          f", surface mean {float(res.surface_mean):.5f}; last step == "
          f"e^-rT*payoff: {'ok' if last_ok else 'MISMATCH'} "
          f"({float((last == want).double().mean()):.6f} bitwise)")
    if not last_ok:
        fail("NMC last step is not the discounted terminal payoff")
    cols = surf.double().mean(dim=0)
    dev_se = ((cols - float(res.outer.price)).abs()
              / float(res.outer.stderr)).max()
    print(f"phase 3: nmc tower property: max |column mean - outer| = "
          f"{float(dev_se):.2f} outer stderr (limit 4)")
    if not float(dev_se) <= 4.0:
        fail("NMC surface columns break the tower property")

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

    p100 = pk.pack_params(option, MAIN_STEPS, dev)
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
    for label, cfg in (
            ("simulate_partials call terminal antithetic",
             pk.KernelConfig(n_paths=MAIN_PATHS, n_steps=MAIN_STEPS,
                             method="terminal", antithetic=True)),
            ("simulate_partials call euler", pk.KernelConfig(
                n_paths=MAIN_PATHS, n_steps=MAIN_STEPS)),
            ("simulate_partials call euler antithetic+cv", pk.KernelConfig(
                n_paths=MAIN_PATHS, n_steps=MAIN_STEPS, antithetic=True,
                with_cv=True))):
        time_pair(label,
                  lambda cfg=cfg: pk.simulate_partials(call, cfg, key, p100),
                  lambda cfg=cfg: pk.simulate_partials_plain(call, cfg, key,
                                                             p100),
                  f"{cfg.n_paths}x{cfg.n_steps}")
    n_out, n_steps, n_inner = NMC_SMALL
    ncfg_s = nk.NMCConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
    p_s = pk.pack_params(option, n_steps, dev)
    nmc_ms = time_pair(
        "nmc_fused",
        lambda: nk.nmc_fused(bullet, ncfg_s, key, key_in, p_s),
        lambda: nk.nmc_fused_plain(bullet, ncfg_s, key, key_in, p_s),
        f"{n_out}x{n_steps}x{n_inner} (plain too slow at the main shape)")
    n_out, n_steps, n_inner = NMC_MAIN
    ncfg_m = nk.NMCConfig(n_paths=n_out, n_steps=n_steps, n_inner=n_inner)
    nmc_main_ms, sp, _ = cuda_ms(lambda: nk.nmc_fused(bullet, ncfg_m, key,
                                                      key_in, prm))
    inner_steps = n_out * n_inner * n_steps * (n_steps - 1) // 2
    print(f"phase 5: nmc_fused {n_out}x{n_steps}x{n_inner}: kernel "
          f"{nmc_main_ms:.2f} ms (spread {sp:.1%}), "
          f"{inner_steps / nmc_main_ms * 1e3:.4e} inner path-steps/s {tag}")

    e2e = (
        ("price() call 1M paths default", "paths/s", MAIN_PATHS,
         lambda: mt.price(option, sim, device=DEVICE)),
        (f"price() bullet {BULLET_PATHS}x{MAIN_STEPS}", "path-steps/s",
         BULLET_PATHS * MAIN_STEPS,
         lambda: mt.price(option, bsim, payoff="bullet_call", device=DEVICE)),
        (f"price_nmc() {n_out}x{n_steps}x{n_inner}", "inner path-steps/s",
         inner_steps, lambda: mt.price_nmc(option, nsim, device=DEVICE)),
    )
    for label, unit, work, fn in e2e:
        secs = sorted(wall_s(fn) for _ in range(REPS))
        med = statistics.median(secs)
        print(f"phase 5: e2e {label}: median {med * 1e3:.4f} ms over {REPS} "
              f"(min {secs[0] * 1e3:.4f}, max {secs[-1] * 1e3:.4f}), "
              f"{work / med:.4e} {unit} {tag}")

    # --- Phase 6: results -----------------------------------------------
    kernels = [
        dict(name="terminal_pair", route="cuda",
             source="mc_tpu_torch/csrc/path_kernels.cu",
             replaces="mc_tpu/ops/path_kernels.py:1015",
             launches=launches["terminal_pair"], max_abs_err=tp_err,
             ms=tp_ms[0], plain_ms=tp_ms[1], shape=f"{MAIN_PATHS} paths"),
        dict(name="simulate_partials", route="cuda",
             source="mc_tpu_torch/csrc/path_kernels.cu",
             replaces="mc_tpu/ops/path_kernels.py:395",
             launches=launches["simulate_partials"],
             max_abs_err=sim_err, ms=sim_ms[0], plain_ms=sim_ms[1],
             shape=f"bullet {BULLET_PATHS}x{MAIN_STEPS}"),
        dict(name="nmc_fused", route="cuda",
             source="mc_tpu_torch/csrc/nmc_kernels.cu",
             replaces="mc_tpu/ops/nmc_kernels.py:264",
             launches=launches["nmc_fused"], max_abs_err=nmc_err,
             ms=nmc_ms[0], plain_ms=nmc_ms[1],
             shape="x".join(map(str, NMC_SMALL)),
             main_shape_ms=nmc_main_ms),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
