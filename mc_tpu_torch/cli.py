"""Command-line interface (port of ``mc_tpu/cli.py:70-210`` demo/price/nmc).

``python -m mc_tpu_torch demo`` — the ``./main`` equivalent
(``hello.cu:3-48``): the European call by every method, the bullet and the
nested-MC surface, with the Black-Scholes oracle beside the estimates.
``price`` and ``nmc`` print one JSON object each.  ``--device`` is explicit
(default ``cuda``); nothing is resized for the device.
"""

from __future__ import annotations

import argparse
import json

from mc_tpu_torch.config import OptionParams, SimParams


def _add_option_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("option/market (OptionData, tool.cuh:13-26)")
    g.add_argument("--s0", type=float, default=100.0)
    g.add_argument("--strike", "-K", type=float, default=100.0, dest="k")
    g.add_argument("--maturity", "-T", type=float, default=1.0, dest="t")
    g.add_argument("--rate", "-r", type=float, default=0.1, dest="r")
    g.add_argument("--sigma", "-v", type=float, default=0.2)
    g.add_argument("--barrier", "-B", type=float, default=120.0)
    g.add_argument("--p1", type=float, default=10.0,
                   help="bullet window lower step count")
    g.add_argument("--p2", type=float, default=50.0,
                   help="bullet window upper step count")
    g.add_argument("--dividend", "-q", type=float, default=0.0, dest="q",
                   help="continuous dividend yield")
    g = p.add_argument_group("simulation")
    g.add_argument("--n-paths", "-N", type=int, default=100_000)
    g.add_argument("--n-steps", type=int, default=100)
    g.add_argument("--n-inner", type=int, default=1_000,
                   help="inner paths per NMC point")
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "PyTorch versions)")


def _parse(args):
    option = OptionParams(s0=args.s0, t=args.t, k=args.k, r=args.r,
                          sigma=args.sigma, barrier=args.barrier,
                          p1=args.p1, p2=args.p2, q=args.q)
    sim = SimParams(n_paths=args.n_paths, n_steps=args.n_steps,
                    n_paths_inner=args.n_inner, seed=args.seed)
    return option, sim


def _fmt(label, res, bs=None):
    line = (f"  {label:<38s} {float(res.price):>10.4f} "
            f"+/- {float(res.stderr):.4f}")
    if bs is not None:
        dev = abs(float(res.price) - bs) / max(float(res.stderr), 1e-12)
        line += f"   ({dev:.2f} se from BS)"
    return line


def cmd_demo(args):
    from mc_tpu_torch import price, price_nmc
    from mc_tpu_torch.oracle import bs_call
    from mc_tpu_torch.utils import device_summary

    option, sim = _parse(args)
    dev = args.device
    print(device_summary(dev))
    print(f"\nConfig: S0={args.s0} K={args.k} T={args.t} r={args.r} "
          f"sigma={args.sigma} B={args.barrier} window=[{args.p1},{args.p2}] "
          f"N={sim.n_paths} steps={sim.n_steps} inner={sim.n_paths_inner}")
    bs = bs_call(args.s0, args.k, args.t, args.r, args.sigma, args.q)

    print("\nVanilla European call (vs wrapper_gpu_option_vanilla):")
    rows = (
        ("terminal_pair (default)", {}),
        ("terminal (exact one-shot draw)", dict(method="terminal")),
        ("euler (step loop)", dict(method="euler")),
        ("antithetic", dict(antithetic=True)),
        ("antithetic + control variate",
         dict(method="euler", antithetic=True, control_variate=True)),
    )
    for label, kw in rows:
        print(_fmt(label, price(option, sim, device=dev, **kw), bs))

    print("\nBullet option (vs wrapper_gpu_bullet_option[_atomic]):")
    print(_fmt("bullet", price(option, sim, payoff="bullet_call",
                               device=dev)))
    print(_fmt("bullet antithetic",
               price(option, sim, payoff="bullet_call", antithetic=True,
                     device=dev)))

    if not args.skip_nmc:
        nmc_sim = sim.replace(n_paths=min(sim.n_paths, args.nmc_max_paths))
        print(f"\nNested MC (vs wrapper_gpu_bullet_option_nmc_*; "
              f"{nmc_sim.n_paths} outer paths x {nmc_sim.n_paths_inner} "
              "inner):")
        res = price_nmc(option, nmc_sim, strategy="fused", device=dev)
        print(_fmt("outer estimate", res.outer))
        print(f"  {'surface mean over all points':<38s} "
              f"{float(res.surface_mean):>10.4f}")

    print(f"\n  {'Black-Scholes closed form':<38s} {bs:>10.4f}"
          f"   (BlackandScholes.hpp:34-43)")
    return 0


def cmd_price(args):
    from mc_tpu_torch import price
    from mc_tpu_torch.oracle import bs_call

    option, sim = _parse(args)
    res = price(option, sim, payoff=args.payoff, method=args.method,
                antithetic=args.antithetic,
                control_variate=args.control_variate,
                rng_source=args.rng_source, device=args.device)
    out = {
        "payoff": args.payoff,
        "price": float(res.price),
        "stderr": float(res.stderr),
        "n_paths": int(float(res.n_paths)),
    }
    if args.payoff == "vanilla_call":
        out["black_scholes"] = bs_call(args.s0, args.k, args.t, args.r,
                                       args.sigma, args.q)
    print(json.dumps(out))
    return 0


def cmd_nmc(args):
    from mc_tpu_torch.nmc import price_nmc

    option, sim = _parse(args)
    res = price_nmc(option, sim, payoff=args.payoff, discount=args.discount,
                    device=args.device)
    print(json.dumps({
        "outer_price": float(res.outer.price),
        "outer_stderr": float(res.outer.stderr),
        "surface_mean": float(res.surface_mean),
        "n_points": int(res.n_points),
    }))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mc_tpu_torch",
        description="Monte Carlo option pricing on PyTorch + CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("demo", help="run all pricers + BS oracle (hello.cu)")
    _add_option_flags(p)
    p.add_argument("--skip-nmc", action="store_true")
    p.add_argument("--nmc-max-paths", type=int, default=4096,
                   help="cap outer paths for the NMC stage of the demo")
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("price", help="price one option, JSON output")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--method", choices=("terminal_pair", "terminal", "euler"),
                   default=None)
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--control-variate", action="store_true")
    p.add_argument("--rng-source", choices=("threefry13", "threefry"),
                   default="threefry13")
    p.set_defaults(fn=cmd_price)

    p = sub.add_parser("nmc", help="nested MC price surface, JSON output")
    _add_option_flags(p)
    p.add_argument("--payoff", default="bullet_call")
    p.add_argument("--discount", choices=("full", "remaining"),
                   default="full")
    p.set_defaults(fn=cmd_nmc)

    args = ap.parse_args(argv)
    return args.fn(args)
