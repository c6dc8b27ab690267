"""Command-line interface (port of ``mc_tpu/cli.py`` demo/price/nmc/traj/
ladder/book/greeks).

``python -m mc_tpu_torch demo`` — the ``./main`` equivalent
(``hello.cu:3-48``): the European call by every method, the bullet and the
nested-MC surface, with the Black-Scholes oracle beside the estimates.
``price``, ``nmc``, ``ladder``, ``book`` and ``greeks`` print one JSON
object each (``price`` adds the closed form where the payoff has one, ``nmc
--exposure`` the XVA figures of the surface); ``traj`` writes the
reference's tidy trajectory CSV (``testing.cu:37-47``).  ``--device`` is explicit (default
``cuda``); nothing is resized for the device.
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
    from mc_tpu_torch import oracle, price

    option, sim = _parse(args)
    shift = args.importance_shift
    if shift not in (None, "auto"):
        shift = float(shift)
    res = price(option, sim, payoff=args.payoff, method=args.method,
                antithetic=args.antithetic,
                control_variate=args.control_variate,
                rng_source=args.rng_source,
                importance_shift=0.0 if shift is None else shift,
                device=args.device)
    out = {
        "payoff": args.payoff,
        "price": float(res.price),
        "stderr": float(res.stderr),
        "n_paths": int(float(res.n_paths)),
    }
    # The closed-form fields of mc_tpu's `price` (cli.py:191-208), as they
    # are there: "black_scholes" is the call's for the put too.
    bs_args = (args.s0, args.k, args.t, args.r, args.sigma)
    if args.payoff in ("vanilla_call", "vanilla_put"):
        out["black_scholes"] = oracle.bs_call(*bs_args, args.q)
        if args.payoff == "vanilla_call":
            out["implied_vol"] = oracle.bs_implied_vol(
                out["price"], args.s0, args.k, args.t, args.r, args.q)
    elif args.payoff == "digital_call":
        out["closed_form"] = oracle.bs_digital_call(*bs_args, args.q)
    elif args.payoff in ("up_out_call_bb", "down_out_call_bb"):
        fn = (oracle.bs_up_out_call if args.payoff == "up_out_call_bb"
              else oracle.bs_down_out_call)
        out["closed_form_continuous_barrier"] = fn(*bs_args, args.barrier,
                                                   q=args.q)
    print(json.dumps(out))
    return 0


def cmd_ladder(args):
    import numpy as np

    from mc_tpu_torch import price_ladder

    option, sim = _parse(args)
    strikes = np.linspace(args.k_min, args.k_max, args.n_strikes)
    res = price_ladder(strikes, option, sim, payoff=args.payoff,
                       antithetic=args.antithetic, device=args.device)
    print(json.dumps({
        "strikes": [round(float(k), 6) for k in strikes],
        "prices": [round(float(p), 6) for p in res.price.tolist()],
        "stderrs": [round(float(s), 6) for s in res.stderr.tolist()],
        "n_paths": sim.n_paths,
    }))
    return 0


def cmd_book(args):
    """A B-contract book (mc_tpu/cli.py:1642-1667): strikes and vols drawn
    from default_rng(seed), U(0.8K, 1.2K) and U(0.5 sigma, 2 sigma)."""
    import numpy as np

    from mc_tpu_torch import price_portfolio

    option, sim = _parse(args)
    rng_np = np.random.default_rng(args.seed)
    b = args.n_contracts
    book = OptionParams(
        s0=np.full(b, args.s0, np.float32),
        t=np.full(b, args.t, np.float32),
        k=rng_np.uniform(0.8 * args.k, 1.2 * args.k, b).astype(np.float32),
        r=np.full(b, args.r, np.float32),
        sigma=rng_np.uniform(0.5 * args.sigma, 2.0 * args.sigma,
                             b).astype(np.float32),
        barrier=np.full(b, args.barrier, np.float32),
        p1=np.full(b, args.p1, np.float32),
        p2=np.full(b, args.p2, np.float32),
        q=np.full(b, args.q, np.float32))
    res = price_portfolio(book, sim, payoff=args.payoff, device=args.device)
    print(json.dumps({"payoff": args.payoff, "n_contracts": b,
                      "prices": [round(float(x), 6)
                                 for x in res.price.tolist()],
                      "stderr_max": float(res.stderr.max())}))
    return 0


def cmd_greeks(args):
    """Greeks as one JSON object (mc_tpu/cli.py:802-825): ``greeks()``
    routes a pathwise request to the fused kernel where it fits and to
    autograd through ``price()`` otherwise, so nothing is filtered."""
    from mc_tpu_torch.greeks import greeks

    option, sim = _parse(args)
    if args.which is None:
        # LRM supports only the density parameters; default per method
        args.which = ("delta,vega,rho" if args.method == "lrm"
                      else "delta,vega,rho,theta")
    g = greeks(option, sim, payoff=args.payoff, method=args.method,
               which=tuple(args.which.split(",")),
               antithetic=args.antithetic, device=args.device)
    print(json.dumps({k: float(v) for k, v in g.items()}))
    return 0


def _profile(x):
    return [round(float(v), 6) for v in x.tolist()]


def _xva_outputs(res, args, out):
    """The XVA rows of ``nmc --exposure``: DVA/BCVA, FVA, collateral, IM/MVA
    and the wrong-way-risk CVAs."""
    if args.dva_hazard is not None:
        out["dva"] = float(res.dva(args.dva_hazard, args.cva_recovery))
        if args.cva_hazard is not None:
            out["bilateral_cva"] = float(res.bilateral_cva(
                args.cva_hazard, args.dva_hazard, args.cva_recovery,
                args.cva_recovery))
    if args.fva_spread is not None:
        fca, fba = res.fva(args.fva_spread)
        out["fca"], out["fba"] = float(fca), float(fba)
    if args.collateral_threshold is not None:
        c = res.collateralized(args.collateral_threshold,
                               mta=args.mta, mpor_steps=args.mpor_steps)
        out["collateralized_ee"] = _profile(
            c.exposure_profile(args.pfe_quantile)[0])
        if args.cva_hazard is not None:
            out["collateralized_cva"] = float(
                c.cva(args.cva_hazard, args.cva_recovery))
    if args.im_quantile is not None:
        mpor = max(args.mpor_steps, 1)
        out["initial_margin"] = _profile(res.im_profile(args.im_quantile,
                                                        mpor_steps=mpor))
        if args.mva_spread is not None:
            out["mva"] = float(res.mva(args.mva_spread, args.im_quantile,
                                       mpor))
    if args.cva_hazard is not None and args.wwr_beta is not None:
        out["cva_wwr"] = float(res.cva_wwr(
            args.cva_hazard, args.wwr_beta, args.cva_recovery))
    if args.cva_hazard is not None and args.wwr_spot_beta is not None:
        out["cva_wwr_spot"] = float(res.cva_wwr_spot(
            args.cva_hazard, args.wwr_spot_beta, args.cva_recovery))
    return out


def cmd_nmc(args):
    import numpy as np

    from mc_tpu_torch.nmc import price_nmc

    option, sim = _parse(args)
    if args.wwr_spot_beta is not None and args.strategy != "grid":
        raise SystemExit("--wwr-spot-beta needs the outer spot grid: "
                         "--strategy grid")
    res = price_nmc(option, sim, payoff=args.payoff, strategy=args.strategy,
                    discount=args.discount, device=args.device)
    out = {
        "outer_price": float(res.outer.price),
        "outer_stderr": float(res.outer.stderr),
        "surface_mean": float(res.surface_mean),
        "n_points": int(res.n_points),
    }
    if args.exposure:
        ee, pfe = res.exposure_profile(args.pfe_quantile)
        out["expected_exposure"] = _profile(ee)
        out["pfe"] = _profile(pfe)
        if args.cva_hazard is not None:
            out["cva"] = float(res.cva(args.cva_hazard, args.cva_recovery,
                                       t_horizon=args.t))
        out = _xva_outputs(res, args, out)
    if args.surface_npz:
        np.savez_compressed(args.surface_npz,
                            surface=res.surface_matrix().cpu().numpy())
        out["surface_npz"] = args.surface_npz
    print(json.dumps(out))
    return 0


def cmd_traj(args):
    """CSV trajectory dump in the reference's tidy format (testing.cu:37-47):
    ``time,trajectory,value`` rows, one per (step, path), step-major."""
    import numpy as np

    from mc_tpu_torch import simulate_trajectories

    option, sim = _parse(args)
    traj = simulate_trajectories(option, sim, payoff=args.payoff,
                                 device=args.device)
    grid = traj.s.cpu().numpy()  # (steps, paths)
    n_steps, n_paths = grid.shape
    rows = np.empty((n_steps * n_paths, 3))
    rows[:, 0] = np.repeat(np.arange(n_steps), n_paths)
    rows[:, 1] = np.tile(np.arange(n_paths), n_steps)
    rows[:, 2] = grid.reshape(-1)  # f32 -> f64 is exact
    np.savetxt(args.out, rows, fmt=("%d", "%d", "%.6f"), delimiter=",",
               header="time,trajectory,value", comments="")
    print(json.dumps({"csv": args.out, "trajectories": n_paths,
                      "steps": n_steps}))
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
    p.add_argument("--importance-shift", default=None,
                   help="drift shift in sd units, or 'auto' (aim at K)")
    p.set_defaults(fn=cmd_price)

    p = sub.add_parser("nmc", help="nested MC price surface, JSON output")
    _add_option_flags(p)
    p.add_argument("--payoff", default="bullet_call")
    p.add_argument("--strategy", choices=("fused", "grid"), default="fused")
    p.add_argument("--discount", choices=("full", "remaining"),
                   default="full")
    p.add_argument("--surface-npz", default=None,
                   help="save the (paths, steps) surface to this .npz")
    p.add_argument("--exposure", action="store_true",
                   help="emit EE/PFE exposure profiles from the surface")
    p.add_argument("--pfe-quantile", type=float, default=0.95)
    p.add_argument("--cva-hazard", type=float, default=None,
                   help="flat hazard rate: emit unilateral CVA")
    p.add_argument("--cva-recovery", type=float, default=0.4)
    p.add_argument("--dva-hazard", type=float, default=None,
                   help="own flat hazard: emit DVA and bilateral CVA "
                        "(needs --cva-hazard)")
    p.add_argument("--fva-spread", type=float, default=None,
                   help="funding spread: emit FCA/FBA")
    p.add_argument("--collateral-threshold", type=float, default=None,
                   help="two-way CSA threshold: emit collateralized "
                        "EE/CVA (with --mta / --mpor-steps)")
    p.add_argument("--mta", type=float, default=0.0)
    p.add_argument("--mpor-steps", type=int, default=0,
                   help="margin period of risk, in steps")
    p.add_argument("--im-quantile", type=float, default=None,
                   help="dynamic initial-margin profile: quantile of "
                        "the adverse MtM move over the MPoR")
    p.add_argument("--mva-spread", type=float, default=None,
                   help="funding spread on the IM profile -> MVA "
                        "(needs --im-quantile)")
    p.add_argument("--wwr-beta", type=float, default=None,
                   help="exposure-linked wrong-way-risk CVA "
                        "(needs --cva-hazard)")
    p.add_argument("--wwr-spot-beta", type=float, default=None,
                   help="spot-linked wrong-way-risk CVA: intensity "
                        "rides the underlying level (sign flips with "
                        "the position; needs --cva-hazard and "
                        "--strategy grid)")
    p.set_defaults(fn=cmd_nmc)

    p = sub.add_parser("ladder", help="strike ladder on shared paths, JSON")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--k-min", type=float, default=60.0)
    p.add_argument("--k-max", type=float, default=140.0)
    p.add_argument("--n-strikes", type=int, default=17)
    p.set_defaults(fn=cmd_ladder)

    p = sub.add_parser("book", help="B-contract book in one kernel, JSON")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--n-contracts", type=int, default=16)
    p.set_defaults(fn=cmd_book)

    p = sub.add_parser("greeks",
                       help="MC Greeks (pathwise, CRN-FD, or LRM), JSON")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--method", choices=("pathwise", "fd", "lrm"),
                   default="pathwise")
    p.add_argument("--which", default=None,
                   help="comma list; default depends on --method")
    p.add_argument("--antithetic", action="store_true")
    p.set_defaults(fn=cmd_greeks)

    p = sub.add_parser("traj", help="dump trajectories CSV (testing.cu)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="bullet_call")
    p.add_argument("--out", default="testing.csv")
    p.set_defaults(fn=cmd_traj)

    args = ap.parse_args(argv)
    return args.fn(args)
