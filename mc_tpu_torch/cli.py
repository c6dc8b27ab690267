"""Command-line interface (port of ``mc_tpu/cli.py`` demo/price/nmc/traj/
ladder/book/greeks/heston/merton/bates/cev/localvol/sabr/term/divs/vasicek/
basket/rainbow/fx/qmc/swaption/hullwhite/g2pp/info).

``python -m mc_tpu_torch demo`` — the ``./main`` equivalent
(``hello.cu:3-48``): the European call by every method, the bullet and the
nested-MC surface, with the Black-Scholes oracle beside the estimates.
``price``, ``nmc``, ``ladder``, ``book``, ``greeks``, ``heston``,
``merton``, ``bates``, ``cev``, ``localvol``, ``sabr``, ``term``, ``divs``,
``vasicek``, ``basket``, ``rainbow``, ``fx``, ``qmc``, ``swaption``,
``hullwhite`` and ``g2pp`` print one JSON object each (``price`` adds the
closed form where
the payoff has one, ``heston`` and ``bates`` the CF oracle for the call,
``merton`` the series oracle, ``cev`` the noncentral chi-squared oracle,
``localvol --beta`` that oracle and the z-score of a CEV-shaped surface,
``sabr`` Hagan's price and implied vol beside the MC-inverted one, ``term``
Black-Scholes at the averaged curves and the z-score, ``divs`` the
quadrature oracle and z-score of one dividend, ``vasicek`` the bond's or
Merton's (1973) call oracle and z-score, ``rainbow`` the Stulz or Margrabe
price and z-score at d = 2 (``--greeks``: the per-asset delta and vega
and cega[0, 1]), ``fx`` the contract's closed form and z,
``qmc`` Black-Scholes beside the call or put, ``swaption``, ``hullwhite``
(``--proj-spread-bp`` multi-curve, ``--par-swap-rates`` a bootstrapped
curve) and ``g2pp`` the European swaption beside its oracle and z-score
(their Bermudan, QMC, greek, exposure, book and curve-VaR legs exit naming
the ROADMAP item that ports them), ``nmc --exposure`` the XVA
figures of the surface, under GBM or ``--model
heston|merton|bates|cev|localvol|sabr|term|vasicek|basket|rainbow``, each
family's dynamics from its own flags; ``--cva-greeks`` adds d(CVA)/d(field)
by forward mode, ``--book-strikes``/``--book-weights`` net a book of
contracts); ``info`` prints the device summary; ``traj`` writes the
reference's tidy trajectory CSV (``testing.cu:37-47``).  ``--device`` is explicit (default
``cuda``); nothing is resized for the device.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def _add_heston_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("Heston variance process")
    g.add_argument("--v0", type=float, default=0.04)
    g.add_argument("--kappa", type=float, default=2.0)
    g.add_argument("--theta-v", type=float, default=0.04)
    g.add_argument("--xi", type=float, default=0.3)
    g.add_argument("--rho-sv", type=float, default=-0.7)


def _heston_dyn(args):
    from mc_tpu_torch.models.heston import HestonDynamics

    return HestonDynamics(v0=args.v0, kappa=args.kappa, theta=args.theta_v,
                          xi=args.xi, rho=args.rho_sv)


def _add_jump_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("compound-Poisson jumps (Merton, Bates)")
    g.add_argument("--lam", type=float, default=0.3,
                   help="jump intensity (per year)")
    g.add_argument("--mu-j", type=float, default=-0.10,
                   help="mean log jump size")
    g.add_argument("--sigma-j", type=float, default=0.15,
                   help="std of log jump size")


def _merton_dyn(args):
    from mc_tpu_torch.models.merton import MertonDynamics

    return MertonDynamics(lam=args.lam, mu_j=args.mu_j, sigma_j=args.sigma_j)


def _bates_dyn(args):
    from mc_tpu_torch.models.bates import BatesDynamics

    return BatesDynamics(v0=args.v0, kappa=args.kappa, theta=args.theta_v,
                         xi=args.xi, rho=args.rho_sv, lam=args.lam,
                         mu_j=args.mu_j, sigma_j=args.sigma_j)


def _cev_dyn(args):
    from mc_tpu_torch.models.cev import CEVDynamics

    return CEVDynamics.from_atm_vol(args.sigma_atm, args.beta, args.s0)


def _nmc_surface(args):
    """``nmc --model localvol``'s surface (mc_tpu/cli.py:320-329): sigma +
    curv*x^2 at every step, no term slope."""
    from mc_tpu_torch.models.localvol import LocalVolSurface

    return LocalVolSurface.from_function(
        lambda x, t: args.sigma + args.smile_curv * x * x, args.n_steps)


def _nmc_sabr_dyn(args):
    """``nmc --model sabr``'s dynamics (mc_tpu/cli.py:373-381): alpha, nu
    and rho from --rho-sv, beta 1."""
    from mc_tpu_torch.models.sabr import SABRDynamics

    return SABRDynamics(alpha=args.alpha, nu=args.nu, rho=args.rho_sv)


def _vasicek_dyn(args):
    from mc_tpu_torch.models.vasicek import VasicekDynamics

    return VasicekDynamics(a=args.a, b=args.b, sigma_r=args.sigma_r,
                           rho=args.rho_r)


def _basket_dyn(args):
    """``--n-assets`` assets at the demo's spots and vols, pairwise
    correlation ``--corr`` (mc_tpu/cli.py:1123-1130, 382-389)."""
    from mc_tpu_torch.models.basket import demo_basket

    return demo_basket(d=args.n_assets, rho=args.corr)


# --model -> the family's dynamics from its own flags (term: the default
# curves of price_nmc_term).
_FAMILY_DYNAMICS = {"heston": _heston_dyn, "merton": _merton_dyn,
                    "bates": _bates_dyn, "cev": _cev_dyn,
                    "localvol": _nmc_surface, "sabr": _nmc_sabr_dyn,
                    "term": lambda args: None, "vasicek": _vasicek_dyn,
                    "basket": _basket_dyn, "rainbow": _basket_dyn}


def cmd_heston(args):
    """Heston price as one JSON object (mc_tpu/cli.py:1869-1882), the CF
    oracle beside the call."""
    from mc_tpu_torch.models.heston import heston_call_cf, price_heston

    option, sim = _parse(args)
    res = price_heston(option, _heston_dyn(args), sim, payoff=args.payoff,
                       scheme=args.scheme, antithetic=args.antithetic,
                       device=args.device)
    out = {"payoff": args.payoff, "scheme": args.scheme,
           "price": float(res.price), "stderr": float(res.stderr)}
    if args.payoff == "vanilla_call":
        out["cf_oracle"] = heston_call_cf(args.s0, args.k, args.t, args.r,
                                          args.v0, args.kappa, args.theta_v,
                                          args.xi, args.rho_sv, q=args.q)
    print(json.dumps(out))
    return 0


def cmd_merton(args):
    """Merton price as one JSON object (mc_tpu/cli.py:910-926), the series
    oracle beside the call."""
    from mc_tpu_torch.models.merton import (merton_call_closed_form,
                                            price_merton)

    option, sim = _parse(args)
    res = price_merton(option, _merton_dyn(args), sim, payoff=args.payoff,
                       method=args.method, antithetic=args.antithetic,
                       device=args.device)
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr), "lam": args.lam}
    if args.payoff == "vanilla_call":
        out["merton_series_oracle"] = merton_call_closed_form(
            args.s0, args.k, args.t, args.r, args.sigma, lam=args.lam,
            mu_j=args.mu_j, sigma_j=args.sigma_j, q=args.q)
    print(json.dumps(out))
    return 0


def cmd_bates(args):
    """Bates price as one JSON object (mc_tpu/cli.py:510-530), the CF
    oracle beside the call."""
    from mc_tpu_torch.models.bates import bates_call_cf, price_bates

    option, sim = _parse(args)
    res = price_bates(option, _bates_dyn(args), sim, payoff=args.payoff,
                      scheme=args.scheme, antithetic=args.antithetic,
                      device=args.device)
    out = {"payoff": args.payoff, "scheme": args.scheme,
           "price": float(res.price), "stderr": float(res.stderr)}
    if args.payoff == "vanilla_call":
        out["cf_oracle"] = bates_call_cf(
            args.s0, args.k, args.t, args.r, args.v0, args.kappa,
            args.theta_v, args.xi, args.rho_sv, args.lam, args.mu_j,
            args.sigma_j, q=args.q)
    print(json.dumps(out))
    return 0


def cmd_cev(args):
    """CEV price as one JSON object (mc_tpu/cli.py:888-906), the
    noncentral chi-squared oracle beside the call where 0 < beta < 1."""
    from mc_tpu_torch.models.cev import cev_call_closed_form, price_cev

    option, sim = _parse(args)
    dyn = _cev_dyn(args)
    res = price_cev(option, dyn, sim, payoff=args.payoff,
                    antithetic=args.antithetic, device=args.device)
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr), "beta": args.beta}
    if args.payoff == "vanilla_call" and 0.0 < args.beta < 1.0:
        out["ncx2_oracle"] = cev_call_closed_form(
            args.s0, args.k, args.t, args.r, dyn.sigma_lv, args.beta,
            q=args.q)
    print(json.dumps(out))
    return 0


def cmd_localvol(args):
    """Local-vol price as one JSON object (mc_tpu/cli.py:1580-1607): the
    surface sigma + curv*x^2 + slope*t, or with ``--beta`` the CEV-shaped
    sigma*e^{(beta-1)x}, whose call prints the CEV oracle and z-score."""
    import math

    from mc_tpu_torch.models.cev import cev_call_closed_form
    from mc_tpu_torch.models.localvol import LocalVolSurface, price_localvol

    option, sim = _parse(args)
    if args.beta is not None:
        beta = args.beta

        def fn(x, t):
            return args.sigma * math.exp((beta - 1.0) * x)
    else:
        def fn(x, t):
            return args.sigma + args.smile_curv * x * x + args.term_slope * t
    surf = LocalVolSurface.from_function(fn, sim.n_steps,
                                         n_knots=args.n_knots)
    res = price_localvol(option, surf, sim, payoff=args.payoff,
                         antithetic=args.antithetic, device=args.device)
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr)}
    if (args.beta is not None and args.payoff == "vanilla_call"
            and 0.0 < args.beta < 1.0):  # the closed form's range
        out["cev_oracle"] = cev_call_closed_form(
            args.s0, args.k, args.t, args.r,
            args.sigma * args.s0 ** (1.0 - args.beta), args.beta, args.q)
        out["z_score"] = (out["price"] - out["cev_oracle"]) / out["stderr"]
    print(json.dumps(out))
    return 0


def cmd_sabr(args):
    """SABR price as one JSON object (mc_tpu/cli.py:929-952): for the call,
    Hagan's price and implied vol beside the MC price's implied vol."""
    import math

    from mc_tpu_torch.models.sabr import (SABRDynamics, price_sabr,
                                          sabr_call_hagan, sabr_implied_vol)
    from mc_tpu_torch.oracle import bs_implied_vol

    option, sim = _parse(args)
    dyn = SABRDynamics(alpha=args.alpha, beta=args.beta, nu=args.nu,
                       rho=args.rho_fv)
    res = price_sabr(option, dyn, sim, payoff=args.payoff,
                     antithetic=args.antithetic, device=args.device)
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr)}
    if args.payoff == "vanilla_call":
        out["hagan_oracle"] = sabr_call_hagan(
            args.s0, args.k, args.t, args.r, alpha=args.alpha,
            beta=args.beta, nu=args.nu, rho=args.rho_fv, q=args.q)
        f = args.s0 * math.exp((args.r - args.q) * args.t)
        out["hagan_implied_vol"] = sabr_implied_vol(
            f, args.k, args.t, args.alpha, args.beta, args.nu, args.rho_fv)
        out["mc_implied_vol"] = bs_implied_vol(
            out["price"], args.s0, args.k, args.t, args.r, args.q)
    print(json.dumps(out))
    return 0


def cmd_term(args):
    """Term-structure price as one JSON object (mc_tpu/cli.py:1552-1577):
    for the call, Black-Scholes at the averaged curves and the z-score."""
    import numpy as np

    from mc_tpu_torch.models.term import TermStructure, price_term
    from mc_tpu_torch.oracle import bs_call

    option, sim = _parse(args)
    rates = [float(x) for x in args.rate_knots.split(",")]
    sigmas = [float(x) for x in args.sigma_knots.split(",")]
    term = TermStructure.from_knots(rates, sigmas, sim.n_steps)
    res = price_term(option, term, sim, payoff=args.payoff,
                     antithetic=args.antithetic, device=args.device)
    out = {"payoff": args.payoff, "rate_knots": rates,
           "sigma_knots": sigmas, "price": float(res.price),
           "stderr": float(res.stderr)}
    if args.payoff == "vanilla_call":
        rs = np.asarray(term.rates, np.float64)
        sg = np.asarray(term.sigmas, np.float64)
        out["oracle"] = bs_call(args.s0, args.k, args.t, float(rs.mean()),
                                float(np.sqrt((sg ** 2).mean())), args.q)
        out["z_score"] = (out["price"] - out["oracle"]) / out["stderr"]
    print(json.dumps(out))
    return 0


def cmd_divs(args):
    """Cash-dividend price as one JSON object (mc_tpu/cli.py:1091-1121):
    with one dividend, the call's quadrature oracle and z-score."""
    from mc_tpu_torch.models.dividends import (bs_call_cash_div,
                                               div_schedule, price_divs)

    option, sim = _parse(args)
    steps = ([int(x) for x in args.div_steps.split(",")]
             if args.div_steps else [])
    amounts = ([float(x) for x in args.div_amounts.split(",")]
               if args.div_amounts else [])
    if len(steps) != len(amounts):
        raise SystemExit("--div-steps and --div-amounts must pair up")
    divs = div_schedule(sim.n_steps, steps, amounts)
    res = price_divs(option, divs, sim, payoff=args.payoff,
                     antithetic=args.antithetic, device=args.device)
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr),
           "dividends": [[int(j), float(a)] for j, a in zip(steps, amounts)]}
    tau = (steps[0] + 1) / sim.n_steps * args.t if len(steps) == 1 else None
    if (args.payoff == "vanilla_call" and tau is not None
            and 0.0 < tau < args.t):
        out["quadrature_oracle"] = bs_call_cash_div(
            args.s0, args.k, args.t, args.r, args.sigma, amounts[0], tau,
            q=args.q)
        out["z_score"] = ((out["price"] - out["quadrature_oracle"])
                          / out["stderr"])
    print(json.dumps(out))
    return 0


def cmd_vasicek(args):
    """Vasicek-rates price as one JSON object (mc_tpu/cli.py:1185-1206): for
    the bond the affine closed form, for the call Merton's (1973), and the
    z-score."""
    from mc_tpu_torch.models.vasicek import price_vasicek
    from mc_tpu_torch.oracle import bsv_call, vasicek_zcb

    option, sim = _parse(args)
    res = price_vasicek(option, _vasicek_dyn(args), sim, payoff=args.payoff,
                        antithetic=args.antithetic, device=args.device)
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr)}
    if args.payoff == "zcb":
        out["oracle"] = vasicek_zcb(args.r, args.a, args.b, args.sigma_r,
                                    args.t)
    elif args.payoff == "vanilla_call":
        out["oracle"] = bsv_call(args.s0, args.k, args.t, args.r, args.sigma,
                                 args.a, args.b, args.sigma_r, args.rho_r,
                                 args.q)
    if "oracle" in out:
        out["z_score"] = (out["price"] - out["oracle"]) / out["stderr"]
    print(json.dumps(out))
    return 0


def cmd_basket(args):
    """Basket price as one JSON object (mc_tpu/cli.py:1123-1133)."""
    from mc_tpu_torch.models.basket import price_basket

    option, sim = _parse(args)
    res = price_basket(option, _basket_dyn(args), sim, payoff=args.payoff,
                       antithetic=args.antithetic, device=args.device)
    print(json.dumps({"payoff": args.payoff, "n_assets": args.n_assets,
                      "price": float(res.price),
                      "stderr": float(res.stderr)}))
    return 0


def cmd_rainbow(args):
    """Rainbow price as one JSON object (mc_tpu/cli.py:1137-1182): d assets
    with spots and vols evenly from (s0, sigma) to (s02, sigma2), pairwise
    correlation --corr; at d = 2 the Stulz or Margrabe price and the
    z-score."""
    import numpy as np

    from mc_tpu_torch import oracle
    from mc_tpu_torch.models.basket import BasketDynamics
    from mc_tpu_torch.models.rainbow import price_rainbow

    option, sim = _parse(args)
    d = args.n_assets
    corr = np.full((d, d), args.corr, np.float32)
    np.fill_diagonal(corr, 1.0)
    sigmas = np.linspace(args.sigma, args.sigma2, d).astype(np.float32)
    s0s = np.linspace(args.s0, args.s02, d).astype(np.float32)
    dyn = BasketDynamics(s0s=s0s, sigmas=sigmas,
                         weights=np.full(d, 1.0 / d, np.float32), corr=corr)
    res = price_rainbow(option, dyn, sim, payoff=args.payoff,
                        antithetic=args.antithetic, device=args.device)
    out = {"payoff": args.payoff, "n_assets": d, "price": float(res.price),
           "stderr": float(res.stderr)}
    if args.greeks:
        from mc_tpu_torch.greeks import rainbow_greeks
        g = rainbow_greeks(option, dyn, sim, args.payoff, device=args.device)
        out["delta"] = [float(x) for x in g["delta"].tolist()]
        out["vega"] = [float(x) for x in g["vega"].tolist()]
        out["cega_01"] = float(g["cega"][0, 1]) if d > 1 else 0.0
    if d == 2:  # the closed-form column (Margrabe, Stulz)
        a = (float(s0s[0]), float(s0s[1]))
        if args.payoff == "exchange":
            out["oracle"] = oracle.margrabe(a[0], a[1], args.t, sigmas[0],
                                            sigmas[1], args.corr, args.q,
                                            args.q)
        elif args.payoff != "best_of_cash":
            fn = {"call_on_min": oracle.stulz_min_call,
                  "call_on_max": oracle.stulz_max_call,
                  "put_on_min": oracle.stulz_min_put,
                  "put_on_max": oracle.stulz_max_put}[args.payoff]
            out["oracle"] = fn(a[0], a[1], args.k, args.t, args.r, sigmas[0],
                               sigmas[1], args.corr, args.q, args.q)
        if "oracle" in out:
            out["z_score"] = (out["price"] - out["oracle"]) / out["stderr"]
    print(json.dumps(out))
    return 0


def cmd_fx(args):
    """Cross-currency price beside its closed form and z (mc_tpu/cli.py:
    533-573)."""
    from mc_tpu_torch import oracle
    from mc_tpu_torch.models.fx import FXDynamics, price_fx

    option, sim = _parse(args)
    fx = FXDynamics(x0=args.x0, sigma_x=args.sigma_x, r_f=args.rf,
                    rho=args.rho_fx, kx=args.kx, x_bar=args.x_bar)
    res = price_fx(option, fx, sim, args.contract, device=args.device)
    kx = args.x0 if args.kx is None else args.kx
    xb = args.x0 if args.x_bar is None else args.x_bar
    a = args
    ref = {
        "gk_call": lambda: oracle.gk_call(a.x0, kx, a.t, a.r, a.rf,
                                          a.sigma_x),
        "gk_put": lambda: oracle.gk_put(a.x0, kx, a.t, a.r, a.rf, a.sigma_x),
        "quanto_call": lambda: oracle.quanto_call(
            a.s0, a.k, a.t, a.r, a.rf, a.sigma, a.sigma_x, a.rho_fx, a.q,
            xb),
        "quanto_put": lambda: oracle.quanto_put(
            a.s0, a.k, a.t, a.r, a.rf, a.sigma, a.sigma_x, a.rho_fx, a.q,
            xb),
        "compo_call": lambda: oracle.compo_call(
            a.s0, a.x0, a.k, a.t, a.r, a.sigma, a.sigma_x, a.rho_fx, a.q),
        "compo_put": lambda: oracle.compo_put(
            a.s0, a.x0, a.k, a.t, a.r, a.sigma, a.sigma_x, a.rho_fx, a.q),
        "flexo_call": lambda: oracle.flexo_call(a.s0, a.x0, a.k, a.t, a.rf,
                                                a.sigma, a.q),
        "flexo_put": lambda: oracle.flexo_put(a.s0, a.x0, a.k, a.t, a.rf,
                                              a.sigma, a.q),
    }[args.contract]()
    z = (float(res.price) - ref) / max(float(res.stderr), 1e-12)
    print(json.dumps({"contract": args.contract, "price": float(res.price),
                      "stderr": float(res.stderr), "oracle": ref,
                      "z": round(z, 3)}))
    return 0


def cmd_qmc(args):
    """Randomized-QMC price as one JSON object (mc_tpu/cli.py:828-870);
    --model prices under a family's demo dynamics, the vanilla call under
    Heston and Bates beside its CF price."""
    from mc_tpu_torch.oracle import bs_call
    from mc_tpu_torch.qmc import price_qmc, price_qmc_model

    option, sim = _parse(args)
    if args.model != "gbm":
        res = price_qmc_model(args.model, option, None, sim,
                              payoff=args.payoff, family=args.family,
                              n_shifts=args.n_shifts, device=args.device)
        out = {"model": args.model, "price": float(res.price),
               "stderr": float(res.stderr),
               "point_n": int(float(res.n_paths)) // args.n_shifts,
               "n_shifts": args.n_shifts}
        if args.model == "heston" and args.payoff == "vanilla_call":
            from mc_tpu_torch.models.heston import DEMO_HESTON, heston_call_cf
            out["cf_oracle"] = float(heston_call_cf(
                args.s0, args.k, args.t, args.r, *DEMO_HESTON.astuple(),
                q=args.q))
        if args.model == "bates" and args.payoff == "vanilla_call":
            from mc_tpu_torch.models.bates import DEMO_BATES, bates_call_cf
            out["cf_oracle"] = float(bates_call_cf(
                args.s0, args.k, args.t, args.r, *DEMO_BATES.astuple(),
                q=args.q))
        print(json.dumps(out))
        return 0
    res = price_qmc(option, sim, payoff=args.payoff, family=args.family,
                    n_shifts=args.n_shifts, device=args.device)
    out = {"price": float(res.price), "stderr": float(res.stderr),
           "lattice_n": int(float(res.n_paths)) // args.n_shifts,
           "n_shifts": args.n_shifts}
    if args.payoff in ("vanilla_call", "vanilla_put"):
        # the call's price for the put too, as mc_tpu prints it (C8)
        out["black_scholes"] = float(
            bs_call(args.s0, args.k, args.t, args.r, args.sigma, args.q))
    print(json.dumps(out))
    return 0


# The legs of the rates subcommands that mc_tpu_torch does not price yet:
# flag -> the ROADMAP item that ports it.
_RATES_LEGS = {"bermudan": "item 18, after item 17's LSMC",
               "bounds": "item 18, after item 17's LSMC",
               "qmc": "item 18", "greeks": "item 18", "exposure": "item 18",
               "cva_hazard": "item 18", "book_k_rates": "item 18",
               "book_sides": "item 18", "book_weights": "item 18",
               "bucket_dv01": "item 18", "curve_var": "item 19"}


def _refuse_rates_legs(args, command: str) -> None:
    for flag, item in _RATES_LEGS.items():
        if getattr(args, flag, None) not in (None, False):
            raise SystemExit(
                f"{command} --{flag.replace('_', '-')} is not ported to "
                f"mc_tpu_torch yet (ROADMAP {item}); drop it to price the "
                "European swaption")


def _swaption_spec(args):
    from mc_tpu_torch.models.swaption import SwaptionSpec

    return SwaptionSpec(expiry=args.expiry, tenor=args.tenor,
                        n_payments=args.n_payments, k_rate=args.k_rate,
                        payer=not args.receiver)


def _rates_curve(args):
    """(curve, knot times): the zero knots, or the curve bootstrapped from
    --par-swap-rates (mc_tpu/cli.py:1310-1322)."""
    from mc_tpu_torch.models.hullwhite import DiscountCurve

    times = [float(x) for x in args.curve_times.split(",")]
    zeros = [float(x) for x in args.curve_zeros.split(",")]
    if args.par_swap_rates:
        mats = ([float(x) for x in args.par_swap_times.split(",")]
                if args.par_swap_times else times)
        pars = [float(x) for x in args.par_swap_rates.split(",")]
        curve = DiscountCurve.from_par_swaps(mats, pars, tenor=args.tenor)
        return curve, list(curve.times), list(curve.zeros)
    return DiscountCurve(times, zeros), times, zeros


def _rates_out(head: dict, res, ref: float) -> dict:
    return {**head, "price": float(res.price), "stderr": float(res.stderr),
            "oracle": ref,
            "z_score": (float(res.price) - ref) / float(res.stderr)}


def cmd_swaption(args):
    """The European Vasicek swaption (r0 is --rate) beside Jamshidian's
    price and the z-score (mc_tpu/cli.py:1210-1229)."""
    from mc_tpu_torch import oracle
    from mc_tpu_torch.models.swaption import price_swaption
    from mc_tpu_torch.models.vasicek import VasicekDynamics

    _refuse_rates_legs(args, "swaption")
    _, sim = _parse(args)
    dyn = VasicekDynamics(a=args.a, b=args.b, sigma_r=args.sigma_r)
    res = price_swaption(_swaption_spec(args), dyn, sim, r0=args.r,
                         seed=args.seed, device=args.device)
    ref = oracle.vasicek_swaption(args.r, args.a, args.b, args.sigma_r,
                                  args.expiry, args.tenor, args.n_payments,
                                  args.k_rate, payer=not args.receiver)
    print(json.dumps(_rates_out({"style": "european"}, res, ref)))
    return 0


def cmd_hullwhite(args):
    """The European swaption under curve-fitted Hull-White beside the
    curve-consistent Jamshidian price (the multi-curve quadrature with
    --proj-spread-bp), the z-score and the curve's discounts at its knots
    (mc_tpu/cli.py:1301-1361)."""
    from mc_tpu_torch import oracle
    from mc_tpu_torch.models.hullwhite import (DiscountCurve,
                                               HullWhiteDynamics,
                                               price_hw_swaption)

    _refuse_rates_legs(args, "hullwhite")
    _, sim = _parse(args)
    curve, times, zeros = _rates_curve(args)
    proj = None
    if args.proj_spread_bp:
        proj = DiscountCurve(times,
                             [z + args.proj_spread_bp * 1e-4 for z in zeros])
    dyn = HullWhiteDynamics(a=args.a, sigma_r=args.sigma_r)
    res = price_hw_swaption(_swaption_spec(args), dyn, curve, sim,
                            seed=args.seed, projection_curve=proj,
                            device=args.device)
    if proj is not None:
        ref = oracle.hw_swaption_multicurve(
            args.a, args.sigma_r, curve.df, proj.df, args.expiry,
            args.tenor, args.n_payments, args.k_rate,
            payer=not args.receiver)
    else:
        ref = oracle.hw_swaption(args.a, args.sigma_r, curve.df, args.expiry,
                                 args.tenor, args.n_payments, args.k_rate,
                                 payer=not args.receiver)
    out = _rates_out({"model": "hull-white"}, res, ref)
    out["curve_dfs"] = [round(curve.df(t), 6) for t in times]
    print(json.dumps(out))
    return 0


def cmd_g2pp(args):
    """The European swaption under curve-fitted G2++ beside the
    conditional-Jamshidian price and the z-score (mc_tpu/cli.py:
    1468-1494)."""
    from mc_tpu_torch import oracle
    from mc_tpu_torch.models.g2pp import G2Dynamics, price_g2_swaption

    _refuse_rates_legs(args, "g2pp")
    _, sim = _parse(args)
    curve, _, _ = _rates_curve(args)
    dyn = G2Dynamics(a=args.a, sigma=args.sigma_x, b_mr=args.b_mr,
                     eta=args.eta, rho=args.rho_xy)
    res = price_g2_swaption(_swaption_spec(args), dyn, curve, sim,
                            seed=args.seed, device=args.device)
    ref = oracle.g2_swaption(dyn.a, dyn.sigma, dyn.b_mr, dyn.eta, dyn.rho,
                             curve.df, args.expiry, args.tenor,
                             args.n_payments, args.k_rate,
                             payer=not args.receiver)
    print(json.dumps(_rates_out({"model": "g2++"}, res, ref)))
    return 0


def _add_vasicek_flags(p: argparse.ArgumentParser):
    p.add_argument("--a", type=float, default=0.3,
                   help="vasicek rate mean-reversion speed")
    p.add_argument("--b", type=float, default=0.05,
                   help="vasicek long-run rate level (r0 is --rate)")
    p.add_argument("--sigma-r", type=float, default=0.015,
                   help="vasicek rate volatility")
    p.add_argument("--rho-r", type=float, default=-0.3,
                   help="equity/rate correlation")


def _add_swap_flags(p: argparse.ArgumentParser, k_rate: float):
    p.add_argument("--expiry", type=float, default=1.0)
    p.add_argument("--tenor", type=float, default=0.5)
    p.add_argument("--n-payments", type=int, default=10)
    p.add_argument("--k-rate", type=float, default=k_rate,
                   help="fixed leg rate")
    p.add_argument("--receiver", action="store_true")


def _add_curve_flags(p: argparse.ArgumentParser):
    p.add_argument("--curve-times", default="0.5,1,2,3,5,10",
                   help="zero-curve knot times (years, ascending)")
    p.add_argument("--curve-zeros", default="0.03,0.035,0.04,0.043,"
                                            "0.046,0.048",
                   help="zero rates at the knots (the curve the model "
                        "reprices exactly)")
    p.add_argument("--par-swap-rates", default=None,
                   help="bootstrap the curve from par swap quotes instead "
                        "(comma list; maturities from --par-swap-times, "
                        "default --curve-times; on the --tenor grid)")
    p.add_argument("--par-swap-times", default=None)


def _add_basket_flags(p: argparse.ArgumentParser):
    p.add_argument("--n-assets", type=int, default=4, help="basket size")
    p.add_argument("--corr", type=float, default=0.5,
                   help="basket pairwise correlation")


def cmd_nmc(args):
    import numpy as np

    from mc_tpu_torch.nmc import price_nmc
    from mc_tpu_torch.nmc_engine import NMC_FAMILIES, ensure_family

    option, sim = _parse(args)
    if args.wwr_spot_beta is not None and args.strategy != "grid":
        raise SystemExit("--wwr-spot-beta needs the outer spot grid: "
                         "--strategy grid")
    dyn = None  # the family's dynamics; cva_greeks reuses them
    if args.model != "gbm":
        try:
            ensure_family(args.model)
        except ValueError as e:
            raise SystemExit(f"--model {args.model}: {e}") from None
        dyn = _FAMILY_DYNAMICS[args.model](args)
    if args.book_strikes:
        return _nmc_book(args, option, sim, dyn)
    if args.model == "gbm":
        res = price_nmc(option, sim, payoff=args.payoff,
                        strategy=args.strategy, discount=args.discount,
                        device=args.device)
    else:
        if args.discount != "full":
            raise SystemExit(f"--discount is fixed (full) with --model "
                             f"{args.model}")
        res = NMC_FAMILIES[args.model](option, dyn, sim, payoff=args.payoff,
                                       strategy=args.strategy,
                                       device=args.device)
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
    if args.cva_greeks:
        if args.cva_hazard is None:
            raise SystemExit("--cva-greeks needs --cva-hazard")
        from mc_tpu_torch.greeks import cva_greeks
        g = cva_greeks(option, sim, args.payoff, hazard_rate=args.cva_hazard,
                       recovery=args.cva_recovery,
                       which=tuple(args.cva_greeks.split(",")),
                       model=None if args.model == "gbm" else args.model,
                       dyn=dyn, device=args.device)
        out["cva_greeks"] = {k: float(v) for k, v in g.items()}
    if args.surface_npz:
        np.savez_compressed(args.surface_npz,
                            surface=res.surface_matrix().cpu().numpy())
        out["surface_npz"] = args.surface_npz
    print(json.dumps(out))
    return 0


def _nmc_book(args, option, sim, dyn):
    """nmc --book-strikes: the netting-set NMC, one contract per strike,
    netted EE/PFE/CVA (mc_tpu/cli.py:265-309)."""
    import numpy as np

    from mc_tpu_torch.nmc_book import price_nmc_book

    if args.cva_greeks:
        raise SystemExit("--cva-greeks differentiates a single contract's "
                         "CVA; not supported with --book-strikes")
    ks = [float(x) for x in args.book_strikes.split(",")]
    ws = ([float(x) for x in args.book_weights.split(",")]
          if args.book_weights else None)
    book = dataclasses.replace(
        option, **{f.name: np.full(len(ks), getattr(option, f.name),
                                   np.float32)
                   for f in dataclasses.fields(option) if f.name != "k"},
        k=np.asarray(ks, np.float32))
    res = price_nmc_book(book, sim, payoff=args.payoff, weights=ws,
                         model=args.model, dyn=dyn, device=args.device)
    ee, pfe = res.exposure_profile(args.pfe_quantile)
    out = {
        "n_contracts": len(ks),
        "net_outer_price": float(res.net_outer_price),
        "per_contract_price": [round(float(x), 6)
                               for x in res.outers.price.tolist()],
        "netted_ee": _profile(ee),
        "netted_pfe": _profile(pfe),
        "sum_of_standalone_ee": _profile(res.ee_contract.sum(dim=0)),
    }
    if args.cva_hazard is not None:
        out["netted_cva"] = float(res.cva(args.cva_hazard, args.cva_recovery))
    out = _xva_outputs(res, args, out)
    print(json.dumps(out))
    return 0


def cmd_info(args):
    """The device summary (mc_tpu/cli.py:882-885)."""
    from mc_tpu_torch.utils import device_summary
    print(device_summary(args.device))
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
    p.add_argument("--model", default="gbm",
                   choices=("gbm", "heston", "bates", "merton", "vasicek",
                            "localvol", "cev", "basket", "sabr", "term",
                            "rainbow"),
                   help="the outer and inner dynamics: gbm, heston, merton, "
                        "bates, cev, localvol, sabr, term, vasicek, basket or "
                        "rainbow (the basket's flags; payoffs call_on_max "
                        "etc. or a registry payoff on the running max)")
    p.add_argument("--surface-npz", default=None,
                   help="save the (paths, steps) surface to this .npz")
    p.add_argument("--exposure", action="store_true",
                   help="emit EE/PFE exposure profiles from the surface")
    p.add_argument("--pfe-quantile", type=float, default=0.95)
    p.add_argument("--cva-hazard", type=float, default=None,
                   help="flat hazard rate: emit unilateral CVA")
    p.add_argument("--cva-recovery", type=float, default=0.4)
    p.add_argument("--cva-greeks", default=None,
                   help="comma list of CVA sensitivities by forward-mode "
                        "AD through the nested pipeline: option greeks "
                        "(delta,rho,dual_delta; vega under gbm) or, with "
                        "--model, any scalar dynamics field (e.g. "
                        "'delta,v0,xi' under heston, 'delta,lam' under "
                        "merton); needs --cva-hazard")
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
    _add_heston_flags(p)
    _add_jump_flags(p)
    p.add_argument("--sigma-atm", type=float, default=0.2,
                   help="cev at-the-money vol")
    p.add_argument("--beta", type=float, default=0.5,
                   help="cev elasticity")
    p.add_argument("--smile-curv", type=float, default=0.1,
                   help="localvol: sigma(x) = sigma + curv*x^2")
    p.add_argument("--alpha", type=float, default=0.2,
                   help="sabr initial vol")
    p.add_argument("--nu", type=float, default=0.4,
                   help="sabr vol-of-vol (its rho is --rho-sv)")
    _add_vasicek_flags(p)
    _add_basket_flags(p)
    p.add_argument("--book-strikes", default=None,
                   help="comma list of strikes: netting-set NMC (netted "
                        "EE/PFE/CVA over the book)")
    p.add_argument("--book-weights", default=None,
                   help="comma list of +/- position sizes (with "
                        "--book-strikes; default all +1)")
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

    p = sub.add_parser("heston", help="Heston stochastic-vol price, JSON")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    _add_heston_flags(p)
    p.add_argument("--scheme", default="euler", choices=("euler", "qe"),
                   help="discretization: full-truncation Euler or Andersen "
                        "QE (exact per-step martingale, low bias at coarse "
                        "steps)")
    p.set_defaults(fn=cmd_heston)

    p = sub.add_parser("merton",
                       help="Merton jump-diffusion price (series oracle)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--method", choices=("euler", "terminal"),
                   default="euler")
    p.add_argument("--antithetic", action="store_true")
    _add_jump_flags(p)
    p.set_defaults(fn=cmd_merton)

    p = sub.add_parser("bates", help="Bates SVJ (Heston + jumps) price vs "
                       "the factorized CF oracle")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    _add_heston_flags(p)
    _add_jump_flags(p)
    p.add_argument("--scheme", default="euler", choices=("euler", "qe"),
                   help="diffusion substep; jumps are exact in law either "
                        "way")
    p.set_defaults(fn=cmd_bates)

    p = sub.add_parser("cev", help="CEV local-vol price (ncx2 oracle)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--sigma-atm", type=float, default=0.2)
    p.add_argument("--beta", type=float, default=0.5)
    p.set_defaults(fn=cmd_cev)

    p = sub.add_parser("localvol",
                       help="local-volatility surface price (CEV oracle "
                            "with --beta)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--smile-curv", type=float, default=0.1,
                   help="sigma(x,t) = sigma + curv*x^2 + slope*t")
    p.add_argument("--term-slope", type=float, default=0.05)
    p.add_argument("--beta", type=float, default=None,
                   help="CEV-shaped surface sigma*e^{(beta-1)x} instead "
                        "(prints the noncentral-chi^2 oracle z-score)")
    p.add_argument("--n-knots", type=int, default=9)
    p.set_defaults(fn=cmd_localvol)

    p = sub.add_parser("sabr",
                       help="SABR stochastic-vol price (Hagan oracle)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--alpha", type=float, default=0.2,
                   help="initial forward vol")
    p.add_argument("--beta", type=float, default=1.0,
                   help="CEV backbone exponent")
    p.add_argument("--nu", type=float, default=0.4, help="vol-of-vol")
    p.add_argument("--rho-fv", type=float, default=-0.4,
                   help="forward-vol correlation")
    p.set_defaults(fn=cmd_sabr)

    p = sub.add_parser("term",
                       help="rate/vol term-structure price (averaged-BS "
                            "oracle)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--rate-knots", default="0.10,0.07,0.05",
                   help="comma list spread evenly over the steps")
    p.add_argument("--sigma-knots", default="0.15,0.22,0.30")
    p.set_defaults(fn=cmd_term)

    p = sub.add_parser("divs",
                       help="GBM with discrete cash dividends "
                            "(quadrature oracle)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--div-steps", default="24",
                   help="comma list of dividend step indices")
    p.add_argument("--div-amounts", default="5.0",
                   help="comma list of cash amounts")
    p.set_defaults(fn=cmd_divs)

    p = sub.add_parser("vasicek",
                       help="stochastic-rate (Black-Scholes-Vasicek) price, "
                            "pathwise discounting")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call",
                   help="any registry payoff; 'zcb' prices the bond")
    p.add_argument("--antithetic", action="store_true")
    _add_vasicek_flags(p)
    p.set_defaults(fn=cmd_vasicek)

    p = sub.add_parser("basket", help="correlated multi-asset basket price")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    _add_basket_flags(p)
    p.set_defaults(fn=cmd_basket)

    p = sub.add_parser("rainbow",
                       help="best-of/worst-of rainbow (Stulz/Margrabe "
                            "oracle at d=2)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="call_on_max",
                   help="call_on_max|call_on_min|put_on_max|put_on_min|"
                        "exchange|best_of_cash")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--greeks", action="store_true",
                   help="per-asset delta/vega + cega (one backward pass)")
    p.add_argument("--n-assets", type=int, default=2)
    p.add_argument("--corr", type=float, default=0.5)
    p.add_argument("--s02", type=float, default=105.0,
                   help="last asset's spot (spots interpolate s0..s02)")
    p.add_argument("--sigma2", type=float, default=0.25,
                   help="last asset's vol (vols interpolate sigma..sigma2)")
    p.set_defaults(fn=cmd_rainbow)

    p = sub.add_parser("fx", help="cross-currency quanto/compo/GK/flexo "
                       "price vs exact closed form")
    _add_option_flags(p)
    p.add_argument("--contract", default="quanto_call",
                   choices=["gk_call", "gk_put", "quanto_call",
                            "quanto_put", "compo_call", "compo_put",
                            "flexo_call", "flexo_put"])
    p.add_argument("--x0", type=float, default=1.0,
                   help="FX spot, domestic per foreign")
    p.add_argument("--sigma-x", type=float, default=0.15)
    p.add_argument("--rf", type=float, default=0.03,
                   help="foreign short rate")
    p.add_argument("--rho-fx", type=float, default=-0.35,
                   help="asset/FX log-return correlation")
    p.add_argument("--kx", type=float, default=None,
                   help="FX strike for gk contracts (default: x0)")
    p.add_argument("--x-bar", type=float, default=None,
                   help="fixed quanto conversion rate (default: x0)")
    p.set_defaults(fn=cmd_fx)

    p = sub.add_parser("qmc", help="randomized-QMC price (lattice/Sobol)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--n-shifts", type=int, default=16)
    p.add_argument("--family", choices=("lattice", "sobol"),
                   default="lattice")
    p.add_argument("--model",
                   choices=("gbm", "heston", "bates", "basket", "cev", "sabr",
                            "localvol", "vasicek", "merton", "term"),
                   default="gbm",
                   help="drive a model family's step loop (its demo "
                        "dynamics) from the low-discrepancy points")
    p.set_defaults(fn=cmd_qmc)

    p = sub.add_parser("swaption",
                       help="Vasicek European swaption: one exact draw at "
                            "expiry vs Jamshidian")
    _add_option_flags(p)
    _add_swap_flags(p, k_rate=0.05)
    p.add_argument("--bermudan", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--bounds", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--bounds-inner", type=int, default=32)
    p.add_argument("--qmc", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--greeks", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--exposure", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--cva-hazard", type=float, default=None)
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--a", type=float, default=0.3)
    p.add_argument("--b", type=float, default=0.05)
    p.add_argument("--sigma-r", type=float, default=0.015)
    p.set_defaults(fn=cmd_swaption)

    p = sub.add_parser("hullwhite",
                       help="curve-fitted Hull-White European swaption vs "
                            "the curve-consistent Jamshidian oracle")
    _add_option_flags(p)
    _add_swap_flags(p, k_rate=0.04)
    _add_curve_flags(p)
    p.add_argument("--exposure", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--proj-spread-bp", type=float, default=0.0,
                   help="MULTI-CURVE: forwards off a projection curve "
                        "this many bp above the discount (OIS) curve")
    p.add_argument("--book-k-rates", default=None,
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--book-sides", default=None)
    p.add_argument("--book-weights", default=None)
    p.add_argument("--bermudan", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--bounds", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--qmc", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--greeks", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--bucket-dv01", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--curve-var", action="store_true",
                   help="not ported yet (ROADMAP item 19)")
    p.add_argument("--var-scenarios", type=int, default=256)
    p.add_argument("--var-alpha", type=float, default=0.99)
    p.add_argument("--var-horizon-days", type=float, default=10.0)
    p.add_argument("--cva-hazard", type=float, default=None)
    p.add_argument("--a", type=float, default=0.3)
    p.add_argument("--sigma-r", type=float, default=0.015)
    p.set_defaults(fn=cmd_hullwhite)

    p = sub.add_parser("g2pp",
                       help="curve-fitted G2++ two-factor European swaption "
                            "vs the conditional-Jamshidian oracle")
    _add_option_flags(p)
    _add_swap_flags(p, k_rate=0.04)
    _add_curve_flags(p)
    p.add_argument("--exposure", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--bermudan", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--bounds", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--qmc", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--greeks", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--bucket-dv01", action="store_true",
                   help="not ported yet (ROADMAP item 18)")
    p.add_argument("--cva-hazard", type=float, default=None)
    p.add_argument("--a", type=float, default=0.5)
    p.add_argument("--sigma-x", type=float, default=0.01,
                   help="first-factor vol")
    p.add_argument("--b-mr", type=float, default=0.05,
                   help="second-factor mean reversion")
    p.add_argument("--eta", type=float, default=0.008,
                   help="second-factor vol")
    p.add_argument("--rho-xy", type=float, default=-0.7,
                   help="factor correlation")
    p.set_defaults(fn=cmd_g2pp)

    p = sub.add_parser("info", help="devices, memory, power limit")
    p.add_argument("--device", default="cuda",
                   help="the device to describe (cuda | cpu)")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("traj", help="dump trajectories CSV (testing.cu)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="bullet_call")
    p.add_argument("--out", default="testing.csv")
    p.set_defaults(fn=cmd_traj)

    args = ap.parse_args(argv)
    return args.fn(args)
