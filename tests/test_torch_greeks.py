"""mc_tpu_torch.greeks against Black-Scholes and against mc_tpu on the CPU
(the GBM cases of tests/test_greeks.py, then the cross-package checks).

On the CPU every route runs plain PyTorch: the kernel route the greek
kernel's plain version, the autograd route the simulate kernel's plain
version forward and backward, fd and lrm as on the card.  mc_tpu runs its
greek kernel in interpret mode (engine="pallas") or its XLA dual
(engine="xla"), on the same threefry stream.

Tolerances:
* closed forms: as tests/test_greeks.py (relative, or 4 stderr);
* like route against like route: 1e-4 relative (mc_tpu's f32 tangents
  and finish against the port's f32 tangents and f64 finish: ~1e-6 seen);
* fd against mc_tpu: 1e-4 relative plus mc_tpu's f32 rounding of the
  prices it differences (8 units of roundoff a price), divided by the
  bump: that rounding is the whole difference at a small bump;
* the plain greek kernel against mc_tpu's: 1e-5 relative on all 10
  moments (~1e-7 seen);
* hand tangent rules against torch.func.jvp: 1e-6 relative (torch's
  forward rule for maximum associates the tie split differently).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.greeks import greeks as jgreeks
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, oracle
from mc_tpu_torch.greeks import greeks
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PATHWISE, get_payoff

torch.set_num_threads(1)

S0, K, T, R, SIG = 100.0, 100.0, 1.0, 0.1, 0.2
SIM = mt.SimParams(n_paths=200_000, n_steps=20)
CPU = dict(device="cpu")
EPS32 = 2.0 ** -24


def _ncdf(x):
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def bs_closed_forms():
    sqrt_t = math.sqrt(T)
    d1 = (math.log(S0 / K) + (R + 0.5 * SIG ** 2) * T) / (SIG * sqrt_t)
    d2 = d1 - SIG * sqrt_t
    phi_d1 = math.exp(-0.5 * d1 * d1) / math.sqrt(2 * math.pi)
    return dict(
        delta=_ncdf(d1),
        gamma=phi_d1 / (S0 * SIG * sqrt_t),
        vega=S0 * phi_d1 * sqrt_t,
        rho=K * T * math.exp(-R * T) * _ncdf(d2),
        theta=(-(S0 * phi_d1 * SIG / (2 * sqrt_t))
               - R * K * math.exp(-R * T) * _ncdf(d2)),
    )


@pytest.fixture(scope="module")
def bs():
    return bs_closed_forms()


# --- the cases of tests/test_greeks.py (GBM) -------------------------------

def test_pathwise_first_order(bs):
    g = greeks(sim=SIM, antithetic=True,
               which=("delta", "vega", "rho", "theta"), **CPU)
    assert float(g["delta"]) == pytest.approx(bs["delta"], rel=0.01)
    assert float(g["vega"]) == pytest.approx(bs["vega"], rel=0.03)
    assert float(g["rho"]) == pytest.approx(bs["rho"], rel=0.02)
    assert float(g["theta"]) == pytest.approx(bs["theta"], rel=0.03)


def test_pathwise_gamma_via_crn(bs):
    g = greeks(sim=SIM, antithetic=True, which=("gamma",), **CPU)
    assert float(g["gamma"]) == pytest.approx(bs["gamma"], rel=0.1)


def test_fd_matches_pathwise(bs):
    fd = greeks(sim=SIM, method="fd", which=("delta", "vega"), **CPU)
    assert float(fd["delta"]) == pytest.approx(bs["delta"], rel=0.02)
    assert float(fd["vega"]) == pytest.approx(bs["vega"], rel=0.05)


def test_bullet_requires_fd():
    with pytest.raises(ValueError, match="discontinuous"):
        greeks(payoff="bullet_call", sim=SIM, **CPU)
    g = greeks(mt.OptionParams(p1=2.0, p2=12.0),
               mt.SimParams(n_paths=100_000, n_steps=20),
               payoff="bullet_call", method="fd", which=("delta",), **CPU)
    assert 0.0 < float(g["delta"]) < 1.5


def test_unknown_greek():
    with pytest.raises(ValueError, match="unknown greeks"):
        greeks(which=("charm",), **CPU)
    with pytest.raises(ValueError, match="unknown method"):
        greeks(method="adjoint", **CPU)


def test_delta_consistent_with_oracle_fn():
    g = greeks(sim=SIM, antithetic=True, which=("delta",), **CPU)
    assert float(g["delta"]) == pytest.approx(
        oracle.bs_delta_call(S0, K, T, R, SIG), rel=0.01)


def test_oracles_match_mc_tpu():
    args = (S0, 95.0, 0.7, 0.03, 0.25, 0.01)
    for name in ("bs_delta_call", "bs_vega", "bs_gamma"):
        assert getattr(oracle, name)(*args) == pytest.approx(
            float(getattr(mc_tpu.oracle, name)(*args)), rel=1e-5)  # f32


# --- likelihood-ratio method -----------------------------------------------

def test_lrm_vanilla_vs_closed_forms():
    cf = bs_closed_forms()
    g = greeks(sim=mt.SimParams(n_paths=1 << 20, n_steps=1), method="lrm",
               which=("delta", "vega", "rho", "epsilon"), **CPU)
    for k in ("delta", "vega", "rho"):
        se = float(g[f"{k}_stderr"])
        assert abs(float(g[k]) - cf[k]) <= 4.0 * se, (k, float(g[k]), cf[k])
    # epsilon (dP/dq) closed form: -S0 T e^{-qT} N(d1) = -S0 T delta at q=0
    assert abs(float(g["epsilon"]) - (-S0 * T * cf["delta"])) <= \
        4.0 * float(g["epsilon_stderr"])


def test_lrm_bullet_vs_crn_fd():
    """LRM against a big-bump CRN central difference on the discontinuous
    bullet (the FD bump must be large: its variance grows like 1/h)."""
    opt = mt.OptionParams(p1=2.0, p2=10.0)
    sim = mt.SimParams(n_paths=1 << 19, n_steps=20)
    gl = greeks(opt, sim, "bullet_call", method="lrm",
                which=("delta", "vega", "rho"), **CPU)
    gf = greeks(opt, sim, "bullet_call", method="fd",
                which=("delta", "vega", "rho"), rel_bump=5e-2, **CPU)
    for k in ("delta", "vega", "rho"):
        tol = 5.0 * float(gl[f"{k}_stderr"]) + 0.05 * abs(float(gl[k]))
        assert abs(float(gl[k]) - float(gf[k])) <= tol, (k, gl[k], gf[k])


def test_lrm_gamma_vanilla_vs_closed_form():
    g = greeks(sim=mt.SimParams(n_paths=1 << 21, n_steps=1), method="lrm",
               which=("gamma",), **CPU)
    cf = oracle.bs_gamma(S0, K, T, R, SIG)
    assert abs(float(g["gamma"]) - cf) <= 4.0 * float(g["gamma_stderr"])


def test_lrm_gamma_digital_vs_closed_form():
    """Unbiased gamma on a discontinuous payoff: e^{-rT} d/ds0 of
    phi(d2)/(s0 sigma sqrt(T))."""
    g = greeks(sim=mt.SimParams(n_paths=1 << 21, n_steps=1),
               payoff="digital_call", method="lrm", which=("gamma",), **CPU)
    st = SIG * math.sqrt(T)
    d2 = (math.log(S0 / K) + (R - 0.5 * SIG ** 2) * T) / st
    phi = math.exp(-0.5 * d2 * d2) / math.sqrt(2.0 * math.pi)
    cf = math.exp(-R * T) * phi * (-d2 / st - 1.0) / (S0 * S0 * st)
    assert abs(float(g["gamma"]) - cf) <= 4.0 * float(g["gamma_stderr"])


def test_lrm_gamma_bullet_euler_sane():
    opt = mt.OptionParams(p1=2.0, p2=10.0)
    sim = mt.SimParams(n_paths=1 << 19, n_steps=20)
    gl = greeks(opt, sim, "bullet_call", method="lrm", which=("gamma",),
                **CPU)
    gf = greeks(opt, sim, "bullet_call", method="fd", which=("gamma",),
                rel_bump=8e-2, **CPU)
    tol = (5.0 * float(gl["gamma_stderr"]) + 0.15 * abs(float(gl["gamma"]))
           + 1e-4)
    assert abs(float(gl["gamma"]) - float(gf["gamma"])) <= tol


def test_lrm_price_bitwise_with_engine():
    """The LRM pass draws price()'s stream: its implied price is bitwise
    price(method="euler") (both plain versions on the CPU)."""
    opt = mt.OptionParams(p1=2.0, p2=10.0)
    sim = mt.SimParams(n_paths=1 << 16, n_steps=20)
    g = greeks(opt, sim, "bullet_call", method="lrm", which=("delta",),
               **CPU)
    r = mt.price(opt, sim, "bullet_call", method="euler", **CPU)
    assert float(g["price"]) == float(r.price)
    assert float(g["price_stderr"]) == float(r.stderr)
    gt = greeks(sim=sim, method="lrm", which=("delta",), **CPU)
    rt = mt.price(sim=sim, method="terminal", **CPU)
    assert float(gt["price"]) == float(rt.price)


def test_lrm_guards():
    with pytest.raises(ValueError, match="LRM supports"):
        greeks(method="lrm", which=("theta",), **CPU)
    with pytest.raises(ValueError, match="antithetic"):
        greeks(method="lrm", which=("delta",), antithetic=True, **CPU)
    with pytest.raises(ValueError, match="lrm"):
        greeks(payoff="bullet_call", method="pathwise", **CPU)


def test_lrm_odd_step_count():
    g = greeks(mt.OptionParams(p1=1.0, p2=4.0),
               mt.SimParams(n_paths=1 << 16, n_steps=5), "bullet_call",
               method="lrm", which=("delta",), **CPU)
    assert np.isfinite(float(g["delta"]))


# --- the fused pathwise kernel (its plain version here) ---------------------

def test_pathwise_kernel_matches_grad():
    """The kernel's hand tangents and autograd through price() compute the
    same estimator on the same draws (they associate the tangents
    differently, hence mc_tpu's 1e-3 across routes)."""
    sim = mt.SimParams(n_paths=1 << 17, n_steps=16)
    for payoff in ("vanilla_call", "asian_call", "lookback_call"):
        gk = greeks(sim=sim, payoff=payoff, sim_method="euler",
                    which=("delta", "vega", "rho", "epsilon"), **CPU)
        gx = greeks(sim=sim, payoff=payoff, sim_method="euler",
                    which=("delta", "vega", "rho", "theta"), **CPU)
        assert "delta_stderr" in gk and "delta_stderr" not in gx
        for k in ("delta", "vega", "rho"):
            a, b = float(gk[k]), float(gx[k])
            assert abs(a - b) <= 1e-3 * max(1.0, abs(b)) + 1e-4, (
                payoff, k, a, b)


def test_pathwise_kernel_terminal_vs_closed_form():
    g = greeks(sim=mt.SimParams(n_paths=1 << 20, n_steps=1),
               which=("delta", "vega", "rho", "epsilon"), **CPU)
    cf = bs_closed_forms()
    for k in ("delta", "vega", "rho"):
        assert abs(float(g[k]) - cf[k]) <= 4.0 * float(g[f"{k}_stderr"]), k
    assert abs(float(g["epsilon"]) - (-S0 * T * cf["delta"])) <= \
        4.0 * float(g["epsilon_stderr"])


def test_pathwise_kernel_fallthrough():
    """Requests outside the fused kernel's set go to torch.autograd.grad
    through price(), bitwise what a direct grad gives."""
    sim = mt.SimParams(n_paths=4096, n_steps=8)
    for which, kw, field, sgn in ((("theta",), {}, "t", -1.0),
                                  (("delta",), {"antithetic": True}, "s0",
                                   1.0)):
        g = greeks(sim=sim, which=which, **kw, **CPU)
        leaf = torch.tensor(float(getattr(mt.DEMO_OPTION, field)),
                            dtype=torch.float64, requires_grad=True)
        opt = mt.OptionParams(**{field: leaf})
        p = mt.price(opt, sim, method="terminal", **kw, **CPU).price
        (want,) = torch.autograd.grad(p, leaf)
        assert float(g[which[0]]) == sgn * float(want), which


def test_pathwise_kernel_refuses_other_payoffs():
    cfg = pk.KernelConfig(n_paths=64, n_steps=4)
    prm = pk.pack_params(mt.DEMO_OPTION, 4)
    with pytest.raises(ValueError, match="lrm"):
        pk.simulate_greek_partials(get_payoff("bullet_call"), cfg, (1, 2),
                                   prm)
    with pytest.raises(ValueError, match="antithetic"):
        pk.simulate_greek_partials(
            get_payoff("vanilla_call"),
            pk.KernelConfig(n_paths=64, n_steps=4, antithetic=True), (1, 2),
            prm)
    with pytest.raises(ValueError, match="path-dependent"):
        pk.simulate_greek_partials(
            get_payoff("asian_call"),
            pk.KernelConfig(n_paths=64, n_steps=4, method="terminal"),
            (1, 2), prm)


# --- cross-package: the port against mc_tpu on the same stream --------------

J_KEY = np.asarray(mc_tpu.rng.derive_key(1234, 0), np.uint32)
KEY = convert.key(J_KEY)
KERNEL_CASES = [(name, method, steps)
                for name in PATHWISE
                for method, steps in ((("terminal", 8),) if name in (
                    "vanilla_call", "vanilla_put", "best_of_cash") else ())
                + (("euler", 8), ("euler", 7))]


@pytest.mark.parametrize("name,method,steps", KERNEL_CASES)
def test_greek_partials_plain_matches_mc_tpu(name, method, steps):
    """All 10 moments of the plain greek kernel against mc_tpu's Pallas
    greek kernel in interpret mode, at 4,096 paths (7 steps: the odd
    epilogue)."""
    jcfg = jpk.KernelConfig(n_paths=4096, n_steps=steps, tile_rows=8,
                            method=method)
    slabs = jpk.simulate_greek_partials(
        jget_payoff(name), jcfg, jnp.asarray(J_KEY),
        jpk.pack_params(mc_tpu.OptionParams().as_f32(), steps), True)
    want = np.array([float(jfinish_sum(s)) for s in slabs])
    cfg = pk.KernelConfig(n_paths=4096, n_steps=steps, method=method)
    got = pk.simulate_greek_partials(
        get_payoff(name), cfg, KEY,
        pk.pack_params(mt.DEMO_OPTION, steps)).sum(dim=0).numpy()
    assert got.shape == (10,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _tangent_inputs(name):
    """Per-path (state, dstate, s, ds, p) with exact ties planted."""
    rs = np.random.RandomState(11)
    n = 64
    p = pk.unpack_params(pk.pack_params(mt.DEMO_OPTION, 8))
    s = torch.from_numpy(rs.uniform(80, 120, n).astype(np.float32))
    s[:4] = float(p.k)  # S == K
    ds = torch.from_numpy(rs.standard_normal(n).astype(np.float32))
    po = get_payoff(name)
    if not po.n_state:
        return po, (), (), s, ds, p
    st = torch.from_numpy(rs.uniform(0, 150, n).astype(np.float32))
    if name == "asian_call":
        st[4:8] = float(p.k) / float(p.inv_n_steps)  # mean == K
    else:
        st[4:8] = s[4:8]                             # running max == S
        st[8:12] = float(p.k)                        # max == K
    dst = torch.from_numpy(rs.standard_normal(n).astype(np.float32))
    return po, (st,), (dst,), s, ds, p


@pytest.mark.parametrize("name", PATHWISE)
def test_tangent_rules_match_jvp(name):
    po, st, dst, s, ds, p = _tangent_inputs(name)
    if po.n_state:
        _, want = torch.func.jvp(lambda a, b: po.terminal((a,), b, p),
                                 (st[0], s), (dst[0], ds))
        _, want_u = torch.func.jvp(lambda a, b: po.update((a,), b, p)[0],
                                   (st[0], s), (dst[0], ds))
        (got_u,) = po.update_jvp(st, dst, s, ds, p)
        torch.testing.assert_close(got_u, want_u, rtol=1e-6, atol=1e-6)
    else:
        _, want = torch.func.jvp(lambda b: po.terminal((), b, p), (s,),
                                 (ds,))
    got = po.terminal_jvp(st, dst, s, ds, p)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # the tie splits the tangent half and half
    if name in ("vanilla_call", "best_of_cash"):
        torch.testing.assert_close(got[:4], 0.5 * ds[:4])


ROUTE_SIM = mc_tpu.SimParams(n_paths=4096, n_steps=8)
ALL = ("delta", "vega", "rho", "theta", "dual_delta", "epsilon", "gamma")


def _route_opt(payoff):
    # the bullet's window reachable within 8 steps
    return mc_tpu.OptionParams(**(dict(p1=1.0, p2=6.0)
                                  if payoff == "bullet_call" else {}))


def _route(payoff, method, which, engine, **kw):
    opt = _route_opt(payoff)
    want = jgreeks(opt, ROUTE_SIM, payoff, method=method, which=which,
                   engine=engine, **kw)
    got = greeks(convert.option_params(opt), convert.sim_params(ROUTE_SIM),
                 payoff, method=method, which=which, **kw, **CPU)
    assert sorted(got) == sorted(want)
    return got, want


@pytest.mark.parametrize("payoff", ["vanilla_call", "asian_call",
                                    "lookback_call"])
def test_kernel_route_matches_mc_tpu_pallas(payoff):
    got, want = _route(payoff, "pathwise", ("delta", "vega", "rho",
                                            "epsilon"), "pallas")
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4), k


@pytest.mark.parametrize("payoff", ["vanilla_put", "best_of_cash",
                                    "asian_call", "lookback_call"])
def test_autograd_route_matches_mc_tpu_xla(payoff):
    got, want = _route(payoff, "pathwise", ALL, "xla", antithetic=True)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4), k


@pytest.mark.parametrize("payoff", ["vanilla_call", "asian_call",
                                    "bullet_call"])
def test_fd_route_matches_mc_tpu_xla(payoff):
    got, want = _route(payoff, "fd", ALL, "xla")
    opt = _route_opt(payoff)
    price = float(mt.price(convert.option_params(opt),
                           convert.sim_params(ROUTE_SIM), payoff,
                           method="terminal" if payoff == "vanilla_call"
                           else "euler", **CPU).price)
    rounding = 8 * EPS32 * abs(price)  # mc_tpu's f32 price
    for k in want:
        if k == "gamma":
            h = 1e-3 * opt.s0
            bound = 4 * rounding / h ** 2
        else:
            base = getattr(opt, mc_tpu.greeks.GREEK_FIELDS[k][0])
            bound = rounding / (1e-3 * max(abs(base), 1e-2))
        assert abs(float(got[k]) - float(want[k])) <= (
            1e-4 * abs(float(want[k])) + bound), k


@pytest.mark.parametrize("payoff", ["vanilla_call", "bullet_call",
                                    "digital_call", "asian_call"])
def test_lrm_route_matches_mc_tpu_xla(payoff):
    got, want = _route(payoff, "lrm", ("delta", "vega", "rho", "epsilon",
                                       "gamma"), "xla")
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4), k
