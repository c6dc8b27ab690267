"""mc_tpu_torch's rainbow options against mc_tpu on the CPU.

The port runs its kernel's plain PyTorch version here (device="cpu").  Both
draw the ceil(d/2) pairs (id, q) of one exact terminal draw per path from
the basket's pack at n_steps = 1.  mc_tpu's XLA dual ignores
``rng_source`` (ROADMAP C11): threefry-13 is held to ``engine="xla"``,
threefry-20 to the Pallas kernel in interpret mode.

Tolerances (the parity contract): prices 1e-5 relative, stderrs 1e-5 plus
the bound of mc_tpu's f32 finish; the closed-form gates 3.5 stderr, as
tests/test_rainbow.py; the bivariate normal bit for bit against
mc_tpu's.
"""

import math

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu import oracle as joracle
from mc_tpu.models import basket as jb
from mc_tpu.models import rainbow as jr

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import basket as tb
from mc_tpu_torch.models import rainbow as tr
from mc_tpu_torch.oracle import (bs_call, bvn_cdf, margrabe, stulz_max_call,
                                 stulz_max_put, stulz_min_call, stulz_min_put)

torch.set_num_threads(1)

VANILLA_RTOL = 1e-5
EPS32 = 2.0 ** -24
RHO = 0.5
S1, S2, SIG1, SIG2 = 100.0, 105.0, 0.2, 0.25
SIM = mt.SimParams(n_paths=100_000, n_steps=1)
J_SIM = mc_tpu.SimParams(n_paths=3001, n_steps=1)  # a partial tile


def two_asset(rho=RHO):
    return tb.BasketDynamics(
        s0s=np.array([S1, S2], np.float32),
        sigmas=np.array([SIG1, SIG2], np.float32),
        weights=np.array([0.5, 0.5], np.float32),
        corr=np.array([[1.0, rho], [rho, 1.0]], np.float32))


def _f32_finish_rtol(res):
    mean, var = float(res.payoff_mean), float(res.payoff_var)
    if var == 0.0:
        return VANILLA_RTOL
    return VANILLA_RTOL + 0.5 * 8 * EPS32 * (var + 2 * mean * mean) / var


def _assert_close(got, want):
    assert float(got.price) == pytest.approx(float(want.price),
                                             rel=VANILLA_RTOL, abs=1e-9)
    assert float(got.stderr) == pytest.approx(
        float(want.stderr), rel=_f32_finish_rtol(got), abs=1e-9)


def _gate(res, want, n_se=3.5):
    assert abs(float(res.price) - want) <= n_se * float(res.stderr), (
        float(res.price), want, float(res.stderr))


# --- the bivariate normal ----------------------------------------------------


@pytest.mark.parametrize("rho", [-0.99, -0.95, -0.6, 0.0, 0.3, 0.74, 0.9,
                                 0.93, 0.99])
def test_bvn_center_identity(rho):
    """M(0, 0, rho) = 1/4 + asin(rho)/(2 pi), and bit for bit mc_tpu's."""
    want = 0.25 + math.asin(rho) / (2.0 * math.pi)
    assert bvn_cdf(0.0, 0.0, rho) == pytest.approx(want, abs=5e-15)
    assert bvn_cdf(0.3, -1.1, rho) == joracle.bvn_cdf(0.3, -1.1, rho)


def test_bvn_limits_and_marginals():
    phi = lambda z: 0.5 * math.erfc(-z / math.sqrt(2.0))
    for x, y in ((0.3, -1.1), (-0.5, 0.9), (1.7, 2.1)):
        assert bvn_cdf(x, y, 0.0) == pytest.approx(phi(x) * phi(y), abs=1e-14)
        assert bvn_cdf(x, y, 1.0) == pytest.approx(phi(min(x, y)), abs=1e-12)
        assert bvn_cdf(x, y, -1.0) == pytest.approx(
            max(phi(x) + phi(y) - 1.0, 0.0), abs=1e-12)
        assert bvn_cdf(x, y, 0.77) == pytest.approx(bvn_cdf(y, x, 0.77),
                                                    abs=1e-14)
        assert bvn_cdf(x, 37.0, 0.77) == pytest.approx(phi(x), abs=1e-14)


def test_bvn_vs_scipy():
    scipy_stats = pytest.importorskip("scipy.stats")
    rs = np.random.default_rng(7)
    for rho in (-0.99, -0.8, 0.5, 0.95, 0.99):  # both Genz branches
        for _ in range(5):
            x, y = rs.normal(size=2) * 1.5
            want = scipy_stats.multivariate_normal.cdf(
                [x, y], cov=[[1.0, rho], [rho, 1.0]])
            assert bvn_cdf(x, y, rho) == pytest.approx(want, abs=5e-10)


# --- price_rainbow against mc_tpu.price_rainbow ------------------------------


@pytest.mark.parametrize("payoff,d", [
    (p, d) for d in (1, 2, 4, 9) for p in sorted(tr.RAINBOW_PAYOFFS)
    if d >= tr.RAINBOW_PAYOFFS[p][1]])
def test_every_payoff_matches_mc_tpu(payoff, d):
    """On the demo basket (d = 9: the capacity-32 layout on the card), with
    the antithetic twin at d = 4."""
    anti = d == 4
    want = jr.price_rainbow(mc_tpu.OptionParams(k=98.0),
                            jb._demo_basket(d, 0.5), J_SIM, payoff,
                            engine="xla", antithetic=anti)
    got = tr.price_rainbow(mt.OptionParams(k=98.0), tb.demo_basket(d, 0.5),
                           convert.sim_params(J_SIM), payoff, antithetic=anti,
                           device="cpu")
    _assert_close(got, want)


@pytest.mark.parametrize("payoff", ["call_on_max", "exchange", "put_on_min"])
def test_threefry20_matches_the_pallas_kernel(payoff):
    """threefry-20 against mc_tpu's Pallas kernel in interpret mode (C11)."""
    jsim = mc_tpu.SimParams(n_paths=2048, n_steps=1, seed=3)
    b = convert.basket_dynamics(jb._demo_basket(3, 0.4))
    want = jr.price_rainbow(mc_tpu.OptionParams(k=98.0),
                            jb._demo_basket(3, 0.4), jsim, payoff,
                            engine="pallas", tile_rows=8, interpret=True,
                            rng_source="threefry")
    got = tr.price_rainbow(mt.OptionParams(k=98.0), b,
                           convert.sim_params(jsim), payoff,
                           rng_source="threefry", device="cpu")
    _assert_close(got, want)


def test_partials_offset_and_bound():
    key = rng.derive_key(3, 0, tr.RAINBOW_TAG)
    prm = tb.pack_basket(mt.OptionParams(), tb.demo_basket(5, 0.3), 1, "cpu")
    cfg = tr.RainbowConfig(n_paths=900, d=5, antithetic=True)
    whole = tr.rainbow_partials("call_on_min", cfg, key, prm).sum(0)
    a = tr.rainbow_partials("call_on_min", tr.RainbowConfig(500, 5, True),
                            key, prm).sum(0)
    b = tr.rainbow_partials("call_on_min", tr.RainbowConfig(400, 5, True),
                            key, prm, path_offset=500).sum(0)
    torch.testing.assert_close(a + b, whole, rtol=1e-12, atol=0.0)
    masked = tr.rainbow_partials("call_on_min", cfg, key, prm,
                                 n_valid=500).sum(0)
    assert float(masked[0]) == pytest.approx(float(a[0]), rel=1e-12)


# --- the cases of tests/test_rainbow.py --------------------------------------


def test_exchange_margrabe_gate():
    res = tr.price_rainbow(mt.OptionParams(), two_asset(), SIM, "exchange",
                           antithetic=True, device="cpu")
    _gate(res, margrabe(S1, S2, 1.0, SIG1, SIG2, RHO))


@pytest.mark.parametrize("payoff,oracle", [
    ("call_on_min", stulz_min_call), ("call_on_max", stulz_max_call),
    ("put_on_min", stulz_min_put), ("put_on_max", stulz_max_put)])
def test_stulz_gates(payoff, oracle):
    res = tr.price_rainbow(mt.OptionParams(k=98.0), two_asset(), SIM, payoff,
                           antithetic=True, device="cpu")
    _gate(res, oracle(S1, S2, 98.0, 1.0, 0.1, SIG1, SIG2, RHO))
    want = getattr(joracle, oracle.__name__)(S1, S2, 98.0, 1.0, 0.1, SIG1,
                                             SIG2, RHO)
    # the port's Black-Scholes is host f64 (mc_tpu's f32 moves the max's)
    assert oracle(S1, S2, 98.0, 1.0, 0.1, SIG1, SIG2, RHO) == pytest.approx(
        want, abs=1e-4)


def test_negative_correlation_gate():
    res = tr.price_rainbow(mt.OptionParams(k=100.0), two_asset(rho=-0.6), SIM,
                           "call_on_max", antithetic=True, device="cpu")
    _gate(res, stulz_max_call(S1, S2, 100.0, 1.0, 0.1, SIG1, SIG2, -0.6))


def test_min_max_multiset_identity():
    """max(M-K,0) + max(m-K,0) == max(S1-K,0) + max(S2-K,0) pathwise: the
    closed forms satisfy it exactly, the same-key estimates to MC noise of
    a two-vanilla estimate."""
    opt = mt.OptionParams(k=98.0)
    mx = tr.price_rainbow(opt, two_asset(), SIM, "call_on_max", device="cpu")
    mn = tr.price_rainbow(opt, two_asset(), SIM, "call_on_min", device="cpu")
    c1 = bs_call(S1, 98.0, 1.0, 0.1, SIG1)
    c2 = bs_call(S2, 98.0, 1.0, 0.1, SIG2)
    cf = (stulz_max_call(S1, S2, 98.0, 1.0, 0.1, SIG1, SIG2, RHO)
          + stulz_min_call(S1, S2, 98.0, 1.0, 0.1, SIG1, SIG2, RHO))
    assert cf == pytest.approx(c1 + c2, abs=1e-12)
    assert abs(float(mx.price) + float(mn.price) - (c1 + c2)) <= (
        3.5 * 2.0 * float(mx.stderr))


def test_best_of_cash_identity():
    """max(M, K) = max(M-K, 0) + K pathwise: the same-key estimates differ by
    the discounted cash leg."""
    opt = mt.OptionParams(k=110.0)
    sim = mt.SimParams(n_paths=50_000, n_steps=1)
    boc = float(tr.price_rainbow(opt, two_asset(), sim, "best_of_cash",
                                 device="cpu").price)
    com = float(tr.price_rainbow(opt, two_asset(), sim, "call_on_max",
                                 device="cpu").price)
    assert boc == pytest.approx(com + 110.0 * math.exp(-0.1), rel=2e-5)


def test_single_asset_reduces_to_bs():
    one = tb.BasketDynamics(s0s=np.array([100.0], np.float32),
                            sigmas=np.array([0.2], np.float32),
                            weights=np.array([1.0], np.float32),
                            corr=np.eye(1, dtype=np.float32))
    res = tr.price_rainbow(mt.OptionParams(), one, SIM, "call_on_max",
                           antithetic=True, device="cpu")
    _gate(res, bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    mn = tr.price_rainbow(mt.OptionParams(), one, SIM, "call_on_min",
                          antithetic=True, device="cpu")
    assert float(mn.price) == float(res.price)  # one asset: max == min


def test_more_assets_raise_max_call():
    def iid(d):
        return tb.BasketDynamics(s0s=np.full(d, 100.0, np.float32),
                                 sigmas=np.full(d, 0.2, np.float32),
                                 weights=np.full(d, 1.0 / d, np.float32),
                                 corr=np.eye(d, dtype=np.float32))
    sim = mt.SimParams(n_paths=20_000, n_steps=1)
    p2 = float(tr.price_rainbow(mt.OptionParams(), iid(2), sim, "call_on_max",
                                antithetic=True, device="cpu").price)
    p4 = float(tr.price_rainbow(mt.OptionParams(), iid(4), sim, "call_on_max",
                                antithetic=True, device="cpu").price)
    assert p4 > p2 + 1.0


def test_antithetic_reduces_stderr():
    plain = tr.price_rainbow(mt.OptionParams(), two_asset(), SIM,
                             "call_on_max", device="cpu")
    anti = tr.price_rainbow(mt.OptionParams(), two_asset(), SIM,
                            "call_on_max", antithetic=True, device="cpu")
    assert float(anti.stderr) < float(plain.stderr)


def test_validation():
    """The same calls raise in both packages; d = 33 and the TPU's
    hardware RNG are refused too."""
    one = tb.BasketDynamics(s0s=np.array([100.0], np.float32),
                            sigmas=np.array([0.2], np.float32),
                            weights=np.array([1.0], np.float32),
                            corr=np.eye(1, dtype=np.float32))
    with pytest.raises(KeyError, match="unknown rainbow payoff"):
        tr.price_rainbow(payoff="nope", device="cpu")
    with pytest.raises(KeyError, match="unknown rainbow payoff"):
        jr.price_rainbow(payoff="nope")
    with pytest.raises(ValueError, match="needs >= 2 assets"):
        tr.price_rainbow(basket=one, payoff="exchange", device="cpu")
    with pytest.raises(ValueError, match="needs >= 2 assets"):
        jr.price_rainbow(basket=convert.basket_dynamics(one),
                         payoff="exchange")
    with pytest.raises(ValueError, match="MAX_BASKET_D"):
        tr.price_rainbow(basket=tb.demo_basket(33), device="cpu")
    with pytest.raises(ValueError, match="hw"):
        tr.price_rainbow(rng_source="hw", device="cpu")
    prm = tb.pack_basket(mt.OptionParams(), tb.demo_basket(3), 1, "cpu")
    with pytest.raises(ValueError, match="params"):
        tr.rainbow_partials("call_on_max", tr.RainbowConfig(8, 4), (1, 2),
                            prm)
