"""mc_tpu_torch's strike ladder (price_ladder, the ladder kernel's plain
version) on the CPU: the cases of tests/test_ladder.py, and the ladder
against mc_tpu's engine="xla" ladder (``_xla_ladder``) on the same stream.

Tolerances: vanilla strikes 1e-5 relative in price (the per-path values
differ only where the frameworks' f32 libm differ by an ulp); the stderr 1e-5
plus the bound of mc_tpu's f32 finish (var = E[p^2] - E[p]^2 in f32); bullet
strikes 0.05 stderr (a barrier count can flip where S lands within an ulp of
B).  Inside the port a ladder strike equals the single-strike price on the
same key exactly: the same f32 per-path values, summed in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu import engines as jeng
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, oracle
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

SIM = mt.SimParams(n_paths=20_000, n_steps=20)
STRIKES = [80.0, 90.0, 100.0, 110.0, 120.0]
VANILLA_RTOL = 1e-5
BULLET_SE = 0.05
EPS32 = 2.0 ** -24


def test_ladder_matches_bs():
    res = mt.price_ladder(STRIKES, sim=SIM, antithetic=True, device="cpu")
    assert tuple(res.price.shape) == (len(STRIKES),)
    for i, k in enumerate(STRIKES):
        bs = oracle.bs_call(100.0, k, 1.0, 0.1, 0.2)
        assert abs(float(res.price[i]) - bs) <= 3.5 * float(res.stderr[i]), k


def test_ladder_monotone_decreasing():
    """Shared paths: the ladder is monotone in the strike path by path."""
    res = mt.price_ladder(STRIKES, sim=SIM, device="cpu")
    assert bool((torch.diff(res.price) < 0).all())


@pytest.mark.parametrize("method,antithetic", [
    ("terminal", False), ("terminal", True), ("euler", False),
    ("euler", True)])
def test_ladder_matches_single_strike(method, antithetic):
    """Strike m equals price(k=strikes[m]) on the same stream, exactly."""
    res = mt.price_ladder(STRIKES, sim=SIM, method=method,
                          antithetic=antithetic, device="cpu")
    for i, k in enumerate(STRIKES):
        single = mt.price(mt.OptionParams(k=k), SIM, method=method,
                          antithetic=antithetic, device="cpu")
        assert float(res.price[i]) == float(single.price), (method, k)
        assert float(res.stderr[i]) == float(single.stderr)


def test_ladder_bullet_payoff():
    res = mt.price_ladder(STRIKES, option=mt.OptionParams(p1=2.0, p2=12.0),
                          sim=SIM, payoff="bullet_call", device="cpu")
    p = res.price
    assert bool((torch.diff(p) < 0).all()) and bool((p > 0).all())


def _f32_finish_rtol(mean, var):
    return VANILLA_RTOL + 0.5 * 8 * EPS32 * (var + 2 * mean * mean) / var


@pytest.mark.parametrize("payoff,method,antithetic", [
    ("vanilla_call", "terminal", False),
    ("vanilla_call", "euler", True),
    ("vanilla_put", "terminal", True),
    ("bullet_call", "euler", False),
    ("asian_call", "euler", True),
])
def test_ladder_matches_mc_tpu(payoff, method, antithetic):
    jopt = mc_tpu.OptionParams(p1=1.0, p2=6.0)
    jsim = mc_tpu.SimParams(n_paths=4096, n_steps=16)
    want = mc_tpu.engines.price_ladder(STRIKES, jopt, jsim, payoff,
                                       method=method, engine="xla",
                                       antithetic=antithetic, tile_rows=8)
    got = mt.price_ladder(STRIKES, convert.option_params(jopt),
                          convert.sim_params(jsim), payoff, method=method,
                          antithetic=antithetic, device="cpu")
    for i in range(len(STRIKES)):
        gp, wp = float(got.price[i]), float(want.price[i])
        ws = float(want.stderr[i])
        if payoff == "bullet_call":
            assert abs(gp - wp) <= BULLET_SE * ws, (i, gp, wp, ws)
            assert abs(float(got.stderr[i]) - ws) <= BULLET_SE * ws
        else:
            assert gp == pytest.approx(wp, rel=VANILLA_RTOL), i
            assert float(got.stderr[i]) == pytest.approx(
                ws, rel=_f32_finish_rtol(float(got.payoff_mean[i]),
                                         float(got.payoff_var[i]))), i


def test_ladder_partials_match_xla_ladder():
    """The moment sums per strike against _xla_ladder's accumulators."""
    n_paths, n_steps = 2048, 10
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8,
                            antithetic=True)
    jopt = mc_tpu.OptionParams()
    acc_s, acc_q = jeng._xla_ladder(
        jget_payoff("vanilla_call"), jcfg, len(STRIKES),
        mc_tpu.rng.derive_key(3, 0), jopt.as_f32(),
        jnp.asarray(STRIKES, jnp.float32))
    want = np.array([[float(jfinish_sum(acc_s[m])), float(jfinish_sum(
        acc_q[m]))] for m in range(len(STRIKES))])
    cfg = pk.KernelConfig(n_paths=n_paths, n_steps=n_steps, antithetic=True)
    got = finish_sum(pk.simulate_ladder_partials(
        get_payoff("vanilla_call"), cfg, mt.engines.rng.derive_key(3, 0),
        pk.pack_params(convert.option_params(jopt), n_steps),
        torch.tensor(STRIKES)))
    assert tuple(got.shape) == (len(STRIKES), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=VANILLA_RTOL)


def test_ladder_offset_and_bound():
    """A slice at a global path offset masks ids at or past the bound."""
    cfg = pk.KernelConfig(n_paths=1024, n_steps=6, method="terminal")
    prm = pk.pack_params(mt.DEMO_OPTION, 6)
    ladder = finish_sum(pk.simulate_ladder_partials(
        get_payoff("vanilla_call"), cfg, (7, 9), prm,
        torch.tensor([100.0]), path_offset=3000, n_valid=3900))
    single = finish_sum(pk.simulate_partials(
        get_payoff("vanilla_call"), cfg, (7, 9), prm, path_offset=3000,
        n_valid=3900))
    assert torch.equal(ladder[0], single)


def test_ladder_guards():
    prm = pk.pack_params(mt.DEMO_OPTION, 4)
    call = get_payoff("vanilla_call")
    cfg = pk.KernelConfig(n_paths=8, n_steps=4)
    with pytest.raises(ValueError, match="strikes must be"):
        pk.simulate_ladder_partials(call, cfg, (1, 2), prm, torch.tensor([]))
    with pytest.raises(ValueError, match="strikes must be"):
        pk.simulate_ladder_partials(call, cfg, (1, 2), prm,
                                    torch.tensor([1.0], dtype=torch.float64))
    with pytest.raises(ValueError, match="threefry-13"):
        pk.simulate_ladder_partials(
            call, pk.KernelConfig(n_paths=8, n_steps=4, rng_source="threefry"),
            (1, 2), prm, torch.tensor([100.0]))
    with pytest.raises(ValueError, match="control variate"):
        pk.simulate_ladder_partials(
            call, pk.KernelConfig(n_paths=8, n_steps=4, with_cv=True),
            (1, 2), prm, torch.tensor([100.0]))
    with pytest.raises(ValueError, match="path-dependent"):
        mt.price_ladder(STRIKES, payoff="bullet_call", method="terminal",
                        device="cpu")


def test_price_ladder_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.price_ladder(STRIKES, sim=mt.SimParams(n_paths=64, n_steps=2))
