"""rainbow_greeks and basket_greeks on the CPU: the cases of
tests/test_rainbow_greeks.py against the Stulz, Margrabe and Black-Scholes
oracles, the vectors and the cega matrix against mc_tpu's one reverse pass,
and the differentiable pack against its bitwise value.

On the CPU the price is the kernel's plain version (#27, #25) and the
gradient the same plain version's, through ``engines.kernel_sums``; mc_tpu
differentiates its XLA dual on the same key.

Tolerances:
* the oracles: tests/test_rainbow_greeks.py's;
* against mc_tpu: 1e-5 relative to the largest entry of each vector or
  matrix (the f32 gradients of two frameworks over the parity contract's
  few-ulp normals; ~2e-7 seen);
* the pack with gradients on: bitwise the pack without.
"""

import importlib

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models.basket import BasketDynamics as JBasketDynamics

import mc_tpu_torch as mt
from mc_tpu_torch import oracle
from mc_tpu_torch.models.basket import BasketDynamics, pack_basket

torch.set_num_threads(1)

jg = importlib.import_module("mc_tpu.greeks")
tg = importlib.import_module("mc_tpu_torch.greeks")

CPU = dict(device="cpu")
S1, S2, K, T, R = 100.0, 100.0, 100.0, 1.0, 0.1
SIG1, SIG2, RHO = 0.25, 0.2, 0.4
SIM18 = mt.SimParams(n_paths=1 << 18, n_steps=1)


def _dyn2(cls=BasketDynamics):
    return cls(s0s=np.array([S1, S2], np.float32),
               sigmas=np.array([SIG1, SIG2], np.float32),
               weights=np.array([0.5, 0.5], np.float32),
               corr=np.array([[1.0, RHO], [RHO, 1.0]], np.float32))


def _fd(fn, i, h=0.01):
    args = [S1, S2]
    args[i] += h
    up = fn(*args)
    args[i] -= 2 * h
    return (up - fn(*args)) / (2 * h)


def test_rainbow_deltas_match_stulz_fd():
    g = tg.rainbow_greeks(mt.OptionParams(), _dyn2(), SIM18, "call_on_max",
                          which=("delta",), **CPU)
    fn = lambda s1, s2: oracle.stulz_max_call(s1, s2, K, T, R, SIG1, SIG2,
                                              RHO)
    for i in range(2):
        assert abs(float(g["delta"][i]) - _fd(fn, i)) < 5e-3, i


def test_rainbow_min_call_deltas_and_vegas():
    g = tg.rainbow_greeks(mt.OptionParams(), _dyn2(), SIM18, "call_on_min",
                          **CPU)
    fn = lambda s1, s2: oracle.stulz_min_call(s1, s2, K, T, R, SIG1, SIG2,
                                              RHO)
    for i in range(2):
        assert abs(float(g["delta"][i]) - _fd(fn, i)) < 5e-3, i
    h = 1e-3
    v1 = (oracle.stulz_min_call(S1, S2, K, T, R, SIG1 + h, SIG2, RHO)
          - oracle.stulz_min_call(S1, S2, K, T, R, SIG1 - h, SIG2,
                                  RHO)) / (2 * h)
    v2 = (oracle.stulz_min_call(S1, S2, K, T, R, SIG1, SIG2 + h, RHO)
          - oracle.stulz_min_call(S1, S2, K, T, R, SIG1, SIG2 - h,
                                  RHO)) / (2 * h)
    assert abs(float(g["vega"][0]) - v1) < 0.35
    assert abs(float(g["vega"][1]) - v2) < 0.35


def test_rainbow_cega_matches_stulz_fd():
    g = tg.rainbow_greeks(mt.OptionParams(), _dyn2(), SIM18, "call_on_max",
                          which=("cega",), **CPU)
    h = 1e-3
    ref = (oracle.stulz_max_call(S1, S2, K, T, R, SIG1, SIG2, RHO + h)
           - oracle.stulz_max_call(S1, S2, K, T, R, SIG1, SIG2,
                                   RHO - h)) / (2 * h)
    c = g["cega"].numpy()
    assert c[0, 0] == 0.0 and c[1, 1] == 0.0    # the diagonal is no param
    assert c[0, 1] == c[1, 0]                    # the symmetric fold
    assert abs(float(c[0, 1]) - ref) < 0.12, (c, ref)


def test_exchange_deltas_match_margrabe():
    g = tg.rainbow_greeks(mt.OptionParams(), _dyn2(), SIM18, "exchange",
                          which=("delta",), **CPU)
    fn = lambda s1, s2: oracle.margrabe(s1, s2, T, SIG1, SIG2, RHO)
    for i in range(2):
        assert abs(float(g["delta"][i]) - _fd(fn, i)) < 5e-3, i
    assert float(g["delta"][1]) < 0.0


def test_basket_d1_degenerates_to_black_scholes():
    dyn = BasketDynamics(s0s=np.array([100.0], np.float32),
                         sigmas=np.array([0.2], np.float32),
                         weights=np.array([1.0], np.float32),
                         corr=np.array([[1.0]], np.float32))
    g = tg.basket_greeks(mt.OptionParams(), dyn,
                         mt.SimParams(n_paths=1 << 18, n_steps=8),
                         "vanilla_call", **CPU)
    assert abs(float(g["delta"][0])
               - oracle.bs_delta_call(100, 100, 1, 0.1, 0.2)) < 6e-3
    assert abs(float(g["vega"][0]) - oracle.bs_vega(100, 100, 1, 0.1, 0.2)
               ) < 0.35
    assert float(g["cega"][0, 0]) == 0.0


def test_basket_d1_is_the_gbm_pathwise_greeks():
    """d = 1, weight 1: the basket's delta and vega are GBM's pathwise
    greeks() on the same paths in law (different keys), within 4 joint
    stderr of their price."""
    dyn = BasketDynamics(s0s=np.array([100.0], np.float32),
                         sigmas=np.array([0.2], np.float32),
                         weights=np.array([1.0], np.float32),
                         corr=np.array([[1.0]], np.float32))
    sim = mt.SimParams(n_paths=1 << 16, n_steps=8)
    b = tg.basket_greeks(mt.OptionParams(), dyn, sim, "vanilla_call",
                         which=("delta", "vega"), **CPU)
    g = mt.greeks(mt.OptionParams(), sim, "vanilla_call",
                  which=("delta", "vega"), **CPU)
    for name in ("delta", "vega"):
        tol = 4 * 2 ** 0.5 * float(g[f"{name}_stderr"])
        assert abs(float(b[name][0]) - float(g[name])) < tol, name


def test_basket_rejects_discontinuous_payoff():
    with pytest.raises(ValueError, match="a.e.-differentiable"):
        tg.basket_greeks(payoff="digital_call", **CPU)


def test_unknown_greek_rejected():
    with pytest.raises(ValueError, match="unknown greeks"):
        tg.rainbow_greeks(which=("delta", "charm"), **CPU)


@pytest.mark.parametrize("payoff,d", [("call_on_max", 4), ("put_on_min", 3),
                                      ("exchange", 2), ("best_of_cash", 4)])
def test_rainbow_greeks_match_mc_tpu(payoff, d):
    dyn = mt.demo_basket(d, 0.3)
    sim = mt.SimParams(n_paths=4_096, n_steps=1)
    mine = tg.rainbow_greeks(mt.OptionParams(), dyn, sim, payoff, **CPU)
    jdyn = JBasketDynamics(*(np.asarray(getattr(dyn, f)) for f in
                             ("s0s", "sigmas", "weights", "corr")))
    ref = jg.rainbow_greeks(mc_tpu.OptionParams(), jdyn,
                            mc_tpu.SimParams(n_paths=4_096, n_steps=1),
                            payoff)
    for k in ("delta", "vega", "cega"):
        want = np.asarray(ref[k])
        np.testing.assert_allclose(mine[k].numpy(), want, rtol=0,
                                   atol=1e-5 * np.max(np.abs(want)))


@pytest.mark.parametrize("payoff,d,anti", [("vanilla_call", 4, False),
                                           ("asian_call", 3, False),
                                           ("vanilla_put", 2, True)])
def test_basket_greeks_match_mc_tpu(payoff, d, anti):
    dyn = mt.demo_basket(d, 0.4)
    sim = mt.SimParams(n_paths=4_096, n_steps=10)
    mine = tg.basket_greeks(mt.OptionParams(), dyn, sim, payoff,
                            antithetic=anti, **CPU)
    jdyn = JBasketDynamics(*(np.asarray(getattr(dyn, f)) for f in
                             ("s0s", "sigmas", "weights", "corr")))
    ref = jg.basket_greeks(mc_tpu.OptionParams(), jdyn,
                           mc_tpu.SimParams(n_paths=4_096, n_steps=10),
                           payoff, antithetic=anti)
    for k in ("delta", "vega", "cega"):
        want = np.asarray(ref[k])
        np.testing.assert_allclose(mine[k].numpy(), want, rtol=0,
                                   atol=1e-5 * np.max(np.abs(want)))


@pytest.mark.parametrize("d", [1, 2, 5, 9])
def test_differentiable_pack_is_bitwise(d):
    """With s0s, sigmas and corr requiring grad the pack's value is the
    bitwise pack, and its gradient flows to all three."""
    dyn = mt.demo_basket(d, 0.35)
    plain = pack_basket(mt.DEMO_OPTION, dyn, 10, "cpu")
    leaves = [torch.tensor(np.asarray(v), requires_grad=True)
              for v in (dyn.s0s, dyn.sigmas, dyn.corr)]
    live = BasketDynamics(s0s=leaves[0], sigmas=leaves[1],
                          weights=dyn.weights, corr=leaves[2])
    packed = pack_basket(mt.DEMO_OPTION, live, 10, "cpu")
    assert torch.equal(packed.detach(), plain)
    grads = torch.autograd.grad(packed.sum(), leaves, allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)


def test_rainbow_price_with_grad_is_the_kernel_value():
    """price_rainbow on basket fields that require grad returns the same
    price as without (the forward is the kernel's, never recomputed)."""
    dyn = mt.demo_basket(3, 0.2)
    sim = mt.SimParams(n_paths=2_048, n_steps=1)
    a = mt.price_rainbow(sim=sim, basket=dyn, **CPU)
    live = BasketDynamics(s0s=torch.tensor(dyn.s0s, requires_grad=True),
                          sigmas=dyn.sigmas, weights=dyn.weights,
                          corr=dyn.corr)
    b = mt.price_rainbow(sim=sim, basket=live, **CPU)
    assert float(a.price) == float(b.price.detach())
    assert b.price.requires_grad
