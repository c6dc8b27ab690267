"""torch.autograd.grad through mc_tpu_torch.price on the CPU (the cases of
tests/test_greeks_vjp.py).

price() wraps the simulate kernel in an autograd Function
(engines._SimulateSums): forward the kernel (its plain version on a CPU
tensor), backward the plain version's vector-Jacobian product.  On the CPU
both are the plain version, so the gradient through price() equals the
gradient of the plain version's own graph bitwise; against mc_tpu's
jax.grad (its XLA dual, f32 throughout) it agrees to 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import mc_tpu
from mc_tpu.greeks import greeks as jgreeks

import mc_tpu_torch as mt
from mc_tpu_torch import engines
from mc_tpu_torch.greeks import greeks
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

J_OPT = mc_tpu.OptionParams()
J_SIM = mc_tpu.SimParams(n_paths=4096, n_steps=8)
SIM = mt.SimParams(n_paths=4096, n_steps=8)


def _leaf(v=100.0):
    return torch.tensor(v, dtype=torch.float64, requires_grad=True)


def _port_grad(**kw):
    s0 = _leaf()
    res = mt.price(mt.OptionParams(s0=s0), SIM, payoff="vanilla_call",
                   device="cpu", **kw)
    (g,) = torch.autograd.grad(res.price, s0)
    return res, float(g)


def _plain_graph_grad(method, antithetic=False):
    """The gradient of the plain version's own autograd graph, without the
    Function: pack, simulate_partials_plain, finish."""
    s0 = _leaf()
    opt = mt.OptionParams(s0=s0)
    params = pk.pack_params(opt, SIM.n_steps)
    cfg = pk.KernelConfig(n_paths=SIM.n_paths, n_steps=SIM.n_steps,
                          method=method, antithetic=antithetic)
    key = engines._stream_key(SIM, 0, None)
    sums = finish_sum(pk.simulate_partials_plain(get_payoff("vanilla_call"),
                                                 cfg, key, params))
    (g,) = torch.autograd.grad(
        engines.finish_price(sums, SIM.n_paths, opt).price, s0)
    return float(g)


def _jax_grad(**kw):
    def f(s0):
        o = dataclasses.replace(J_OPT.as_f32(), s0=s0)
        return mc_tpu.price(o, J_SIM, payoff="vanilla_call", engine="xla",
                            tile_rows=8, **kw).price
    return float(jax.grad(f)(jnp.float32(100.0)))


def test_grad_through_price():
    """The gradient through price() is the plain version's gradient, and
    mc_tpu's jax.grad on the same stream."""
    res, g = _port_grad(method="euler")
    assert g == _plain_graph_grad("euler")
    assert g == pytest.approx(_jax_grad(method="euler"), rel=1e-5)
    assert 0.3 < g < 1.0  # a call delta
    assert res.price.requires_grad


def test_grad_antithetic_and_terminal():
    for kw in ({"method": "terminal"},
               {"method": "euler", "antithetic": True}):
        _, g = _port_grad(**kw)
        assert g == _plain_graph_grad(kw["method"],
                                      kw.get("antithetic", False)), kw
        assert g == pytest.approx(_jax_grad(**kw), rel=1e-5), kw


def test_greeks_full_which():
    """theta (outside the fused kernel's set) goes through autograd and
    matches mc_tpu's jax.grad route."""
    which = ("delta", "vega", "rho", "theta")
    got = greeks(mt.OptionParams(), SIM, "vanilla_call", which=which,
                 device="cpu")
    want = jgreeks(J_OPT, J_SIM, "vanilla_call", which=which, engine="xla",
                   tile_rows=8)
    for k in which:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k


def test_grad_hw_prng_raises():
    with pytest.raises(ValueError, match="hw"):
        _port_grad(method="euler", rng_source="hw")
    with pytest.raises(ValueError, match="method='terminal'"):
        _port_grad(method="terminal_pair")
    with pytest.raises(ValueError, match="method='terminal'"):
        _port_grad()  # the default for a plain call is terminal_pair


def test_primal_value_unchanged():
    """Differentiable fields do not move the primal: price() with every
    field a tensor that requires grad is bitwise price() with floats."""
    opt = mt.OptionParams()
    leaves = mt.OptionParams(*(_leaf(float(v)) for v in opt.astuple()))
    for payoff, kw in (("asian_call", dict(method="euler")),
                       ("vanilla_call", dict(method="euler", antithetic=True,
                                             control_variate=True)),
                       ("asian_call_geo_cv", dict(control_variate=True))):
        a = mt.price(leaves, SIM, payoff, device="cpu", **kw)
        b = mt.price(opt, SIM, payoff, device="cpu", **kw)
        assert a.price.item() == b.price.item(), payoff
        assert a.stderr.item() == b.stderr.item(), payoff
        grads = torch.autograd.grad(a.price, list(leaves.astuple()),
                                    allow_unused=True)
        assert all(g is None or torch.isfinite(g) for g in grads)
