"""mc_tpu_torch's cross-currency contracts against mc_tpu on the CPU.

The port runs its kernel's plain PyTorch version here (device="cpu").  Both
draw one threefry pair per path at counter (id, 0) under the fx stream tag.
mc_tpu's XLA dual ignores ``rng_source`` (ROADMAP C11), so threefry-13 is
held to ``engine="xla"`` and threefry-20 to the Pallas kernel in interpret
mode.

Tolerances (the parity contract):
* the packed parameters: bitwise (``pack_fx`` reproduces the fused
  multiply-adds XLA's CPU backend contracts the jitted pack into);
* prices 1e-5 relative, stderrs 1e-5 plus the bound of mc_tpu's f32
  finish (the same paths; only the libm and the order of the sums differ);
* the Monte Carlo gates: 3.5 stderr, as tests/test_fx.py.
"""

import math

import jax
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu import oracle as joracle
from mc_tpu.models import fx as jfx

import mc_tpu_torch as mt
from mc_tpu_torch import convert, oracle, rng
from mc_tpu_torch.models import fx as tfx

torch.set_num_threads(1)

VANILLA_RTOL = 1e-5
EPS32 = 2.0 ** -24
OPT = mt.OptionParams()
JFX = jfx.FXDynamics(x0=1.2, sigma_x=0.15, r_f=0.03, rho=-0.35)
FX = convert.fx_dynamics(JFX)
J_SIM = mc_tpu.SimParams(n_paths=3001, n_steps=2, seed=11)  # a partial tile
SIM = convert.sim_params(J_SIM)


def _f32_finish_rtol(res):
    """mc_tpu forms var = E[p^2] - E[p]^2 from f32 moments (8 units of
    roundoff each): the stderr's tolerance is half var's relative error."""
    mean, var = float(res.payoff_mean), float(res.payoff_var)
    if var == 0.0:
        return VANILLA_RTOL
    return VANILLA_RTOL + 0.5 * 8 * EPS32 * (var + 2 * mean * mean) / var


def _assert_close(got, want):
    assert float(got.price) == pytest.approx(float(want.price),
                                             rel=VANILLA_RTOL, abs=1e-9)
    assert float(got.stderr) == pytest.approx(
        float(want.stderr), rel=_f32_finish_rtol(got), abs=1e-9)


def _oracle(contract, opt=OPT, fx=FX):
    s0, t, k, r, sigma, _, _, _, q = (float(v) for v in opt.astuple())
    x0, sx, rf, rho = (float(fx.x0), float(fx.sigma_x), float(fx.r_f),
                       float(fx.rho))
    kx = x0 if fx.kx is None else float(fx.kx)
    xb = x0 if fx.x_bar is None else float(fx.x_bar)
    return {
        "gk_call": lambda: oracle.gk_call(x0, kx, t, r, rf, sx),
        "gk_put": lambda: oracle.gk_put(x0, kx, t, r, rf, sx),
        "quanto_call": lambda: oracle.quanto_call(s0, k, t, r, rf, sigma, sx,
                                                  rho, q, xb),
        "quanto_put": lambda: oracle.quanto_put(s0, k, t, r, rf, sigma, sx,
                                                rho, q, xb),
        "compo_call": lambda: oracle.compo_call(s0, x0, k, t, r, sigma, sx,
                                                rho, q),
        "compo_put": lambda: oracle.compo_put(s0, x0, k, t, r, sigma, sx,
                                              rho, q),
        "flexo_call": lambda: oracle.flexo_call(s0, x0, k, t, rf, sigma, q),
        "flexo_put": lambda: oracle.flexo_put(s0, x0, k, t, rf, sigma, q),
    }[contract]()


# --- packing -----------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_pack_fx_is_bitwise_mc_tpus_jitted_pack(seed):
    """Against mc_tpu's _pack_fx under jax.jit, as _price_fx_impl runs it
    (1 - rho*rho and the drifts' a - b*c as fused multiply-adds, a
    correctly rounded sqrt): bit for bit on random contracts."""
    rs = np.random.default_rng(seed)
    jopt = mc_tpu.OptionParams(s0=rs.uniform(50, 150), k=rs.uniform(50, 150),
                               r=rs.uniform(-0.02, 0.15),
                               sigma=rs.uniform(0.05, 0.6),
                               t=rs.uniform(0.1, 5), q=rs.uniform(0, 0.05))
    jf = jfx.FXDynamics(x0=rs.uniform(0.5, 2), sigma_x=rs.uniform(0.05, 0.4),
                        r_f=rs.uniform(-0.01, 0.1), rho=rs.uniform(-0.95, 0.95),
                        kx=None if seed % 2 else rs.uniform(0.5, 2))
    want = np.asarray(jax.jit(jfx._pack_fx)(jopt.as_f32(), jf.as_f32()))
    got = tfx.pack_fx(convert.option_params(jopt), convert.fx_dynamics(jf),
                      "cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(convert.fx_params(want).numpy(), want)
    p = tfx.unpack_fx(got)
    assert float(p.kx) == (float(np.float32(jf.x0)) if jf.kx is None
                           else float(np.float32(jf.kx)))


# --- price_fx against mc_tpu.price_fx ----------------------------------------


@pytest.mark.parametrize("contract", sorted(tfx.FX_CONTRACTS))
def test_every_contract_matches_mc_tpu_xla(contract):
    """threefry-13: against mc_tpu's XLA dual on the same key."""
    want = jfx.price_fx(mc_tpu.OptionParams(), JFX, J_SIM, contract,
                        engine="xla")
    got = tfx.price_fx(OPT, FX, SIM, contract, device="cpu")
    _assert_close(got, want)


@pytest.mark.parametrize("contract", sorted(tfx.FX_CONTRACTS))
def test_threefry20_matches_the_pallas_kernel(contract):
    """threefry-20 against mc_tpu's Pallas kernel in interpret mode (its
    XLA dual ignores rng_source, C11)."""
    jsim = mc_tpu.SimParams(n_paths=2048, n_steps=2, seed=5)
    want = jfx.price_fx(mc_tpu.OptionParams(), JFX, jsim, contract,
                        engine="pallas", tile_rows=8, interpret=True,
                        rng_source="threefry")
    got = tfx.price_fx(OPT, FX, convert.sim_params(jsim), contract,
                       rng_source="threefry", device="cpu")
    _assert_close(got, want)
    other = tfx.price_fx(OPT, FX, convert.sim_params(jsim), contract,
                         device="cpu")
    assert float(other.price) != float(got.price)


def test_partials_offset_and_bound():
    """A shard's global ids and the bound mask, as the kernel takes them:
    two halves add up to the whole run, paths past the bound add zeros."""
    key = rng.derive_key(3, 0, tfx.FX_TAG)
    prm = tfx.pack_fx(OPT, FX, "cpu")
    whole = tfx.fx_partials("compo_put", tfx.FXConfig(1000), key, prm).sum(0)
    a = tfx.fx_partials("compo_put", tfx.FXConfig(600), key, prm).sum(0)
    b = tfx.fx_partials("compo_put", tfx.FXConfig(400), key, prm,
                        path_offset=600).sum(0)
    torch.testing.assert_close(a + b, whole, rtol=1e-12, atol=0.0)
    masked = tfx.fx_partials("compo_put", tfx.FXConfig(1000), key, prm,
                             n_valid=600).sum(0)
    assert float(masked[0]) == pytest.approx(float(a[0]), rel=1e-12)


# --- the cases of tests/test_fx.py -------------------------------------------


@pytest.mark.parametrize("contract", sorted(tfx.FX_CONTRACTS))
def test_mc_matches_closed_form(contract):
    """Every contract within 3.5 stderr of its exact oracle: jointly they
    pin the quanto drift tilt, the rho mixing and the measure change."""
    opt = OPT if not contract.startswith("compo") else mt.OptionParams(k=120.0)
    res = tfx.price_fx(opt, FX, mt.SimParams(n_paths=1 << 18, n_steps=2,
                                             seed=11), contract, device="cpu")
    ref = _oracle(contract, opt)
    z = (float(res.price) - ref) / float(res.stderr)
    assert abs(z) < 3.5, (contract, float(res.price), ref, z)


def test_oracles_equal_mc_tpus():
    """The host closed forms, bit for bit the reference's."""
    args = (100.0, 1.4, 95.0, 2.0, 0.07, 0.25, 0.12, 0.45, 0.015)
    for name in ("compo_call", "compo_put"):
        assert getattr(oracle, name)(*args) == getattr(joracle, name)(*args)
    q = (100.0, 95.0, 2.0, 0.07, 0.02, 0.25, 0.12, 0.45, 0.015, 1.35)
    for name in ("quanto_call", "quanto_put"):
        assert getattr(oracle, name)(*q) == getattr(joracle, name)(*q)
    g = (1.4, 1.3, 2.0, 0.07, 0.02, 0.12)
    for name in ("gk_call", "gk_put"):
        assert getattr(oracle, name)(*g) == getattr(joracle, name)(*g)
    f = (100.0, 1.4, 95.0, 2.0, 0.02, 0.25, 0.015)
    for name in ("flexo_call", "flexo_put"):
        assert getattr(oracle, name)(*f) == getattr(joracle, name)(*f)


def test_oracle_put_call_parities():
    """Exact f64 parities, one per contract family (1e-12 relative)."""
    s0, t, k, r, sig = 100.0, 2.0, 95.0, 0.07, 0.25
    x0, kx, sx, rf, rho, q, xb = 1.4, 1.3, 0.12, 0.02, 0.45, 0.015, 1.35
    lhs = oracle.gk_call(x0, kx, t, r, rf, sx) - oracle.gk_put(x0, kx, t, r,
                                                               rf, sx)
    assert lhs == pytest.approx(x0 * math.exp(-rf * t) - kx * math.exp(-r * t),
                                rel=1e-12)
    f = s0 * math.exp((rf - q - rho * sig * sx) * t)
    lhs = (oracle.quanto_call(s0, k, t, r, rf, sig, sx, rho, q, xb)
           - oracle.quanto_put(s0, k, t, r, rf, sig, sx, rho, q, xb))
    assert lhs == pytest.approx(xb * math.exp(-r * t) * (f - k), rel=1e-12)
    lhs = (oracle.compo_call(s0, x0, k * x0, t, r, sig, sx, rho, q)
           - oracle.compo_put(s0, x0, k * x0, t, r, sig, sx, rho, q))
    rhs = s0 * x0 * math.exp(-q * t) - k * x0 * math.exp(-r * t)
    assert lhs == pytest.approx(rhs, rel=1e-12)
    lhs = (oracle.flexo_call(s0, x0, k, t, rf, sig, q)
           - oracle.flexo_put(s0, x0, k, t, rf, sig, q))
    rhs = x0 * (s0 * math.exp(-q * t) - k * math.exp(-rf * t))
    assert lhs == pytest.approx(rhs, rel=1e-12)


def test_oracle_degenerate_limits():
    """rho = 0 and sigma_x -> 0: the quanto is x_bar times Black-Scholes at
    the foreign growth rate; flexo is x0 times the foreign Black-Scholes."""
    bs = oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2, q=0.1 - 0.03)
    qc = oracle.quanto_call(100.0, 100.0, 1.0, 0.1, 0.03, 0.2, 1e-12, 0.0,
                            0.0, 1.0)
    assert qc == pytest.approx(bs, rel=1e-6)
    fl = oracle.flexo_call(100.0, 1.2, 100.0, 1.0, 0.03, 0.2)
    assert fl == pytest.approx(1.2 * oracle.bs_call(100.0, 100.0, 1.0, 0.03,
                                                    0.2), rel=1e-6)


def test_quanto_option_params_equals_mc_tpus():
    """The q_eff adapter: the same (option, x_bar) as mc_tpu's, and the f64
    identity quanto_call == x_bar * bs_call(q=q_eff)."""
    opt, xb = tfx.quanto_option_params(OPT, FX)
    jopt, jxb = jfx.quanto_option_params(mc_tpu.OptionParams(), JFX)
    assert (opt.q, xb) == (jopt.q, jxb)
    ref = oracle.quanto_call(100.0, 100.0, 1.0, 0.1, FX.r_f, 0.2, FX.sigma_x,
                             FX.rho, 0.0, 1.2)
    via = xb * oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2, q=opt.q)
    assert via == pytest.approx(ref, rel=1e-6)
    # and through the GBM engine, within MC noise of the quanto oracle
    res = mt.price(opt, mt.SimParams(n_paths=1 << 18, n_steps=2, seed=5),
                   device="cpu")
    z = (xb * float(res.price) - ref) / (xb * float(res.stderr))
    assert abs(z) < 3.5


def test_correlation_sensitivity_signs():
    """On common keys: the compo call rises with rho (a higher compo vol),
    the quanto call falls (a lower quanto forward)."""
    sim = mt.SimParams(n_paths=1 << 16, n_steps=2, seed=13)
    lo = tfx.FXDynamics(x0=1.2, sigma_x=0.15, r_f=0.03, rho=-0.6)
    hi = tfx.FXDynamics(x0=1.2, sigma_x=0.15, r_f=0.03, rho=0.6)
    ko = mt.OptionParams(k=120.0)
    assert (float(tfx.price_fx(ko, hi, sim, "compo_call", device="cpu").price)
            > float(tfx.price_fx(ko, lo, sim, "compo_call",
                                 device="cpu").price))
    assert (float(tfx.price_fx(OPT, hi, sim, "quanto_call",
                               device="cpu").price)
            < float(tfx.price_fx(OPT, lo, sim, "quanto_call",
                                 device="cpu").price))


def test_default_strikes_resolve_to_spot():
    fx = tfx.FXDynamics(x0=1.3).as_f32()
    assert float(fx.kx) == pytest.approx(1.3)
    assert float(fx.x_bar) == pytest.approx(1.3)


def test_unknown_contract_and_engine_raise():
    """An unknown contract raises KeyError in both packages; the port has
    no engine argument (mc_tpu's raises on an unknown one) and refuses the
    TPU's hardware RNG."""
    with pytest.raises(KeyError, match="unknown fx contract"):
        tfx.price_fx(OPT, FX, SIM, "straddle", device="cpu")
    with pytest.raises(KeyError, match="unknown fx contract"):
        jfx.price_fx(mc_tpu.OptionParams(), JFX, J_SIM, "straddle")
    with pytest.raises(ValueError, match="unknown engine"):
        jfx.price_fx(mc_tpu.OptionParams(), JFX, J_SIM, "gk_call",
                     engine="mosaic")
    with pytest.raises(TypeError):
        tfx.price_fx(OPT, FX, SIM, "gk_call", engine="mosaic", device="cpu")
    with pytest.raises(ValueError, match="hw"):
        tfx.price_fx(OPT, FX, SIM, "gk_call", rng_source="hw", device="cpu")


def test_stream_independent_of_gbm():
    """The fx stream tag decorrelates the fx draws from the GBM engine at
    the same seed."""
    sim = mt.SimParams(n_paths=1 << 14, n_steps=2, seed=11)
    opt, xb = tfx.quanto_option_params(OPT, FX)
    via_engine = xb * float(mt.price(opt, sim, device="cpu").price)
    direct = float(tfx.price_fx(OPT, FX, sim, "quanto_call",
                                device="cpu").price)
    assert via_engine != direct
