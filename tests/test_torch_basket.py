"""mc_tpu_torch's correlated basket against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here (device="cpu").
mc_tpu's engine="xla" dual is bitwise equal to its Pallas kernel for every
payoff but the two Brownian-bridge barriers: the Pallas kernel unpacks
sigma = k*0 (``mc_tpu/models/basket.py:243``), the XLA dual carries the
option's sigma (``:189``).  The port replaces the Pallas kernel (#25), so
its bridge barriers follow that kernel; the engines' disagreement is pinned
here (ROADMAP C16).  Both draw the pairs (id, j*ceil(d/2) + q) at step j.

Tolerances (the parity contract):
* the packed parameters: bitwise (``pack_basket`` reproduces the fused
  multiply-adds XLA's CPU backend contracts the jitted namespace into);
* smooth payoffs: price 1e-5 relative, stderr 1e-5 plus the bound of
  mc_tpu's f32 finish; payoffs where a path can flip at K or B: 0.05
  stderr;
* the trajectories (#26): the basket level to 2e-6 relative, a barrier
  count equal on >= 99.9% of paths.

The cases of tests/test_basket.py run at its sizes and tolerances.
"""

import jax
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import basket as jb
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, rng
from mc_tpu_torch.models import basket as tb
from mc_tpu_torch.models.heston import SIGMA_PAYOFFS
from mc_tpu_torch.oracle import bs_call
from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

VANILLA_RTOL = 1e-5
FLIP_SE = 0.05
EPS32 = 2.0 ** -24
FLIPS = {"digital_call", "digital_put", "bullet_call", "up_out_call",
         "down_out_call", "down_in_call"}
J_OPTIONS = {
    "bullet_call": dict(p1=1.0, p2=6.0),
    "down_out_call": dict(barrier=90.0),
    "down_in_call": dict(barrier=90.0),
    "down_out_call_bb": dict(barrier=90.0),
    "variance_swap": dict(k=0.03),
    "forward_start_call": dict(k=1.0, p1=6.0),
    "cliquet": dict(k=4.0, p1=-0.02, p2=0.04),
}
J_SIM = mc_tpu.SimParams(n_paths=3001, n_steps=16)  # odd: a partial tile
SIM = convert.sim_params(J_SIM)
NAMES = sorted(n for n in PAYOFFS if n not in SIGMA_PAYOFFS)


def _options(name):
    jopt = mc_tpu.OptionParams(**J_OPTIONS.get(name, {}))
    return jopt, convert.option_params(jopt)


def _random_basket(d, seed, perfect=False):
    """Spots 50-150, vols 5-60%, signed weights and a random correlation
    (every entry 1 if ``perfect``)."""
    rs = np.random.default_rng(seed)
    a = rs.standard_normal((d, d))
    c = a @ a.T + 0.3 * np.eye(d)
    c = c / np.sqrt(np.outer(np.diag(c), np.diag(c)))
    if perfect:
        c = np.ones((d, d))
    return jb.BasketDynamics(s0s=rs.uniform(50, 150, d).astype(np.float32),
                             sigmas=rs.uniform(0.05, 0.6, d).astype(np.float32),
                             weights=rs.uniform(-1, 1, d).astype(np.float32),
                             corr=c.astype(np.float32))


def _f32_finish_rtol(res):
    """The stderr's tolerance where mc_tpu forms var = E[p^2] - E[p]^2 from
    f32 moments (8 units of roundoff each): half of var's relative error."""
    mean, var = float(res.payoff_mean), float(res.payoff_var)
    if var == 0.0:
        return VANILLA_RTOL
    return VANILLA_RTOL + 0.5 * 8 * EPS32 * (var + 2 * mean * mean) / var


def _assert_close(name, got, want):
    gp, wp, ws = float(got.price), float(want.price), float(want.stderr)
    if name in FLIPS:
        assert abs(gp - wp) <= FLIP_SE * ws, (gp, wp, ws)
        assert abs(float(got.stderr) - ws) <= FLIP_SE * ws
    else:
        assert gp == pytest.approx(wp, rel=VANILLA_RTOL, abs=1e-9)
        assert float(got.stderr) == pytest.approx(
            ws, rel=_f32_finish_rtol(got), abs=1e-9)


# --- packing -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["demo", "random", "perfect"])
@pytest.mark.parametrize("d", [1, 2, 4, 9, 32])
def test_pack_basket_is_bitwise_mc_tpu(d, kind):
    """Against mc_tpu's _pack_basket(_basket_namespace(...)) under jax.jit,
    as price_basket runs it (t / n as t * (1/n), a*b + c contracted into
    fused multiply-adds): bit for bit, the ill-conditioned Cholesky of a
    perfect correlation included."""
    b = (jb._demo_basket(d, 0.5) if kind == "demo"
         else _random_basket(d, 7 + d, perfect=kind == "perfect"))
    opt = mc_tpu.OptionParams(t=0.7, r=0.05, q=0.02)

    def pack(o, bk):
        return jb._pack_basket(jb._basket_namespace(o, bk, 20), d)

    want = np.asarray(jax.jit(pack)(opt.as_f32(), b.as_f32()))
    got = tb.pack_basket(convert.option_params(opt),
                         convert.basket_dynamics(b), 20, "cpu")
    assert got.shape == (tb.packed_length(d),) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(
        convert.basket_params(want, d).numpy().view(np.uint32),
        want.view(np.uint32))
    p = tb.unpack_basket(got, d)
    assert float(p.sigma) == 0.0 and p.chol.shape == (d, d)
    assert bool((torch.triu(p.chol, 1) == 0).all())


def test_fma_f32_rounds_once():
    """fma_f32 against exact rationals on values whose product and sum need
    more than 24 bits, and its ties to even."""
    from mc_tpu_torch.models.term import fma_f32
    a, b = np.float32(1.0 + 2.0 ** -12), np.float32(1.0 + 2.0 ** -12)
    c = np.float32(-1.0)
    # a*b + c = 2^-11 + 2^-24 exactly: representable, so returned as is
    assert float(fma_f32(a, b, c)) == 2.0 ** -11 + 2.0 ** -24
    assert float(np.float32(a * b) + c) != 2.0 ** -11 + 2.0 ** -24
    # 1 + 2^-24 is a tie between 1 and 1 + 2^-23: to even, 1
    assert float(fma_f32(1.0, 2.0 ** -24, 1.0)) == 1.0
    assert float(fma_f32(1.0, 3 * 2.0 ** -24, 1.0)) == 1.0 + 2.0 ** -22


# --- price_basket against mc_tpu.price_basket --------------------------------


@pytest.mark.parametrize("d", [1, 4, 9])
@pytest.mark.parametrize("name", NAMES)
def test_every_payoff_matches_mc_tpu(name, d):
    """The 16 payoffs both mc_tpu engines agree on, on the demo basket."""
    jopt, opt = _options(name)
    want = jb.price_basket(jopt, jb._demo_basket(d, 0.5), J_SIM, name,
                           engine="xla")
    got = tb.price_basket(opt, tb.demo_basket(d, 0.5), SIM, name,
                          device="cpu")
    _assert_close(name, got, want)


@pytest.mark.parametrize("antithetic", [False, True])
def test_random_basket_matches_mc_tpu(antithetic):
    """Signed weights, uneven spots and vols, a random correlation at d =
    5 (an odd d drops the last normal of its last pair)."""
    jb5 = _random_basket(5, 3)
    want = jb.price_basket(mc_tpu.OptionParams(k=10.0), jb5, J_SIM,
                           engine="xla", antithetic=antithetic)
    got = tb.price_basket(mt.OptionParams(k=10.0),
                          convert.basket_dynamics(jb5), SIM,
                          antithetic=antithetic, device="cpu")
    _assert_close("vanilla_call", got, want)


@pytest.mark.parametrize("name", sorted(SIGMA_PAYOFFS))
def test_bridge_barriers_match_pallas_interpret(name):
    """The bridge barriers against mc_tpu's Pallas kernel (interpret mode),
    which reads sigma = 0: they price as their discrete twins."""
    jopt, opt = _options(name)
    jsim = mc_tpu.SimParams(n_paths=1024, n_steps=8)
    want = jb.price_basket(jopt, jb.DEMO_BASKET, jsim, name,
                           engine="pallas", tile_rows=8, interpret=True)
    got = tb.price_basket(opt, tb.DEMO_BASKET, convert.sim_params(jsim), name,
                          device="cpu")
    _assert_close(name, got, want)
    twin = tb.price_basket(opt, tb.DEMO_BASKET, convert.sim_params(jsim),
                           name[:-3], device="cpu")
    assert float(got.price) == float(twin.price)


def test_engines_disagree_on_the_bridge_barriers():
    """ROADMAP C16: mc_tpu's XLA dual reads the option's sigma, its Pallas
    kernel (and the port) sigma = 0; at 2,048 x 8 with the barrier at 120
    the XLA up_out_call_bb is 1.39606 and the Pallas one 2.34966, the
    discrete up_out_call's."""
    jsim = mc_tpu.SimParams(n_paths=2048, n_steps=8)
    jopt = mc_tpu.OptionParams(barrier=120.0)
    xla = jb.price_basket(jopt, jb.DEMO_BASKET, jsim, "up_out_call_bb",
                          engine="xla")
    pallas = jb.price_basket(jopt, jb.DEMO_BASKET, jsim, "up_out_call_bb",
                             engine="pallas", tile_rows=8, interpret=True)
    discrete = jb.price_basket(jopt, jb.DEMO_BASKET, jsim, "up_out_call",
                               engine="xla")
    got = tb.price_basket(convert.option_params(jopt), tb.DEMO_BASKET,
                          convert.sim_params(jsim), "up_out_call_bb",
                          device="cpu")
    assert float(xla.price) == pytest.approx(1.39606, abs=1e-5)
    assert float(pallas.price) == pytest.approx(2.34966, abs=1e-5)
    assert float(pallas.price) == float(discrete.price)
    assert float(got.price) == pytest.approx(float(pallas.price), rel=1e-5)
    assert abs(float(got.price) - float(xla.price)) > 0.9


@pytest.mark.parametrize("d", [4, 9])
@pytest.mark.parametrize("name", ["vanilla_call", "bullet_call",
                                  "asian_call", "down_out_call"])
def test_trajectories_match_pallas_interpret(name, d):
    """#26's plain version against mc_tpu's basket_trajectories_kernel in
    interpret mode: the basket-level grid, the state word and the payoff
    sums."""
    jopt, opt = _options(name)
    n_paths, n_steps = 1000, 8
    key = rng.derive_key(4, 0, tb.BASKET_TAG)
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    jbk = jb._demo_basket(d, 0.5).as_f32()
    jparams = jb._pack_basket(jb._basket_namespace(jopt.as_f32(), jbk,
                                                   n_steps), d)
    jg, jst, jsum, jsq = jb.basket_trajectories_kernel(
        jget_payoff(name), jcfg, d, np.asarray(key, np.uint32), jparams,
        interpret=True)
    prm = convert.basket_params(np.asarray(jparams), d)
    cfg = tb.BasketConfig(n_paths=n_paths, n_steps=n_steps, d=d)
    b, st, partials = tb.basket_trajectories(get_payoff(name), cfg, key, prm)
    want = convert.surface_matrix(jg, n_paths)
    np.testing.assert_allclose(b.T.numpy(), want, rtol=2e-6)
    want_st = convert.surface_matrix(jst, n_paths)
    if name in FLIPS:
        assert (st.T.numpy() == want_st).all(axis=1).mean() >= 0.999
    else:
        np.testing.assert_allclose(st.T.numpy(), want_st, rtol=2e-6)
    sums = finish_sum(partials).numpy()
    want = np.array([float(jfinish_sum(jsum)), float(jfinish_sum(jsq))])
    if name not in FLIPS:
        np.testing.assert_allclose(sums, want, rtol=1e-5)
    own = finish_sum(tb.basket_partials(get_payoff(name), cfg, key, prm))
    np.testing.assert_allclose(sums, own.numpy(), rtol=1e-12)


def test_path_offset_and_bound_match_mc_tpu():
    jcfg = jpk.KernelConfig(n_paths=1000, n_steps=6, tile_rows=8)
    ns = jb._basket_namespace(mc_tpu.OptionParams().as_f32(),
                              jb.DEMO_BASKET.as_f32(), 6)
    key = rng.derive_key(5, 0, tb.BASKET_TAG)
    s, sq = jb._basket_partials(jget_payoff("vanilla_call"), jcfg, 4,
                                np.asarray(key, np.uint32), ns, 1500, 2300,
                                engine="xla")
    want = np.array([float(jfinish_sum(s)), float(jfinish_sum(sq))])
    prm = convert.basket_params(np.asarray(jb._pack_basket(ns, 4)), 4)
    got = finish_sum(tb.basket_partials(
        get_payoff("vanilla_call"),
        tb.BasketConfig(n_paths=1000, n_steps=6, d=4), key, prm,
        path_offset=1500, n_valid=2300)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    head = finish_sum(tb.basket_partials(
        get_payoff("vanilla_call"),
        tb.BasketConfig(n_paths=800, n_steps=6, d=4), key, prm,
        path_offset=1500)).numpy()
    np.testing.assert_array_equal(got, head)


def test_guards():
    with pytest.raises(ValueError, match="positive"):
        tb.BasketConfig(n_paths=8, n_steps=0, d=2)
    with pytest.raises(ValueError, match="params"):
        tb.basket_partials(get_payoff("vanilla_call"),
                           tb.BasketConfig(n_paths=8, n_steps=2, d=4),
                           (1, 2), torch.zeros(17))
    with pytest.raises(ValueError, match="antithetic"):
        tb.basket_trajectories(
            get_payoff("vanilla_call"),
            tb.BasketConfig(n_paths=8, n_steps=2, d=4, antithetic=True),
            (1, 2), tb.pack_basket(mt.OptionParams(), tb.DEMO_BASKET, 2,
                                   "cpu"))
    with pytest.raises(ValueError, match="one state array"):
        tb.basket_trajectories(
            get_payoff("cliquet"), tb.BasketConfig(n_paths=8, n_steps=2, d=4),
            (1, 2), tb.pack_basket(mt.OptionParams(), tb.DEMO_BASKET, 2,
                                   "cpu"))
    with pytest.raises(ValueError, match="32"):
        convert.basket_params(np.zeros(50, np.float32), 4)
    with pytest.raises(ValueError, match="corr"):
        convert.basket_dynamics(dict(s0s=np.ones(3), sigmas=np.ones(3),
                                     weights=np.ones(3), corr=np.eye(2)))


def test_dimension_guard_names_max_basket_d():
    """tests/test_basket.py's guard: d = 33 refused, naming MAX_BASKET_D."""
    d = tb.MAX_BASKET_D + 1
    dyn = tb.BasketDynamics(s0s=np.full(d, 100.0, np.float32),
                            sigmas=np.full(d, 0.2, np.float32),
                            weights=np.full(d, 1.0 / d, np.float32),
                            corr=np.eye(d, dtype=np.float32))
    with pytest.raises(ValueError, match="MAX_BASKET_D"):
        tb.price_basket(basket=dyn, sim=mt.SimParams(n_paths=1024,
                                                     n_steps=2),
                        device="cpu")
    with pytest.raises(ValueError, match="MAX_BASKET_D"):
        tb.BasketConfig(n_paths=8, n_steps=2, d=d)
    assert tb.MAX_BASKET_D == jb.MAX_BASKET_D


def test_default_key_is_mc_tpus_basket_stream():
    sim = mt.SimParams(n_paths=512, n_steps=5, seed=21)
    a = tb.price_basket(sim=sim, device="cpu")
    b = tb.price_basket(sim=sim, key=rng.derive_key(21, 0, 0xBA5C),
                        device="cpu")
    c = tb.price_basket(sim=sim, key=rng.derive_key(21, 0), device="cpu")
    assert float(a.price) == float(b.price)
    assert float(a.price) != float(c.price)


# --- the cases of tests/test_basket.py ---------------------------------------

GATE_SIM = mt.SimParams(n_paths=100_000, n_steps=20)


def _single_asset(sigma=0.2, s0=100.0):
    return tb.BasketDynamics(s0s=np.array([s0], np.float32),
                             sigmas=np.array([sigma], np.float32),
                             weights=np.array([1.0], np.float32),
                             corr=np.eye(1, dtype=np.float32))


def _perfectly_correlated(d=3, sigma=0.2):
    return tb.BasketDynamics(s0s=np.full(d, 100.0, np.float32),
                             sigmas=np.full(d, sigma, np.float32),
                             weights=np.full(d, 1.0 / d, np.float32),
                             corr=np.ones((d, d), np.float32))


def test_single_asset_reduces_to_bs():
    res = tb.price_basket(mt.OptionParams(), _single_asset(), GATE_SIM,
                          antithetic=True, device="cpu")
    assert abs(float(res.price) - bs_call(100.0, 100.0, 1.0, 0.1, 0.2)) <= (
        4.0 * float(res.stderr))


def test_perfect_correlation_equals_single_asset():
    res = tb.price_basket(mt.OptionParams(), _perfectly_correlated(),
                          GATE_SIM, antithetic=True, device="cpu")
    assert abs(float(res.price) - bs_call(100.0, 100.0, 1.0, 0.1, 0.2)) <= (
        4.0 * float(res.stderr))


def test_diversification_lowers_price():
    indep = tb.BasketDynamics(s0s=np.full(4, 100.0, np.float32),
                              sigmas=np.full(4, 0.2, np.float32),
                              weights=np.full(4, 0.25, np.float32),
                              corr=np.eye(4, dtype=np.float32))
    kw = dict(sim=GATE_SIM, antithetic=True, device="cpu")
    res_i = tb.price_basket(mt.OptionParams(), indep, **kw)
    res_c = tb.price_basket(mt.OptionParams(), _perfectly_correlated(4), **kw)
    assert float(res_i.price) < float(res_c.price) - 2.0


def test_path_dependent_on_basket():
    sim = mt.SimParams(n_paths=50_000, n_steps=20)
    vanilla = tb.price_basket(sim=sim, device="cpu")
    asian = tb.price_basket(sim=sim, payoff="asian_call", device="cpu")
    up_out = tb.price_basket(sim=sim, payoff="up_out_call", device="cpu")
    assert 0.0 < float(asian.price) < float(vanilla.price)
    assert 0.0 < float(up_out.price) < float(vanilla.price)


def test_correlation_raises_the_atm_call():
    """More correlation, more basket variance: a pricier ATM call (the
    correlation enters only through the packed factor, no rebuild)."""
    prices = []
    for rho in (0.0, 0.4, 0.8):
        corr = np.full((3, 3), rho, np.float32)
        np.fill_diagonal(corr, 1.0)
        b = tb.BasketDynamics(s0s=np.full(3, 100.0, np.float32),
                              sigmas=np.full(3, 0.2, np.float32),
                              weights=np.full(3, 1 / 3, np.float32),
                              corr=corr)
        prices.append(float(tb.price_basket(
            mt.OptionParams(), b, mt.SimParams(n_paths=50_000, n_steps=10),
            device="cpu").price))
    assert prices == sorted(prices)
