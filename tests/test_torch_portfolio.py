"""mc_tpu_torch's batched book (price_portfolio, the book kernel's plain
version, pack_params_rows, convert.book_params) on the CPU: the cases of
tests/test_portfolio.py, and the book against mc_tpu's engine="xla" book on
the same stream.

Tolerances: vanilla contracts 1e-5 relative in price; the stderr 1e-5 plus
the bound of mc_tpu's f32 finish (var = E[p^2] - E[p]^2 in f32, and for the
control variate adj_var = var_p - cov^2/var_x); bullet contracts 0.05
stderr (a barrier count can flip where S lands within an ulp of B).  Inside
the port a contract equals its standalone price on the same key exactly (the
same f32 per-path values, summed in the same order), and pack_params_rows
equals pack_params row by row bit for bit.
"""

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.engines import price_portfolio as jprice_portfolio
from mc_tpu.ops import path_kernels as jpk

import mc_tpu_torch as mt
from mc_tpu_torch import convert, oracle
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import get_payoff

torch.set_num_threads(1)

SIM = mt.SimParams(n_paths=8192, n_steps=20)
VANILLA_RTOL = 1e-5
BULLET_SE = 0.05
EPS32 = 2.0 ** -24
FIELDS = ("s0", "t", "k", "r", "sigma", "barrier", "p1", "p2", "q")


def book():
    return dict(
        s0=np.array([100.0, 100.0, 90.0, 110.0], np.float32),
        t=np.array([1.0, 0.5, 1.0, 2.0], np.float32),
        k=np.array([100.0, 105.0, 95.0, 100.0], np.float32),
        r=np.full(4, 0.1, np.float32),
        sigma=np.array([0.2, 0.25, 0.15, 0.3], np.float32),
        barrier=np.full(4, 120.0, np.float32),
        p2=np.full(4, 12.0, np.float32),
        p1=np.full(4, 2.0, np.float32),
    )


def contract(b, i):
    return mt.OptionParams(**{f: float(v[i]) for f, v in b.items()})


def test_portfolio_matches_bs():
    b = book()
    res = mt.price_portfolio(mt.OptionParams(**b), SIM, antithetic=True,
                             device="cpu")
    assert tuple(res.price.shape) == (4,)
    for i in range(4):
        bs = oracle.bs_call(b["s0"][i], b["k"][i], b["t"][i], b["r"][i],
                            b["sigma"][i])
        assert abs(float(res.price[i]) - bs) <= 4.0 * float(res.stderr[i])


@pytest.mark.parametrize("payoff,kw", [
    ("vanilla_call", dict()),
    ("vanilla_call", dict(method="euler", antithetic=True)),
    ("bullet_call", dict()),
    ("bullet_call", dict(antithetic=True)),
    ("vanilla_call", dict(method="euler", control_variate=True)),
    ("asian_call_geo_cv", dict(control_variate=True)),
    ("cliquet", dict()),
])
def test_portfolio_matches_individual(payoff, kw):
    """Contract b equals its standalone price() on the same key, exactly
    (the book rides the classic per-path stream: method pinned)."""
    b = book()
    if payoff == "cliquet":
        b.update(k=np.full(4, 5.0, np.float32),
                 p1=np.full(4, -0.02, np.float32),
                 p2=np.full(4, 0.04, np.float32))
    res = mt.price_portfolio(mt.OptionParams(**b), SIM, payoff,
                             device="cpu", **kw)
    method = kw.get("method") or ("terminal" if get_payoff(payoff)
                                  .terminal_only else "euler")
    for i in range(4):
        single = mt.price(contract(b, i), SIM, payoff,
                          **{**kw, "method": method}, device="cpu")
        assert float(res.price[i]) == float(single.price), i
        assert float(res.stderr[i]) == float(single.stderr), i


def _f32_finish_rtol(mean, var):
    return VANILLA_RTOL + 0.5 * 8 * EPS32 * (var + 2 * mean * mean) / var


@pytest.mark.parametrize("payoff,kw", [
    ("vanilla_call", dict(method="terminal")),
    ("bullet_call", dict(method="euler")),
    ("bullet_call", dict(method="euler", antithetic=True)),
    ("vanilla_put", dict(method="euler", antithetic=True)),
])
def test_portfolio_matches_mc_tpu(payoff, kw):
    b = book()
    want = jprice_portfolio(mc_tpu.OptionParams(**b), mc_tpu.SimParams(
        n_paths=SIM.n_paths, n_steps=SIM.n_steps), payoff, engine="xla",
        tile_rows=8, **kw)
    got = mt.price_portfolio(mt.OptionParams(**b), SIM, payoff,
                             device="cpu", **kw)
    for i in range(4):
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


def test_portfolio_cv_book_matches_mc_tpu_and_cuts_the_stderr():
    b = book()
    kw = dict(payoff="vanilla_call", method="euler", control_variate=True)
    want = jprice_portfolio(mc_tpu.OptionParams(**b), mc_tpu.SimParams(
        n_paths=SIM.n_paths, n_steps=SIM.n_steps), engine="xla",
        tile_rows=8, **kw)
    got = mt.price_portfolio(mt.OptionParams(**b), SIM, device="cpu", **kw)
    np.testing.assert_allclose(got.price.numpy(), np.asarray(want.price),
                               rtol=VANILLA_RTOL)
    plain = mt.price_portfolio(mt.OptionParams(**b), SIM, "vanilla_call",
                               method="euler", device="cpu")
    assert bool((got.stderr < plain.stderr).all())


def test_portfolio_large_book():
    """B=64 through the one batched call: > 95% of contracts within 5
    stderr of Black-Scholes (tests/test_portfolio.py:76-99)."""
    rng_np = np.random.default_rng(7)
    b = 64
    opts = mt.OptionParams(
        s0=np.full(b, 100.0, np.float32),
        t=rng_np.uniform(0.5, 2.0, b).astype(np.float32),
        k=rng_np.uniform(80.0, 120.0, b).astype(np.float32),
        r=np.full(b, 0.1, np.float32),
        sigma=rng_np.uniform(0.1, 0.4, b).astype(np.float32))
    res = mt.price_portfolio(opts, mt.SimParams(n_paths=20_000, n_steps=4),
                             method="terminal", device="cpu")
    bs = np.array([oracle.bs_call(opts.s0[i], opts.k[i], opts.t[i], 0.1,
                                  opts.sigma[i]) for i in range(b)])
    err = np.abs(res.price.numpy() - bs) / res.stderr.numpy()
    assert (err < 5.0).mean() > 0.95, err.max()


def test_pack_params_rows_bitwise():
    """Row b of pack_params_rows == pack_params(contract b) == mc_tpu's
    pack_params(contract b), bit for bit; scalars broadcast to B."""
    b = book()
    rows = pk.pack_params_rows(mt.OptionParams(**b), 37).numpy()
    assert rows.shape == (4, 15) and rows.dtype == np.float32
    for i in range(4):
        one = pk.pack_params(contract(b, i), 37).numpy()
        jone = np.asarray(jpk.pack_params(
            mc_tpu.OptionParams(**{f: float(v[i]) for f, v in b.items()})
            .as_f32(), 37))
        np.testing.assert_array_equal(rows[i].view(np.int32),
                                      one.view(np.int32))
        np.testing.assert_array_equal(rows[i].view(np.int32),
                                      jone.view(np.int32))
    # a tensor field, the rest scalars
    mixed = pk.pack_params_rows(mt.OptionParams(k=torch.tensor([90.0,
                                                                 110.0])), 8)
    assert tuple(mixed.shape) == (2, 15)
    assert torch.equal(mixed[1], pk.pack_params(mt.OptionParams(k=110.0), 8))


def test_book_params_round_trip():
    """convert.book_params carries mc_tpu's book across: both packages
    price the same book."""
    jbook = mc_tpu.OptionParams(**book())
    got = convert.book_params(jbook)
    for f in FIELDS:
        v = getattr(got, f)
        assert v.shape == (4,) and v.dtype == np.float32, f
        np.testing.assert_array_equal(v, np.broadcast_to(
            np.asarray(getattr(jbook, f), np.float32), (4,)))
    a = mt.price_portfolio(got, SIM, device="cpu")
    b = mt.price_portfolio(mt.OptionParams(**book()), SIM, device="cpu")
    assert torch.equal(a.price, b.price)
    with pytest.raises(ValueError, match="scalar or a"):
        convert.book_params(dict(s0=np.ones((2, 2)), **{
            f: 1.0 for f in FIELDS if f != "s0"}))


def test_book_block_threads():
    def threads(n_steps, method="euler"):
        return pk.book_block_threads(pk.KernelConfig(
            n_paths=64, n_steps=n_steps, method=method))

    assert threads(100) == 256
    assert threads(216) == 256 and threads(217) == 128
    assert threads(100_000, "terminal") == 256
    assert threads(400) == 128
    assert threads(600) == 64
    assert threads(1000) == 32 and threads(1736) == 32
    for n_steps in (1737, 2000):
        with pytest.raises(ValueError, match="even a block of 32"):
            threads(n_steps)
    with pytest.raises(ValueError, match="even a block of 32"):
        mt.price_portfolio(mt.OptionParams(k=np.array([90.0, 110.0])),
                           mt.SimParams(n_paths=64, n_steps=2000),
                           "bullet_call", device="cpu")


def test_book_guards():
    call = get_payoff("vanilla_call")
    cfg = pk.KernelConfig(n_paths=8, n_steps=4)
    with pytest.raises(ValueError, match="params_rows must be"):
        pk.simulate_book_partials(call, cfg, (1, 2), torch.zeros(15))
    with pytest.raises(ValueError, match="params_rows must be"):
        pk.simulate_book_partials(call, cfg, (1, 2), torch.zeros((0, 15)))
    with pytest.raises(ValueError, match="importance sampling"):
        pk.simulate_book_partials(
            call, pk.KernelConfig(n_paths=8, n_steps=4, is_shift=1.0), (1, 2),
            torch.zeros((2, 15)))
    with pytest.raises(ValueError, match="path-dependent"):
        mt.price_portfolio(mt.OptionParams(k=np.array([90.0, 110.0])),
                           SIM, "bullet_call", method="terminal",
                           device="cpu")


def test_price_portfolio_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.price_portfolio(mt.OptionParams(k=np.array([90.0, 110.0])),
                           mt.SimParams(n_paths=64, n_steps=2))
