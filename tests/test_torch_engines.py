"""mc_tpu_torch's path kernels and price() against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here (device="cpu");
mc_tpu runs its engine="xla" dual, which is bitwise equal to its Pallas
kernel by that package's own contract.  Both draw the same threefry
stream from the same key.

Tolerances (parity contract):
* vanilla payoffs: 1e-5 relative in price and stderr — the per-path values
  differ only where the frameworks' f32 log1p/cos/sin/exp differ by an ulp;
* bullet payoffs: 0.05 stderr — a barrier count can flip on a path whose
  S lands within an ulp of B;
* mc_tpu finishes its sums in f32 (x64 is off) while the port finishes in
  f64; where that f32 finish cancels (the control-variate variance), the
  stderr is held to the bound of that cancellation, derived below.
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
from mc_tpu_torch import convert, engines, oracle, rng
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

# Barrier window reachable within 16 steps (as tests/test_engines.py uses).
J_OPT = mc_tpu.OptionParams(p1=1.0, p2=6.0)
J_SIM = mc_tpu.SimParams(n_paths=4096, n_steps=16)
OPT = convert.option_params(J_OPT)
SIM = convert.sim_params(J_SIM)
J_KEY = np.asarray(mc_tpu.rng.derive_key(J_SIM.seed, 0), np.uint32)
KEY = convert.key(J_KEY)
VANILLA_RTOL = 1e-5
BULLET_SE = 0.05
EPS32 = 2.0 ** -24  # f32 unit roundoff


def _jax_moments(payoff, n_paths, n_steps, path_offset=0, **kw):
    cfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8,
                           **kw)
    parts = jeng._xla_partials(jget_payoff(payoff), cfg, J_KEY,
                               J_OPT.as_f32(), jnp.uint32(path_offset))
    return torch.tensor([float(jfinish_sum(x)) for x in parts],
                        dtype=torch.float64)


def _cv_stderr_rtol(sums, n):
    """Relative stderr tolerance where mc_tpu's CV moments are f32.

    Each f32 moment is within a few ulp (8 units of roundoff here) of its
    size; var_x = E[X^2] - E[X]^2 and cov cancel, and adj_var = var_p -
    cov^2/var_x carries those errors scaled by beta = cov/var_x.  Half of
    adj_var's relative error is the stderr's, on top of the 1e-5 contract.
    """
    m_p, e_p2, m_x, e_x2, e_px = (float(v) / n for v in sums)
    var_p, var_x = e_p2 - m_p ** 2, e_x2 - m_x ** 2
    cov = e_px - m_p * m_x
    beta = cov / var_x
    d = 8 * EPS32
    d_adj = d * ((e_p2 + m_p ** 2)
                 + 2 * abs(beta) * (abs(e_px) + abs(m_p * m_x))
                 + beta ** 2 * (e_x2 + m_x ** 2))
    return VANILLA_RTOL + 0.5 * d_adj / (var_p - cov * beta)


def _assert_price_close(got, want, bullet, se_rtol=VANILLA_RTOL):
    gp, ws, wp = float(got.price), float(want.stderr), float(want.price)
    if bullet:
        assert abs(gp - wp) <= BULLET_SE * ws, (gp, wp, ws)
        assert abs(float(got.stderr) - ws) <= BULLET_SE * ws
    else:
        assert abs(gp - wp) <= VANILLA_RTOL * abs(wp), (gp, wp)
        assert abs(float(got.stderr) - ws) <= se_rtol * ws, (
            float(got.stderr), ws, se_rtol)


@pytest.mark.parametrize("n_paths", [4097, 1001, 2])
def test_terminal_pair_partials_odd_paths(n_paths):
    """Element e prices paths (2e, 2e+1); the odd trailing path is masked."""
    n_elems = (n_paths + 1) // 2
    jcfg = jpk.KernelConfig(n_paths=n_elems, n_steps=J_SIM.n_steps,
                            tile_rows=8)
    jparts = jpk.terminal_pair_partials(
        jget_payoff("vanilla_call"), jcfg, J_KEY,
        jpk.pack_params(J_OPT.as_f32(), J_SIM.n_steps), jnp.uint32(n_paths),
        engine="xla")
    want = [float(jfinish_sum(x)) for x in jparts]
    cfg = pk.KernelConfig(n_paths=n_elems, n_steps=SIM.n_steps,
                          method="terminal")
    got = finish_sum(pk.terminal_pair_partials(
        get_payoff("vanilla_call"), cfg, KEY,
        pk.pack_params(OPT, SIM.n_steps), n_paths)).tolist()
    np.testing.assert_allclose(got, want, rtol=VANILLA_RTOL)


def test_pack_params_bitwise():
    want = np.asarray(jpk.pack_params(J_OPT.as_f32(), 37))
    got = pk.pack_params(OPT, 37).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# terminal/euler x plain/antithetic/CV x vanilla/put/bullet
CASES = [
    (method, variant, payoff)
    for method in ("terminal", "euler")
    for variant in ("plain", "antithetic", "cv")
    for payoff in ("vanilla_call", "vanilla_put", "bullet_call")
    if not (method == "terminal" and payoff == "bullet_call")
]


@pytest.mark.parametrize("method,variant,payoff", CASES)
def test_simulate_partials_matches_mc_tpu(method, variant, payoff):
    """Same stream, same per-path f32 values: the moment sums agree, and so
    do the prices that one f64 finish makes of them."""
    kw = dict(method=method, antithetic=variant != "plain",
              with_cv=variant == "cv")
    want_sums = _jax_moments(payoff, J_SIM.n_paths, J_SIM.n_steps, **kw)
    cfg = pk.KernelConfig(n_paths=SIM.n_paths, n_steps=SIM.n_steps, **kw)
    got_sums = finish_sum(pk.simulate_partials(
        get_payoff(payoff), cfg, KEY, pk.pack_params(OPT, SIM.n_steps)))
    cv = variant == "cv"
    got = engines.finish_price(got_sums, SIM.n_paths, OPT, cv)
    want = engines.finish_price(want_sums, SIM.n_paths, OPT, cv)
    se_rtol = (_cv_stderr_rtol(got_sums, SIM.n_paths) if cv
               else VANILLA_RTOL)
    _assert_price_close(got, want, bullet=payoff == "bullet_call",
                        se_rtol=se_rtol)
    if payoff != "bullet_call":
        np.testing.assert_allclose(got_sums.numpy(), want_sums.numpy(),
                                   rtol=VANILLA_RTOL)


def test_simulate_partials_path_offset_and_bound():
    """A slice at a global path offset draws the global ids' counters and
    masks ids at or past the bound."""
    cfg = pk.KernelConfig(n_paths=1024, n_steps=5, antithetic=True)
    jcfg = jpk.KernelConfig(n_paths=1024, n_steps=5, tile_rows=8,
                            antithetic=True)
    jparts = jeng._xla_partials(jget_payoff("vanilla_call"), jcfg, J_KEY,
                                J_OPT.as_f32(), jnp.uint32(3000),
                                n_valid=jnp.uint32(3900))
    want = [float(jfinish_sum(x)) for x in jparts]
    got = finish_sum(pk.simulate_partials(
        get_payoff("vanilla_call"), cfg, KEY, pk.pack_params(OPT, 5),
        path_offset=3000, n_valid=3900)).tolist()
    np.testing.assert_allclose(got, want, rtol=VANILLA_RTOL)


PRICE_CASES = [
    dict(),                                         # -> terminal_pair
    dict(method="terminal"),
    dict(method="euler"),
    dict(antithetic=True),                          # -> terminal
    dict(rng_source="threefry"),
    dict(payoff="vanilla_put", method="euler", antithetic=True),
    dict(payoff="bullet_call"),                     # -> euler
    dict(payoff="bullet_call", antithetic=True),
]


@pytest.mark.parametrize("kw", PRICE_CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_price_matches_mc_tpu(kw):
    """price() picks the same method, hence the same stream, as mc_tpu."""
    want = mc_tpu.price(J_OPT, J_SIM, engine="xla", **kw)
    got = mt.price(OPT, SIM, device="cpu", **kw)
    _assert_price_close(got, want,
                        bullet=kw.get("payoff") == "bullet_call")
    assert float(got.n_paths) == J_SIM.n_paths


@pytest.mark.parametrize("method", ["terminal", "euler"])
def test_control_variate_price_matches_mc_tpu(method):
    """The CV finish end to end: price to 1e-5; the stderr to 1e-5 plus the
    error of mc_tpu's f32 moments and finish (see _cv_stderr_rtol)."""
    kw = dict(method=method, antithetic=True, control_variate=True)
    want = mc_tpu.price(J_OPT, J_SIM, engine="xla", **kw)
    got = mt.price(OPT, SIM, device="cpu", **kw)
    cfg = pk.KernelConfig(n_paths=SIM.n_paths, n_steps=SIM.n_steps,
                          method=method, antithetic=True, with_cv=True)
    sums = finish_sum(pk.simulate_partials(
        get_payoff("vanilla_call"), cfg, KEY,
        pk.pack_params(OPT, SIM.n_steps)))
    _assert_price_close(got, want, bullet=False,
                        se_rtol=_cv_stderr_rtol(sums, SIM.n_paths))


def test_default_method_choice():
    """terminal_pair for plain terminal payoffs; the per-path stream once
    antithetic/CV/offset need it; euler for path-dependent payoffs."""
    base = mt.price(OPT, SIM, device="cpu")
    pair = mt.price(OPT, SIM, device="cpu", method="terminal_pair")
    assert float(base.price) == float(pair.price)
    anti = mt.price(OPT, SIM, device="cpu", antithetic=True)
    anti_t = mt.price(OPT, SIM, device="cpu", antithetic=True,
                      method="terminal")
    assert float(anti.price) == float(anti_t.price)
    off = mt.price(OPT, SIM, device="cpu", path_offset=8)
    off_t = mt.price(OPT, SIM, device="cpu", path_offset=8,
                     method="terminal")
    assert float(off.price) == float(off_t.price)
    bul = mt.price(OPT, SIM, "bullet_call", device="cpu")
    bul_e = mt.price(OPT, SIM, "bullet_call", device="cpu", method="euler")
    assert float(bul.price) == float(bul_e.price)


@pytest.mark.parametrize("kw", [
    dict(), dict(method="terminal"), dict(method="euler"),
    dict(antithetic=True),
    dict(method="euler", antithetic=True, control_variate=True),
])
def test_hello_call_within_3se_of_black_scholes(kw):
    bs = oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2)
    sim = mt.SimParams(n_paths=20_000, n_steps=8)
    res = mt.price(mt.DEMO_OPTION, sim, device="cpu", **kw)
    assert float(res.stderr) > 0
    assert res.within(bs, 3.0), (float(res.price), float(res.stderr), bs)


def test_bs_call_matches_mc_tpu_oracle():
    want = float(mc_tpu.oracle.bs_call(100.0, 95.0, 0.5, 0.03, 0.25, 0.01))
    assert oracle.bs_call(100.0, 95.0, 0.5, 0.03, 0.25, 0.01) == (
        pytest.approx(want, rel=1e-6))


def test_summarize_matches_mc_tpu():
    got = oracle.summarize(12.5, 400.0, 10, 0.9)
    want = mc_tpu.oracle.summarize(jnp.float32(12.5), jnp.float32(400.0),
                                   10, jnp.float32(0.9))
    for f in ("price", "stderr", "payoff_mean", "payoff_var"):
        assert float(getattr(got, f)) == pytest.approx(
            float(getattr(want, f)), rel=1e-6), f


# --- guards --------------------------------------------------------------


def test_hw_rng_source_refused():
    with pytest.raises(ValueError, match="hardware PRNG"):
        mt.price(OPT, SIM, rng_source="hw", device="cpu")
    with pytest.raises(ValueError, match="hardware PRNG"):
        pk.KernelConfig(n_paths=8, n_steps=2, rng_source="hw")
    with pytest.raises(ValueError, match="unknown rng_source"):
        mt.price(OPT, SIM, rng_source="philox", device="cpu")


def test_importance_sampling_and_resume_not_ported():
    with pytest.raises(NotImplementedError):
        mt.price(OPT, SIM, method="terminal", importance_shift=0.5,
                 device="cpu")
    with pytest.raises(NotImplementedError):
        pk.KernelConfig(n_paths=8, n_steps=4, start_step=2)
    with pytest.raises(NotImplementedError):
        pk.KernelConfig(n_paths=8, n_steps=4, is_shift=1.0)
    cfg = pk.KernelConfig(n_paths=8, n_steps=4)
    with pytest.raises(NotImplementedError):
        pk.simulate_partials(get_payoff("bullet_call"), cfg, KEY,
                             pk.pack_params(OPT, 4),
                             s_init=torch.ones(8))


def test_invalid_combinations():
    with pytest.raises(ValueError, match="path-dependent"):
        mt.price(OPT, SIM, "bullet_call", method="terminal", device="cpu")
    with pytest.raises(ValueError, match="terminal_pair"):
        mt.price(OPT, SIM, method="terminal_pair", antithetic=True,
                 device="cpu")
    with pytest.raises(ValueError, match="path_offset"):
        mt.price(OPT, SIM, method="terminal_pair", path_offset=4,
                 device="cpu")
    with pytest.raises(KeyError, match="not yet ported"):
        mt.price(OPT, SIM, "asian_call", device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        mt.price(OPT, SIM, device="meta")
    with pytest.raises(ValueError, match="2\\^32"):
        mt.price(OPT, SIM, n_paths=1 << 32, device="cpu")


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.price(OPT, SIM)


# --- convert --------------------------------------------------------------


def test_convert_carries_config_and_key():
    o = convert.option_params(J_OPT.as_f32())
    assert o.astuple() == pytest.approx(OPT.astuple(), rel=1e-7)
    assert convert.sim_params(J_SIM) == SIM
    k = rng.derive_key(J_SIM.seed, 0)
    assert convert.key(J_KEY) == (int(k[0]), int(k[1]))
    with pytest.raises(ValueError):
        convert.key(np.array([1, 2, 3], np.uint32))
    with pytest.raises(ValueError):
        convert.key(np.array([-1, 2]))


def test_convert_surface_matrix():
    grid = np.arange(3 * 2 * 128, dtype=np.float32).reshape(3, 2, 128)
    m = convert.surface_matrix(grid, 200)
    assert m.shape == (200, 3)
    # path i = row i // 128, lane i % 128; step j along the last axis
    assert m[130, 2] == grid[2, 1, 2]
    with pytest.raises(ValueError):
        convert.surface_matrix(grid, 257)
