"""mc_tpu_torch's payoff registry (all 18 payoffs) against mc_tpu on the CPU.

Hand-computed paths pin each payoff's semantics on the port's registry (the
port of tests/test_payoffs.py:23-100, plus the bridge barriers, the variance
swap, the forward start, the cliquet and the lookback's running max).  Then
every payoff goes through the port's plain kernel versions and mc_tpu's
engine="xla" dual on the same threefry stream, and the multi-word payoffs
resume against mc_tpu's Pallas kernel in interpret mode.

Tolerances:
* payoff functions on the same f32 inputs: rtol 1e-6, atol 1e-7 (the
  frameworks' f32 log/exp differ by an ulp); the geometric control
  exp(mean log S) - K to 1e-6 of S (a sum of f32 logs, exponentiated, then
  a difference that cancels most of it);
* mc_tpu's prices finish in f32: var = E[p^2] - E[p]^2 cancels where the
  mean dwarfs the spread (best_of_cash), so each stderr is held to 1e-5
  plus the bound of that cancellation;
* prices of the smooth payoffs: 1e-5 relative in price and stderr (the
  parity contract: the per-path values differ only where the frameworks'
  f32 log1p/cos/sin/exp/log differ by an ulp);
* prices where a flip can decide a path (digitals, discrete barriers, the
  bullet's window): 0.05 stderr, since a path whose S lands within an ulp of
  K or B can go either way;
* the geometric control variate: price 1e-5 relative; mc_tpu's moments are
  f32, so the CV stderr, which cancels most of the variance, is held to the
  bound of that cancellation (as tests/test_torch_engines.py derives it);
  its closed-form expectation to 1e-5 (mc_tpu evaluates it in f32).
"""

import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu import engines as jeng
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import PAYOFFS as JPAYOFFS
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, engines, oracle
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import PAYOFFS, get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

VANILLA_RTOL = 1e-5
FLIP_SE = 0.05
EPS32 = 2.0 ** -24
# Payoffs where a path's value jumps at K or B (a flip within an ulp).
FLIPS = {"digital_call", "digital_put", "bullet_call", "up_out_call",
         "down_out_call", "down_in_call"}
# Options that make each payoff live at 16 steps (the mc_tpu field names).
J_OPTIONS = {
    "bullet_call": dict(p1=1.0, p2=6.0),
    "down_out_call": dict(barrier=90.0),
    "down_in_call": dict(barrier=90.0),
    "down_out_call_bb": dict(barrier=90.0),
    "variance_swap": dict(k=0.03),
    "forward_start_call": dict(k=1.0, p1=6.0),
    "cliquet": dict(k=4.0, p1=-0.02, p2=0.04),
}
J_SIM = mc_tpu.SimParams(n_paths=4096, n_steps=16)
SIM = convert.sim_params(J_SIM)


def _options(name):
    jopt = mc_tpu.OptionParams(**J_OPTIONS.get(name, {}))
    return jopt, convert.option_params(jopt)


# --- hand-computed paths ---------------------------------------------------


def params(**kw):
    base = dict(s0=100.0, k=100.0, r=0.1, sigma=0.2, t=1.0, barrier=120.0,
                p1=1.0, p2=3.0, q=0.0, dt=0.25, inv_n_steps=0.25)
    base.update(kw)
    return SimpleNamespace(**{k: torch.tensor(v, dtype=torch.float32)
                              for k, v in base.items()})


def run_path(payoff, prices, p, control=False):
    po = get_payoff(payoff)
    s = torch.tensor(prices[0], dtype=torch.float32)
    state = po.init(p, torch.zeros_like(s))
    for v in prices:
        s = torch.tensor(v, dtype=torch.float32)
        state = po.update(state, s, p)
    fn = po.control if control else po.terminal
    return float(fn(state, s, p))


def test_get_payoff_unknown_lists_all_18():
    with pytest.raises(KeyError, match="unknown payoff 'nope'") as err:
        get_payoff("nope")
    assert "not yet ported" not in str(err.value)
    for name in JPAYOFFS:
        assert name in str(err.value)


def test_registry_matches_mc_tpu():
    assert set(PAYOFFS) == set(JPAYOFFS) and len(PAYOFFS) == 18
    for name, po in PAYOFFS.items():
        jpo = JPAYOFFS[name]
        assert (po.n_state, po.terminal_only, po.has_control) == (
            jpo.n_state, jpo.terminal_only, jpo.has_control), name
        assert get_payoff(po) is po
    assert sorted(po.cuda_id for po in PAYOFFS.values()) == list(range(18))
    # the ids of the first slice stay
    assert [PAYOFFS[n].cuda_id for n in ("vanilla_call", "vanilla_put",
                                          "bullet_call")] == [0, 1, 2]


def test_vanilla_call_put():
    p = params()
    vc, vp = get_payoff("vanilla_call"), get_payoff("vanilla_put")
    s = torch.tensor([113.0, 90.0])
    assert vc.terminal((), s, p).tolist() == pytest.approx([13.0, 0.0])
    assert vp.terminal((), s, p).tolist() == pytest.approx([0.0, 10.0])


def test_terminal_only_payoffs():
    p = params()
    s = torch.tensor([113.0, 90.0, 100.0])
    assert get_payoff("digital_call").terminal((), s, p).tolist() == [1, 0, 0]
    assert get_payoff("digital_put").terminal((), s, p).tolist() == [0, 1, 0]
    assert get_payoff("best_of_cash").terminal((), s, p).tolist() == [
        113.0, 100.0, 100.0]
    assert get_payoff("zcb").terminal((), s, p).tolist() == [1, 1, 1]


def test_bullet_window_semantics():
    p = params()  # barrier=120, window [1,3] steps below barrier
    assert run_path("bullet_call", [110.0, 130.0, 115.0, 125.0], p) == \
        pytest.approx(25.0)
    assert run_path("bullet_call", [130.0, 130.0, 130.0, 130.0], p) == 0.0
    assert run_path("bullet_call", [110.0, 110.0, 110.0, 110.0], p) == 0.0
    assert run_path("bullet_call", [110.0, 110.0, 110.0, 125.0], p) == \
        pytest.approx(25.0)


def test_asian_call_mean():
    p = params(k=100.0, inv_n_steps=0.25)
    assert run_path("asian_call", [100.0, 110.0, 120.0, 130.0], p) == \
        pytest.approx(15.0)
    assert run_path("asian_call", [80.0, 90.0, 90.0, 80.0], p) == 0.0


def test_up_out_call():
    p = params(barrier=120.0)
    assert run_path("up_out_call", [105.0, 110.0, 115.0], p) == \
        pytest.approx(15.0)
    assert run_path("up_out_call", [105.0, 125.0, 115.0], p) == 0.0


def test_down_in_and_down_out_call():
    p = params(barrier=90.0)
    assert run_path("down_in_call", [95.0, 110.0, 115.0], p) == 0.0
    assert run_path("down_in_call", [85.0, 110.0, 115.0], p) == \
        pytest.approx(15.0)
    assert run_path("down_out_call", [95.0, 110.0, 115.0], p) == \
        pytest.approx(15.0)
    assert run_path("down_out_call", [85.0, 110.0, 115.0], p) == 0.0


def test_lookback_call():
    p = params(k=100.0)
    assert run_path("lookback_call", [100.0, 140.0, 110.0], p) == \
        pytest.approx(40.0)


def test_lookback_running_max_starts_at_zero():
    """mc_tpu's init returns its zeros argument: the max is over S_1..S_N,
    not S0 (=100 here)."""
    p = params(k=85.0)
    po = get_payoff("lookback_call")
    assert po.init(p, torch.zeros(3))[0].tolist() == [0.0, 0.0, 0.0]
    assert run_path("lookback_call", [90.0, 95.0, 80.0], p) == \
        pytest.approx(10.0)


def _bridge(a, b, sigma=0.2, dt=0.25):
    return 1.0 - math.exp(-2.0 * a * b / (sigma * sigma * dt))


def test_up_out_call_bb():
    p = params(barrier=120.0)
    want = (_bridge(math.log(120 / 100), math.log(120 / 110))
            * _bridge(math.log(120 / 110), math.log(120 / 115)) * 15.0)
    assert run_path("up_out_call_bb", [110.0, 115.0], p) == \
        pytest.approx(want, rel=1e-5)
    assert run_path("up_out_call_bb", [110.0, 125.0, 115.0], p) == 0.0


def test_down_out_call_bb():
    p = params(barrier=90.0)
    want = (_bridge(math.log(100 / 90), math.log(95 / 90))
            * _bridge(math.log(95 / 90), math.log(105 / 90)) * 5.0)
    assert run_path("down_out_call_bb", [95.0, 105.0], p) == \
        pytest.approx(want, rel=1e-5)
    assert run_path("down_out_call_bb", [95.0, 85.0, 105.0], p) == 0.0


def test_variance_swap():
    p = params(k=0.01, t=1.0)
    path = [110.0, 99.0, 105.0]
    prev, acc = 100.0, 0.0
    for v in path:
        acc += math.log(v / prev) ** 2
        prev = v
    assert run_path("variance_swap", path, p) == pytest.approx(
        acc - 0.01, rel=1e-5)


def test_forward_start_call():
    path = [105.0, 110.0, 120.0, 115.0]
    # the strike fixes after step 2 at 110
    assert run_path("forward_start_call", path, params(k=1.0, p1=2.0)) == \
        pytest.approx(5.0)
    # p1 = 0 fixes it at S0 = 100: a vanilla struck at k * S0
    assert run_path("forward_start_call", path, params(k=1.0, p1=0.0)) == \
        pytest.approx(15.0)
    assert run_path("forward_start_call", path, params(k=0.9, p1=2.0)) == \
        pytest.approx(115.0 - 0.9 * 110.0)


def test_cliquet():
    """Periods of 2 steps, floor -2%, cap 4%: +3% at step 2, then
    99/103 - 1 = -3.9% floored to -2% at step 4."""
    p = params(k=2.0, p1=-0.02, p2=0.04)
    assert run_path("cliquet", [101.0, 103.0, 102.0, 99.0], p) == \
        pytest.approx(0.03 - 0.02, rel=1e-5)
    # a capped period
    assert run_path("cliquet", [104.0, 110.0], p) == pytest.approx(0.04)


def test_asian_geo_cv_control():
    p = params(k=100.0, inv_n_steps=0.25)
    path = [100.0, 110.0, 120.0, 130.0]
    assert run_path("asian_call_geo_cv", path, p) == pytest.approx(15.0)
    geo = math.exp(sum(math.log(v) for v in path) / 4)
    assert run_path("asian_call_geo_cv", path, p, control=True) == \
        pytest.approx(geo - 100.0, rel=1e-5)  # f32 sum of logs, then exp


@pytest.mark.parametrize("name", sorted(PAYOFFS))
def test_payoff_functions_match_mc_tpu_on_seeded_paths(name):
    """init/update/terminal (and control) of both registries on the same
    numpy-seeded f32 price paths."""
    rs = np.random.default_rng(sorted(PAYOFFS).index(name))
    n_paths, n_steps = 512, 12
    path = (100.0 * np.exp(np.cumsum(0.05 * rs.standard_normal(
        (n_steps, n_paths)), axis=0))).astype(np.float32)
    jopt, opt = _options(name)
    p = pk.unpack_params(pk.pack_params(opt, n_steps))
    jp = jeng._payoff_namespace(jopt.as_f32(), n_steps)
    po, jpo = PAYOFFS[name], JPAYOFFS[name]
    st = po.init(p, torch.zeros(n_paths))
    jst = jpo.init(jp, jnp.zeros(n_paths, jnp.float32))
    for row in path:
        st = po.update(st, torch.from_numpy(row), p)
        jst = jpo.update(jst, jnp.asarray(row), jp)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    s_t = torch.from_numpy(path[-1])
    fns = [("terminal", po.terminal, jpo.terminal, 1e-7)]
    if po.has_control:
        fns.append(("control", po.control, jpo.control, 1e-6 * 100.0))
    for what, f, jf, atol in fns:
        np.testing.assert_allclose(
            f(st, s_t, p).numpy(), np.asarray(jf(jst, jnp.asarray(path[-1]),
                                                 jp)),
            rtol=1e-6, atol=atol, err_msg=what)


def test_control_expectation_matches_mc_tpu():
    jopt = mc_tpu.OptionParams(k=95.0, q=0.01)
    got = float(engines.control_mean(get_payoff("asian_call_geo_cv"),
                                      pk.pack_params(convert.option_params(
                                          jopt), 16)))
    want = float(JPAYOFFS["asian_call_geo_cv"].control_expectation(
        jeng._payoff_namespace(jopt.as_f32(), 16)))
    assert got == pytest.approx(want, rel=1e-5)


# --- every payoff against mc_tpu on the same stream --------------------------


def _f32_finish_rtol(res):
    """The stderr's tolerance where mc_tpu forms var = E[p^2] - E[p]^2 from
    f32 moments (8 units of roundoff each): half of var's relative error."""
    mean, var = float(res.payoff_mean), float(res.payoff_var)
    if var == 0.0:
        return VANILLA_RTOL
    return VANILLA_RTOL + 0.5 * 8 * EPS32 * (var + 2 * mean * mean) / var


def _assert_close(name, got, want, se_rtol=None):
    gp, wp, ws = float(got.price), float(want.price), float(want.stderr)
    if name in FLIPS:
        assert abs(gp - wp) <= FLIP_SE * ws, (gp, wp, ws)
        assert abs(float(got.stderr) - ws) <= FLIP_SE * ws
    else:
        se_rtol = se_rtol or _f32_finish_rtol(got)
        assert gp == pytest.approx(wp, rel=VANILLA_RTOL, abs=1e-9)
        assert float(got.stderr) == pytest.approx(ws, rel=se_rtol, abs=1e-9)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("name", sorted(PAYOFFS))
def test_price_matches_mc_tpu(name, antithetic):
    """Default method (terminal_pair, terminal or euler, as mc_tpu picks)
    and the antithetic variant, on the same key."""
    jopt, opt = _options(name)
    want = mc_tpu.price(jopt, J_SIM, name, engine="xla",
                        antithetic=antithetic)
    got = mt.price(opt, SIM, name, antithetic=antithetic, device="cpu")
    _assert_close(name, got, want)


@pytest.mark.parametrize("name", sorted(
    n for n, po in PAYOFFS.items() if po.terminal_only))
def test_terminal_only_payoffs_by_euler_match_mc_tpu(name):
    jopt, opt = _options(name)
    want = mc_tpu.price(jopt, J_SIM, name, engine="xla", method="euler")
    got = mt.price(opt, SIM, name, method="euler", device="cpu")
    _assert_close(name, got, want)


def _cv_stderr_rtol(sums, n):
    """The CV stderr's tolerance where mc_tpu's five moments are f32 (8
    units of roundoff each), carried through adj_var = var_p - cov^2/var_x
    (the derivation of tests/test_torch_engines.py)."""
    m_p, e_p2, m_x, e_x2, e_px = (float(v) / n for v in sums)
    var_p, var_x = e_p2 - m_p ** 2, e_x2 - m_x ** 2
    cov = e_px - m_p * m_x
    beta = cov / var_x
    d = 8 * EPS32
    d_adj = d * ((e_p2 + m_p ** 2)
                 + 2 * abs(beta) * (abs(e_px) + abs(m_p * m_x))
                 + beta ** 2 * (e_x2 + m_x ** 2))
    return VANILLA_RTOL + 0.5 * d_adj / (var_p - cov * beta)


@pytest.mark.parametrize("antithetic", [False, True])
def test_geometric_control_variate_matches_mc_tpu(antithetic):
    name = "asian_call_geo_cv"
    jopt, opt = _options(name)
    kw = dict(antithetic=antithetic, control_variate=True)
    want = mc_tpu.price(jopt, J_SIM, name, engine="xla", **kw)
    got = mt.price(opt, SIM, name, device="cpu", **kw)
    cfg = pk.KernelConfig(n_paths=SIM.n_paths, n_steps=SIM.n_steps,
                          antithetic=antithetic, with_cv=True)
    sums = finish_sum(pk.simulate_partials(
        get_payoff(name), cfg, engines.rng.derive_key(SIM.seed, 0),
        pk.pack_params(opt, SIM.n_steps)))
    # the moments themselves, against mc_tpu's
    jcfg = jpk.KernelConfig(n_paths=4096, n_steps=16, tile_rows=8,
                            antithetic=antithetic, with_cv=True)
    jsums = [float(jfinish_sum(x)) for x in jeng._xla_partials(
        JPAYOFFS[name], jcfg, mc_tpu.rng.derive_key(J_SIM.seed, 0),
        jopt.as_f32(), jnp.uint32(0))]
    np.testing.assert_allclose(sums.numpy(), jsums, rtol=VANILLA_RTOL)
    _assert_close(name, got, want, se_rtol=_cv_stderr_rtol(sums, 4096))
    # and the control cuts the stderr of the plain Asian
    plain = mt.price(opt, SIM, "asian_call", antithetic=antithetic,
                     device="cpu")
    assert float(got.stderr) < 0.2 * float(plain.stderr)


# --- resume of the multi-word payoffs ---------------------------------------


def _resume_state(name, start, s_init, rs, n):
    """Per-path states a run could hold after step ``start``."""
    if name in ("up_out_call_bb", "down_out_call_bb"):
        return (s_init, rs.uniform(0.5, 1.0, n))
    if name == "variance_swap":
        return (s_init, rs.uniform(0.0, 0.02, n))
    if name == "forward_start_call":
        return (np.full(n, start), 100.0 * rs.uniform(0.9, 1.1, n))
    if name == "cliquet":
        return (np.full(n, start), 100.0 * rs.uniform(0.9, 1.1, n),
                rs.uniform(-0.04, 0.08, n))
    assert name == "asian_call_geo_cv"
    return (start * s_init, start * np.log(s_init))


@pytest.mark.parametrize("start", [4, 5])
@pytest.mark.parametrize("name", sorted(
    n for n, po in PAYOFFS.items() if po.n_state >= 2))
def test_multi_word_resume_matches_mc_tpu(name, start):
    """simulate_partials from numpy-seeded (s_init, state words) at an even
    and an odd start_step, against mc_tpu's kernel on the same arrays."""
    n_paths, n_steps = 1024, 8
    rs = np.random.default_rng(start)
    s_init = (100.0 * np.exp(0.1 * rs.standard_normal(n_paths))).astype(
        np.float32)
    state = [np.asarray(a, np.float32)
             for a in _resume_state(name, start, s_init, rs, n_paths)]
    jopt = mc_tpu.OptionParams(**{**J_OPTIONS.get(name, {}),
                                  **({"p1": 6.0} if name ==
                                     "forward_start_call" else {})})
    opt = convert.option_params(jopt)
    cfg = pk.KernelConfig(n_paths=n_paths, n_steps=n_steps, start_step=start)
    key = engines.rng.derive_key(11, 0)
    got = finish_sum(pk.simulate_partials(
        get_payoff(name), cfg, key, pk.pack_params(opt, n_steps),
        s_init=torch.from_numpy(s_init),
        state_init=tuple(torch.from_numpy(a) for a in state)))
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8,
                            start_step=start)
    parts = jpk.simulate_partials(
        JPAYOFFS[name], jcfg, mc_tpu.rng.derive_key(11, 0),
        jpk.pack_params(jopt.as_f32(), n_steps),
        s_init=jnp.asarray(s_init.reshape(8, 128)),
        state_init=tuple(jnp.asarray(a.reshape(8, 128)) for a in state))
    want = np.array([float(jfinish_sum(x)) for x in parts])
    assert abs(want[0]) > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=VANILLA_RTOL)


def test_resume_state_must_carry_every_word():
    cfg = pk.KernelConfig(n_paths=8, n_steps=4, start_step=2)
    prm = pk.pack_params(mt.OptionParams(k=2.0, p1=-0.02, p2=0.04), 4)
    cliquet = get_payoff("cliquet")
    with pytest.raises(ValueError, match="3 state words"):
        pk.simulate_partials(cliquet, cfg, (1, 2), prm, s_init=torch.ones(8),
                             state_init=torch.zeros(8))
    with pytest.raises(ValueError, match=r"state_init\[1\] must be"):
        pk.simulate_partials(cliquet, cfg, (1, 2), prm, s_init=torch.ones(8),
                             state_init=(torch.zeros(8), torch.zeros(7),
                                         torch.zeros(8)))


# --- validation (tests/test_forward_start.py:76-92) --------------------------


def test_validation():
    sim = mt.SimParams(n_paths=1024, n_steps=20)
    with pytest.raises(ValueError, match="determination step"):
        mt.price(mt.OptionParams(k=1.0, p1=50.0), sim,
                 payoff="forward_start_call", method="euler", device="cpu")
    with pytest.raises(ValueError, match="determination step"):
        mt.price(mt.OptionParams(k=1.0, p1=10.5), sim,
                 payoff="forward_start_call", method="euler", device="cpu")
    with pytest.raises(ValueError, match="period length"):
        mt.price(mt.OptionParams(k=0.0, p1=-0.02, p2=0.04), sim,
                 payoff="cliquet", method="euler", device="cpu")
    with pytest.raises(ValueError, match="floor"):
        mt.price(mt.OptionParams(k=5.0, p1=0.04, p2=-0.02), sim,
                 payoff="cliquet", method="euler", device="cpu")
    with pytest.raises(ValueError, match="path-dependent"):
        mt.price(mt.OptionParams(k=0.03), sim, payoff="variance_swap",
                 method="terminal", device="cpu")


# --- identities on one key ---------------------------------------------------


def test_digital_parity_and_zcb():
    sim = mt.SimParams(n_paths=20_000, n_steps=8)
    call = mt.price(mt.DEMO_OPTION, sim, "digital_call", device="cpu")
    put = mt.price(mt.DEMO_OPTION, sim, "digital_put", device="cpu")
    bond = math.exp(-float(np.float32(0.1)))
    assert float(call.price) + float(put.price) == pytest.approx(bond,
                                                                 rel=2e-6)
    zcb = mt.price(mt.DEMO_OPTION, sim, "zcb", device="cpu")
    assert float(zcb.price) == pytest.approx(bond, rel=1e-12)
    assert float(zcb.stderr) <= 1e-6
    cf = oracle.bs_digital_call(100.0, 100.0, 1.0, 0.1, 0.2)
    assert abs(float(call.price) - cf) <= 4.0 * float(call.stderr)


def test_in_out_parity_and_best_of_cash():
    opt = mt.OptionParams(barrier=90.0)
    sim = mt.SimParams(n_paths=8192, n_steps=16)
    d_in = mt.price(opt, sim, "down_in_call", device="cpu")
    d_out = mt.price(opt, sim, "down_out_call", device="cpu")
    van = mt.price(opt, sim, "vanilla_call", method="euler", device="cpu")
    assert float(d_in.price) > 0.0 and float(d_out.price) > 0.0
    assert float(d_in.price) + float(d_out.price) == pytest.approx(
        float(van.price), rel=1e-12)
    boc = mt.price(opt, sim, "best_of_cash", method="terminal", device="cpu")
    call = mt.price(opt, sim, "vanilla_call", method="terminal", device="cpu")
    disc_k = 100.0 * math.exp(-float(np.float32(0.1)))
    assert float(boc.price) == pytest.approx(disc_k + float(call.price),
                                             rel=1e-6)
