"""mc_tpu_torch's trajectories and resume against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here (device="cpu");
mc_tpu runs its Pallas kernels in interpret mode, as
tests/test_trajectories.py does.  Both draw the same threefry stream.

Tolerances:
* prices on the grid: rtol 2e-6 (the f32 exp of the two frameworks differ
  by an ulp or so, and the normals by a few ulp);
* barrier counts: equal on all but 0.1% of paths (a count flips where S
  lands within an ulp of B, and that path's later counts move by one);
* the port's own grids: state == cumsum(S < B) exactly, and pay_sum equal to
  the payoff recomputed from the grids;
* resume: the port's materialize-then-resume equals its straight run to
  rel 1e-6 (as tests/test_trajectories.py:91 holds mc_tpu), and equals
  mc_tpu's resume on the same arrays to the bullet's 0.05 stderr.
"""

import hashlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.payoffs import get_payoff as jget_payoff
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import cli, convert, engines
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

J_SIM = mc_tpu.SimParams(n_paths=2048, n_steps=16)
SIM = convert.sim_params(J_SIM)
OPT = mt.DEMO_OPTION
S_RTOL = 2e-6
FLIP_FRAC = 1e-3
BULLET_SE = 0.05
# docs/GOLDENS.md: the 512 x 100 CSV that mc_tpu renders its golden plot from
GOLDEN_SHA256 = ("4f799553393c0994926c2e9be01647e4f8dd5359f614821e9c9b18a4"
                 "0126b476")


@pytest.fixture(scope="module")
def both():
    return (mt.simulate_trajectories(OPT, SIM, device="cpu"),
            mc_tpu.simulate_trajectories(sim=J_SIM))


def test_shapes_and_layout(both):
    got, _ = both
    assert tuple(got.s.shape) == (SIM.n_steps, SIM.n_paths)
    assert tuple(got.path_matrix().shape) == (SIM.n_paths, SIM.n_steps)
    assert tuple(got.state_matrix().shape) == (SIM.n_paths, SIM.n_steps)
    assert got.s.dtype == got.state.dtype == torch.float32
    assert got.pay_sum.dtype == torch.float64 and got.n_paths == SIM.n_paths


def test_prices_match_mc_tpu(both):
    got, want = both
    np.testing.assert_allclose(got.path_matrix().numpy(),
                               np.asarray(want.path_matrix()), rtol=S_RTOL)


def test_barrier_counts_match_mc_tpu(both):
    got, want = both
    same = (got.state_matrix().numpy()
            == np.asarray(want.state_matrix())).all(axis=1)
    assert same.mean() >= 1.0 - FLIP_FRAC, same.mean()


def test_state_is_barrier_count(both):
    got, _ = both
    path = got.path_matrix().numpy()
    want = np.cumsum(path < OPT.barrier, axis=1).astype(np.float32)
    np.testing.assert_array_equal(got.state_matrix().numpy(), want)


def test_payoff_sums_match_grid(both):
    got, want = both
    path = got.path_matrix().numpy()
    count = got.state_matrix().numpy()[:, -1]
    in_window = (count >= OPT.p1) & (count <= OPT.p2)
    # f32 payoff and square per path, as the kernel forms them; f64 sums
    pay = np.where(in_window, np.maximum(path[:, -1] - np.float32(OPT.k),
                                         np.float32(0.0)), np.float32(0.0))
    assert pay.sum() > 0.0
    assert float(got.pay_sum) == pytest.approx(
        pay.astype(np.float64).sum(), rel=1e-12)
    assert float(got.pay_sq) == pytest.approx(
        (pay * pay).astype(np.float64).sum(), rel=1e-12)
    assert float(got.pay_sum) == pytest.approx(float(want.pay_sum), rel=1e-5)


def test_pay_sum_is_the_bullet_price_stream(both):
    """The grids lie on price()'s bullet stream: the same payoff sum."""
    got, _ = both
    res = mt.price(OPT, SIM, "bullet_call", device="cpu")
    assert float(got.pay_sum) / SIM.n_paths == pytest.approx(
        float(res.payoff_mean), rel=1e-12)


@pytest.mark.parametrize("rng_source", ["threefry13", "threefry"])
@pytest.mark.parametrize("n_steps", [16, 7])
def test_kernel_plain_path_offset_and_odd_steps(rng_source, n_steps):
    """The wrapper's plain version at an offset and an odd step count
    against mc_tpu's kernel on the same global ids."""
    cfg = pk.KernelConfig(n_paths=1024, n_steps=n_steps,
                          rng_source=rng_source)
    prm = pk.pack_params(OPT, n_steps)
    s, st, parts = pk.simulate_trajectories(get_payoff("bullet_call"), cfg,
                                            engines.rng.derive_key(5, 0),
                                            prm, path_offset=3000,
                                            n_valid=3900)
    jcfg = jpk.KernelConfig(n_paths=1024, n_steps=n_steps, tile_rows=8,
                            rng_source=rng_source)
    js, jst, jsum, _ = jpk.simulate_trajectories_kernel(
        jget_payoff("bullet_call"), jcfg, mc_tpu.rng.derive_key(5, 0),
        jpk.pack_params(mc_tpu.OptionParams().as_f32(), n_steps),
        path_offset=jnp.uint32(3000), n_valid=jnp.uint32(3900))
    np.testing.assert_allclose(s.numpy(), convert.surface_matrix(js, 1024).T,
                               rtol=S_RTOL)
    same = (st.numpy() == convert.surface_matrix(jst, 1024).T).all(axis=0)
    assert same.mean() >= 1.0 - FLIP_FRAC
    assert float(finish_sum(parts)[0]) == pytest.approx(
        float(jfinish_sum(jsum)), rel=1e-5)


def test_trajectories_refuse_variance_reduction():
    prm = pk.pack_params(OPT, 4)
    for kw in (dict(antithetic=True), dict(method="terminal"),
               dict(is_shift=1.0), dict(start_step=2)):
        cfg = pk.KernelConfig(n_paths=8, n_steps=4, **kw)
        with pytest.raises(ValueError, match="log-Euler"):
            pk.simulate_trajectories(get_payoff("vanilla_call"), cfg, (1, 2),
                                     prm)


# --- resume ----------------------------------------------------------------


@pytest.mark.parametrize("start", [4, 5])
def test_materialize_then_resume_equals_straight_run(start):
    """Store the states after step `start`, resume from them: the same
    bullet sums as the straight 8-step run (tests/test_trajectories.py:63-92
    for the port, odd resume points included)."""
    sim = mt.SimParams(n_paths=1024, n_steps=8)
    opt = mt.OptionParams(p1=1.0, p2=6.0)  # a window 8 steps can reach
    bullet = get_payoff("bullet_call")
    prm = pk.pack_params(opt, sim.n_steps)
    key = engines.rng.derive_key(sim.seed, 0)
    full = finish_sum(pk.simulate_partials(
        bullet, pk.KernelConfig(n_paths=1024, n_steps=8), key, prm))
    traj = mt.simulate_trajectories(opt, sim, device="cpu")
    cfg = pk.KernelConfig(n_paths=1024, n_steps=8, start_step=start)
    resumed = finish_sum(pk.simulate_partials(
        bullet, cfg, key, prm, s_init=traj.s[start - 1].contiguous(),
        state_init=traj.state[start - 1].contiguous()))
    assert float(full[0]) > 0.0
    np.testing.assert_allclose(resumed.numpy(), full.numpy(), rtol=1e-6)


@pytest.mark.parametrize("start,antithetic,payoff", [
    (4, False, "bullet_call"), (5, False, "bullet_call"),
    (3, True, "bullet_call"), (6, True, "vanilla_call"),
])
def test_resume_matches_mc_tpu(start, antithetic, payoff):
    """simulate_partials(s_init, state_init, start_step) against mc_tpu's
    resume on the same numpy-seeded per-path states."""
    n_paths, n_steps = 1024, 8
    rs = np.random.default_rng(start)
    s_init = (100.0 * np.exp(0.1 * rs.standard_normal(n_paths))).astype(
        np.float32)
    c_init = rs.integers(0, start + 1, n_paths).astype(np.float32)
    opt = mt.OptionParams(p1=2.0, p2=6.0)
    jopt = mc_tpu.OptionParams(p1=2.0, p2=6.0).as_f32()
    key = engines.rng.derive_key(11, 0)
    cfg = pk.KernelConfig(n_paths=n_paths, n_steps=n_steps,
                          start_step=start, antithetic=antithetic)
    got = engines.finish_price(finish_sum(pk.simulate_partials(
        get_payoff(payoff), cfg, key, pk.pack_params(opt, n_steps),
        s_init=torch.from_numpy(s_init), state_init=torch.from_numpy(c_init))),
        n_paths, opt)
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8,
                            start_step=start, antithetic=antithetic)
    jpo = jget_payoff(payoff)
    parts = jpk.simulate_partials(
        jpo, jcfg, mc_tpu.rng.derive_key(11, 0),
        jpk.pack_params(jopt, n_steps),
        s_init=jnp.asarray(s_init.reshape(8, 128)),
        state_init=(jnp.asarray(c_init.reshape(8, 128)),) if jpo.n_state
        else ())
    want = engines.finish_price(torch.tensor(
        [float(jfinish_sum(x)) for x in parts], dtype=torch.float64),
        n_paths, opt)
    se = float(want.stderr)
    assert abs(float(got.price) - float(want.price)) <= BULLET_SE * se
    assert abs(float(got.stderr) - se) <= BULLET_SE * se


def test_resume_guards():
    with pytest.raises(ValueError, match="importance sampling with resume"):
        pk.KernelConfig(n_paths=8, n_steps=4, start_step=2, is_shift=1.0)
    with pytest.raises(ValueError, match="importance sampling with resume"):
        jpk.KernelConfig(n_paths=8, n_steps=4, start_step=2, is_shift=1.0)
    with pytest.raises(ValueError, match="start_step"):
        pk.KernelConfig(n_paths=8, n_steps=4, start_step=4)
    cfg = pk.KernelConfig(n_paths=8, n_steps=4, start_step=2)
    prm = pk.pack_params(OPT, 4)
    bullet = get_payoff("bullet_call")
    with pytest.raises(ValueError, match="state_init"):
        pk.simulate_partials(bullet, cfg, (1, 2), prm, s_init=torch.ones(8))
    with pytest.raises(ValueError, match="s_init must be"):
        pk.simulate_partials(bullet, cfg, (1, 2), prm, s_init=torch.ones(7),
                             state_init=torch.zeros(7))
    with pytest.raises(ValueError, match="needs s_init"):
        pk.simulate_partials(bullet, cfg, (1, 2), prm,
                             state_init=torch.zeros(8))


# --- the traj CSV ----------------------------------------------------------


def _traj_csv(tmp_path, capsys, *args):
    out = tmp_path / "traj.csv"
    assert cli.main(["traj", "--device", "cpu", "--out", str(out),
                     *args]) == 0
    capsys.readouterr()
    return out


def test_traj_csv_matches_path_matrix(tmp_path, capsys):
    out = _traj_csv(tmp_path, capsys, "--n-paths", "37", "--n-steps", "5")
    lines = out.read_text().splitlines()
    assert lines[0] == "time,trajectory,value"
    mat = mt.simulate_trajectories(OPT, mt.SimParams(n_paths=37, n_steps=5),
                                   device="cpu").path_matrix().numpy()
    want = [f"{j},{i},{mat[i, j]:.6f}" for j in range(5) for i in range(37)]
    assert lines[1:] == want


def test_traj_csv_golden_fingerprint(tmp_path, capsys, record_property):
    """Reports whether the port's 512 x 100 CSV reproduces mc_tpu's golden
    sha256; not asserted, since the CSV text rides on each framework's f32
    exp (the stream underneath is bitwise)."""
    out = _traj_csv(tmp_path, capsys, "--n-paths", "512", "--n-steps", "100")
    text = out.read_bytes()
    digest = hashlib.sha256(text).hexdigest()
    record_property("golden_sha256_reproduced", digest == GOLDEN_SHA256)
    print(f"traj 512x100 CSV sha256 {digest}: "
          f"{'reproduces' if digest == GOLDEN_SHA256 else 'differs from'} "
          "docs/GOLDENS.md")
    assert re.fullmatch(r"[0-9a-f]{64}", digest)
    assert text.count(b"\n") == 1 + 512 * 100


# --- every payoff with at most one state word ---------------------------------

# word 0 is continuous in S (a sum or a max) for these; a flag elsewhere
CONTINUOUS_STATE = {"asian_call", "lookback_call"}


@pytest.mark.parametrize("payoff", [
    "digital_call", "digital_put", "best_of_cash", "zcb", "asian_call",
    "up_out_call", "down_out_call", "down_in_call", "lookback_call"])
def test_one_word_payoff_trajectories_match_mc_tpu(payoff):
    """The trajectories kernel's plain version for each payoff the kernel
    takes against mc_tpu's kernel in interpret mode: prices to 2e-6, state
    word 0 to 2e-6 where it is a sum or a max, else equal on all but 0.1%
    of paths, and the payoff sums to 1e-5 (0.05 stderr for the flags)."""
    n_paths, n_steps = 1024, 8
    jopt = mc_tpu.OptionParams(barrier=90.0 if payoff.startswith("down")
                               else 120.0)
    opt = convert.option_params(jopt)
    cfg = pk.KernelConfig(n_paths=n_paths, n_steps=n_steps)
    s, st, parts = pk.simulate_trajectories(
        get_payoff(payoff), cfg, engines.rng.derive_key(9, 0),
        pk.pack_params(opt, n_steps))
    jcfg = jpk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    js, jst, jsum, jsq = jpk.simulate_trajectories_kernel(
        jget_payoff(payoff), jcfg, mc_tpu.rng.derive_key(9, 0),
        jpk.pack_params(jopt.as_f32(), n_steps))
    np.testing.assert_allclose(s.numpy(), convert.surface_matrix(js, n_paths).T,
                               rtol=S_RTOL)
    jstate = convert.surface_matrix(jst, n_paths).T
    if payoff in CONTINUOUS_STATE:
        np.testing.assert_allclose(st.numpy(), jstate, rtol=S_RTOL)
    else:
        same = (st.numpy() == jstate).all(axis=0)
        assert same.mean() >= 1.0 - FLIP_FRAC
    got = engines.finish_price(finish_sum(parts), n_paths, opt)
    want = engines.finish_price(torch.tensor(
        [float(jfinish_sum(jsum)), float(jfinish_sum(jsq))],
        dtype=torch.float64), n_paths, opt)
    if payoff in CONTINUOUS_STATE or payoff in ("best_of_cash", "zcb"):
        assert float(got.price) == pytest.approx(float(want.price), rel=1e-5)
    else:
        se = float(want.stderr)
        assert abs(float(got.price) - float(want.price)) <= BULLET_SE * se


def test_trajectories_refuse_multi_word_payoffs():
    cfg = pk.KernelConfig(n_paths=8, n_steps=4)
    with pytest.raises(ValueError, match="one state array"):
        pk.simulate_trajectories(get_payoff("cliquet"), cfg, (1, 2),
                                 pk.pack_params(OPT, 4))
