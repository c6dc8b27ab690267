"""mc_tpu_torch's randomized QMC under GBM against mc_tpu on the CPU.

The port runs its kernels' plain PyTorch versions here (device="cpu");
mc_tpu runs its engine="xla" dual, which its tests hold bitwise to its
Pallas kernels.  Both build the same point sets: the CBC generating vector
and scipy's Sobol directions by the same numpy code, and the shifts from
the same threefry-20 words.

Tolerances (parity contract):
* point sets, shifts, lattice residues and Sobol coordinates: bitwise;
  the lattice coordinate u = frac(t * (1/n) + shift) bitwise mc_tpu's
  eager one and within 2^-23 (one rounding of a value below 2) of its
  jitted one (XLA may fuse that multiply-add, ROADMAP C18);
* the normals: the port's inverse CDF is bitwise mc_tpu's eager one on at
  least 90% of inputs and within 1e-5 absolute of its jitted one (XLA
  contracts the rationals' multiply-adds, C19);
* prices 1e-5 relative; stderrs 1e-5 relative plus 8 f32 roundings of the
  mean (mc_tpu sums each shift in f32, so its shift means carry that
  error; the port sums in f64).
The statistical cases of tests/test_qmc.py (its GBM half) run at its sizes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu import qmc as jq
from mc_tpu import rng as jrng
from mc_tpu.ops.payoffs import get_payoff as jget_payoff

import mc_tpu_torch as mt
from mc_tpu_torch import convert, qmc, rng
from mc_tpu_torch.oracle import bs_call
from mc_tpu_torch.ops import path_kernels as pk
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

BS = bs_call(100.0, 100.0, 1.0, 0.1, 0.2)
EPS32 = 2.0 ** -24
PRICE_RTOL = 1e-5


def _assert_close(got, want):
    assert float(got.price) == pytest.approx(float(want.price),
                                             rel=PRICE_RTOL)
    tol = 1e-5 * float(want.stderr) + 8 * EPS32 * abs(float(want.price))
    assert abs(float(got.stderr) - float(want.stderr)) <= tol


# --- the point sets ------------------------------------------------------------


def test_prev_prime():
    assert qmc.prev_prime(100) == 97
    assert qmc.prev_prime(4099) == 4099
    assert qmc.prev_prime(1 << 21) < (1 << 20)  # capped
    assert qmc.prev_prime(1 << 20) == jq.prev_prime(1 << 20) == 1_048_573


@pytest.mark.parametrize("n,d", [(509, 8), (4099, 10), (16381, 32)])
def test_lattice_vector_equals_mc_tpus(n, d):
    z = qmc.lattice_vector(n, d)
    np.testing.assert_array_equal(z, jq.lattice_vector(n, d))
    assert z.dtype == np.uint32 and (z > 0).all() and (z < n).all()
    assert len(set(int(v) for v in z)) == d


@pytest.mark.parametrize("n", [4, 7, 16, 100])
def test_bridge_schedule_equals_mc_tpus(n):
    idx, coef = qmc.bridge_schedule(n)
    jidx, jcoef = jq.bridge_schedule(n)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(coef.view(np.uint32), jcoef.view(np.uint32))
    assert idx[0, 0] == n
    assert sorted(idx[:, 0]) == sorted(set(range(1, n + 1)))
    assert coef[0, 2] == pytest.approx(math.sqrt(n))


def test_sobol_directions_equal_mc_tpus_and_scipys_points():
    from scipy.stats import qmc as sqmc

    sv = qmc.sobol_directions(5)
    np.testing.assert_array_equal(sv, jq.sobol_directions(5))
    pts = sqmc.Sobol(d=5, scramble=False).random(16)
    ps = qmc.QMCPointSet("sobol", 16, 5,
                         torch.from_numpy(sv.reshape(-1).astype(np.int32)),
                         torch.zeros((1, 5), dtype=torch.int32))
    ids = torch.arange(16, dtype=torch.int64)
    ours = torch.stack([qmc.point_unit(ps, ids, j)[0] for j in range(5)], 1)
    np.testing.assert_allclose(ours.double().numpy(), pts, atol=1e-12)


@pytest.mark.parametrize("family", ["lattice", "sobol"])
@pytest.mark.parametrize("method,bridge", [("terminal", False),
                                           ("euler", False),
                                           ("euler", True)])
def test_pointset_equals_mc_tpus(family, method, bridge):
    """The table and the shifts bit for bit, and convert.qmc_pointset's
    copy of mc_tpu's equal to the port's own."""
    po = get_payoff("asian_call" if method == "euler" else "vanilla_call")
    sim = mt.SimParams(n_paths=3000, n_steps=9, seed=21)
    m, ps = qmc.qmc_pointset(po, sim, 5, method, family, bridge, 0.1, 0, 21,
                             "cpu")
    n, jm, _, zvec, shifts = jq._qmc_pointset(
        jget_payoff(po.name), mc_tpu.SimParams(n_paths=3000, n_steps=9,
                                               seed=21), 5, method, "xla",
        family, bridge, 8, 0.1, 0, 21)
    assert (m, ps.n) == (jm, n)
    np.testing.assert_array_equal(ps.table.numpy(), np.asarray(zvec))
    np.testing.assert_array_equal(
        ps.shifts.numpy().view(np.uint32),
        np.asarray(shifts).view(np.uint32))
    other = convert.qmc_pointset(family, n, zvec, shifts)
    assert torch.equal(other.table, ps.table)
    assert torch.equal(other.shifts, ps.shifts)


@pytest.mark.parametrize("n", [509, 1021, 4099])
def test_lattice_coordinates_every_point(n):
    """Every point of a small lattice: the residue i z mod n equal to
    mc_tpu's float-assisted Barrett reduction, u bitwise its eager
    _lattice_u and within 2^-23 of the jitted one."""
    z = qmc.lattice_vector(n, 3)
    ids = np.arange(n, dtype=np.uint32)
    for j in range(3):
        zj, shift = int(z[j]), np.float32(0.1 + 0.3 * j)
        i32 = ids.astype(np.int32)
        t = jq._mod_int(jnp.asarray(i32 * (zj >> 10)), n)
        t = jq._mod_int(jnp.left_shift(t, 10) + jnp.asarray(i32 * (zj & 1023)),
                        n)
        got_t = qmc.lattice_residue(torch.from_numpy(ids.astype(np.int64)),
                                    zj, n)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(t))
        ps = qmc.QMCPointSet("lattice", n, 1,
                             torch.tensor([zj], dtype=torch.int32),
                             torch.tensor([[shift]]))
        u = qmc.point_unit(ps, torch.from_numpy(ids.astype(np.int64)),
                           0)[0].numpy()
        eager = np.asarray(jq._lattice_u(jnp.asarray(ids), jnp.uint32(zj),
                                         jnp.float32(shift), n))
        jitted = np.asarray(jax.jit(
            lambda i, zz, s: jq._lattice_u(i, zz, s, n))(
                jnp.asarray(ids), jnp.uint32(zj), jnp.float32(shift)))
        np.testing.assert_array_equal(u.view(np.uint32), eager.view(np.uint32))
        # one rounding of t * (1/n) + shift (< 2) apart: 2^-23 absolute
        assert np.abs(u.astype(np.float64) - jitted).max() <= 2.0 ** -23
        assert len(np.unique(np.round(u * n).astype(int) % n)) == n


def test_sobol_coordinates_every_point():
    """Every point of a 2^12 net under a digital shift, bitwise mc_tpu's
    _sobol_u."""
    n, d = 4096, 4
    sv = qmc.sobol_directions(d).reshape(-1).astype(np.int32)
    dshift = np.array([12345, 99, 1 << 29, 7], np.int32)
    ids = np.arange(n, dtype=np.uint32)
    ps = qmc.QMCPointSet("sobol", n, d, torch.from_numpy(sv),
                         torch.from_numpy(dshift[None, :]))
    for j in range(d):
        got = qmc.point_unit(ps, torch.from_numpy(ids.astype(np.int64)),
                             j)[0].numpy()
        want = np.asarray(jq._sobol_u(jnp.asarray(ids), jnp.asarray(sv),
                                      jnp.asarray(dshift), j,
                                      jax.lax.bitcast_convert_type))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_inv_normal_cdf_accuracy_and_gap_to_mc_tpu():
    """Acklam + one Newton step: within 1e-4 of scipy on (0.001, 0.999);
    bitwise mc_tpu's eager version on >= 90% of inputs, within 1e-5 of its
    jitted one (measured: 97% and 6.2e-6 on 400,000 uniforms)."""
    from scipy.stats import norm

    u = np.linspace(0.001, 0.999, 9973).astype(np.float32)
    got = rng.inv_normal_cdf(torch.from_numpy(u)).numpy()
    assert np.abs(got - norm.ppf(u.astype(np.float64))).max() < 1e-4
    uu = np.random.default_rng(1).uniform(0, 1, 1 << 16).astype(np.float32)
    got = rng.inv_normal_cdf(torch.from_numpy(uu)).numpy()
    eager = np.asarray(jrng.inv_normal_cdf(uu))
    jitted = np.asarray(jax.jit(jrng.inv_normal_cdf)(uu))
    assert (got == eager).mean() >= 0.9
    assert np.abs(got.astype(np.float64) - jitted).max() <= 1e-5
    # the clamp: 0 and 1 map to the ends of [1e-6, 1 - 1e-6]
    ends = rng.inv_normal_cdf(torch.tensor([0.0, 1.0])).numpy()
    np.testing.assert_array_equal(ends, np.asarray(
        jrng.inv_normal_cdf(np.float32([0.0, 1.0]))))


# --- price_qmc against mc_tpu.price_qmc --------------------------------------


@pytest.mark.parametrize("family", ["lattice", "sobol"])
@pytest.mark.parametrize("payoff,n_steps,bridge", [
    ("vanilla_call", 8, False), ("asian_call", 8, False),
    ("asian_call", 8, True), ("asian_call", 7, True),
    ("lookback_call", 7, False), ("cliquet", 8, True)])
def test_price_qmc_matches_mc_tpu(payoff, n_steps, bridge, family):
    """Terminal, Euler (an odd step count too) and the bridge."""
    kw = dict(k=2.0, p1=-0.02, p2=0.04) if payoff == "cliquet" else {}
    jopt = mc_tpu.OptionParams(**kw)
    jsim = mc_tpu.SimParams(n_paths=2000, n_steps=n_steps)
    want = jq.price_qmc(jopt, jsim, payoff, n_shifts=4, engine="xla",
                        family=family, bridge=bridge)
    got = qmc.price_qmc(convert.option_params(jopt), convert.sim_params(jsim),
                        payoff, n_shifts=4, family=family, bridge=bridge,
                        device="cpu")
    _assert_close(got, want)
    assert float(got.n_paths) == float(want.n_paths)


def test_bullet_matches_mc_tpu_within_flips():
    """A barrier count can flip where S lands within an ulp of B: one path
    moves the mean by at most its payoff over n."""
    jopt = mc_tpu.OptionParams(p1=1.0, p2=8.0)
    jsim = mc_tpu.SimParams(n_paths=2053, n_steps=10)
    want = jq.price_qmc(jopt, jsim, "bullet_call", n_shifts=4, engine="xla")
    got = qmc.price_qmc(convert.option_params(jopt), convert.sim_params(jsim),
                        "bullet_call", n_shifts=4, device="cpu")
    assert abs(float(got.price) - float(want.price)) <= 60.0 / 2053


def test_qmc_sums_take_mc_tpus_point_set():
    """The plain sums over mc_tpu's own (n, zvec, shifts), through
    convert.qmc_pointset, give the port's price_qmc bit for bit."""
    po = get_payoff("asian_call")
    jsim = mc_tpu.SimParams(n_paths=1500, n_steps=6)
    n, m, _, zvec, shifts = jq._qmc_pointset(
        jget_payoff("asian_call"), jsim, 3, None, "xla", "sobol", True, 8,
        0.1, 0, jsim.seed)
    ps = convert.qmc_pointset("sobol", n, zvec, shifts)
    cfg = pk.KernelConfig(n_paths=n, n_steps=6, method=m)
    prm = pk.pack_params(mt.DEMO_OPTION, 6, "cpu")
    sums = finish_sum(qmc.qmc_sums(po, cfg, ps, prm, bridge=True))[:, 0]
    own = qmc.price_qmc(sim=convert.sim_params(jsim), payoff="asian_call",
                        n_shifts=3, family="sobol", bridge=True, device="cpu")
    assert float(qmc.finish_qmc(sums, n, mt.DEMO_OPTION).price) == float(
        own.price)


# --- the cases of tests/test_qmc.py (GBM) ------------------------------------


@pytest.mark.parametrize("family,n", [("lattice", 4099), ("sobol", 4096)])
def test_qmc_unbiased_terminal(family, n):
    res = qmc.price_qmc(sim=mt.SimParams(n_paths=n, n_steps=10), n_shifts=8,
                        family=family, device="cpu")
    assert abs(float(res.price) - BS) <= 4.0 * float(res.stderr) + 5e-3


@pytest.mark.parametrize("family,n", [("lattice", 4099), ("sobol", 4096)])
def test_qmc_beats_mc_at_same_budget(family, n):
    """16 shifts of n points against plain MC on the same total paths: the
    stderr under half."""
    shifts = 16
    q = qmc.price_qmc(sim=mt.SimParams(n_paths=n, n_steps=10),
                      n_shifts=shifts, family=family, device="cpu")
    mc = mt.price(sim=mt.SimParams(n_paths=n * shifts, n_steps=10),
                  method="terminal", device="cpu")
    assert float(q.stderr) < 0.5 * float(mc.stderr)
    assert abs(float(q.price) - BS) < 5e-2


def test_qmc_euler_path_dependent():
    res = qmc.price_qmc(mt.OptionParams(p1=1.0, p2=8.0),
                        mt.SimParams(n_paths=2053, n_steps=10),
                        payoff="bullet_call", n_shifts=8, device="cpu")
    assert 0.0 < float(res.price) < BS and float(res.stderr) > 0.0


def test_bridge_marginals_match_plain():
    sim = mt.SimParams(n_paths=4099, n_steps=16)
    plain = qmc.price_qmc(sim=sim, method="euler", n_shifts=8, device="cpu")
    bridged = qmc.price_qmc(sim=sim, method="euler", n_shifts=8, bridge=True,
                            device="cpu")
    tol = 5.0 * (float(plain.stderr) + float(bridged.stderr)) + 1e-3
    assert abs(float(plain.price) - float(bridged.price)) <= tol
    assert abs(float(bridged.price) - BS) <= 5.0 * float(bridged.stderr) + 5e-3


@pytest.mark.parametrize("family,n", [("lattice", 16381), ("sobol", 16384)])
def test_bridge_improves_asian(family, n):
    sim = mt.SimParams(n_paths=n, n_steps=32)
    plain = qmc.price_qmc(sim=sim, payoff="asian_call", n_shifts=12,
                          family=family, device="cpu")
    bridged = qmc.price_qmc(sim=sim, payoff="asian_call", n_shifts=12,
                            family=family, bridge=True, device="cpu")
    assert float(bridged.stderr) < float(plain.stderr)
    assert 0.0 < float(bridged.price) < BS


def test_guards_raise_where_mc_tpu_raises():
    """Each of mc_tpu's guards, in both packages: one shift, a
    path-dependent payoff on the terminal draw, the bridge off Euler, an
    unknown family, the bridge past its step limit (mc_tpu's VMEM
    budget, kept for parity, ROADMAP C20); the model half prices (its
    guards: tests/test_torch_qmc_model_cases.py)."""
    cases = [(dict(n_shifts=1), "n_shifts"),
             (dict(payoff="bullet_call", method="terminal"), "terminal"),
             (dict(bridge=True, method="terminal"), "bridge"),
             (dict(family="halton"), "family"),
             (dict(sim_steps=2000, bridge=True, method="euler"), "budget")]
    for kw, match in cases:
        steps = kw.pop("sim_steps", 10)
        with pytest.raises(ValueError, match=match):
            qmc.price_qmc(sim=mt.SimParams(n_paths=4096, n_steps=steps),
                          device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            jq.price_qmc(sim=mc_tpu.SimParams(n_paths=4096, n_steps=steps),
                         **kw)
    r = qmc.price_qmc(sim=mt.SimParams(n_paths=1 << 10, n_steps=1000),
                      method="euler", n_shifts=2, bridge=True, device="cpu")
    assert math.isfinite(float(r.price)) and float(r.stderr) > 0
    r = qmc.price_qmc_model("heston", sim=mt.SimParams(n_paths=1 << 10,
                                                       n_steps=4),
                            n_shifts=2, device="cpu")
    assert math.isfinite(float(r.price)) and float(r.stderr) > 0
    with pytest.raises(TypeError):
        qmc.price_qmc(engine="pallas", device="cpu")
