"""The Heston QE kernel #12 (heston_qe_kernel, ``csrc/heston_qe_kernels.cu``):
its branch-split QE step (``csrc/heston.cuh``), the exponential sampler's
uniform drawn only where a leg takes that sampler (``csrc/heston_qe.cuh``)
and the grid the wrapper computes from the library's paths a block.

No card is needed.  A numpy f32 mirror of the kernel's step (qe_moments,
then per lane only its own sampler and correction, then qe_advance) equals
the port's plain ``heston_qe_step`` (both samplers everywhere, then
selected) bit for bit over both samplers, both plain-K0 fall-backs, NaN and
infinite psi, v = 0 and u at p_at0; the port's step is held to mc_tpu's.
The mirror takes sqrt, log and log1p from torch on arrays of the step's
length, each lane where the step has it, so a lane's is the plain step's
(torch's CPU sqrt is not correctly rounded in its vector body; the card's
sqrtf and torch's CUDA sqrt are).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.models import heston as jh

from mc_tpu_torch import convert
from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.models import heston as th
from mc_tpu_torch.ops import _cuda, payoffs
from test_torch_localvol_launch import launch_blocks

torch.set_num_threads(1)

CSRC = Path(th.__file__).resolve().parents[1] / "csrc"
STEP_SRC = (CSRC / "heston.cuh").read_text()
LEGS_SRC = (CSRC / "heston_qe.cuh").read_text()
KERNEL_SRC = (CSRC / "heston_qe_kernels.cu").read_text()
F32 = np.float32
EPS32 = 2.0 ** -24
# (dynamics, t, n_steps, v range): the stress regime of tests/test_heston_qe.py
# at dt = 0.5 (psi crosses 1.5), and rho = +0.9, xi = 2 at dt = 2, where the
# quadratic sampler's correction falls back above v ~ 16.2 and the
# exponential one's over v ~ 5-16.2.
REGIMES = {
    "stress": (jh.HestonDynamics(v0=0.09, kappa=1.0, theta=0.09, xi=1.0,
                                 rho=-0.9), 1.0, 2, 1.0),
    "fall-backs": (jh.HestonDynamics(v0=17.0, kappa=1.0, theta=0.09, xi=2.0,
                                     rho=0.9), 4.0, 2, 20.0),
    "demo": (jh.DEMO_HESTON, 1.0, 100, 3.0),
}


def _params(dyn, t, n_steps):
    opt = mc_tpu.OptionParams(t=t)
    jp = jh._unpack_heston(jh._pack_heston(opt.as_f32(), dyn.as_f32(),
                                           n_steps))
    tp = th.unpack_heston(th.pack_heston(convert.option_params(opt),
                                         convert.heston_dynamics(dyn),
                                         n_steps, "cpu"))
    return jp, tp


def _f(x) -> F32:
    return F32(float(x))


def _lanes(x, mask, fn):
    """fn (a torch function) of the lanes ``mask`` holds, x their values,
    computed where the plain step computes it: on an array of the step's
    length, each lane at its own place (torch's CPU sqrt, log and log1p
    differ between their vector body and scalar tail by an ulp), the other
    lanes at 1."""
    full = np.ones(mask.shape[0], F32)
    full[mask] = x
    return fn(torch.from_numpy(full)).numpy()[mask]


def mirror_step(p, qc, w, v, z_v, z_s, u):
    """The kernel's QE step in numpy f32 (heston.cuh qe_moments,
    qe_quadratic_step, qe_exponential_step, qe_advance): each lane computes
    only its own sampler and correction.  Returns (w', v', quadratic lane,
    fall-back lane)."""
    theta, emkdt, c1, c2 = _f(p.theta), _f(qc.emkdt), _f(qc.c1), _f(qc.c2)
    aa, k0, k1, k3, k4 = _f(qc.a_mc), _f(qc.k0), _f(qc.k1), _f(qc.k3), _f(qc.k4)
    k2, growth_dt = _f(qc.k2), _f(qc.growth_dt)
    one_minus = F32(1.0 - 1e-6)
    n = v.shape[0]
    with np.errstate(all="ignore"):
        m = theta + (v - theta) * emkdt
        psi = (v * c1 + c2) / (m * m)
        quad = psi <= F32(1.5)
        ex = ~quad
        v_next = np.zeros(n, F32)
        k0_eff = np.zeros(n, F32)
        fall = np.zeros(n, bool)

        # the quadratic lanes
        q_psi, q_m, q_v = psi[quad], m[quad], v[quad]
        two_over = F32(2.0) / np.maximum(q_psi, F32(1e-12))
        b2 = np.maximum(two_over - F32(1.0), F32(0.0))
        b2 = b2 + _lanes(two_over * b2, quad, torch.sqrt)
        a = q_m / (F32(1.0) + b2)
        bz = _lanes(b2, quad, torch.sqrt) + z_v[quad]
        v_next[quad] = (a * bz) * bz
        two_a_a = (F32(2.0) * aa) * a
        ok = two_a_a < one_minus
        safe = np.where(ok, F32(1.0) - two_a_a, F32(1.0))
        k0_q = ((((-aa) * b2) * a) / safe
                + F32(0.5) * _lanes(safe, quad, torch.log)) \
            - (F32(0.5) * k3) * q_v
        k0_eff[quad] = np.where(ok, k0_q, k0 + k1 * q_v)
        fall[quad] = ~ok

        # the exponential lanes
        e_psi, e_m, e_v = psi[ex], m[ex], v[ex]
        p_at0 = (e_psi - F32(1.0)) / (e_psi + F32(1.0))
        beta = (F32(1.0) - p_at0) / np.maximum(e_m, F32(1e-30))
        u_c = np.minimum(u[ex], F32(0.99999994))
        l1p_p = _lanes(-p_at0, ex, torch.log1p)
        l1p_u = _lanes(-u_c, ex, torch.log1p)
        v_next[ex] = np.where(u_c <= p_at0, F32(0.0), (l1p_p - l1p_u) / beta)
        ok = aa < beta * one_minus
        marg = np.where(ok, p_at0 + (beta * (F32(1.0) - p_at0))
                        / np.maximum(beta - aa, F32(1e-30)), F32(1.0))
        k0_e = (-_lanes(marg, ex, torch.log)) - (F32(0.5) * k3) * e_v
        k0_eff[ex] = np.where(ok, k0_e, k0 + k1 * e_v)
        fall[ex] = ~ok

        var_s = np.maximum(k3 * v + k4 * v_next, F32(0.0))
        w = (((w + growth_dt) + k0_eff) + k2 * v_next) \
            + _lanes(var_s, np.ones(n, bool), torch.sqrt) * z_s
    return w.astype(F32), v_next.astype(F32), quad, fall


def _inputs(n, v_hi, seed):
    g = np.random.default_rng(seed)
    w = g.normal(0.0, 0.05, n).astype(F32)
    v = g.uniform(0.0, v_hi, n).astype(F32)
    z_v = g.standard_normal(n).astype(F32)
    z_s = g.standard_normal(n).astype(F32)
    u = g.random(n).astype(F32)
    return w, v, z_v, z_s, u


def _with_edges(p, qc, w, v, z_v, z_s, u):
    """Append v = 0, tiny v (psi infinite where theta = 0), NaN and +inf
    v, and lanes whose u is p_at0 and its two neighbours."""
    edge_v = np.array([0.0, 1e-45, 1e-40, 1e-30, np.nan, np.inf], F32)
    with np.errstate(all="ignore"):
        m = _f(p.theta) + (v - _f(p.theta)) * _f(qc.emkdt)
        psi = (v * _f(qc.c1) + _f(qc.c2)) / (m * m)
        p_at0 = (psi - F32(1.0)) / (psi + F32(1.0))
    ex = np.flatnonzero(psi > 1.5)[:64]
    at_v = np.concatenate([v[ex]] * 3)
    at_u = np.concatenate([p_at0[ex], np.nextafter(p_at0[ex], F32(0.0)),
                           np.nextafter(p_at0[ex], F32(1.0))]).astype(F32)
    k = len(edge_v) + len(at_v)
    g = np.random.default_rng(k)
    return (np.concatenate([w, g.normal(0.0, 0.05, k).astype(F32)]),
            np.concatenate([v, edge_v, at_v]),
            np.concatenate([z_v, g.standard_normal(k).astype(F32)]),
            np.concatenate([z_s, g.standard_normal(k).astype(F32)]),
            np.concatenate([u, g.random(len(edge_v)).astype(F32), at_u]))


@pytest.mark.parametrize("theta0", [False, True])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_branch_split_step_is_the_plain_step_bitwise(regime, theta0):
    """The kernel's split step (each lane only its own sampler) equals the
    plain step (both samplers, selected) bit for bit, w' and v'; the
    regimes reach both samplers and both fall-backs, the edges NaN and
    infinite psi, v = 0 and u at p_at0."""
    dyn, t, n_steps, v_hi = REGIMES[regime]
    if theta0:  # theta = 0: c2 = 0, so v = 0 gives psi NaN, v tiny +inf
        dyn = jh.HestonDynamics(dyn.v0, dyn.kappa, 0.0, dyn.xi, dyn.rho)
    _, tp = _params(dyn, t, n_steps)
    tq = th.qe_consts(tp)
    ins = _with_edges(tp, tq, *_inputs(20_000, v_hi, 3))
    w2, v2, quad, fall = mirror_step(tp, tq, *ins)
    want = th.heston_qe_step(tp, tq, *map(torch.from_numpy, ins))
    np.testing.assert_array_equal(w2.view(np.uint32),
                                  want[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(v2.view(np.uint32),
                                  want[1].numpy().view(np.uint32))
    if regime != "demo":
        assert quad.any() and (~quad).any()  # both samplers
    if regime == "fall-backs":
        assert (fall & quad).any() and (fall & ~quad).any()
    with np.errstate(invalid="ignore"):
        psi_nan = ~(ins[1] * 0 == 0)
    assert (~quad[psi_nan]).all()  # NaN v (so psi): the exponential lanes


@pytest.mark.parametrize("regime", ["stress", "fall-backs"])
def test_plain_step_is_held_to_mc_tpu(regime):
    """The port's step, which the mirror equals, against mc_tpu's on the
    same f32 inputs (the parity contract: 1e-6 relative and 8 f32 ulp of
    the largest output; the frameworks' log/log1p/sqrt differ by an ulp)."""
    dyn, t, n_steps, v_hi = REGIMES[regime]
    jp, tp = _params(dyn, t, n_steps)
    jq, tq = jh.qe_consts(jp), th.qe_consts(tp)
    ins = _inputs(20_000, v_hi, 4)
    want = jh.heston_qe_step(jp, jq, *map(jnp.asarray, ins))
    got = th.heston_qe_step(tp, tq, *map(torch.from_numpy, ins))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                   atol=8 * EPS32 * np.abs(w).max())


@pytest.mark.parametrize("n_steps", [1, 2, 12, 100, 1000, 100_000])
@pytest.mark.parametrize("dyn", [th.DEMO_HESTON,
                                 th.HestonDynamics(0.09, 1.5, 0.04, 0.3, 0.5),
                                 th.HestonDynamics(0.0, 5.0, 0.02, 0.45, -0.9)])
def test_psi_stays_under_its_value_at_zero(dyn, n_steps):
    """psi(v) = (c1 v + c2) / m(v)^2 falls from psi(0) = c2 / m(0)^2 for v
    >= 0 (the derivative's numerator c1 theta (1 - e) - 2 e c2 is 0), and
    psi(0) = xi^2 / (2 kappa theta) at any dt (in f32 up to the rounding of
    1 - e^{-kappa dt}, which grows as dt shrinks): under the demo dynamics
    0.5625 < 1.5, no lane takes the exponential sampler, and the kernel
    draws no uniform on the main shape."""
    p = th.unpack_heston(th.pack_heston(OptionParams(), dyn, n_steps, "cpu"))
    qc = th.qe_consts(p)
    v = torch.cat([torch.linspace(0.0, 1.0, 100_001),
                   torch.logspace(-30, 3, 10_001)]).float()
    m = p.theta + (v - p.theta) * qc.emkdt
    psi = (v * qc.c1 + qc.c2) / (m * m)
    top = float(dyn.xi) ** 2 / (2.0 * float(dyn.kappa) * float(dyn.theta))
    # the f32 rounding of 1 - e (and of m near v = 0, where psi is flat)
    rel = 64 * EPS32 / -np.expm1(-float(dyn.kappa) * float(p.dt))
    assert float(psi.max()) <= float(psi[0]) * (1.0 + rel)
    assert float(psi[0]) == pytest.approx(top, rel=rel)
    if dyn == th.DEMO_HESTON:
        assert top == pytest.approx(0.5625)
        assert bool((psi <= th.PSI_C).all())


def mirror_legs(p, qc, v_legs, z_v, z_s, draw):
    """heston_qe.cuh qe_legs_step for two legs (a path and its twin on the
    negated normals): draw() once where either leg takes the exponential
    sampler, leg 1 reading 1 - u.  Returns ((w', v') per leg, drew)."""
    with np.errstate(all="ignore"):
        psi = [(v * _f(qc.c1) + _f(qc.c2))
               / np.square(_f(p.theta) + (v - _f(p.theta)) * _f(qc.emkdt))
               for v in v_legs]
    need = ~(psi[0] <= 1.5) | ~(psi[1] <= 1.5)
    u = np.zeros_like(v_legs[0])
    u[need] = draw(need)
    zero = np.zeros_like(u)
    legs = [mirror_step(p, qc, zero, v_legs[0], z_v, z_s, u)[:2],
            mirror_step(p, qc, zero, v_legs[1], -z_v, -z_s,
                        (F32(1.0) - u).astype(F32))[:2]]
    return legs, need


@pytest.mark.parametrize("regime", ["stress", "demo"])
def test_lazy_uniform_one_draw_twin_reads_one_minus_u(regime):
    """Under antithetic the uniform is drawn once where either leg takes
    the exponential sampler, and the twin reads 1 - u: each leg's step is
    then the plain version's twin (models/heston.py _pay: -z_v, -z_s,
    1 - u) bit for bit; where neither leg does, no draw (the demo: none)."""
    dyn, t, n_steps, v_hi = REGIMES[regime]
    _, tp = _params(dyn, t, n_steps)
    tq = th.qe_consts(tp)
    g = np.random.default_rng(5)
    n = 20_000
    v_legs = [g.uniform(0.0, v_hi, n).astype(F32) for _ in range(2)]
    z_v, z_s = (g.standard_normal(n).astype(F32) for _ in range(2))
    u_all = g.random(n).astype(F32)
    calls = []

    def draw(mask):
        calls.append(int(mask.sum()))
        return u_all[mask]

    legs, need = mirror_legs(tp, tq, v_legs, z_v, z_s, draw)
    assert calls == [int(need.sum())]  # one draw a lane that needs it
    zero = torch.zeros(n)
    for leg, (v, zv, zs, u) in enumerate(((v_legs[0], z_v, z_s, u_all),
                                          (v_legs[1], -z_v, -z_s,
                                           (F32(1.0) - u_all).astype(F32)))):
        want = th.heston_qe_step(tp, tq, zero, *map(torch.from_numpy,
                                                    (v, zv, zs, u)))
        np.testing.assert_array_equal(legs[leg][0].view(np.uint32),
                                      want[0].numpy().view(np.uint32))
        np.testing.assert_array_equal(legs[leg][1].view(np.uint32),
                                      want[1].numpy().view(np.uint32))
    if regime == "demo":
        assert not need.any()
    else:
        assert need.any() and not need.all()


def test_kernel_source_draws_the_uniform_once_and_splits_at_the_switch():
    """The source's own terms: draw_u() once, under the exponential test;
    the twin reads 1 - u; the switch psi <= 1.5; the QE kernel's plain and
    antithetic instantiations apart (bool A), its counters 2j and 2j+1."""
    assert LEGS_SRC.count("= draw_u();") == 1
    assert "if (exponential) u = draw_u();" in LEGS_SRC
    assert "l == 0 ? u : 1.0f - u" in LEGS_SRC
    assert "return q.psi <= 1.5f;" in STEP_SRC
    assert "heston_qe_step(" not in STEP_SRC  # no two-branch step left
    assert re.search(r"heston_qe_kernel<Payoff, R, A>", KERNEL_SRC)
    assert "2u * static_cast<uint32_t>(j)" in KERNEL_SRC
    assert "unit_draw<ROUNDS>(k0, k1, id, c + 1u)" in KERNEL_SRC


@pytest.mark.parametrize("scheme", ["euler", "qe"])
@pytest.mark.parametrize("tile", [256, 128])
@pytest.mark.parametrize("n_paths", [1, 255, 256, 257, 1_000_000,
                                     (1 << 32) - 1])
def test_wrapper_reads_the_librarys_paths_a_block(monkeypatch, n_paths, tile,
                                                  scheme):
    """The grid is ceil(n_paths / the library's paths a block), capped at
    MAX_BLOCKS (the kernels grid-stride past it); one launch counted."""
    cfg = th.HestonConfig(n_paths=n_paths, n_steps=100, scheme=scheme)
    params = torch.empty(len(th.HESTON_FIELDS), device="meta")
    got = launch_blocks(
        monkeypatch, th, "heston", tile,
        lambda: th.heston_partials(payoffs.get_payoff("vanilla_call"), cfg,
                                   (1, 2), params))
    assert got == min(-(-n_paths // tile), _cuda.MAX_BLOCKS)
