"""mc_tpu_torch's European swaptions (kernel #11's five tiles) against
mc_tpu on the CPU.

The port runs its kernel's plain PyTorch version here (device="cpu").  Both
packages draw the threefry-13 pair at counter (id, 0) (G2++ also an
inverse-CDF normal from word 0 at (id, 1)) under the model's stream tag.
mc_tpu prices a single-curve swaption by its classic XLA program
(engine=None) or by its fused tile (engine="xla", the Pallas kernel's
bitwise dual); the port has one route, held to both.  mc_tpu prices the
multi-curve swaptions on its classic route only.

Tolerances:
* the packs: G2++'s bitwise (host f64 cast to f32); Hull-White's bitwise
  but its three l-coefficients, and the Vasicek pack's OU fields, within
  the ulps measured against mc_tpu's eager pack on 200 random (a, sigma,
  T) (PIN_ULP; XLA's exp, expm1 and tanh are not PyTorch's, ROADMAP C22),
  its logA_j within LOGA_UNITS x 2^-24 of the scale of its two terms
  (logA = c (B - s) - sigma^2 B^2 / (4a) cancels where B ~ s);
* per path, on mc_tpu's own pack: PER_PATH_ABS (16 ulp of the swap's
  scale, 1; the normals are a few ulp apart, C2, and G2++'s third normal
  within C19's bound) and at least half bitwise;
* prices against either route: PRICE_RTOL relative + 1e-9 (mc_tpu's own
  gap between its routes is 3e-7 at 10 payments, tests/test_rates_fused.py:
  its classic route adds the payoffs in one f32 sum, ROADMAP C23; the
  normals add a few ulp a path); stderrs 1e-6 relative plus the bound of
  mc_tpu's f32 finish;
* the oracles: 1e-12 relative (the same host f64 arithmetic).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu import oracle as joracle
from mc_tpu import rng as jrng
from mc_tpu.models import g2pp as jg2
from mc_tpu.models import hullwhite as jhw
from mc_tpu.models import swaption as jsw
from mc_tpu.models.vasicek import VasicekDynamics as JVasicek
from mc_tpu.ops import _pallas as jpallas
from mc_tpu.ops import path_kernels as jpk
from mc_tpu.ops.reduce import finish_sum as jfinish_sum

import mc_tpu_torch as mt
from mc_tpu_torch import convert, oracle
from mc_tpu_torch.models import g2pp as tg2
from mc_tpu_torch.models import hullwhite as thw
from mc_tpu_torch.models import swaption as tsw
from mc_tpu_torch.ops import _cuda, fused
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

EPS32 = 2.0 ** -24
PRICE_RTOL = 5e-7
SE_RTOL = 1e-6
PER_PATH_ABS = 16 * 2.0 ** -23
# Gaps (ulp) of the port's OU fields from mc_tpu's eager pack: the e1, B,
# l11, l21, l22 of the expiry step and B_j of the tables.  Measured on the
# 200 cases of test_pack_ou_fields_within_measured_ulps: 1, 3, 2, 7, 36, 4
# and logA_j 7.4 units; a 300-case probe of ou_chol2 alone: 1, 4, 2, 8, 35.
# Pinned at the larger of the two, logA_j at 8 units.
PIN_ULP = {"e1": 1, "big_b": 4, "l11": 3, "l21": 8, "l22": 36, "b_j": 5}
LOGA_UNITS = 8.0

JSPEC = jsw.SwaptionSpec(k_rate=0.04)
SPEC = convert.swaption_spec(JSPEC)
JPROJ = jhw.DiscountCurve(jhw.DEMO_CURVE.times,
                          np.asarray(jhw.DEMO_CURVE.zeros) + 0.0025)
PROJ = convert.discount_curve(JPROJ)
CURVE = convert.discount_curve(jhw.DEMO_CURVE)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _specs(payer=True, k_rate=0.04, n=10):
    return (jsw.SwaptionSpec(k_rate=k_rate, payer=payer, n_payments=n),
            tsw.SwaptionSpec(k_rate=k_rate, payer=payer, n_payments=n))


def _jva_pack(js, a=0.3, b=0.05, sig=0.015, r0=0.05):
    return np.asarray(jsw._pack_va_swpt(js, jnp.float32(a), jnp.float32(b),
                                        jnp.float32(sig), jnp.float32(r0)))


def _jhw_pack(js, dyn=jhw.DEMO_HW, curve=jhw.DEMO_CURVE):
    return np.asarray(jhw._pack_hw_swpt(
        jnp.float32(dyn.a), jnp.float32(dyn.sigma_r), js,
        *jhw._hw_tables(js, dyn, curve)))


def _jg2_pack(js, dyn=jg2.DEMO_G2, curve=jhw.DEMO_CURVE):
    return np.asarray(jg2._pack_g2_swpt(js, dyn,
                                        jg2._g2_tables(js, dyn, curve)))


# --- the packs --------------------------------------------------------------


@pytest.mark.parametrize("payer,n", [(True, 10), (False, 1), (True, 60)])
@pytest.mark.parametrize("dyn", [jg2.DEMO_G2,
                                 jg2.G2Dynamics(a=0.2, sigma=0.02, b_mr=1.1,
                                                eta=0.004, rho=0.3)])
def test_g2_pack_is_bitwise(payer, n, dyn):
    js, ts = _specs(payer, n=n)
    got = tg2.pack_g2_swpt(ts, convert.g2_dynamics(dyn),
                           tg2.g2_tables(ts, convert.g2_dynamics(dyn), CURVE))
    assert np.array_equal(got.numpy().view(np.int32),
                          _jg2_pack(js, dyn).view(np.int32))


@pytest.mark.parametrize("payer,n", [(True, 10), (False, 1), (True, 60)])
def test_hw_pack_host_fields_bitwise_l_within_ulps(payer, n):
    js, ts = _specs(payer, n=n)
    got = thw.pack_hw_swpt(0.3, 0.015, ts,
                           *thw.hw_tables(ts, thw.DEMO_HW, CURVE)).numpy()
    want = _jhw_pack(js)
    assert got.shape == want.shape == (7 + 3 * n,)
    assert np.array_equal(got[3:].view(np.int32), want[3:].view(np.int32))
    gap = _ulps(got[:3], want[:3])
    assert (gap <= [PIN_ULP["l11"], PIN_ULP["l21"], PIN_ULP["l22"]]).all()


@pytest.mark.parametrize("payer,n", [(True, 10), (False, 3)])
def test_va_pack_plain_fields_bitwise(payer, n):
    """x0 = r0 - b, b*T, K*tau, the sign and b are plain f32 arithmetic."""
    js, ts = _specs(payer, k_rate=0.05, n=n)
    got = tsw.pack_va_swpt(ts, 0.3, 0.05, 0.015, 0.05).numpy()
    want = _jva_pack(js)
    assert got.shape == want.shape == (10 + 2 * n,)
    idx = [0, 6, 7, 8, 9]
    assert np.array_equal(got[idx].view(np.int32), want[idx].view(np.int32))


def test_pack_ou_fields_within_measured_ulps():
    """On 200 random (a, sigma_r, T, tau, b, r0): the OU fields of both
    packs (e1, B, l11, l21, l22; the Hull-White pack's l's), B_j within
    PIN_ULP and logA_j within LOGA_UNITS of its terms' scale."""
    rs = np.random.default_rng(7)
    worst = dict.fromkeys(PIN_ULP, 0)
    worst_loga = 0.0
    for _ in range(200):
        a = float(np.float32(rs.uniform(0.02, 2.0)))
        sig = float(np.float32(rs.uniform(0.001, 0.05)))
        t0 = float(rs.choice([0.25, 0.5, 1.0, 2.0, 5.0, 10.0])
                   * rs.uniform(0.5, 1.5))
        tau = float(rs.choice([0.25, 0.5, 1.0]))
        b = float(np.float32(rs.uniform(0.0, 0.08)))
        r0 = float(np.float32(rs.uniform(0.0, 0.08)))
        js = jsw.SwaptionSpec(expiry=t0, tenor=tau, n_payments=10,
                              k_rate=0.04)
        ts = convert.swaption_spec(js)
        got = tsw.pack_va_swpt(ts, a, b, sig, r0).numpy()
        want = _jva_pack(js, a, b, sig, r0)
        gap = _ulps(got, want)
        for name, i in (("e1", 1), ("big_b", 2), ("l11", 3), ("l21", 4),
                        ("l22", 5)):
            worst[name] = max(worst[name], int(gap[i]))
        worst["b_j"] = max(worst["b_j"], int(gap[20:30].max()))
        s = tau * np.arange(1, 11)
        bt = -np.expm1(-a * s) / a
        scale = (abs(b - sig * sig / (2 * a * a)) * s
                 + sig * sig * bt * bt / (4 * a))
        worst_loga = max(worst_loga, float(
            (np.abs(got[10:20].astype(np.float64) - want[10:20])
             / (EPS32 * scale)).max()))
        hdyn = jhw.HullWhiteDynamics(a=a, sigma_r=sig)
        hgot = thw.pack_hw_swpt(a, sig, ts, *thw.hw_tables(
            ts, convert.hw_dynamics(hdyn), CURVE)).numpy()
        hgap = _ulps(hgot[:3], _jhw_pack(js, hdyn)[:3])
        for name, g in zip(("l11", "l21", "l22"), hgap):
            worst[name] = max(worst[name], int(g))
    assert all(worst[k] <= PIN_ULP[k] for k in PIN_ULP), worst
    assert worst_loga <= LOGA_UNITS, worst_loga


def test_mc_tpu_packs_through_convert_bitwise():
    js, _ = _specs(n=7)
    for fn, want in ((convert.va_swpt_params, _jva_pack(js)),
                     (convert.hw_swpt_params, _jhw_pack(js)),
                     (convert.g2_swpt_params, _jg2_pack(js))):
        got = fn(want, 7)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32))
        with pytest.raises(ValueError, match="float32"):
            fn(want, 8)


def test_multicurve_packs_append_mc_tpus_weights():
    js, ts = _specs(payer=False)
    const, wvec = jhw._hw_mc_weights(js, jhw.DEMO_CURVE, JPROJ)
    tc, tw = thw.hw_mc_weights(ts, CURVE, PROJ)
    assert np.array_equal(const, tc) and np.array_equal(wvec, tw)
    tail = np.asarray(jnp.asarray([const[0], *wvec[1:]], jnp.float32))
    hw = thw.pack_multicurve(convert.hw_swpt_params(_jhw_pack(js), 10),
                             tc, tw).numpy()
    g2 = thw.pack_multicurve(convert.g2_swpt_params(_jg2_pack(js), 10),
                             tc, tw).numpy()
    assert hw.shape == (fused.packed_length("hw_mc", 10),)
    assert g2.shape == (fused.packed_length("g2_mc", 10),)
    assert np.array_equal(hw[-11:].view(np.int32), tail.view(np.int32))
    assert np.array_equal(g2[-11:].view(np.int32), tail.view(np.int32))


# --- per path -----------------------------------------------------------------

IDS = np.concatenate([np.arange(4096), np.arange(4096) * 997 + 12345,
                      [2**32 - 2, 2**32 - 1]]).astype(np.uint32)


def _per_path_check(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and (got >= 0).all()
    assert np.abs(got - want).max() <= PER_PATH_ABS
    assert np.mean(got == want) >= 0.5


@pytest.mark.parametrize("payer", [True, False])
@pytest.mark.parametrize("n_pay", [1, 10, 60])
@pytest.mark.parametrize("model", ["va", "hw", "g2"])
def test_plain_tile_per_path_on_mc_tpus_pack(model, n_pay, payer):
    """Each plain tile on mc_tpu's own pack (through convert) against the
    mc_tpu tile evaluated eagerly on the same ids and key."""
    js, _ = _specs(payer, n=n_pay)
    jtile, pay, pack, conv = {
        "va": (jsw._va_swpt_tile, tsw.va_swpt_pay, _jva_pack,
               convert.va_swpt_params),
        "hw": (jhw._hw_swpt_tile, thw.hw_swpt_pay, _jhw_pack,
               convert.hw_swpt_params),
        "g2": (jg2._g2_swpt_tile, tg2.g2_swpt_pay, _jg2_pack,
               convert.g2_swpt_params)}[model]
    pv = pack(js)
    k0, k1 = (int(k) for k in jrng.derive_key(5, 0, 0x4877))
    ids = jnp.asarray(IDS)
    want = jtile(n_pay, jnp.asarray(pv), ids, jnp.ones(ids.shape, bool),
                 jnp.uint32(k0), jnp.uint32(k1), jax.lax.bitcast_convert_type)
    got = pay(n_pay, conv(pv, n_pay), torch.from_numpy(IDS.astype(np.int64)),
              k0, k1)
    assert got.dtype == torch.float32
    _per_path_check(got.numpy(), want)


@pytest.mark.parametrize("payer", [True, False])
@pytest.mark.parametrize("model", ["hw", "g2"])
def test_plain_multicurve_tile_per_path(model, payer):
    """The multi-curve tiles against mc_tpu's classic arithmetic
    (``_hw_mtm_multicurve`` / ``_g2_mtm_multicurve`` on its expiry draw of
    paths 0..n-1, discounted as ``_hw_european_mc_impl`` /
    ``_g2_european_mc_impl``)."""
    n = 4096
    js, ts = _specs(payer)
    const, wvec = jhw._hw_mc_weights(js, jhw.DEMO_CURVE, JPROJ)
    ids = torch.arange(n, dtype=torch.int64)
    if model == "hw":
        tag = 0x4877
        key = jnp.asarray(jrng.derive_key(3, 0, tag), jnp.uint32)
        p0, c, bmat, corr = jhw._hw_tables(js, jhw.DEMO_HW, jhw.DEMO_CURVE)
        xg, yg = jsw._simulate_rate_grid(
            js, jnp.float32(0.3), jnp.float32(0.0), jnp.float32(0.015),
            jnp.float32(0.0), n, 1, key)
        v = jhw._hw_mtm_multicurve(js, 0, xg[0], p0, bmat, corr, const,
                                   wvec)
        want = (jnp.maximum(v, 0.0) * jnp.float32(p0[0])
                * jnp.exp(-yg[0] - jnp.float32(c[0])))
        pv = thw.pack_multicurve(convert.hw_swpt_params(_jhw_pack(js), 10),
                                 const, wvec)
        got = thw.hw_mc_swpt_pay(10, pv, ids, *(int(k) for k in key))
    else:
        tag = 0x6270
        key = jnp.asarray(jrng.derive_key(3, 0, tag), jnp.uint32)
        p0, vhalf, amat, bamat, bbmat = jg2._g2_tables(js, jg2.DEMO_G2,
                                                       jhw.DEMO_CURVE)
        (x, y, z), = jg2._simulate_g2_grid(js, jg2.DEMO_G2, n, 1, key)
        v = jg2._g2_mtm_multicurve(js, 0, x, y, p0, amat, bamat, bbmat,
                                   const, wvec)
        want = (jnp.maximum(v, 0.0) * jnp.float32(p0[0])
                * jnp.exp(-z - jnp.float32(vhalf[0])))
        pv = thw.pack_multicurve(convert.g2_swpt_params(_jg2_pack(js), 10),
                                 const, wvec)
        got = tg2.g2_mc_swpt_pay(10, pv, ids, *(int(k) for k in key))
    _per_path_check(got.numpy(), want)


# --- the partials ---------------------------------------------------------------


def test_block_rows_add_in_the_kernels_order(monkeypatch):
    """block_rows against the kernel's order written out: each thread's
    grid-stride share in sequence, then the block's halving tree; three
    blocks (MAX_BLOCKS patched) so the stride wraps three times."""
    monkeypatch.setattr(_cuda, "MAX_BLOCKS", 3)
    t = fused.RATES_THREADS
    n = 3 * t * 2 + 123
    x = np.random.default_rng(3).lognormal(-3.0, 2.0, n).astype(np.float32)
    x[::7] = 0.0
    rows = fused.block_rows(torch.from_numpy(x)).numpy()
    assert rows.shape == (3, 2)
    for b in range(3):
        acc = np.zeros((2, t))
        for th in range(t):
            for i in range(b * t + th, n, 3 * t):
                acc[0, th] += float(x[i])
                acc[1, th] += float(np.float32(x[i] * x[i]))
        s = t // 2
        while s:
            acc[:, :s] = acc[:, :s] + acc[:, s:2 * s]
            s //= 2
        assert rows[b].tolist() == acc[:, 0].tolist()


@pytest.mark.parametrize("tile", ["va", "hw", "g2"])
def test_partials_offset_and_bound_match_mc_tpus(tile):
    """path_offset and n_valid against mc_tpu's fused_moment_partials
    (engine="xla") on the same pack: ids offset + i, masked at the bound."""
    js, _ = _specs(n=4)
    jtile, pack, conv = {
        "va": (jsw._va_swpt_tile, _jva_pack, convert.va_swpt_params),
        "hw": (jhw._hw_swpt_tile, _jhw_pack, convert.hw_swpt_params),
        "g2": (jg2._g2_swpt_tile, _jg2_pack, convert.g2_swpt_params)}[tile]
    pv = pack(js)
    key = jrng.derive_key(9, 0, 0x5A97)
    n, offset, n_valid = 20_000, 70_001, 70_001 + 19_000
    cfg = jpk.KernelConfig(n_paths=n, n_steps=1, tile_rows=8)
    s, sq = jpallas.fused_moment_partials(
        lambda *a: jtile(4, *a), cfg, key, jnp.asarray(pv),
        path_offset=offset, n_valid=n_valid, engine="xla")
    want = np.array([float(jfinish_sum(s)), float(jfinish_sum(sq))])
    got = finish_sum(fused.fused_moment_partials(
        tile, 4, key, conv(pv, 4), n, offset, n_valid)).numpy()
    assert got == pytest.approx(want, rel=PRICE_RTOL, abs=1e-9)
    full = finish_sum(fused.fused_moment_partials(tile, 4, key,
                                                  conv(pv, 4), n, offset))
    assert float(full[0]) > got[0]


def test_partials_guards():
    pv = convert.g2_swpt_params(_jg2_pack(JSPEC), 10)
    with pytest.raises(KeyError, match="unknown rates tile"):
        fused.fused_moment_partials("sabr", 10, (1, 2), pv, 100)
    with pytest.raises(ValueError, match=r"\(54,\)"):
        fused.fused_moment_partials("g2", 11, (1, 2), pv, 100)
    with pytest.raises(ValueError, match="n_pay"):
        fused.fused_moment_partials("g2", 0, (1, 2), pv, 100)
    with pytest.raises(ValueError, match="n_paths"):
        fused.fused_moment_partials("g2", 10, (1, 2), pv, 0)
    with pytest.raises(ValueError, match="float32"):
        fused.fused_moment_partials("g2", 10, (1, 2), pv.double(), 100)


# --- prices -------------------------------------------------------------------


def _f32_finish_rtol(res):
    """mc_tpu forms var = E[p^2] - E[p]^2 from f32 moments (8 units of
    roundoff each): the stderr's tolerance is half var's relative error."""
    mean, var = float(res.payoff_mean), float(res.payoff_var)
    return SE_RTOL + 0.5 * 8 * EPS32 * (var + 2 * mean * mean) / var


def _assert_close(got, want):
    assert float(got.price) == pytest.approx(float(want.price),
                                             rel=PRICE_RTOL, abs=1e-9)
    assert float(got.stderr) == pytest.approx(
        float(want.stderr), rel=_f32_finish_rtol(got), abs=1e-12)


def _price_pair(model, n, payer, engine, multicurve=False):
    js, ts = _specs(payer)
    jsim = mc_tpu.SimParams(n_paths=n, n_steps=1, seed=77)
    sim = convert.sim_params(jsim)
    jproj = JPROJ if multicurve else None
    proj = PROJ if multicurve else None
    if model == "va":
        want = jsw.price_swaption(js, JVasicek(), jsim, r0=0.05,
                                  engine=engine)
        got = tsw.price_swaption(ts, mt.DEMO_VASICEK, sim, r0=0.05,
                                 device="cpu")
    elif model == "hw":
        want = jhw.price_hw_swaption(js, jhw.DEMO_HW, jhw.DEMO_CURVE, jsim,
                                     projection_curve=jproj, engine=engine)
        got = thw.price_hw_swaption(ts, thw.DEMO_HW, CURVE, sim,
                                    projection_curve=proj, device="cpu")
    else:
        want = jg2.price_g2_swaption(js, jg2.DEMO_G2, jhw.DEMO_CURVE, jsim,
                                     projection_curve=jproj, engine=engine)
        got = tg2.price_g2_swaption(ts, tg2.DEMO_G2, CURVE, sim,
                                    projection_curve=proj, device="cpu")
    return got, want


@pytest.mark.parametrize("engine", ["xla", None], ids=["xla", "classic"])
@pytest.mark.parametrize("payer", [True, False], ids=["payer", "receiver"])
@pytest.mark.parametrize("n", [1 << 16, 100_001])
@pytest.mark.parametrize("model", ["va", "hw", "g2"])
def test_price_matches_mc_tpus_routes(model, n, payer, engine):
    got, want = _price_pair(model, n, payer, engine)
    assert int(float(got.n_paths)) == n
    _assert_close(got, want)


@pytest.mark.parametrize("payer", [True, False], ids=["payer", "receiver"])
@pytest.mark.parametrize("n", [1 << 16, 100_001])
@pytest.mark.parametrize("model", ["hw", "g2"])
def test_multicurve_price_matches_mc_tpus_classic(model, n, payer):
    got, want = _price_pair(model, n, payer, None, multicurve=True)
    _assert_close(got, want)


def test_default_keys_are_mc_tpus_streams():
    """Each pricer draws rng.derive_key(seed, stream, tag) with mc_tpu's
    tag; ``seed`` overrides sim.seed."""
    sim = mt.SimParams(n_paths=2048, n_steps=1, seed=21)
    for price in (tsw.price_swaption, thw.price_hw_swaption,
                  tg2.price_g2_swaption):
        a = price(sim=sim, device="cpu")
        b = price(sim=mt.SimParams(n_paths=2048, n_steps=1), seed=21,
                  device="cpu")
        c = price(sim=sim, stream=1, device="cpu")
        assert float(a.price) == float(b.price) != float(c.price)


# --- the oracles ----------------------------------------------------------------


@pytest.mark.parametrize("payer", [True, False])
@pytest.mark.parametrize("case", [(1.0, 0.5, 10, 0.05), (2.0, 0.25, 8, 0.06),
                                  (0.5, 1.0, 3, 0.03)])
def test_oracles_match_mc_tpus(case, payer):
    t0, tau, n, k = case
    df, pdf = jhw.DEMO_CURVE.df, JPROJ.df
    g = jg2.DEMO_G2
    pairs = (
        (oracle.vasicek_swaption(0.05, 0.3, 0.05, 0.015, t0, tau, n, k, payer),
         joracle.vasicek_swaption(0.05, 0.3, 0.05, 0.015, t0, tau, n, k,
                                  payer)),
        (oracle.vasicek_zbp(0.04, 0.3, 0.05, 0.015, t0, t0 + tau, 0.97),
         joracle.vasicek_zbp(0.04, 0.3, 0.05, 0.015, t0, t0 + tau, 0.97)),
        (oracle.hw_zbp(0.3, 0.015, df(t0), df(t0 + tau), t0, t0 + tau, 0.98),
         joracle.hw_zbp(0.3, 0.015, df(t0), df(t0 + tau), t0, t0 + tau,
                        0.98)),
        (oracle.hw_swaption(0.3, 0.015, df, t0, tau, n, k, payer),
         joracle.hw_swaption(0.3, 0.015, df, t0, tau, n, k, payer)),
        (oracle.g2_swaption(g.a, g.sigma, g.b_mr, g.eta, g.rho, df, t0, tau,
                            n, k, payer),
         joracle.g2_swaption(g.a, g.sigma, g.b_mr, g.eta, g.rho, df, t0, tau,
                             n, k, payer)),
        (oracle.hw_swaption_multicurve(0.3, 0.015, df, pdf, t0, tau, n, k,
                                       payer),
         joracle.hw_swaption_multicurve(0.3, 0.015, df, pdf, t0, tau, n, k,
                                        payer)),
        (oracle.g2_swaption_multicurve(g.a, g.sigma, g.b_mr, g.eta, g.rho,
                                       df, pdf, t0, tau, n, k, payer,
                                       n_quad=201),
         joracle.g2_swaption_multicurve(g.a, g.sigma, g.b_mr, g.eta, g.rho,
                                        df, pdf, t0, tau, n, k, payer,
                                        n_quad=201)))
    for got, want in pairs:
        assert got == pytest.approx(want, rel=1e-12, abs=1e-300)


# --- guards -------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(engine="xla"), dict(tile_rows=128),
                                dict(interpret=True)])
def test_tpu_only_arguments_raise_type_error(kw):
    sim = mt.SimParams(n_paths=64, n_steps=1)
    for price in (tsw.price_swaption, thw.price_hw_swaption,
                  tg2.price_g2_swaption):
        with pytest.raises(TypeError):
            price(sim=sim, device="cpu", **kw)


def _same_error(port_call, jax_call, exc=ValueError):
    with pytest.raises(exc) as want:
        jax_call()
    with pytest.raises(exc) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_validation_raises_mc_tpus_messages():
    sim, jsim = mt.SimParams(n_paths=64, n_steps=1), mc_tpu.SimParams(
        n_paths=64, n_steps=1)
    for kw in (dict(n_payments=0), dict(tenor=-1.0), dict(expiry=0.0)):
        _same_error(lambda: tsw.price_swaption(tsw.SwaptionSpec(**kw),
                                               sim=sim, device="cpu"),
                    lambda: jsw.price_swaption(jsw.SwaptionSpec(**kw),
                                               sim=jsim))
    for kw in (dict(a=0.0), dict(sigma_r=-0.1)):
        _same_error(lambda: thw.price_hw_swaption(
            dyn=thw.HullWhiteDynamics(**kw), sim=sim, device="cpu"),
            lambda: jhw.price_hw_swaption(dyn=jhw.HullWhiteDynamics(**kw),
                                          sim=jsim))
    for kw in (dict(a=-0.1), dict(b_mr=0.0), dict(eta=-0.1),
               dict(rho=-1.5)):
        _same_error(lambda: tg2.price_g2_swaption(
            dyn=tg2.G2Dynamics(**kw), sim=sim, device="cpu"),
            lambda: jg2.price_g2_swaption(dyn=jg2.G2Dynamics(**kw),
                                          sim=jsim))
    for args in (([1.0, 1.0], [0.02, 0.02]), ([0.0, 1.0], [0.02, 0.02]),
                 ([1.0, 2.0], [0.02]), ([], [])):
        _same_error(lambda: thw.DiscountCurve(*args),
                    lambda: jhw.DiscountCurve(*args))
    for args in (([0.7], [0.03]), ([1.0, 1.0], [0.03, 0.03]),
                 ([1.0, 2.0], [0.03]), ([0.5, 1.0], [0.03, 5.0])):
        _same_error(lambda: thw.DiscountCurve.from_par_swaps(*args),
                    lambda: jhw.DiscountCurve.from_par_swaps(*args))


def test_curve_is_mc_tpus_curve():
    """df at knots, between them, beyond both ends; the bootstrap's knots
    and zeros bit for bit."""
    for t in (0.0, 0.1, 0.5, 0.75, 1.0, 2.5, 10.0, 30.0):
        assert CURVE.df(t) == jhw.DEMO_CURVE.df(t)
    mats, pars = [0.5, 1.0, 2.0, 3.0, 5.0], [0.03, 0.034, 0.039, 0.042, 0.045]
    got = thw.DiscountCurve.from_par_swaps(mats, pars)
    want = jhw.DiscountCurve.from_par_swaps(mats, pars)
    assert np.array_equal(got.times, want.times)
    assert np.array_equal(got.zeros, want.zeros)
    assert thw.DiscountCurve.flat(0.05).df(20.0) == jhw.DiscountCurve.flat(
        0.05).df(20.0)


def test_tables_are_mc_tpus():
    js, ts = _specs(n=12)
    for got, want in zip(thw.hw_tables(ts, thw.DEMO_HW, CURVE),
                         jhw._hw_tables(js, jhw.DEMO_HW, jhw.DEMO_CURVE)):
        assert np.array_equal(got, want)
    for got, want in zip(tg2.g2_tables(ts, tg2.DEMO_G2, CURVE),
                         jg2._g2_tables(js, jg2.DEMO_G2, jhw.DEMO_CURVE)):
        assert np.array_equal(got, want)
    for dt in (0.25, 1.0, 3.0):
        got, want = tg2.step_chol(tg2.DEMO_G2, dt), jg2._step_chol(
            jg2.DEMO_G2, dt)
        assert got[:4] == want[:4] and np.array_equal(got[4], want[4])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    sim = mt.SimParams(n_paths=64, n_steps=1)
    for call in (lambda: mt.price_swaption(sim=sim),
                 lambda: mt.price_hw_swaption(sim=sim),
                 lambda: mt.price_g2_swaption(sim=sim, projection_curve=PROJ)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
