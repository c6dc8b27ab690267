"""mc_tpu_torch's model QMC on the CPU: the cases of tests/test_qmc.py's
model half against their oracles, every guard with mc_tpu's message, the
families' MC paths bitwise unchanged by the split of their draws from their
step loops, the ``qmc --model`` command against mc_tpu's, and the entry
point's default device.

The statistical cases run at tests/test_qmc.py's sizes (2^14 points x 16
steps x 8 shifts) through the plain version; the MC references draw the
same total budget through the families' plain versions.
"""

import json

import pytest
import torch

import mc_tpu
from mc_tpu import qmc as jq

import mc_tpu_torch as mt
from mc_tpu_torch import cli, qmc, rng
from mc_tpu_torch.models import (basket, bates, cev, heston, localvol,
                                 merton, sabr, term, vasicek)
from mc_tpu_torch.models.merton import counters, steps_index
from mc_tpu_torch.oracle import vasicek_zcb
from mc_tpu_torch.ops.payoffs import get_payoff
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

SIM = mt.SimParams(n_paths=1 << 14, n_steps=16)
BIG = mt.SimParams(n_paths=8 * (1 << 14), n_steps=16)


def _q(model, dyn=None, payoff="vanilla_call", sim=SIM):
    return qmc.price_qmc_model(model, dyn=dyn, sim=sim, payoff=payoff,
                               n_shifts=8, device="cpu")


def _joint(a, b):
    return (float(a.stderr) ** 2 + float(b.stderr) ** 2) ** 0.5


# --- the cases of tests/test_qmc.py:246-465 -----------------------------------


def test_qmc_heston_matches_cf():
    q = _q("heston")
    cf = heston.heston_call_cf(100.0, 100.0, 1.0, 0.1,
                               *heston.DEMO_HESTON.astuple())
    assert abs(float(q.price) - cf) <= 3.5 * float(q.stderr)
    mc = heston.price_heston(sim=BIG, device="cpu")
    assert float(q.stderr) < 0.55 * float(mc.stderr)


def test_qmc_basket_matches_mc():
    q = _q("basket")
    mc = basket.price_basket(sim=BIG, device="cpu")
    assert abs(float(q.price) - float(mc.price)) <= 3.5 * _joint(q, mc)
    assert float(q.stderr) < 0.4 * float(mc.stderr)


def test_qmc_model_path_dependent_payoff():
    r = qmc.price_qmc_model("heston", sim=mt.SimParams(n_paths=1 << 13,
                                                       n_steps=16),
                            payoff="asian_call", n_shifts=8, device="cpu")
    assert 0.0 < float(r.price) < 15.0 and float(r.stderr) > 0.0


@pytest.mark.parametrize("model", ["cev", "sabr", "localvol"])
def test_qmc_cev_sabr_localvol_match_mc(model):
    q = _q(model)
    mc = {"cev": lambda: cev.price_cev(sim=BIG, device="cpu"),
          "sabr": lambda: sabr.price_sabr(sim=BIG, device="cpu"),
          "localvol": lambda: localvol.price_localvol(
              surf=localvol.LocalVolSurface.demo(16), sim=BIG,
              device="cpu")}[model]()
    assert abs(float(q.price) - float(mc.price)) <= 3.5 * _joint(q, mc)
    assert float(q.stderr) < 0.6 * float(mc.stderr)


def test_qmc_vasicek_zcb_exact():
    """The bond pays 1 discounted pathwise inside the leg: P(0,T) within
    the stderr (no double discount)."""
    q = qmc.price_qmc_model("vasicek", sim=mt.SimParams(n_paths=1 << 13,
                                                        n_steps=16),
                            payoff="zcb", n_shifts=8, device="cpu")
    d = vasicek.DEMO_VASICEK
    want = vasicek_zcb(0.1, d.a, d.b, d.sigma_r, 1.0)
    assert abs(float(q.price) - want) <= 3.5 * float(q.stderr) + 1e-4


def test_qmc_vasicek_matches_mc():
    q = _q("vasicek")
    mc = vasicek.price_vasicek(sim=BIG, device="cpu")
    assert abs(float(q.price) - float(mc.price)) <= 3.5 * _joint(q, mc)
    assert float(q.stderr) < 0.7 * float(mc.stderr)


def test_qmc_bates_matches_cf_oracle():
    d = bates.DEMO_BATES
    q = _q("bates")
    ref = bates.bates_call_cf(100.0, 100.0, 1.0, 0.1, d.v0, d.kappa, d.theta,
                              d.xi, d.rho, d.lam, d.mu_j, d.sigma_j)
    assert abs(float(q.price) - ref) <= 4.0 * float(q.stderr) + 0.02 * ref
    mc = bates.price_bates(sim=mt.SimParams(n_paths=1 << 17, n_steps=16),
                           device="cpu")
    at_budget = float(mc.stderr) * ((1 << 17) / (SIM.n_paths * 8)) ** 0.5
    assert float(q.stderr) < at_budget


def test_qmc_merton_matches_series_oracle():
    d = merton.DEMO_MERTON
    q = _q("merton")
    want = merton.merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2, d.lam,
                                          d.mu_j, d.sigma_j)
    assert abs(float(q.price) - want) <= 3.5 * float(q.stderr) + 2e-3


def test_qmc_term_matches_mc():
    curves = term.TermStructure.from_knots([0.10, 0.05], [0.15, 0.30], 16)
    q = _q("term", curves)
    mc = term.price_term(term=curves, sim=BIG, device="cpu")
    assert abs(float(q.price) - float(mc.price)) <= 3.5 * _joint(q, mc)
    assert float(q.stderr) < 0.7 * float(mc.stderr)


# --- guards, each with mc_tpu's message ------------------------------------


@pytest.mark.parametrize("model,kw,match", [
    ("rainbow2", {}, "heston"),
    ("heston", dict(n_shifts=1), "n_shifts"),
    ("heston", dict(family="halton"), "family"),
    ("heston", dict(option=dict(p1=999.0), payoff="forward_start_call"),
     "determination step"),
    ("cev", dict(steps=7), "CEV requires an even n_steps"),
    ("localvol", dict(steps=7), "localvol requires an even n_steps"),
    ("vasicek", dict(steps=7), "vasicek requires an even n_steps"),
    ("merton", dict(steps=7), "merton requires an even n_steps"),
    ("term", dict(steps=7, dyn="term"), "term requires an even n_steps"),
    ("term", dict(dyn="term4"), "one knot per step"),
    ("localvol", dict(dyn="surface4"), "surface has 4 steps")])
def test_guards_raise_where_mc_tpu_raises(model, kw, match):
    steps = kw.pop("steps", 8)
    opt = kw.pop("option", {})
    dyn_kind = kw.pop("dyn", None)
    dyns = {"term": lambda pkg: pkg.models.term.TermStructure.from_knots(
                [0.1], [0.2], steps),
            "term4": lambda pkg: pkg.models.term.TermStructure.from_knots(
                [0.1], [0.2], 4),
            "surface4": lambda pkg: pkg.models.localvol.LocalVolSurface.demo(
                4)}
    import mc_tpu.models.localvol  # noqa: F401  (the submodules by name)
    import mc_tpu.models.term  # noqa: F401
    for pkg, fn, extra in ((mt, qmc.price_qmc_model, dict(device="cpu")),
                           (mc_tpu, jq.price_qmc_model,
                            dict(engine="xla"))):
        dyn = dyns[dyn_kind](pkg) if dyn_kind else None
        with pytest.raises(ValueError, match=match):
            fn(model, pkg.OptionParams(**opt), dyn,
               pkg.SimParams(n_paths=1 << 10, n_steps=steps),
               **dict(kw, **extra))


@pytest.mark.parametrize("model", ["heston", "bates", "cev", "sabr"])
@pytest.mark.parametrize("payoff", ["up_out_call_bb", "down_out_call_bb"])
def test_bridge_barriers_refused_without_sigma(model, payoff):
    """The packs without sigma: the port raises ValueError where mc_tpu
    fails with an AttributeError (ROADMAP C10)."""
    sim = mt.SimParams(n_paths=256, n_steps=4)
    with pytest.raises(ValueError, match="sigma"):
        qmc.price_qmc_model(model, sim=sim, payoff=payoff, n_shifts=2,
                            device="cpu")
    with pytest.raises(AttributeError, match="sigma"):
        jq.price_qmc_model(model, sim=mc_tpu.SimParams(n_paths=256,
                                                       n_steps=4),
                           payoff=payoff, n_shifts=2, engine="xla")


def test_tpu_only_arguments_raise_type_error():
    for kw in (dict(engine="pallas"), dict(tile_rows=8),
               dict(interpret=True)):
        with pytest.raises(TypeError):
            qmc.price_qmc_model("heston", device="cpu", **kw)


def test_sums_check_their_inputs():
    po = get_payoff("vanilla_call")
    _, dyn, _, ps = qmc.qmc_model_pointset(
        "heston", mt.DEMO_OPTION, None, mt.SimParams(n_paths=256, n_steps=4),
        n_shifts=2, device="cpu")
    prm = heston.pack_heston(mt.DEMO_OPTION, dyn, 4, "cpu")
    with pytest.raises(ValueError, match="dimensions"):
        qmc.qmc_model_sums("heston", po, ps, prm, 5)
    with pytest.raises(ValueError, match="QMC model"):
        qmc.qmc_model_sums("rainbow", po, ps, prm, 4)


# --- the MC paths bitwise after the split of their draws ---------------------


def _ids(n=512):
    return torch.arange(n, dtype=torch.int64)


K0, K1 = (int(k) for k in rng.derive_key(7, 0, 0x1234))


def _pairs(n, rounds=13):
    ids = _ids()
    z0, z1 = rng.normal_pair(K0, K1, ids, counters(ids, steps_index(n, ids)),
                             rounds=rounds)
    return ids, z0, z1


def _sums(partials):
    return finish_sum(partials)


def test_cev_mc_path_bitwise():
    """Substeps 2m, 2m+1 on pair m: the loop written out against the plain
    version, bit for bit."""
    po = get_payoff("asian_call")
    p_t = cev.pack_cev(mt.DEMO_OPTION, cev.DEMO_CEV, 8, "cpu")
    p = cev.unpack_cev(p_t)
    ids, z0, z1 = _pairs(4)
    s = torch.zeros(512) + p.s0
    st = po.init(p, torch.zeros(512))
    for m in range(4):
        for z in (z0[m], z1[m]):
            s, st = cev.cev_substep(po, p, s, st, z)
    want = po.terminal(st, s, p).double()
    got = _sums(cev.cev_partials_plain(po, cev.CEVConfig(512, 8), (K0, K1),
                                       p_t))
    assert float(got[0]) == float(want.sum())


@pytest.mark.parametrize("model", ["sabr", "localvol", "term"])
def test_pair_step_mc_paths_bitwise(model):
    po = get_payoff("lookback_call")
    n = 8
    if model == "sabr":
        p_t = sabr.pack_sabr(mt.DEMO_OPTION, sabr.DEMO_SABR, n, "cpu")
        p = sabr.unpack_sabr(p_t)
        ids, zv, zp = _pairs(n)
        lf, sig = torch.log(torch.zeros(512) + p.f0), torch.zeros(512) + p.alpha
        st = po.init(p, torch.zeros(512))
        for j in range(n):
            lf, sig = sabr.sabr_step(p, lf, sig, zv[j], zp[j])
            st = po.update(st, torch.exp(lf), p)
        want = po.terminal(st, torch.exp(lf), p)
        got = sabr.sabr_partials_plain(po, sabr.SABRConfig(512, n), (K0, K1),
                                       p_t)
    else:
        if model == "localvol":
            surf = localvol.LocalVolSurface.demo(n)
            p_t = localvol.pack_localvol(mt.DEMO_OPTION, surf, n, "cpu")
            p = localvol.unpack_localvol(p_t, surf.n_knots)
            step, cfg = localvol.localvol_step, localvol.LocalVolConfig(
                512, n, surf.n_knots)
            plain = localvol.localvol_partials_plain
        else:
            p_t = term.pack_term(mt.DEMO_OPTION, term.demo_term(n), n, "cpu")
            p = term.unpack_term(p_t)
            step, cfg = term.term_step, term.TermConfig(512, n)
            plain = term.term_partials_plain
        ids, z0, z1 = _pairs(n // 2)
        w, s = torch.zeros(512), torch.zeros(512) + p.s0
        st = po.init(p, torch.zeros(512))
        for j in range(n):
            w, s, st = step(po, p, w, st, (z0, z1)[j % 2][j // 2], j)
        want = po.terminal(st, s, p)
        got = plain(po, cfg, (K0, K1), p_t)
    assert float(_sums(got)[0]) == float(want.double().sum())


def test_vasicek_mc_path_bitwise():
    po = get_payoff("vanilla_call")
    n = 8
    p_t = vasicek.pack_vasicek(mt.DEMO_OPTION, vasicek.DEMO_VASICEK, n, "cpu")
    p = vasicek.unpack_vasicek(p_t)
    ids = _ids()
    zero = torch.zeros(512)
    carry, s0 = (zero, zero + p.x0, zero), zero + p.s0
    st, s = po.init(p, zero), s0
    for m in range(n // 2):
        z = [rng.normal_pair(K0, K1, ids, torch.full_like(ids, 3 * m + c))
             for c in range(3)]
        for zs in ((z[0][0], z[0][1], z[1][0]), (z[1][1], z[2][0], z[2][1])):
            carry, s = vasicek.vasicek_step(p, carry, *zs, s0)
            st = po.update(st, s, p)
    want = po.terminal(st, s, p) * torch.exp(-carry[2])
    got = vasicek.vasicek_partials_plain(po, vasicek.VasicekConfig(512, n),
                                         (K0, K1), p_t)
    assert float(_sums(got)[0]) == float(want.double().sum())


def test_merton_and_bates_mc_paths_bitwise():
    po = get_payoff("asian_call")
    n = 8
    kmax = merton.poisson_kmax(0.3 / n)
    m_t = merton.pack_merton(mt.DEMO_OPTION, merton.DEMO_MERTON, n, "cpu")
    pm = merton.unpack_merton(m_t)
    ids = _ids()
    zero = torch.zeros(512)
    w, s, st = zero, zero + pm.s0, po.init(pm, zero)
    for m in range(n // 2):
        z0, z1, e0, e1, u0, u1 = merton.merton_draw3(K0, K1, ids, m)
        for z, e, u in ((z0, e0, u0), (z1, e1, u1)):
            w, s, st = merton.merton_step(po, pm, kmax, zero + pm.s0, w, st,
                                          z, e, u)
    want = po.terminal(st, s, pm)
    got = merton.merton_partials_plain(po, merton.MertonConfig(512, n, kmax),
                                       (K0, K1), m_t)
    assert float(_sums(got)[0]) == float(want.double().sum())
    b_t = bates.pack_bates(mt.DEMO_OPTION, bates.DEMO_BATES, n, "cpu")
    pb = bates.unpack_bates(b_t)
    w, v, s, st = zero, zero + pb.v0, zero + pb.s0, po.init(pb, zero)
    for j in range(n):
        z_v, z_p, e, u = bates.bates_euler_draw(K0, K1, ids, 3 * j)
        w, v, s, st = bates.bates_euler_step(po, pb, kmax, zero + pb.s0, w, v,
                                             st, z_v, z_p, e, u)
    want = po.terminal(st, s, pb)
    got = bates.bates_partials_plain(po, bates.BatesConfig(512, n, kmax),
                                     (K0, K1), b_t)
    assert float(_sums(got)[0]) == float(want.double().sum())


@pytest.mark.parametrize("d", [1, 3])
def test_basket_mc_path_bitwise(d):
    po = get_payoff("asian_call")
    n = 6
    dyn = mt.demo_basket(d, 0.5)
    p_t = basket.pack_basket(mt.DEMO_OPTION, dyn, n, "cpu")
    p = basket.unpack_basket(p_t, d)
    ids = _ids()
    zero = torch.zeros(512)
    ws, st = zero.expand(d, 512), po.init(p, zero)
    npps = (d + 1) // 2
    for u in range(n):
        ws = basket.mix_step(p, ws, basket.basket_normals(K0, K1, ids,
                                                          u * npps, d))
        b = basket.basket_of(p, basket.levels(p, ws))
        st = po.update(st, b, p)
    want = po.terminal(st, b, p)
    got = basket.basket_partials_plain(po, basket.BasketConfig(512, n, d),
                                       (K0, K1), p_t)
    assert float(_sums(got)[0]) == float(want.double().sum())


def test_heston_mc_path_bitwise():
    po = get_payoff("asian_call")
    n = 8
    p_t = heston.pack_heston(mt.DEMO_OPTION, heston.DEMO_HESTON, n, "cpu")
    p = heston.unpack_heston(p_t)
    ids = _ids()
    zero = torch.zeros(512)
    w, v, st = zero, zero + p.v0, po.init(p, zero)
    for j in range(n):
        z_v, z_p = rng.normal_pair(K0, K1, ids, torch.full_like(ids, j))
        w, v = heston.heston_euler_step(p, w, v, z_v, z_p, p.dt, p.sqrt_dt)
        s = (zero + p.s0) * torch.exp(w)
        st = po.update(st, s, p)
    want = po.terminal(st, s, p)
    got = heston.heston_partials_plain(po, heston.HestonConfig(512, n),
                                       (K0, K1), p_t)
    assert float(_sums(got)[0]) == float(want.double().sum())


# --- the command and the device ----------------------------------------------


def _mc_tpu_cli(argv, capsys):
    from mc_tpu import cli as jcli

    capsys.readouterr()
    assert jcli.main(argv + ["--platform", "cpu", "--engine", "xla"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("model", ["heston", "bates", "vasicek"])
def test_qmc_model_command_matches_mc_tpus(model, capsys):
    """``qmc --model``: mc_tpu's keys and fields (the CF price under Heston
    and Bates), on its default family, the lattice."""
    argv = ["qmc", "--model", model, "--n-paths", "1024", "--n-steps", "6",
            "--n-shifts", "4"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _mc_tpu_cli(argv, capsys)
    assert sorted(res) == sorted(want)
    assert res["point_n"] == want["point_n"] == qmc.prev_prime(1024)
    assert res["model"] == model and res["n_shifts"] == 4
    assert res["price"] == pytest.approx(want["price"], rel=1e-6)
    if "cf_oracle" in want:
        assert res["cf_oracle"] == pytest.approx(want["cf_oracle"],
                                                 rel=1e-12)


def test_price_qmc_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.price_qmc_model("heston", sim=mt.SimParams(n_paths=64,
                                                      n_steps=4))
    assert qmc.price_qmc_model.__kwdefaults__["device"] == "cuda"
    assert qmc.price_qmc_model.__kwdefaults__["family"] == "sobol"


def test_qmc_model_pointset_takes_no_default_device():
    """The point set's device is the caller's to name, as qmc_pointset's
    is: a default would build it where price_qmc_model does not run."""
    assert "device" not in (qmc.qmc_model_pointset.__kwdefaults__ or {})
    with pytest.raises(TypeError, match="device"):
        qmc.qmc_model_pointset("heston", mt.DEMO_OPTION, None,
                               mt.SimParams(n_paths=64, n_steps=4))


@pytest.mark.parametrize("model", sorted(qmc.QMC_MODELS))
def test_plain_sums_over_point_ids_add_up(model):
    """qmc_model_sums_plain over a set of point ids: all ids in order give
    the default sums bitwise, and the two halves add up to them."""
    sim = mt.SimParams(n_paths=256, n_steps=4)
    po, dyn, extra, ps = qmc.qmc_model_pointset(model, mt.DEMO_OPTION, None,
                                                sim, n_shifts=3, device="cpu")
    prm = qmc.QMC_MODELS[model].pack(mt.DEMO_OPTION, dyn, 4, "cpu")
    whole = qmc.qmc_model_sums_plain(model, po, ps, prm, 4, extra)
    ids = torch.arange(ps.n)
    halves = [qmc.qmc_model_sums_plain(model, po, ps, prm, 4, extra, i)
              for i in (ids[::2], ids[1::2])]
    assert torch.allclose(halves[0].sum(0) + halves[1].sum(0), whole.sum(0),
                          rtol=1e-15, atol=0)
    assert torch.equal(
        qmc.qmc_model_sums_plain(model, po, ps, prm, 4, extra, ids), whole)
