"""cva_greeks on the CPU: the cases of tests/test_xva.py:113-240 (forward
mode against CRN central differences of the same pipeline, the signs, the
which resolution), and every greek against mc_tpu's forward-mode JVP on the
same keys, for GBM and each family of NMC_FAMILY_BUILDERS.

On the CPU the CVA's value is the fused NMC's plain version (the kernel's
stand-in here) and the tangent that plain version's JVP; mc_tpu takes its
JVP through its XLA dual.

Tolerances:
* against CRN central differences: tests/test_xva.py's (delta 1e-3
  relative, vega 2e-3; under Heston delta 2e-3 and v0 1e-2);
* against mc_tpu: 1e-5 relative (two frameworks' f32 tangents over the
  parity contract's few-ulp normals; ~1e-7 seen), but 1e-4 for xi under
  Heston and Bates: its tangent runs through sqrt(max(v, 0)), and a path
  whose variance the few-ulp gap moves across the truncation takes the
  other branch's tangent (1.8e-5 and 6.1e-5 seen).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import mc_tpu

import mc_tpu_torch as mt
from mc_tpu_torch.nmc_heston import price_nmc_heston

torch.set_num_threads(1)

jg = importlib.import_module("mc_tpu.greeks")
tg = importlib.import_module("mc_tpu_torch.greeks")

CPU = dict(device="cpu")
SIM = mt.SimParams(n_paths=2048, n_steps=8, n_paths_inner=32)


def _jsim(sim):
    return mc_tpu.SimParams(n_paths=sim.n_paths, n_steps=sim.n_steps,
                            n_paths_inner=sim.n_paths_inner)


def test_cva_greeks_match_crn_fd():
    g = tg.cva_greeks(mt.OptionParams(), SIM, "vanilla_call",
                      hazard_rate=0.02, **CPU)

    def cva_at(**kw):
        o = dataclasses.replace(mt.OptionParams(), **kw)
        return float(mt.price_nmc(o, SIM, "vanilla_call", **CPU).cva(
            0.02, t_horizon=1.0))

    h = 0.05
    fd_delta = (cva_at(s0=100 + h) - cva_at(s0=100 - h)) / (2 * h)
    hs = 1e-3
    fd_vega = (cva_at(sigma=0.2 + hs) - cva_at(sigma=0.2 - hs)) / (2 * hs)
    assert float(g["delta"]) == pytest.approx(fd_delta, rel=1e-3)
    assert float(g["vega"]) == pytest.approx(fd_vega, rel=2e-3)
    assert float(g["delta"]) > 0.0 and float(g["vega"]) > 0.0
    with pytest.raises(ValueError, match="unknown greeks"):
        tg.cva_greeks(which=("charm",), hazard_rate=0.02, **CPU)


def test_family_cva_greeks_heston_crn_fd():
    sim = mt.SimParams(n_paths=512, n_steps=8, n_paths_inner=16)
    g = tg.cva_greeks(mt.OptionParams(), sim, "vanilla_call",
                      hazard_rate=0.02, model="heston",
                      which=("delta", "v0"), **CPU)

    def cva_at(opt_kw=None, dyn_kw=None):
        o = dataclasses.replace(mt.OptionParams(), **(opt_kw or {}))
        d = dataclasses.replace(mt.DEMO_HESTON, **(dyn_kw or {}))
        return float(price_nmc_heston(o, d, sim, "vanilla_call",
                                      **CPU).cva(0.02, t_horizon=1.0))

    h = 0.05
    fd_delta = (cva_at({"s0": 100 + h}) - cva_at({"s0": 100 - h})) / (2 * h)
    hv = 5e-4
    fd_v0 = (cva_at(dyn_kw={"v0": 0.04 + hv})
             - cva_at(dyn_kw={"v0": 0.04 - hv})) / (2 * hv)
    assert float(g["delta"]) == pytest.approx(fd_delta, rel=2e-3)
    assert float(g["v0"]) == pytest.approx(fd_v0, rel=1e-2)
    assert float(g["delta"]) > 0.0 and float(g["v0"]) > 0.0


def test_heston_v0_difference_converges_to_the_tangent_at_16_steps():
    """At 16 steps x 64 inner paths v0's CVA response curves (paths cross
    the variance truncation as v0 moves), so the h = 5e-4 central
    difference of tests/test_xva.py sits well off the tangent there, in
    mc_tpu as in the port: the port's tangent is mc_tpu's (1e-4 relative,
    the xi-like truncation tolerance above), and mc_tpu's own CRN
    differences close on it as h shrinks (12.7%, 2.4%, 0.74%, 0.23% at h =
    5e-4, 1e-4, 2e-5, 1e-5 at 512 outer paths), to within test_xva.py's
    1e-2 at h = 1e-5.  The bumps' denominators are the f32-rounded
    v0 +/- h, as the pack reads them."""
    sim = mt.SimParams(n_paths=512, n_steps=16, n_paths_inner=64)
    jsim = _jsim(sim)
    mine = float(tg.cva_greeks(mt.OptionParams(), sim, "vanilla_call",
                               hazard_rate=0.02, model="heston",
                               which=("v0",), **CPU)["v0"])
    ref = float(jg.cva_greeks(mc_tpu.OptionParams(), jsim, "vanilla_call",
                              hazard_rate=0.02, model="heston",
                              which=("v0",))["v0"])
    assert mine == pytest.approx(ref, rel=1e-4)

    from mc_tpu.models.heston import DEMO_HESTON as JH
    from mc_tpu.nmc_heston import price_nmc_heston as j_price

    def fd(hv):
        def cva(v0):
            d = dataclasses.replace(JH.as_f32(), v0=v0)
            return float(j_price(mc_tpu.OptionParams().as_f32(), d, jsim,
                                 "vanilla_call", engine="xla").cva(
                                     0.02, t_horizon=1.0))
        up, dn = float(np.float32(0.04 + hv)), float(np.float32(0.04 - hv))
        return (cva(up) - cva(dn)) / (up - dn)

    gaps = [abs(fd(hv) / ref - 1.0) for hv in (5e-4, 1e-4, 2e-5, 1e-5)]
    assert gaps[0] > 1e-2 and gaps[1] < gaps[0] / 2 and gaps[3] < 1e-2, gaps


def test_family_cva_greeks_merton_jump_risk():
    sim = mt.SimParams(n_paths=512, n_steps=8, n_paths_inner=16)
    g = tg.cva_greeks(mt.OptionParams(), sim, "vanilla_call",
                      hazard_rate=0.02, model="merton",
                      which=("delta", "lam"), **CPU)
    assert float(g["lam"]) > 0.0 and float(g["delta"]) > 0.0


def test_family_cva_greeks_dyn_prefix_and_validation():
    sim = mt.SimParams(n_paths=256, n_steps=8, n_paths_inner=8)
    g = tg.cva_greeks(mt.OptionParams(), sim, "vanilla_call",
                      hazard_rate=0.02, model="heston",
                      which=("rho", "dyn.rho"), **CPU)
    assert float(g["rho"]) != float(g["dyn.rho"])
    with pytest.raises(ValueError, match="dynamics field"):
        tg.cva_greeks(mt.OptionParams(), sim, hazard_rate=0.02,
                      model="heston", which=("vega",), **CPU)
    with pytest.raises(ValueError, match="unknown greek"):
        tg.cva_greeks(mt.OptionParams(), sim, hazard_rate=0.02,
                      model="heston", which=("zzz",), **CPU)
    with pytest.raises(ValueError, match="vector fields"):
        tg.cva_greeks(mt.OptionParams(), sim, hazard_rate=0.02,
                      model="basket", which=("sigmas",), **CPU)
    with pytest.raises(ValueError, match="no nested-MC adapter"):
        tg.cva_greeks(mt.OptionParams(), sim, hazard_rate=0.02,
                      model="fx", which=("delta",), **CPU)


CASES = [
    (None, ("delta", "vega", "rho", "dual_delta")),
    ("heston", ("delta", "v0", "xi", "dyn.rho", "rho")),
    ("merton", ("delta", "lam", "sigma_j")),
    ("bates", ("delta", "xi", "lam")),
    ("cev", ("delta", "beta", "sigma_lv")),
    ("localvol", ("delta", "rho")),
    ("sabr", ("delta", "alpha", "nu")),
    ("term", ("delta", "dual_delta")),
    ("vasicek", ("delta", "sigma_r", "b", "rho")),
    ("basket", ("rho", "dual_delta")),
    ("rainbow", ("rho",)),
]


@pytest.mark.parametrize("model,which", CASES,
                         ids=[c[0] or "gbm" for c in CASES])
def test_cva_greeks_match_mc_tpu(model, which):
    sim = mt.SimParams(n_paths=256, n_steps=8, n_paths_inner=8)
    mine = tg.cva_greeks(sim=sim, hazard_rate=0.02, which=which,
                         model=model, **CPU)
    ref = jg.cva_greeks(sim=_jsim(sim), hazard_rate=0.02, which=which,
                        model=model)
    for g in which:
        rel = 1e-4 if g == "xi" else 1e-5
        assert float(mine[g]) == pytest.approx(float(ref[g]), rel=rel,
                                               abs=1e-9), g


def test_cva_value_is_the_kernel_surface():
    """The tangent rides the fused NMC's surface: with forward AD off, the
    CVA cva_greeks differentiates is price_nmc(strategy='fused')'s."""
    import torch.autograd.forward_ad as fwAD

    from mc_tpu_torch.ops import twin
    sim = mt.SimParams(n_paths=128, n_steps=4, n_paths_inner=4)
    res = mt.price_nmc(sim=sim, payoff="vanilla_call", **CPU)
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.tensor(100.0), torch.tensor(1.0))
        plain = mt.price_nmc(dataclasses.replace(mt.DEMO_OPTION, s0=dual),
                             sim, "vanilla_call", **CPU).surface
        s = twin.with_derivative_of(res.surface, plain)
        p, t = fwAD.unpack_dual(s)
        assert torch.equal(p, res.surface) and t is not None
