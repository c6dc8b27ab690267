"""mc_tpu_torch's randomized QMC under the model families against mc_tpu on
the CPU (kernel #33's plain version).

The port runs its plain version here (device="cpu"); mc_tpu runs its
engine="xla" dual, which its tests hold bitwise to its Pallas kernel
(tests/test_qmc.py:275).  Both build the same point sets (the CBC vector or
scipy's Sobol directions, the shifts from the same threefry-20 words), pack
the same parameters and step the same legs.

Tolerances:
* prices 1e-6 relative: the inverse CDF is a few ulp off mc_tpu's jitted
  one (ROADMAP C19) and mc_tpu sums each shift in f32 (Kahan) where the
  port sums in f64 (C6);
* stderrs 1e-6 relative plus 8 f32 roundings of the mean: the stderr is
  the spread of the R shift means, and each of mc_tpu's f32 shift means
  carries that rounding (C6);
* "within flips" where a path's payoff jumps: a barrier or digital whose
  level S crosses within an ulp, and on the lattice Merton's and Bates's
  Poisson counts, whose raw u can sit 2^-23 off mc_tpu's jitted one (C18);
  one flipped path moves a shift mean by at most its payoff jump over n.
"""

import jax
import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu import qmc as jq
from mc_tpu.models import basket as jbasket

import mc_tpu_torch as mt
from mc_tpu_torch import convert, qmc
from mc_tpu_torch.ops.reduce import finish_sum

torch.set_num_threads(1)

EPS32 = 2.0 ** -24
PRICE_RTOL = 1e-6
N_STEPS = 8
SHIFTS = 4
POINTS = {"sobol": 1024, "lattice": 1031}
# The largest payoff jump of one flipped path (a barrier knocking a call of
# S ~ 100-160 in or out, a Poisson count moving S by a jump of ~10-20%).
FLIP_JUMP = 60.0


def _both(model, payoff, family, *, n=None, n_steps=N_STEPS, option=None,
          dyn=(None, None)):
    jopt = mc_tpu.OptionParams(**(option or {}))
    jsim = mc_tpu.SimParams(n_paths=n or POINTS[family], n_steps=n_steps)
    want = jq.price_qmc_model(model, jopt, dyn[0], jsim, payoff,
                              n_shifts=SHIFTS, engine="xla", family=family)
    got = qmc.price_qmc_model(model, convert.option_params(jopt), dyn[1],
                              convert.sim_params(jsim), payoff,
                              n_shifts=SHIFTS, family=family, device="cpu")
    assert float(got.n_paths) == float(want.n_paths)
    return got, want


def _assert_close(got, want, flips: bool = False, n: int = 1):
    dp = abs(float(got.price) - float(want.price))
    tol = PRICE_RTOL * abs(float(want.price))
    if flips:  # one flipped path in each shift, at most
        tol += FLIP_JUMP / n
    assert dp <= tol, (float(got.price), float(want.price))
    ds = abs(float(got.stderr) - float(want.stderr))
    tol_s = PRICE_RTOL * float(want.stderr) + 8 * EPS32 * abs(
        float(want.price))
    if flips:
        tol_s += FLIP_JUMP / n
    assert ds <= tol_s, (float(got.stderr), float(want.stderr))


@pytest.mark.parametrize("payoff", ["vanilla_call", "asian_call"])
@pytest.mark.parametrize("family", ["sobol", "lattice"])
@pytest.mark.parametrize("model", qmc.QMC_MODELS)
def test_price_qmc_model_matches_mc_tpu(model, family, payoff):
    """Every family on both point families, the call and the Asian."""
    got, want = _both(model, payoff, family)
    jumps = model in ("merton", "bates") and family == "lattice"
    _assert_close(got, want, flips=jumps, n=POINTS[family])


@pytest.mark.parametrize("model,payoff", [
    ("localvol", "cliquet"), ("localvol", "variance_swap"),
    ("term", "lookback_call"), ("term", "forward_start_call"),
    ("vasicek", "asian_call_geo_cv"), ("vasicek", "zcb"),
    ("merton", "up_out_call_bb"), ("basket", "down_out_call_bb"),
    ("heston", "vanilla_put"), ("sabr", "best_of_cash"),
    ("cev", "lookback_call"), ("bates", "variance_swap")])
def test_state_payoffs_match_mc_tpu(model, payoff):
    """The payoffs with state words (and the bridge barriers where a pack
    has sigma, the basket's 0, ROADMAP C16) through the legs, on Sobol."""
    option = {"cliquet": dict(k=2.0, p1=-0.02, p2=0.04),
              "forward_start_call": dict(p1=3.0)}.get(payoff)
    got, want = _both(model, payoff, "sobol", option=option)
    _assert_close(got, want, flips=payoff.endswith("_bb"),
                  n=POINTS["sobol"])


@pytest.mark.parametrize("model", ["heston", "cev", "basket", "merton"])
@pytest.mark.parametrize("payoff", ["bullet_call", "digital_call",
                                    "down_out_call"])
def test_flip_payoffs_match_mc_tpu_within_flips(model, payoff):
    option = dict(p1=1.0, p2=6.0) if payoff == "bullet_call" else None
    got, want = _both(model, payoff, "sobol", option=option)
    _assert_close(got, want, flips=True, n=POINTS["sobol"])


@pytest.mark.parametrize("d", [1, 9])
def test_basket_dimensions_match_mc_tpu(d):
    """An odd d (the last pair's second normal unused) and d past 8 (the
    kernel's capacity 32)."""
    dyn = mt.demo_basket(d, 0.5)
    jdyn = jbasket.BasketDynamics(s0s=dyn.s0s, sigmas=dyn.sigmas,
                                  weights=dyn.weights, corr=dyn.corr)
    got, want = _both("basket", "vanilla_call", "lattice", dyn=(jdyn, dyn))
    _assert_close(got, want)


@pytest.mark.parametrize("model", qmc.QMC_MODELS)
def test_pointset_equals_mc_tpus(model):
    """mc_tpu's model point set (n, zvec, shifts) bitwise, both families,
    its dimensions the family's."""
    jsim = mc_tpu.SimParams(n_paths=1000, n_steps=N_STEPS)
    for family in ("lattice", "sobol"):
        _, _, _, n, zvec, shifts = jq._qmc_model_pointset(
            model, mc_tpu.OptionParams(), None, jsim, payoff="vanilla_call",
            n_shifts=3, engine="xla", family=family, tile_rows=8, gamma=0.1,
            stream=0)
        _, _, _, ps = qmc.qmc_model_pointset(
            model, mt.DEMO_OPTION, None, convert.sim_params(jsim),
            n_shifts=3, family=family, device="cpu")
        assert ps.n == n and ps.d == np.asarray(shifts).shape[1]
        assert np.array_equal(ps.table.numpy(), np.asarray(zvec))
        assert np.array_equal(ps.shifts.numpy(), np.asarray(shifts))


@pytest.mark.parametrize("model", ["heston", "bates", "basket", "term"])
def test_sums_take_mc_tpus_point_set_and_params(model):
    """mc_tpu's own (n, zvec, shifts) and packed params, through
    convert.qmc_pointset and convert.<family>_params, give the port's
    price_qmc_model bit for bit."""
    jopt = mc_tpu.OptionParams()
    jsim = mc_tpu.SimParams(n_paths=1500, n_steps=6)
    po, jdyn, _, n, zvec, shifts = jq._qmc_model_pointset(
        model, jopt, None, jsim, payoff="asian_call", n_shifts=3,
        engine="xla", family="sobol", tile_rows=8, gamma=0.1, stream=0)
    pack, _, _ = jq._model_qmc_hooks(model, jdyn, 6, 1.0)
    if model == "basket":  # pack_basket is bitwise the jitted pack (C17)
        pack = jax.jit(pack, static_argnums=2)
    jprm = np.asarray(pack(jopt.as_f32(), jdyn, 6))
    ps = convert.qmc_pointset("sobol", n, zvec, shifts)
    own_po, dyn, extra, _ = qmc.qmc_model_pointset(
        model, mt.DEMO_OPTION, None, convert.sim_params(jsim), "asian_call",
        n_shifts=3, device="cpu")
    prm = {"heston": convert.heston_params,
           "bates": convert.bates_params,
           "basket": lambda a: convert.basket_params(a, dyn.d),
           "term": lambda a: convert.term_params(a, 6)}[model](jprm)
    sums = finish_sum(qmc.qmc_model_sums(model, own_po, ps, prm, 6,
                                         extra))[:, 0]
    got = qmc.finish_qmc(sums, n, mt.DEMO_OPTION,
                         qmc.qmc_model_discount(model, mt.DEMO_OPTION, dyn))
    own = qmc.price_qmc_model(model, sim=convert.sim_params(jsim),
                              payoff="asian_call", n_shifts=3,
                              device="cpu")
    assert float(got.price) == float(own.price)
    assert float(got.stderr) == float(own.stderr)


def test_discounts_equal_mc_tpus():
    """The date-0 discounts: 1 for Vasicek, the f32 curve mean for term,
    e^{-rT} otherwise, each bitwise mc_tpu's."""
    for model in qmc.QMC_MODELS:
        jopt = mc_tpu.OptionParams()
        jsim = mc_tpu.SimParams(n_paths=256, n_steps=N_STEPS)
        _, jdyn, _, _, _, _ = jq._qmc_model_pointset(
            model, jopt, None, jsim, payoff="vanilla_call", n_shifts=2,
            engine="xla", family="sobol", tile_rows=8, gamma=0.1, stream=0)
        want = float(jq._model_qmc_discount(model, jopt.as_f32(), jdyn))
        dyn, _ = qmc.qmc_model_dynamics(model, None, N_STEPS)
        assert qmc.qmc_model_discount(model, mt.DEMO_OPTION, dyn) == want
