"""price_nmc_book on the CPU: the cases of tests/test_nmc_book.py (a
one-contract book bitwise the grid NMC, netting subadditivity, long/short
collapse, CVA on the netted profile, validation, the family books), then
the netted surface against mc_tpu's price_nmc_book(engine="xla") through
convert.book_surface.

On the CPU each contract runs the grid pipeline's plain versions (the
trajectories and inner kernels' stand-ins).

Tolerances:
* against the port's own grid NMC: bitwise;
* against mc_tpu: each netted point within 1e-5 of the largest (per-point
  f32 values over the parity contract's few-ulp normals, summed over B
  weighted contracts; ~3e-7 seen), the standalone EEs the same (f32 sums
  in another order), the outer prices 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.nmc_book import price_nmc_book as jbook

import mc_tpu_torch as mt
from mc_tpu_torch import convert
from mc_tpu_torch.nmc_book import price_nmc_book

torch.set_num_threads(1)

CPU = dict(device="cpu")
SIM = mt.SimParams(n_paths=2048, n_steps=8, n_paths_inner=8)
JSIM = mc_tpu.SimParams(n_paths=2048, n_steps=8, n_paths_inner=8)


def _book(ks, **kw):
    fields = dict(k=np.asarray(ks, np.float32))
    fields.update({f: np.asarray(v, np.float32) for f, v in kw.items()})
    return mt.OptionParams(**fields)


def test_b1_bitwise_equals_price_nmc():
    b = price_nmc_book(_book([100.0], p1=[1.0], p2=[6.0]), SIM,
                       payoff="bullet_call", **CPU)
    s = mt.price_nmc(mt.OptionParams(p1=1.0, p2=6.0), SIM,
                     payoff="bullet_call", strategy="grid", **CPU)
    assert torch.equal(b.net_surface, s.surface)
    assert float(b.outers.price[0]) == float(s.outer.price)
    assert float(b.outers.stderr[0]) == float(s.outer.stderr)


def test_netting_subadditivity():
    r = price_nmc_book(_book([90.0, 100.0, 110.0]), SIM,
                       payoff="vanilla_call", weights=[1.0, -2.0, 1.0], **CPU)
    ee_net, pfe_net = r.exposure_profile()
    sum_ee = r.ee_contract.sum(dim=0)
    assert torch.all(ee_net <= sum_ee + 1e-5)
    assert torch.all(pfe_net >= ee_net - 1e-5)
    assert float(ee_net[-1]) < float(sum_ee[-1]) - 1e-3


def test_long_short_collapse():
    r = price_nmc_book(_book([100.0, 100.0]), SIM, payoff="vanilla_call",
                       weights=[1.0, -1.0], **CPU)
    assert torch.equal(r.net_surface, torch.zeros_like(r.net_surface))
    assert float(r.net_outer_price) == 0.0


def test_cva_on_netted_profile():
    r = price_nmc_book(_book([90.0, 110.0]), SIM, payoff="vanilla_call",
                       **CPU)
    cva = float(r.cva(0.02))
    assert 0.0 < cva < float(r.ee_contract.sum())


def test_validation():
    with pytest.raises(ValueError, match="one market state"):
        price_nmc_book(_book([90.0, 100.0], sigma=[0.2, 0.3]), SIM, **CPU)
    with pytest.raises(ValueError, match="weights shape"):
        price_nmc_book(_book([90.0, 100.0]), SIM, weights=[1.0], **CPU)
    with pytest.raises(ValueError, match="1-D"):
        price_nmc_book(mt.OptionParams(), SIM, **CPU)
    with pytest.raises(ValueError, match="at most one state"):
        price_nmc_book(_book([100.0]), SIM, payoff="cliquet", **CPU)


@pytest.mark.parametrize("model", ["heston", "vasicek", "merton", "basket",
                                   "bates", "cev", "localvol", "sabr"])
def test_book_under_model_families(model):
    """A one-contract book is bitwise price_nmc_<model>'s grid surface and
    outer price; a long against the same short nets to zero."""
    b = price_nmc_book(_book([100.0]), SIM, model=model, **CPU)
    s = getattr(mt, f"price_nmc_{model}")(sim=SIM, strategy="grid", **CPU)
    assert torch.equal(b.net_surface, s.surface)
    assert float(b.outers.price[0]) == float(s.outer.price)
    r = price_nmc_book(_book([100.0, 100.0]), SIM, model=model,
                       weights=[1.0, -1.0], **CPU)
    assert torch.equal(r.net_surface, torch.zeros_like(r.net_surface))
    assert float(r.net_outer_price) == 0.0


def test_book_model_validation():
    with pytest.raises(ValueError, match="unknown book model"):
        price_nmc_book(_book([100.0]), SIM, model="bachelier", **CPU)
    for model in ("rainbow", "term"):
        with pytest.raises(ValueError, match="unknown book model"):
            price_nmc_book(_book([100.0]), SIM, model=model, **CPU)
    with pytest.raises(ValueError, match="even n_steps"):
        price_nmc_book(_book([100.0]), SIM.replace(n_steps=7),
                       model="merton", **CPU)
    with pytest.raises(ValueError, match="counter space"):
        price_nmc_book(_book([100.0]), mt.SimParams(
            n_paths=8, n_steps=2048, n_paths_inner=1024), model="heston",
            **CPU)


@pytest.mark.parametrize("model,payoff", [("gbm", "vanilla_call"),
                                          ("gbm", "bullet_call"),
                                          ("heston", "vanilla_call"),
                                          ("vasicek", "asian_call"),
                                          ("basket", "vanilla_put")])
def test_book_matches_mc_tpu(model, payoff):
    ks, w = [90.0, 100.0, 110.0], [1.0, -0.5, 2.0]
    a = price_nmc_book(_book(ks), SIM, payoff, w, model=model, **CPU)
    b = jbook(mc_tpu.OptionParams(k=np.asarray(ks, np.float32)), JSIM,
              payoff, w, model=model, engine="xla")
    want = convert.book_surface(b)
    assert a.net_surface.shape == want.shape
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(a.net_surface.numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(a.ee_contract.numpy(),
                               np.asarray(b.ee_contract), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(a.outers.price.numpy(),
                               np.asarray(b.outers.price), rtol=1e-6)
    assert float(a.net_outer_price) == pytest.approx(
        float(b.net_outer_price), rel=1e-6)
    assert float(a.cva(0.02)) == pytest.approx(float(b.cva(0.02)), rel=1e-5)
    assert float(a.t_horizon) == float(b.t_horizon)


def test_book_defaults_to_cuda():
    if torch.cuda.is_available():
        r = price_nmc_book(_book([100.0]), SIM)
        assert r.net_surface.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            price_nmc_book(_book([100.0]), SIM)
