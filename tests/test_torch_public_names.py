"""The public names of mc_tpu_torch and mc_tpu_torch.models against
mc_tpu's, the Abramowitz-Stegun oracles (cnd_as, bs_call_as: the cases of
tests/test_oracle.py, then against mc_tpu's on one f32 grid) and
models/gbm.py against mc_tpu's.

Tolerances:
* cnd_as: test_oracle.py's 1e-6 against the exact CDF; against mc_tpu's
  2^-23, two f32 roundings below 1 (the two frameworks' exp differ by an
  ulp, and 1 - tail rounds it once more; 96% of the grid is bitwise);
* bs_call_as: test_oracle.py's 1e-4 against Black-Scholes; against
  mc_tpu's 1e-5 relative (the log and exp ulps carried through
  s0 N(d1) - K e^{-rT} N(d2), whose cancellation amplifies them);
* the GBM functions: a few f32 ulps (torch's and XLA's exp).
"""

import inspect
import math
import re

import numpy as np
import pytest
import torch
from scipy.stats import norm

import mc_tpu
import mc_tpu.models
from mc_tpu import oracle as joracle
from mc_tpu.models import gbm as jgbm

import mc_tpu_torch
import mc_tpu_torch.models
from mc_tpu_torch import oracle
from mc_tpu_torch.models import gbm

EPS32 = 2.0 ** -24


def test_models_exports_mc_tpus_names():
    assert len(mc_tpu.models.__all__) == 38
    assert sorted(mc_tpu_torch.models.__all__) == sorted(
        mc_tpu.models.__all__)
    for name in mc_tpu.models.__all__:
        assert getattr(mc_tpu_torch.models, name) is not None, name
    assert "to port" not in mc_tpu_torch.models.__doc__.split("rates")[0]


def test_package_exports_mc_tpus_names():
    for name in mc_tpu.__all__:
        assert name in mc_tpu_torch.__all__, name
        assert getattr(mc_tpu_torch, name) is not None, name
    for name in ("PriceResult", "bs_call", "bs_put", "bs_call_as",
                 "bs_delta_call", "cnd_as", "PAYOFFS", "get_payoff"):
        assert getattr(mc_tpu_torch, name) is getattr(
            mc_tpu_torch.oracle if name not in ("PAYOFFS", "get_payoff")
            else mc_tpu_torch.ops.payoffs, name)
    assert sorted(mc_tpu_torch.PAYOFFS) == sorted(mc_tpu.PAYOFFS)


def _lazy_names():
    src = inspect.getsource(mc_tpu.__getattr__)
    return sorted(set(re.findall(r'"([A-Za-z_0-9]+)"', src)))


@pytest.mark.parametrize("name", _lazy_names())
def test_lazy_names_have_counterparts(name):
    """Each name mc_tpu loads lazily is here, or raises an AttributeError
    naming the ROADMAP item that ports it."""
    try:
        assert getattr(mc_tpu_torch, name) is not None
    except AttributeError as e:
        assert re.search(r"ROADMAP item (16|17|18|19)\b", str(e)), str(e)


def test_unknown_name_raises():
    with pytest.raises(AttributeError, match="no attribute 'nonesuch'"):
        mc_tpu_torch.nonesuch


def test_cnd_as_matches_exact_cdf():
    x = torch.linspace(-6.0, 6.0, 4001)
    err = torch.abs(oracle.cnd_as(x).double()
                    - torch.as_tensor(norm.cdf(x.double().numpy())))
    assert float(err.max()) < 1e-6
    assert oracle.cnd_as(x).dtype == torch.float32


def test_cnd_as_matches_mc_tpus():
    x = np.linspace(-8.0, 8.0, 100_001).astype(np.float32)
    mine = oracle.cnd_as(x).numpy()
    ref = np.asarray(joracle.cnd_as(x))
    assert np.max(np.abs(mine - ref)) <= 2 * EPS32


def test_bs_call_as_close_to_exact():
    demo = dict(s0=100.0, k=100.0, t=1.0, r=0.1, sigma=0.2)
    a = float(oracle.bs_call_as(**demo))
    assert a == pytest.approx(oracle.bs_call(**demo), abs=1e-4)


def test_bs_call_as_matches_mc_tpus():
    s0 = np.linspace(60.0, 160.0, 1001).astype(np.float32)
    mine = oracle.bs_call_as(s0, 100.0, 1.0, 0.1, 0.2).numpy()
    ref = np.asarray(joracle.bs_call_as(s0, 100.0, 1.0, 0.1, 0.2))
    np.testing.assert_allclose(mine, ref, rtol=1e-5)


def test_gbm_functions_match_mc_tpus():
    z = np.linspace(-4.0, 4.0, 1001).astype(np.float32)
    zt = torch.from_numpy(z)
    mine = gbm.gbm_exact_terminal(100.0, 1.0, 0.1, 0.2, zt).numpy()
    ref = np.asarray(jgbm.gbm_exact_terminal(100.0, 1.0, 0.1, 0.2, z))
    np.testing.assert_allclose(mine, ref, rtol=4 * EPS32 * 8)
    mine = gbm.gbm_log_euler_step(torch.full_like(zt, 100.0), 0.01, 0.1,
                                  0.2, zt).numpy()
    ref = np.asarray(jgbm.gbm_log_euler_step(np.float32(100.0), 0.01, 0.1,
                                             0.2, z))
    np.testing.assert_allclose(mine, ref, rtol=4 * EPS32 * 8)
    g, jg = gbm.GBM.make(1.0, 0.1, 0.2, 100), jgbm.GBM.make(1.0, 0.1, 0.2,
                                                            100)
    for f in ("drift_dt", "vol_dt", "drift_t", "vol_t"):
        assert float(getattr(g, f)) == float(getattr(jg, f)), f
    np.testing.assert_allclose(g.step(torch.full_like(zt, 100.0), zt).numpy(),
                               np.asarray(jg.step(np.float32(100.0), z)),
                               rtol=4 * EPS32 * 8)
    np.testing.assert_allclose(g.terminal(100.0, zt).numpy(),
                               np.asarray(jg.terminal(100.0, z)),
                               rtol=4 * EPS32 * 8)
    # the exact draw's mean: E[S_T] = s0 e^{rT}
    zz = torch.randn(200_000, generator=torch.Generator().manual_seed(5))
    m = float(g.terminal(100.0, zz).double().mean())
    assert m == pytest.approx(100.0 * math.exp(0.1), rel=3e-3)
