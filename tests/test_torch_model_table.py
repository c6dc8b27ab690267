"""The model table (mc_tpu_torch.parallel.models_sharded) and
chunked_price(model=...) on the CPU: the model= cases of
tests/test_checkpoint.py, then the cross-package checks.

Tolerances:
* chunked_price(model=m) against the port's price_<m> on the same key:
  both finish the same per-path f32 payoffs in f64 and differ only in the
  order of the f64 sums, so 1e-12 relative;
* against mc_tpu's chunked_price(model=m, engine="xla"): its Kahan f32
  slabs finished in f32, and per-path payoffs within the parity contract's
  few-ulp normals, so 1e-5 relative (~1e-7 seen);
* a resumed run against the uninterrupted one: bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.checkpoint import chunked_price as jchunked_price
from mc_tpu.checkpoint import load_checkpoint as jload_checkpoint
from mc_tpu.parallel.models_sharded import _model_def as _jmodel_def

import mc_tpu_torch as mt
from mc_tpu_torch import convert
from mc_tpu_torch.checkpoint import chunked_price, load_checkpoint
from mc_tpu_torch.parallel import SHARDED_MODELS
from mc_tpu_torch.parallel.models_sharded import (_model_def,
                                                  model_fingerprint)

torch.set_num_threads(1)

CPU = dict(device="cpu")
SIM = mt.SimParams(n_paths=6_000, n_steps=10)
CHUNK = 2_048  # 3 chunks, the last a part
STEP_MODELS = tuple(m for m in SHARDED_MODELS if m not in ("rainbow", "fx"))


def _price_family(model: str, sim, dyn=None):
    """price_<model> on its default key, on the table's demo dynamics."""
    mdef = _model_def(model)
    dyn = mdef.default_dyn(sim) if dyn is None else dyn
    fn = getattr(mt, f"price_{model}")
    if model == "localvol":
        return fn(surf=dyn, sim=sim, **CPU)
    if model == "term":
        return fn(term=dyn, sim=sim, **CPU)
    return fn(mt.DEMO_OPTION, dyn, sim, **CPU)


def test_table_rows_match_mc_tpu():
    """Every row's tag, step parity, terminal draw, resolver and discount
    convention are mc_tpu's."""
    from mc_tpu.parallel.models_sharded import SHARDED_MODELS as JMODELS
    assert SHARDED_MODELS == JMODELS
    for m in SHARDED_MODELS:
        mine, ref = _model_def(m), _jmodel_def(m)
        assert mine.tag == ref.tag, m
        assert mine.even_steps == ref.even_steps, m
        assert mine.terminal_only == ref.terminal_only, m
        assert (mine.resolve_payoff is None) == (ref.resolve_payoff is None)
        assert (mine.discount is None) == (ref.discount is None), m
        assert (mine.prepare is None) == (ref.prepare is None), m


@pytest.mark.parametrize("model", ["rainbow", "fx"])
def test_terminal_rows_build_and_price(model):
    """The terminal-draw rows resolve their payoff names and build the
    packed vector and partials of price_<model>."""
    mdef = _model_def(model)
    name = mdef.resolve_payoff(None)
    assert name == ("call_on_max" if model == "rainbow" else "quanto_call")
    sim = mt.SimParams(n_paths=4_096, n_steps=1)
    cfg = mt_kernel_config(sim.n_paths)
    params, partials = mdef.build(name, cfg, mt.DEMO_OPTION,
                                  mdef.default_dyn(sim), 1, "cpu", ())
    from mc_tpu_torch import rng
    from mc_tpu_torch.ops.reduce import finish_sum
    key = rng.derive_key(sim.seed, 0, mdef.tag)
    sums = finish_sum(partials(key, params))
    ref = (mt.price_rainbow(sim=sim, **CPU) if model == "rainbow"
           else mt.price_fx(sim=sim, **CPU))
    assert float(sums[0]) / sim.n_paths == pytest.approx(
        float(ref.payoff_mean), rel=1e-12)
    with pytest.raises(KeyError):
        mdef.resolve_payoff("vanilla_call")


def mt_kernel_config(n_paths):
    from mc_tpu_torch.ops.path_kernels import KernelConfig
    return KernelConfig(n_paths=n_paths, n_steps=1)


@pytest.mark.parametrize("model", STEP_MODELS)
def test_chunked_model_matches_price_and_mc_tpu(model):
    """chunked_price(model=m) is price_<m> up to the f64 sum order, and
    mc_tpu's chunked_price(model=m) within its f32 slabs."""
    a = chunked_price(sim=SIM, chunk_paths=CHUNK, model=model, **CPU)
    b = _price_family(model, SIM)
    assert float(a.price) == pytest.approx(float(b.price), rel=1e-12)
    assert float(a.stderr) == pytest.approx(float(b.stderr), rel=1e-12)
    j = jchunked_price(sim=mc_tpu.SimParams(n_paths=SIM.n_paths,
                                            n_steps=SIM.n_steps),
                       chunk_paths=1024, model=model, engine="xla",
                       tile_rows=8)
    assert float(a.price) == pytest.approx(float(j.price), rel=1e-5)
    assert float(a.stderr) == pytest.approx(float(j.stderr), rel=1e-4)


@pytest.mark.parametrize("model", STEP_MODELS)
def test_chunked_model_resume_bitwise(model, tmp_path):
    """A run stopped after 2 of its 3 chunks and resumed is bitwise the
    uninterrupted one under every family."""
    ck = str(tmp_path / "run.npz")
    full = chunked_price(sim=SIM, chunk_paths=CHUNK, model=model, **CPU)
    chunked_price(sim=SIM.replace(n_paths=2 * CHUNK), chunk_paths=CHUNK,
                  model=model, checkpoint_path=ck, **CPU)
    mid = load_checkpoint(ck)
    assert mid.meta["model"] == model and mid.meta["dyn"]
    mid.n_paths = SIM.n_paths
    mid.save(ck)
    resumed = chunked_price(sim=SIM, chunk_paths=CHUNK, model=model,
                            checkpoint_path=ck, resume=True, **CPU)
    assert float(resumed.price) == float(full.price)
    assert float(resumed.stderr) == float(full.stderr)
    assert load_checkpoint(ck).paths_done == SIM.n_paths


def test_vasicek_discount_is_pathwise_and_term_off_its_curve():
    """Vasicek finishes at discount 1 (its legs discount pathwise); term at
    e^{-r_bar T}, r_bar from its packed head."""
    v = chunked_price(sim=SIM, chunk_paths=CHUNK, model="vasicek", **CPU)
    assert float(v.price) == pytest.approx(float(v.payoff_mean), rel=1e-15)
    t = chunked_price(sim=SIM, chunk_paths=CHUNK, model="term", **CPU)
    assert float(t.price) < float(t.payoff_mean)


def test_chunked_model_rejects_changed_dynamics(tmp_path):
    """Resuming under other dynamics fails loudly: the dyn fingerprint is
    in the checkpoint's meta."""
    sim = SIM.replace(n_paths=2 * CHUNK)
    ck = str(tmp_path / "dyn.npz")
    chunked_price(sim=sim, chunk_paths=CHUNK, model="heston",
                  checkpoint_path=ck, **CPU)
    with pytest.raises(ValueError, match="mismatch for 'dyn'"):
        chunked_price(sim=sim, chunk_paths=CHUNK, model="heston",
                      dyn=mt.HestonDynamics(v0=0.09), checkpoint_path=ck,
                      resume=True, **CPU)
    with pytest.raises(ValueError, match="mismatch for 'model'"):
        chunked_price(sim=sim, chunk_paths=CHUNK, model="bates",
                      checkpoint_path=ck, resume=True, **CPU)


def test_chunked_model_validation():
    with pytest.raises(ValueError, match="unknown model") as e:
        chunked_price(model="bachelier", **CPU)
    assert "heston" in str(e.value) and "localvol" in str(e.value)
    for model in ("rainbow", "fx"):
        with pytest.raises(ValueError, match="terminal-draw"):
            chunked_price(model=model, **CPU)
    for model in ("merton", "cev", "vasicek", "term", "localvol"):
        with pytest.raises(ValueError, match="even n_steps"):
            dyn = None
            if model == "term":
                dyn = mt.TermStructure.from_knots([0.1], [0.2], 9)
            if model == "localvol":
                dyn = mt.LocalVolSurface.demo(9)
            chunked_price(sim=mt.SimParams(n_paths=2048, n_steps=9),
                          model=model, dyn=dyn, **CPU)
    with pytest.raises(ValueError, match="term structure has"):
        chunked_price(sim=mt.SimParams(n_paths=2048, n_steps=10),
                      model="term", dyn=mt.TermStructure.from_knots(
                          [0.1], [0.2], 8), **CPU)
    # the payoff is validated under a family too
    with pytest.raises(ValueError, match="forward_start_call"):
        chunked_price(mt.OptionParams(p1=3.5), SIM, "forward_start_call",
                      model="heston", **CPU)


def test_fingerprint_matches_mc_tpu_meta(tmp_path):
    """The dyn meta is mc_tpu's string (its pytree leaves in field order as
    %.9g), on scalar and array dynamics."""
    for model in ("heston", "localvol", "term"):
        ck = str(tmp_path / f"{model}.npz")
        jchunked_price(sim=mc_tpu.SimParams(n_paths=2048, n_steps=10),
                       chunk_paths=1024, model=model, engine="xla",
                       tile_rows=8, checkpoint_path=ck)
        dyn = _model_def(model).default_dyn(SIM)
        assert jload_checkpoint(ck).meta["dyn"] == model_fingerprint(
            _model_def(model).prepare(mt.DEMO_OPTION, dyn, SIM)[0]
            if model == "localvol" else dyn)


def test_mc_tpu_model_checkpoint_resumes_converted(tmp_path):
    """An mc_tpu heston run stopped after 2 of 5 chunks, carried over by
    convert.checkpoint with its model and dyn meta, resumes in the port:
    within its f32 slabs' rounding of the port's uninterrupted run."""
    sim = mt.SimParams(n_paths=5 * 1024, n_steps=10)
    jck = str(tmp_path / "mc_tpu.npz")
    jchunked_price(sim=mc_tpu.SimParams(n_paths=2 * 1024, n_steps=10),
                   chunk_paths=1024, model="heston", engine="xla",
                   tile_rows=8, checkpoint_path=jck)
    mid = jload_checkpoint(jck)
    mid.n_paths = sim.n_paths
    mid.save(jck)
    ck = convert.checkpoint(jck)
    assert ck.meta["model"] == "heston" and ck.paths_done == 2 * 1024
    path = str(tmp_path / "port.npz")
    ck.save(path)
    resumed = chunked_price(sim=sim, chunk_paths=1024, model="heston",
                            checkpoint_path=path, resume=True, **CPU)
    full = chunked_price(sim=sim, chunk_paths=1024, model="heston", **CPU)
    assert float(resumed.price) == pytest.approx(float(full.price), rel=1e-6)
    assert float(resumed.stderr) == pytest.approx(float(full.stderr),
                                                  rel=1e-5)


def test_chunked_model_defaults_to_cuda():
    """No device: the card (on a host without one this raises; nothing
    runs on the CPU instead)."""
    if torch.cuda.is_available():
        res = chunked_price(sim=SIM, model="heston")
        assert res.price.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            chunked_price(sim=SIM, model="heston")


def test_table_prepare_extras():
    """Merton's and Bates's kmax and local vol's knot count ride as the
    family's integer extras."""
    from mc_tpu_torch.models.merton import poisson_kmax
    dyn, ex = _model_def("merton").prepare(mt.DEMO_OPTION, mt.DEMO_MERTON,
                                           SIM)
    assert ex == (poisson_kmax(mt.DEMO_MERTON.lam * 1.0 / SIM.n_steps),)
    _, ex = _model_def("bates").prepare(mt.DEMO_OPTION, mt.DEMO_BATES, SIM)
    assert len(ex) == 1 and ex[0] >= 1
    surf, ex = _model_def("localvol").prepare(
        mt.DEMO_OPTION, mt.LocalVolSurface.demo(SIM.n_steps), SIM)
    assert ex == (surf.n_knots,)
    assert dataclasses.is_dataclass(surf)
