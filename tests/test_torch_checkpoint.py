"""mc_tpu_torch.checkpoint on the CPU (the GBM cases of
tests/test_checkpoint.py, and a run begun by mc_tpu and resumed here).

The running state is the f64 moment sums, added in chunk order, so a
resumed run is bitwise the uninterrupted one.  Tolerances:
* against price(method="terminal") of the port: both finish in f64 and
  differ only in the order of the sums, so 1e-12 relative;
* against mc_tpu's chunked_price: its slabs are f32 Kahan sums finished in
  f32, so 1e-6 relative (as tests/test_torch_engines.py holds prices).
"""

import os

import numpy as np
import pytest
import torch

import mc_tpu
from mc_tpu.checkpoint import chunked_price as jchunked_price
from mc_tpu.checkpoint import load_checkpoint as jload_checkpoint

import mc_tpu_torch as mt
from mc_tpu_torch import convert
from mc_tpu_torch.checkpoint import (MAGIC, Checkpoint, chunked_price,
                                     load_checkpoint)

torch.set_num_threads(1)

SIM = mt.SimParams(n_paths=40_000, n_steps=10)
CHUNK = 8 * 128 * 8  # 8192 paths a chunk -> 5 chunks
CPU = dict(device="cpu")


def test_chunked_matches_plain_price():
    """Chunked accumulation equals the one-shot price on the per-path
    stream (method="terminal"); the terminal_pair default draws another
    stream and agrees statistically."""
    a = chunked_price(sim=SIM, chunk_paths=CHUNK, **CPU)
    b = mt.price(sim=SIM, method="terminal", **CPU)
    assert float(a.price) == pytest.approx(float(b.price), rel=1e-12)
    assert float(a.stderr) == pytest.approx(float(b.stderr), rel=1e-12)
    c = mt.price(sim=SIM, **CPU)
    joint = (float(a.stderr) ** 2 + float(c.stderr) ** 2) ** 0.5
    assert abs(float(a.price) - float(c.price)) < 4 * joint
    e = chunked_price(sim=SIM, chunk_paths=CHUNK, payoff="asian_call", **CPU)
    f = mt.price(sim=SIM, payoff="asian_call", **CPU)
    assert float(e.price) == pytest.approx(float(f.price), rel=1e-12)


def test_matches_mc_tpu_chunked_price():
    a = chunked_price(sim=SIM, chunk_paths=CHUNK, **CPU)
    b = jchunked_price(sim=mc_tpu.SimParams(n_paths=40_000, n_steps=10),
                       chunk_paths=CHUNK, engine="xla", tile_rows=8)
    assert float(a.price) == pytest.approx(float(b.price), rel=1e-6)
    assert float(a.stderr) == pytest.approx(float(b.stderr), rel=1e-5)


def test_resume_bitwise_identical(tmp_path):
    ck = str(tmp_path / "run.npz")
    full = chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck,
                         **CPU)
    state = load_checkpoint(ck)
    assert state.paths_done == SIM.n_paths
    # The state after chunk 2: a two-chunk run writes it.
    ck2 = str(tmp_path / "run2.npz")
    chunked_price(sim=SIM.replace(n_paths=2 * CHUNK), chunk_paths=CHUNK,
                  checkpoint_path=ck2, **CPU)
    mid = load_checkpoint(ck2)
    assert mid.paths_done == 2 * CHUNK
    mid.n_paths = SIM.n_paths
    mid.save(ck)
    resumed = chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck,
                            resume=True, **CPU)
    assert float(resumed.price) == float(full.price)  # bitwise
    assert float(resumed.stderr) == float(full.stderr)
    np.testing.assert_array_equal(load_checkpoint(ck).sums, state.sums)


def test_resume_guards(tmp_path):
    ck = str(tmp_path / "run.npz")
    with pytest.raises(FileNotFoundError):
        chunked_price(sim=SIM, checkpoint_path=ck, resume=True, **CPU)
    chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck, **CPU)
    with pytest.raises(ValueError, match="payoff"):
        chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck,
                      resume=True, payoff="bullet_call", **CPU)
    with pytest.raises(ValueError, match="n_paths"):
        chunked_price(sim=SIM.replace(n_paths=50_000), chunk_paths=CHUNK,
                      checkpoint_path=ck, resume=True, **CPU)
    with pytest.raises(ValueError, match="chunk_paths"):
        chunked_price(sim=SIM, chunk_paths=CHUNK // 2, checkpoint_path=ck,
                      resume=True, **CPU)


def test_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "c.npz")
    ck = Checkpoint(paths_done=100, n_paths=200,
                    sums=np.array([1.5, 2.25]),
                    meta=dict(seed=1, payoff="vanilla_call", method="euler",
                              chunk_paths=100))
    ck.save(p)
    assert os.listdir(tmp_path) == ["c.npz"]  # the temporary file is gone
    back = load_checkpoint(p)
    assert back.paths_done == 100 and back.n_paths == 200
    np.testing.assert_array_equal(back.sums, ck.sums)
    assert back.meta["payoff"] == "vanilla_call"
    assert str(np.load(p)["magic"]) == MAGIC


def test_resume_rejects_changed_market_data(tmp_path):
    ck = str(tmp_path / "run.npz")
    chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck, **CPU)
    with pytest.raises(ValueError, match="option"):
        chunked_price(option=mt.OptionParams(sigma=0.3), sim=SIM,
                      chunk_paths=CHUNK, checkpoint_path=ck, resume=True,
                      **CPU)
    with pytest.raises(ValueError, match="n_steps"):
        chunked_price(sim=SIM.replace(n_steps=20), chunk_paths=CHUNK,
                      checkpoint_path=ck, resume=True, **CPU)


def test_resume_rejects_changed_rng_source(tmp_path):
    ck = str(tmp_path / "run.npz")
    chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck, **CPU)
    with pytest.raises(ValueError, match="rng_source"):
        chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=ck,
                      resume=True, rng_source="threefry", **CPU)


def test_hw_rng_source_rejected():
    with pytest.raises(ValueError, match="resumable"):
        chunked_price(sim=SIM, chunk_paths=CHUNK, rng_source="hw", **CPU)
    with pytest.raises(ValueError, match="resumable"):
        chunked_price(sim=SIM, chunk_paths=CHUNK, rng_source="threefry31",
                      **CPU)


def test_model_refused():
    """A name outside the model table and the terminal-draw families are
    refused (the step-loop families run: tests/test_torch_model_table.py)."""
    with pytest.raises(ValueError, match="unknown model 'bachelier'"):
        chunked_price(sim=SIM, model="bachelier", **CPU)
    with pytest.raises(ValueError, match="terminal-draw"):
        chunked_price(sim=SIM, model="rainbow", **CPU)


def test_rejects_mc_tpu_file_and_resumes_it_converted(tmp_path):
    """An mc_tpu run stopped after 2 of 5 chunks, carried over by
    convert.checkpoint, resumes in the port: within its f32 slabs'
    rounding of the port's uninterrupted run."""
    jck = str(tmp_path / "mc_tpu.npz")
    jchunked_price(sim=mc_tpu.SimParams(n_paths=2 * CHUNK, n_steps=10),
                   chunk_paths=CHUNK, checkpoint_path=jck, engine="xla",
                   tile_rows=8)
    mid = jload_checkpoint(jck)
    mid.n_paths = SIM.n_paths
    mid.save(jck)
    with pytest.raises(ValueError, match="not an mc_tpu_torch checkpoint"):
        load_checkpoint(jck)
    ck = convert.checkpoint(jck)
    assert ck.paths_done == 2 * CHUNK and ck.n_paths == SIM.n_paths
    assert "engine" not in ck.meta and "tile_rows" not in ck.meta
    mine = chunked_price(sim=SIM.replace(n_paths=2 * CHUNK),
                         chunk_paths=CHUNK, **CPU)
    np.testing.assert_allclose(
        ck.sums, [float(mine.payoff_mean) * 2 * CHUNK,
                  float(mine.payoff_var) * (2 * CHUNK - 1)
                  + float(mine.payoff_mean) ** 2 * 2 * CHUNK], rtol=1e-6)
    # a mapping of the arrays gives the same state
    with np.load(jck) as z:
        np.testing.assert_array_equal(convert.checkpoint(z).sums, ck.sums)
    path = str(tmp_path / "port.npz")
    ck.save(path)
    resumed = chunked_price(sim=SIM, chunk_paths=CHUNK, checkpoint_path=path,
                            resume=True, **CPU)
    full = chunked_price(sim=SIM, chunk_paths=CHUNK, **CPU)
    assert float(resumed.price) == pytest.approx(float(full.price), rel=1e-6)
    assert float(resumed.stderr) == pytest.approx(float(full.stderr),
                                                  rel=1e-5)
    assert load_checkpoint(path).paths_done == SIM.n_paths
