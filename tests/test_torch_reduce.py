"""mc_tpu_torch's standalone reductions against mc_tpu and numpy on the CPU
(the cases of tests/test_reduce.py).

On a CPU tensor ``tile_partials``/``sum_sumsq_partials`` run their plain
versions (f64 sums per chunk of elements); mc_tpu runs its Pallas kernels
in interpret mode.  Tolerances:
* against the f64 numpy sum: the port adds in f64, so 1e-12 relative;
* against mc_tpu: it Kahan-adds f32 tiles and finishes in f32 (x64 is
  off), so 1e-6 relative (abs 1e-2 where the sum is near zero);
* ``kahan_sum`` is the same sequential f32 Kahan loop in both packages, so
  the two are bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_tpu.ops import reduce as jreduce

from mc_tpu_torch.ops import reduce

torch.set_num_threads(1)

SIZES = [1, 127, 1024, 100_000]


@pytest.fixture(scope="module")
def random_array():
    rs = np.random.RandomState(42)
    return rs.standard_normal(100_000).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
def test_sum_pallas_matches_numpy_and_mc_tpu(n):
    rs = np.random.RandomState(n)
    x = rs.standard_normal(n).astype(np.float32)
    got = float(reduce.sum_pallas(torch.from_numpy(x)))
    want = float(np.sum(x.astype(np.float64)))
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    ref = float(jreduce.sum_pallas(jnp.asarray(x), tile_rows=8))
    assert got == pytest.approx(ref, abs=1e-2, rel=1e-6)
    s, s2 = reduce.sum_sumsq_pallas(torch.from_numpy(x))
    js, js2 = jreduce.sum_sumsq_pallas(jnp.asarray(x), tile_rows=8)
    assert float(s) == got
    assert float(s2) == pytest.approx(float(js2), rel=1e-6)
    # each square in f32, as mc_tpu and the path kernels' moments take it
    assert float(s2) == pytest.approx(
        float(np.sum((x * x).astype(np.float64))), rel=1e-12)


def test_tile_partials_sum(random_array):
    parts = reduce.tile_partials(torch.from_numpy(random_array))
    assert parts.dtype == torch.float64 and parts.shape[1] == 1
    got = float(reduce.finish_sum(parts)[0])
    want = float(random_array.astype(np.float64).sum())
    assert got == pytest.approx(want, rel=1e-12)
    ref = np.asarray(jreduce.tile_partials(jnp.asarray(random_array),
                                           tile_rows=64))
    assert got == pytest.approx(float(ref.astype(np.float64).sum()),
                                abs=1e-2)


def test_sum_sumsq(random_array):
    x = torch.from_numpy(random_array)
    parts = reduce.sum_sumsq_partials(x)
    assert parts.dtype == torch.float64 and parts.shape[1] == 2
    s, s2 = reduce.sum_sumsq_pallas(x)
    want_s = random_array.astype(np.float64).sum()
    want_s2 = (random_array * random_array).astype(np.float64).sum()
    assert float(s) == pytest.approx(want_s, rel=1e-12)
    assert float(s2) == pytest.approx(want_s2, rel=1e-12)
    js, js2 = jreduce.sum_sumsq_pallas(jnp.asarray(random_array),
                                       tile_rows=64)
    assert float(s) == pytest.approx(float(js), abs=1e-2)
    assert float(s2) == pytest.approx(float(js2), rel=1e-6)


def test_kahan_sum_ground_truth(random_array):
    x = random_array[:20_000]
    got = reduce.kahan_sum(torch.from_numpy(x))
    assert isinstance(got, np.float32)
    assert float(got) == pytest.approx(float(x.astype(np.float64).sum()),
                                       abs=1e-3)
    assert got == np.float32(jreduce.kahan_sum(jnp.asarray(x)))


def test_kahan_accumulation_beats_naive_f32():
    """A constant array drifts under naive sequential f32 addition; the
    Kahan loop does not, and sum_pallas adds in f64."""
    n = 200_000
    x = np.full(n, 0.123456789, dtype=np.float32)
    want = float(x.astype(np.float64).sum())
    naive = float(np.cumsum(x)[-1])  # sequential f32
    kahan = float(reduce.kahan_sum(x))
    assert abs(kahan - want) < abs(naive - want)
    assert kahan == pytest.approx(want, rel=1e-6)
    assert float(reduce.sum_pallas(torch.from_numpy(x))) == pytest.approx(
        want, rel=1e-12)


def test_views_and_shapes():
    """Any shape is flattened; a sliced view (misaligned on the card) sums
    its own elements; the plain rows are chunks of PLAIN_CHUNK."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.standard_normal((3, 1000)).astype(np.float32))
    assert float(reduce.sum_pallas(x)) == pytest.approx(
        float(x.double().sum()), rel=1e-12)
    flat = x.reshape(-1)
    view = flat[1:]
    assert float(reduce.sum_pallas(view)) == pytest.approx(
        float(view.double().sum()), rel=1e-12)
    assert float(reduce.sum_pallas(x.T)) == pytest.approx(
        float(x.double().sum()), rel=1e-12)
    big = torch.ones(reduce.PLAIN_CHUNK + 3)
    rows = reduce.tile_partials_plain(big)
    assert rows.shape == (2, 1)
    assert rows[:, 0].tolist() == [float(reduce.PLAIN_CHUNK), 3.0]
    assert reduce.sum_sumsq_partials_plain(torch.zeros(0)).tolist() == [
        [0.0, 0.0]]


def test_rejects_non_f32():
    with pytest.raises(ValueError, match="float32"):
        reduce.sum_pallas(torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="float32"):
        reduce.sum_sumsq_pallas(np.ones(4, np.float32))
