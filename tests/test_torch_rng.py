"""mc_tpu_torch.rng against mc_tpu.rng: the stream the port shares.

Parity contract: threefry words and derived keys are bitwise equal; the
Box-Muller normals differ only through each framework's f32 log1p/cos/sin
(measured: ~92% bitwise, at most 3 ulp apart), so they are held to 4 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_tpu import rng as jrng
from mc_tpu_torch import rng

torch.set_num_threads(1)

# Official Random123 known-answer vectors for threefry2x32, 20 rounds.
KAT = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344),
     (0xC4923A9C, 0x483DF7A0)),
]


def _counters(n=1 << 16, seed=0):
    rs = np.random.default_rng(seed)
    c0 = rs.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    c1 = rs.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return c0, c1


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("ctr,key,expected", KAT)
def test_threefry_known_answers(ctr, key, expected):
    a, b = rng.threefry2x32(key[0], key[1], torch.tensor([ctr[0]]),
                            torch.tensor([ctr[1]]))
    assert (int(a), int(b)) == expected


@pytest.mark.parametrize("ctr,key,expected", KAT)
def test_threefry_numpy_mirror(ctr, key, expected):
    a, b = rng._threefry_scalar_np(np.uint32(key[0]), np.uint32(key[1]),
                                   np.uint32(ctr[0]), np.uint32(ctr[1]))
    assert (int(a), int(b)) == expected


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry_bitwise_vs_mc_tpu(rounds):
    c0, c1 = _counters()
    k = jrng.derive_key(99, 5)
    ja, jb = jrng.threefry2x32(jnp.uint32(k[0]), jnp.uint32(k[1]),
                               jnp.asarray(c0), jnp.asarray(c1), rounds=rounds)
    ta, tb = rng.threefry2x32(int(k[0]), int(k[1]), _t(c0), _t(c1),
                              rounds=rounds)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja).astype(np.int64))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).astype(np.int64))


@pytest.mark.parametrize("seed,tags", [
    (1234, ()), (1234, (0,)), (1234, (1,)), (0, (7, 3)), (-1, ()),
    (-1234, (1,)), (2**40 + 17, (2**33 + 5,)), (-(2**63), (-1,)),
])
def test_derive_key_matches_mc_tpu(seed, tags):
    want = jrng.derive_key(seed, *tags)
    got = rng.derive_key(seed, *tags)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))


def test_bits_to_unit_bitwise():
    c0, _ = _counters(4096, seed=1)
    bits = np.concatenate([c0, np.array([0, 0xFFFFFFFF, 1 << 31], np.uint32)])
    want = np.asarray(jrng.bits_to_unit(jnp.asarray(bits)))
    got = rng.bits_to_unit(_t(bits)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("rounds", [13, 20])
def test_normals_within_4_ulp(rounds):
    c0, c1 = _counters(seed=rounds)
    k = jrng.derive_key(1234, 0)
    jz = jrng.normal_pair(jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray(c0),
                          jnp.asarray(c1), rounds=rounds)
    tz = rng.normal_pair(int(k[0]), int(k[1]), _t(c0), _t(c1), rounds=rounds)
    for j, t in zip(jz, tz):
        j = np.asarray(j)
        t = t.numpy()
        assert t.dtype == np.float32
        # Same sign and binade almost everywhere, so the int32 views differ
        # by the distance in ulp.
        ulp = np.abs(j.view(np.int32).astype(np.int64)
                     - t.view(np.int32).astype(np.int64))
        assert ulp.max() <= 4, ulp.max()
        assert (ulp == 0).mean() > 0.8


def test_normals_stack_follows_pair_convention():
    key = rng.derive_key(7)
    ids = torch.arange(64, dtype=torch.int64)
    z = rng.normals(key, ids, n_draws=5)
    assert z.shape == (5, 64)
    z0, z1 = rng.normal_pair(int(key[0]), int(key[1]), ids,
                             torch.full_like(ids, 1))
    torch.testing.assert_close(z[2], z0, rtol=0, atol=0)
    torch.testing.assert_close(z[3], z1, rtol=0, atol=0)
    with pytest.raises(ValueError):
        rng.normals(key, ids, 2, draw_offset=1)


def test_normals_are_standard():
    z = rng.normals(rng.derive_key(3), torch.arange(1 << 15), n_draws=2)
    assert abs(float(z.mean())) < 0.02
    assert abs(float(z.std()) - 1.0) < 0.02
