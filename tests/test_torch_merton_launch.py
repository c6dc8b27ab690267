"""The Merton partials kernel #14 (merton_partials_kernel,
``csrc/merton_kernels.cu``): its Poisson count against the block's cdf
table, the jump-size draw taken only where a count can be nonzero, the
depths the kernel takes, and the grid the wrapper computes from the
library's paths a block.

No card is needed.  A numpy f32 mirror of ``poisson_cdf_table`` and of the
count against it holds the count to mc_tpu's scan (``_poisson_inv_cdf``)
bit for bit on a 200,001-point grid of u and of 1-u; a mirror of the Euler
step's log-moneyness holds the skipped jump (+0 added) to the drawn one bit
for bit.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_tpu.models import merton as jm

from mc_tpu_torch.models import merton as tm
from mc_tpu_torch.ops import _cuda, payoffs
from test_torch_localvol_launch import launch_blocks

CSRC = Path(tm.__file__).resolve().parents[1] / "csrc"
SRC = (CSRC / "merton_kernels.cu").read_text()
LAMS = (0.003, 0.03, 0.3, 2.0, 17.0)
F32 = np.float32


def cdf_table(lam: float, kmax: int) -> np.ndarray:
    """poisson_cdf_table (csrc/merton.cuh) in f32: F(0..kmax-1) by the
    scan's recurrence pmf = (pmf*lam)/k, cdf += pmf, in its order; F(0) =
    exp(-lam) through mc_tpu's exp (the scan's own first value)."""
    lam32 = F32(lam)
    pmf = np.asarray(jnp.exp(-jnp.float32(lam)), F32)
    cdf = pmf
    out = np.empty(kmax, F32)
    for k in range(kmax):
        out[k] = cdf
        pmf = F32(F32(pmf * lam32) / F32(k + 1))
        cdf = F32(cdf + pmf)
    return out


def table_counts(table: np.ndarray, u: np.ndarray) -> np.ndarray:
    """poisson_counts: n = 0, then n + (u >= F(k) ? 1 : 0) for k in order."""
    n = np.zeros_like(u, F32)
    for f in table:
        n = (n + np.where(u >= f, F32(1.0), F32(0.0))).astype(F32)
    return n


def _grid(side: str) -> np.ndarray:
    u = np.concatenate([np.linspace(0.0, 1.0, 200_001, dtype=F32),
                        F32(0.99999994)[None]])
    return u if side == "u" else (F32(1.0) - u).astype(F32)


@pytest.mark.parametrize("side", ["u", "1-u"])
@pytest.mark.parametrize("lam", LAMS)
def test_table_count_is_the_scan_bitwise(lam, side):
    """The count against the table is mc_tpu's scan bit for bit, for the
    path's uniform and its antithetic 1-u; below the table's least entry
    (the kernel's test for drawing the jump sizes) it is +0."""
    u = _grid(side)
    kmax = tm.poisson_kmax(lam)
    want = np.asarray(jm._poisson_inv_cdf(jnp.asarray(u), jnp.float32(lam),
                                          kmax))
    table = cdf_table(lam, kmax)
    got = table_counts(table, u)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    below = u < table.min()
    assert below.any()
    assert not got[below].view(np.uint32).any()  # +0, every one


@pytest.mark.parametrize("kmax", [1, 4, 10, 53, 256])
def test_table_at_any_depth(kmax):
    """The kernel's depths (kmax = 1 .. 256): the table's count is the scan's
    at lam*dt = 0.003 (kmax 4), 0.3 (10) and 17 (53), and at any kmax."""
    lam = {1: 0.003, 4: 0.003, 10: 0.3, 53: 17.0, 256: 100.0}[kmax]
    u = _grid("u")
    want = np.asarray(jm._poisson_inv_cdf(jnp.asarray(u), jnp.float32(lam),
                                          kmax))
    got = table_counts(cdf_table(lam, kmax), u)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_table_fits_the_kernels_shared_array():
    """The kernel's shared table holds kMertonMaxKmax entries and its least
    entry: the deepest scan MertonConfig takes (tm.MAX_KMAX)."""
    cap = int(re.search(r"constexpr int kMertonMaxKmax = (\d+);",
                        SRC).group(1))
    assert cap == tm.MAX_KMAX == 256


@pytest.mark.parametrize("kmax", [-1, 0, 257, 1000])
@pytest.mark.parametrize("method", ["euler", "terminal"])
def test_config_refuses_a_depth_the_table_cannot_hold(method, kmax):
    with pytest.raises(ValueError, match="kmax"):
        tm.MertonConfig(n_paths=1000, n_steps=100, kmax=kmax, method=method)


@pytest.mark.parametrize("kmax", [1, 256])
def test_config_takes_every_depth_the_table_holds(kmax):
    assert tm.MertonConfig(n_paths=1000, n_steps=100, kmax=kmax).kmax == kmax


@pytest.mark.parametrize("mu_j,sigma_j", [(-0.1, 0.15), (0.1, 0.15),
                                          (-0.0, 0.0), (0.0, 0.0),
                                          (-0.1, -0.15), (-3e38, 3e38)])
def test_zero_count_jump_is_a_signed_zero(mu_j, sigma_j):
    """n = 0: n*mu_j + (sigma_j*sqrt(n))*e is +0 or -0 for every finite e
    and finite mu_j, sigma_j (the kernel's premise for not drawing e)."""
    e = np.concatenate([np.linspace(-8.0, 8.0, 4001, dtype=F32),
                        np.array([-0.0, 0.0, -3e38, 3e38], F32)])
    n = F32(0.0)
    with np.errstate(over="ignore"):
        jump = (n * F32(mu_j)
                + (F32(sigma_j) * np.sqrt(n)) * e).astype(F32)
    assert not jump.any()


def _walk(drift, vol, z, e, n, skip):
    """The Euler step's log-moneyness over the steps (f32, the kernel's
    association): w = ((w + drift) + vol*z) + jump, the jump +0 where the
    count is 0 and ``skip``."""
    w = np.zeros(z.shape[1], F32)
    out = []
    for j in range(z.shape[0]):
        jump = (n[j] * F32(-0.1) + (F32(0.15) * np.sqrt(n[j])) * e[j]).astype(F32)
        if skip:
            jump = np.where(n[j] == 0, F32(0.0), jump).astype(F32)
        w = (((w + F32(drift)).astype(F32) + (F32(vol) * z[j]).astype(F32))
             .astype(F32) + jump).astype(F32)
        out.append(w.copy())
    return np.stack(out)


@pytest.mark.parametrize("drift", [-0.0, 0.0, -1e-3, 1e-3])
@pytest.mark.parametrize("vol", [0.0, 0.02])
def test_skipped_jump_keeps_w_bitwise(drift, vol):
    """Adding +0 where the count is 0 keeps every w of the path bit for bit:
    w starts at +0 and a sum is -0 only when both its terms are, so no w is
    ever -0 (z includes +-0, so w + drift and vol*z meet -0)."""
    rs = np.random.default_rng(7)
    steps, paths = 40, 4096
    z = rs.standard_normal((steps, paths)).astype(F32)
    z[:, ::7] = F32(-0.0)
    z[:, 3::7] = F32(0.0)
    e = rs.standard_normal((steps, paths)).astype(F32)
    e[:, 1::5] = F32(-0.0)
    n = (rs.random((steps, paths)) < 0.05).astype(F32)
    drawn = _walk(drift, vol, z, e, n, skip=False)
    skipped = _walk(drift, vol, z, e, n, skip=True)
    np.testing.assert_array_equal(skipped.view(np.uint32),
                                  drawn.view(np.uint32))
    assert not (np.signbit(drawn) & (drawn == 0)).any()


@pytest.mark.parametrize("method", ["euler", "terminal"])
@pytest.mark.parametrize("tile", [256, 128])
@pytest.mark.parametrize("n_paths", [1, 255, 256, 257, 1_000_000,
                                     (1 << 32) - 1])
def test_wrapper_reads_the_librarys_paths_a_block(monkeypatch, n_paths, tile,
                                                  method):
    """The grid is ceil(n_paths / the library's paths a block), capped at
    MAX_BLOCKS (the kernel grid-strides past it)."""
    cfg = tm.MertonConfig(n_paths=n_paths, n_steps=100, kmax=4, method=method)
    params = torch.empty(len(tm.MERTON_FIELDS), device="meta")
    got = launch_blocks(
        monkeypatch, tm, "merton", tile,
        lambda: tm.merton_partials(payoffs.get_payoff("vanilla_call"), cfg,
                                   (1, 2), params))
    assert got == min(-(-n_paths // tile), _cuda.MAX_BLOCKS)
