"""The Bates QE kernel #16 (bates_qe_kernel, ``csrc/bates_qe_kernels.cu``):
its Poisson count against the block's cdf table, the jump-size draw taken
only where a leg's count can be nonzero (the twin's test on 1 - u_n), the
skipped jump's w, and the grid the wrapper computes from the library's
paths a block.

No card is needed.  The numpy f32 mirror of ``poisson_cdf_table`` and of the
count against it (``test_torch_merton_launch``) holds the count to
mc_tpu's scan (``_poisson_inv_cdf``, the parent kernel's
``poisson_inv_cdf``) bit for bit at every depth the kernel takes and at
the uniforms on either side of each cdf step; a mirror of the QE step's
log-price holds the skipped jump (+0 added) to the drawn one bit for bit.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mc_tpu.models import merton as jm

from mc_tpu_torch.models import bates as tb
from mc_tpu_torch.models import merton as tm
from mc_tpu_torch.ops import _cuda, payoffs
from test_torch_localvol_launch import launch_blocks
from test_torch_merton_launch import cdf_table, table_counts

CSRC = Path(tb.__file__).resolve().parents[1] / "csrc"
SRC = (CSRC / "bates_qe_kernels.cu").read_text()
HEADER = (CSRC / "bates.cuh").read_text()
F32 = np.float32
LAM_DTS = (1e-6, 1e-3, 0.003, 0.05, 0.5, 1.0, 2.0, 5.0)


def _steps_uniforms(table: np.ndarray) -> np.ndarray:
    """Each cdf step F(k), the floats on either side of it, and the path
    uniforms' ends (0 and the largest below 1), as path and as twin 1 - u."""
    near = np.concatenate([table, np.nextafter(table, F32(0.0)),
                           np.nextafter(table, F32(1.0)),
                           np.array([0.0, 0.99999994], F32)])
    near = near[(near >= 0.0) & (near < 1.0)]
    return np.unique(np.concatenate([near, (F32(1.0) - near).astype(F32)]))


@pytest.mark.parametrize("kmax", [1, 2, 4, 16, 64, 256, None])
@pytest.mark.parametrize("lam_dt", LAM_DTS)
def test_table_count_is_the_scan_at_every_step(lam_dt, kmax):
    """The count against the block's table is the scan's bit for bit at
    kmax 1-256 (None: poisson_kmax's depth) and lam*dt 1e-6-5, at the
    uniforms on either side of every cdf step and at their 1 - u."""
    kmax = kmax or tm.poisson_kmax(lam_dt)
    table = cdf_table(lam_dt, kmax)
    u = _steps_uniforms(table)
    want = np.asarray(jm._poisson_inv_cdf(jnp.asarray(u), jnp.float32(lam_dt),
                                          kmax))
    got = table_counts(table, u)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("lam_dt", LAM_DTS)
def test_twin_draws_where_one_minus_u_reaches_the_table(lam_dt):
    """The kernel draws the step's jump size where !(u_n < F_min) or, for
    the antithetic twin, !(1 - u_n < F_min), F_min the table's least entry
    (its F(0)): wherever either leg's count is nonzero the test holds, and
    where it fails both counts are +0."""
    kmax = tm.poisson_kmax(lam_dt)
    table = cdf_table(lam_dt, kmax)
    f_min = table.min()
    assert f_min == table[0]
    u = np.unique(np.concatenate([
        np.linspace(0.0, 0.99999994, 400_001, dtype=F32),
        _steps_uniforms(table),
        np.nextafter(F32(1.0) - f_min, F32(0.0))[None],
        (F32(1.0) - f_min)[None]]))
    twin = (F32(1.0) - u).astype(F32)
    draw = ~(u < f_min) | ~(twin < f_min)
    n, n_twin = table_counts(table, u), table_counts(table, twin)
    assert ((n != 0) | (n_twin != 0))[~draw].sum() == 0
    assert not n[~draw].view(np.uint32).any()
    assert not n_twin[~draw].view(np.uint32).any()
    assert (n_twin[draw & (u < f_min)] != 0).any()  # the twin alone draws


def _walk(steps, paths, mu_j, sigma_j, skip, seed):
    """A QE path's log-price over the steps (f32, the kernel's association):
    the diffusion w = (((w + g) + k0) + k2 v') + sqrt(var) z, then w + jump,
    the jump n*mu_j + (sigma_j*sqrt(n))*e; with ``skip`` +0 where the count
    is 0 (as the kernel adds where no leg's uniform reaches the table).  The
    terms include +-0, so sums meet -0."""
    g = np.random.default_rng(seed)
    shape = (steps, paths)
    terms = [g.normal(0.0, 0.01, shape).astype(F32) for _ in range(4)]
    for t in terms:  # signed zeros among the diffusion's terms
        t[:, ::7] = F32(-0.0)
        t[:, 3::11] = F32(0.0)
    e = g.standard_normal(shape).astype(F32)
    e[:, 1::5] = F32(-0.0)
    n = (g.random(shape) < 0.05).astype(F32)
    w = np.zeros(paths, F32)
    ws = []
    with np.errstate(all="ignore"):
        for j in range(steps):
            w = (((w + terms[0][j]) + terms[1][j]) + terms[2][j]) \
                + terms[3][j]
            jump = (n[j] * F32(mu_j) + (F32(sigma_j) * np.sqrt(n[j])) * e[j])
            if skip:
                jump = np.where(n[j] == 0, F32(0.0), jump)
            w = (w + jump.astype(F32)).astype(F32)
            ws.append(w.copy())
    return np.stack(ws)


@pytest.mark.parametrize("mu_j,sigma_j", [(-0.1, 0.15), (0.1, 0.15),
                                          (-0.0, 0.15), (0.0, 0.15),
                                          (-0.1, 0.0), (-0.1, -0.0),
                                          (0.0, 0.0), (-0.0, -0.0),
                                          (-3e38, 3e38)])
def test_skipped_jump_keeps_w_and_s_bitwise(mu_j, sigma_j):
    """Adding +0 where the count is 0 keeps every w of the path, and so S =
    s0 exp(w), bit for bit: w starts at +0 and a sum is -0 only when both
    its terms are, so no w is -0 (+0 and -0 jumps, w + +-0 = w)."""
    drawn = _walk(40, 4096, mu_j, sigma_j, skip=False, seed=11)
    skipped = _walk(40, 4096, mu_j, sigma_j, skip=True, seed=11)
    np.testing.assert_array_equal(skipped.view(np.uint32),
                                  drawn.view(np.uint32))
    assert not (np.signbit(drawn) & (drawn == 0)).any()
    with np.errstate(over="ignore"):
        s = (F32(100.0) * np.exp(drawn)).astype(F32)
        s_skip = (F32(100.0) * np.exp(skipped)).astype(F32)
    np.testing.assert_array_equal(s_skip.view(np.uint32), s.view(np.uint32))


@pytest.mark.parametrize("mu_j,sigma_j", [(np.inf, 0.15), (-np.inf, 0.15),
                                          (np.nan, 0.15), (-0.1, np.inf),
                                          (-0.1, -np.inf), (-0.1, np.nan)])
def test_non_finite_jump_parameters_draw_every_step(mu_j, sigma_j):
    """A count of 0 gives a NaN jump where mu_j or sigma_j is not finite
    (0*inf), so the kernel draws every step there (its ``always``): the
    skipped walk would lose the NaN."""
    drawn = _walk(8, 256, mu_j, sigma_j, skip=False, seed=12)
    skipped = _walk(8, 256, mu_j, sigma_j, skip=True, seed=12)
    assert np.isnan(drawn[-1]).all()  # a NaN stays a NaN
    assert not np.isnan(skipped[-1]).all()  # the skip would lose it
    assert "!(isfinite(b.mu_j) && isfinite(b.sigma_j))" in SRC


def test_kernel_source_terms():
    """The source's own terms: the table's capacity the deepest scan
    BatesConfig takes, its least entry after it, the jump-size pair at
    counter 4j+2 drawn under the test, the Poisson uniform at 4j+3, the QE
    uniform through the lazy draw at 4j+1, plain and antithetic apart."""
    cap = int(re.search(r"constexpr int kBatesMaxKmax = (\d+);",
                        HEADER).group(1))
    assert cap == tm.MAX_KMAX == 256
    assert "cdf[kmax] = f_min;" in SRC
    assert "const float f_min = cdf[kmax];" in SRC
    assert re.search(r"if \(jumps\) \{\s+float e\[L\], n\[L\], unused;\s+"
                     r"normal_pair<ROUNDS>\(k0, k1, id, c \+ 2u", SRC)
    assert "unit_draw<ROUNDS>(k0, k1, id, c + 3u)" in SRC
    assert "unit_draw<ROUNDS>(k0, k1, id, c + 1u)" in SRC
    assert "u_n[1] = 1.0f - u_n[0];" in SRC
    assert "bates_qe_kernel<Payoff, R, A>" in SRC


@pytest.mark.parametrize("scheme", ["euler", "qe"])
@pytest.mark.parametrize("tile", [256, 128])
@pytest.mark.parametrize("n_paths", [1, 255, 256, 257, 1_000_000,
                                     (1 << 32) - 1])
def test_wrapper_reads_the_librarys_paths_a_block(monkeypatch, n_paths, tile,
                                                  scheme):
    """The grid is ceil(n_paths / the library's paths a block), capped at
    MAX_BLOCKS (the kernels grid-stride past it); one launch counted."""
    cfg = tb.BatesConfig(n_paths=n_paths, n_steps=100, kmax=4, scheme=scheme)
    params = torch.empty(len(tb.BATES_FIELDS), device="meta")
    got = launch_blocks(
        monkeypatch, tb, "bates", tile,
        lambda: tb.bates_partials(payoffs.get_payoff("vanilla_call"), cfg,
                                  (1, 2), params))
    assert got == min(-(-n_paths // tile), _cuda.MAX_BLOCKS)
