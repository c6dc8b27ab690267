"""The rainbow kernel #27 (rainbow_partials_kernel,
``csrc/rainbow_partials.cuh``): the capacity that fits d, plain and
antithetic kernels apart, P paths a thread in lockstep and their lanes'
fold over the block rows, the paths a thread (read from the CUDA source)
and the grid, d and mode the wrapper passes.

No card is needed.  A numpy mirror of the kernel's order (P paths a thread
over the grid-stride rounds, each path's f64 [pay, pay^2] in a lane, the
lanes folded as the one-path kernel's tree's top levels, then the warp's
levels) gives the one-path kernel's rows bit for bit, and its sum, on the
plain version's per-path values, the plain version's sum.  The antithetic
leg's prices from -y are the plain version's prices of the negated normals
bit for bit.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.models import basket as bm
from mc_tpu_torch.models import rainbow as rb
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops import path_kernels as pk
from test_torch_basket_launch import _thread_sums, _tree
from test_torch_fx_launch import lane_rows

torch.set_num_threads(1)

CSRC = Path(rb.__file__).resolve().parents[1] / "csrc"
HEADER = (CSRC / "rainbow_partials.cuh").read_text()
ENTRY = (CSRC / "rainbow_kernels.cu").read_text()
F32 = np.float32
INF, NAN = float("inf"), float("nan")
KEY = (1234, 5678)


def paths_a_thread(capacity: int) -> int:
    """rainbow_paths_per_thread of the source: P up to capacity C, 1
    above."""
    m = re.search(r"int rainbow_paths_per_thread\(int kMaxD\) \{\n  return "
                  r"kMaxD <= (\d+) \? (\d+) : 1;", HEADER)
    return int(m.group(2)) if capacity <= int(m.group(1)) else 1


def block_paths() -> int:
    return int(re.search(r"constexpr int kRainbowBlockPaths = (\d+);",
                         HEADER).group(1))


def basket_capacity(d: int) -> int:
    """basket_partials.cuh's basket_capacity, the one the entry point
    switches on."""
    return 4 if d <= 4 else 8 if d <= 8 else 16 if d <= 16 else 32


def _body(name: str) -> str:
    """The source of the kernel or function ``name`` of the header, one
    line of whitespace-collapsed text."""
    body = HEADER[HEADER.index(name):]
    return " ".join(body[:body.index("\n}\n")].split())


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("n,n_blocks", [(1, 1), (255, 1), (256, 1), (257, 2),
                                        (4_099, 3), (50_001, 8)])
def test_lanes_keep_the_one_path_rows(p, n, n_blocks):
    """P lanes a thread, folded as the tree's top levels, then the warp's
    levels: the one-path kernel's rows (its 256-wide shared tree) bit for
    bit over ragged path counts, a bound inside the run and several
    grid-stride rounds."""
    rs = np.random.default_rng(p * 7 + n)
    pay = (rs.lognormal(0.0, 1.5, n) * rs.choice([0, 1], n)).astype(F32)
    valid = np.arange(n) < n - n // 5
    want = _tree(_thread_sums(pay, valid, n_blocks).reshape(n_blocks, 256, 2))
    assert lane_rows(pay, valid, n_blocks, p).tobytes() == want.tobytes()


@pytest.mark.parametrize("capacity", [4, 8, 16, 32])
def test_paths_a_thread_divide_the_block(capacity):
    """Each capacity's paths a thread divide the block's 256 paths into a
    power of two of at least a warp's threads; capacity 32 runs one."""
    p = paths_a_thread(capacity)
    t = block_paths() // p
    assert block_paths() == 256 and 256 % p == 0 and t >= 32
    assert t & (t - 1) == 0
    assert "static_assert(kMaxD < 32 || P == 1" in HEADER


def test_capacity_dispatch_through_basket_capacity():
    """mc_rainbow_partials picks the capacity of d by basket_capacity alone,
    the capacities' launchers defined in two sources (4 and 8 beside the
    dispatch, 16 and 32 apart), so nvcc builds them in parallel."""
    basket = (CSRC / "basket_partials.cuh").read_text()
    assert ("return d <= 4 ? 4 : d <= 8 ? 8 : d <= 16 ? 16 : 32;"
            in basket)
    assert [basket_capacity(d) for d in (1, 4, 5, 8, 9, 16, 17, 32)] == \
        [4, 4, 8, 8, 16, 16, 32, 32]
    entry = ENTRY[ENTRY.index("int mc_rainbow_partials("):]
    entry = " ".join(entry[:entry.index("\n}\n")].split())
    assert "switch (mc::basket_capacity(d)) {" in entry
    for cap in (4, 8, 16):
        assert f"case {cap}: return mc::rainbow_partials_{cap}(" in entry
    assert "default: return mc::rainbow_partials_32(" in entry
    wide = (CSRC / "rainbow32_kernels.cu").read_text()
    for cap, src in ((4, ENTRY), (8, ENTRY), (16, wide), (32, wide)):
        assert f"MC_DEFINE_RAINBOW_PARTIALS({cap})" in src
    assert "MC_DEFINE_RAINBOW_PARTIALS" not in ENTRY.replace(
        "MC_DEFINE_RAINBOW_PARTIALS(4)", "").replace(
        "MC_DEFINE_RAINBOW_PARTIALS(8)", "")
    cuda_py = Path(_cuda.__file__).read_text()
    assert '"rainbow_kernels.cu"' in cuda_py
    assert '"rainbow32_kernels.cu"' in cuda_py


def test_no_runtime_antithetic_test_in_the_path_loop():
    """The antithetic leg is a template parameter picked on the host: the
    kernel takes no antithetic argument and its path loop tests no flag;
    the launcher passes the plain call to the plain kernel and the
    antithetic call to the antithetic one."""
    kernel = _body("rainbow_partials_kernel(int payoff")
    assert "antithetic" not in kernel and "if (A)" not in kernel
    for fn in ("void rainbow_paths(", "float rainbow_path32(",
               "void rainbow_fold(", "float rainbow_path_pay("):
        assert "antithetic" not in _body(fn)
    define = HEADER[HEADER.index("#define MC_DEFINE_RAINBOW_PARTIALS"):]
    define = " ".join(define[:define.index("MC_DECLARE_RAINBOW_PARTIALS(4)")]
                      .split())
    assert "return antithetic ? launch_rainbow<CAP, true>(" in define
    assert ": launch_rainbow<CAP, false>(" in define


def test_kernel_structure_in_source():
    """The lanes run paths i + p*T, the pack is read once a thread before
    the loop (staged in shared memory at capacity 32), a lane past the last
    path or the bound adds zeros, the lanes fold before the warp helper."""
    body = _body("rainbow_partials_kernel(int payoff")
    assert ("id[p] = path_offset + static_cast<uint32_t>(i + p * T);"
            in body)
    assert body.index("load_basket<kMaxD>(params, d)") < body.index(
        "for (uint64_t i")
    assert body.index("c = load_basket<32>(pack, d);") < body.index(
        "for (uint64_t i")
    assert "i + p * T < n_paths && id[p] < bound" in body
    assert ("block_store_moments_warp<2, T>(acc[0], partials + 2 * "
            "static_cast<size_t>(blockIdx.x));") in body
    lanes = _body("void rainbow_paths(")
    # each Cholesky row, s0 and drift read once for the P lanes
    assert lanes.count("__ldg(") == 4
    assert "basket_draw<kMaxD, ROUNDS>(c, k0, k1, id[p], 0u, 1.0f, z[p]);" \
        in lanes


def _paths(name, d, anti, n, offset=0, fix=()):
    """(per-path pay, valid) of the plain version's arithmetic."""
    opt = OptionParams()
    params = bm.pack_basket(opt, bm.demo_basket(d, 0.5), 1, "cpu")
    for i, v in fix:
        params[i] = v
    p = bm.unpack_basket(params, d)
    ids = (offset + torch.arange(n, dtype=torch.int64)) & 0xFFFFFFFF
    zs = rb.rainbow_normals(*KEY, ids, d, 13)
    pay = rb.rainbow_pay(name, p, rb.rainbow_levels(p, zs))
    if anti:
        pay = 0.5 * (pay + rb.rainbow_pay(name, p, rb.rainbow_levels(p, -zs)))
    return params, pay.numpy(), ids


@pytest.mark.parametrize("name", sorted(rb.RAINBOW_PAYOFFS))
@pytest.mark.parametrize("d", [2, 5, 17])
@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("n,offset,n_valid", [(257, 0, None),
                                              (4_099, 1_000, 1_000 + 3_001),
                                              (3_000, (1 << 32) - 300, None)])
def test_rows_sum_to_the_plain_version(name, d, anti, n, offset, n_valid):
    """On the plain version's per-path values, the kernel's rows (mirrored
    at the source's paths a thread for d's capacity, the grid capped at 3
    blocks so blocks stride) add to the plain version's sums: f64 rounding
    apart."""
    params, pay, ids = _paths(name, d, anti, n, offset)
    bound = pk._bound(offset, n, n_valid)
    valid = (ids < bound).numpy()
    rows = lane_rows(pay, valid, min(-(-n // 256), 3),
                     paths_a_thread(basket_capacity(d)))
    cfg = rb.RainbowConfig(n_paths=n, d=d, antithetic=anti)
    plain = rb.rainbow_partials_plain(name, cfg, KEY, params, offset,
                                      n_valid).sum(0)
    np.testing.assert_allclose(rows.sum(0), plain.numpy(), rtol=1e-12,
                               atol=1e-300)


# the pack entry an edge sets: the last asset's s0, asset 0's drift, L's
# last row's first entry
FIELDS = {"s0": lambda d: 10 + d - 1, "drift": lambda d: 10 + 2 * d,
          "chol": lambda d: 10 + 3 * d + (d - 1) * d // 2}


@pytest.mark.parametrize("d", [1, 2, 4, 9, 32])
@pytest.mark.parametrize("fix", [None, ("s0", INF), ("s0", NAN),
                                 ("drift", -INF), ("chol", NAN)])
def test_antithetic_leg_is_the_draws_minus_y(d, fix):
    """The antithetic kernel prices asset i at s0_i expf(drift_i + sqrt_T *
    -y_i), y_i the + leg's mix: bit for bit the plain version's prices of
    the negated normals (a product and a sum of negated terms round to the
    negated result), at +-inf and NaN entries of the pack too."""
    params = bm.pack_basket(OptionParams(), bm.demo_basket(d, 0.5), 1, "cpu")
    if fix:
        params[FIELDS[fix[0]](d)] = fix[1]
    p = bm.unpack_basket(params, d)
    ids = torch.arange(2_048, dtype=torch.int64)
    zs = rb.rainbow_normals(*KEY, ids, d, 13)
    y = p.chol[:, :1] * zs[0]
    for k in range(1, d):
        y[k:] = y[k:] + p.chol[k:, k:k + 1] * zs[k]
    s0s, drifts = p.s0s[:, None], p.drifts[:, None]
    got = s0s * torch.exp(drifts + p.sqrt_dt * -y)
    want = rb.rainbow_levels(p, -zs)
    assert torch.equal(got.isnan(), want.isnan())
    ok = ~want.isnan()
    assert got[ok].view(torch.int32).equal(want[ok].view(torch.int32))


@pytest.mark.parametrize("name", sorted(rb.RAINBOW_PAYOFFS))
@pytest.mark.parametrize("d", [2, 4, 9, 32])
@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("n_paths", [1, 257, 1_000_000, (1 << 32) - 1])
def test_wrapper_passes_the_grid_d_and_mode(monkeypatch, name, d, anti,
                                            n_paths):
    """The wrapper passes the payoff's id, the rounds, the antithetic flag
    (its kernel) and d (its capacity, picked in the library), and
    ceil(n_paths / the library's paths a block) blocks, capped at
    MAX_BLOCKS, and counts the one launch."""
    seen = []

    class Lib:
        def __getattr__(self, attr):
            if attr == "mc_rainbow_block_paths":
                return lambda: 256
            if attr == "mc_rainbow_partials":
                return lambda *args: seen.append(args) or 0
            raise AttributeError(attr)

    monkeypatch.setattr(_cuda, "load", Lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_cuda, "launch_counts",
                        dict.fromkeys(_cuda.KERNELS, 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(rb, "check_basket_params", lambda params, d: None)
    params = torch.empty(bm.packed_length(d), device="meta")
    cfg = rb.RainbowConfig(n_paths=n_paths, d=d, antithetic=anti,
                           rng_source="threefry")
    rows = rb.rainbow_partials(name, cfg, (1, 2), params, 5, n_paths - 1)
    assert len(seen) == 1 and rows.shape == (seen[0][-2], 2)
    args = seen[0]
    assert args[:3] == (rb.RAINBOW_PAYOFFS[name][0], 20, int(anti))
    assert args[6] == d and args[7] == n_paths and args[8:10] == (
        5, n_paths - 1)
    assert args[-2] == min(-(-n_paths // 256), _cuda.MAX_BLOCKS)
    assert _cuda.launch_counts["rainbow_partials"] == 1


def test_normals_pair_layout():
    """rainbow_normals' z_{2q}, z_{2q+1} are pair q of counter (id, q), the
    layout basket_draw writes at base 0 and rainbow_path32 stages."""
    ids = torch.arange(300, dtype=torch.int64)
    zs = rb.rainbow_normals(*KEY, ids, 5, 20)
    for q in range(3):
        z0, z1 = rng.normal_pair(*KEY, ids, torch.full_like(ids, q), rounds=20)
        assert torch.equal(zs[2 * q], z0)
        if 2 * q + 1 < 5:
            assert torch.equal(zs[2 * q + 1], z1)
