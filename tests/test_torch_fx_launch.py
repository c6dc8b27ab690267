"""The FX kernel #28 (fx_partials_kernel, ``csrc/fx_kernels.cu``): an
instantiation a contract that computes only the terminal values its payoff
reads, P paths a thread in lockstep and their lanes' fold over the block
rows, the paths a thread (read from the CUDA source) and the grid and
contract the wrapper passes.

No card is needed.  A numpy mirror of the kernel's order (P paths a thread
over the grid-stride rounds, each path's f64 [pay, pay^2] in a lane, the
lanes folded as the one-path kernel's tree's top levels, then the warp's
levels) gives the one-path kernel's rows bit for bit, and its sum, on the
plain version's per-path values, the plain version's sum.  A payoff formed
from only the values it reads has the bits of ``fx_vals``, which forms all.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_tpu_torch import rng
from mc_tpu_torch.config import OptionParams
from mc_tpu_torch.models import fx
from mc_tpu_torch.ops import _cuda
from mc_tpu_torch.ops import path_kernels as pk
from test_torch_basket_launch import _thread_sums, _tree
from test_torch_rates_launch import warp_levels

CSRC = Path(fx.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "fx_kernels.cu").read_text()
F32 = np.float32
INF, NAN = float("inf"), float("nan")


def paths_a_thread() -> int:
    return int(re.search(r"constexpr int kFxPaths = (\d+);", SOURCE).group(1))


def block_paths() -> int:
    return int(re.search(r"constexpr int kFxBlockPaths = (\d+);",
                         SOURCE).group(1))


def lane_rows(pay, valid, n_blocks, p, tile=256):
    """The kernel's rows, mirrored: lane q of thread t adds path b*tile + t
    + q*T + r*stride (T = tile/p; a path past the end or the bound adds
    zeros); the lanes fold (q and q + h at the tree's level T*h), then the
    T threads' tree with its warp levels."""
    acc = _thread_sums(pay, valid, n_blocks, tile).reshape(n_blocks, p,
                                                           tile // p, 2)
    h = p // 2
    while h:
        acc[:, :h] += acc[:, h:2 * h]
        h //= 2
    return warp_levels(acc[:, 0])


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("n,n_blocks", [(1, 1), (255, 1), (256, 1), (257, 2),
                                        (4_099, 3), (50_001, 8)])
def test_lanes_keep_the_one_path_rows(p, n, n_blocks):
    """P lanes a thread, folded as the tree's top levels, then the warp's
    levels: the one-path kernel's rows (its 256-wide shared tree) bit for
    bit over ragged path counts, a bound inside the run and several
    grid-stride rounds."""
    rs = np.random.default_rng(p * 1000 + n)
    pay = (rs.lognormal(0.0, 2.0, n) * rs.choice([-1, 1], n)).astype(F32)
    pay[::7] = 0.0
    valid = np.arange(n) < n - n // 9
    acc = _thread_sums(pay, valid, n_blocks).reshape(n_blocks, 256, 2)
    want = _tree(acc)
    assert lane_rows(pay, valid, n_blocks, p).tobytes() == want.tobytes()


def _params(**fields):
    """pack_fx on the CPU of DEMO_OPTION's fields and DEMO_FX's, each
    overridden by ``fields`` (its keys name an option or an FX field)."""
    opt_keys = set(OptionParams.__dataclass_fields__)
    opt = {k: v for k, v in fields.items() if k in opt_keys}
    fxd = {k: v for k, v in fields.items() if k not in opt_keys}
    return fx.pack_fx(OptionParams(**opt),
                      fx.FXDynamics(**{**fx.DEMO_FX.__dict__, **fxd}), "cpu")


def read_only_pay(contract: str, p, z0, z1):
    """The kernel's fx_pay<CONTRACT>: the quanto from S_T alone, GK from
    z_x and X_T alone, compo and flexo from both, each value in fx_vals'
    association."""
    cid = fx.FX_CONTRACTS[contract]
    sign = -1.0 if cid & 1 else 1.0
    kind = cid >> 1

    def s_t():
        return p.s0 * torch.exp(p.drift_s_t + p.vol_s_t * z0)

    def x_t():
        z_x = p.rho * z0 + p.rho_perp * z1
        return p.x0 * torch.exp(p.drift_x_t + p.vol_x_t * z_x)

    if kind == 1:
        return p.x_bar * torch.clamp(sign * (s_t() - p.k), min=0.0)
    x = x_t()
    if kind == 0:
        return torch.clamp(sign * (x - p.kx), min=0.0)
    s = s_t()
    if kind == 2:
        return torch.clamp(sign * (s * x - p.k), min=0.0)
    return x * torch.clamp(sign * (s - p.k), min=0.0)


EDGE_FIELDS = [{}, dict(rho=1.0), dict(rho=-1.0), dict(sigma=0.0),
               dict(sigma_x=0.0), dict(s0=0.0), dict(s0=-0.0), dict(s0=INF),
               dict(s0=NAN), dict(x0=-0.0), dict(x0=INF), dict(x0=NAN),
               dict(r_f=100.0), dict(r=100.0), dict(k=INF), dict(x_bar=NAN)]


@pytest.mark.parametrize("contract", sorted(fx.FX_CONTRACTS))
@pytest.mark.parametrize("fields", EDGE_FIELDS,
                         ids=[str(f) for f in EDGE_FIELDS])
def test_payoff_from_its_own_values_keeps_the_bits(contract, fields):
    """Each contract's payoff formed from only the terminal values it reads
    has fx_vals' bits on seeded pairs (the threefry-13 stream), at +-inf
    and NaN parameters and a drift past expf's range too."""
    p = fx.unpack_fx(_params(**fields))
    ids = torch.arange(4_099, dtype=torch.int64)
    z0, z1 = rng.normal_pair(1234, 5678, ids, torch.zeros_like(ids),
                             rounds=13)
    want = fx.fx_vals(contract, p, z0, z1)
    got = read_only_pay(contract, p, z0, z1)
    assert torch.equal(want.isnan(), got.isnan())
    ok = ~want.isnan()
    assert got[ok].view(torch.int32).equal(want[ok].view(torch.int32))


def _kind_branch(kind: int) -> str:
    """The source of fx_pay's branch that forms ``kind``'s payoff."""
    body = SOURCE[SOURCE.index("__device__ __forceinline__ float fx_pay("):]
    body = body[:body.index("\n}\n")]
    quanto = body[body.index("if constexpr (kKind == 1)"):body.index(
        "} else {")]
    if kind == 1:
        return quanto
    rest = body[body.index("} else {"):]
    gk = rest[rest.index("if constexpr (kKind == 0)"):rest.index(
        "} else {", rest.index("if constexpr (kKind == 0)"))]
    return gk if kind == 0 else rest


def test_each_contract_forms_only_what_it_reads():
    """The quanto's branch forms no z_x and no X_T; GK's none of S_T; the
    compo and flexo form both."""
    q = _kind_branch(1)
    assert "s_t" in q and "z_x" not in q and "x_t" not in q
    assert q.count("expf(") == 1
    gk = _kind_branch(0)
    assert "x_t" in gk and "s_t" not in gk
    both = _kind_branch(2)
    assert "s_t * x_t" in both and "x_t * fmaxf" in both


def test_no_contract_switch_in_the_kernel():
    """The contract is a template parameter picked once on the host: the
    kernel takes no contract argument and holds no switch; mc_fx_partials
    switches over the 8 ids, each to its instantiation under 13 and 20
    rounds."""
    kernel = SOURCE[SOURCE.index("fx_partials_kernel(uint32_t k0"):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert "switch" not in kernel and "contract" not in kernel
    assert "switch" not in SOURCE[SOURCE.index("float fx_pay("):SOURCE.index(
        "fx_partials_kernel(uint32_t k0")]
    assert "#define MC_FX_CONTRACTS(X) X(0) X(1) X(2) X(3) X(4) X(5) X(6) " \
        "X(7)" in SOURCE
    launch = SOURCE[SOURCE.index("cudaError_t launch_fx("):]
    launch = launch[:launch.index("\n}\n")]
    assert "fx_partials_kernel<CONTRACT, 13><<<" in launch
    assert "fx_partials_kernel<CONTRACT, 20><<<" in launch
    entry = SOURCE[SOURCE.index("int mc_fx_partials("):]
    assert "switch (contract)" in entry and "MC_FX_CONTRACTS(MC_CASE)" in entry
    assert sorted(fx.FX_CONTRACTS.values()) == list(range(8))


def test_paths_a_thread_divide_the_block():
    """The paths a thread divide the block's 256 paths into a power of two
    of at least a warp's threads."""
    p = paths_a_thread()
    assert block_paths() == 256
    assert 256 % p == 0 and 256 // p >= 32
    assert (256 // p) & (256 // p - 1) == 0


def test_kernel_structure_in_source():
    """The lanes draw at paths i + q*T with (id, 0) counters, the
    parameters once a thread, a lane past the last path or the bound adds
    zeros, the lanes fold before the warp helper."""
    body = SOURCE[SOURCE.index("fx_partials_kernel(uint32_t k0"):]
    body = " ".join(body[:body.index("\n}\n")].split())
    assert ("normal_pair<ROUNDS>(k0, k1, path_offset + "
            "static_cast<uint32_t>(i + q * T), 0u") in body
    assert body.index("const FxParams p =") < body.index("for (uint64_t i")
    assert "i + q * T < n_paths && id < bound" in body
    assert ("block_store_moments_warp<2, T>(acc[0], partials + 2 * "
            "static_cast<size_t>(blockIdx.x));") in body


@pytest.mark.parametrize("contract", sorted(fx.FX_CONTRACTS))
@pytest.mark.parametrize("n,offset,n_valid", [(257, 0, None),
                                              (4_099, 1_000, 1_000 + 3_001),
                                              (5_000, (1 << 32) - 300, None)])
def test_rows_sum_to_the_plain_version(contract, n, offset, n_valid):
    """On the plain version's per-path values, the kernel's rows (mirrored
    at the source's paths a thread, the grid capped at 3 blocks so blocks
    stride) add to the plain version's sums: f64 rounding apart."""
    params = _params()
    p = fx.unpack_fx(params)
    key = (1234, 5678)
    bound = pk._bound(offset, n, n_valid)
    ids = (offset + torch.arange(n, dtype=torch.int64)) & 0xFFFFFFFF
    z0, z1 = rng.normal_pair(*key, ids, torch.zeros_like(ids), rounds=13)
    pay = fx.fx_vals(contract, p, z0, z1).numpy()
    valid = (ids < bound).numpy()
    rows = lane_rows(pay, valid, min(-(-n // 256), 3), paths_a_thread())
    cfg = fx.FXConfig(n_paths=n)
    plain = fx.fx_partials_plain(contract, cfg, key, params, offset,
                                 n_valid).sum(0)
    np.testing.assert_allclose(rows.sum(0), plain.numpy(), rtol=1e-12,
                               atol=1e-300)


@pytest.mark.parametrize("contract", sorted(fx.FX_CONTRACTS))
@pytest.mark.parametrize("n_paths", [1, 255, 256, 257, 1_000_000,
                                     (1 << 32) - 1])
@pytest.mark.parametrize("tile", [256, 128])
def test_wrapper_passes_the_grid_and_contract(monkeypatch, contract, n_paths,
                                              tile):
    """The wrapper passes the contract's id (its instantiation) and
    ceil(n_paths / the library's paths a block) blocks, capped at
    MAX_BLOCKS, and counts the one launch."""
    seen = []

    class Lib:
        def __getattr__(self, attr):
            if attr == "mc_fx_block_paths":
                return lambda: tile
            if attr == "mc_fx_partials":
                return lambda *args: seen.append(args) or 0
            raise AttributeError(attr)

    monkeypatch.setattr(_cuda, "load", Lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_cuda, "launch_counts",
                        dict.fromkeys(_cuda.KERNELS, 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(fx, "check_fx_params", lambda params: None)
    params = torch.empty(len(fx.FX_FIELDS), device="meta")
    cfg = fx.FXConfig(n_paths=n_paths, rng_source="threefry")
    rows = fx.fx_partials(contract, cfg, (1, 2), params)
    assert len(seen) == 1 and rows.shape == (seen[0][-2], 2)
    assert seen[0][0] == fx.FX_CONTRACTS[contract] and seen[0][1] == 20
    assert seen[0][-2] == min(-(-n_paths // tile), _cuda.MAX_BLOCKS)
    assert _cuda.launch_counts["fx_partials"] == 1
