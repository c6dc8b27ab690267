"""The rates kernel #11 (rates_partials_kernel, ``csrc/rates_kernels.cu``
and the tiles of ``csrc/rates.cuh``): its lanes and their fold, the warp's
levels of the block tree (``reduce.cuh`` block_store_moments_warp), the
per-payment layout a block stages its pack in, the paths a thread (read
from the CUDA source), the bond loop's staged path, the launcher's
choice of it by n, and the grid the wrapper passes.

No card is needed.  A numpy mirror of the kernel's order (P lanes a thread
over the grid-stride rounds, folded as the 256-wide tree's top levels, the
rest of the tree in shared memory and by warp shuffles) gives
``fused.block_rows``' rows bit for bit; a mirror of the staging returns,
for every tile, the table entries that the flat pack's offsets hold, which
the plain payoffs read.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mc_tpu_torch.ops import _cuda, fused

CSRC = Path(fused.__file__).resolve().parents[1] / "csrc"
KERNEL = (CSRC / "rates_kernels.cu").read_text()
TILES_SRC = (CSRC / "rates.cuh").read_text()
REDUCE = (CSRC / "reduce.cuh").read_text()
F32 = np.float32
STRUCTS = {"va": "VaSwpt", "hw": "HwSwpt", "hw_mc": "HwSwptMc",
           "g2": "G2Swpt", "g2_mc": "G2SwptMc"}


def paths_a_thread() -> int:
    return int(re.search(r"constexpr int kRatesPaths = (\d+);", KERNEL)
               .group(1))


def stage_payments() -> int:
    return int(re.search(r"constexpr int kRatesStagePayments = (\d+);",
                         KERNEL).group(1))


# --- the block tree's warp levels -------------------------------------------


def warp_levels(sums):
    """block_store_moments_warp over the last-but-one axis (THREADS, a power
    of two of at least 32): the levels above 32 as the shared tree, then
    lane t of warp 0 takes t + 32's sum and, for s = 16 .. 1, the value
    __shfl_down_sync(v, s) gives (lane t + s's, or its own past lane 31)."""
    sh = np.array(sums, dtype=np.float64)
    threads = sh.shape[-2]
    s = threads // 2
    while s > 32:
        sh[..., :s, :] += sh[..., s:2 * s, :]
        s //= 2
    v = sh[..., :32, :] + sh[..., 32:64, :] if threads > 32 else sh.copy()
    for s in (16, 8, 4, 2, 1):
        down = np.concatenate([v[..., s:, :], v[..., 32 - s:, :]], axis=-2)
        v = v + down
    return v[..., 0, :]


def shared_tree(sums):
    """reduce.cuh block_store_moments' tree: thread t adds t + s for s =
    THREADS/2 .. 1 (the same as test_torch_basket_launch._tree)."""
    sh = np.array(sums, dtype=np.float64)
    s = sh.shape[-2] // 2
    while s:
        sh[..., :s, :] += sh[..., s:2 * s, :]
        s //= 2
    return sh[..., 0, :]


@pytest.mark.parametrize("threads", [32, 64, 128, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_levels_pair_threads_as_the_shared_tree(threads, seed):
    """The shuffles pair lane t with t + s as the shared tree pairs thread t
    with t + s: the row bit for bit, on sums of mixed sign and magnitude
    (where another pairing rounds otherwise); a shuffle by s - 1 does not."""
    rs = np.random.default_rng(seed * 7 + threads)
    sums = rs.standard_normal((9, threads, 2)) * 10.0 ** rs.integers(
        -8, 8, (9, threads, 2))
    want = shared_tree(sums)
    assert warp_levels(sums).tobytes() == want.tobytes()

    def off_by_one(x):
        sh = x.copy()
        s = threads // 2
        while s > 32:
            sh[..., :s, :] += sh[..., s:2 * s, :]
            s //= 2
        v = sh[..., :32, :] + sh[..., 32:64, :] if threads > 32 else sh
        for s in (16, 8, 4, 2, 1):
            k = s - 1
            v = v + np.concatenate([v[..., k:, :], v[..., 32 - k:, :]],
                                   axis=-2)
        return v[..., 0, :]

    assert off_by_one(sums).tobytes() != want.tobytes()


def test_helper_in_reduce_and_only_these_kernels_call_it():
    """block_store_moments_warp lives in reduce.cuh beside the unchanged
    tree; #11, #1, #28, #27 and #8 call it, and no other source does."""
    assert "__device__ void block_store_moments_warp(" in REDUCE
    assert "__device__ void block_store_moments(" in REDUCE
    assert "__device__ void block_store_moments_unrolled(" in REDUCE
    assert "sh[m][threadIdx.x] + sh[m][threadIdx.x + 32]" in REDUCE
    assert "__shfl_down_sync(0xffffffffu, v[m], s)" in REDUCE
    callers = sorted(p.name for p in CSRC.glob("*.cu*")
                     if "block_store_moments_warp<" in p.read_text())
    assert callers == ["fx_kernels.cu", "greek_kernels.cu", "path_kernels.cu",
                       "rainbow_partials.cuh", "rates_kernels.cu"]


# --- the lanes ---------------------------------------------------------------


def kernel_rows(pay, valid, n_blocks, p, tile=256):
    """The kernel's rows, mirrored: block b, round r: lane q of thread t
    adds path b*tile + t + q*T + r*stride (T = tile/p) in f64, [pay, pay^2]
    (a path past the end or the bound adding zeros); the lanes fold as the
    tree's top levels (q and q + h), then block_store_moments_warp."""
    n = pay.size
    t_ = tile // p
    stride = n_blocks * tile
    acc = np.zeros((n_blocks, p, t_, 2))
    for c in range(0, n, stride):
        x = np.zeros(stride, F32)
        m = min(stride, n - c)
        x[:m] = np.where(valid[c:c + m], pay[c:c + m], F32(0.0))
        x = x.reshape(n_blocks, p, t_)  # path b*tile + q*T + t
        acc[..., 0] += x.astype(np.float64)
        acc[..., 1] += (x * x).astype(np.float64)
    h = p // 2
    while h:
        acc[:, :h] += acc[:, h:2 * h]
        h //= 2
    return warp_levels(acc[:, 0])


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("n,n_blocks", [(1, 1), (255, 1), (257, 2),
                                        (3 * 256 * 2 + 123, 3),
                                        (5 * 256 * 4 + 17, 5),
                                        (100_001, 7)])
def test_lanes_give_block_rows(monkeypatch, p, n, n_blocks):
    """The P-lane fold and the warp levels give fused.block_rows' rows bit
    for bit: ragged counts, several grid-stride rounds (MAX_BLOCKS
    patched), paths past a bound adding zeros."""
    monkeypatch.setattr(_cuda, "MAX_BLOCKS", n_blocks)
    rs = np.random.default_rng(p * 1000 + n)
    pay = rs.lognormal(-3.0, 2.0, n).astype(F32)
    pay[::7] = 0.0
    bound = n - n // 9
    valid = np.arange(n) < bound
    want = fused.block_rows(torch.from_numpy(np.where(valid, pay, F32(0))))
    got = kernel_rows(pay, valid, want.shape[0], p)
    assert got.tobytes() == want.numpy().tobytes()


def test_paths_a_thread_divide_the_tile():
    """The paths a thread divide the block's 256 paths into a power of two
    of at least a warp's threads; the wrapper's block_rows reduces 256."""
    p = paths_a_thread()
    assert re.search(r"constexpr int kRatesTile = 256;", KERNEL)
    assert fused.RATES_THREADS == 256
    assert 256 % p == 0 and 256 // p >= 32
    assert (256 // p) & (256 // p - 1) == 0


# --- the staged layout -------------------------------------------------------


def struct_body(name: str) -> str:
    start = TILES_SRC.index(f"struct {name} {{")
    return TILES_SRC[start:TILES_SRC.index("\n};", start)]


def struct_int(name: str, field: str) -> int:
    return int(re.search(rf"static constexpr int {field} = (\d+);",
                         struct_body(name)).group(1))


def offset_fn(name: str, fn: str):
    """The tile's ``fn`` (head_offset or entry_offset) as a Python
    function of (n, index), from its one return statement."""
    body = struct_body(name)
    m = re.search(rf"static int {fn}\(int(?: n)?, int (\w)\) \{{\s*return "
                  r"(.*?);\s*\}", body, re.S)
    var, expr = m.group(1), " ".join(m.group(2).split())
    t = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
    if t:
        expr = f"(({t.group(2)}) if ({t.group(1)}) else ({t.group(3)}))"
    k_header = struct_int(name, "kHeader")
    return lambda n, i: eval(expr, {"kHeader": k_header, "n": n, var: i})


def stage(tile: str, pv: np.ndarray, n: int):
    """The block's staging, mirrored: head[k] = pv[head_offset(n, k)]
    (kHead floats), quad[j][e] = pv[entry_offset(n, e) + j] for e < 4 and
    tail[j] for the fifth entry."""
    s = STRUCTS[tile]
    head_off, entry_off = offset_fn(s, "head_offset"), offset_fn(
        s, "entry_offset")
    head = np.array([pv[head_off(n, k)] for k in range(struct_int(
        s, "kHead"))], F32)
    n_e = struct_int(s, "kEntries")
    quad = np.full((n, 4), np.nan, F32)
    tail = np.full(n, np.nan, F32)
    for k in range(n_e * n):  # the kernel's loop over k = e*n + j
        e, j = divmod(k, n)
        if e < 4:
            quad[j, e] = pv[entry_off(n, e) + j]
        else:
            tail[j] = pv[entry_off(n, e) + j]
    return head, quad[:, :min(n_e, 4)], tail if n_e > 4 else None


def flat_entries(tile: str, pv: np.ndarray, n: int):
    """(header floats, per-payment entries) where the plain payoffs read
    them (models/swaption.py, hullwhite.py, g2pp.py): Vasicek logA_j, B_j
    at pv + 10; Hull-White ratio_j, B_j, corr_j at pv + 7 (the multi-curve
    const_0 at pv + 7 + 3n and w_j at pv + 8 + 3n); G2++ ratio_j, A_j,
    Ba_j, Bb_j at pv + 10 (const_0 at pv + 10 + 4n, w_j at pv + 11 + 4n)."""
    j = np.arange(n)
    if tile == "va":
        return pv[:10], np.stack([pv[10 + j], pv[10 + n + j]], 1), None
    if tile.startswith("hw"):
        ent = [pv[7 + j], pv[7 + n + j], pv[7 + 2 * n + j]]
        if tile == "hw":
            return pv[:7], np.stack(ent, 1), None
        return (np.append(pv[:7], pv[7 + 3 * n]),
                np.stack(ent + [pv[8 + 3 * n + j]], 1), None)
    ent = [pv[10 + j], pv[10 + n + j], pv[10 + 2 * n + j], pv[10 + 3 * n + j]]
    if tile == "g2":
        return pv[:10], np.stack(ent, 1), None
    return (np.append(pv[:10], pv[10 + 4 * n]), np.stack(ent, 1),
            pv[11 + 4 * n + j])


@pytest.mark.parametrize("tile", sorted(STRUCTS))
@pytest.mark.parametrize("n", [1, 10, 60, "cap"])
def test_staged_layout_holds_the_packs_entries(tile, n):
    """For every tile at n = 1, 10, 60 and the staging cap, the staged
    header and entries are the ones the flat pack's offsets give; the
    tile's header and entry counts match fused.TILES' pack length."""
    n = stage_payments() if n == "cap" else n
    s = STRUCTS[tile]
    assert struct_int(s, "kHead") == fused.TILES[tile].header
    assert struct_int(s, "kEntries") == fused.TILES[tile].per_payment
    pv = np.arange(fused.packed_length(tile, n), dtype=F32) + F32(0.5)
    head, quad, tail = stage(tile, pv, n)
    want_head, want_quad, want_tail = flat_entries(tile, pv, n)
    assert head.tobytes() == want_head.tobytes()
    assert quad.tobytes() == want_quad.tobytes()
    assert (tail is None) == (want_tail is None)
    if tail is not None:
        assert tail.tobytes() == want_tail.tobytes()
    # every float of the pack is staged exactly once
    used = np.concatenate([head, quad.ravel()] + ([tail] if tail is not None
                                                  else []))
    assert np.array_equal(np.sort(used), pv)


def test_staging_cap_fits_shared_memory():
    """The staged tables at the cap: 16 bytes a payment and 4 more for the
    fifth entry, beside the 64-byte header slot: 16 blocks of 128 threads
    (an SM's 2,048 threads at 2 paths a thread) fit in its 228 KB, each
    inside the 48 KB a block takes without an opt-in."""
    cap = stage_payments()
    assert re.search(r"constexpr int kRatesHeadFloats = 16;", KERNEL)
    assert 16 * (64 + 20 * cap) <= 228 * 1024
    assert 64 + 20 * cap <= 48 * 1024


# --- the source -------------------------------------------------------------


def test_bond_loop_reads_no_ldg_when_staged():
    """On the staged path a bond's entries come from the block's shared
    copy (one float4, and the fifth beside it), no __ldg; in place each
    entry is one __ldg; the staging itself reads the pack once a block."""
    body = KERNEL[KERNEL.index("__device__ __forceinline__ RatesEntry rates_entry("):]
    body = body[:body.index("\n}\n")]
    staged, in_place = body.split("} else {")
    assert "__ldg" not in staged and "e.q = quad[j];" in staged
    assert in_place.count("__ldg") == 5
    kernel = KERNEL[KERNEL.index("rates_partials_kernel(int n"):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert "__ldg" not in kernel
    assert "rates_entry<Tile, kStaged>(quad, tail, pv, n, j)" in kernel


def test_bond_loop_unrolled_with_its_tail():
    """kRatesUnroll bonds an iteration, then the tail of n modulo it, each
    bond once for every lane, in payment order."""
    unroll = int(re.search(r"constexpr int kRatesUnroll = (\d+);",
                           KERNEL).group(1))
    assert unroll == 4
    flat = " ".join(KERNEL.split())
    assert ("for (; j + kRatesUnroll <= n; j += kRatesUnroll) { #pragma "
            "unroll for (int u = 0; u < kRatesUnroll; ++u) bond(j + u); }"
            in flat)
    assert "#pragma unroll 1 for (; j < n; ++j) bond(j);" in flat
    assert "for (int p = 0; p < P; ++p) Tile::bond(h, e, s[p], a[p]);" in flat


def test_tiles_keep_the_plain_association():
    """Each bond's expf and add in the plain version's order."""
    flat = " ".join(TILES_SRC.split())
    assert "a.p = expf(e.q.x - e.q.y * s.r); a.fixed = a.fixed + a.p;" in flat
    assert "return e.q.x * expf(-e.q.y * x - e.q.z);" in flat
    assert "return e.q.x * expf(e.q.y - e.q.z * x - e.q.w * y);" in flat
    assert "a.fixed = a.fixed + h.ktau * a.p;" in flat
    assert "a.v = a.v + e.q.w * hw_bond(e, s.x);" in flat
    assert "a.v = a.v + e.t * g2_bond(e, s.x, s.y);" in flat
    assert "const float fixed = a.fixed + a.p; // the principal" in flat


# --- the wrapper ------------------------------------------------------------


def launch_args(monkeypatch, tile: str, n_pay: int, n_paths: int):
    """The arguments the wrapper passes to mc_rates_partials (its card path
    run against a stand-in library on a meta tensor, which has no staging
    cap to read: the library picks its path).  Checks that it counts the
    one launch."""
    seen = []

    class Lib:
        def __getattr__(self, attr):
            if attr == "mc_rates_block_paths":
                return lambda: 256
            if attr == "mc_rates_partials":
                return lambda *args: seen.append(args) or 0
            raise AttributeError(attr)

    monkeypatch.setattr(_cuda, "load", Lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_cuda, "launch_counts",
                        dict.fromkeys(_cuda.KERNELS, 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(fused, "_check", lambda *args: None)
    pv = torch.empty(fused.packed_length(tile, n_pay), device="meta")
    rows = fused.fused_moment_partials(tile, n_pay, (1, 2), pv, n_paths)
    assert len(seen) == 1 and rows.shape == (seen[0][-2], 2)
    assert _cuda.launch_counts[f"rates_partials_{tile}"] == 1
    return seen[0]


@pytest.mark.parametrize("tile", sorted(STRUCTS))
@pytest.mark.parametrize("n_pay", [1, 10, 60, 512, 513])
@pytest.mark.parametrize("n_paths", [1, 257, 1 << 20, (1 << 32) - 1])
def test_wrapper_passes_the_grid(monkeypatch, tile, n_pay, n_paths):
    """The tile's id, n_pay, the key, the path count and ceil(n_paths /
    256) blocks, capped at MAX_BLOCKS: the entry point's eleven arguments,
    whatever n_pay."""
    args = launch_args(monkeypatch, tile, n_pay, n_paths)
    assert len(args) == len(_cuda._SIGNATURES["mc_rates_partials"][0]) == 11
    assert args[:5] == (fused.TILES[tile].cuda_id, n_pay, 1, 2, 0)
    assert args[5] == n_paths
    assert args[-2] == min(-(-n_paths // 256), _cuda.MAX_BLOCKS)


def launcher(name: str) -> str:
    body = KERNEL[KERNEL.index(f"cudaError_t {name}("):]
    return " ".join(body[:body.index("\n}\n")].split())


@pytest.mark.parametrize("name", ["launch_rates", "rates_occupancy"])
def test_launcher_picks_the_path_by_n(name):
    """The launcher and the occupancy query stage the tables where n_pay is
    at most kRatesStagePayments and read them in place past it, each
    kernel with the shared memory its path takes, as #22's payment table
    is picked (divs_kernels.cu)."""
    flat = " ".join(KERNEL.split())
    assert ("inline bool rates_staged(int n_pay) { return n_pay <= "
            "kRatesStagePayments; }" in flat)
    body = launcher(name)
    assert "const bool staged = rates_staged(n_pay);" in body
    assert ("const size_t smem = rates_smem_bytes<Tile>(n_pay, staged);"
            in body)
    assert "rates_partials_kernel<Tile, P, true>" in body
    assert "rates_partials_kernel<Tile, P, false>" in body


def test_entry_points_take_no_staging_flag():
    """mc_rates_partials and mc_rates_occupancy take what the one-path
    kernel's took (the occupancy query its tile and n_pay); the ctypes
    signatures agree."""
    flat = " ".join(KERNEL.split())
    assert ("int mc_rates_partials(int tile, int n_pay, uint32_t k0, "
            "uint32_t k1, const float* pv, uint32_t n_paths, uint32_t "
            "path_offset, uint32_t bound, double* partials, int n_blocks, "
            "void* stream)" in flat)
    assert "int mc_rates_occupancy(int tile, int n_pay, int* blocks)" in flat
    assert len(_cuda._SIGNATURES["mc_rates_occupancy"][0]) == 3
