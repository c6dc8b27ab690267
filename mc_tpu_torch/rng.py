"""Counter-based RNG: threefry2x32 keyed per (path, draw), and the inverse
normal CDF of the quasi-Monte Carlo points
(port of ``mc_tpu/rng.py:44-272``).

The normal draw for (path ``i``, draw ``j``) is a pure function
``N(key, i, j)``, so the port draws the same stream as the JAX package and
the CUDA kernels draw the same stream as this module (``csrc/rng.cuh`` holds
the device twin).  Torch on the CPU has no uint32 add or shift, so words are
carried in int64 tensors masked to 32 bits; every function here takes and
returns such int64 "uint32" tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "threefry2x32",
    "derive_key",
    "bits_to_unit",
    "normal_pair",
    "normals",
    "inv_normal_cdf",
    "TWO_PI",
    "DEFAULT_ROUNDS",
]

TWO_PI = 6.283185307179586

# Normal draws use 13 rounds (the smallest count that passes all of TestU01
# BigCrush, Salmon et al. 2011, table 5); key derivation uses 20.
DEFAULT_ROUNDS = 13

# Threefry2x32 rotation schedule (Salmon et al. 2011, table 2).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def _rotl(x, d: int):
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(k0, k1, x0, x1, rounds: int = 20):
    """Threefry-2x32 on int64 tensors holding uint32 words.

    ``k0``/``k1`` are Python ints or tensors broadcastable against the
    counters ``x0``/``x1``.  Returns two int64 tensors of 32-bit words.
    The key is injected after every 4th round; a round count that is not a
    multiple of 4 (13) ends without an injection, as in ``mc_tpu.rng``.
    """
    if not 1 <= rounds <= 32:
        raise ValueError("rounds must be in [1, 32]")
    k0, k1 = (k if torch.is_tensor(k) else int(k) for k in (k0, k1))
    ks2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, ks2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for r in range(rounds):
        x0 = (x0 + x1) & _MASK
        x1 = _rotl(x1, _ROTATIONS[r % 8]) ^ x0
        if (r + 1) % 4 == 0:  # key injection after every 4th round (R123)
            inj = (r + 1) // 4
            x0 = (x0 + ks[inj % 3]) & _MASK
            x1 = (x1 + ks[(inj + 1) % 3] + inj) & _MASK
    return x0, x1


def derive_key(seed: int, *tags: int) -> tuple[np.uint32, np.uint32]:
    """Derive a (k0, k1) stream key from an integer seed + stream tags.

    Host-side numpy; ``derive_key(seed)`` is the root and
    ``derive_key(seed, tag)`` an independent stream (outer vs inner NMC
    paths).  Bitwise equal to ``mc_tpu.rng.derive_key``.
    """
    seed = int(seed) % (1 << 64)  # accept negative / arbitrary-width ints
    k0 = np.uint32(np.uint64(seed) & np.uint64(0xFFFFFFFF))
    k1 = np.uint32((np.uint64(seed) >> np.uint64(32)) & np.uint64(0xFFFFFFFF))
    for tag in tags:
        tag = int(tag) % (1 << 64)
        t0 = np.uint32(np.uint64(tag) & np.uint64(0xFFFFFFFF))
        t1 = np.uint32((np.uint64(tag) >> np.uint64(32)) & np.uint64(0xFFFFFFFF))
        k0, k1 = _threefry_scalar_np(k0, k1, t0, t1)
    return k0, k1


def _threefry_scalar_np(k0, k1, x0, x1):
    """Concrete numpy threefry2x32-20 for host key derivation."""
    m = np.uint64(0xFFFFFFFF)

    def rotl(x, d):
        x = np.uint64(x)
        return np.uint32(((x << np.uint64(d)) | (x >> np.uint64(32 - d))) & m)

    k0 = np.uint32(k0); k1 = np.uint32(k1)
    ks2 = np.uint32(np.uint32(k0 ^ k1) ^ np.uint32(_PARITY))
    x0 = np.uint32((np.uint64(x0) + np.uint64(k0)) & m)
    x1 = np.uint32((np.uint64(x1) + np.uint64(k1)) & m)
    key_sched = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    for r in range(5):
        for i in range(4):
            x0 = np.uint32((np.uint64(x0) + np.uint64(x1)) & m)
            x1 = rotl(x1, _ROTATIONS[(r % 2) * 4 + i])
            x1 = np.uint32(x0 ^ x1)
        ka, kb = key_sched[r]
        x0 = np.uint32((np.uint64(x0) + np.uint64(ka)) & m)
        x1 = np.uint32((np.uint64(x1) + np.uint64(kb) + np.uint64(r + 1)) & m)
    return x0, x1


def bits_to_unit(bits):
    """32 random bits (int64 tensor) -> float32 uniform in [0, 1).

    Sets the exponent to 0 (value in [1, 2)) and subtracts 1: exact, branch
    free, and identical across backends.
    """
    as_int = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return as_int.view(torch.float32) - 1.0


def normal_pair(k0, k1, c0, c1, rounds: int = DEFAULT_ROUNDS):
    """Two independent N(0,1) f32 tensors from counter tensors (c0, c1).

    Full Box-Muller: one threefry call yields 64 bits -> (u1, u2) -> the
    (cos, sin) pair.
    """
    b0, b1 = threefry2x32(k0, k1, c0, c1, rounds=rounds)
    u1 = bits_to_unit(b0)
    u2 = bits_to_unit(b1)
    # 1 - u1 in (0, 1]: log is finite; r = 0 when u1 == 0.
    rad = torch.sqrt(-2.0 * torch.log1p(-u1))
    theta = torch.tensor(TWO_PI, dtype=torch.float32, device=u2.device) * u2
    return rad * torch.cos(theta), rad * torch.sin(theta)


def normals(key, ids, n_draws: int, draw_offset: int = 0,
            rounds: int = DEFAULT_ROUNDS):
    """Stack of ``n_draws`` N(0,1) tensors for element-id tensor ``ids``.

    Returns shape ``(n_draws,) + ids.shape``.  Draw ``j`` for element ``i``
    uses counter ``(i, draw_offset/2 + j//2)``, half ``j % 2``: pairs
    ``(2m, 2m+1)`` share one threefry evaluation.  ``draw_offset`` must be
    even.
    """
    if draw_offset % 2:
        raise ValueError("draw_offset must be even (pair alignment)")
    k0, k1 = int(key[0]), int(key[1])
    outs = []
    for m in range((n_draws + 1) // 2):
        c1 = torch.full_like(ids, draw_offset // 2 + m)
        outs.extend(normal_pair(k0, k1, ids, c1, rounds=rounds))
    return torch.stack(outs[:n_draws], dim=0)


# ---------------------------------------------------------------------------
# Inverse normal CDF (Acklam's rational approximation): the QMC map.
# Box-Muller would scramble a low-discrepancy point set; QMC needs the
# direct inverse transform.  ``csrc/rng.cuh`` holds the device twin,
# operation for operation.
# ---------------------------------------------------------------------------

_ACKLAM_A = (-3.969683028665376e+01, 2.209460984245205e+02,
             -2.759285104469687e+02, 1.383577518672690e+02,
             -3.066479806614716e+01, 2.506628277459239e+00)
_ACKLAM_B = (-5.447609879822406e+01, 1.615858368580409e+02,
             -1.556989798598866e+02, 6.680131188771972e+01,
             -1.328068155288572e+01)
_ACKLAM_C = (-7.784894002430293e-03, -3.223964580411365e-01,
             -2.400758277161838e+00, -2.549732539343734e+00,
             4.374664141464968e+00, 2.938163982698783e+00)
_ACKLAM_D = (7.784695709041462e-03, 3.224671290700398e-01,
             2.445134137142996e+00, 3.754408661907416e+00)
# Abramowitz-Stegun 7.1.26.
_ERF_P = 0.3275911
_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def _horner(coefs, x, last=None):
    """((c0 x + c1) x + c2) ... in f32, one rounding per mul and add (no
    fused multiply-add); ``last`` adds a final ``* x + last``."""
    f = lambda c: torch.tensor(c, dtype=torch.float32, device=x.device)
    acc = f(coefs[0]) * x + f(coefs[1])
    for c in coefs[2:]:
        acc = acc * x + f(c)
    if last is not None:
        acc = acc * x + f(last)
    return acc


def _erf_as(x):
    """erf by Abramowitz-Stegun 7.1.26 (|abs err| <= 1.5e-7), f32."""
    ax = torch.abs(x)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    t = one / (one + torch.tensor(_ERF_P, dtype=torch.float32,
                                  device=x.device) * ax)
    a = _ERF_A
    poly = t * (a[0] + t * (a[1] + t * (a[2] + t * (a[3] + t * a[4]))))
    e = one - poly * torch.exp(-ax * ax)
    return torch.sign(x) * e


def inv_normal_cdf(u):
    """Phi^{-1}(u) for f32 ``u`` in (0, 1), clamped to [1e-6, 1 - 1e-6]:
    Acklam's central and tail rationals, then one Newton step against the
    A&S erf where |x| < 3 (``mc_tpu.rng.inv_normal_cdf``, the same f32
    operations in the same order; XLA's CPU backend may contract its
    multiply-adds, so the two stay a few ulp apart, ROADMAP C19)."""
    dev = u.device
    f = lambda c: torch.tensor(c, dtype=torch.float32, device=dev)
    u = torch.clamp(u.to(torch.float32), f(1e-6), f(1.0 - 1e-6))
    q = u - f(0.5)
    r = q * q
    num = _horner(_ACKLAM_A, r)
    den = _horner(_ACKLAM_B, r, 1.0)
    central = q * num / den
    u_tail = torch.minimum(u, 1.0 - u)
    qt = torch.sqrt(f(-2.0) * torch.log(u_tail))
    num_t = _horner(_ACKLAM_C, qt)
    den_t = _horner(_ACKLAM_D, qt, 1.0)
    tail = num_t / den_t
    tail = torch.where(u < f(0.5), tail, -tail)
    p_low = f(0.02425)
    x = torch.where((u < p_low) | (u > 1.0 - p_low), tail, central)
    cdf = f(0.5) * (1.0 + _erf_as(x / f(1.4142135623730951)))
    pdf = f(0.3989422804014327) * torch.exp(f(-0.5) * x * x)
    step = (cdf - u) / torch.clamp(pdf, min=f(1e-10))
    return torch.where(torch.abs(x) < f(3.0), x - step, x)
