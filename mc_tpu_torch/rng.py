"""Counter-based RNG: threefry2x32 keyed per (path, draw)
(port of ``mc_tpu/rng.py:44-198``).

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
