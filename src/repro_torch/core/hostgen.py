"""Host-side constants, the key schedule of the keyed Feistel family and the
numpy walk RNG.

Own copy of the subset of `repro.core.hostgen` the port needs; that module is
jax-free but cannot be imported without jax (its package imports
`core/rmat.py`).  Scalars are Python ints holding uint32 values; the numpy
functions compute in wrapping uint32, as the reference does.
"""

from __future__ import annotations

import numpy as np

FEISTEL_ROUNDS = 4
_FEISTEL_STREAM = 0xFE15_7E11
_GOLDEN = 0x9E3779B9
MASK32 = 0xFFFFFFFF


def mix32_int(x: int) -> int:
    """mix32 of one uint32 held in a Python int."""
    x &= MASK32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & MASK32
    x ^= x >> 16
    return x


def perm_domain_bits(n: int) -> int:
    """ceil(log2(n)) clamped to >= 1: the Feistel domain covering [0, n)."""
    return max(1, int(n - 1).bit_length())


def feistel_round_key(key: int, i: int) -> int:
    """Round key rk_i = mix32(key + (i+1)*GOLDEN), folded in Python ints."""
    return mix32_int((int(key) + (i + 1) * _GOLDEN) & MASK32)


def graph_perm_key(seed: int) -> int:
    """The pipeline's permutation key for graph seed `seed`."""
    return (int(seed) ^ _FEISTEL_STREAM) & MASK32


_M1 = np.uint32(0x7FEB352D)
_M2 = np.uint32(0x846CA68B)


def mix32_np(x: np.ndarray) -> np.ndarray:
    """Numpy mix32 (murmur3-finalizer variant, bijective on uint32)."""
    x = np.asarray(x, np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * _M1
    x = x ^ (x >> np.uint32(15))
    x = x * _M2
    x = x ^ (x >> np.uint32(16))
    return x


def walk_rand_np(seed: int, walker: np.ndarray, step: int) -> np.ndarray:
    """Counter RNG of the random-walk samplers, keyed by (seed, walker id,
    step): the uint32 every sampler draws for walker w at step t."""
    s = np.uint32(seed & MASK32)
    return mix32_np(mix32_np(np.asarray(walker, np.uint32) ^ s)
                    + np.uint32((step * _GOLDEN) & MASK32))


def walk_start_np(seed: int, walker: np.ndarray, n: int, base: int = 0) -> np.ndarray:
    """Deterministic start vertex of a walker (int64, the host walk dtype)."""
    return base + (walk_rand_np(seed ^ 0xA5A5, walker, 0) % np.uint32(n)).astype(np.int64)
