"""Host-side constants and key schedule of the keyed Feistel family.

Own copy of the subset of `repro.core.hostgen` the device path needs; that
module is jax-free but cannot be imported without jax (its package imports
`core/rmat.py`).  Scalars are Python ints holding uint32 values.
"""

from __future__ import annotations

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
