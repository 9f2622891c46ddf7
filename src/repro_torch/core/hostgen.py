"""Pure-numpy mirrors of the counter-based generation math: the R-MAT edge
stream, the shuffle salts and keys, the keyed Feistel family and the walk
RNG (twin of `repro.core.hostgen`).

Own copy of that module: it is jax-free but cannot be imported without jax
(its package imports `core/rmat.py`).  Scalars are Python ints holding uint32
values; the numpy functions compute in wrapping uint32, as the reference
does.  The disk tier (`core/phases.py`) sends its per-chunk hot loops to the
kernels through `core/chunks.py`; these mirrors stay the numpy reference the
tests hold the hooks to.
"""

from __future__ import annotations

from typing import Tuple

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


def counter_uniform_u32_np(seed: int, index: np.ndarray, stream: int) -> np.ndarray:
    s = np.uint32((seed ^ (stream * _GOLDEN)) & 0xFFFFFFFF)
    return mix32_np(mix32_np(np.asarray(index, np.uint32) + s) ^ s)


def round_salt(seed: int, r: int) -> np.uint32:
    """Per-round shuffle salt — twin of shuffle._shuffle_rounds_body's
    mix32(seed + r * GOLDEN)."""
    s = (seed + r * _GOLDEN) & 0xFFFFFFFF
    return mix32_np(np.asarray([s], np.uint32))[0]


def shuffle_keys(values: np.ndarray, salt: np.uint32) -> np.ndarray:
    """Twin of shuffle._local_shuffle's sort keys: mix32(value ^ salt).

    Bijective in `value`, so keys are unique within any set of distinct
    vertex ids — external sort by these keys reproduces the device local
    shuffle exactly."""
    return mix32_np(np.asarray(values).astype(np.uint32) ^ salt)


def rmat_thresholds(a: float, b: float, c: float, d: float) -> Tuple[int, int, int]:
    """Integer cut points on the uint32 lattice (twin of types.quadrant_thresholds,
    duplicated here so worker processes need no jax-importing module)."""
    two32 = float(1 << 32)
    t_src = int((c + d) * two32)
    t_dst0 = int((b / (a + b)) * two32)
    t_dst1 = int((d / (c + d)) * two32)
    return t_src, t_dst0, t_dst1


def rmat_edges_np(
    scale: int,
    seed: int,
    start: int,
    count: int,
    a: float,
    b: float,
    c: float,
    d: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of rmat.rmat_edge_block: `count` edges with global ids
    [start, start+count), bit-identical to the jnp reference."""
    t_src, t_dst0, t_dst1 = rmat_thresholds(a, b, c, d)
    idx = np.uint32(start) + np.arange(count, dtype=np.uint32)
    src = np.zeros(count, np.uint32)
    dst = np.zeros(count, np.uint32)
    for level in range(scale):
        r1 = counter_uniform_u32_np(seed, idx, 2 * level)
        r2 = counter_uniform_u32_np(seed, idx, 2 * level + 1)
        src_bit = r1 < np.uint32(t_src)
        t_d = np.where(src_bit, np.uint32(t_dst1), np.uint32(t_dst0))
        dst_bit = r2 < t_d
        src = (src << np.uint32(1)) | src_bit.astype(np.uint32)
        dst = (dst << np.uint32(1)) | dst_bit.astype(np.uint32)
    return src.astype(np.int64), dst.astype(np.int64)


def rmat_edges_np_cfg(cfg, start: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
    """Config-object convenience (any object with scale/seed/a/b/c/d)."""
    return rmat_edges_np(cfg.scale, cfg.seed, start, count, cfg.a, cfg.b, cfg.c, cfg.d)


def feistel_round_key_np(key: int, i: int) -> np.ndarray:
    """Round key rk_i = mix32(key + (i+1)*GOLDEN) — scalar uint32 (0-d).

    The sum is folded in PYTHON integers then reduced mod 2**32, so the jnp
    and Pallas twins can reproduce it exactly with one mix32 call."""
    s = (int(key) + (i + 1) * _GOLDEN) & 0xFFFFFFFF
    return mix32_np(np.asarray([s], np.uint32))[0]


def feistel_perm_np(x: np.ndarray, key: int, nbits: int,
                    rounds: int = FEISTEL_ROUNDS) -> np.ndarray:
    """Keyed bijection on [0, 2**nbits) (unbalanced Feistel over mix32).

    The input splits into L (hi_bits = nbits - nbits//2) and R (lo_bits =
    nbits//2); each round computes F = mix32(R ^ rk_i), swaps halves, and
    masks the new R to the width the OLD L had — after an even number of
    rounds the widths are back to (hi, lo) and (L << lo_bits) | R is again an
    nbits value.  Bijective because every round is invertible (XOR with a
    function of the untouched half) — see feistel_perm_inv_np.

    Container is uint64 with uint32 halves: nbits <= 62 (each half <= 31
    bits, so the masks fit uint32).  Returns uint64.
    """
    if rounds < 2 or rounds % 2:
        raise ValueError(f"feistel rounds must be even and >= 2, got {rounds}")
    if not 1 <= nbits <= 62:
        raise ValueError(f"feistel domain needs 1 <= nbits <= 62, got {nbits}")
    lo_bits = nbits // 2
    x = np.asarray(x, np.uint64)
    L = (x >> np.uint64(lo_bits)).astype(np.uint32)
    R = (x & np.uint64((1 << lo_bits) - 1)).astype(np.uint32)
    wL, wR = nbits - lo_bits, lo_bits
    for i in range(rounds):
        F = mix32_np(R ^ feistel_round_key_np(key, i))
        L, R, wL, wR = R, (L ^ F) & np.uint32((1 << wL) - 1), wR, wL
    return (L.astype(np.uint64) << np.uint64(lo_bits)) | R.astype(np.uint64)


def feistel_perm_inv_np(y: np.ndarray, key: int, nbits: int,
                        rounds: int = FEISTEL_ROUNDS) -> np.ndarray:
    """Inverse of feistel_perm_np: same round keys, walked in reverse."""
    if rounds < 2 or rounds % 2:
        raise ValueError(f"feistel rounds must be even and >= 2, got {rounds}")
    if not 1 <= nbits <= 62:
        raise ValueError(f"feistel domain needs 1 <= nbits <= 62, got {nbits}")
    lo_bits = nbits // 2
    y = np.asarray(y, np.uint64)
    L = (y >> np.uint64(lo_bits)).astype(np.uint32)
    R = (y & np.uint64((1 << lo_bits) - 1)).astype(np.uint32)
    wL, wR = nbits - lo_bits, lo_bits
    for i in reversed(range(rounds)):
        F = mix32_np(L ^ feistel_round_key_np(key, i))
        L, R, wL, wR = (R ^ F) & np.uint32((1 << wR) - 1), L, wR, wL
    return (L.astype(np.uint64) << np.uint64(lo_bits)) | R.astype(np.uint64)


def keyed_perm_np(x: np.ndarray, key: int, n: int,
                  rounds: int = FEISTEL_ROUNDS) -> np.ndarray:
    """Keyed bijection on [0, n) for ARBITRARY n, by cycle-walking the
    power-of-two Feistel: out-of-range outputs are re-permuted until they
    land inside [0, n).  Terminates because the Feistel orbit of any x < n
    returns to x, so walking forward from x must hit an in-range element
    within one cycle (< 2**nbits steps; in expectation < 2 steps since the
    domain is at most 2n).  For power-of-two n — the pipeline's case, n =
    2**scale — the walk never triggers and the cost is exactly one Feistel
    evaluation per element.  Returns int64."""
    nbits = perm_domain_bits(n)
    x = np.asarray(x)
    flat = np.atleast_1d(x).astype(np.int64)
    if flat.size and (flat.min() < 0 or flat.max() >= n):
        raise ValueError(f"keyed_perm_np: inputs must lie in [0, {n})")
    out = np.atleast_1d(feistel_perm_np(flat, key, nbits, rounds))
    bad = out >= np.uint64(n)
    while bad.any():
        out[bad] = feistel_perm_np(out[bad], key, nbits, rounds)
        bad = out >= np.uint64(n)
    return out.astype(np.int64).reshape(np.shape(x))


def keyed_perm_inv_np(y: np.ndarray, key: int, n: int,
                      rounds: int = FEISTEL_ROUNDS) -> np.ndarray:
    """Inverse of keyed_perm_np: the inverse walk retraces the forward
    cycle-walk backwards (all intermediates of the forward walk were >= n,
    so the first in-range preimage IS the original input)."""
    nbits = perm_domain_bits(n)
    y = np.asarray(y)
    flat = np.atleast_1d(y).astype(np.int64)
    if flat.size and (flat.min() < 0 or flat.max() >= n):
        raise ValueError(f"keyed_perm_inv_np: inputs must lie in [0, {n})")
    out = np.atleast_1d(feistel_perm_inv_np(flat, key, nbits, rounds))
    bad = out >= np.uint64(n)
    while bad.any():
        out[bad] = feistel_perm_inv_np(out[bad], key, nbits, rounds)
        bad = out >= np.uint64(n)
    return out.astype(np.int64).reshape(np.shape(y))


def graph_perm_np(seed: int, x: np.ndarray, n: int,
                  rounds: int = FEISTEL_ROUNDS) -> np.ndarray:
    """pv[x] of the recomputable permutation family: what the external
    shuffle would have materialized, evaluated on demand (shuffle_variant=
    "recompute" / perm_family="feistel")."""
    return keyed_perm_np(x, graph_perm_key(seed), n, rounds)


def graph_perm_inv_np(seed: int, y: np.ndarray, n: int,
                      rounds: int = FEISTEL_ROUNDS) -> np.ndarray:
    """Original vertex id of new label y (pv^{-1}[y])."""
    return keyed_perm_inv_np(y, graph_perm_key(seed), n, rounds)


def walk_rand_np(seed: int, walker: np.ndarray, step: int) -> np.ndarray:
    """Counter RNG of the random-walk samplers, keyed by (seed, walker id,
    step): the uint32 every sampler draws for walker w at step t."""
    s = np.uint32(seed & MASK32)
    return mix32_np(mix32_np(np.asarray(walker, np.uint32) ^ s)
                    + np.uint32((step * _GOLDEN) & MASK32))


def walk_start_np(seed: int, walker: np.ndarray, n: int, base: int = 0) -> np.ndarray:
    """Deterministic start vertex of a walker (int64, the host walk dtype)."""
    return base + (walk_rand_np(seed ^ 0xA5A5, walker, 0) % np.uint32(n)).astype(np.int64)
