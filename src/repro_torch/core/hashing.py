"""Hash-based relabel baseline (the Graph500 'hashing based' kernel), twin of
`repro.core.hashing`: a balanced Feistel on `scale` bits (cycle-walked for odd
scale) maps old id -> new id with no permutation vector.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .hostgen import MASK32
from .rmat import mix32
from .types import GraphConfig

_ROUNDS = 4


def _feistel_even(v: torch.Tensor, bits: int, seed: int) -> torch.Tensor:
    """Balanced Feistel on an even number of bits (int64 holding uint32)."""
    half = bits // 2
    mask = (1 << half) - 1
    L = (v >> half) & mask
    R = v & mask
    for r in range(_ROUNDS):
        k = (seed & MASK32) ^ ((r * 0x9E3779B9) & MASK32)
        L, R = R, L ^ (mix32((R + k) & MASK32) & mask)
    return (L << half) | R


def feistel_permute(v: torch.Tensor, scale: int, seed: int) -> torch.Tensor:
    """Bijection on [0, 2**scale); odd scale cycle-walks on scale+1 bits.  int64 out."""
    v = v.to(torch.int64) & MASK32
    bits = scale + (scale & 1)
    n = 1 << scale
    x = _feistel_even(v, bits, seed)
    if bits == scale:
        return x
    while bool((x >= n).any()):
        x = torch.where(x >= n, _feistel_even(x, bits, seed), x)
    return x


def hash_relabel(cfg: GraphConfig, src: torch.Tensor, dst: torch.Tensor):
    """new = H(old): no pv, no communication."""
    return (feistel_permute(src, cfg.scale, cfg.seed).to(src.dtype),
            feistel_permute(dst, cfg.scale, cfg.seed).to(dst.dtype))


def hash_permutation_vector(cfg: GraphConfig, device="cuda") -> torch.Tensor:
    """H materialized as a pv [n] of cfg.vertex_dtype (for cross-validating
    the relabel paths)."""
    ids = torch.arange(cfg.n, dtype=torch.int64, device=resolve_device(device))
    return feistel_permute(ids, cfg.scale, cfg.seed).to(cfg.vertex_dtype)
