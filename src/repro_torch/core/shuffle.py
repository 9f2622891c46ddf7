"""Distributed random shuffle -> permutation vector pv (paper Alg. 2-4), twin
of `repro.core.shuffle`.

  distributed_shuffle  paper-faithful: log_nb(n) rounds of a local shuffle
                       (sort by counter-hash keys) and a 1:1 slice exchange
  shuffle_argsort      one global sort by counter-hash keys
  shuffle_recompute    communication-free: pv[i] = keyed Feistel(i), through
                       the `feistel_perm` kernel

All return pv as a flat int32 tensor of shape (n,), shard-major; given a
placement over cards (`distributed/collectives.py::Cards`), the paper's
shuffle and the recompute return one block a card, card c's shards'
[per_card * n / nb] part of pv.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from ..distributed.collectives import Cards, slice_exchange
from ..kernels.rmat import feistel_perm as _feistel_kernel
from .hostgen import FEISTEL_ROUNDS, MASK32, graph_perm_key, mix32_int, perm_domain_bits
from .rmat import mix32
from .types import GraphConfig

_GOLDEN = 0x9E3779B9


def _local_shuffle(buf: torch.Tensor, salt: int) -> torch.Tensor:
    """Each row of buf [nb, B] reordered by mix32(value ^ salt) (unique keys)."""
    keys = mix32((buf.to(torch.int64) & MASK32) ^ salt)
    return torch.gather(buf, 1, torch.argsort(keys, dim=1))


def distributed_shuffle(cfg: GraphConfig, device="cuda", cards: Optional[Cards] = None):
    """Paper-faithful shuffle (Alg. 4): pv [n] on `device`, or with `cards`
    a list of each card's [per_card * B] block of it."""
    nb, B = cfg.nb, cfg.bucket_size
    if B % nb:
        raise ValueError("bucket size must split into nb exchange slices")
    if cards is None:
        dev = resolve_device(device)
        return distributed_shuffle(cfg, cards=Cards((dev,), nb))[0]
    S = cards.per_card
    # sbuf[bid] starts as shard bid's range partition of [0, n).
    sbuf = [torch.arange(cards.first(c) * B, (cards.first(c) + S) * B, dtype=cfg.vertex_dtype,
                         device=dev).reshape(S, B) for c, dev in enumerate(cards.devices)]
    for r in range(cfg.rounds):
        salt = mix32_int((cfg.seed + r * _GOLDEN) & MASK32)
        sbuf = [_local_shuffle(b, salt) for b in sbuf]
        if nb > 1:
            # slice j of shard i -> shard j: [sender, dest, blk] -> [dest, sender, blk]
            sbuf = slice_exchange(sbuf, cards)
    return [b.reshape(-1) for b in sbuf]


def shuffle_argsort(cfg: GraphConfig, device="cuda") -> torch.Tensor:
    """Exact one-shot shuffle: pv = ids sorted by mix32(id + seed) (unique keys)."""
    dev = resolve_device(device)
    ids = torch.arange(cfg.n, dtype=cfg.vertex_dtype, device=dev)
    keys = mix32((ids.to(torch.int64) + (cfg.seed & MASK32)) & MASK32)
    return ids[torch.argsort(keys)]


def feistel_perm(x: torch.Tensor, key: int, nbits: int,
                 rounds: int = FEISTEL_ROUNDS) -> torch.Tensor:
    """Keyed bijection on [0, 2**nbits), 1 <= nbits <= 31; int32 in and out."""
    return _feistel_kernel(x.to(torch.int32), key, nbits, rounds)


def keyed_perm(x: torch.Tensor, key: int, n: int,
               rounds: int = FEISTEL_ROUNDS) -> torch.Tensor:
    """Keyed bijection on [0, n) by cycle-walking the power-of-two Feistel.

    For power-of-two n (the pipeline's case) the walk never runs.  Returns
    x's dtype."""
    nbits = perm_domain_bits(n)
    y = feistel_perm(x, key, nbits, rounds)
    if n != (1 << nbits):
        while bool((y >= n).any()):
            y = torch.where(y >= n, feistel_perm(y, key, nbits, rounds), y)
    return y.to(x.dtype)


def graph_perm(seed: int, x: torch.Tensor, n: int,
               rounds: int = FEISTEL_ROUNDS) -> torch.Tensor:
    """The pipeline's recomputable permutation: keyed_perm under seed's key."""
    return keyed_perm(x, graph_perm_key(seed), n, rounds)


def shuffle_recompute(cfg: GraphConfig, device="cuda", cards: Optional[Cards] = None):
    """Communication-free pv: every id through the keyed Feistel family; with
    `cards`, each card's block computed where it lies."""
    if cards is None:
        dev = resolve_device(device)
        return shuffle_recompute(cfg, cards=Cards((dev,), cfg.nb))[0]
    size = cards.per_card * cfg.bucket_size
    return [graph_perm(cfg.seed, torch.arange(c * size, (c + 1) * size, dtype=cfg.vertex_dtype,
                                              device=dev), cfg.n, rounds=cfg.feistel_rounds)
            for c, dev in enumerate(cards.devices)]


def pv_is_permutation(pv: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: pv is a bijection on [0, n) (each id hit exactly once)."""
    n = pv.shape[0]
    hits = torch.zeros(n, dtype=torch.int32, device=pv.device)
    hits.index_add_(0, pv.to(torch.int64), torch.ones(n, dtype=torch.int32, device=pv.device))
    return (hits == 1).all()
