"""Redistribute relabeled edges to their owners (paper Alg. 8-9, §III-B7),
twin of `repro.core.redistribute`.

An edge is owned by the shard whose range contains its relabeled source.
  redistribute         unordered: one capacity_all_to_all
  redistribute_sorted  senders sort by source (stably), the stable bucketing
                       keeps each packet sorted, each receiver k-way merges
                       its nb runs (`kernels/merge.py::merge_runs`, one
                       launch for all receivers on a card): its edges come
                       out sorted by source.
Both take, with `cards`, one block a card ([per_card, N] fields) and give
each card its own receivers' rows; the buckets of receivers on other cards
are copied there (`distributed/collectives.py::capacity_all_to_all`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..distributed.collectives import (Cards, ExchangeResult, capacity_all_to_all, card_spans,
                                      first_block)
from ..kernels.merge import merge_runs
from .types import GraphConfig


class OwnedEdges(NamedTuple):
    """Owned edges with a validity mask; global shape [nb*nb, capacity]
    (rows [i*nb, (i+1)*nb) belong to shard i, one row per sender).  Over
    cards, src, dst and valid are lists of each card's rows ([per_card*nb,
    capacity]) and dropped is summed on the first card."""

    src: torch.Tensor
    dst: torch.Tensor
    valid: torch.Tensor
    dropped: torch.Tensor


def default_capacity(cfg: GraphConfig) -> int:
    return int(cfg.capacity_factor * cfg.edges_per_shard / max(cfg.nb, 1)) + 8


def _one_card(fn, cfg: GraphConfig, src: torch.Tensor, dst: torch.Tensor, capacity: int):
    return first_block(fn(cfg, [src], [dst], capacity, Cards((src.device,), cfg.nb)))


def _exchange(pair, dest, capacity: int, cards: Cards) -> ExchangeResult:
    """capacity_all_to_all over the cards; on one card in its one-card form,
    its result put in lists of one block."""
    if cards.count > 1:
        return capacity_all_to_all(pair, dest, capacity=capacity, cards=cards)
    ex = capacity_all_to_all(pair[0], dest[0], capacity=capacity)
    return ExchangeResult([ex.data], [ex.valid], None, ex.dropped)


def redistribute(cfg: GraphConfig, src, dst, capacity: int = 0,
                 cards: Optional[Cards] = None) -> OwnedEdges:
    """Unordered redistribute (paper Alg. 8-9)."""
    if cards is None:
        return _one_card(redistribute, cfg, src, dst, capacity)
    nb, B, S = cfg.nb, cfg.bucket_size, cards.per_card
    cap = capacity or default_capacity(cfg)
    src, dst = [x.reshape(S, -1) for x in src], [x.reshape(S, -1) for x in dst]
    pair = [torch.stack([s, d], dim=-1) for s, d in zip(src, dst)]   # [S, N, 2] a card
    ex = _exchange(pair, [torch.div(s, B, rounding_mode="floor") for s in src], cap, cards)
    del pair
    return OwnedEdges([x[..., 0].reshape(S * nb, cap) for x in ex.data],
                      [x[..., 1].reshape(S * nb, cap) for x in ex.data],
                      [v.reshape(S * nb, cap) for v in ex.valid], ex.dropped)


def redistribute_sorted(cfg: GraphConfig, src, dst, capacity: int = 0,
                        cards: Optional[Cards] = None) -> OwnedEdges:
    """Sorted-merge redistribute (paper §III-B7).  Its three steps are the
    device spans "redistribute.sort", ".exchange" and ".merge", one a card."""
    if cards is None:
        return _one_card(redistribute_sorted, cfg, src, dst, capacity)
    nb, B, S = cfg.nb, cfg.bucket_size, cards.per_card
    cap = capacity or default_capacity(cfg)
    src, dst = [x.reshape(S, -1) for x in src], [x.reshape(S, -1) for x in dst]
    pair, src_s = [], []
    with card_spans("redistribute.sort", cards):
        for s, d in zip(src, dst):
            keys, order = torch.sort(s, dim=1, stable=True)          # send-side sort
            pair.append(torch.stack([keys, torch.gather(d, 1, order)], dim=-1))
            src_s.append(keys)
            del keys, order
    with card_spans("redistribute.exchange", cards):
        ex = _exchange(pair, [torch.div(k, B, rounding_mode="floor") for k in src_s], cap, cards)
        del pair, src_s
    with card_spans("redistribute.merge", cards):
        merged = [merge_runs(data, valid, cfg.n) for data, valid in zip(ex.data, ex.valid)]
        dropped = ex.dropped                                             # receive side
        del ex
    return OwnedEdges(*([m[i].reshape(S * nb, cap) for m in merged] for i in range(3)), dropped)
