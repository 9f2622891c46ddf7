"""Relabel edges through the permutation vector (paper Alg. 6-7), twin of
`repro.core.relabel`.

relabel_ring (paper-faithful): each shard sorts the field being relabeled
and the pv chunks stream past it in nb ring rounds.  In a round the keys
that fall in the resident chunk form one contiguous segment of the sorted
field (the paper's merge cursor).  A card holds the pv chunks of its own
shards; the ring first gathers the others' (`all_gather`: on one card
nothing moves, on D cards each receives (D - 1) / D of pv, once a call,
for both fields).  Then every chunk is resident on every card, and the nb
segments of a row are the whole row, so the segments of a card's field are
relabeled by one `relabel_gather` launch over its sorted rows against pv
at base 0.  Every key in [0, n) lies in exactly one chunk, so this gives
the same bits as the reference's masked gather in every round; a key
outside [0, n) passes through.

relabel_recompute: elementwise keyed Feistel, no pv (the `feistel_perm`
kernel).  relabel_alltoall: one bucketed round trip to the owners of the
raw ids.

Inputs src/dst are [nb, N] (or flat [nb*N]) and pv is flat [n]; with
`cards`, each is a list of one block a card ([per_card, N] fields, flat
pv blocks) and so is the result.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..distributed.collectives import Cards, all_gather, capacity_all_to_all, return_all_to_all
from ..kernels.relabel_gather import relabel_gather
from .shuffle import graph_perm
from .types import GraphConfig


def _relabel_field_ring(field: torch.Tensor, pv: torch.Tensor) -> torch.Tensor:
    """Relabel field [nb, N] through the flat pv [n] by the ring merge-join:
    all nb ring rounds of every shard in one gather, in place on the sorted
    field."""
    sorted_field, sort_idx = torch.sort(field, dim=1)       # paper: chunk-sort
    out_sorted = relabel_gather(sorted_field, pv, 0, out=sorted_field)
    # scatter back to generation order
    return torch.empty_like(field).scatter_(1, sort_idx, out_sorted)


def _shards(x: torch.Tensor, nb: int) -> torch.Tensor:
    return x.reshape(nb, -1)


def relabel_ring(cfg: GraphConfig, src, dst, pv, cards: Optional[Cards] = None):
    """Paper-faithful relabel: dst pass, then src pass.  Returns [nb, N] each
    (with `cards`, a list of [per_card, N] blocks each)."""
    if cards is None:
        new_src, new_dst = relabel_ring(cfg, [src], [dst], [pv], Cards((src.device,), cfg.nb))
        return new_src[0], new_dst[0]
    S = cards.per_card
    pv_all = all_gather(pv, cards)
    new_dst = [_relabel_field_ring(_shards(f, S), p) for f, p in zip(dst, pv_all)]
    new_src = [_relabel_field_ring(_shards(f, S), p) for f, p in zip(src, pv_all)]
    return new_src, new_dst


def relabel_recompute(cfg: GraphConfig, src, dst, cards: Optional[Cards] = None):
    """Communication-free relabel: (perm(src), perm(dst)) elementwise, on
    each card where its block lies when `cards` is given."""
    if cards is not None:
        pairs = [relabel_recompute(cfg, s, d) for s, d in zip(src, dst)]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return (graph_perm(cfg.seed, src, cfg.n, rounds=cfg.feistel_rounds),
            graph_perm(cfg.seed, dst, cfg.n, rounds=cfg.feistel_rounds))


def relabel_alltoall(cfg: GraphConfig, src: torch.Tensor, dst: torch.Tensor, pv: torch.Tensor,
                     capacity: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both fields in one bucketed round trip.  Returns (new_src, new_dst, dropped)."""
    nb, B = cfg.nb, cfg.bucket_size
    if capacity == 0:
        capacity = int(cfg.capacity_factor * 2 * cfg.edges_per_shard / max(nb, 1)) + 8
    q = torch.cat([_shards(src, nb), _shards(dst, nb)], dim=1)          # [nb, 2N]
    ex = capacity_all_to_all(q, torch.div(q, B, rounding_mode="floor"), capacity=capacity)
    del q
    pv_sh = _shards(pv, nb)
    base = (torch.arange(nb, device=pv.device) * B).reshape(nb, 1, 1)
    local = (ex.data.to(torch.int64) - base).clamp(0, B - 1)
    answered = torch.gather(pv_sh, 1, local.reshape(nb, -1)).reshape(local.shape)
    answered = torch.where(ex.valid, answered, 0)
    back = return_all_to_all(answered, ex.position)
    new_src, new_dst = back.chunk(2, dim=1)
    return new_src, new_dst, ex.dropped
