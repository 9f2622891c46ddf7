"""Relabel edges through the permutation vector (paper Alg. 6-7), twin of
`repro.core.relabel`.

relabel_ring (paper-faithful): each shard sorts the field being relabeled
and the pv chunks stream past it in nb ring rounds.  In a round the keys
that fall in the resident chunk form one contiguous segment of the sorted
field (the paper's merge cursor).  On one device every chunk is resident,
and the nb segments of a row are the whole row, so the nb^2 segments of a
field are relabeled by one `relabel_gather` launch over all nb sorted rows
against pv at base 0.  Every key in [0, n) lies in exactly one chunk, so
this gives the same bits as the reference's masked gather in every round;
a key outside [0, n) passes through.

relabel_recompute: elementwise keyed Feistel, no pv (the `feistel_perm`
kernel).  relabel_alltoall: one bucketed round trip to the owners of the
raw ids.

Inputs src/dst are [nb, N] (or flat [nb*N]) and pv is flat [n].
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..distributed.collectives import capacity_all_to_all, return_all_to_all
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


def relabel_ring(cfg: GraphConfig, src: torch.Tensor, dst: torch.Tensor,
                 pv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper-faithful relabel: dst pass, then src pass.  Returns [nb, N] each."""
    nb = cfg.nb
    new_dst = _relabel_field_ring(_shards(dst, nb), pv.reshape(-1))
    new_src = _relabel_field_ring(_shards(src, nb), pv.reshape(-1))
    return new_src, new_dst


def relabel_recompute(cfg: GraphConfig, src: torch.Tensor,
                      dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Communication-free relabel: (perm(src), perm(dst)) elementwise."""
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
