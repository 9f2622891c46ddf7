"""Build the CSR representation (paper Alg. 1, 10, 11, §III-B7), twin of
`repro.core.csr`.

Shard i owns rows [i*B, (i+1)*B): offv [B+1] local offsets, adjv [nb*cap]
destinations with a valid prefix of num_edges[i] entries.
  build_csr_scatter  degrees by scatter-add, placement by a stable sort on row
  build_csr_sorted   input sorted by source: offsets by searchsorted, adjv verbatim
Both run on each card's own shards where `cards` is given (`OwnedEdges`
over cards), and then give lists of one block a card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..distributed.collectives import Cards
from .redistribute import OwnedEdges
from .types import GraphConfig


class CSRShards(NamedTuple):
    """One card's arrays, or over cards a list of each card's block
    ([per_card*(B+1)], [per_card*cap_m], [per_card])."""

    offv: torch.Tensor       # [nb*(B+1)]
    adjv: torch.Tensor       # [nb*cap_m]
    num_edges: torch.Tensor  # [nb]


def _per_shard(owned: OwnedEdges, nb: int):
    return (owned.src.reshape(nb, -1), owned.dst.reshape(nb, -1), owned.valid.reshape(nb, -1))


def _bases(cfg: GraphConfig, device, first: int = 0, count: Optional[int] = None) -> torch.Tensor:
    """The first vertex of shards [first, first + count) (all nb by default)."""
    count = cfg.nb if count is None else count
    return (torch.arange(first, first + count, dtype=torch.int64, device=device)
            * cfg.bucket_size).reshape(-1, 1)


def _on_cards(build, cfg: GraphConfig, owned: OwnedEdges, cards: Cards) -> CSRShards:
    """`build` on each card's own shards."""
    parts = [build(cfg, OwnedEdges(s, d, v, owned.dropped), cards.first(c), cards.per_card)
             for c, (s, d, v) in enumerate(zip(owned.src, owned.dst, owned.valid))]
    return CSRShards(*([p[i] for p in parts] for i in range(3)))


def build_csr_scatter(cfg: GraphConfig, owned: OwnedEdges, first: int = 0,
                      count: Optional[int] = None, cards: Optional[Cards] = None) -> CSRShards:
    """Unordered-input CSR (paper Alg. 10/11 with sort-rank placement) of
    shards [first, first + count), all of them by default."""
    if cards is not None:
        return _on_cards(build_csr_scatter, cfg, owned, cards)
    nb, B = (cfg.nb if count is None else count), cfg.bucket_size
    s, d, v = _per_shard(owned, nb)
    rows = (s.to(torch.int64) - _bases(cfg, s.device, first, nb)).clamp(0, B - 1)
    degv = torch.zeros((nb, B), dtype=torch.int32, device=s.device)
    degv.scatter_add_(1, rows, v.to(torch.int32))
    offv = torch.cat([torch.zeros((nb, 1), dtype=torch.int32, device=s.device),
                      torch.cumsum(degv, 1, dtype=torch.int32)], dim=1)
    del degv
    # stable sort by row (invalid -> B sinks to the end) is the placement
    rows = torch.where(v, rows, B)
    order = torch.argsort(rows, dim=1, stable=True)
    del rows
    cnt = v.sum(1, dtype=torch.int32)
    pos = torch.arange(s.shape[1], device=s.device).reshape(1, -1)
    adjv = torch.where(pos < cnt.reshape(-1, 1), torch.gather(d, 1, order), 0)
    return CSRShards(offv.reshape(-1), adjv.reshape(-1), cnt)


def build_csr_sorted(cfg: GraphConfig, owned: OwnedEdges, first: int = 0,
                     count: Optional[int] = None, cards: Optional[Cards] = None) -> CSRShards:
    """Sorted-input CSR (paper Alg. 1) of shards [first, first + count), all
    of them by default: input must be redistribute_sorted output."""
    if cards is not None:
        return _on_cards(build_csr_sorted, cfg, owned, cards)
    nb, B = (cfg.nb if count is None else count), cfg.bucket_size
    s, d, v = _per_shard(owned, nb)
    cnt = v.sum(1, dtype=torch.int32)
    keyed = torch.where(v, s - _bases(cfg, s.device, first, nb).to(s.dtype), B)
    targets = torch.arange(B + 1, dtype=keyed.dtype, device=s.device).expand(nb, B + 1).contiguous()
    offv = torch.searchsorted(keyed, targets, side="left", out_int32=True)
    del keyed, targets
    pos = torch.arange(d.shape[1], device=s.device).reshape(1, -1)
    adjv = torch.where(pos < cnt.reshape(-1, 1), d, 0)
    return CSRShards(offv.reshape(-1), adjv.reshape(-1), cnt)


def csr_global(csr: CSRShards, cfg: GraphConfig):
    """One (offv [n+1] int64, adjv [m]) pair from the distributed CSR, on its device."""
    B, nb = cfg.bucket_size, cfg.nb
    cnt = csr.num_edges.to(torch.int64)
    base = torch.cumsum(cnt, 0) - cnt
    offv = csr.offv.reshape(nb, B + 1)[:, :-1].to(torch.int64) + base.reshape(-1, 1)
    offv = torch.cat([offv.reshape(-1), cnt.sum().reshape(1)])
    adjv_s = csr.adjv.reshape(nb, -1)
    return offv, torch.cat([adjv_s[i, :c] for i, c in enumerate(csr.num_edges.tolist())])


def csr_to_host(csr: CSRShards, cfg: GraphConfig):
    """One host (offv [n+1] int64, adjv [m]) numpy pair from the distributed CSR."""
    return tuple(t.cpu().numpy() for t in csr_global(csr, cfg))


def csr_neighbors(csr: CSRShards, cfg: GraphConfig, v: int) -> torch.Tensor:
    """Adjacency list of global vertex v."""
    B = cfg.bucket_size
    shard, row = divmod(v, B)
    offv = csr.offv.reshape(cfg.nb, B + 1)[shard]
    adjv = csr.adjv.reshape(cfg.nb, -1)[shard]
    return adjv[int(offv[row]):int(offv[row + 1])]
