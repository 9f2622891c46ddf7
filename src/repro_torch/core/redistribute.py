"""Redistribute relabeled edges to their owners (paper Alg. 8-9, §III-B7),
twin of `repro.core.redistribute`.

An edge is owned by the shard whose range contains its relabeled source.
  redistribute         unordered: one capacity_all_to_all
  redistribute_sorted  senders sort by source (stably), the stable bucketing
                       keeps each packet sorted, each receiver k-way merges
                       its nb runs: its edges come out sorted by source.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..distributed.collectives import capacity_all_to_all, merge_sorted_runs
from .trace import device_span
from .types import GraphConfig


class OwnedEdges(NamedTuple):
    """Owned edges with a validity mask; global shape [nb*nb, capacity]
    (rows [i*nb, (i+1)*nb) belong to shard i, one row per sender)."""

    src: torch.Tensor
    dst: torch.Tensor
    valid: torch.Tensor
    dropped: torch.Tensor


def default_capacity(cfg: GraphConfig) -> int:
    return int(cfg.capacity_factor * cfg.edges_per_shard / max(cfg.nb, 1)) + 8


def redistribute(cfg: GraphConfig, src: torch.Tensor, dst: torch.Tensor,
                 capacity: int = 0) -> OwnedEdges:
    """Unordered redistribute (paper Alg. 8-9)."""
    nb, B = cfg.nb, cfg.bucket_size
    cap = capacity or default_capacity(cfg)
    src, dst = src.reshape(nb, -1), dst.reshape(nb, -1)
    pair = torch.stack([src, dst], dim=-1)                          # [nb, N, 2]
    ex = capacity_all_to_all(pair, torch.div(src, B, rounding_mode="floor"), capacity=cap)
    del pair
    return OwnedEdges(ex.data[..., 0].reshape(nb * nb, cap), ex.data[..., 1].reshape(nb * nb, cap),
                      ex.valid.reshape(nb * nb, cap), ex.dropped)


def redistribute_sorted(cfg: GraphConfig, src: torch.Tensor, dst: torch.Tensor,
                        capacity: int = 0) -> OwnedEdges:
    """Sorted-merge redistribute (paper §III-B7).  Its three steps are the
    device spans "redistribute.sort", ".exchange" and ".merge"."""
    nb, B = cfg.nb, cfg.bucket_size
    cap = capacity or default_capacity(cfg)
    src, dst = src.reshape(nb, -1), dst.reshape(nb, -1)
    with device_span("redistribute.sort", src.device):
        src_s, order = torch.sort(src, dim=1, stable=True)          # send-side sort
        pair = torch.stack([src_s, torch.gather(dst, 1, order)], dim=-1)
        del order
    with device_span("redistribute.exchange", src.device):
        ex = capacity_all_to_all(pair, torch.div(src_s, B, rounding_mode="floor"), capacity=cap)
        del pair, src_s
    with device_span("redistribute.merge", src.device):
        out_src = torch.empty((nb, nb * cap), dtype=src.dtype, device=src.device)
        out_dst = torch.empty((nb, nb * cap), dtype=dst.dtype, device=dst.device)
        out_valid = torch.empty((nb, nb * cap), dtype=torch.bool, device=src.device)
        for r in range(nb):
            rs, rd, rv = ex.data[r, ..., 0], ex.data[r, ..., 1], ex.valid[r]
            # receive-side k-way merge; empty slots get the sentinel key n.
            keys = torch.where(rv, rs, cfg.n)
            payload = torch.stack([rd, rv.to(rd.dtype)], dim=-1)
            mkeys, mpay = merge_sorted_runs(keys, payload)
            mvalid = mpay[:, 1].to(torch.bool)
            out_src[r] = torch.where(mvalid, mkeys, 0)
            out_dst[r] = mpay[:, 0]
            out_valid[r] = mvalid
            del rs, rd, rv, keys, payload, mkeys, mpay, mvalid
        dropped = ex.dropped
        del ex
    return OwnedEdges(out_src.reshape(nb * nb, cap), out_dst.reshape(nb * nb, cap),
                      out_valid.reshape(nb * nb, cap), dropped)
