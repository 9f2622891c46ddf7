"""Redistribute relabeled edges to their owners (paper Alg. 8-9, §III-B7),
twin of `repro.core.redistribute`.

An edge is owned by the shard whose range contains its relabeled source.
  redistribute         unordered: one capacity_all_to_all
  redistribute_sorted  senders sort by source (stably), the stable bucketing
                       keeps each packet sorted, each receiver k-way merges
                       its nb runs (`kernels/merge.py::merge_runs`, one
                       launch for all receivers on a card): its edges come
                       out sorted by source.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..distributed.collectives import capacity_all_to_all
from ..kernels.merge import merge_runs
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
        out_src, out_dst, out_valid = merge_runs(ex.data, ex.valid, cfg.n)   # receive side
        dropped = ex.dropped
        del ex
    return OwnedEdges(out_src.reshape(nb * nb, cap), out_dst.reshape(nb * nb, cap),
                      out_valid.reshape(nb * nb, cap), dropped)
