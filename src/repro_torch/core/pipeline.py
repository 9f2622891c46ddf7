"""End-to-end graph generation (the paper's top-level routine), twin of
`repro.core.pipeline`:

    shuffle -> generate edges -> relabel -> redistribute -> build CSR

on nb shards held as the leading dimension of one device's arrays.  Each
phase's inputs are dropped as soon as the next phase has consumed them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..device import resolve_device
from .csr import CSRShards, build_csr_scatter, build_csr_sorted
from .hashing import hash_relabel
from .hostgen import MASK32
from .redistribute import OwnedEdges, redistribute, redistribute_sorted
from .relabel import relabel_alltoall, relabel_recompute, relabel_ring
from .rmat import rmat_edge_block
from .shuffle import distributed_shuffle, shuffle_argsort, shuffle_recompute
from .types import GraphConfig

SHUFFLE_VARIANTS = ("paper", "argsort", "recompute")


class GraphResult(NamedTuple):
    pv: torch.Tensor          # [n]
    src: torch.Tensor         # [m] relabeled, generation order
    dst: torch.Tensor         # [m]
    owned: OwnedEdges
    csr: CSRShards
    dropped_relabel: torch.Tensor
    dropped_redistribute: torch.Tensor


def generate_edges(cfg: GraphConfig, device="cuda"):
    """Paper Alg. 5: shard bid generates the edges [bid*eps, (bid+1)*eps).

    Returns (src, dst), each int32 [nb, eps]."""
    dev = resolve_device(device)
    eps = cfg.edges_per_shard
    src = torch.empty((cfg.nb, eps), dtype=cfg.vertex_dtype, device=dev)
    dst = torch.empty_like(src)
    for bid in range(cfg.nb):
        src[bid], dst[bid] = rmat_edge_block(cfg, (bid * eps) & MASK32, eps, dev)
    return src, dst


def generate(cfg: GraphConfig, shuffle_variant: str = "paper", device="cuda",
             phase_hook: Optional[Callable[[str], None]] = None) -> GraphResult:
    """Run the full pipeline on `device`.

    `phase_hook(name)`, when given, is called as each phase ends ("shuffle",
    "edges", "relabel", "redistribute", "csr"), so that a caller can time
    the phases; it does not change the result.
    """
    dev = resolve_device(device)
    if shuffle_variant not in SHUFFLE_VARIANTS:
        raise ValueError(shuffle_variant)
    if cfg.relabel_variant not in ("ring", "alltoall"):
        raise ValueError(cfg.relabel_variant)
    if cfg.csr_variant not in ("sorted", "scatter"):
        raise ValueError(cfg.csr_variant)
    hook = phase_hook or (lambda name: None)

    # 1. permutation phase
    if shuffle_variant == "paper":
        pv = distributed_shuffle(cfg, dev)
    elif shuffle_variant == "argsort":
        pv = shuffle_argsort(cfg, dev)
    else:
        # pv is materialized only because GraphResult exposes it; the
        # relabel below recomputes labels and never reads it.
        pv = shuffle_recompute(cfg, dev)
    hook("shuffle")

    # 2. edge generation phase
    src, dst = generate_edges(cfg, dev)
    hook("edges")

    # 3. relabeling phase
    dropped_rel = torch.zeros((), dtype=torch.int32, device=dev)
    if shuffle_variant == "recompute":
        new_src, new_dst = relabel_recompute(cfg, src, dst)
    elif cfg.relabel_variant == "ring":
        new_src, new_dst = relabel_ring(cfg, src, dst, pv)
    else:
        new_src, new_dst, dropped_rel = relabel_alltoall(cfg, src, dst, pv)
    del src, dst
    hook("relabel")

    # 4 + 5. redistribute + CSR
    if cfg.csr_variant == "sorted":
        owned = redistribute_sorted(cfg, new_src, new_dst)
        hook("redistribute")
        csr = build_csr_sorted(cfg, owned)
    else:
        owned = redistribute(cfg, new_src, new_dst)
        hook("redistribute")
        csr = build_csr_scatter(cfg, owned)
    hook("csr")
    return GraphResult(pv, new_src.reshape(-1), new_dst.reshape(-1), owned, csr,
                       dropped_rel, owned.dropped)


def generate_baseline_hash(cfg: GraphConfig, device="cuda"):
    """Graph500 'hashing based' kernel: generate, hash-relabel, sort, CSR.
    Returns (offv [n+1] int32, dst sorted by src [m])."""
    dev = resolve_device(device)
    src, dst = rmat_edge_block(cfg, 0, cfg.m, dev)
    src, dst = hash_relabel(cfg, src, dst)
    src_s, order = torch.sort(src, stable=True)
    dst_s = dst[order]
    del src, dst, order
    targets = torch.arange(cfg.n + 1, dtype=src_s.dtype, device=dev)
    offv = torch.searchsorted(src_s, targets, side="left", out_int32=True)
    return offv, dst_s
