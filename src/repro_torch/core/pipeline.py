"""End-to-end graph generation (the paper's top-level routine), twin of
`repro.core.pipeline`:

    shuffle -> generate edges -> relabel -> redistribute -> build CSR

on nb shards placed on one device, as the leading dimension of its arrays,
or on a list of devices (the reference's mesh: shard i on device i // (nb /
D)), each holding its consecutive shards' block and exchanging with the
others.  Each phase's inputs are dropped as soon as the next phase has
consumed them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from ..device import resolve_device
from ..distributed.collectives import Cards, card_spans, card_streams, place
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
    """On one device, the arrays below; on a list of devices, each array is
    a list of one block a card (its shards' rows, in the same layout:
    concatenated in card order they are the one-device arrays), and the
    dropped counts are summed on the first card."""

    pv: torch.Tensor          # [n]
    src: torch.Tensor         # [m] relabeled, generation order
    dst: torch.Tensor         # [m]
    owned: OwnedEdges
    csr: CSRShards
    dropped_relabel: torch.Tensor
    dropped_redistribute: torch.Tensor


def placement(nb: int, device) -> Cards:
    """The cards that `device` names: one device, or a list or tuple of them
    (1 or more; nb a multiple of their count)."""
    if isinstance(device, (list, tuple)):
        return place(nb, [resolve_device(d) for d in device])
    return Cards((resolve_device(device),), nb)


def generate_edges(cfg: GraphConfig, device="cuda"):
    """Paper Alg. 5: shard bid generates the edges [bid*eps, (bid+1)*eps),
    on the card that holds it.

    Returns (src, dst), each int32 [nb, eps] (a list of [per_card, eps]
    blocks where `device` is a list, or a `Cards`)."""
    cards = device if isinstance(device, Cards) else placement(cfg.nb, device)
    eps, S = cfg.edges_per_shard, cards.per_card
    src, dst = [], []
    for c, dev in enumerate(cards.devices):
        s = torch.empty((S, eps), dtype=cfg.vertex_dtype, device=dev)
        d = torch.empty_like(s)
        for i in range(S):
            bid = cards.first(c) + i
            s[i], d[i] = rmat_edge_block(cfg, (bid * eps) & MASK32, eps, dev)
        src.append(s)
        dst.append(d)
    if isinstance(device, (Cards, list, tuple)):
        return src, dst
    return src[0], dst[0]


def generate(cfg: GraphConfig, shuffle_variant: str = "paper", device="cuda",
             phase_hook: Optional[Callable[[str], None]] = None) -> GraphResult:
    """Run the full pipeline on `device`: one device, or a list of them over
    which the nb shards are placed (shard i on device i // (nb / D)).  Each
    phase is called in its one-device form, or with the placement (`cards`)
    on lists of one block a card.

    `phase_hook(name)`, when given, is called as each phase ends ("shuffle",
    "edges", "relabel", "redistribute", "csr"), so that a caller can time
    the phases; it does not change the result.  Over several cards each
    card's work runs on a stream of its own (`card_streams`), and its whole
    call is the device span "generate.card" on it.
    """
    cards = placement(cfg.nb, device)
    if shuffle_variant not in SHUFFLE_VARIANTS:
        raise ValueError(shuffle_variant)
    if cfg.relabel_variant not in ("ring", "alltoall"):
        raise ValueError(cfg.relabel_variant)
    if cfg.csr_variant not in ("sorted", "scatter"):
        raise ValueError(cfg.csr_variant)
    blocks = isinstance(device, (list, tuple))
    if blocks and (shuffle_variant == "argsort" or cfg.relabel_variant == "alltoall"):
        raise ValueError("the argsort shuffle and the all_to_all relabel run on one device")
    kw = {"cards": cards} if blocks else {}
    flat = (lambda x: [b.reshape(-1) for b in x]) if blocks else (lambda x: x.reshape(-1))
    hook = phase_hook or (lambda name: None)
    dev = cards.devices[0]
    spans = card_spans("generate.card", cards) if cards.count > 1 else contextlib.nullcontext()
    with card_streams(cards), spans:
        # 1. permutation phase
        if shuffle_variant == "paper":
            pv = distributed_shuffle(cfg, dev, **kw)
        elif shuffle_variant == "argsort":
            pv = shuffle_argsort(cfg, dev)
        else:
            # pv is materialized only because GraphResult exposes it; the
            # relabel below recomputes labels and never reads it.
            pv = shuffle_recompute(cfg, dev, **kw)
        hook("shuffle")

        # 2. edge generation phase
        src, dst = generate_edges(cfg, cards if blocks else dev)
        hook("edges")

        # 3. relabeling phase
        dropped_rel = torch.zeros((), dtype=torch.int32, device=dev)
        if shuffle_variant == "recompute":
            new_src, new_dst = relabel_recompute(cfg, src, dst, **kw)
        elif cfg.relabel_variant == "ring":
            new_src, new_dst = relabel_ring(cfg, src, dst, pv, **kw)
        else:
            new_src, new_dst, dropped_rel = relabel_alltoall(cfg, src, dst, pv)
        del src, dst
        hook("relabel")

        # 4 + 5. redistribute + CSR
        if cfg.csr_variant == "sorted":
            owned = redistribute_sorted(cfg, new_src, new_dst, **kw)
            hook("redistribute")
            csr = build_csr_sorted(cfg, owned, **kw)
        else:
            owned = redistribute(cfg, new_src, new_dst, **kw)
            hook("redistribute")
            csr = build_csr_scatter(cfg, owned, **kw)
        hook("csr")
    return GraphResult(pv, flat(new_src), flat(new_dst), owned, csr, dropped_rel, owned.dropped)


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
