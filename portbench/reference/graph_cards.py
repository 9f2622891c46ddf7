"""Plain reference of a graph whose nb shards lie on several cards: each
card computes the pieces of the shards placed on it, where they lie.

It builds on `portbench/reference/graph.py` (the edges, the permutations
and the CSR offsets of one shard) and shares no code with the program.
Every card computes pv whole, then the relabelled edges its own shards
generated.  A receiver's owned edges are those whose relabelled source it
owns: each sender keeps, for each receiver, the first `capacity` of them in
(source, generation) order, found as one range of its edges sorted stably
by source (the owner grows with the source), and ships them to the
receiver's card (through the host, which holds them meanwhile), which sorts
what its senders kept by source, stably: equal sources stay in sender
order, which is generation order.

`placement` names which shards a card holds: "consecutive" (card c the
shards [c * nb/D, (c+1) * nb/D), the program's) or "round_robin" (card c
the shards c, c + D, ...: a control, not the program's).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import torch

from portbench.reference import graph as G

PLACEMENTS = ("consecutive", "round_robin")

Piece = Tuple[str, torch.Tensor]


def shards_of(nb: int, cards: int, card: int, placement: str = "consecutive") -> List[int]:
    """The shards card `card` of `cards` holds."""
    per = nb // cards
    if placement == "consecutive":
        return list(range(card * per, (card + 1) * per))
    if placement == "round_robin":
        return list(range(card, nb, cards))
    raise ValueError(placement)


def sender_edges(spec: G.GraphSpec, pv: Sequence[torch.Tensor],
                 held: Sequence[Sequence[int]]) -> List[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """For each card c, int32 (src, dst) of the edges each of its shards
    held[c] generated, relabelled through its pv[c], in generation order,
    on that card.  The blocks are issued to the cards in turn, so that all
    of them work at once."""
    eps = spec.generated
    out = [[(torch.empty(eps, dtype=torch.int32, device=p.device),
             torch.empty(eps, dtype=torch.int32, device=p.device)) for _ in h]
           for p, h in zip(pv, held)]
    for i in range(len(held[0])):
        for off in range(0, eps, G.EDGE_BLOCK):
            count = min(G.EDGE_BLOCK, eps - off)
            for c, p in enumerate(pv):
                s, d = G.rmat_block(spec, held[c][i] * eps + off, count, p.device)
                out[c][i][0][off:off + count] = p[s.to(torch.int64)]
                out[c][i][1][off:off + count] = p[d.to(torch.int64)]
    return out


def kept_by_receiver(spec: G.GraphSpec, src: torch.Tensor,
                     dst: torch.Tensor) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], int]:
    """One sender's kept edges for each receiver, each in (source,
    generation) order, and the count it dropped."""
    s_sorted, order = torch.sort(src, stable=True)
    d_sorted = dst[order]
    del order
    bounds = torch.arange(spec.nb + 1, dtype=torch.int32, device=src.device) * spec.owned
    edges = torch.searchsorted(s_sorted, bounds).tolist()
    out, dropped = [], 0
    for r in range(spec.nb):
        lo, hi = edges[r], edges[r + 1]
        take = min(hi - lo, spec.capacity)
        dropped += hi - lo - take
        out.append((s_sorted[lo:lo + take], d_sorted[lo:lo + take]))
    return out, dropped


def receiver_pieces(spec: G.GraphSpec, r: int, parts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    device) -> Iterator[Piece]:
    """Shard r's owned edges and CSR from its senders' kept edges (in
    sender order), as `portbench/loops/common.py::reference_pieces` lays
    them out."""
    s = torch.cat([p[0].to(device) for p in parts])
    d = torch.cat([p[1].to(device) for p in parts])
    key = s.to(torch.int64) * spec.n + d.to(torch.int64) if spec.ties_by_dst else s
    order = torch.sort(key, stable=True).indices
    del key
    s, d = s[order], d[order]
    del order
    count = s.numel()
    pad = torch.zeros(spec.nb * spec.capacity - count, dtype=torch.int32, device=device)
    yield "owned_src", torch.cat([s, pad])
    yield "owned_dst", torch.cat([d, pad])
    yield "owned_valid", torch.arange(spec.nb * spec.capacity, device=device) < count
    yield "offv", G.csr_offsets(spec, s, r)
    yield "adjv", torch.cat([d, pad])
    yield "num_edges", torch.tensor([count], dtype=torch.int32, device=device)


def card_pieces(spec: G.GraphSpec, devices: Sequence, placement: str = "consecutive",
                stats: Dict = None) -> Iterator[Tuple[int, str, torch.Tensor]]:
    """(card, name, piece) of the graph with each card's pieces on it: for
    every card its part of pv, then the relabelled sources and destinations
    its shards generated; then for every card and each of its shards the
    owned edges and CSR; last the edges dropped, on the first card."""
    devices = [torch.device(d) for d in devices]
    held = [shards_of(spec.nb, len(devices), c, placement) for c in range(len(devices))]
    pv = [G.permutation(spec, dev) for dev in devices]          # every card's work at once
    B = spec.owned
    edges = sender_edges(spec, pv, held)
    for c, dev in enumerate(devices):
        yield c, "pv", torch.cat([pv[c][g * B:(g + 1) * B] for g in held[c]])
        yield c, "src", torch.cat([e[0] for e in edges[c]])
        yield c, "dst", torch.cat([e[1] for e in edges[c]])
    del pv
    by_sender, dropped = {}, 0
    for c in range(len(devices)):
        for g, (s, d) in zip(held[c], edges[c]):
            kept, lost = kept_by_receiver(spec, s, d)
            by_sender[g] = [(a.cpu(), b.cpu()) for a, b in kept]    # the cards keep room to sort
            dropped += lost
            del kept
        edges[c] = None
    for c, dev in enumerate(devices):
        for r in held[c]:
            parts = [by_sender[g][r] for g in range(spec.nb)]
            for name, piece in receiver_pieces(spec, r, parts, dev):
                yield c, name, piece
            for g in range(spec.nb):
                by_sender[g][r] = None
    if stats is not None:
        stats["dropped"] = dropped
    yield 0, "dropped", torch.tensor([dropped], dtype=torch.int32, device=devices[0])
