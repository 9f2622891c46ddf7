"""Plain reference of the distributed random walks (DeepWalk's corpus over
the generated graph, with walkers moved between shards before every hop).

The rule, written from its semantics: walker w of shard s = w // W starts
at s * B + rand(seed ^ 0xA5A5, w, 0) % B; at hop t it draws r = rand(seed,
w, t + 1), moves to a uniform neighbour adjv[offv[p] + r % deg(p)], or to
r % n when p has no edge.  rand(k, w, t) = mix32((mix32(w ^ k) + t *
GOLDEN) mod 2**32).

The rows: before every hop each live walker goes to the shard that owns its
vertex.  A sender keeps its rows' order within each destination, and a
receiver holds cp slots per sender, sender-major; a walker past its pair's
cp slots is dropped.  After the walk, a row holds (history, valid, walker
id), and a row no walker reached holds zeros and is not valid.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .graph import GOLDEN, MASK32, mix32


def walk_rand(seed: int, walker: torch.Tensor, step: int) -> torch.Tensor:
    s = seed & MASK32
    return mix32((mix32(walker ^ s) + ((step * GOLDEN) & MASK32)) & MASK32)


def rows(nb: int, walkers: int, capacity_factor: float):
    """(cp, cap): slots per sender and receiver, and rows per shard."""
    cp = max(1, int(math.ceil(walkers * capacity_factor / nb)))
    return cp, cp * nb


def walks(offv: torch.Tensor, adjv: torch.Tensor, *, n: int, nb: int, walkers: int, length: int,
          seed: int, capacity_factor: float,
          multiply_high: bool = False) -> Dict[str, torch.Tensor]:
    """The walk over the global CSR (offv [n+1] int64, adjv int32): for each
    walker still live at the end, its row in [0, nb*cap) (`rows`), its id
    (`wid`, int32) and its history (`hist`, int32 [live, length+1]); and
    the dropped count.  With `multiply_high` a hop picks neighbour
    (r * deg) >> 32 instead of r % deg: the control, not the rule."""
    dev = offv.device
    B = n // nb
    cp, cap = rows(nb, walkers, capacity_factor)
    total = nb * walkers
    wid = torch.arange(total, dtype=torch.int64, device=dev)
    shard = wid // walkers
    row = wid % walkers                                    # before the first exchange
    pos = shard * B + walk_rand(seed ^ 0xA5A5, wid, 0) % B
    hist = torch.zeros((total, length + 1), dtype=torch.int32, device=dev)
    hist[:, 0] = pos.to(torch.int32)
    live = torch.ones(total, dtype=torch.bool, device=dev)
    dropped = 0
    for t in range(length):
        # the exchange: sender `shard`, receiver `owner`, rank in the sender's row order
        lw = torch.nonzero(live).reshape(-1)
        owner = pos[lw] // B
        key = (shard[lw] * nb + owner) * cap + row[lw]
        order = torch.argsort(key)
        pair = (key // cap)[order]
        counts = torch.bincount(pair, minlength=nb * nb)
        first = torch.cumsum(counts, 0) - counts
        rank = torch.arange(lw.numel(), device=dev) - first[pair]
        w = lw[order]
        kept = rank < cp
        dropped += int((~kept).sum())
        live[w[~kept]] = False
        w, rank = w[kept], rank[kept]
        row[w] = shard[w] * cp + rank
        shard[w] = pos[w] // B
        # the hop
        p = pos[w]
        start = offv[p]
        deg = offv[p + 1] - start
        r = walk_rand(seed, w, t + 1)
        pick = (r * deg) >> 32 if multiply_high else r % deg.clamp(min=1)
        nxt = torch.where(deg > 0, adjv[(start + pick).clamp(max=adjv.numel() - 1)].to(torch.int64),
                          r % n)
        pos[w] = nxt
        hist[w, t + 1] = nxt.to(torch.int32)
    w = torch.nonzero(live).reshape(-1)
    return {"rows": shard[w] * cap + row[w], "wid": w.to(torch.int32), "hist": hist[w],
            "dropped": dropped, "total_rows": nb * cap}


def as_rows(walk: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`walks`' live walkers laid out as all nb*cap rows (hist, valid, wid)."""
    total, rows_ = walk["total_rows"], walk["rows"]
    hist = walk["hist"].new_zeros((total, walk["hist"].shape[1]))
    hist[rows_] = walk["hist"]
    valid = torch.zeros(total, dtype=torch.bool, device=rows_.device)
    valid[rows_] = True
    wid = walk["wid"].new_zeros(total)
    wid[rows_] = walk["wid"]
    return {"hist": hist, "valid": valid, "wid": wid}
