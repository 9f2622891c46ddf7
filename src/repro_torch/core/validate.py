"""Graph500-style validation of a generated graph, twin of `repro.core.validate`.

The checks and their results are the reference's; they take torch tensors
and run on the tensors' device, so at full size the sorts run on the card.
"""

from __future__ import annotations

from typing import Dict

import torch

from .hostgen import MASK32
from .types import GraphConfig


def check_permutation(pv: torch.Tensor) -> bool:
    """pv hits every id of [0, n)."""
    pv = pv.reshape(-1).to(torch.int64)
    n = pv.shape[0]
    seen = torch.zeros(n, dtype=torch.bool, device=pv.device)
    seen[pv] = True
    return bool(seen.all())


def edge_multiset(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Sorted packed (src << 32 | dst) pairs for a multiset compare."""
    src = src.reshape(-1).to(torch.int64)
    dst = dst.reshape(-1).to(torch.int64)
    return torch.sort((src << 32) | (dst & MASK32)).values


def check_relabel(src, dst, new_src, new_dst, pv, parts: int = 8) -> bool:
    """Multiset of (pv[u], pv[v]) over the generated edges == relabeled edges.

    The pairs are compared in `parts` slices by the range of their relabeled
    source (equal multisets slice by slice iff equal as a whole), so that the
    packed 64-bit pairs of only one slice are alive at a time."""
    pv = pv.reshape(-1)
    want_src = torch.index_select(pv, 0, src.reshape(-1))
    want_dst = torch.index_select(pv, 0, dst.reshape(-1))
    new_src, new_dst = new_src.reshape(-1), new_dst.reshape(-1)
    if want_src.shape != new_src.shape:
        return False
    step = -(-pv.shape[0] // parts)
    compared = 0
    for lo in range(0, pv.shape[0], step):
        w = (want_src >= lo) & (want_src < lo + step)
        g = (new_src >= lo) & (new_src < lo + step)
        want = edge_multiset(want_src[w], want_dst[w])
        del w
        got = edge_multiset(new_src[g], new_dst[g])
        del g
        if not torch.equal(want, got):
            return False
        compared += got.numel()
    # a relabeled source outside [0, n) lies in no slice
    return compared == new_src.numel()


def check_ownership(owned_src, owned_valid, cfg: GraphConfig) -> bool:
    """Every valid edge on shard i has src in [i*B, (i+1)*B)."""
    B = cfg.bucket_size
    src = owned_src.reshape(cfg.nb, -1)
    valid = owned_valid.reshape(cfg.nb, -1)
    lo = (torch.arange(cfg.nb, device=src.device) * B).reshape(-1, 1)
    inside = (src >= lo) & (src < lo + B)
    return bool((inside | ~valid).all())


def check_csr(csr, owned, cfg: GraphConfig) -> Dict[str, bool]:
    """CSR invariants and the adjacency multiset against the owned edges."""
    B = cfg.bucket_size
    offv = csr.offv.reshape(cfg.nb, B + 1)
    adjv = csr.adjv.reshape(cfg.nb, -1)
    src = owned.src.reshape(cfg.nb, -1)
    dst = owned.dst.reshape(cfg.nb, -1)
    valid = owned.valid.reshape(cfg.nb, -1)
    ok_monotone, ok_counts, ok_multiset = True, True, True
    for i in range(cfg.nb):
        o = offv[i].to(torch.int64)
        cnt = int(valid[i].sum())
        deg = torch.diff(o)
        ok_monotone &= bool((deg >= 0).all())
        ok_counts &= int(o[-1]) == cnt
        if not ok_monotone:
            ok_multiset = False
            continue
        rows = torch.repeat_interleave(torch.arange(B, device=o.device), deg) + i * B
        if rows.shape[0] != cnt:
            ok_multiset = False
            continue
        got = edge_multiset(rows, adjv[i][:cnt])
        del rows
        want = edge_multiset(src[i][valid[i]], dst[i][valid[i]])
        ok_multiset &= bool(torch.equal(got, want))
        del got, want
    return {"monotone": ok_monotone, "counts": ok_counts, "multiset": ok_multiset}


def endpoint_skew(src, dst, n: int, frac: int = 16) -> float:
    """Fraction of endpoints in the lowest n/frac ids (1/frac == unbiased)."""
    lo = n // frac
    cnt = int((src < lo).sum()) + int((dst < lo).sum())
    return cnt / float(src.numel() + dst.numel())


def degree_stats(csr, cfg: GraphConfig) -> Dict[str, float]:
    """Max and mean out-degree over every shard's CSR, and the share of
    vertices above 4x the mean (a heavy-tail marker); in float64 on the host,
    as the reference computes them in numpy."""
    offv = csr.offv.detach().cpu().to(torch.int64).reshape(cfg.nb, cfg.bucket_size + 1)
    deg = torch.diff(offv, dim=1).reshape(-1).numpy()
    return {
        "max_degree": float(deg.max()),
        "mean_degree": float(deg.mean()),
        "gini_proxy": float((deg > 4 * deg.mean()).mean()),
    }
