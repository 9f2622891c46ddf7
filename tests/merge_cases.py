"""Exchanges built as `redistribute_sorted` builds them, for the tests of
`kernels/merge.py` on the CPU and on the card: each sender's (src, dst) rows
sorted by source, stably, then bucketed to the receivers by
`capacity_all_to_all`.  No jax here."""

from __future__ import annotations

import torch

from repro_torch.distributed.collectives import capacity_all_to_all


def exchange(nb: int, per_sender: int, n: int, cap: int, seed: int, hub: int = 0,
             empty_receiver=None, device="cpu"):
    """The exchange of nb senders' `per_sender` edges with sources in [0, n):
    `hub` edges of every sender share one source (a tie across all senders);
    no source falls to `empty_receiver`; a bucket over `cap` drops."""
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(0, n, (nb, per_sender), generator=g, dtype=torch.int64)
    if hub:
        src[:, :hub] = n // 2 + 1
    B = n // nb
    if empty_receiver is not None:
        src = torch.where(src // B == empty_receiver, (src + B) % n, src)
    dst = torch.randint(0, n, (nb, per_sender), generator=g, dtype=torch.int32)
    src_s, order = torch.sort(src.to(torch.int32), dim=1, stable=True)
    pair = torch.stack([src_s, torch.gather(dst, 1, order)], dim=-1).to(device)
    dest = torch.div(src_s, B, rounding_mode="floor").to(torch.int64).to(device)
    return capacity_all_to_all(pair, dest, capacity=cap)

