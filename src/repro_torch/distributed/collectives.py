"""The k:1 scatter-gather collective on a leading shard dimension (twin of
`repro.distributed.collectives`).

The reference runs these inside `shard_map` over nb devices.  Here all nb
shards live on one device as the leading dimension of each array:

    lax.all_to_all  ->  swap of dims 0 and 1 of [sender, dest, cap, ...]
    lax.ppermute    ->  torch.roll over dim 0   (ring_shift)
    lax.psum        ->  .sum()

`bucket_by_destination`, `unbucket`, `merge_two_sorted` and
`merge_sorted_runs` are per-shard functions with the reference's signatures.
The per-destination counts that place each bucket come from the
`bucket_hist` kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.trace import count, counting
from ..kernels.bucket import bucket_hist

JUNK_ROWS = 1 << 16   # rows past the buckets that take dead records (a power of two)


class Buckets(NamedTuple):
    data: torch.Tensor      # [k, capacity, ...] bucketed payload
    valid: torch.Tensor     # [k, capacity] bool
    position: torch.Tensor  # [N] int64 dest*capacity + slot (k*capacity if dropped)
    dropped: torch.Tensor   # [] int32 records beyond capacity
    counts: torch.Tensor    # [k] int32 records per destination (valid ones), from bucket_hist


def bucket_by_destination(data: torch.Tensor, dest: torch.Tensor, k: int, capacity: int,
                          valid: Optional[torch.Tensor] = None) -> Buckets:
    """Stable bucketing of `data` rows by `dest` in [0, k) with fixed capacity.

    Records keep their relative order within a destination; those past
    `capacity` are counted in `dropped`; rows with valid=False take no slot.
    """
    n = dest.shape[0]
    dev = dest.device
    dest = dest.to(torch.int32)
    if valid is not None:
        dest = torch.where(valid, dest, k)                     # sentinel group
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    # Start of each destination group: exclusive prefix sum of the counts
    # (records with the sentinel k are not counted, so this equals the
    # reference's searchsorted over the sorted destinations).
    hist = bucket_hist(dest, k)
    counts = hist.to(torch.int64)
    group_start = torch.cumsum(counts, 0) - counts
    rank_sorted = (torch.arange(n, dtype=torch.int64, device=dev)
                   - group_start[sorted_dest.clamp(max=k - 1).to(torch.int64)])
    del sorted_dest
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = rank_sorted
    del order, rank_sorted
    real = dest < k
    keep = (rank < capacity) & real
    slot = torch.where(keep, dest.to(torch.int64) * capacity + rank, k * capacity)
    dropped = ((rank >= capacity) & real).sum().to(torch.int32)
    # Records that take no slot are written past the k*capacity slots and
    # cut off below.  A caller that marks dead records (`valid`: 7 in 8 of a
    # walk's rows) gets them spread over JUNK_ROWS rows by rank, since the
    # card serialises writes to one row.  The others drop nothing when sized
    # right, and the spread's three int64 passes would cost the scale-26
    # graph path's redistribute 21 ms on an H100 (scripts/time_generate.py).
    junk, write = 1, slot
    if valid is not None:
        junk, write = JUNK_ROWS, torch.where(keep, slot, slot + (rank & (JUNK_ROWS - 1)))
    del rank, keep, real
    tail = tuple(data.shape[1:])
    flat = torch.zeros((k * capacity + junk,) + tail, dtype=data.dtype, device=dev)
    flat[write] = data
    occupied = torch.zeros(k * capacity + junk, dtype=torch.bool, device=dev)
    occupied.index_fill_(0, write, True)      # a scalar fill: no copy from the host
    return Buckets(
        data=flat[:k * capacity].reshape((k, capacity) + tail),
        valid=occupied[:k * capacity].reshape(k, capacity),
        position=slot,
        dropped=dropped,
        counts=hist,
    )


def unbucket(buckets_data: torch.Tensor, position: torch.Tensor, fill=0) -> torch.Tensor:
    """Inverse of bucket_by_destination for the return trip; dropped records get `fill`."""
    k, capacity = buckets_data.shape[:2]
    flat = buckets_data.reshape((k * capacity,) + tuple(buckets_data.shape[2:]))
    pad = torch.full((1,) + tuple(flat.shape[1:]), fill, dtype=flat.dtype, device=flat.device)
    return torch.cat([flat, pad])[position]


class ExchangeResult(NamedTuple):
    data: torch.Tensor      # [nb, nb, capacity, ...] [receiver, sender] records
    valid: torch.Tensor     # [nb, nb, capacity] bool
    position: torch.Tensor  # [nb, N] each sender's bucketing positions
    dropped: torch.Tensor   # [] int32 dropped over all shards


def capacity_all_to_all(data: torch.Tensor, dest: torch.Tensor, *, capacity: int,
                        valid: Optional[torch.Tensor] = None) -> ExchangeResult:
    """Bucket each shard's records by destination shard and exchange them.

    `data` is [nb, N, ...], `dest` [nb, N] in [0, nb).  Each sender's buckets
    are written straight into the receivers' rows: the all_to_all is the
    [sender, dest] -> [dest, sender] transpose, done while bucketing.  Rows
    with `valid` [nb, N] False are discarded without taking a slot.

    Where a device span records (`core/trace.py`), the exchange counts under
    it the records offered ("rows", dead ones included), those valid
    ("live", from each sender's bucket counts), those given a slot ("kept",
    live less dropped) and the slots ("slots").
    """
    nb = data.shape[0]
    recv = torch.empty((nb, nb, capacity) + tuple(data.shape[2:]), dtype=data.dtype,
                       device=data.device)
    recv_valid = torch.empty((nb, nb, capacity), dtype=torch.bool, device=data.device)
    position = torch.empty(dest.shape, dtype=torch.int64, device=data.device)
    dropped = torch.zeros((), dtype=torch.int32, device=data.device)
    live = [] if counting() else None
    for s in range(nb):
        b = bucket_by_destination(data[s], dest[s], nb, capacity,
                                  valid=None if valid is None else valid[s])
        recv[:, s] = b.data
        recv_valid[:, s] = b.valid
        position[s] = b.position
        dropped += b.dropped
        if live is not None:
            live.append(b.counts)
        del b
    if live is not None:
        live = torch.stack(live).sum()
        count("rows", dest.numel())
        count("live", live)
        count("kept", live - dropped)
        count("slots", nb * nb * capacity)
    return ExchangeResult(recv, recv_valid, position, dropped)


def return_all_to_all(results: torch.Tensor, position: torch.Tensor, *, fill=0) -> torch.Tensor:
    """Return trip: `results` [receiver, sender, cap, ...] go back to their
    senders and are scattered to the original record order ([nb, N, ...])."""
    back = results.transpose(0, 1)
    return torch.stack([unbucket(back[s], position[s], fill=fill)
                        for s in range(results.shape[0])])


def ring_shift(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Shard i receives the block of shard (i + shift) mod nb."""
    return torch.roll(x, -shift, dims=0)


def merge_two_sorted(a: torch.Tensor, b: torch.Tensor, a_payload=None, b_payload=None):
    """Merge two sorted arrays by searchsorted ranks (ties: a before b)."""
    na, nb_ = a.shape[0], b.shape[0]
    dev = a.device
    pos_a = torch.arange(na, device=dev) + torch.searchsorted(b, a, side="left")
    pos_b = torch.arange(nb_, device=dev) + torch.searchsorted(a, b, side="right")
    out = torch.empty(na + nb_, dtype=a.dtype, device=dev)
    out[pos_a] = a
    out[pos_b] = b
    if a_payload is None:
        return out
    pay = torch.empty((na + nb_,) + tuple(a_payload.shape[1:]), dtype=a_payload.dtype, device=dev)
    pay[pos_a] = a_payload
    pay[pos_b] = b_payload
    return out, pay


def merge_sorted_runs(keys: torch.Tensor, payload: Optional[torch.Tensor] = None):
    """K-way merge of k sorted runs [k, run] in log2(k) pairwise rounds."""
    k = keys.shape[0]
    if k & (k - 1):
        raise ValueError(f"k={k} must be a power of two")
    while k > 1:
        pairs = [merge_two_sorted(keys[2 * i], keys[2 * i + 1],
                                  None if payload is None else payload[2 * i],
                                  None if payload is None else payload[2 * i + 1])
                 for i in range(k // 2)]
        if payload is None:
            keys = torch.stack(pairs)
        else:
            keys = torch.stack([p[0] for p in pairs])
            payload = torch.stack([p[1] for p in pairs])
        del pairs
        k //= 2
    if payload is None:
        return keys[0]
    return keys[0], payload[0]
