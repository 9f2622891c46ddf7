"""K-way merge of each receiver's sorted runs, the receive side of
`redistribute_sorted`: CUDA kernel + plain version.

It replaces no Pallas kernel.  The reference merges each receiver's nb runs
by log2(nb) rounds of pairwise searchsorted merges
(`repro/distributed/collectives.py::merge_sorted_runs`); the plain version
here is that loop, over `distributed/collectives.py::merge_sorted_runs`.
The kernel (`csrc/graph_kernels.cu`, `merge_runs_kernel`) is bound by bytes:
it reads each live record once and writes every output slot once.  It cuts
each receiver's output into tiles of TILE records, finds every run's split
at each tile start (a co-rank search on the key, ties handed out in sender
order, first at every FAN-th tile, then inside those chunks), merges a
tile's segments in shared memory and zero-fills past the live records: four
launches in all, whatever nb.

It relies on what `bucket_by_destination` gives each (receiver, sender)
bucket: its live slots are a prefix, sorted by source, stably.  Keys are the
sources, all below n, so the plain version's sentinel n orders every empty
slot after them: both give the stable merge by key (ties to the lower
sender, then the lower slot), then src 0, dst 0, valid False.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.trace import count, counting
from ..distributed.collectives import merge_sorted_runs
from . import build

TILE = 4096          # outputs a block merges (kMergeTile)
FAN = 16             # tiles a chunk of the first split search (kMergeFan)
MAX_RUNS = 32        # senders, one lane each in the split search (kMergeMaxRuns)


def _check(data: torch.Tensor, valid: torch.Tensor) -> None:
    if data.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"merge_runs takes int32 records and bool valid, got {data.dtype} "
                        f"and {valid.dtype}")
    if data.dim() != 4 or data.shape[3] != 2 or tuple(valid.shape) != tuple(data.shape[:3]):
        raise ValueError(f"merge_runs takes data [receivers, nb, cap, 2] and valid [receivers, "
                         f"nb, cap], got {tuple(data.shape)} and {tuple(valid.shape)}")
    if not (data.is_contiguous() and valid.is_contiguous()):
        raise ValueError("merge_runs takes contiguous data and valid")
    if data.device != valid.device:
        raise ValueError(f"merge_runs: data on {data.device}, valid on {valid.device}")


def merge_runs_plain(data: torch.Tensor, valid: torch.Tensor, n: int):
    """Plain version: each receiver's runs keyed by source, empty slots by
    the sentinel n, merged by `merge_sorted_runs` with (dst, valid) as the
    payload."""
    receivers, nb, cap = data.shape[:3]
    out_src = torch.empty((receivers, nb * cap), dtype=data.dtype, device=data.device)
    out_dst = torch.empty((receivers, nb * cap), dtype=data.dtype, device=data.device)
    out_valid = torch.empty((receivers, nb * cap), dtype=torch.bool, device=data.device)
    for r in range(receivers):
        rs, rd, rv = data[r, ..., 0], data[r, ..., 1], valid[r]
        keys = torch.where(rv, rs, n)
        payload = torch.stack([rd, rv.to(rd.dtype)], dim=-1)
        mkeys, mpay = merge_sorted_runs(keys, payload)
        mvalid = mpay[:, 1].to(torch.bool)
        out_src[r] = torch.where(mvalid, mkeys, 0)
        out_dst[r] = mpay[:, 0]
        out_valid[r] = mvalid
        del rs, rd, rv, keys, payload, mkeys, mpay, mvalid
    return out_src, out_dst, out_valid


def merge_runs(data: torch.Tensor, valid: torch.Tensor,
               n: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """out_src, out_dst [receivers, nb * cap] int32 and out_valid
    [receivers, nb * cap] bool: receiver r's runs data[r] ([nb senders, cap]
    (src, dst) records, the live ones valid[r]'s prefixes) merged by source,
    sources below n.  One card's receivers are all nb shards, or its share
    of them where the shards lie on several cards.

    Where a device span records (`core/trace.py`), it counts under it the
    live records merged ("live") and those the kernel merged ("kernel",
    0 on the plain path)."""
    _check(data, valid)
    if data.device.type == "cpu":
        out = merge_runs_plain(data, valid, n)
        if counting():
            count("live", valid.sum())
            count("kernel", 0)
        return out
    if data.device.type != "cuda":
        raise ValueError(f"merge_runs: unsupported device {data.device}")
    receivers, nb, cap = data.shape[:3]
    row = nb * cap
    if nb > MAX_RUNS or row >= 1 << 31:
        raise ValueError(f"merge_runs kernel takes nb <= {MAX_RUNS} and nb * cap < 2^31, "
                         f"got nb {nb}, cap {cap}")
    if data.data_ptr() % 8:
        raise ValueError("merge_runs kernel takes data on an 8-byte boundary")
    dev = data.device
    tiles, chunks = -(-row // TILE), -(-row // (TILE * FAN))
    bounds = torch.empty((receivers, 2, nb), dtype=torch.int32, device=dev)
    coarse = torch.empty((receivers, chunks + 1, nb), dtype=torch.int32, device=dev)
    fine = torch.empty((receivers, tiles + 1, nb), dtype=torch.int32, device=dev)
    out_src = torch.empty((receivers, row), dtype=torch.int32, device=dev)
    out_dst = torch.empty((receivers, row), dtype=torch.int32, device=dev)
    out_valid = torch.empty((receivers, row), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = build.library().merge_runs_launch(
            data.data_ptr(), valid.data_ptr(), receivers, nb, cap, bounds.data_ptr(),
            coarse.data_ptr(), fine.data_ptr(), out_src.data_ptr(), out_dst.data_ptr(),
            out_valid.data_ptr(), stream)
    build.check(err, "merge_runs")
    build.LAUNCHES["merge_runs"] += 1
    if counting():
        live = bounds[:, 1].sum()
        count("live", live)
        count("kernel", live)
    return out_src, out_dst, out_valid
