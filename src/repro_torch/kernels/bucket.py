"""Per-destination histogram that plans the buckets: CUDA kernel + plain version.

Replaces `repro/kernels/bucket.py::bucket_hist_pallas`: counts of int32 ids
in [0, k); any other id (the pad value k in particular) is not counted.  The
kernel (`csrc/graph_kernels.cu`) streams the ids with 16-byte loads and is
bound by bytes; for k <= 32 each thread counts in registers, above that each
block keeps histograms in shared memory.  One launch does all: every block
writes its counts to a scratch row and the last block to finish sums them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build

MAX_K = 8192              # bins held in one block's shared memory (32 KiB)
THREADS = 256             # threads per block (kHistThreads)
TILE_IDS = 4096           # ids per block and tile: 256 threads x 4 int4 loads
BLOCKS_PER_SM = 4         # resident blocks the grid is sized for
REGISTER_BINS = (4, 8, 16, 32)
SMEM_BYTES = 32 << 10     # shared histograms per block (one per warp where they fit)
PARTIAL_ROWS_IDS = 1 << 18  # grid * k at most this, so the last block's sum stays short


class HistPlan(NamedTuple):
    bins: int      # register bins K (a power of two >= k), or 0: shared-memory histograms
    grid: int      # blocks; also the rows of the [grid, k] partial-count scratch
    copies: int    # shared-memory histograms per block (bins == 0), else 1


def plan(n: int, k: int, sms: int) -> HistPlan:
    """Kernel variant, grid and scratch for n ids and k bins on `sms` SMs: no
    more blocks than the card holds at once or the ids can feed (one tile of
    TILE_IDS each), and for large k few enough that the partial counts stay
    within PARTIAL_ROWS_IDS."""
    bins = next((b for b in REGISTER_BINS if b >= k), 0)
    grid = max(1, min(sms * BLOCKS_PER_SM, -(-n // TILE_IDS), PARTIAL_ROWS_IDS // k))
    warps = THREADS // 32
    copies = warps if bins == 0 and 4 * k * warps <= SMEM_BYTES else 1
    return HistPlan(bins, grid, copies)


def bucket_hist_plain(dest: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: one compare-and-reduce per bin, as the TPU kernel does."""
    return torch.stack([(dest == j).sum() for j in range(k)]).to(torch.int32)


def bucket_hist(dest: torch.Tensor, k: int) -> torch.Tensor:
    """int32 counts [k] of the int32 ids in `dest` that lie in [0, k)."""
    if dest.dtype != torch.int32 or dest.dim() != 1:
        raise TypeError(f"bucket_hist takes 1-D int32, got {dest.dtype} {tuple(dest.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"bucket_hist needs 1 <= k <= {MAX_K}, got {k}")
    if dest.device.type == "cpu":
        return bucket_hist_plain(dest, k)
    if dest.device.type != "cuda":
        raise ValueError(f"bucket_hist: unsupported device {dest.device}")
    if not dest.is_contiguous():
        raise ValueError("bucket_hist kernel takes a contiguous tensor")
    n = dest.numel()
    if n >= 1 << 31:
        raise ValueError(f"bucket_hist kernel takes fewer than 2^31 ids, got {n}")
    p = plan(n, k, torch.cuda.get_device_properties(dest.device).multi_processor_count)
    counts = torch.empty(k, dtype=torch.int32, device=dest.device)
    partials = torch.empty(p.grid * k, dtype=torch.int32, device=dest.device)
    stream = torch.cuda.current_stream(dest.device).cuda_stream
    ticket = build.counters(dest.device, stream, 1)
    with torch.cuda.device(dest.device):
        err = build.library().bucket_hist_launch(
            dest.data_ptr(), n, k, p.bins, p.grid, p.copies, partials.data_ptr(),
            ticket.data_ptr(), counts.data_ptr(), stream)
    build.check(err, "bucket_hist")
    build.LAUNCHES["bucket_hist"] += 1
    return counts
