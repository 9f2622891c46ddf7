"""Per-destination histogram that plans the buckets: CUDA kernel + plain version.

Replaces `repro/kernels/bucket.py::bucket_hist_pallas`: counts of int32 ids
in [0, k); any other id (the pad value k in particular) is not counted.  The
kernel (`csrc/graph_kernels.cu`) keeps a shared-memory histogram per block
and is bound by bytes.
"""

from __future__ import annotations

import torch

from . import build

MAX_K = 8192          # bins held in one block's shared memory (32 KiB)
_BLOCKS_PER_SM = 8


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
    counts = torch.empty(k, dtype=torch.int32, device=dest.device)
    sms = torch.cuda.get_device_properties(dest.device).multi_processor_count
    with torch.cuda.device(dest.device):
        err = build.library().bucket_hist_launch(
            dest.data_ptr(), dest.numel(), k, counts.data_ptr(), sms * _BLOCKS_PER_SM,
            torch.cuda.current_stream(dest.device).cuda_stream)
    build.check(err, "bucket_hist")
    build.LAUNCHES["bucket_hist"] += 1
    return counts
