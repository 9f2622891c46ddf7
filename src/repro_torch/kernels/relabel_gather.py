"""The merge-join gather of the ring relabel: CUDA kernel + plain version.

Replaces `repro/kernels/relabel_gather.py::relabel_gather_pallas`: keys in
[base, base + len(chunk)) become `chunk[key - base]`, every other key passes
through.  The kernel (`csrc/graph_kernels.cu`) is bound by bytes.
"""

from __future__ import annotations

import torch

from . import build


def relabel_gather_plain(keys: torch.Tensor, chunk: torch.Tensor, base: int) -> torch.Tensor:
    """Plain version of the masked gather."""
    B = chunk.shape[0]
    local = keys.to(torch.int64) - int(base)
    in_range = (local >= 0) & (local < B)
    gathered = chunk[local.clamp(0, B - 1)]
    return torch.where(in_range, gathered, keys)


def relabel_gather(keys: torch.Tensor, chunk: torch.Tensor, base: int) -> torch.Tensor:
    """int32 keys relabeled through the int32 pv chunk that starts at `base`."""
    if keys.dtype != torch.int32 or chunk.dtype != torch.int32:
        raise TypeError(f"relabel_gather takes int32, got {keys.dtype} and {chunk.dtype}")
    if keys.dim() != 1 or chunk.dim() != 1 or chunk.shape[0] == 0:
        raise ValueError("relabel_gather takes 1-D keys and a non-empty 1-D chunk")
    if keys.device != chunk.device:
        raise ValueError(f"keys on {keys.device}, chunk on {chunk.device}")
    if keys.device.type == "cpu":
        return relabel_gather_plain(keys, chunk, base)
    if keys.device.type != "cuda":
        raise ValueError(f"relabel_gather: unsupported device {keys.device}")
    if not (keys.is_contiguous() and chunk.is_contiguous()):
        raise ValueError("relabel_gather kernel takes contiguous tensors")
    out = torch.empty_like(keys)
    if keys.numel() == 0:
        return out
    with torch.cuda.device(keys.device):
        err = build.library().relabel_gather_launch(
            keys.data_ptr(), chunk.data_ptr(), out.data_ptr(), keys.numel(), chunk.numel(),
            int(base), torch.cuda.current_stream(keys.device).cuda_stream)
    build.check(err, "relabel_gather")
    build.LAUNCHES["relabel_gather"] += 1
    return out
