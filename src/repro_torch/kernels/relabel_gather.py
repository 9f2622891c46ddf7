"""The merge-join gather of the ring relabel: CUDA kernel + plain version.

Replaces `repro/kernels/relabel_gather.py::relabel_gather_pallas`: keys in
[base, base + len(chunk)) become `chunk[key - base]`, every other key passes
through.  The kernel (`csrc/graph_kernels.cu`) is bound by bytes.  Keys are
1-D, or 2-D rows (the ring relabel's sorted [nb, N] field, whose rows the
kernel walks side by side); `out`, of the keys' shape, may be a view or the
keys themselves.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build


def relabel_gather_plain(keys: torch.Tensor, chunk: torch.Tensor, base: int,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the masked gather (into `out` when given)."""
    B = chunk.shape[0]
    local = keys.to(torch.int64) - int(base)
    in_range = (local >= 0) & (local < B)
    gathered = chunk[local.clamp(0, B - 1)]
    res = torch.where(in_range, gathered, keys)
    return res if out is None else out.copy_(res)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() < b.data_ptr() + 4 * b.numel()
            and b.data_ptr() < a.data_ptr() + 4 * a.numel())


def relabel_gather(keys: torch.Tensor, chunk: torch.Tensor, base: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 keys relabeled through the int32 pv chunk that starts at `base`,
    written into `out` (a new tensor when None) and returned."""
    if keys.dtype != torch.int32 or chunk.dtype != torch.int32:
        raise TypeError(f"relabel_gather takes int32, got {keys.dtype} and {chunk.dtype}")
    if keys.dim() not in (1, 2) or chunk.dim() != 1 or chunk.shape[0] == 0:
        raise ValueError("relabel_gather takes 1-D or 2-D keys and a non-empty 1-D chunk")
    if keys.device != chunk.device:
        raise ValueError(f"keys on {keys.device}, chunk on {chunk.device}")
    if out is not None and (out.dtype != torch.int32 or out.shape != keys.shape
                            or out.device != keys.device):
        raise ValueError(f"relabel_gather: out must be int32 {tuple(keys.shape)} on {keys.device}, "
                         f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    if keys.device.type == "cpu":
        return relabel_gather_plain(keys, chunk, base, out)
    if keys.device.type != "cuda":
        raise ValueError(f"relabel_gather: unsupported device {keys.device}")
    if out is None:
        out = torch.empty_like(keys, memory_format=torch.contiguous_format)
    if not (keys.is_contiguous() and chunk.is_contiguous() and out.is_contiguous()):
        raise ValueError("relabel_gather kernel takes contiguous tensors")
    if _overlap(out, chunk) or (_overlap(out, keys) and out.data_ptr() != keys.data_ptr()):
        raise ValueError("relabel_gather: out overlaps the chunk, or the keys other than exactly")
    if keys.numel() == 0:
        return out
    rows, row_len = (1, keys.numel()) if keys.dim() == 1 else keys.shape
    with torch.cuda.device(keys.device):
        err = build.library().relabel_gather_launch(
            keys.data_ptr(), chunk.data_ptr(), out.data_ptr(), rows, row_len, chunk.numel(),
            int(base), torch.cuda.current_stream(keys.device).cuda_stream)
    build.check(err, "relabel_gather")
    build.LAUNCHES["relabel_gather"] += 1
    return out
