"""Gradient compression for cross-pod reduction (twin of
`repro/train/compression.py`).

Two compressors, both with error feedback (EF: the residual of each step's
compression is added back before the next step's, so compression error does
not accumulate as bias; Karimireddy et al. 2019):

  int8   per-tensor symmetric quantization (4x traffic vs fp32 / 2x vs bf16)
  topk   keep the largest-|g| fraction per tensor (`torch.topk` in place of
         `lax.top_k`)

`compressed_grads` simulates the numerics inside one train step, EF
included, as the reference does.  `podwise_psum_int8` is the reference's
pod-axis reduction by the port's rule for a mesh axis: the pods are a
leading dimension of each leaf, and `pmax`/`psum` over the axis become a max
and a sum over that dimension.  The pod axis has no NCCL counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import tree


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"        # "none" | "int8" | "topk"
    topk_frac: float = 0.01   # fraction of entries kept by "topk"
    ef: bool = True           # error feedback on/off


# ---------------------------------------------------------------------------
# per-leaf codecs
# ---------------------------------------------------------------------------


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 codes, f32 scale). scale = max|g|/127, per tensor."""
    amax = g.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, 1.0).float()
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    """Boolean mask of the largest-|g| `frac` of entries (>=1 entry)."""
    flat = g.reshape(-1).abs()
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    return g.abs() >= thresh


# ---------------------------------------------------------------------------
# tree-level API with error feedback
# ---------------------------------------------------------------------------


def compress_state_init(cfg: Optional[CompressionConfig], params):
    """EF residual buffers (zeros, param-shaped f32).  Empty tuple if off."""
    if cfg is None or cfg.kind == "none" or not cfg.ef:
        return ()
    return tree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)


def _codec_roundtrip(cfg: CompressionConfig, g: torch.Tensor) -> torch.Tensor:
    if cfg.kind == "int8":
        q, s = quantize_int8(g)
        return dequantize_int8(q, s)
    if cfg.kind == "topk":
        return g * topk_mask(g, cfg.topk_frac)
    raise ValueError(cfg.kind)


def compressed_grads(cfg: CompressionConfig, grads, ef_state):
    """Apply codec (+EF) leaf-wise.  Returns (decoded grads, new EF state)."""
    if cfg.kind == "none":
        return grads, ef_state
    if not ef_state:
        return tree.tree_map(lambda g: _codec_roundtrip(cfg, g.float()), grads), ef_state
    decoded, residual = [], []
    for g, e in zip(tree.leaves(grads), tree.leaves(ef_state)):
        g32 = g.float() + (e if cfg.ef else 0.0)
        dec = _codec_roundtrip(cfg, g32)
        decoded.append(dec)
        residual.append(g32 - dec if cfg.ef else e)
    return tree.unflatten(grads, decoded), tree.unflatten(ef_state, residual)


# ---------------------------------------------------------------------------
# pod-axis compressed mean (the pods a leading dimension)
# ---------------------------------------------------------------------------


def podwise_psum_int8(grads):
    """Mean over the leading pod dimension of every leaf [npods, ...] in int8:
    one global per-tensor scale from the max over the pods, each pod's
    codes against it, the codes summed in int32 (no overflow up to
    127 x npods), dequantized once.  Per-element error is bounded by half a
    quantum regardless of how pod gradients differ.  Returns leaves
    [npods, ...] holding every pod's (equal) result, as the reference's
    psum leaves one on each pod."""
    def leaf(g):
        g = g.float()
        npods = g.shape[0]
        amax = g.abs().reshape(npods, -1).amax(dim=1).max()
        scale = torch.where(amax > 0, amax / 127.0, 1.0)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int32)
        qsum = q.sum(dim=0)
        return (qsum.float() * scale / npods).expand_as(g).clone()

    return tree.tree_map(leaf, grads)
