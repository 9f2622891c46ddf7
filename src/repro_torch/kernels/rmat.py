"""R-MAT edges and the keyed Feistel permutation: CUDA kernels + plain versions.

`rmat_edges` replaces `repro/kernels/rmat.py::rmat_edges_pallas` and
`feistel_perm` replaces `repro/kernels/rmat.py::feistel_perm_pallas`; the
kernels are in `csrc/graph_kernels.cu`.  A wrapper runs the plain version for
a CPU device or tensor, launches the kernel for a CUDA one, and raises for
anything the kernel does not take.  Both are integer-ALU bound (see the
source).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.hostgen import FEISTEL_ROUNDS, MASK32, feistel_round_key
from ..core.types import GraphConfig, quadrant_thresholds
from ..device import resolve_device
from . import build
from .ref import counter_uniform_u32, mix32

MAX_FEISTEL_ROUNDS = 8


def rmat_edges_plain(cfg: GraphConfig, start: int, count: int,
                     device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: `count` edges with global ids [start, start+count) mod 2**32."""
    t_src, t_dst0, t_dst1 = quadrant_thresholds(cfg)
    dev = torch.device(device)
    idx = (torch.arange(count, dtype=torch.int64, device=dev) + (int(start) & MASK32)) & MASK32
    src = torch.zeros(count, dtype=torch.int64, device=dev)
    dst = torch.zeros(count, dtype=torch.int64, device=dev)
    for level in range(cfg.scale):
        r1 = counter_uniform_u32(cfg.seed, idx, 2 * level)
        r2 = counter_uniform_u32(cfg.seed, idx, 2 * level + 1)
        src_bit = r1 < t_src
        dst_bit = r2 < torch.where(src_bit, t_dst1, t_dst0)
        src = ((src << 1) | src_bit.to(torch.int64)) & MASK32
        dst = ((dst << 1) | dst_bit.to(torch.int64)) & MASK32
    return src.to(torch.int32), dst.to(torch.int32)


def rmat_edges(cfg: GraphConfig, start: int, count: int,
               device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 (src, dst) of the edges with global ids [start, start+count)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return rmat_edges_plain(cfg, start, count, dev)
    if not 1 <= cfg.scale <= 31:
        raise ValueError(f"rmat_edges kernel needs 1 <= scale <= 31, got {cfg.scale}")
    src = torch.empty(count, dtype=torch.int32, device=dev)
    dst = torch.empty(count, dtype=torch.int32, device=dev)
    if count == 0:
        return src, dst
    t_src, t_dst0, t_dst1 = quadrant_thresholds(cfg)
    with torch.cuda.device(dev):
        err = build.library().rmat_edges_launch(
            src.data_ptr(), dst.data_ptr(), count, int(start) & MASK32, cfg.seed & MASK32,
            cfg.scale, t_src, t_dst0, t_dst1, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "rmat_edges")
    build.LAUNCHES["rmat_edges"] += 1
    return src, dst


def _check_feistel(nbits: int, rounds: int) -> None:
    if rounds < 2 or rounds % 2:
        raise ValueError(f"feistel rounds must be even and >= 2, got {rounds}")
    if not 1 <= nbits <= 31:
        raise ValueError(f"int32 feistel needs 1 <= nbits <= 31, got {nbits}")


def feistel_perm_plain(x: torch.Tensor, key: int, nbits: int,
                       rounds: int = FEISTEL_ROUNDS) -> torch.Tensor:
    """Plain version: keyed unbalanced Feistel bijection on [0, 2**nbits)."""
    _check_feistel(nbits, rounds)
    lo_bits = nbits // 2
    v = x.to(torch.int64) & MASK32
    L = v >> lo_bits
    R = v & ((1 << lo_bits) - 1)
    wL, wR = nbits - lo_bits, lo_bits
    for i in range(rounds):
        F = mix32(R ^ feistel_round_key(key, i))
        L, R, wL, wR = R, (L ^ F) & ((1 << wL) - 1), wR, wL
    return ((L << lo_bits) | R).to(torch.int32)


def feistel_perm(x: torch.Tensor, key: int, nbits: int,
                 rounds: int = FEISTEL_ROUNDS) -> torch.Tensor:
    """Permute int32 ids through the keyed Feistel bijection on [0, 2**nbits)."""
    _check_feistel(nbits, rounds)
    if x.dtype != torch.int32:
        raise TypeError(f"feistel_perm takes int32, got {x.dtype}")
    if x.device.type == "cpu":
        return feistel_perm_plain(x, key, nbits, rounds)
    if x.device.type != "cuda":
        raise ValueError(f"feistel_perm: unsupported device {x.device}")
    if rounds > MAX_FEISTEL_ROUNDS:
        raise ValueError(f"feistel_perm kernel takes at most {MAX_FEISTEL_ROUNDS} rounds")
    if not x.is_contiguous():
        raise ValueError("feistel_perm kernel takes a contiguous tensor")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    keys = (ctypes.c_uint * MAX_FEISTEL_ROUNDS)(
        *[feistel_round_key(key, i) for i in range(rounds)])
    with torch.cuda.device(x.device):
        err = build.library().feistel_perm_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), nbits, rounds, keys,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "feistel_perm")
    build.LAUNCHES["feistel_perm"] += 1
    return out
