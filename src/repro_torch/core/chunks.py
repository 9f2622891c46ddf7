"""The disk tier's per-chunk hot loops on the graph kernels.

The out-of-core generator (`core/phases.py`, `core/external.py`) is the
reference's host code, copied; four of its numpy loops compute what a kernel
of the port computes, and go through these hooks instead:

  rmat_chunk          R-MAT edges of one chunk            -> `rmat_edges`
  graph_perm_chunk    the keyed Feistel relabel u->pv[u]  -> `feistel_perm`
  partition_chunk     per-destination counts + stable order of one run
                                                          -> `bucket_hist`
  gather_chunk        the pv join's gather vals[keys - base]
                                                          -> `relabel_gather`

Each takes numpy columns and a device and returns numpy arrays (int64,
C-contiguous) equal to the reference's: on a CUDA device the kernel runs, on
the CPU its plain PyTorch version (the path the tests hold against the
reference).  There is no numpy fallback.  Every kernel takes int32 values:
ids lie below 2^scale and the disk tier refuses scale > 31
(`phases.plain_config`), so each hook checks its range and raises
`ValueError` outside it.  Device work stays on the caller's thread; the
disk tier's I/O threads move numpy only.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import bucket, relabel_gather, rmat
from .hostgen import FEISTEL_ROUNDS, MASK32, graph_perm_key, perm_domain_bits

INT32_MAX = (1 << 31) - 1


def to_tensor(x: np.ndarray, dev: torch.device, dtype=torch.int64) -> torch.Tensor:
    """A numpy column on `dev`.  Read-only arrays (memmaps) and strided
    column views are copied first: torch takes neither as it stands."""
    a = np.asarray(x)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")
    return torch.from_numpy(a).to(dev, dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64, C-contiguous numpy of a tensor on any device."""
    return t.to(torch.int64).contiguous().cpu().numpy()


def rmat_chunk(pcfg, start: int, count: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """int64 (src, dst) of the edges with global ids [start, start+count) mod
    2^32: `hostgen.rmat_edges_np_cfg` through the `rmat_edges` kernel.  A
    start outside [0, 2^32) raises the reference's `OverflowError` (its
    `np.uint32(start)`); a chunk that runs past 2^32 wraps, as there."""
    dev = resolve_device(device)
    if not 0 <= int(start) <= MASK32:
        raise OverflowError(f"Python integer {int(start)} out of bounds for uint32")
    if not 1 <= pcfg.scale <= 31:
        raise ValueError(f"rmat_chunk: int32 ids need 1 <= scale <= 31, got {pcfg.scale}")
    src, dst = rmat.rmat_edges(pcfg, start, count, dev)
    return to_numpy(src), to_numpy(dst)


def graph_perm_chunk(seed: int, x: np.ndarray, n: int, rounds: int = FEISTEL_ROUNDS,
                     device="cuda") -> np.ndarray:
    """pv[x] of the recomputable family, `hostgen.graph_perm_np` through the
    `feistel_perm` kernel.  For n that is not a power of two the cycle walk
    re-permutes the ids that left [0, n) outside the kernel, as the
    reference does; for n = 2^scale it never runs."""
    dev = resolve_device(device)
    nbits = perm_domain_bits(n)
    if nbits > 31:
        raise ValueError(f"graph_perm_chunk: int32 ids need n <= 2^31, got {n}")
    x = np.asarray(x)
    flat = np.atleast_1d(x).astype(np.int64)
    if flat.size and (flat.min() < 0 or flat.max() >= n):
        raise ValueError(f"keyed_perm_np: inputs must lie in [0, {n})")
    key = graph_perm_key(seed)
    out = rmat.feistel_perm(to_tensor(flat, dev, torch.int32), key, nbits, rounds)
    bad = out >= n
    while bool(bad.any()):
        out[bad] = rmat.feistel_perm(out[bad], key, nbits, rounds)
        bad = out >= n
    return to_numpy(out).reshape(np.shape(x))


def partition_chunk(cols: Sequence[np.ndarray], part_of: Callable, nparts: int, device,
                    name: str) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
    """One run of `blockstore.partition_runs`: the columns stable-sorted by
    destination bucket and the rows of each bucket.

    `part_of` maps the columns (int64 tensors on the device) to bucket ids;
    `bucket_hist` counts them, `torch.argsort(stable=True)` orders them.
    Ids outside [0, nparts) are clamped to -1 or nparts before the int32
    cast, so the kernel counts none of them, and a count short of the rows
    raises the reference's `ValueError`."""
    dev = resolve_device(device)
    tcols = [to_tensor(c, dev) for c in cols]
    rows = tcols[0].shape[0]
    dest = part_of(*tcols).to(torch.int64)
    counts = bucket.bucket_hist(dest.clamp(-1, nparts).to(torch.int32).contiguous(), nparts)
    if int(counts.sum()) != rows:
        bad = dest[(dest < 0) | (dest >= nparts)]
        raise ValueError(
            f"partition_runs: part_of produced bucket {int(bad[0])} outside "
            f"[0, {nparts}) for {bad.numel()} record(s) of store "
            f"'{name}' — a bad owner function would silently "
            "shrink the record stream")
    order = torch.argsort(dest, stable=True)
    return tuple(to_numpy(c[order]) for c in tcols), to_numpy(counts)


def gather_chunk(keys: np.ndarray, vals: torch.Tensor, base: int) -> np.ndarray:
    """vals[keys - base] for keys in [base, base + len(vals)), through the
    `relabel_gather` kernel on `vals`' device (vals: int32, already there)."""
    if base + vals.shape[0] - 1 > INT32_MAX:
        raise ValueError(f"gather_chunk: int32 keys need base + rows <= 2^31, got {base}")
    out = relabel_gather.relabel_gather(to_tensor(keys, vals.device, torch.int32), vals, base)
    return to_numpy(out)


def table_block(vals: np.ndarray, device) -> torch.Tensor:
    """One block of a lookup table as int32 on the device (`gather_chunk`'s
    `vals`); its values are vertex ids, below 2^31."""
    dev = resolve_device(device)
    if vals.size and (int(vals.min()) < 0 or int(vals.max()) > INT32_MAX):
        raise ValueError("table_block: the table's values do not fit int32")
    return to_tensor(vals, dev, torch.int32)
