"""Fault-tolerant checkpointing (twin of `repro/train/checkpoint.py`).

Protocol (per checkpoint step):
  1. write every leaf to   <dir>/tmp.step_<N>/<leaf>.npy
  2. write manifest.json   (step, leaf names with shapes and dtypes, extra)
  3. fsync + atomic rename tmp.step_<N> -> step_<N>

A reader only trusts directories with a valid manifest whose listed files all
exist with the right shapes and dtypes: a crash mid-save leaves a tmp.*
directory that is ignored and GC'd (after 60 s), never a half-trusted
checkpoint.  keep=k older checkpoints are retained for corrupt-latest
fallback.

A state is a tree of tensors (`train/tree.py`).  Leaf names join a leaf's
path (NamedTuple fields, dict keys, list indices) with ".", as the
reference's `_leaf_name` does, so a TrainState's leaves are
`params.blocks.0.attn.wq`, `opt.mu....`, `step`.
Leaves are stored as whole logical arrays, so a checkpoint restores onto any
device (the reference's re-mesh restore; no shardings on one card).

bfloat16: numpy has no such dtype (and `ml_dtypes`, which would give it one,
is not a dependency of the port), so a bf16 leaf is stored as its 16-bit
patterns, a uint16 .npy, with dtype "bfloat16" in the manifest; a reader
accepts such a file only where the manifest says "bfloat16", and restore
reinterprets the bits.  Every other dtype is stored as itself.

Async: save(..., blocking=False) snapshots every leaf to host memory before
its writer thread starts, so the next step's in-place updates cannot reach
the files; training continues during the disk I/O.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import tree

MANIFEST = "manifest.json"
BF16 = "bfloat16"


def _leaf_name(path) -> str:
    return ".".join(str(k) for k in path) or "root"


def _flatten(state) -> Tuple[List[str], List[Any]]:
    flat = tree.leaves_with_path(state)
    names = [_leaf_name(p) for p, _ in flat]
    if len(set(names)) != len(names):
        raise ValueError("leaf name collision")
    return names, [leaf for _, leaf in flat]


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(a host copy of the tensor as numpy, its manifest dtype)."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _stored_dtype(manifest_dtype: str) -> str:
    return "uint16" if manifest_dtype == BF16 else manifest_dtype


def save(ckpt_dir: str, step: int, state: Any, *, keep: int = 3,
         blocking: bool = True, extra: Optional[Dict] = None) -> str:
    """Write checkpoint for `step`.  Returns the final directory path."""
    names, leaves = _flatten(state)
    # snapshot to host before returning (async-safe: the next step updates
    # the state's tensors in place)
    host = [_to_host(leaf) for leaf in leaves]

    def _write():
        tmp = os.path.join(ckpt_dir, f"tmp.step_{step:08d}")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "leaves": {},
                    "extra": extra or {}}
        for name, (arr, dtype) in zip(names, host):
            np.save(os.path.join(tmp, name + ".npy"), arr)
            manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)
        return final

    if blocking:
        return _write()
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    save._last_thread = t  # tests join() this
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def wait_for_async_saves():
    t = getattr(save, "_last_thread", None)
    if t is not None:
        t.join()


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
    # stale tmp dirs from crashed saves
    for d in os.listdir(ckpt_dir):
        if d.startswith("tmp.step_"):
            full = os.path.join(ckpt_dir, d)
            if time.time() - os.path.getmtime(full) > 60:
                shutil.rmtree(full, ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.isfile(os.path.join(ckpt_dir, d, MANIFEST)):
            out.append(int(d[len("step_"):]))
    return sorted(out)


def _manifest(ckpt_dir: str, step: int) -> Dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", MANIFEST)) as f:
        return json.load(f)


def _valid(ckpt_dir: str, step: int) -> bool:
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        manifest = _manifest(ckpt_dir, step)
        for name, meta in manifest["leaves"].items():
            p = os.path.join(d, name + ".npy")
            if not os.path.isfile(p):
                return False
            arr = np.load(p, mmap_mode="r")
            if list(arr.shape) != meta["shape"] or str(arr.dtype) != _stored_dtype(meta["dtype"]):
                return False
        return True
    except (OSError, ValueError, KeyError, TypeError):
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest step whose manifest fully validates (corrupt-latest fallback)."""
    for s in reversed(all_steps(ckpt_dir)):
        if _valid(ckpt_dir, s):
            return s
    return None


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Load checkpoint `step` into the structure of `like`: each leaf on its
    `like` leaf's device, in its dtype, requiring grad where it does."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    metas = _manifest(ckpt_dir, step)["leaves"]
    names, like_leaves = _flatten(like)
    leaves = []
    for name, ref in zip(names, like_leaves):
        if name not in metas:
            raise ValueError(f"checkpoint step {step} has no leaf {name}")
        arr = np.load(os.path.join(d, name + ".npy"))
        dtype = metas[name]["dtype"]
        if str(arr.dtype) != _stored_dtype(dtype):
            raise ValueError(f"{name}: stored {arr.dtype}, manifest says {dtype}")
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape}, state {tuple(ref.shape)}")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if dtype == BF16 \
            else torch.from_numpy(arr)
        t = t.to(device=ref.device, dtype=ref.dtype)
        leaves.append(t.requires_grad_(ref.requires_grad))
    return tree.unflatten(like, leaves)


def restore_latest(ckpt_dir: str, like: Any):
    """(state, step) from the newest valid checkpoint, or (None, None)."""
    s = latest_step(ckpt_dir)
    if s is None:
        return None, None
    return restore(ckpt_dir, s, like), s
