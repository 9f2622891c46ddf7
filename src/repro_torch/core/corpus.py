"""Sharded walk-corpus manifest — the multi-host collect format (twin of
`repro.core.corpus`).

The single-workdir collect (one `walks.npy` memmap assembled on the driver)
cannot exist on a real cluster: no host's disk is required to hold the full
corpus.  Instead the collect phase leaves the corpus as **per-bucket shard
files** — bucket j's shard holds the walker block [w0, w1) that j's
history-gather kernel owns — plus one small JSON manifest describing them:

    {"version": 1, "num_walkers": W, "length": L, "dtype": "<i8",
     "shards": [{"bucket": 0, "w0": 0, "w1": 8, "path": "walks_b000.npy",
                 "host": 0}, ...]}

Shard paths are stored relative to the manifest's directory when the shard
lives under it (single-host layout: everything in one workdir, so a
checkpointed workdir can still be moved), absolute otherwise (cluster
layout: shards live in per-host workdirs the controller only references).

`ShardedWalks` is the read side: an array-like over the shard memmaps with
the same (shape, dtype, row indexing) surface the old monolithic memmap had,
so loaders and tests are corpus-layout-agnostic.  Walker blocks are the
uniform `ceil(W/nb)` blocks of phases.walker_block, which is what makes
row -> shard lookup a division instead of a search.

jax-free on purpose: worker processes and the cluster HostRunner import this
without paying a jax initialization.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def shard_name(out_name: str, bucket: int) -> str:
    """Per-bucket shard file name derived from the corpus name:
    walks.npy -> walks_b003.npy."""
    stem = out_name[:-4] if out_name.endswith(".npy") else out_name
    return f"{stem}_b{bucket:03d}.npy"


def manifest_name(out_name: str) -> str:
    stem = out_name[:-4] if out_name.endswith(".npy") else out_name
    return f"{stem}_manifest.json"


def write_manifest(path: str, num_walkers: int, length: int,
                   shards: Sequence[Dict], dtype=np.int64) -> str:
    """Atomically write a corpus manifest.  Each shard dict carries
    {bucket, w0, w1, path, host}; `path` is made manifest-relative when the
    shard lives under the manifest's directory."""
    base = os.path.dirname(os.path.abspath(path))
    norm = []
    for s in shards:
        p = os.path.abspath(s["path"])
        rel = os.path.relpath(p, base)
        norm.append({**s, "path": rel if not rel.startswith("..") else p})
    payload = {"version": 1, "num_walkers": int(num_walkers),
               "length": int(length), "dtype": np.dtype(dtype).str,
               "shards": norm}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)  # atomic: never a torn manifest
    return path


def read_manifest(path: str) -> Dict:
    with open(path) as f:
        m = json.load(f)
    if m.get("version") != 1:
        raise ValueError(f"unsupported corpus manifest version in {path}: "
                         f"{m.get('version')!r}")
    return m


class ShardedWalks:
    """Array-like view over a sharded walk corpus (read-only).

    shape [num_walkers, length + 1]; rows are walker histories.  Row w lives
    in shard w // wpb (uniform walker blocks), so `walks[wid_array]` is a
    grouped gather over at most nb shard memmaps — no shard is ever read
    whole unless asked for.  `np.asarray(walks)` materializes the full
    corpus (tests / small graphs only, exactly like concat_bucket_csr).
    """

    def __init__(self, manifest_path: str):
        self.manifest_path = os.path.abspath(manifest_path)
        m = read_manifest(self.manifest_path)
        base = os.path.dirname(self.manifest_path)
        self.num_walkers = int(m["num_walkers"])
        self.length = int(m["length"])
        self.dtype = np.dtype(m["dtype"])
        self.shards: List[Dict] = sorted(m["shards"], key=lambda s: s["w0"])
        for s in self.shards:
            if not os.path.isabs(s["path"]):
                s["path"] = os.path.join(base, s["path"])
        # Uniform block size (ceil(W/nb), the walker_block contract); the
        # last shard may be short or empty.
        self._wpb = (self.shards[0]["w1"] - self.shards[0]["w0"]
                     if self.shards else 0)
        self._mms: List[Optional[np.ndarray]] = [None] * len(self.shards)

    # -- array-like surface --------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_walkers, self.length + 1)

    def __len__(self) -> int:
        return self.num_walkers

    def _mm(self, i: int) -> np.ndarray:
        if self._mms[i] is None:
            self._mms[i] = np.load(self.shards[i]["path"], mmap_mode="r")
        return self._mms[i]

    def __array__(self, dtype=None, copy=None):
        parts = [np.asarray(self._mm(i)) for i in range(len(self.shards))]
        out = (np.concatenate(parts) if parts
               else np.zeros((0, self.length + 1), self.dtype))
        return out.astype(dtype) if dtype is not None else out

    def rows(self, wid) -> np.ndarray:
        """Gather history rows for an int array of walker ids."""
        wid = np.asarray(wid, np.int64)
        if wid.size and (wid.min() < 0 or wid.max() >= self.num_walkers):
            raise IndexError(
                f"walker id out of range [0, {self.num_walkers})")
        out = np.empty((wid.shape[0], self.length + 1), self.dtype)
        if self._wpb == 0:
            return out
        shard_of = wid // self._wpb
        for i in np.unique(shard_of):
            sel = shard_of == i
            s = self.shards[int(i)]
            out[sel] = self._mm(int(i))[wid[sel] - s["w0"]]
        return out

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self.rows(np.asarray([key]))[0]
        if isinstance(key, slice):
            return self.rows(np.arange(*key.indices(self.num_walkers)))
        return self.rows(key)
