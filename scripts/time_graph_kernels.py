#!/usr/bin/env python3
"""CUDA-event times of the port's `feistel_perm` and `relabel_gather` kernels
at the shapes that `chip_smoke.py` times, each beside its byte bound.

    python3 scripts/time_graph_kernels.py [--src DIR] [--label NAME] [--reps N]

Imports `repro_torch` from DIR (default: `src/` of this checkout), so the same
script times the kernels of another checkout, such as a parent commit unpacked
into a git-ignored directory: run parent, change, change, parent in one call
to compare two versions on one card.  The shapes, the data and the timing
(`chip_smoke.time_ms`, the median of N runs) are this checkout's, whatever
DIR is:

  feistel_perm    2^30 ids at nbits 26 (relabel_recompute's call at scale 26)
                  and 2^20 ids at nbits 18 (a disk-tier chunk)
  relabel_gather  one field of the ring relabel at scale 26, nb 8 (8 sorted
                  rows of 2^27 R-MAT src ids against all of pv), as the
                  checkout's `core/relabel.py` gathers it: one launch over
                  the rows (`rows`), and beside it one launch over the
                  flattened field (`flat`), where the wrapper takes `out=`;
                  else the per-(round, shard) segment loop of earlier
                  versions (`segments`: bounds, 64 launches and 64 copies);
                  one ring segment (base B); one disk-tier pv-join segment

Every call is held bit-equal to the plain version first.  An empty kernel's
time is the floor of a call's fixed cost.  Prints the card's name and power
limit, then one JSON line per shape.  Needs a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402
from time_bucket_hist import _mesh_constants  # noqa: E402


def segment_loop(torch, ops, field, pv, nb, B):
    """The ring relabel's gather as earlier versions made it: one launch per
    (ring round, shard) segment, each copied into the output."""
    N = field.shape[1]
    out = torch.empty_like(field)
    starts = (torch.arange(1, nb, device=field.device) * B).to(field.dtype)
    inner = torch.searchsorted(field, starts.expand(nb, nb - 1).contiguous())
    bounds = [[0, *row, N] for row in inner.tolist()]
    pv_sh = pv.reshape(nb, B)
    for r in range(nb):
        for bid in range(nb):
            c = (bid + r) % nb
            lo, hi = bounds[bid][c], bounds[bid][c + 1]
            if hi > lo:
                out[bid, lo:hi] = ops.relabel_gather(field[bid, lo:hi], pv_sh[c], c * B)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_graph_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.core.types import GraphConfig
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    mem = _mesh_constants().MEM_BYTES_PER_S
    print(smoke.nvidia_smi("name,power.limit"), flush=True)
    cfg = GraphConfig(scale=smoke.MAIN_SCALE, nb=smoke.NB)
    dcfg = GraphConfig(scale=smoke.DISK_MAIN_SCALE, nb=smoke.NB)
    g = torch.Generator(device=dev).manual_seed(1234)
    key, rounds = 0x5EED1234 ^ 0xFE157E11, cfg.feistel_rounds

    def line(shape, n, fn, plain, n_bytes):
        before = ops.LAUNCHES[kernel]
        got = fn()
        launches = ops.LAUNCHES[kernel] - before
        if not torch.equal(got, plain()):
            raise RuntimeError(f"{kernel} [{shape}] differs from its plain version")
        del got
        print(json.dumps({"label": args.label, "kernel": kernel, "shape": shape, "n": n,
                          "launches": launches, "kernel_ms": smoke.time_ms(fn, args.reps),
                          "byte_bound_ms": n_bytes / mem * 1e3}), flush=True)

    kernel = "feistel_perm"
    for shape, n, nbits in ((f"2^30 ids, nbits {cfg.scale}", cfg.m, cfg.scale),
                            (f"disk tier: 2^20 ids, nbits {smoke.DISK_RECOMPUTE_SCALE}",
                             smoke.DISK_RECOMPUTE_CHUNK, smoke.DISK_RECOMPUTE_SCALE)):
        x = torch.randint(0, 1 << nbits, (n,), generator=g, device=dev, dtype=torch.int32)
        line(shape, n, lambda: ops.feistel_perm(x, key, nbits, rounds),
             lambda: torch.cat([ops.feistel_perm_plain(c, key, nbits, rounds)
                                for c in x.split(smoke.PLAIN_CHUNK)]), 8 * n)
        del x

    kernel = "relabel_gather"
    field = smoke.relabel_field(torch, ops, cfg, dev)
    pv = torch.randperm(cfg.n, generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    want = smoke.relabel_plain_rows(torch, ops, field, pv, 0)
    field_bytes = smoke.gather_bytes(torch, field, cfg.n, 0)
    shape = f"one ring relabel field, {cfg.nb} x {cfg.edges_per_shard} keys"
    if "out" in inspect.signature(ops.relabel_gather).parameters:
        out = torch.empty_like(field)
        line(f"{shape}: rows", field.numel(), lambda: ops.relabel_gather(field, pv, 0, out=out),
             lambda: want, field_bytes)
        line(f"{shape}: flat", field.numel(),
             lambda: ops.relabel_gather(field.reshape(-1), pv, 0, out=out.reshape(-1)),
             lambda: want.reshape(-1), field_bytes)
        del out
    else:
        line(f"{shape}: segments", field.numel(),
             lambda: segment_loop(torch, ops, field, pv, cfg.nb, cfg.bucket_size),
             lambda: want, field_bytes)
    del want
    B = cfg.bucket_size
    seg, chunk = smoke.ring_segment(torch, field, B), pv[B:2 * B]
    line(f"ring segment, base B, {seg.numel()} keys", seg.numel(),
         lambda: ops.relabel_gather(seg, chunk, B),
         lambda: ops.relabel_gather_plain(seg, chunk, B), smoke.gather_bytes(torch, seg, B, B))
    del field, seg
    keys, block, base = smoke.join_segment(torch, g, dev, dcfg)
    line(f"disk tier: one pv-join segment, {keys.numel()} keys", keys.numel(),
         lambda: ops.relabel_gather(keys, block, base),
         lambda: ops.relabel_gather_plain(keys, block, base),
         smoke.gather_bytes(torch, keys, block.numel(), base))
    print(json.dumps({"label": args.label, "empty_kernel_ms": smoke.time_ms(
        lambda: torch.cuda._sleep(0), args.reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
