"""Dry run of every (arch x shape) cell on one card, on the meta device
(counterpart of `repro/launch/dryrun.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \
        [--out cells.jsonl]

The reference lowers and compiles each cell for its 256- and 512-chip
production meshes on 512 fake CPU devices; one card has no such mesh, and
multi-GPU is out of the port's scope.  Here each cell is built by
`cells.build_cell` on the meta device, at the shape's global batch, dp 1
and the production mesh's "model" axis as the expert shards: tensors with
shapes and dtypes and no storage.  No step runs (the MoE dispatch's
histogram kernel and data-dependent shapes have no meta version), so
FlopCounterMode cannot count one: the compute term takes
`model_flops_for_cell` as the step's flops.  Per cell the record gives:

  * the bytes of the params, of the train state beyond them (gradients, f32
    master copy and Adam moments) or of the cache (prefill, decode);
  * whether those bytes fit in one card's 80 GB, activations not counted,
    and the largest power-of-two batch up to the shape's global batch whose
    bytes fit (0 when the batch-independent bytes alone do not);
  * `model_flops_for_cell` and the one-card Roofline terms
    (`roofline.min_step_bytes` as the memory term's bytes).

`cell_supported`'s skips are records with status "skipped" and the
reference's reason.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Dict, List

from ..configs.base import SHAPES, arch_ids, get_config
from ..train import tree
from . import roofline as rl
from .cells import build_cell, cell_supported
from .mesh import MEM_BYTES, make_production_mesh

DRY_RUN_MESH = {"data": 1, "model": make_production_mesh()["model"]}


def _elements(t, skip_length: bool = False) -> int:
    return sum(x.numel() for path, x in tree.leaves_with_path(t)
               if not (skip_length and path and path[-1] == "length"))


def run_cell(arch: str, shape_name: str) -> Dict:
    """One cell's record (see the module docstring)."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "chips": 1, "mesh": DRY_RUN_MESH}
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return dict(rec, status="skipped", reason=why)
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, DRY_RUN_MESH, cfg=cfg, device="meta")
    B = shape.global_batch
    if cell.kind == "train":
        state, data = cell.args
        params, cache = state.params, None
        # gradients (the params' dtype), master copy, moments
        extra = rl.tree_bytes(params) + rl.tree_bytes(
            (state.opt.master, state.opt.mu, state.opt.nu))
        min_bytes = rl.min_step_bytes("train", params, opt=state.opt)
    else:
        params, data, cache = cell.args
        extra = 0
        min_bytes = rl.min_step_bytes(cell.kind, params, cache=cache)
    fixed = rl.tree_bytes(params) + extra
    per_seq = (rl.tree_bytes(data) + (rl.tree_bytes(cache) if cache is not None else 0)) / B
    total = fixed + per_seq * B
    max_batch = 0
    if fixed + per_seq <= MEM_BYTES:
        max_batch = 1
        while max_batch * 2 <= B and fixed + per_seq * max_batch * 2 <= MEM_BYTES:
            max_batch *= 2
    model_flops = rl.model_flops_for_cell(cfg, shape)
    roof = rl.Roofline(flops_per_chip=model_flops, bytes_per_chip=min_bytes,
                       coll_bytes_per_chip=0.0, coll_by_kind={}, chips=1,
                       model_flops=model_flops)
    rec.update({
        "status": "ok", "kind": cell.kind, "batch": B, "seq_len": shape.seq_len,
        "param_elements": _elements(params),
        "param_bytes": rl.tree_bytes(params),
        "state_bytes": extra if cell.kind == "train" else None,
        "cache_elements": _elements(cache, skip_length=True) if cache is not None else None,
        "cache_bytes": rl.tree_bytes(cache) if cache is not None else None,
        "bytes": total, "fits_80gb": total <= MEM_BYTES, "max_batch_pow2": max_batch,
        "model_flops": model_flops, "flops_source": "model_flops_for_cell",
        "roofline": roof.as_dict(), "build_s": time.perf_counter() - t0,
    })
    return rec


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description="one-card dry run on the meta device")
    ap.add_argument("--arch", default="all", help="arch id or 'all' (configs.base.arch_ids)")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--out", default="", help="append JSONL records here")
    args = ap.parse_args(argv)
    archs = arch_ids() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    records, failures = [], []
    for arch in archs:
        for shape in shapes:
            try:
                rec = run_cell(arch, shape)
            except Exception as e:   # one failing cell is reported; the rest still run
                rec = {"arch": arch, "shape": shape, "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-2000:]}
                failures.append(rec)
            records.append(rec)
            print(_line(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_fit = sum(bool(r.get("fits_80gb")) for r in records)
    print(f"=== dry-run: {n_ok} ok ({n_fit} fit in 80 GB), {n_skip} skipped (documented), "
          f"{len(failures)} failed, {len(records)} total ===", flush=True)
    if failures:
        raise SystemExit(1)
    return records


def _line(rec: Dict) -> str:
    head = f"[{rec['arch']} x {rec['shape']}]"
    if rec["status"] != "ok":
        return f"{head} {rec['status']}: {rec.get('reason') or rec.get('error')}"
    ro = rec["roofline"]
    state = rec["state_bytes"] if rec["kind"] == "train" else rec["cache_bytes"]
    return (f"{head} {rec['kind']} B {rec['batch']}: params {rec['param_bytes'] / 1e9:.2f} GB, "
            f"{'state' if rec['kind'] == 'train' else 'cache'} {state / 1e9:.2f} GB, "
            f"fits {rec['fits_80gb']}, max pow2 batch {rec['max_batch_pow2']}; "
            f"model flops {rec['model_flops']:.3e}, tC {ro['t_compute_s']:.3e}s "
            f"tM {ro['t_memory_s']:.3e}s -> {ro['bottleneck']} bound")


if __name__ == "__main__":
    main()
