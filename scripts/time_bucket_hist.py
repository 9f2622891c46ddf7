#!/usr/bin/env python3
"""CUDA-event times of the port's `bucket_hist` kernel at the shapes that
`chip_smoke.py` times (`chip_smoke.bucket_hist_shapes`), beside
`torch.bincount` on the same ids.

    python3 scripts/time_bucket_hist.py [--src DIR] [--label NAME]

Imports `repro_torch` from DIR (default: `src/` of this checkout), so the same
script times the kernel of another checkout, such as a parent commit unpacked
into a git-ignored directory: run parent, change, change, parent in one
call to compare two versions on one card.  The shapes, the ids and the timing
(`chip_smoke.time_ms`) are this checkout's, whatever DIR is.  Each shape is
held bit-equal to `bucket_hist_plain` first; an empty kernel's time is the
floor of a call's fixed cost.  Prints the card's name and power limit, then
one JSON line per shape.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402


def _mesh_constants():
    """This checkout's launch/mesh.py (it imports nothing of the package),
    whatever --src points at."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_h100_mesh", ROOT / "src" / "repro_torch" / "launch" / "mesh.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_bucket_hist: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.core.types import GraphConfig
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    mesh = _mesh_constants()
    print(smoke.nvidia_smi("name,power.limit"), flush=True)
    eps = GraphConfig(scale=smoke.MAIN_SCALE, nb=smoke.NB).edges_per_shard
    g = torch.Generator(device=dev).manual_seed(1234)
    for case, n, k, pad in smoke.bucket_hist_shapes(eps):
        dest = smoke.bucket_ids(torch, g, dev, n, k, pad)
        got, want = ops.bucket_hist(dest, k), ops.bucket_hist_plain(dest, k)
        if not torch.equal(got, want):
            raise RuntimeError(f"bucket_hist [{case}] differs from its plain version")
        print(json.dumps({
            "label": args.label, "shape": case, "n": n, "k": k,
            "kernel_ms": smoke.time_ms(lambda: ops.bucket_hist(dest, k)),
            "bincount_ms": smoke.time_ms(lambda: torch.bincount(dest, minlength=k)),
            "byte_bound_ms": 4 * (n + k) / mesh.MEM_BYTES_PER_S * 1e3}), flush=True)
        del dest, got, want
    print(json.dumps({"label": args.label,
                      "empty_kernel_ms": smoke.time_ms(lambda: torch.cuda._sleep(0))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
