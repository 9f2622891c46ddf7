#!/usr/bin/env python3
"""CUDA-event times of each phase of the port's graph path (`generate` at
`chip_smoke.py`'s main configuration: scale 26, nb 8, the defaults), warm.

    python3 scripts/time_generate.py [--src DIR] [--label NAME] [--reps N]

Imports `repro_torch` from DIR (default: `src/` of this checkout), so the same
script times another checkout, such as a parent commit unpacked into a
git-ignored directory: run parent, change, change, parent in one call to
compare two versions on one card.  One run warms the allocator and builds the
kernels; each of the N runs after it prints one JSON line with the phase
times (shuffle, edges, relabel, redistribute, csr), their sum and the drop
counts.  Prints the card's name and power limit first.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_generate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.core.pipeline import generate
    from repro_torch.core.types import GraphConfig

    dev = torch.device("cuda", 0)
    print(smoke.nvidia_smi("name,power.limit"), flush=True)
    cfg = GraphConfig(scale=smoke.MAIN_SCALE, nb=smoke.NB)
    for rep in range(args.reps + 1):
        marks = []

        def hook(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        torch.cuda.synchronize()
        hook("start")
        res = generate(cfg, device=dev, phase_hook=hook)
        torch.cuda.synchronize()
        phases = {name: marks[i - 1][1].elapsed_time(e) for i, (name, e) in enumerate(marks) if i}
        line = {"label": args.label, "rep": rep, "warm": rep > 0, "phase_ms": phases,
                "total_ms": sum(phases.values()),
                "dropped_redistribute": int(res.dropped_redistribute),
                "dropped_relabel": int(res.dropped_relabel)}
        del res
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
