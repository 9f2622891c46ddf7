#!/usr/bin/env python3
"""Wall time of the disk tier (`StreamingGenerator`) with its per-chunk hooks
on the card and on the host's CPU, one run after the other in one process.

    python3 scripts/time_external.py [--config main|parity] [--devices cuda,cpu]

`main` is `chip_smoke.py`'s external_main configuration (scale 20, nb 8, the
external shuffle, sorted CSR, chunks of 2^21 edges, I/O overlap on);
`parity` is its external_parity run "streaming-recompute" (scale 16, nb 8,
chunks of 2^14), here alone instead of beside 13 other processes.  Each run
prints one JSON line: wall seconds, edges/s, each phase's seconds from
`orchestrator.report()`, and per hook of `core/chunks.py` (rmat_chunk,
graph_perm_chunk, partition_chunk, gather_chunk, table_block) its calls and
host seconds end to end (the copies to and from the device, the kernel or
its plain version, the wait for it), with the rest of the wall time, the
host's numpy, beside them.  Prints the card's name and power limit first.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as smoke  # noqa: E402

HOOKS = {"phases": ("rmat_chunk", "graph_perm_chunk"),
         "external": ("rmat_chunk", "graph_perm_chunk"),
         "blockstore": ("partition_chunk", "gather_chunk", "table_block")}


def configs():
    from repro_torch.core.types import GraphConfig

    return {
        "main": GraphConfig(scale=smoke.DISK_MAIN_SCALE, nb=smoke.NB,
                            chunk_edges=smoke.DISK_MAIN_CHUNK, shuffle_variant="external",
                            csr_variant="sorted", io_overlap=True),
        "parity": GraphConfig(scale=smoke.DISK_PARITY_SCALE, nb=smoke.NB,
                              chunk_edges=smoke.DISK_PARITY_CHUNK,
                              shuffle_variant="recompute"),
    }


class HookClock:
    """perf_counter around every hook call, where the disk tier's modules
    imported the hooks; restored on exit."""

    def __init__(self):
        from repro_torch.core import blockstore, external, phases

        self.mods = {"phases": phases, "external": external, "blockstore": blockstore}
        self.stats = {}
        self.saved = []

    def __enter__(self):
        for mod_name, names in HOOKS.items():
            mod = self.mods[mod_name]
            for name in names:
                fn = getattr(mod, name)
                self.saved.append((mod, name, fn))
                setattr(mod, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                s = self.stats.setdefault(name, {"calls": 0, "s": 0.0})
                s["calls"] += 1
                s["s"] += time.perf_counter() - t
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("main", "parity"), default="main")
    ap.add_argument("--devices", default="cuda,cpu")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_external: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.external import StreamingGenerator

    print(smoke.nvidia_smi("name,power.limit"), flush=True)
    cfg = configs()[args.config]
    for device in args.devices.split(","):
        dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
        with tempfile.TemporaryDirectory(prefix="time_external_") as tmp:
            gen = StreamingGenerator(cfg, tmp, device=dev)
            with HookClock() as clock:
                t = time.perf_counter()
                gen.run()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t
            hook_s = sum(s["s"] for s in clock.stats.values())
            print(json.dumps({
                "config": args.config, "device": device, "scale": cfg.scale, "nb": cfg.nb,
                "chunk_edges": cfg.chunk_edges, "shuffle": cfg.shuffle_variant,
                "wall_s": wall, "edges_per_s": cfg.m / wall,
                "phase_s": {r["phase"]: r["seconds"] for r in gen.orchestrator.report()},
                "hooks": clock.stats, "hook_s": hook_s, "hook_share": hook_s / wall,
                "rest_s": wall - hook_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
