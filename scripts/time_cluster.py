#!/usr/bin/env python3
"""Wall time of the cluster runtime with its hosts' per-chunk hooks on the
card and on the host's CPU, one run after the other.

    python3 scripts/time_cluster.py [--config main|queue] [--devices cuda,cpu]
                                    [--workers N] [--queue-walkers W]

`main` is `chip_smoke.py`'s cluster_main: external_main's graph (scale 20,
nb 8, the external shuffle, sorted CSR, chunks of 2^21 edges, I/O overlap)
through `ClusterGenerator` on 2 local hosts with `--workers` (default 2)
spawn-pool workers each, exchanging over loopback sockets.  `queue` is
cluster_parity's queue run (scale 16, nb 8, chunks of 2^14: a
`JobScheduler` draining an external job and a recompute one with the fused
generate+relabel and two fused corpora of `--queue-walkers` (default 4096)
x 3 hops, max_concurrent 2; `--workers` default 0 there, as in
cluster_parity).  Each run prints one JSON line: the hosts' start
(rendezvous) seconds, the wall seconds of the run (or drain), edges/s and
each phase's seconds with their sums by first word (main), each host's busy
seconds (its tasks' seconds, as it reported them), the kernels' launches
from the hosts' reports, and per hook of `core/chunks.py` (rmat_chunk,
graph_perm_chunk, partition_chunk, gather_chunk, table_block) its calls and
seconds summed over every host process and pool worker (perf_counter around
each call: the copies to and from the device, the kernel or its plain
version, the wait for it; `scripts/time_external.py`'s HookClock).  Prints
the card's name and power limit first.  Needs a card.

The hosts are started through `CommandTemplateBackend` as this script's
`host` command, which installs the hook clock and then runs the port's
`host`; their spawn-pool workers import this script again as their main
module and install it there.  Every process keeps its totals in a file of
the directory that TIME_CLUSTER_HOOKS names.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
HOOK_DIR_ENV = "TIME_CLUSTER_HOOKS"


def install_hook_clock(out_dir: str) -> None:
    """Time every hook call of this process and keep the totals in
    out_dir/hooks_<pid>.json, rewritten after each call."""
    from time_external import HookClock

    path = Path(out_dir) / f"hooks_{os.getpid()}.json"

    class FileHookClock(HookClock):
        def _timed(self, name, fn):
            timed = super()._timed(name, fn)

            def call(*args, **kw):
                try:
                    return timed(*args, **kw)
                finally:
                    tmp = path.with_suffix(".tmp")
                    tmp.write_text(json.dumps(self.stats))
                    os.replace(tmp, path)
            return call

    FileHookClock().__enter__()


if __name__ == "__mp_main__" and os.environ.get(HOOK_DIR_ENV):
    install_hook_clock(os.environ[HOOK_DIR_ENV])   # a host's spawn-pool worker


def hook_totals(out_dir: Path) -> dict:
    out = {}
    for f in sorted(out_dir.glob("hooks_*.json")):
        for name, s in json.loads(f.read_text()).items():
            t = out.setdefault(name, {"calls": 0, "s": 0.0})
            t["calls"] += s["calls"]
            t["s"] += s["s"]
    return out


def run(config: str, device: str, workers: int, queue_walkers: int) -> dict:
    import torch

    import chip_smoke as smoke
    from repro_torch.core.cluster import ClusterGenerator, ClusterSpec, CommandTemplateBackend
    from repro_torch.core.jobqueue import JobScheduler, submit_job
    from repro_torch.core.types import GraphConfig
    from repro_torch.kernels import ops

    if config == "main":
        cfg = GraphConfig(scale=smoke.DISK_MAIN_SCALE, nb=smoke.NB,
                          chunk_edges=smoke.DISK_MAIN_CHUNK, shuffle_variant="external",
                          csr_variant="sorted", io_overlap=True, transport="socket")
    else:
        cfg = GraphConfig(scale=smoke.DISK_PARITY_SCALE, nb=smoke.NB,
                          chunk_edges=smoke.DISK_PARITY_CHUNK, shuffle_variant="external",
                          transport="socket")
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    with tempfile.TemporaryDirectory(prefix="time_cluster_") as tmp:
        hooks = Path(tmp) / "hooks"
        hooks.mkdir()
        os.environ[HOOK_DIR_ENV] = str(hooks)
        os.environ["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p)
        backend = CommandTemplateBackend(
            f"{{python}} {Path(__file__).resolve()} host --controller {{controller}} "
            f"--host-id {{host_id}} --workdir {{workdir}} --workers {workers}")
        spec = ClusterSpec.local(smoke.CLUSTER_HOSTS, str(Path(tmp) / "hosts"), nb=cfg.nb)
        ctrl = str(Path(tmp) / "ctrl")
        ops.reset_launches()
        if config == "main":
            t = time.perf_counter()
            gen = ClusterGenerator(cfg, spec, ctrl, backend=backend, checkpoint=True, device=dev)
            start_s = time.perf_counter() - t
            try:
                t = time.perf_counter()
                gen.run(cfg.csr_variant)
                wall = time.perf_counter() - t
                phases = {r["phase"]: r["seconds"] for r in gen.orchestrator.report()}
                busy = dict(gen.controller.busy_seconds)
                restarts = dict(gen.controller.restarts)
            finally:
                gen.close()
            groups = {}
            for name, sec in phases.items():
                groups[name.split("_")[0]] = groups.get(name.split("_")[0], 0.0) + sec
            out = {"edges_per_s": cfg.m / wall, "phase_s": phases, "phase_group_s": groups}
        else:
            submit_job(ctrl, cfg, name="external")
            walks = tuple((queue_walkers, smoke.DISK_WALK_LENGTH, seed, name)
                          for seed, name in enumerate(("a.npy", "b.npy")))
            submit_job(ctrl, cfg.with_(shuffle_variant="recompute"), walks=walks,
                       fuse_walks=True, fuse_gen_relabel=True, name="recompute")
            t = time.perf_counter()
            with JobScheduler(spec, ctrl, backend=backend, max_concurrent=2,
                              device=dev) as sched:
                start_s = time.perf_counter() - t
                t = time.perf_counter()
                summary = sched.drain()
                wall = time.perf_counter() - t
                busy = dict(sched.controller.busy_seconds)
                restarts = dict(sched.controller.restarts)
            out = {"queue_walkers": queue_walkers, "jobs": summary["jobs"],
                   "dead_letters": summary["dead_letters"]}
        stats = hook_totals(hooks)
    hook_s = sum(s["s"] for s in stats.values())
    return {"config": config, "device": device, "hosts": smoke.CLUSTER_HOSTS,
            "workers_per_host": workers,
            "scale": cfg.scale, "nb": cfg.nb, "chunk_edges": cfg.chunk_edges,
            "start_s": start_s, "wall_s": wall, **out, "host_busy_s": busy,
            "restarts": restarts, "launches": {k: v for k, v in ops.LAUNCHES.items() if v},
            "hooks": stats, "hook_s": hook_s,
            "hook_share_of_busy": hook_s / sum(busy.values()) if sum(busy.values()) else None}


def main() -> int:
    if sys.argv[1:2] == ["host"]:
        install_hook_clock(os.environ[HOOK_DIR_ENV])
        from repro_torch.launch.cluster import main as cluster_main
        return cluster_main(sys.argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("main", "queue"), default="main")
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--workers", type=int, default=None,
                    help="pool workers per host (default: 2 for main, 0 for queue)")
    ap.add_argument("--queue-walkers", type=int, default=4096)
    args = ap.parse_args()
    workers = args.workers if args.workers is not None else (2 if args.config == "main" else 0)
    import torch

    if not torch.cuda.is_available():
        print("time_cluster: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke

    print(smoke.nvidia_smi("name,power.limit"), flush=True)
    for device in args.devices.split(","):
        print(json.dumps(run(args.config, device, workers, args.queue_walkers)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
