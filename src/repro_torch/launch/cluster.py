"""Cluster launcher CLI: start worker hosts and drive multi-host runs (twin
of `repro.launch.cluster`).

`run` and `drain` take `--device` (default `cuda`, which raises without
CUDA; `--device cpu` runs the kernels' plain versions on every host): the
hosts run their per-chunk hooks there, and the driver builds the kernel
libraries before it starts them.  `host` needs no device option (the
device rides each task's config) and `submit` touches no device.

Quickstart (single box -> 2-host local-exec -> ssh template)
-----------------------------------------------------------

1. Single box (no cluster — the in-process partitioned driver):

       PYTHONPATH=src python - <<'EOF'
       from repro_torch.core.phases import PartitionedGenerator
       from repro_torch.core.types import GraphConfig
       cfg = GraphConfig(scale=12, nb=4, shuffle_variant="external")
       with PartitionedGenerator(cfg, "/tmp/g1", device="cuda") as gen:
           gen.run(); gen.walk_corpus(1024, 16)
       EOF

2. Two "hosts" on one box, real process + workdir isolation, socket
   exchange (the loopback deployment shape the tests exercise):

       PYTHONPATH=src python -m repro_torch.launch.cluster run \
           --hosts 2 --workdir /tmp/cluster --scale 12 --nb 4 \
           --walkers 1024 --length 16

   Each host h gets /tmp/cluster/host{h} (its buckets' stores, CSR files,
   and corpus shards live THERE and only there); the controller keeps
   /tmp/cluster/ctrl with checkpoint state, graph_manifest.json, and
   walks_manifest.json.  Re-running the same command after a crash or a
   host kill resumes: surviving hosts skip all completed work.

3. Real hosts over ssh (or srun — it's just a template).  Host workdirs are
   per-host LOCAL paths; only the controller and exchange ports cross the
   network:

       PYTHONPATH=src python -m repro_torch.launch.cluster run \
           --hosts 2 --workdir /data/cluster --scale 30 --nb 64 \
           --host-names node1,node2 \
           --template 'ssh {host} env PYTHONPATH=/repo/src {python} -m \
repro_torch.launch.cluster host --controller {controller} --host-id {host_id} \
--workdir {workdir}'

   (For the template to work, the controller address in `{controller}`
   must be reachable from the worker hosts: `--bind 0.0.0.0` to listen on
   every interface, plus `--advertise 10.0.0.5` — the routable address
   workers should dial; the bound port is appended automatically.)

Training then streams straight from the sharded corpus manifest:
`repro_torch.data.ExternalWalkLoader(..., corpus_manifest=
"/tmp/cluster/ctrl/walks_manifest.json")`.

4. Many graphs through one fleet — the multi-tenant job queue.  `submit`
   appends jobs to <workdir>/ctrl/jobqueue.json (no cluster needed);
   `drain` launches the hosts once and runs every queued job
   concurrently, work-stealing style:

       PYTHONPATH=src python -m repro_torch.launch.cluster submit \
           --workdir /tmp/cluster --scale 12 --nb 4 --recompute \
           --walks 1024:16:0:walks.npy
       PYTHONPATH=src python -m repro_torch.launch.cluster submit \
           --workdir /tmp/cluster --scale 13 --nb 4 --recompute --seed 7
       PYTHONPATH=src python -m repro_torch.launch.cluster queue \
           --workdir /tmp/cluster
       PYTHONPATH=src python -m repro_torch.launch.cluster drain \
           --workdir /tmp/cluster --hosts 2 --max-concurrent 2

   Scheduling vocabulary (measured per drain in the summary JSON and in
   the drain's printed summary):

   - LEASE: hosts PULL tasks — a poll hands out at most `--lease-size`
     tasks from the host's own queue (0 = the whole queue).  Control
     cost is one ~hundreds-of-bytes header frame per poll/report, never
     per-byte-of-data; leases only bound BATCHING, placement of
     data-bearing tasks stays with the bucket owner.
   - STEAL: an idle host with an empty queue takes stealable tasks
     (communication-free recompute kernels — no local inputs) from the
     tail of the longest peer queue, so one job's straggler never idles
     the fleet.  `steals` in the drain summary counts migrations.
   - OVERLAP FACTOR: serial_makespan / queued_makespan for the same job
     set — >1 means independent jobs' I/O and exchange phases really
     did interleave; `utilization` (busy-seconds / fleet-seconds) is
     the same effect as a ratio.
   - DEAD-LETTER: a task failing deterministically past `--lease-budget`
     dispatches parks its JOB (queue keeps draining, partial stores
     GC'd) — bulkhead semantics, one poisoned job can't wedge the rest.
   - Walk specs W:L:seed:out submitted together with `--fuse-walks`
     advance through ONE CSR scan per hop (walk_hop_fused), k corpora
     for one read pass.

   Every job's artifacts stay bit-identical to a serial single-job run;
   each job's stores live under the job's namespace subdir of every job's host
   workdir plus <ctrl>/<job tag>/ for manifests and checkpoints.

5. Skew rebalancing + elastic hosts.  RMAT degree skew concentrates hot
   buckets on a few hosts; the controller's versioned shard map can move
   those bucket shards to colder (or freshly admitted) hosts between
   phases.  Start a run with rebalancing armed — the controller snapshots
   per-bucket I/O from the ledgers at every phase barrier, plans a greedy
   migration off the hottest host, and ships the shards over the exchange
   transport (MIGRATE frames, ack-after-durable, resumable):

       PYTHONPATH=src python -m repro_torch.launch.cluster run \
           --hosts 2 --workdir /tmp/cluster --scale 14 --nb 8 --rebalance

   Or drive it by hand from a second terminal while a run is live (the
   run drops its control address in <workdir>/ctrl/controller_addr):

       # one-shot: arm a rebalance at the next phase barrier
       PYTHONPATH=src python -m repro_torch.launch.cluster rebalance \
           --workdir /tmp/cluster
       # elastic admission: a new empty host joins mid-run; the next
       # rebalance assigns it shards, later phases run on it
       PYTHONPATH=src python -m repro_torch.launch.cluster admit \
           --workdir /tmp/cluster --host-workdir /tmp/cluster/host2
       # inspect the live map, per-bucket byte loads, and host roster
       PYTHONPATH=src python -m repro_torch.launch.cluster status \
           --workdir /tmp/cluster

   Invariants the rebalancer keeps (tests/test_torch_shardmap.py asserts
   all of them): artifacts stay BIT-IDENTICAL to the never-rebalanced run —
   the map changes where bytes live, never what they are; migrations are
   checkpointed per file, so a killed host resumes without re-sending
   completed shards; frames routed under a stale map version are refused
   by the receiving host.

6. Overlapped I/O.  Every host's external kernels overlap disk reads and
   writes with compute by default (GraphConfig.io_overlap — merge-cursor
   prefetch + write-behind emission, core/blockstore.py); outputs are
   bit-identical with the flag off, so flipping it never invalidates a
   checkpoint.  Force the strictly serial path for a run or a single
   host with the environment override:

       REPRO_IO_OVERLAP=0 PYTHONPATH=src python -m repro_torch.launch.cluster \
           run --hosts 2 --workdir /tmp/cluster --scale 14 --nb 8

   The time the pipeline could NOT hide shows up in every ledger
   surfaced by `status` and the per-phase orchestrator deltas:
   `read_wait_s` (consumer stalled on an unfinished prefetch),
   `write_wait_s` (producer stalled on the in-flight chunk), and
   `overlap_s` (I/O seconds that ran hidden behind compute).

7. Tracing + live telemetry (core/trace.py).  Every layer — orchestrator
   phases, the ~23 bucket kernels, external sort/merge/partition passes,
   prefetch/write-behind stalls, exchange frames, migrations, controller
   barriers — emits structured spans when a run is traced.  Tracing is
   timing-only: trace=False runs are bit-identical AND checkpoint-
   compatible with traced ones (result_config_key normalizes the flag
   out), and the tracer is a no-op stub unless armed:

       PYTHONPATH=src python -m repro_torch.launch.cluster run \
           --hosts 2 --workdir /tmp/cluster --scale 12 --nb 4 --trace

   Each process appends to its own <workdir>/trace/trace_<pid>.jsonl;
   hosts ship completed lines to the controller piggybacked on the task
   loop, landing in <ctrl>/trace/host<h>.jsonl.  Merge every lane into
   one Chrome/Perfetto trace-event file (open it at https://ui.perfetto.dev
   or chrome://tracing) and print the per-phase wall-time table:

       PYTHONPATH=src python -m repro_torch.launch.cluster trace \
           --workdir /tmp/cluster

   (`--out` overrides the default <ctrl>/trace_merged.json; the merge
   also runs the timeline validator — negative durations or span-nesting
   violations print as warnings, not errors.)  `REPRO_TRACE=1` force-arms
   tracing for any run without touching configs, exactly like
   REPRO_IO_OVERLAP.

   While a run is live, watch the fleet instead of polling JSON: the
   `status` admin RPC now carries a per-host live view — current phase
   key, queue depth, in-flight tasks, busy seconds, heartbeat age, and
   the unified metrics snapshot (io / stalls / wire / memory, the same
   schema BENCH_*.json embeds):

       PYTHONPATH=src python -m repro_torch.launch.cluster status \
           --workdir /tmp/cluster --watch            # redraws every 2 s

Subcommands: `host` (the worker daemon an exec backend or an operator
starts), `run` (controller + hosts end to end), `spec` (emit a ClusterSpec
JSON for external orchestration), `submit`/`queue`/`drain` (the job
queue), `status`/`rebalance`/`admit` (admin RPCs against a live
controller; `status --watch` is the live fleet view), `trace` (merge a
run's span files into one Perfetto-loadable timeline).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import socket
import sys
import time

from ..core.cluster import (
    ClusterError,
    ClusterGenerator,
    ClusterSpec,
    CommandTemplateBackend,
    HostRunner,
    HostSpec,
    LocalExecBackend,
    _ctrl_request,
)
from ..core.jobqueue import JobScheduler, load_state, submit_job
from ..core.trace import (
    merge_traces,
    phase_durations,
    validate_timeline,
    write_perfetto,
)
from ..core.types import GraphConfig


def _build_spec(args) -> ClusterSpec:
    names = (args.host_names.split(",") if args.host_names else
             ["127.0.0.1"] * args.hosts)
    if len(names) != args.hosts:
        raise SystemExit(f"--host-names lists {len(names)} names for "
                         f"--hosts {args.hosts}")
    root = os.path.abspath(args.workdir)
    return ClusterSpec(
        nb=args.nb,
        controller_host=args.bind,
        hosts=tuple(HostSpec(h, os.path.join(root, f"host{h}"), names[h])
                    for h in range(args.hosts)))


def cmd_host(args) -> int:
    HostRunner(args.workdir, args.host_id, args.controller,
               workers=args.workers, checkpoint=not args.no_checkpoint,
               max_tasks=args.max_tasks,
               exchange_host=args.exchange_host).run()
    return 0


def cmd_spec(args) -> int:
    spec = _build_spec(args)
    path = os.path.abspath(args.out) if args.out else os.path.join(
        os.path.abspath(args.workdir), "cluster_spec.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    spec.save(path)
    print(path)
    return 0


def cmd_run(args) -> int:
    spec = _build_spec(args)
    cfg = GraphConfig(scale=args.scale, nb=args.nb, edge_factor=args.edge_factor,
                      chunk_edges=args.chunk_edges, seed=args.seed,
                      shuffle_variant="external", transport="socket",
                      merge_fanin=args.merge_fanin,
                      pooled_cascade=args.pooled_cascade,
                      trace=args.trace)
    backend = (CommandTemplateBackend(args.template) if args.template
               else LocalExecBackend(workers=args.workers))
    ctrl_dir = os.path.join(os.path.abspath(args.workdir), "ctrl")
    gen = ClusterGenerator(cfg, spec, ctrl_dir, backend=backend,
                           checkpoint=not args.no_checkpoint,
                           max_restarts=args.max_restarts,
                           barrier_timeout=args.barrier_timeout,
                           advertise=args.advertise or None,
                           rebalance=args.rebalance, device=args.device)
    _write_ctrl_addr(ctrl_dir, gen.controller.public_addr)
    try:
        manifest, ledger = gen.run(csr_variant=args.csr_variant)
        print(f"[graph] manifest {manifest}")
        summary = {"graph_manifest": manifest, "ledger": ledger.as_dict(),
                   "restarts": gen.controller.restarts}
        if args.walkers > 0:
            walks = gen.walk_corpus(args.walkers, args.length,
                                    seed=args.walk_seed)
            print(f"[corpus] manifest {walks.manifest_path} "
                  f"({walks.num_walkers} x {walks.length + 1})")
            summary["corpus_manifest"] = walks.manifest_path
        print(json.dumps(summary, indent=1))
    finally:
        gen.close()
    if args.trace:
        # Merge AFTER close: closing stops the hosts, whose shutdown path
        # ships any trace lines still sitting in their local files.
        _merge_run_trace(os.path.abspath(args.workdir), "")
    return 0


def _write_ctrl_addr(ctrl_dir: str, addr: str) -> None:
    """Drop the live controller's admin address where the `status` /
    `rebalance` / `admit` subcommands expect it (best effort — an
    operator can always pass --controller explicitly)."""
    os.makedirs(ctrl_dir, exist_ok=True)
    with open(os.path.join(ctrl_dir, "controller_addr"), "w") as f:
        f.write(addr)


def _ctrl_addr(args) -> str:
    if getattr(args, "controller", ""):
        return args.controller
    path = os.path.join(os.path.abspath(args.workdir), "ctrl",
                        "controller_addr")
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        raise SystemExit(f"no --controller given and {path} not found "
                         "(is a run live in this workdir?)")


def _admin_request(addr: str, req: dict) -> dict:
    host, _, port = addr.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=30.0) as sock:
        return _ctrl_request(sock, {"op": "admin", **req})


def _trace_dirs(root: str):
    """Every place a run's span files can live under one launcher root:
    the controller's own lane + shipped host lanes (ctrl/trace), per-job
    controller workdirs (ctrl/<jobNNNN>/trace), and the hosts' LOCAL trace
    dirs — including namespace subdirs — which cover lines a host never
    got to ship (same-box and shared-fs deployments see them directly)."""
    pats = ("ctrl/trace", "ctrl/*/trace", "host*/trace", "host*/*/trace")
    dirs = []
    for pat in pats:
        dirs.extend(sorted(glob.glob(os.path.join(root, pat))))
    return [d for d in dirs if os.path.isdir(d)]


def _merge_run_trace(root: str, out: str) -> int:
    dirs = _trace_dirs(root)
    events = merge_traces(dirs)
    if not events:
        print(f"no trace events under {root} — was the run started with "
              "--trace (or REPRO_TRACE=1)?", file=sys.stderr)
        return 1
    warns = validate_timeline(events)
    for w in warns[:20]:
        print(f"[trace-warn] {w}", file=sys.stderr)
    if len(warns) > 20:
        print(f"[trace-warn] ... {len(warns) - 20} more", file=sys.stderr)
    path = os.path.abspath(out) if out else os.path.join(
        root, "ctrl", "trace_merged.json")
    write_perfetto(events, path)
    lanes = {(e.get("host"), e.get("pid")) for e in events}
    print(f"[trace] {len(events)} events across {len(lanes)} process "
          f"lane(s) -> {path}")
    durs = phase_durations(events)
    if durs:
        width = max(len(n) for n in durs)
        for name in sorted(durs, key=durs.get, reverse=True):
            print(f"  {name:<{width}}  {durs[name]:9.3f}s")
        print(f"  {'[sum of phases]':<{width}}  {sum(durs.values()):9.3f}s")
    return 0


def cmd_trace(args) -> int:
    return _merge_run_trace(os.path.abspath(args.workdir), args.out)


def _fmt_status_table(st: dict) -> str:
    """Compact per-host fleet table from the status RPC's hosts_live view."""
    rows = [f"{'host':>4}  {'phase':<34} {'queue':>5} {'infl':>4} "
            f"{'done':>5} {'busy_s':>8} {'hb_age':>6} {'MB_rd':>8} "
            f"{'MB_wr':>8} {'MB_wire':>8} {'stall_s':>7}"]
    for hid in sorted(st.get("hosts_live", {}), key=int):
        h = st["hosts_live"][hid]
        m = h.get("metrics", {})
        io, stalls, wire = (m.get("io", {}), m.get("stalls", {}),
                            m.get("wire", {}))
        age = h.get("heartbeat_age_s")
        wire_mb = (wire.get("bytes_sent", 0) + wire.get("bytes_recv", 0)) / 1e6
        stall = stalls.get("read_wait_s", 0.0) + stalls.get("write_wait_s", 0.0)
        rows.append(
            f"{hid:>4}  {(h.get('phase') or '-')[:34]:<34} "
            f"{h.get('queue', 0):>5} {h.get('inflight', 0):>4} "
            f"{h.get('tasks_done', 0):>5} {h.get('busy_seconds', 0.0):>8.1f} "
            f"{('-' if age is None else f'{age:.0f}'):>6} "
            f"{io.get('bytes_read', 0) / 1e6:>8.1f} "
            f"{io.get('bytes_written', 0) / 1e6:>8.1f} "
            f"{wire_mb:>8.1f} {stall:>7.2f}")
    rows.append(f"steals={st.get('steals', 0)} "
                f"rebalance_armed={st.get('rebalance_requested', False)} "
                f"map_v{st.get('map', {}).get('version', 0)}")
    return "\n".join(rows)


def cmd_status(args) -> int:
    addr = _ctrl_addr(args)
    if not args.watch:
        print(json.dumps(_admin_request(addr, {"cmd": "status"}),
                         indent=1, sort_keys=True))
        return 0
    try:
        while True:
            st = _admin_request(addr, {"cmd": "status"})
            # ANSI clear + home keeps the table in place like `watch(1)`.
            sys.stdout.write("\x1b[2J\x1b[H" + _fmt_status_table(st) + "\n")
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0
    except (OSError, ClusterError):
        print("controller gone; exiting watch", file=sys.stderr)
        return 0


def cmd_rebalance(args) -> int:
    _admin_request(_ctrl_addr(args), {"cmd": "rebalance"})
    print("rebalance armed: plan/migrate/commit runs at the next "
          "phase barrier")
    return 0


def cmd_admit(args) -> int:
    out = _admin_request(_ctrl_addr(args), {
        "cmd": "admit",
        "workdir": os.path.abspath(args.host_workdir),
        "host": args.host_name,
        "launch": not args.no_launch,
    })
    print(json.dumps(out))
    return 0


def _parse_walk_spec(s: str):
    parts = s.split(":")
    if len(parts) != 4:
        raise SystemExit(f"walk spec {s!r} is not W:L:seed:out_name")
    return (int(parts[0]), int(parts[1]), int(parts[2]), parts[3])


def _queue_root(args) -> str:
    return os.path.join(os.path.abspath(args.workdir), "ctrl")


def cmd_submit(args) -> int:
    cfg = GraphConfig(scale=args.scale, nb=args.nb,
                      edge_factor=args.edge_factor,
                      chunk_edges=args.chunk_edges, seed=args.seed,
                      shuffle_variant=("recompute" if args.recompute
                                       else "external"),
                      transport="socket", merge_fanin=args.merge_fanin)
    job = submit_job(_queue_root(args), cfg, csr_variant=args.csr_variant,
                     walks=[_parse_walk_spec(w) for w in args.walks],
                     fuse_walks=args.fuse_walks,
                     fuse_gen_relabel=args.fuse_gen_relabel,
                     name=args.name)
    print(json.dumps({"job": job.tag, "name": job.name,
                      "tasks": job.num_tasks, "phases": len(job.plan)}))
    return 0


def cmd_queue(args) -> int:
    state = load_state(_queue_root(args))
    for d in state["jobs"]:
        print(f"{d['job_id']:>6} {d.get('name', ''):<16} "
              f"{d['status']:<8} "
              f"{sum(len(p['keys']) for p in d.get('plan', [])):>5} tasks  "
              f"{d.get('error', '')}")
    for dl in state["dead_letters"]:
        print(f"[dead-letter] {dl['job']}: {dl['task_key']} "
              f"after {dl['attempts']} attempt(s)")
    return 0


def cmd_drain(args) -> int:
    spec = _build_spec(args)
    backend = (CommandTemplateBackend(args.template) if args.template
               else LocalExecBackend(workers=args.workers))
    sched = JobScheduler(spec, _queue_root(args), backend=backend,
                         max_concurrent=args.max_concurrent,
                         lease_size=args.lease_size,
                         lease_budget=args.lease_budget,
                         max_restarts=args.max_restarts,
                         barrier_timeout=args.barrier_timeout,
                         checkpoint=not args.no_checkpoint,
                         advertise=args.advertise or None,
                         device=args.device)
    _write_ctrl_addr(_queue_root(args), sched.controller.public_addr)
    try:
        summary = sched.drain()
        print(json.dumps(summary, indent=1))
        return 0 if not summary["dead_letters"] else 2
    finally:
        sched.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.cluster")
    sub = ap.add_subparsers(dest="cmd", required=True)

    h = sub.add_parser("host", help="worker-host daemon (one per machine)")
    h.add_argument("--controller", required=True, help="controller host:port")
    h.add_argument("--host-id", type=int, required=True)
    h.add_argument("--workdir", required=True)
    h.add_argument("--workers", type=int, default=0,
                   help="local spawn-pool size (0 = in-process)")
    h.add_argument("--no-checkpoint", action="store_true")
    h.add_argument("--exchange-host", default="127.0.0.1",
                   help="bind address of this host's ExchangeServer")
    h.add_argument("--max-tasks", type=int, default=0,
                   help="crash-test hook: hard-exit after N executed tasks")
    h.set_defaults(fn=cmd_host)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--hosts", type=int, default=2)
    common.add_argument("--workdir", required=True,
                        help="root dir: host{h}/ per host + ctrl/")
    common.add_argument("--nb", type=int, default=4)
    common.add_argument("--bind", default="127.0.0.1",
                        help="controller bind address")
    common.add_argument("--advertise", default="",
                        help="controller address workers dial, when it "
                             "differs from --bind (e.g. bind 0.0.0.0, "
                             "advertise the routable interface); bare "
                             "hostnames get the bound port appended")
    common.add_argument("--host-names", default="",
                        help="comma list of launch targets for {host}")

    s = sub.add_parser("spec", parents=[common],
                       help="emit a ClusterSpec JSON")
    s.add_argument("--out", default="")
    s.set_defaults(fn=cmd_spec)

    r = sub.add_parser("run", parents=[common],
                       help="controller + hosts, generation (+ walks)")
    r.add_argument("--scale", type=int, default=12)
    r.add_argument("--edge-factor", type=int, default=4)
    r.add_argument("--chunk-edges", type=int, default=1 << 14)
    r.add_argument("--seed", type=int, default=0x5EED_1234)
    r.add_argument("--merge-fanin", type=int, default=64)
    r.add_argument("--pooled-cascade", action="store_true",
                   help="dispatch cascade merge levels through the cluster")
    r.add_argument("--csr-variant", choices=("sorted", "scatter"),
                   default="sorted")
    r.add_argument("--walkers", type=int, default=0,
                   help="walk-corpus size (0 = generation only)")
    r.add_argument("--length", type=int, default=16)
    r.add_argument("--walk-seed", type=int, default=0)
    r.add_argument("--workers", type=int, default=0,
                   help="per-host local pool size (local backend)")
    r.add_argument("--template", default="",
                   help="command template backend (ssh/srun); see module doc")
    r.add_argument("--max-restarts", type=int, default=1)
    r.add_argument("--barrier-timeout", type=float, default=600.0)
    r.add_argument("--no-checkpoint", action="store_true")
    r.add_argument("--device", default="cuda",
                   help="where every host runs its hooks: cuda (the kernels; "
                        "raises without CUDA) or cpu (their plain versions)")
    r.add_argument("--rebalance", action="store_true",
                   help="rebalance hot bucket shards off straggler hosts "
                        "at every phase barrier (skew-aware shard map)")
    r.add_argument("--trace", action="store_true",
                   help="emit spans on every host + the controller and "
                        "merge them into <ctrl>/trace_merged.json "
                        "(Perfetto trace-event format) when the run ends; "
                        "timing-only, outputs stay bit-identical")
    r.set_defaults(fn=cmd_run)

    admin = argparse.ArgumentParser(add_help=False)
    admin.add_argument("--workdir", default="",
                       help="run root; reads <workdir>/ctrl/controller_addr")
    admin.add_argument("--controller", default="",
                       help="controller host:port (overrides --workdir)")

    st = sub.add_parser("status", parents=[admin],
                        help="live shard map, bucket loads, host roster, "
                             "per-host telemetry (--watch for a live view)")
    st.add_argument("--watch", action="store_true",
                    help="redraw a compact per-host fleet table until ^C")
    st.add_argument("--interval", type=float, default=2.0,
                    help="seconds between --watch polls")
    st.set_defaults(fn=cmd_status)

    tr = sub.add_parser("trace",
                        help="merge a traced run's span files into one "
                             "Perfetto-loadable timeline + phase table")
    tr.add_argument("--workdir", required=True,
                    help="the run root passed to `run`/`drain`")
    tr.add_argument("--out", default="",
                    help="output path (default <workdir>/ctrl/"
                         "trace_merged.json)")
    tr.set_defaults(fn=cmd_trace)

    rb = sub.add_parser("rebalance", parents=[admin],
                        help="arm a shard rebalance at the next phase "
                             "barrier of the live run")
    rb.set_defaults(fn=cmd_rebalance)

    ad = sub.add_parser("admit", parents=[admin],
                        help="admit a new host into the live cluster "
                             "(owns nothing until the next rebalance)")
    ad.add_argument("--host-workdir", required=True,
                    help="the new host's LOCAL workdir")
    ad.add_argument("--host-name", default="127.0.0.1",
                    help="launch target for the backend template")
    ad.add_argument("--no-launch", action="store_true",
                    help="register only; the operator starts the `host` "
                         "daemon out of band")
    ad.set_defaults(fn=cmd_admit)

    sb = sub.add_parser("submit", help="append one job to the queue "
                                       "(no cluster needed)")
    sb.add_argument("--workdir", required=True)
    sb.add_argument("--nb", type=int, default=4)
    sb.add_argument("--scale", type=int, default=12)
    sb.add_argument("--edge-factor", type=int, default=4)
    sb.add_argument("--chunk-edges", type=int, default=1 << 14)
    sb.add_argument("--seed", type=int, default=0x5EED_1234)
    sb.add_argument("--merge-fanin", type=int, default=64)
    sb.add_argument("--recompute", action="store_true",
                    help="shuffle_variant='recompute' (makes generation "
                         "tasks stealable)")
    sb.add_argument("--fuse-gen-relabel", action="store_true",
                    help="one fused regenerate+relabel barrier "
                         "(recompute only)")
    sb.add_argument("--csr-variant", choices=("sorted", "scatter"),
                    default="sorted")
    sb.add_argument("--walks", action="append", default=[],
                    metavar="W:L:seed:out",
                    help="walk corpus spec; repeatable")
    sb.add_argument("--fuse-walks", action="store_true",
                    help="advance all this job's corpora through one CSR "
                         "scan per hop")
    sb.add_argument("--name", default="")
    sb.set_defaults(fn=cmd_submit)

    q = sub.add_parser("queue", help="print queue + dead-letter state")
    q.add_argument("--workdir", required=True)
    q.set_defaults(fn=cmd_queue)

    d = sub.add_parser("drain", parents=[common],
                       help="launch hosts once, run every queued job "
                            "(work-stealing, overlapped)")
    d.add_argument("--max-concurrent", type=int, default=2)
    d.add_argument("--lease-size", type=int, default=2,
                   help="tasks handed out per host poll (0 = whole queue)")
    d.add_argument("--lease-budget", type=int, default=2,
                   help="dispatches a deterministically failing task gets "
                        "before its job dead-letters")
    d.add_argument("--workers", type=int, default=0)
    d.add_argument("--template", default="")
    d.add_argument("--max-restarts", type=int, default=1)
    d.add_argument("--barrier-timeout", type=float, default=600.0)
    d.add_argument("--no-checkpoint", action="store_true")
    d.add_argument("--device", default="cuda",
                   help="where every host runs its hooks: cuda (the kernels; "
                        "raises without CUDA) or cpu (their plain versions)")
    d.set_defaults(fn=cmd_drain)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
