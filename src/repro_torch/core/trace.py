"""Run-wide tracing + unified metrics: spans, Perfetto export, one schema
(twin of `repro.core.trace`).

The paper's whole argument is an I/O-cost ledger — which pass, which phase,
how many bytes, how much overlap — but until this module the telemetry was
fragmented: IOLedger (disk), TransportStats (wire), MemoryGauge (residency),
stall counters (async I/O), and ad-hoc controller dicts, none of which could
answer "where did the wall time of this 2-host run go?".  Two pieces close
that gap:

  Tracer            a per-process, append-only span log.  Every
                    instrumented site (PhaseOrchestrator.run_phase, the
                    phase kernels via phases._traced_kernel, the blockstore
                    sort/merge/partition primitives, Transport sends and
                    MIGRATE streams, controller barriers) emits one JSON
                    line per span into `<workdir>/trace/trace_{pid}.jsonl`.
                    Emission is off the hot path: spans buffer in a bounded
                    in-memory deque and a background thread flushes them;
                    when the buffer saturates, spans are DROPPED and
                    counted, never blocked on.  With tracing disabled
                    (GraphConfig.trace=False, the default) every site costs
                    one attribute check — the NullTracer — and no file is
                    ever created, so traced and untraced runs are
                    bit-identical in everything but the trace files.

  MetricsRegistry   one snapshot schema (`unified_snapshot`) over every
                    counter family: {"schema", "io" (IOLedger), "stalls"
                    (read_wait_s/write_wait_s/overlap_s), "wire"
                    (TransportStats), "memory" (MemoryGauge)}.  The SAME
                    shape flows into BENCH_*.json (benchmarks/run.py), the
                    controller's `status` admin RPC (per host), and any
                    future serve-tier histogram — so trajectory diffs,
                    live fleet views, and trace args never disagree about
                    what a byte counter is called.

Hosts ship their trace files to the controller (a "trace" control op riding
the exchange frame format — see core/cluster.py), where they land in
`<ctrl>/trace/host{h}.jsonl`; `merge_traces` + `to_perfetto` turn any pile
of trace files into one run-wide Chrome/Perfetto trace-event JSON
(`python -m repro.launch.cluster trace`).

Clock discipline: spans carry WALL-clock `ts` (time.time(), comparable
across processes and hosts within NTP skew) and a perf_counter-measured
`dur`, so per-phase durations are monotonic-accurate even when the wall
clock steps.  The span NESTING law (a child span closes before its parent,
per (host, pid, tid) lane) holds for the call-structured categories
"phase" and "kernel" only; "io"/"wire"/"stall" spans are leaf complete
events that generator interleaving may close out of LIFO order, so
`validate_timeline` exempts them.

`python -m repro_torch.core.trace lint` asserts every kernel registered in
phases._KERNELS (the universe phase_task_plan draws from) carries the
instrumentation wrapper — the CI guard against a new kernel silently
missing from timelines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

SCHEMA_VERSION = 1

# Subdirectory of a workdir holding that process tree's trace files.
TRACE_DIR = "trace"

# Stall windows shorter than this emit NO span (the counter in IOLedger
# still accumulates them): per-block waits of a healthy overlapped pass are
# microseconds, and a span per block would swamp the buffer with noise.
STALL_MIN_S = 1e-3

# Categories that are strictly call-structured (emitted by `with` blocks /
# function wrappers on one thread) and therefore subject to the nesting law.
NESTED_CATS = ("phase", "kernel")

# Tolerance for the nesting/ordering checks: perf_counter durations are
# subtracted from wall timestamps taken a few ns apart, so parent/child
# endpoints can disagree by scheduler-tick noise.
_EPS_S = 5e-3


def _now() -> float:
    return time.time()


class NullTracer:
    """The disabled tracer: every instrumented site costs one `.enabled`
    check (or a no-op context manager), and nothing touches the disk."""

    enabled = False
    dropped = 0
    path = None

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "span", **args):
        yield

    def event(self, name: str, cat: str, t0: float, dur: float,
              args: Optional[Dict] = None) -> None:
        pass

    def instant(self, name: str, cat: str = "instant", **args) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


_NULL = NullTracer()


class Tracer:
    """Span emitter for ONE process: bounded buffer, background flush.

    `host`/`job` label every span (None omits the field); `path` is the
    per-process trace file — per-PID because pool workers and host daemons
    share workdirs, and an append-only file with one writer needs no
    locking.  Buffer overflow DROPS spans (counted in `dropped`, recorded
    as a final meta line on close) instead of blocking the traced code —
    tracing must never become the bottleneck it is measuring."""

    enabled = True

    def __init__(self, trace_dir: str, host=None, job: Optional[str] = None,
                 max_buffer: int = 8192, flush_interval: float = 0.5):
        os.makedirs(trace_dir, exist_ok=True)
        self.path = os.path.join(trace_dir, f"trace_{os.getpid()}.jsonl")
        self.host = host
        self.job = job
        self.dropped = 0
        self._max = int(max_buffer)
        self._buf: deque = deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._flush_loop, args=(float(flush_interval),),
            name="trace-flush", daemon=True)
        self._thread.start()

    # -- emission ------------------------------------------------------------
    def _emit(self, rec: Dict) -> None:
        if self.host is not None:
            rec["host"] = self.host
        if self.job is not None:
            rec["job"] = self.job
        rec["pid"] = os.getpid()
        rec["tid"] = threading.get_ident()
        with self._lock:
            if len(self._buf) >= self._max:
                self.dropped += 1
                return
            self._buf.append(rec)

    def event(self, name: str, cat: str, t0: float, dur: float,
              args: Optional[Dict] = None) -> None:
        """One COMPLETE span from pre-measured (wall t0, duration)."""
        rec = {"name": name, "cat": cat, "ph": "X",
               "ts": float(t0), "dur": float(dur)}
        if args:
            rec["args"] = args
        self._emit(rec)

    def instant(self, name: str, cat: str = "instant", **args) -> None:
        rec = {"name": name, "cat": cat, "ph": "i", "ts": _now()}
        if args:
            rec["args"] = args
        self._emit(rec)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "span", **args):
        t0 = _now()
        p0 = time.perf_counter()
        try:
            yield
        finally:
            self.event(name, cat, t0, time.perf_counter() - p0,
                       args=args or None)

    # -- flushing ------------------------------------------------------------
    def _drain(self) -> List[Dict]:
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
        return out

    def flush(self) -> None:
        recs = self._drain()
        if not recs:
            return
        lines = "".join(json.dumps(r, separators=(",", ":")) + "\n"
                        for r in recs)
        with open(self.path, "a") as f:
            f.write(lines)

    def _flush_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.flush()
            except OSError:
                pass   # disk-full etc. must never kill the traced process

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        try:
            # Drain BEFORE appending the meta record: on a full buffer the
            # meta line would otherwise be the one span _emit drops.
            self.flush()
            if self.dropped:
                self._emit({"name": "trace_dropped", "cat": "meta",
                            "ph": "i", "ts": _now(),
                            "args": {"dropped": self.dropped}})
                self.flush()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Process-global tracer installation
# ---------------------------------------------------------------------------

_TRACER = _NULL
_INSTALL_LOCK = threading.Lock()


def get_tracer():
    """The process tracer — _NULL (enabled=False) until installed."""
    return _TRACER


def install_tracer(workdir: str, host=None, job: Optional[str] = None,
                   **kw) -> Tracer:
    """Install the process-global Tracer writing under
    `<workdir>/trace/`.  Idempotent: a second install keeps the first
    tracer (one process, one trace file) and returns it."""
    global _TRACER
    with _INSTALL_LOCK:
        if isinstance(_TRACER, Tracer):
            return _TRACER
        _TRACER = Tracer(os.path.join(workdir, TRACE_DIR),
                         host=host, job=job, **kw)
        return _TRACER


def maybe_install_tracer(workdir: str, enabled: bool = True, host=None,
                         job: Optional[str] = None):
    """install_tracer gated on a config flag — the one-liner every driver
    and worker entry point calls: no-op (and no directory) when disabled."""
    if not enabled:
        return _TRACER
    return install_tracer(workdir, host=host, job=job)


def uninstall_tracer() -> None:
    """Close and reset to the NullTracer (tests; production processes just
    exit and the daemon flush thread dies with them after a final flush on
    close paths that call it)."""
    global _TRACER
    with _INSTALL_LOCK:
        tr, _TRACER = _TRACER, _NULL
    tr.close()


# ---------------------------------------------------------------------------
# Merge + validation + Perfetto export
# ---------------------------------------------------------------------------


def trace_files(dirs: Iterable[str]) -> List[str]:
    """Every trace file under the given directories: per-process
    `trace_{pid}.jsonl` files plus controller-side shipped `host{h}.jsonl`
    files, in deterministic (sorted) order."""
    out: List[str] = []
    for d in dirs:
        out += glob.glob(os.path.join(d, "trace_*.jsonl"))
        out += glob.glob(os.path.join(d, "host*.jsonl"))
    return sorted(set(out))


def merge_traces(sources: Iterable[str]) -> List[Dict]:
    """Merge trace FILES and/or trace DIRECTORIES into one run-wide
    timeline, sorted by (ts, -dur, name) so parents precede children and
    the result is a pure function of the input contents (not of file
    order).  Torn trailing lines (a process killed mid-flush) and corrupt
    lines are skipped — a trace must be readable after any crash the
    checkpoint machinery survives."""
    paths: List[str] = []
    for s in sources:
        if os.path.isdir(s):
            paths += trace_files([s])
        elif os.path.exists(s):
            paths.append(s)
    events: List[Dict] = []
    for p in sorted(set(paths)):
        try:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue   # torn/corrupt line: skip, keep the rest
                    if isinstance(rec, dict) and "ts" in rec:
                        events.append(rec)
        except OSError:
            continue
    events.sort(key=lambda r: (float(r.get("ts", 0.0)),
                               -float(r.get("dur", 0.0)),
                               str(r.get("name", ""))))
    return events


def _lane(rec: Dict):
    return (rec.get("host"), rec.get("pid"), rec.get("tid"))


def validate_timeline(events: Sequence[Dict]) -> List[str]:
    """Well-formedness of a merged timeline; returns problem strings
    (empty = valid).  Checks: every complete span has a non-negative
    duration, and per (host, pid, tid) lane the call-structured categories
    (NESTED_CATS) obey the nesting law — a child span lies within its
    parent (±_EPS_S for cross-clock subtraction noise).  Leaf categories
    (io/wire/stall/ctrl) are exempt: generator-driven I/O spans legally
    close out of LIFO order when merges interleave."""
    problems: List[str] = []
    lanes: Dict[tuple, List[Dict]] = {}
    for rec in events:
        if rec.get("ph") == "X":
            dur = float(rec.get("dur", 0.0))
            if dur < 0.0:
                problems.append(
                    f"negative duration {dur} on span {rec.get('name')!r}")
            if rec.get("cat") in NESTED_CATS:
                lanes.setdefault(_lane(rec), []).append(rec)
    for lane, recs in lanes.items():
        recs = sorted(recs, key=lambda r: (float(r["ts"]), -float(r["dur"])))
        stack: List[Dict] = []
        for rec in recs:
            t0 = float(rec["ts"])
            t1 = t0 + float(rec["dur"])
            while stack and t0 >= (float(stack[-1]["ts"])
                                   + float(stack[-1]["dur"]) - _EPS_S):
                stack.pop()
            if stack:
                p1 = float(stack[-1]["ts"]) + float(stack[-1]["dur"])
                if t1 > p1 + _EPS_S:
                    problems.append(
                        f"span {rec.get('name')!r} overflows its parent "
                        f"{stack[-1].get('name')!r} in lane {lane} "
                        f"({t1 - p1:.6f}s past the parent end)")
            stack.append(rec)
    return problems


def to_perfetto(events: Sequence[Dict]) -> Dict:
    """Chrome/Perfetto trace-event JSON: complete ("X") and instant ("i")
    events with µs timestamps rebased to the earliest span, one Perfetto
    pid per (host, pid) so a 2-host run renders as parallel process
    tracks."""
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(float(r["ts"]) for r in events)
    procs: Dict[tuple, int] = {}
    out: List[Dict] = []
    for rec in events:
        pkey = (rec.get("host"), rec.get("pid"))
        pid = procs.get(pkey)
        if pid is None:
            pid = procs[pkey] = len(procs) + 1
            host = "?" if pkey[0] is None else pkey[0]
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0,
                        "args": {"name": f"host {host} / pid {pkey[1]}"}})
        ev = {"name": str(rec.get("name", "?")),
              "cat": str(rec.get("cat", "span")),
              "ph": rec.get("ph", "X"),
              "ts": int(round((float(rec["ts"]) - base) * 1e6)),
              "pid": pid,
              "tid": int(rec.get("tid") or 0) % (1 << 31)}
        if rec.get("ph") == "X":
            ev["dur"] = max(0, int(round(float(rec.get("dur", 0.0)) * 1e6)))
        args = dict(rec.get("args") or {})
        if rec.get("job"):
            args["job"] = rec["job"]
        if args:
            ev["args"] = args
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_perfetto(events: Sequence[Dict], path: str) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(to_perfetto(events), f)
    os.replace(tmp, path)
    return path


def phase_durations(events: Sequence[Dict]) -> Dict[str, float]:
    """Total seconds per phase-span name — the "where did the wall time
    go" summary the acceptance gate sums against run wall time."""
    out: Dict[str, float] = {}
    for rec in events:
        if rec.get("ph") == "X" and rec.get("cat") == "phase":
            name = str(rec.get("name", "?"))
            out[name] = out.get(name, 0.0) + float(rec.get("dur", 0.0))
    return out


# ---------------------------------------------------------------------------
# Unified metrics schema + registry
# ---------------------------------------------------------------------------

_STALL_KEYS = ("read_wait_s", "write_wait_s", "overlap_s")


def unified_snapshot(ledger=None, stats=None, gauge=None,
                     extra: Optional[Dict] = None) -> Dict:
    """THE telemetry snapshot schema: every surface that reports counters
    (BENCH_*.json, the `status` admin RPC, trace span args, future serve
    latency histograms) emits this shape, so consumers parse one schema.

      {"schema": 1,
       "io":     flat IOLedger counters (stall seconds split out),
       "stalls": {"read_wait_s", "write_wait_s", "overlap_s"},
       "wire":   TransportStats fields,
       "memory": {"peak_rows", "budget_rows"},
       "extra":  caller-specific leaves (queue depths, heartbeat ages)}

    Sections for absent inputs are omitted, never null.  `ledger`/`stats`
    duck-type (as_dict() / dataclass / plain dict) so reports that crossed
    the wire as dicts snapshot identically to live objects."""
    snap: Dict = {"schema": SCHEMA_VERSION}
    if ledger is not None:
        d = dict(ledger.as_dict() if hasattr(ledger, "as_dict") else ledger)
        snap["stalls"] = {k: float(d.pop(k, 0.0)) for k in _STALL_KEYS}
        snap["io"] = d
    if stats is not None:
        snap["wire"] = dict(dataclasses.asdict(stats)
                            if dataclasses.is_dataclass(stats) else stats)
    if gauge is not None:
        snap["memory"] = {
            "peak_rows": int(getattr(gauge, "peak_rows", gauge if
                                     isinstance(gauge, int) else 0)),
            "budget_rows": int(getattr(gauge, "budget_rows", 0))}
    if extra:
        snap["extra"] = dict(extra)
    return snap


class MetricsRegistry:
    """Named unified_snapshot slots + a combiner.  `update(name, snap)`
    replaces the named slot (snapshots are cumulative, so latest wins);
    `combined()` folds every slot into one snapshot — numeric counters
    sum, memory peaks take the max.  Thread-safe: phase threads, the
    controller's server threads, and the bench harness all touch it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._snaps: Dict[str, Dict] = {}

    def update(self, name: str, snap: Dict) -> None:
        with self._lock:
            self._snaps[name] = snap

    def get(self, name: str) -> Optional[Dict]:
        with self._lock:
            return self._snaps.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._snaps)

    def clear(self) -> None:
        with self._lock:
            self._snaps.clear()

    def combined(self) -> Dict:
        with self._lock:
            snaps = list(self._snaps.items())
        out: Dict = {"schema": SCHEMA_VERSION}
        if snaps:
            out["sources"] = sorted(n for n, _ in snaps)
        for _, snap in snaps:
            for sec in ("io", "stalls", "wire", "extra"):
                d = snap.get(sec)
                if not isinstance(d, dict):
                    continue
                acc = out.setdefault(sec, {})
                for k, v in d.items():
                    if isinstance(v, (int, float)):
                        acc[k] = acc.get(k, 0) + v
            mem = snap.get("memory")
            if isinstance(mem, dict):
                acc = out.setdefault("memory", {})
                for k, v in mem.items():
                    if isinstance(v, (int, float)):
                        acc[k] = max(acc.get(k, 0), v)
        return out


# The process-wide registry: PhaseOrchestrator folds its cumulative
# ledger/wire counters in per phase; benchmarks/run.py snapshots + clears
# it per bench; the cluster controller keeps its own per-host instances.
GLOBAL = MetricsRegistry()


# ---------------------------------------------------------------------------
# Run metadata (BENCH attribution across machines)
# ---------------------------------------------------------------------------


def run_metadata(config_digest: Optional[str] = None) -> Dict[str, str]:
    """Provenance stamp for BENCH_summary.json: which commit, which box,
    when, which torch and card.  All values are STRINGS so benchmarks/diff.py's
    numeric-leaf walk never tracks them as a perf trajectory."""
    meta = {
        "schema": str(SCHEMA_VERSION),
        "hostname": socket.gethostname(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "python": sys.version.split()[0],
    }
    try:
        meta["git_sha"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5.0, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        meta["git_sha"] = "unknown"
    import torch
    meta["torch"] = str(torch.__version__)
    meta["device"] = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                      else "cpu")
    if config_digest:
        meta["config_digest"] = str(config_digest)
    return meta


# ---------------------------------------------------------------------------
# Lint: every registered kernel carries the instrumentation wrapper
# ---------------------------------------------------------------------------


def lint_kernel_coverage() -> List[str]:
    """Problems (empty = pass): every kernel in phases._KERNELS must carry
    the `traced_kernel` wrapper attribute, and every kernel a
    phase_task_plan can dispatch must be a registered (hence instrumented)
    kernel.  Run as `python -m repro_torch.core.trace lint`."""
    from .phases import PlainCfg, _KERNELS, phase_task_plan
    problems: List[str] = []
    for name, fn in _KERNELS.items():
        if getattr(fn, "traced_kernel", None) != name:
            problems.append(f"kernel {name!r} is not wrapped with "
                            "phases._traced_kernel (no span instrumentation)")
    base = PlainCfg(scale=8, edge_factor=2, seed=1, a=0.57, b=0.19, c=0.19,
                    d=0.05, nb=2, chunk_edges=1024, rounds=2)
    walks = [(8, 2, 0, "w0.npy"), (8, 2, 1, "w1.npy")]
    plans = [
        phase_task_plan(base, walks=walks),
        phase_task_plan(dataclasses.replace(base, perm_family="feistel"),
                        csr_variant="scatter"),
        phase_task_plan(
            dataclasses.replace(base, shuffle_variant="recompute",
                                perm_family="feistel"),
            walks=walks, fuse_gen_relabel=True, fuse_walks=True),
    ]
    for plan in plans:
        for p in plan:
            k = p["kernel"]
            if k not in _KERNELS:
                problems.append(f"phase {p['phase']!r} dispatches unknown "
                                f"kernel {k!r}")
    return problems


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["lint"]:
        problems = lint_kernel_coverage()
        for p in problems:
            print(f"TRACE-LINT: {p}")
        if problems:
            return 1
        from .phases import _KERNELS
        print(f"trace lint ok: {len(_KERNELS)} kernels instrumented")
        return 0
    print("usage: python -m repro_torch.core.trace lint", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
