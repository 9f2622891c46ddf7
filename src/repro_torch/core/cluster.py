"""Multi-host cluster runtime: the paper's actual deployment shape (twin of
`repro.core.cluster`).

Every bucket exchange rides a pluggable Transport whose socket backend
takes arbitrary `peer_addrs` — this module supplies the missing piece:
something that actually STARTS workers + exchange servers on N
machines, rendezvouses them, drives the bulk-synchronous phases across them,
and keeps going (or resumes) when a host dies.  Four layers:

  ClusterSpec        the host manifest: which hosts exist, where each one's
                     private workdir lives, and which contiguous bucket
                     range each owns (the paper's RP(n, nb) applied to
                     hosts).  JSON round-trippable; never contains ephemeral
                     ports — those are discovered at rendezvous.
  HostRunner         the worker-host daemon: sweeps its workdir, starts the
                     local ExchangeServer, registers with the controller,
                     then polls for kernel tasks and executes them (in
                     process, or through a local spawn pool) against its own
                     per-host checkpoint state — so a relaunched host skips
                     every task it already completed, recomputing nothing
                     of its peers' work.
  ClusterController  rendezvous + heartbeats + phase barriers over the same
                     length-prefixed framing the exchange transport uses
                     (a control RPC is a header-only frame; the reply rides
                     the ack).  Dispatches each bucket kernel to the host
                     owning args[0]'s bucket, detects dead hosts (exec
                     handle exit or heartbeat silence), relaunches them
                     through the exec backend, and retries transport-failed
                     tasks once the peer map heals — GraphD's explicit
                     failure handling for disk-resident small clusters.
  ClusterGenerator   PartitionedGenerator with the pool swapped for the
                     cluster: same phase drivers, fine-grained checkpointed
                     clean/barrier phases (see drive_shuffle), sharded
                     collect (per-host corpus shards + manifest — no single
                     workdir ever holds the full corpus), and a graph
                     manifest instead of a driver-side CSR load.

Exec backends: `LocalExecBackend` spawns `python -m
repro_torch.launch.cluster host ...` subprocesses with per-host isolated
workdirs (the reference backend, and the loopback "two-host" shape);
`CommandTemplateBackend` formats an arbitrary command template (`ssh {host}
... --host-id {host_id}`) so srun/ssh/k8s launches are a string, not a
subclass.

Determinism is what makes the failure story simple: every run tag and every
run's bytes are a pure function of (config, bucket, phase), so re-executing
a half-finished task overwrites identical files — a resumed exchange never
needs distributed rollback, only the "clean exactly once per phase"
discipline the fine-grained checkpoint phases provide.

Device: each host runs its tasks' per-chunk hooks (core/chunks.py) on the
device the driver chose (`PlainCfg.device`, on the wire with the rest of the
config): "cuda" launches the four graph kernels, in a CUDA context of each
host process and of each of its spawn-pool workers, "cpu" their plain
versions.  A host without CUDA that is handed a "cuda" config fails the
task; it never runs it on the CPU.  The driver builds the kernel libraries
once before any host starts, and every host and worker only loads them.
Each task's kernel launches ride its report back to the driver, which adds
them to its own `build.LAUNCHES`.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import shlex
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..device import resolve_device
from ..kernels import build
from .blockstore import (
    IOLedger,
    MemoryGauge,
    clean_cascade_stores,
    split_counter_key,
)
from .shardmap import ShardMap, ShardMapError, plan_rebalance
from .trace import (
    TRACE_DIR,
    get_tracer,
    maybe_install_tracer,
    unified_snapshot,
)
from .phases import (
    PartitionedGenerator,
    PhaseOrchestrator,
    PlainCfg,
    WalkCfg,
    _MARK,
    _SKIP,
    _resolve_trace,
    _run_kernel,
    csr_adjv_path,
    csr_offv_path,
    plain_config,
    result_config_key,
    task_key,
    validate_external_shape,
)
from .transport import (
    ExchangeServer,
    SocketTransport,
    TransportError,
    TransportStats,
    PART_SUFFIX,
    _ACK,
    _HDR,
    _MAGIC,
    _MAX_HEADER_BYTES,
    _PLEN,
    _check_subdir,
    _recv_exact,
    _send_frame,
    store_bucket,
    sweep_partial_frames,
)

# Control-plane frame kind: rides the exchange transport's wire format
# (magic, kind, header JSON) but is served by the ControlServer, never by an
# ExchangeServer.  Requests are header-only; the JSON reply rides the ack
# message field.
_KIND_CTRL = 2


class ClusterError(RuntimeError):
    """A cluster-level failure: lost host past its restart budget, barrier
    timeout, or a non-retriable kernel error reported by a host.  When the
    failure is task-scoped, `task_key` and `attempts` name exactly which
    task died and how many dispatches it burned (`job` names the owning
    queue job, when any) — structured so schedulers can park the job
    instead of parsing the message."""

    def __init__(self, msg: str, *, task_key: Optional[str] = None,
                 attempts: Optional[int] = None, job: Optional[str] = None):
        super().__init__(msg)
        self.task_key = task_key
        self.attempts = attempts
        self.job = job


class TaskError(ClusterError):
    """One task exhausted its lease/retry budget.  JOB-scoped, not
    cluster-scoped: the hosts are healthy and other jobs keep draining —
    the job-queue scheduler catches this, dead-letters the owning job, and
    moves on, where a plain ClusterError aborts the whole cluster run."""


def heartbeat_period(timeout: float) -> float:
    """Heartbeat send period derived from the controller's advertised
    heartbeat_timeout: timeout/8 (several beats must fit in one timeout
    window so a single dropped RPC never flaps the host), clamped to
    [0.2s, 15s] so short-timeout tests don't spin and long-timeout
    deployments don't fall to one beat per epoch."""
    return min(max(float(timeout) / 8.0, 0.2), 15.0)


# ---------------------------------------------------------------------------
# ClusterSpec — the host manifest
# ---------------------------------------------------------------------------


def format_peer_addrs(addrs: Sequence[str]) -> str:
    """peer_addrs tuple -> the comma-joined CLI form."""
    return ",".join(str(a) for a in addrs)


def parse_peer_addrs(s: str) -> Tuple[str, ...]:
    """CLI "host:port,host:port" -> validated peer_addrs tuple.  Round-trips
    with format_peer_addrs (property-tested)."""
    out = []
    for part in s.split(","):
        part = part.strip()
        host, sep, port = part.rpartition(":")
        if not sep or not host:
            raise ValueError(f"peer address {part!r} is not host:port")
        int(port)  # raises ValueError on a non-numeric port
        out.append(part)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """One worker host: id, its PRIVATE workdir (never shared with peers),
    and the launch target a command template may address (ssh host name)."""

    host_id: int
    workdir: str
    host: str = "127.0.0.1"


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Host manifest + bucket ownership.  Host h owns the contiguous bucket
    range [h*nb//H, (h+1)*nb//H) — the paper's range partition applied at
    host granularity, so a host's buckets (and their vertex ranges) are one
    contiguous span and per-host recomputation never touches a peer's data
    (Funke et al.'s recomputable-partition shape)."""

    nb: int
    hosts: Tuple[HostSpec, ...]
    controller_host: str = "127.0.0.1"
    controller_port: int = 0   # 0 = ephemeral, discovered at start

    def __post_init__(self):
        ids = sorted(h.host_id for h in self.hosts)
        if not self.hosts:
            raise ValueError("ClusterSpec needs at least one host")
        if ids != list(range(len(self.hosts))):
            raise ValueError(f"host_ids must be 0..H-1, got {ids}")
        if len({h.workdir for h in self.hosts}) != len(self.hosts):
            raise ValueError("host workdirs must be distinct (per-host "
                             "isolation is the whole point)")
        if self.nb < len(self.hosts):
            raise ValueError(
                f"nb={self.nb} buckets cannot cover {len(self.hosts)} hosts")

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    def buckets_of(self, host_id: int) -> range:
        H = self.num_hosts
        return range(host_id * self.nb // H, (host_id + 1) * self.nb // H)

    def owner_of(self, bucket: int) -> int:
        if not 0 <= bucket < self.nb:
            raise ValueError(f"bucket {bucket} outside [0, {self.nb})")
        # Inverse of buckets_of's balanced contiguous split: host h owns
        # [h*nb//H, (h+1)*nb//H), so owner(b) = floor((b*H + H - 1) / nb)
        # ... which is fiddly with uneven splits; a direct scan over H hosts
        # is exact and H is tiny.
        return next(h for h in range(self.num_hosts)
                    if bucket in self.buckets_of(h))

    def workdir_of(self, bucket: int) -> str:
        return self.hosts[self.owner_of(bucket)].workdir

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> Dict:
        return {"nb": self.nb,
                "controller": f"{self.controller_host}:{self.controller_port}",
                "hosts": [dataclasses.asdict(h) for h in self.hosts]}

    @classmethod
    def from_json(cls, d: Dict) -> "ClusterSpec":
        chost, _, cport = str(d.get("controller", "127.0.0.1:0")).rpartition(":")
        return cls(nb=int(d["nb"]),
                   hosts=tuple(HostSpec(int(h["host_id"]), str(h["workdir"]),
                                        str(h.get("host", "127.0.0.1")))
                               for h in d["hosts"]),
                   controller_host=chost or "127.0.0.1",
                   controller_port=int(cport or 0))

    def save(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "ClusterSpec":
        with open(path) as f:
            return cls.from_json(json.load(f))

    @classmethod
    def local(cls, num_hosts: int, root: str, nb: int,
              controller_host: str = "127.0.0.1") -> "ClusterSpec":
        """The single-box N-host layout: per-host workdirs under `root`."""
        return cls(nb=nb, controller_host=controller_host,
                   hosts=tuple(HostSpec(h, os.path.join(root, f"host{h}"))
                               for h in range(num_hosts)))


# ---------------------------------------------------------------------------
# Control-plane wire (the exchange framing, reused)
# ---------------------------------------------------------------------------


def _ctrl_request(sock: socket.socket, obj: Dict) -> Dict:
    """One control RPC: header-only frame out, JSON reply in the ack."""
    _send_frame(sock, _KIND_CTRL, obj)
    status, mlen = _ACK.unpack(_recv_exact(sock, _ACK.size))
    if mlen > _MAX_HEADER_BYTES:
        raise ClusterError(f"oversized control reply ({mlen} bytes)")
    body = _recv_exact(sock, mlen).decode() if mlen else "{}"
    if status != 0:
        raise ClusterError(f"controller refused request: {body}")
    return json.loads(body)


class ControlServer:
    """Threaded request/reply server over the exchange frame format.  Every
    accepted connection loops {frame in -> handler(meta) -> JSON ack out};
    `handler` runs on the connection thread and must be thread-safe (the
    controller guards its state with one lock)."""

    def __init__(self, handler: Callable[[Dict], Dict],
                 host: str = "127.0.0.1", port: int = 0):
        self._handler = handler
        self._sock = socket.create_server((host, port))
        bound = self._sock.getsockname()
        self.addr = f"{bound[0]}:{bound[1]}"
        self._lock = threading.Lock()
        self._live: set = set()
        self._stopping = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        name=f"control-server-{bound[1]}",
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._lock:
                self._live.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            with conn:
                while True:
                    conn.settimeout(None)        # idle between RPCs is fine
                    try:
                        first = conn.recv(1)
                    except OSError:
                        return
                    if not first:
                        return
                    conn.settimeout(30.0)        # mid-frame stall is not
                    try:
                        head = first + _recv_exact(conn, _HDR.size - 1)
                        magic, kind, hlen = _HDR.unpack(head)
                        if magic != _MAGIC or kind != _KIND_CTRL:
                            raise ClusterError("bad control frame")
                        if hlen > _MAX_HEADER_BYTES:
                            raise ClusterError("oversized control header")
                        meta = json.loads(_recv_exact(conn, hlen).decode())
                        (plen,) = _PLEN.unpack(_recv_exact(conn, _PLEN.size))
                        if plen:
                            raise ClusterError("control frames carry no payload")
                        body = json.dumps(self._handler(meta)).encode()
                        conn.sendall(_ACK.pack(0, len(body)) + body)
                    except (ClusterError, ValueError, KeyError, TypeError,
                            json.JSONDecodeError, OSError) as e:
                        msg = str(e).encode()[:4096]
                        try:
                            conn.sendall(_ACK.pack(1, len(msg)) + msg)
                        except OSError:
                            pass
                        return
        finally:
            with self._lock:
                self._live.discard(conn)

    def stop(self) -> None:
        if self._stopping:
            return
        self._stopping = True
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)
        with self._lock:
            live = list(self._live)
        for c in live:
            try:
                c.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Exec backends
# ---------------------------------------------------------------------------


class ExecBackend:
    """How worker-host processes come into existence.  `launch` returns a
    handle; `alive(handle)` is the liveness probe the controller pairs with
    heartbeats; `stop(handle)` is best-effort teardown."""

    def launch(self, spec: ClusterSpec, host: HostSpec, controller_addr: str,
               attempt: int = 0):
        raise NotImplementedError

    def alive(self, handle) -> bool:
        return handle is not None and handle.poll() is None

    def stop(self, handle) -> None:
        if handle is None or handle.poll() is not None:
            return
        handle.terminate()
        try:
            handle.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            handle.kill()


class LocalExecBackend(ExecBackend):
    """Reference backend: one `python -m repro_torch.launch.cluster host ...`
    subprocess per host, each with its own isolated workdir — the paper's
    64-node cluster collapsed onto one box, but with REAL process and
    filesystem isolation (nothing shared but the sockets)."""

    def __init__(self, python: str = sys.executable, workers: int = 0,
                 env: Optional[Dict[str, str]] = None):
        self.python = python
        self.workers = workers
        self.env = env

    def host_args(self, host: HostSpec, attempt: int) -> List[str]:
        """Extra CLI args per launch — overridable (tests inject crash hooks
        like --max-tasks on the FIRST attempt only)."""
        return []

    def launch(self, spec: ClusterSpec, host: HostSpec, controller_addr: str,
               attempt: int = 0):
        cmd = [self.python, "-m", "repro_torch.launch.cluster", "host",
               "--controller", controller_addr,
               "--host-id", str(host.host_id),
               "--workdir", host.workdir,
               "--workers", str(self.workers)]
        cmd += self.host_args(host, attempt)
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        return subprocess.Popen(cmd, env=env)


class CommandTemplateBackend(ExecBackend):
    """Launch through a formatted command template — the ssh/srun shape:

        CommandTemplateBackend(
            "ssh {host} env PYTHONPATH=/repo/src {python} -m "
            "repro_torch.launch.cluster host --controller {controller} "
            "--host-id {host_id} --workdir {workdir}")

    Placeholders: {host} {host_id} {workdir} {controller} {python} {attempt}.
    The handle is the local launcher process (ssh/srun), whose exit mirrors
    the remote daemon's for liveness purposes."""

    def __init__(self, template: str, python: str = sys.executable):
        self.template = template
        self.python = python

    def launch(self, spec: ClusterSpec, host: HostSpec, controller_addr: str,
               attempt: int = 0):
        cmd = self.template.format(
            host=host.host, host_id=host.host_id, workdir=host.workdir,
            controller=controller_addr, python=self.python, attempt=attempt)
        return subprocess.Popen(shlex.split(cmd))


# ---------------------------------------------------------------------------
# Wire helpers
# ---------------------------------------------------------------------------


def _pcfg_to_wire(pcfg: PlainCfg) -> Dict:
    d = dataclasses.asdict(pcfg)
    if d.get("peer_addrs") is not None:
        d["peer_addrs"] = list(d["peer_addrs"])
    return d


def _pcfg_from_wire(d: Dict) -> PlainCfg:
    d = dict(d)
    if d.get("peer_addrs") is not None:
        d["peer_addrs"] = tuple(d["peer_addrs"])
    pcfg = PlainCfg(**d)
    # The wire pcfg bakes in trace as resolved at SUBMIT time; re-apply the
    # env override so `REPRO_TRACE=1 ... drain` arms spans for jobs queued
    # earlier without it.  Safe: result_config_key normalizes trace out, so
    # checkpoint keys (and therefore resume) are unaffected.
    resolved = _resolve_trace(pcfg)
    if resolved != pcfg.trace:
        pcfg = dataclasses.replace(pcfg, trace=resolved)
    return pcfg


def _jsonable(x):
    if isinstance(x, (tuple, list)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (np.integer,)):
        return int(x)
    return x


# ---------------------------------------------------------------------------
# Shard migration (MIGRATE frames over the exchange transport)
# ---------------------------------------------------------------------------

# CSR bucket files carry their bucket as a bare index (`csr_offv_003.npy`),
# not the `_b{ddd}` store suffix — the one naming family store_bucket
# cannot see.
_CSR_FILE_RE = re.compile(r"^csr_(?:offv|adjv)_(\d{3})\.npy$")


def _bucket_of_entry(name: str) -> Optional[int]:
    """Which bucket a workdir entry (store dir, shard file, CSR file)
    belongs to, or None for unbucketed entries (checkpoint state, specs)."""
    b = store_bucket(name)
    if b is not None:
        return b
    m = _CSR_FILE_RE.match(name)
    return int(m.group(1)) if m else None


def bucket_file_relpaths(workdir: str, bucket: int) -> List[str]:
    """Every FILE in `workdir` belonging to `bucket`, as slash-relative
    paths, spanning the top level and one namespace (job subdir) level —
    migration moves every job's data for a bucket, not one namespace's.
    Store directories are flat, so a matched store contributes its run
    files individually (file-granular resume).  `.part`/`.tmp` staging and
    `.json` checkpoint state never migrate."""
    out: List[str] = []

    def scan(rel: str, full: str) -> None:
        if os.path.isdir(full):
            for f in sorted(os.listdir(full)):
                if (not f.endswith((PART_SUFFIX, ".tmp"))
                        and os.path.isfile(os.path.join(full, f))):
                    out.append(f"{rel}/{f}")
        else:
            out.append(rel)

    for e in sorted(os.listdir(workdir)):
        if e.endswith((PART_SUFFIX, ".tmp", ".json")):
            continue
        full = os.path.join(workdir, e)
        if _bucket_of_entry(e) == bucket:
            scan(e, full)
        elif os.path.isdir(full):
            for s in sorted(os.listdir(full)):
                if s.endswith((PART_SUFFIX, ".tmp", ".json")):
                    continue
                if _bucket_of_entry(s) == bucket:
                    scan(f"{e}/{s}", os.path.join(full, s))
    return out


def _cleanup_bucket_dirs(workdir: str, bucket: int) -> None:
    """Best-effort rmdir of emptied per-bucket store dirs after a
    migration, so a later listing on the old owner can't see ghost stores
    of a bucket it no longer serves."""
    def _try(path: str) -> None:
        try:
            os.rmdir(path)
        except OSError:
            pass   # non-empty (a .part landed) or already gone — both fine

    for e in os.listdir(workdir):
        full = os.path.join(workdir, e)
        if not os.path.isdir(full):
            continue
        if _bucket_of_entry(e) == bucket:
            _try(full)
        else:
            for s in os.listdir(full):
                sf = os.path.join(full, s)
                if os.path.isdir(sf) and _bucket_of_entry(s) == bucket:
                    _try(sf)


def migrate_bucket_files(workdir: str, bucket: int, dest_addr: str,
                         transport: SocketTransport,
                         orch: Optional[PhaseOrchestrator] = None,
                         key: str = "") -> Dict[str, int]:
    """Move every file of `bucket` from this host's workdir to the
    ExchangeServer at `dest_addr`.  Each file is one resumable micro-phase
    (when `orch` is given) with a strict ordering that makes resume exact:

      send (ack-after-durable) -> unlink local copy -> checkpoint

    so on a mid-migration crash: a checkpointed file is skipped outright; a
    missing-but-unchecked file was fully acked (the crash hit between
    unlink and checkpoint) and completes as a no-op; a present file
    re-sends from offset 0, which the receiver's `.part` staging truncates
    and the deterministic bytes make an idempotent overwrite."""
    sent = {"files": 0, "bytes": 0}
    for rel in bucket_file_relpaths(workdir, bucket):
        def _send(rel=rel):
            src = os.path.join(workdir, *rel.split("/"))
            if os.path.exists(src):
                n = transport.send_file(dest_addr, src, rel)
                os.unlink(src)   # strictly after the final durable ack
                sent["files"] += 1
                sent["bytes"] += n

        if orch is not None:
            orch.run_phase(f"{key}:shard:{rel}", _send, save=_MARK, load=_SKIP)
        else:
            _send()
    _cleanup_bucket_dirs(workdir, bucket)
    return sent


# ---------------------------------------------------------------------------
# HostRunner — the worker-host daemon
# ---------------------------------------------------------------------------


class HostRunner:
    """One worker host: local ExchangeServer + task-execution loop.

    Startup order matters: the workdir stray sweep (cascade scratch,
    partial `.part` frames) runs BEFORE the ExchangeServer starts accepting
    — once peers know our address a sweep could race a live receive — and
    registration happens after, so no frame can arrive pre-sweep.

    Per-host resume: completed tasks are checkpointed in
    `<workdir>/host_phases.json` keyed by the controller-assigned task key
    (a pure function of namespace + kernel + args, NOT of dispatch order,
    so keys survive controller relaunches).  A relaunched host therefore
    re-executes only what it never finished; peers recompute nothing.
    Deterministic run tags make the reruns idempotent overwrites.

    `max_tasks` is a crash-test hook: the process hard-exits (os._exit)
    after executing that many fresh tasks — the CI host-kill scenario.
    """

    def __init__(self, workdir: str, host_id: int, controller_addr: str,
                 workers: int = 0, checkpoint: bool = True,
                 poll_interval: float = 0.05, max_tasks: int = 0,
                 exchange_host: str = "127.0.0.1"):
        self.workdir = workdir
        self.host_id = int(host_id)
        self.controller_addr = controller_addr
        self.workers = int(workers)
        self.checkpoint = checkpoint
        self.poll_interval = poll_interval
        self.max_tasks = int(max_tasks)
        os.makedirs(workdir, exist_ok=True)
        # Sweep stray cascade scratch and partial frames BEFORE the server
        # accepts — at the top level AND inside every job subdir (namespaced
        # exchanges land in <workdir>/<job>/; sweep_partial_frames already
        # walks recursively).
        clean_cascade_stores(workdir)
        for entry in os.scandir(workdir):
            if entry.is_dir():
                clean_cascade_stores(entry.path)
        sweep_partial_frames(workdir)
        self.server = ExchangeServer(workdir, host=exchange_host)
        self._orchs: Dict[str, PhaseOrchestrator] = {}
        self._orch_ledger = IOLedger()
        self._pool: Optional[ProcessPoolExecutor] = None
        self._executed = 0
        # Byte offset already shipped to the controller, per trace file
        # (this host's own + its pool workers', across job subdirs).
        self._trace_offsets: Dict[str, int] = {}

    # -- checkpoint state ----------------------------------------------------
    def _task_workdir(self, task: Dict) -> str:
        sub = task.get("subdir")
        if not sub:
            return self.workdir
        return os.path.join(self.workdir, _check_subdir(str(sub)))

    def _orchestrator(self, pcfg: PlainCfg, task: Dict) -> PhaseOrchestrator:
        """Per-JOB checkpoint state: each job subdir keeps its own
        host_phases.json (plus the default '' namespace for bare cluster
        runs), so concurrent jobs' task checkpoints never interleave and a
        dead-lettered job's state dies with its subdir."""
        sub = str(task.get("subdir") or "")
        orch = self._orchs.get(sub)
        if orch is None:
            wdir = self._task_workdir(task)
            os.makedirs(wdir, exist_ok=True)
            orch = self._orchs[sub] = PhaseOrchestrator(
                wdir, self._orch_ledger, checkpoint=self.checkpoint,
                state_name="host_phases.json",
                config_key=repr(("host", result_config_key(pcfg))),
                sweep=False)   # swept in __init__, before the server accepts
        return orch

    # -- execution -----------------------------------------------------------
    def _kernel_task(self, task: Dict) -> Tuple:
        pcfg = _pcfg_from_wire(task["pcfg"])
        args = list(task["args"])
        if task.get("wcfg"):
            args.append(WalkCfg(**task["wcfg"]))
        if task.get("wcfgs"):
            args.append([WalkCfg(**d) for d in task["wcfgs"]])
        return (task["kernel"], pcfg, self._task_workdir(task), tuple(args))

    def _migrate_task(self, task: Dict, orch: PhaseOrchestrator) -> Tuple:
        """Execute one MIGRATE task in-process (never in the spawn pool —
        its checkpoint micro-phases live in this process's orchestrator):
        ship every file of the bucket to the new owner's ExchangeServer,
        one resumable micro-phase per file in host_phases.json.  The
        destination may own no buckets yet (a just-admitted host), so its
        address rides the task (`dest_addr`), not the peer map.  Returns
        the same (out, ledger, peak, stats, launched) shape kernels return,
        with no launches."""
        b = int(task["args"][0])
        dest_addr = str(task["dest_addr"])
        ledger = IOLedger()
        tr = SocketTransport(
            self.workdir, ledger, peers=(dest_addr,),
            map_version=task["pcfg"].get("shard_map_version"))
        try:
            sent = migrate_bucket_files(self.workdir, b, dest_addr, tr,
                                        orch=orch, key=task["key"])
        finally:
            stats = dataclasses.asdict(tr.stats)
            tr.close()
        return sent, ledger.as_dict(), 0, stats, {}

    def _execute(self, tasks: List[Dict]):
        """Run a batch of tasks (resumed ones skip; fresh ones run in-process
        or through the local spawn pool), YIELDING one report per task as it
        finishes — the caller sends each report immediately, so the
        controller's liveness view advances task by task, not batch by
        batch."""
        if not tasks:
            return
        futs: Dict[int, object] = {}
        if self.workers > 0:
            fresh = [t for t in tasks
                     if t["kernel"] != "migrate"
                     and not self._orchestrator(_pcfg_from_wire(t["pcfg"]),
                                                t).completed(t["key"])]
            if len(fresh) > 1:
                if self._pool is None:
                    # nvcc at most once per host (the driver already built,
                    # so this only loads); workers only load the .so.
                    # Without CUDA the tasks themselves raise and report it.
                    if (torch.cuda.is_available() and any(
                            _pcfg_from_wire(t["pcfg"]).device.startswith("cuda")
                            for t in fresh)):
                        build.library()
                    self._pool = ProcessPoolExecutor(
                        max_workers=self.workers,
                        mp_context=get_context("spawn"))
                for t in fresh:
                    futs[t["id"]] = self._pool.submit(_run_kernel,
                                                      self._kernel_task(t))
        for t in tasks:
            rep: Dict = {"op": "report", "host_id": self.host_id,
                         "task_id": t["id"]}
            t0 = time.monotonic()
            try:
                pcfg = _pcfg_from_wire(t["pcfg"])
                # First traced task installs this host process's tracer
                # (pool workers install their own in _run_kernel).
                maybe_install_tracer(self._task_workdir(t),
                                     enabled=pcfg.trace, host=self.host_id)
                orch = self._orchestrator(pcfg, t)
                if orch.completed(t["key"]):
                    out = orch.run_phase(t["key"], lambda: None,
                                         load=lambda m: m.get("out"))
                    rep.update(ok=True, resumed=True, out=out, ledger={},
                               peak=0, stats={}, launched={})
                else:
                    fut = futs.get(t["id"])
                    if t["kernel"] == "migrate":
                        fn = lambda t=t, orch=orch: self._migrate_task(t, orch)
                    else:
                        fn = (fut.result if fut is not None
                              else lambda t=t: _run_kernel(self._kernel_task(t)))
                    res = orch.run_phase(
                        t["key"], fn,
                        save=lambda r: {"out": _jsonable(r[0])},
                        load=lambda m: m.get("out"))
                    out, ldict, peak, sdict, launched = res
                    rep.update(ok=True, resumed=False, out=_jsonable(out),
                               ledger=ldict, peak=int(peak), stats=sdict,
                               launched=launched)
                    self._executed += 1
            except BaseException as e:  # noqa: BLE001 - reported, not hidden
                rep.update(ok=False, resumed=False,
                           error=f"{type(e).__name__}: {e}",
                           retriable=isinstance(e, (TransportError, OSError)),
                           ledger={}, peak=0, stats={}, launched={})
            # Busy-seconds for the controller's fleet-utilization accounting
            # (resumed checkpoint replays cost ~0 and report as such).
            rep["seconds"] = time.monotonic() - t0
            # Receiver-side accounting accumulated since the last report —
            # folded into the controller's per-phase deltas at the barrier.
            sl, sg = IOLedger(), MemoryGauge()
            sstats = self.server.drain_accounting(sl, sg)
            rep.update(server_ledger=sl.as_dict(), server_peak=sg.peak_rows,
                       server_stats=dataclasses.asdict(sstats))
            yield rep

    # Lines per "trace" control op stay bounded so the JSON header never
    # approaches the server's _MAX_HEADER_BYTES frame bound.
    _TRACE_BATCH_BYTES = 256 << 10

    def _ship_trace(self, sock) -> None:
        """Ship newly-written trace lines to the controller (the "trace"
        control op) — called after each executed lease batch (the barrier
        cadence) and once at stop.  Reads every
        per-process trace file under this host's workdir (its own + its
        pool workers', including job subdirs) from the last-shipped byte
        offset, forwarding only COMPLETE lines in bounded batches.  Best
        effort by design: lines a dying host never ships are still on its
        disk for a local merge."""
        tracer = get_tracer()
        if not tracer.enabled:
            return
        tracer.flush()
        paths = glob.glob(os.path.join(self.workdir, TRACE_DIR,
                                       "trace_*.jsonl"))
        paths += glob.glob(os.path.join(self.workdir, "*", TRACE_DIR,
                                        "trace_*.jsonl"))
        batch: List[str] = []
        size = 0

        def send() -> None:
            nonlocal batch, size
            if batch:
                _ctrl_request(sock, {"op": "trace", "host_id": self.host_id,
                                     "lines": batch})
                batch, size = [], 0

        for p in sorted(paths):
            off = self._trace_offsets.get(p, 0)
            try:
                with open(p, "rb") as f:
                    f.seek(off)
                    data = f.read()
            except OSError:
                continue
            end = data.rfind(b"\n")
            if end < 0:
                continue   # no complete new line yet
            self._trace_offsets[p] = off + end + 1
            for line in data[:end].decode("utf-8", "replace").splitlines():
                if line:
                    batch.append(line)
                    size += len(line)
                    if size >= self._TRACE_BATCH_BYTES:
                        send()
        send()

    def _heartbeat_loop(self, stop: threading.Event, period: float) -> None:
        """Liveness side-channel on its OWN connection: a kernel can sort for
        longer than the controller's heartbeat_timeout, and the main loop's
        socket is busy-synchronous while it does — without this thread an
        externally-launched (handle-less) host doing honest work would be
        declared dead."""
        try:
            host, _, port = self.controller_addr.rpartition(":")
            s = socket.create_connection((host, int(port)), timeout=30.0)
        except OSError:
            return
        with s:
            while not stop.wait(period):
                try:
                    _ctrl_request(s, {"op": "heartbeat",
                                      "host_id": self.host_id})
                except (OSError, ClusterError):
                    return

    # -- the loop ------------------------------------------------------------
    def run(self) -> None:
        host, _, port = self.controller_addr.rpartition(":")
        sock = socket.create_connection((host, int(port)), timeout=60.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hb_stop = threading.Event()
        try:
            hello = _ctrl_request(sock, {"op": "hello",
                                         "host_id": self.host_id,
                                         "exchange_addr": self.server.addr,
                                         "pid": os.getpid()})
            # Heartbeat cadence follows the controller's configured timeout
            # (hello reply), so short-timeout tests don't flap and
            # long-timeout deployments don't spam the control socket.
            period = heartbeat_period(float(hello.get("heartbeat_timeout",
                                                      16.0)))
            threading.Thread(target=self._heartbeat_loop,
                             args=(hb_stop, period), daemon=True).start()
            while True:
                # Long-poll: the controller parks this RPC on its condition
                # variable until tasks/stop arrive (or the wait expires), so
                # an idle host costs one RPC per wait window, not a
                # sleep-spin.
                r = _ctrl_request(sock, {"op": "poll",
                                         "host_id": self.host_id,
                                         "wait": 2.0})
                if "mapv" in r:
                    # Rebalance fence: the controller's map moved past what
                    # some in-flight sender routed under — ratchet the local
                    # server so stale-routed DATA/MIGRATE frames are refused
                    # (their senders retry against the fresh map).
                    self.server.set_min_map_version(int(r["mapv"]))
                if r["cmd"] == "stop":
                    return
                if r["cmd"] == "idle":
                    time.sleep(self.poll_interval)
                    continue
                for rep in self._execute(r["tasks"]):
                    _ctrl_request(sock, rep)
                    if self.max_tasks and self._executed >= self.max_tasks:
                        # Crash-test hook: die HARD mid-phase, like kill -9 —
                        # no server shutdown, no pool teardown, no report for
                        # the remaining tasks.
                        os._exit(17)
                try:
                    self._ship_trace(sock)
                except (OSError, ClusterError):
                    pass   # telemetry must never kill a healthy host
        finally:
            hb_stop.set()
            try:
                self._ship_trace(sock)
            except (OSError, ClusterError):
                pass
            try:
                sock.close()
            except OSError:
                pass
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self.server.stop()


# ---------------------------------------------------------------------------
# ClusterController — rendezvous, barriers, heartbeats, restarts
# ---------------------------------------------------------------------------


class ClusterController:
    """The driver-side half of the control plane, and (since the job queue)
    a multi-job scheduler: every task carries its owning `job`, each job has
    its own wire pcfg (exchange namespace, graph shape), hosts PULL bounded
    lease batches, and an idle host STEALS migratable tasks from a busy
    peer's queue tail — so one job's straggler never idles the fleet.

    All mutable state is guarded by one lock (with a condition variable for
    the barrier/poll waits) and touched from two directions: ControlServer
    connection threads (hello/poll/report) and generator threads — plural:
    concurrent jobs each run their own barrier loop over this controller.

    `lease_size` bounds how many tasks one poll hands out (0 = the host's
    whole queue, the single-job batch behavior); small leases are what make
    work-stealing effective, because un-leased tasks are still stealable.
    Only tasks dispatched with `stealable=True` (no local state — e.g. the
    fused regenerate+relabel kernel) ever migrate; everything else stays
    with the bucket owner whose disk holds its inputs."""

    def __init__(self, spec: ClusterSpec, backend: Optional[ExecBackend] = None,
                 heartbeat_timeout: float = 60.0, max_restarts: int = 1,
                 task_retries: int = 3, advertise: Optional[str] = None,
                 lease_size: int = 0, task_log_cap: int = 1024,
                 trace_dir: Optional[str] = None):
        # `advertise` is the controller address HANDED TO workers when it
        # differs from the bind address (bind 0.0.0.0, advertise the routable
        # interface); a bare hostname gets the bound port appended.
        # `task_log_cap` bounds the in-memory task log (a deque: a
        # multi-week multi-job controller keeps the most recent N reports,
        # not all of them); the full stream rotates into the trace subsystem
        # as "ctrl" events when tracing is on.  `trace_dir` is where hosts'
        # shipped trace lines land (`host{h}.jsonl`) — None drops them.
        self.spec = spec
        self.backend = backend
        self.heartbeat_timeout = heartbeat_timeout
        self.max_restarts = max_restarts
        self.task_retries = task_retries
        self.lease_size = int(lease_size)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._revive_lock = threading.Lock()
        self._exchange_addrs: Dict[int, Optional[str]] = {
            h.host_id: None for h in spec.hosts}
        self._last_seen: Dict[int, float] = {}
        self._queues: Dict[int, deque] = {h.host_id: deque()
                                          for h in spec.hosts}
        self._inflight: Dict[int, Dict[int, Dict]] = {h.host_id: {}
                                                      for h in spec.hosts}
        self._reports: Dict[int, Dict] = {}
        self._tasks: Dict[int, Dict] = {}
        self._task_seq = 0
        self._job_pcfg: Dict[str, Dict] = {}
        self._job_tids: Dict[str, set] = {}
        self._stopping = False
        self.peers_version = 0
        self.restarts: Dict[int, int] = {h.host_id: 0 for h in spec.hosts}
        self._handles: Dict[int, object] = {}
        # (host, key, job, resumed) per report — most recent task_log_cap
        # entries only (an unbounded list would grow the controller's
        # memory over long multi-job runs).
        self.task_log: deque = deque(maxlen=max(1, int(task_log_cap)))
        self.busy_seconds: Dict[int, float] = {h.host_id: 0.0
                                               for h in spec.hosts}
        self.steals = 0
        self.trace_dir = trace_dir
        self._trace_write_lock = threading.Lock()
        # Per-host unified telemetry, folded in from every task report
        # (kernel + receiver side): what `status` serves and --watch renders.
        self.host_ledgers: Dict[int, IOLedger] = {
            h.host_id: IOLedger() for h in spec.hosts}
        self.host_stats: Dict[int, TransportStats] = {
            h.host_id: TransportStats() for h in spec.hosts}
        self.host_last_key: Dict[int, str] = {}
        self.host_tasks_done: Dict[int, int] = {h.host_id: 0
                                                for h in spec.hosts}
        # Live routing directory, seeded with the historical contiguous
        # split — a cluster that never rebalances is bit-identical to the
        # static map.  Rewritten ONLY at phase barriers (apply_shard_moves)
        # or by restore_shard_state on a resumed run.
        self.shard_map = ShardMap.contiguous(spec.nb, spec.num_hosts)
        # Per-bucket observed I/O (bytes), folded in from every task
        # report's kernel- and receiver-side bucket counters: the
        # rebalancer's skew signal.
        self.bucket_loads: Dict[int, int] = {}
        self.rebalance_requested = False
        self.server = ControlServer(self._handle, host=spec.controller_host,
                                    port=spec.controller_port)
        self.addr = self.server.addr
        bound_port = self.addr.rsplit(":", 1)[1]
        self.public_addr = (self.addr if not advertise
                            else advertise if ":" in advertise
                            else f"{advertise}:{bound_port}")

    # -- control RPC handler (server threads) --------------------------------
    def _lease_locked(self, h: int) -> List[Dict]:
        """Pop a lease batch for host h under the lock: up to lease_size
        tasks from its own queue, else STEAL stealable tasks from the
        longest peer queue's tail (the classic work-stealing discipline:
        owners pop their own head, thieves take the cold tail)."""
        out: List[Dict] = []
        cap = self.lease_size
        while self._queues[h] and (not cap or len(out) < cap):
            task = self._queues[h].popleft()
            self._inflight[h][task["id"]] = task
            out.append(task)
        if out:
            return out
        victims = sorted((o for o in self._queues if o != h),
                         key=lambda o: -len(self._queues[o]))
        for o in victims:
            q = self._queues[o]
            # Scan the tail for stealable tasks without reordering the rest.
            keep = deque()
            while q and (not cap or len(out) < cap):
                task = q.pop()
                if task.get("stealable"):
                    self._inflight[h][task["id"]] = task
                    out.append(task)
                    self.steals += 1
                else:
                    keep.appendleft(task)
            q.extend(keep)
            if out:
                break
        return out

    def _handle(self, req: Dict) -> Dict:
        op = req.get("op")
        if op == "admin":
            # Operator plane (`rebalance`/`admit`/`status` CLI verbs): not
            # bound to a registered host, so it dispatches before the
            # host-id check below.
            return self._admin(req)
        h = int(req.get("host_id", -1))
        if h not in self._queues:
            raise ClusterError(f"unknown host_id {h}")
        now = time.monotonic()
        if op == "hello":
            with self._lock:
                self._exchange_addrs[h] = str(req["exchange_addr"])
                self._last_seen[h] = now
                # A (re)registering host lost whatever it had taken; work
                # goes back to its OWNER's queue (a stolen task's home).
                for tid, task in self._inflight[h].items():
                    self._queues[task.get("owner", h)].appendleft(task)
                self._inflight[h].clear()
                self.peers_version += 1
                self._cond.notify_all()
            return {"ok": True, "hosts": self.spec.num_hosts,
                    "nb": self.spec.nb,
                    "heartbeat_timeout": self.heartbeat_timeout}
        if op == "heartbeat":
            with self._lock:
                self._last_seen[h] = now
            return {}
        if op == "poll":
            # Long-poll: park on the condition variable until work, stop,
            # or the host's requested wait expires — the host side spends
            # the window blocked on the RPC, not sleep-spinning.
            wait = min(float(req.get("wait", 0.0)), 10.0)
            deadline = now + wait
            with self._lock:
                self._last_seen[h] = now
                while True:
                    if self._stopping:
                        return {"cmd": "stop"}
                    peers = self._peer_addrs_locked()
                    if peers is not None:
                        out = self._lease_locked(h)
                        # A MIGRATE task's destination may own no buckets
                        # yet (a just-admitted host), so its address is not
                        # in the peer map — resolve it here, and requeue the
                        # task if the destination has not registered yet.
                        ready = []
                        for task in out:
                            dest = None
                            if task["kernel"] == "migrate":
                                dest = self._exchange_addrs.get(
                                    int(task["args"][2]))
                                if dest is None:
                                    self._inflight[h].pop(task["id"], None)
                                    self._queues[task.get("owner", h)].append(
                                        task)
                                    continue
                            ready.append((task, dest))
                        if ready:
                            tasks = []
                            for task, dest in ready:
                                pcfg = dict(
                                    self._job_pcfg[task["job"]],
                                    transport="socket",
                                    peer_addrs=list(peers),
                                    shard_map_version=self.shard_map.version)
                                t = dict(task, pcfg=pcfg)
                                if dest is not None:
                                    t["dest_addr"] = dest
                                tasks.append(t)
                            return {"cmd": "tasks", "tasks": tasks,
                                    "mapv": self.shard_map.version}
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return {"cmd": "idle",
                                "mapv": self.shard_map.version}
                    self._cond.wait(timeout=remaining)
                    self._last_seen[h] = time.monotonic()
        if op == "report":
            with self._lock:
                self._last_seen[h] = now
                tid = int(req["task_id"])
                self._inflight[h].pop(tid, None)
                task = self._tasks.get(tid)
                if task is None:
                    # A cancelled (dead-lettered) job's straggler report —
                    # the job is gone; drop it.
                    return {}
                self._reports[tid] = req
                self.busy_seconds[h] += float(req.get("seconds", 0.0))
                # Fold per-bucket byte counters (kernel side AND receiver
                # side) into the rebalancer's skew signal, and the whole
                # counter dicts into the per-host telemetry the `status`
                # RPC serves.
                for ld in (req.get("ledger") or {},
                           req.get("server_ledger") or {}):
                    for ck, v in ld.items():
                        cname, idx = split_counter_key(ck)
                        if cname == "bucket_bytes" and idx is not None:
                            self.bucket_loads[idx] = (
                                self.bucket_loads.get(idx, 0) + int(v))
                    self.host_ledgers[h].merge(ld)
                fields = TransportStats.__dataclass_fields__
                for sd in (req.get("stats") or {},
                           req.get("server_stats") or {}):
                    if sd:
                        self.host_stats[h].add(TransportStats(
                            **{k: v for k, v in sd.items() if k in fields}))
                self.host_last_key[h] = task["key"]
                self.host_tasks_done[h] += 1
                self.task_log.append({
                    "host": h, "key": task["key"], "job": task.get("job", ""),
                    "ok": bool(req.get("ok")),
                    "resumed": bool(req.get("resumed"))})
                self._cond.notify_all()
            # The unbounded task history lives in the trace stream now, not
            # in controller memory: one "ctrl" instant per report.
            tracer = get_tracer()
            if tracer.enabled:
                tracer.instant(
                    "task_report", cat="ctrl", host=h, key=task["key"],
                    job=task.get("job", ""), ok=bool(req.get("ok")),
                    resumed=bool(req.get("resumed")),
                    seconds=float(req.get("seconds", 0.0)))
            return {}
        if op == "trace":
            # Hosts ship their trace files in bounded line batches at
            # barriers (HostRunner._ship_trace); the controller lands them
            # in `<trace_dir>/host{h}.jsonl` for launch/cluster.py `trace`
            # to merge.  No trace_dir configured -> the lines are dropped.
            lines = req.get("lines") or []
            if self.trace_dir and lines:
                path = os.path.join(self.trace_dir, f"host{h}.jsonl")
                with self._trace_write_lock:
                    os.makedirs(self.trace_dir, exist_ok=True)
                    with open(path, "a") as f:
                        for line in lines:
                            f.write(str(line).rstrip("\n") + "\n")
            return {}
        raise ClusterError(f"unknown control op {op!r}")

    def _peer_addrs_locked(self) -> Optional[Tuple[str, ...]]:
        # Routing goes through the live shard map, not the spec's static
        # split — after a rebalance, bucket b's slot points at its NEW
        # owner's exchange server.  (A bucket-less admitted host is absent
        # here by construction and so never blocks peer completeness.)
        addrs = []
        for b in range(self.spec.nb):
            a = self._exchange_addrs[self.shard_map.owner_of(b)]
            if a is None:
                return None
            addrs.append(a)
        return tuple(addrs)

    def peer_addrs(self) -> Tuple[str, ...]:
        with self._lock:
            peers = self._peer_addrs_locked()
        if peers is None:
            raise ClusterError("not all hosts have registered")
        return peers

    def wait_peer_addrs(self, timeout: float = 0.0) -> Tuple[str, ...]:
        """peer_addrs that tolerates a revive in flight on another thread:
        a dead host's slot is None from the moment `_revive` requeues its
        lease until the relaunch says hello, and any job thread building a
        transport inside that window must park on the registration signal
        rather than abort its phase."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                peers = self._peer_addrs_locked()
                if peers is not None:
                    return peers
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ClusterError("not all hosts have registered")
                self._cond.wait(timeout=min(0.5, remaining))

    # -- shard map: rebalancing + elastic hosts ------------------------------
    def owner_of(self, bucket: int) -> int:
        """Live owner of `bucket` — the directory lookup every placement
        decision (task dispatch, shard manifests) goes through."""
        with self._lock:
            return self.shard_map.owner_of(bucket)

    def workdir_of(self, bucket: int) -> str:
        with self._lock:
            return self.spec.hosts[self.shard_map.owner_of(bucket)].workdir

    def map_version(self) -> int:
        with self._lock:
            return self.shard_map.version

    def bucket_loads_snapshot(self) -> Dict[int, int]:
        with self._lock:
            return dict(self.bucket_loads)

    def rebalance_pending(self) -> bool:
        with self._lock:
            return self.rebalance_requested

    def plan_moves(self, max_moves: int = 0) -> List[Tuple[int, int, int]]:
        """Deterministic rebalance plan against the CURRENT map + observed
        loads (pure planning — nothing moves until apply_shard_moves)."""
        with self._lock:
            return plan_rebalance(self.shard_map, dict(self.bucket_loads),
                                  max_moves=max_moves)

    def quiesce(self, timeout: float = 30.0) -> bool:
        """Soft barrier for rebalancing: wait until no task is queued or in
        flight anywhere.  The generator calls this at its phase barrier
        (where its own tasks are already drained); the wait covers
        concurrent jobs sharing the fleet."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                if not any(self._queues[h] or self._inflight[h]
                           for h in self._queues):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=min(0.25, remaining))

    def apply_shard_moves(
            self, moves: Sequence[Tuple[int, int, int]]) -> int:
        """Commit a migration at a barrier: rewrite the directory, bump the
        map version (stale-route fence) and the peers version (transports
        rebuild their routes lazily).  Returns the new map version."""
        with self._lock:
            for (b, src, dst) in moves:
                if self.shard_map.owner_of(int(b)) != int(src):
                    raise ShardMapError(
                        f"stale plan: bucket {b} owned by "
                        f"{self.shard_map.owner_of(int(b))}, plan expected "
                        f"{src}")
                self.shard_map.assign(int(b), int(dst))
            self.peers_version += 1
            self._cond.notify_all()
            return self.shard_map.version

    def restore_shard_state(self, map_json: Dict,
                            hosts_json: Sequence[Dict] = ()) -> int:
        """Resume path: a relaunched controller starts from the contiguous
        map, but a previously committed rebalance may have moved buckets
        (and admitted hosts).  Re-admit any hosts beyond the spec, then
        adopt the checkpointed map if it is newer than the live one."""
        for hj in sorted(hosts_json, key=lambda d: int(d["host_id"])):
            if int(hj["host_id"]) >= self.spec.num_hosts:
                self.admit_host(str(hj["workdir"]),
                                host=str(hj.get("host", "127.0.0.1")))
        with self._lock:
            smap = ShardMap.from_json(map_json)
            if smap.nb != self.spec.nb or smap.num_hosts != self.spec.num_hosts:
                raise ClusterError(
                    f"checkpointed shard map shape ({smap.nb} buckets, "
                    f"{smap.num_hosts} hosts) does not fit the cluster "
                    f"({self.spec.nb} buckets, {self.spec.num_hosts} hosts)")
            if smap.version > self.shard_map.version:
                self.shard_map = smap
                self.peers_version += 1
                self._cond.notify_all()
            return self.shard_map.version

    def admit_host(self, workdir: str, host: str = "127.0.0.1",
                   launch: bool = True) -> int:
        """Admit a late-joining host mid-run.  It owns no buckets (and so
        blocks no barrier) until a rebalance assigns it some; `launch=False`
        registers the slot for an externally-started HostRunner.  Returns
        the new host id."""
        with self._lock:
            hid = self.spec.num_hosts
            hspec = HostSpec(hid, workdir, host)
            # replace() re-runs ClusterSpec validation: distinct workdirs,
            # and nb >= H (you cannot admit more hosts than buckets).
            self.spec = dataclasses.replace(
                self.spec, hosts=self.spec.hosts + (hspec,))
            if self.shard_map.admit_host() != hid:
                raise ClusterError("shard map and spec disagree on host ids")
            self._exchange_addrs[hid] = None
            self._queues[hid] = deque()
            self._inflight[hid] = {}
            self.restarts[hid] = 0
            self.busy_seconds[hid] = 0.0
            self.host_ledgers[hid] = IOLedger()
            self.host_stats[hid] = TransportStats()
            self.host_tasks_done[hid] = 0
            self.peers_version += 1
            self._cond.notify_all()
        if launch and self.backend is not None:
            self._handles[hid] = self.backend.launch(
                self.spec, hspec, self.public_addr, attempt=0)
        return hid

    def _admin(self, req: Dict) -> Dict:
        cmd = req.get("cmd")
        if cmd == "status":
            now = time.monotonic()
            with self._lock:
                live = {}
                for hs in self.spec.hosts:
                    hid = hs.host_id
                    seen = self._last_seen.get(hid)
                    live[str(hid)] = {
                        # The live fleet view `status --watch` renders: what
                        # each host last worked on, how deep its queue is,
                        # and its unified counters
                        # (trace.unified_snapshot).
                        "phase": self.host_last_key.get(hid, ""),
                        "queue": len(self._queues[hid]),
                        "inflight": len(self._inflight[hid]),
                        "tasks_done": self.host_tasks_done.get(hid, 0),
                        "busy_seconds": round(
                            self.busy_seconds.get(hid, 0.0), 3),
                        "restarts": self.restarts.get(hid, 0),
                        "heartbeat_age_s": (None if seen is None
                                            else round(now - seen, 3)),
                        "registered": self._exchange_addrs.get(hid)
                                      is not None,
                        "metrics": unified_snapshot(
                            ledger=self.host_ledgers[hid],
                            stats=self.host_stats[hid]),
                    }
                return {"ok": True, "map": self.shard_map.to_json(),
                        "hosts": [dataclasses.asdict(h)
                                  for h in self.spec.hosts],
                        "hosts_live": live,
                        "steals": self.steals,
                        "bucket_loads": {str(k): v for k, v in
                                         sorted(self.bucket_loads.items())},
                        "rebalance_requested": self.rebalance_requested}
        if cmd == "rebalance":
            # Arm the flag; the actual plan/migrate/commit runs at the
            # driving generator's next phase barrier (never mid-phase).
            with self._lock:
                self.rebalance_requested = True
            return {"ok": True}
        if cmd == "admit":
            hid = self.admit_host(str(req["workdir"]),
                                  host=str(req.get("host", "127.0.0.1")),
                                  launch=bool(req.get("launch", True)))
            return {"ok": True, "host_id": hid}
        raise ClusterError(f"unknown admin cmd {cmd!r}")

    # -- lifecycle -----------------------------------------------------------
    def launch_hosts(self) -> None:
        if self.backend is None:
            return   # hosts are started externally (manual / tests)
        for h in self.spec.hosts:
            self._handles[h.host_id] = self.backend.launch(
                self.spec, h, self.public_addr, attempt=0)

    def wait_for_hosts(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while True:
            # Registration (hello) notifies the condition variable, so this
            # wait is event-driven; the bounded timeout only exists to
            # re-probe exec handles for a host that died before saying hello.
            with self._lock:
                missing = [h for h, a in self._exchange_addrs.items()
                           if a is None]
                if not missing:
                    return
                remaining = deadline - time.monotonic()
                if remaining > 0:
                    self._cond.wait(timeout=min(0.5, remaining))
                missing = [h for h, a in self._exchange_addrs.items()
                           if a is None]
            if not missing:
                return
            for h in missing:
                handle = self._handles.get(h)
                if handle is not None and not self.backend.alive(handle):
                    raise ClusterError(
                        f"host {h} exited (rc={handle.poll()}) before "
                        "registering")
            if time.monotonic() > deadline:
                raise ClusterError(f"rendezvous timeout: hosts {missing} "
                                   "never registered")

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            self._cond.notify_all()
        # Hosts exit at their next poll; reap backend handles either way.
        # Exponential backoff, not a tight poll — handle exit is the slow
        # external event here.
        deadline = time.monotonic() + 5.0
        for h, handle in self._handles.items():
            if handle is None:
                continue
            delay = 0.02
            while self.backend.alive(handle) and time.monotonic() < deadline:
                time.sleep(delay)
                delay = min(delay * 2.0, 0.25)
            self.backend.stop(handle)
        self.server.stop()

    # -- failure handling ----------------------------------------------------
    def _host_dead(self, h: int) -> bool:
        handle = self._handles.get(h)
        if handle is not None:
            return not self.backend.alive(handle)
        seen = self._last_seen.get(h)
        return seen is not None and (
            time.monotonic() - seen > self.heartbeat_timeout)

    def _revive(self, h: int) -> None:
        """A host with outstanding work died: requeue what it held (stolen
        tasks go home to their owner's queue) and relaunch it through the
        backend (within the restart budget)."""
        with self._lock:
            for tid, task in self._inflight[h].items():
                self._queues[task.get("owner", h)].appendleft(task)
            self._inflight[h].clear()
            self._exchange_addrs[h] = None
            self.peers_version += 1
            self._cond.notify_all()
        if self.backend is None or self.restarts[h] >= self.max_restarts:
            raise ClusterError(
                f"host {h} died mid-phase and the restart budget "
                f"({self.max_restarts}) is spent — relaunch the cluster to "
                "resume from the hosts' checkpoints")
        self.restarts[h] += 1
        self._handles[h] = self.backend.launch(
            self.spec, self.spec.hosts[h], self.public_addr,
            attempt=self.restarts[h])
        self.wait_for_hosts(timeout=self.heartbeat_timeout)

    def revive_dead_hosts(self) -> None:
        """Controller-side recovery hook for non-barrier failures (e.g. a
        CLEAN broadcast hitting a host that died BETWEEN barriers): relaunch
        every dead host within the restart budget, then return — the caller
        retries its operation against the healed peer map.  Serialized
        under its own lock: concurrent job threads both spotting the same
        dead host must produce ONE relaunch, not two."""
        with self._revive_lock:
            for h in list(self._queues):
                if self._host_dead(h):
                    self._revive(h)

    def heal_peers(self, since_version: int, timeout: float) -> None:
        """Recover from a controller-side transport failure observed against
        peer map version `since_version`.  A hard-killed host resets its
        sockets a few milliseconds BEFORE its exec handle polls as exited, so
        an immediate `revive_dead_hosts` can be a no-op and an immediate
        retry redials the same dead port — instead, poll until either the
        peer map has moved past the failed version with every host
        registered (a revive healed it, here or on another job thread) or
        the grace period expires with everyone still alive (the failure was
        transient; let the caller retry against the unchanged map)."""
        deadline = time.monotonic() + timeout
        while True:
            self.revive_dead_hosts()
            with self._lock:
                changed = self.peers_version != since_version
                complete = self._peer_addrs_locked() is not None
            if (changed and complete) or time.monotonic() >= deadline:
                return
            time.sleep(0.05)

    # -- the barrier ---------------------------------------------------------
    def run_tasks(self, kernel: str, argss: Sequence[Tuple], pcfg: PlainCfg,
                  namespace: str, timeout: float = 600.0, job: str = "",
                  stealable: bool = False,
                  lease_budget: int = 1) -> List[Dict]:
        """Dispatch one kernel invocation per args tuple to the owner host of
        bucket args[0], wait for every report (the phase barrier), and return
        the reports in args order.  Task keys are content-addressed
        (namespace:kernel:args, see phases.task_key) so per-host checkpoints
        survive controller relaunches and re-dispatch after failures.

        `job` scopes the barrier to one queue job (its pcfg — exchange
        namespace included — rides every lease); concurrent jobs run their
        own run_tasks threads against this one controller.  `stealable`
        marks the tasks migratable (no local inputs) so idle hosts may pull
        them.  `lease_budget` is how many DISPATCHES a deterministically
        failing (non-retriable) task gets before the barrier gives up;
        exhaustion raises TaskError naming the task key and attempt count —
        job-scoped, so a scheduler dead-letters that job while the fleet
        keeps going.  (Retriable transport failures keep the separate
        task_retries budget.)"""
        tracer = get_tracer()
        t_wall, perf0 = time.time(), time.perf_counter()
        tids = []
        pcfg_wire = _pcfg_to_wire(pcfg)
        subdir = getattr(pcfg, "exchange_namespace", None)
        with self._lock:
            self._job_pcfg[job] = pcfg_wire
            job_tids = self._job_tids.setdefault(job, set())
            for args in argss:
                wire_args, wcfg, wcfgs = [], None, None
                for a in args:
                    if isinstance(a, WalkCfg):
                        wcfg = dataclasses.asdict(a)
                    elif (isinstance(a, (list, tuple)) and a
                          and all(isinstance(w, WalkCfg) for w in a)):
                        wcfgs = [dataclasses.asdict(w) for w in a]
                    else:
                        wire_args.append(a)
                tid = self._task_seq
                self._task_seq += 1
                key = task_key(namespace, kernel, wire_args,
                               ns=(wcfg or {}).get("ns", ""))
                owner = self.shard_map.owner_of(int(wire_args[0]))
                task = {"id": tid, "key": key, "kernel": kernel,
                        "args": wire_args, "wcfg": wcfg, "wcfgs": wcfgs,
                        "attempt": 0, "job": job, "subdir": subdir,
                        "stealable": bool(stealable), "owner": owner}
                self._tasks[tid] = task
                job_tids.add(tid)
                self._queues[owner].append(task)
                tids.append(tid)
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                pending = [t for t in tids if t not in self._reports]
                failed = [(t, self._reports[t]) for t in tids
                          if t in self._reports
                          and not self._reports[t].get("ok")]
            for tid, rep in failed:
                task = self._tasks[tid]
                retriable = bool(rep.get("retriable"))
                budget = self.task_retries if retriable else lease_budget - 1
                if task["attempt"] < budget:
                    task["attempt"] += 1
                    with self._lock:
                        self._reports.pop(tid, None)
                        self._queues[task["owner"]].append(task)
                        self._cond.notify_all()
                else:
                    raise TaskError(
                        f"task {task['key']} failed after "
                        f"{task['attempt'] + 1} attempt(s): "
                        f"{rep.get('error')}",
                        task_key=task["key"],
                        attempts=task["attempt"] + 1, job=job)
            if not pending and not failed:
                break
            # Liveness: while a barrier is in progress EVERY host must be
            # alive, not just the ones owing reports — a host with no tasks
            # left is still every peer's exchange RECEIVER, and its death
            # shows up as retriable TransportErrors on the senders.  Reviving
            # it (rather than letting the senders burn their retry budget
            # against a dead server) is what heals those retries: once the
            # host re-registers, re-dispatched tasks get the fresh peer map.
            # (Revive is serialized against concurrent job threads; the
            # double-check under the revive lock keeps it single-shot.)
            with self._revive_lock:
                for h in list(self._queues):
                    if self._host_dead(h):
                        self._revive(h)
            if time.monotonic() > deadline:
                raise ClusterError(
                    f"barrier timeout waiting for {kernel} "
                    f"({len(pending)} tasks outstanding)", job=job)
            # Event-driven barrier: reports/requeues notify; the bounded
            # timeout only paces the liveness re-check above.
            with self._lock:
                if all(t in self._reports for t in tids):
                    continue
                self._cond.wait(timeout=0.5)
        with self._lock:
            out = [self._reports.pop(t) for t in tids]
            job_tids = self._job_tids.get(job)
            if job_tids is not None:
                job_tids.difference_update(tids)
        if tracer.enabled:
            # One barrier span per dispatched phase: dispatch -> last report.
            tracer.event(f"barrier:{kernel}", "ctrl", t_wall,
                         time.perf_counter() - perf0,
                         args={"tasks": len(tids), "job": job} if job
                         else {"tasks": len(tids)})
        return out

    def cancel_job(self, job: str) -> None:
        """Purge every queued task of `job` (dead-letter path): unqueue,
        forget reports, and drop the job's pcfg.  Inflight tasks on hosts
        finish and their straggler reports are ignored (the report handler
        drops unknown tids)."""
        with self._lock:
            tids = self._job_tids.pop(job, set())
            for h in list(self._queues):
                self._queues[h] = deque(
                    t for t in self._queues[h] if t["id"] not in tids)
                for tid in list(self._inflight[h]):
                    if tid in tids:
                        self._inflight[h].pop(tid)
            for tid in tids:
                self._reports.pop(tid, None)
                self._tasks.pop(tid, None)
            self._job_pcfg.pop(job, None)
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# ClusterGenerator — PartitionedGenerator over the cluster pool
# ---------------------------------------------------------------------------


class _ControllerTransport:
    """The controller's clean/flush transport, rebuilt whenever cluster
    membership changes (a restarted host's ExchangeServer has a new
    ephemeral port).  Only the driver-side operations exist — the controller
    never sends data frames; kernels exchange host-to-host."""

    kind = "cluster"

    def __init__(self, gen: "ClusterGenerator"):
        self._gen = gen
        self._tr: Optional[SocketTransport] = None
        self._ver = -1

    def _cur(self) -> SocketTransport:
        ctl = self._gen.controller
        if self._tr is None or self._ver != ctl.peers_version:
            if self._tr is not None:
                self._tr.close()
            self._tr = SocketTransport(
                self._gen.workdir, self._gen.ledger, self._gen.gauge,
                peers=ctl.wait_peer_addrs(timeout=ctl.heartbeat_timeout),
                namespace=getattr(self._gen.pcfg, "exchange_namespace", None),
                map_version=ctl.map_version())
            self._ver = ctl.peers_version
        return self._tr

    def clean_inboxes(self, names: Sequence[str]) -> None:
        # A peer can die between barriers (no task owed, so the barrier
        # loop's liveness never saw it).  Revive within the controller's
        # max_restarts budget and retry against each healed peer map; once
        # the budget is spent the failure is real and surfaces as a
        # structured ClusterError naming the sweep and attempt count.  The
        # retried CLEAN is idempotent — inboxes already swept on surviving
        # hosts just get swept again.
        ctl = self._gen.controller
        budget = max(1, int(ctl.max_restarts))
        for attempt in range(budget + 1):
            try:
                self._cur().clean_inboxes(names)
                return
            except (TransportError, OSError) as e:
                failed_ver = self._ver   # map version the failed dial used
                if self._tr is not None:
                    self._tr.close()
                    self._tr = None
                if attempt >= budget:
                    raise ClusterError(
                        f"clean_inboxes failed after {attempt + 1} "
                        f"attempt(s) ({len(names)} inbox(es), first "
                        f"{names[0] if names else '<none>'!r}): {e}",
                        task_key=f"clean:{names[0] if names else ''}",
                        attempts=attempt + 1) from e
                ctl.heal_peers(failed_ver, timeout=ctl.heartbeat_timeout)

    def purge_namespace(self) -> None:
        """Dead-letter GC: remove this generator's exchange namespace dir on
        every peer (partial inbound stores of a cancelled job)."""
        self._cur().purge_namespace()

    def flush(self) -> None:
        pass

    def close(self) -> None:
        if self._tr is not None:
            self._tr.close()
            self._tr = None


class ClusterGenerator(PartitionedGenerator):
    """The partitioned driver with its worker pool swapped for a cluster of
    HostRunners: same phase drivers, same kernels, bit-identical outputs —
    but generation, walks, and the pooled cascade's merge groups all execute
    on whichever host owns each bucket, exchanges cross the wire once, CSR
    bucket files and corpus shards live ONLY on their owner host's workdir,
    and the controller's workdir holds nothing but checkpoint state and
    manifests.

    Fine-grained phases (every clean and every barrier its own checkpoint)
    plus per-host task checkpoints give the failure story the cluster
    needs: kill a host mid-phase, relaunch (automatically via
    the exec backend within `max_restarts`, or by rerunning the whole
    launcher), and only that host's unfinished tasks re-execute.

    run() returns (graph_manifest_path, ledger); walk_corpus() returns a
    ShardedWalks over the per-host shards.  `load_csr()` assembles the CSR
    the single-host way — only meaningful where every host workdir is
    reachable (one box, or a shared view for analysis).

    `device` ("cuda" by default, which raises without CUDA) is where every
    host runs its hooks; with "cuda" the kernel libraries are built here
    before the hosts start.  The hosts' kernel launches are added to this
    process's `build.LAUNCHES` at each barrier.
    """

    _fine_phases = True

    def __init__(self, cfg, spec: ClusterSpec, workdir: str,
                 backend: Optional[ExecBackend] = None,
                 checkpoint: bool = True, keep_all: Optional[bool] = None,
                 heartbeat_timeout: float = 60.0, max_restarts: int = 1,
                 rendezvous_timeout: float = 120.0,
                 barrier_timeout: float = 600.0,
                 advertise: Optional[str] = None,
                 controller: Optional[ClusterController] = None,
                 job: str = "", lease_budget: int = 1,
                 rebalance: bool = False, device="cuda"):
        pcfg = validate_external_shape(
            dataclasses.replace(cfg, device=str(resolve_device(device)))
            if isinstance(cfg, PlainCfg) else plain_config(cfg, device))
        if pcfg.transport != "socket":
            raise ValueError("cluster runs exchange over sockets; build the "
                             "config with transport='socket'")
        if pcfg.peer_addrs is not None:
            raise ValueError("peer_addrs are discovered at rendezvous — "
                             "leave them unset for cluster runs")
        if spec.nb != pcfg.nb:
            raise ValueError(f"spec.nb={spec.nb} != cfg.nb={pcfg.nb}")
        self.spec = spec
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        # The controller/driver process traces too (barrier + phase spans);
        # "ctrl" as the host label keeps its lane distinct from host ids.
        maybe_install_tracer(workdir, enabled=pcfg.trace, host="ctrl",
                             job=job or None)
        self.ledger = IOLedger()
        self.gauge = MemoryGauge()
        self.exchange_stats = TransportStats()
        self._servers: List[ExchangeServer] = []   # none local: hosts own them
        self._pool = None
        self.max_workers = 0
        self.barrier_timeout = barrier_timeout
        self.lease_budget = lease_budget
        self._namespace = "gen"
        self._job = job
        # Skew-aware rebalancing at every phase barrier; a one-shot
        # rebalance can instead be armed at runtime through the controller's
        # `rebalance` admin op.  Committed rebalances replay on resume even
        # when the flag is off (the checkpointed map must be restored).
        self.rebalance = bool(rebalance)
        if job:
            # Multi-tenant: every exchange frame and every host-side store of
            # this generator lives under the job's namespace subdir, so
            # concurrent jobs on one fleet never share an inbox and a
            # dead-lettered job's partials can be purged by one rmtree.
            pcfg = dataclasses.replace(pcfg, exchange_namespace=job)
        if keep_all is None:
            keep_all = bool(getattr(cfg, "keep_phase_stores", False))
        self.keep_all = keep_all
        self._owns_controller = controller is None
        if controller is None:
            controller = ClusterController(
                spec, backend=backend, heartbeat_timeout=heartbeat_timeout,
                max_restarts=max_restarts, advertise=advertise,
                trace_dir=(os.path.join(workdir, TRACE_DIR) if pcfg.trace
                           else None))
            try:
                if pcfg.device.startswith("cuda"):
                    build.library()   # nvcc here, once; hosts only load the .so
                controller.launch_hosts()
                controller.wait_for_hosts(rendezvous_timeout)
            except BaseException:
                controller.stop()
                raise
        elif pcfg.trace and controller.trace_dir is None:
            # A shared (scheduler-owned) controller starts collecting host
            # traces the moment any traced job runs through it.
            controller.trace_dir = os.path.join(workdir, TRACE_DIR)
        self.controller = controller
        self.pcfg = dataclasses.replace(
            pcfg, peer_addrs=self.controller.peer_addrs(),
            shard_map_version=self.controller.map_version())
        self.transport = _ControllerTransport(self)
        self.orchestrator = PhaseOrchestrator(
            workdir, self.ledger, checkpoint=checkpoint,
            config_key=repr(("cluster", result_config_key(self.pcfg))),
            keep_all=keep_all, stats=self.exchange_stats,
            cleaner=lambda names: self.transport.clean_inboxes(names))

    # -- pool plumbing --------------------------------------------------------
    def _submit(self, kernel: str, tasks: Sequence[Tuple]) -> List:
        # Recompute-shuffle generation reads nothing local (the RMAT chunk
        # regenerates from (pcfg, lo) alone), so those leases may migrate to
        # idle hosts; everything else is pinned to the bucket owner's disk.
        reports = self.controller.run_tasks(
            kernel, [t[3] for t in tasks], self.pcfg, self._namespace,
            timeout=self.barrier_timeout, job=self._job,
            stealable=(kernel == "gen_relabel_recompute"),
            lease_budget=self.lease_budget)
        results = []
        for rep in reports:
            self.ledger.merge(rep.get("server_ledger", {}))
            self.gauge.track(int(rep.get("server_peak", 0)))
            self.exchange_stats.add(
                TransportStats(**rep.get("server_stats", {})))
            out = rep.get("out")
            results.append((tuple(out) if isinstance(out, list) else out,
                            rep.get("ledger", {}), int(rep.get("peak", 0)),
                            rep.get("stats", {}), rep.get("launched", {})))
        return results

    def _map(self, kernel, argss):
        tasks = [(kernel, self.pcfg, None, args) for args in argss]
        results = self._submit(kernel, tasks)
        outs = []
        for out, ldict, peak, sdict, launched in results:
            self.ledger.merge(ldict)
            self.gauge.track(peak)
            if sdict:
                self.exchange_stats.add(TransportStats(**sdict))
            build.add_worker_launches(launched)
            outs.append(out)
        return outs

    # -- placement hooks ------------------------------------------------------
    # All placement goes through the controller's LIVE shard map, not the
    # spec's static split — after a rebalance (or an elastic admission) the
    # spec no longer describes where buckets live.
    def _host_dir(self, b: int) -> str:
        base = self.controller.workdir_of(b)
        ns = getattr(self.pcfg, "exchange_namespace", None)
        return os.path.join(base, ns) if ns else base

    def _csr_dir(self, i: int) -> str:
        return self._host_dir(i)

    def _shard_dir_of(self, j: int) -> str:
        return self._host_dir(j)

    def _shard_host_of(self, j: int) -> int:
        return self.controller.owner_of(j)

    # -- rebalancing (phase barriers only) ------------------------------------
    def _maybe_rebalance(self, tag: str) -> None:
        """Skew-aware shard rebalance, run at a phase barrier as three
        checkpointed phases so a crash anywhere in the sequence resumes
        exactly:

          rebalance_plan[tag]     quiesce, snapshot per-bucket loads, and
                                  compute the deterministic greedy plan —
                                  saved verbatim, so a resumed run replays
                                  the identical plan
          rebalance_migrate[tag]  one MIGRATE task per move to the source
                                  host (file-granular resumable micro-phases
                                  in its host_phases.json)
          rebalance_commit[tag]   rewrite the directory + bump the map
                                  version — saved with the full map and host
                                  manifest, so a RELAUNCHED controller
                                  restores ownership (and re-admits elastic
                                  hosts) before any later phase routes
        """
        ctl = self.controller
        plan_phase = f"rebalance_plan[{tag}]"
        if not (self.rebalance or ctl.rebalance_pending()
                or self.orchestrator.completed(plan_phase)):
            return
        moves = self.orchestrator.run_phase(
            plan_phase, self._plan_moves,
            save=lambda mv: {"moves": mv},
            load=lambda m: [list(x) for x in m["moves"]])
        if not moves:
            return
        self.orchestrator.run_phase(
            f"rebalance_migrate[{tag}]",
            lambda: self._migrate_moves(moves, tag),
            save=_MARK, load=_SKIP)

        def _commit():
            ver = ctl.apply_shard_moves([(int(b), int(s), int(d))
                                         for b, s, d in moves])
            with ctl._lock:
                ctl.rebalance_requested = False
                return {"version": ver, "map": ctl.shard_map.to_json(),
                        "hosts": [dataclasses.asdict(hs)
                                  for hs in ctl.spec.hosts]}

        def _load_commit(m):
            ctl.restore_shard_state(m["map"], m.get("hosts", ()))
            return m

        self.orchestrator.run_phase(f"rebalance_commit[{tag}]", _commit,
                                    save=lambda m: m, load=_load_commit)
        self._refresh_routes()

    def _plan_moves(self) -> List[List[int]]:
        ctl = self.controller
        # Our own barrier just drained, so this only waits on OTHER jobs
        # sharing the fleet — rebalancing never happens under live traffic.
        if not ctl.quiesce(timeout=min(30.0, self.barrier_timeout)):
            raise ClusterError("rebalance needs a quiet fleet: tasks still "
                               "queued or in flight at the barrier")
        return [[int(b), int(s), int(d)] for b, s, d in ctl.plan_moves()]

    def _migrate_moves(self, moves: Sequence[Sequence[int]],
                       tag: str) -> None:
        ctl = self.controller
        # (bucket, gen, dest): args[0] places the task at the CURRENT owner
        # (the source), the split generation keys this migration apart from
        # any later move of the same bucket, args[2] routes the bytes.
        argss = [(int(b), int(ctl.shard_map.gen_of(int(b))), int(d))
                 for b, _, d in moves]
        ctl.run_tasks("migrate", argss, self.pcfg, f"rebalance[{tag}]",
                      timeout=self.barrier_timeout, job=self._job,
                      lease_budget=self.lease_budget)

    def _refresh_routes(self) -> None:
        """Post-commit: subsequent dispatches must ride the new map —
        fresh peer_addrs (bucket -> new owner's server) and the bumped map
        version (the stale-route fence's stamp).  The controller-side clean
        transport rebuilds itself lazily off peers_version."""
        ctl = self.controller
        self.pcfg = dataclasses.replace(
            self.pcfg,
            peer_addrs=ctl.wait_peer_addrs(timeout=ctl.heartbeat_timeout),
            shard_map_version=ctl.map_version())

    # -- driver ---------------------------------------------------------------
    def run(self, csr_variant: str = "sorted"):
        """All generation phases across the cluster; returns
        (graph_manifest_path, ledger).  The manifest records, per bucket,
        the owner host and its CSR file paths — the cluster twin of
        PartitionedGenerator.run()'s in-memory CSR list."""
        paths = self._run_phases(csr_variant)
        manifest_path = os.path.join(self.workdir, "graph_manifest.json")

        def _manifest():
            payload = {
                "version": 1, "nb": self.pcfg.nb,
                "scale": self.pcfg.scale, "edge_factor": self.pcfg.edge_factor,
                "csr_variant": csr_variant,
                "buckets": [
                    {"bucket": i, "host": self.controller.owner_of(i),
                     "workdir": self._host_dir(i),
                     "offv": os.path.basename(o), "adjv": os.path.basename(a)}
                    for i, (o, a) in enumerate(paths)],
            }
            tmp = manifest_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, manifest_path)

        self.orchestrator.run_phase("graph_manifest", _manifest,
                                    save=_MARK, load=_SKIP)
        return manifest_path, self.ledger

    def load_csr(self):
        """Assemble [(offv, adjv memmap)] per bucket by reading each owner
        host's files — colocated/shared-view deployments only."""
        from .phases import load_bucket_csr
        return [load_bucket_csr(csr_offv_path(self._host_dir(i), i),
                                csr_adjv_path(self._host_dir(i), i),
                                self.ledger, self.gauge)
                for i in range(self.pcfg.nb)]

    def walk_corpus(self, num_walkers: int, length: int, seed: int = 0,
                    out_name: str = "walks.npy", checkpoint: bool = True):
        self._namespace = f"walk:{num_walkers}:{length}:{seed}:{out_name}"
        try:
            return super().walk_corpus(num_walkers, length, seed=seed,
                                       out_name=out_name,
                                       checkpoint=checkpoint)
        finally:
            self._namespace = "gen"

    def walk_corpus_fused(self, specs, checkpoint: bool = True):
        """Batched corpora over the cluster: one fused hop barrier per
        bucket per step advances every (num_walkers, length, seed, out_name)
        spec through a single CSR scan on the owner host — the fused-walk
        upside, a first-class job-queue fusion."""
        self._namespace = "walkf:" + ";".join(
            f"{w}:{l}:{s}:{o}" for w, l, s, o in specs)
        try:
            return super().walk_corpus_fused(specs, checkpoint=checkpoint)
        finally:
            self._namespace = "gen"

    def close(self):
        try:
            if self._owns_controller:
                self.controller.stop()
        finally:
            self.transport.close()
