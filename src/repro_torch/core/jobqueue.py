"""Multi-tenant job queue over the cluster runtime (twin of
`repro.core.jobqueue`).

A bare ClusterGenerator drives exactly ONE graph at a time: every
HostRunner idles at every phase barrier while stragglers finish.  This
module layers a persistent job queue on the same rendezvous/control-frame
protocol: submit many (graph, corpus, config) jobs, decompose each into
the per-phase task keys HostRunner already checkpoints
(phases.phase_task_plan), and run several jobs' barrier loops concurrently
against one shared controller so hosts PULL work — bounded lease batches
from their own queue first, then STEAL migratable tasks from a busy peer's
queue tail.  One job's straggler never idles the fleet: the idle host
leases another job's tasks (independent jobs' I/O and exchange phases
overlap), and walk corpora submitted with `fuse_walks` batch every seed's
hop through one CSR scan per bucket (walk_hop_fused).

Isolation is by namespace: each job's exchange frames and host-side stores
live under the job tag's subdir (PlainCfg.exchange_namespace), so
concurrent jobs never share an inbox and a poisoned job's partials are one
rmtree to GC.  A task that fails deterministically past its lease budget
raises the job-scoped TaskError; the scheduler parks the job in the
DEAD-LETTER list (bulkhead: the bad job can't wedge the queue), cancels
its queued tasks, purges its namespace on every host, and keeps draining
the rest.  Every job's outputs are bit-identical to a serial single-job
run — the scheduler changes WHEN tasks run, never what they compute.

Queue state persists in <root>/jobqueue.json (atomic replace), so a
killed scheduler resumes: finished jobs stay done, a job caught mid-run
re-enters the queue and resumes from its per-host checkpoints.

Device is dispatch-time state, not job identity: a job's stored config
keeps the normalized device ("cuda", as `result_config_key` has it), and
the scheduler injects its own `device` into every job it runs, as it
injects the live peer addresses and shard-map version.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from ..device import resolve_device
from ..kernels import build
from .cluster import (
    ClusterController,
    ClusterGenerator,
    ClusterSpec,
    ExecBackend,
    TaskError,
    _pcfg_from_wire,
    _pcfg_to_wire,
)
from .phases import (
    PlainCfg,
    phase_task_plan,
    plain_config,
    validate_external_shape,
)
from .trace import TRACE_DIR

QUEUE_FILE = "jobqueue.json"


# ---------------------------------------------------------------------------
# JobSpec + persistent queue state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JobSpec:
    """One queued generation job: config, optional walk corpora, and the
    static task-key plan exported at submit time.  `tag` doubles as the
    job's exchange namespace and its workdir subdir on every host."""

    job_id: int
    cfg: Dict                                   # wire-form PlainCfg
    csr_variant: str = "sorted"
    walks: List[List] = dataclasses.field(default_factory=list)
    fuse_walks: bool = False
    fuse_gen_relabel: bool = False
    name: str = ""
    status: str = "queued"                      # queued|running|done|dead
    error: str = ""
    plan: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def tag(self) -> str:
        return f"job{self.job_id:04d}"

    @property
    def num_tasks(self) -> int:
        return sum(len(p["keys"]) for p in self.plan)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "JobSpec":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


def _state_path(root: str) -> str:
    return os.path.join(root, QUEUE_FILE)


def load_state(root: str) -> Dict:
    """Queue state: {"version", "next_id", "jobs", "dead_letters"}."""
    path = _state_path(root)
    if not os.path.exists(path):
        return {"version": 1, "next_id": 0, "jobs": [], "dead_letters": []}
    with open(path) as f:
        return json.load(f)


def save_state(root: str, state: Dict) -> str:
    os.makedirs(root, exist_ok=True)
    path = _state_path(root)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1)
    os.replace(tmp, path)
    return path


def submit_job(root: str, cfg, csr_variant: str = "sorted",
               walks: Sequence[Tuple[int, int, int, str]] = (),
               fuse_walks: bool = False, fuse_gen_relabel: bool = False,
               name: str = "") -> JobSpec:
    """Append one job to <root>/jobqueue.json and return its JobSpec.  No
    controller needed — submission is a pure queue edit, so the CLI can
    enqueue while nothing is running (or while a drain is in flight on
    another box sharing the root).  The task-key plan is computed here,
    once: invalid configs (pooled_cascade, bad csr_variant, fuse without
    recompute) are rejected at submit time, not at dispatch.  Touches no
    device: the config is built for the CPU and stored with its device
    normalized."""
    pcfg = validate_external_shape(
        cfg if isinstance(cfg, PlainCfg) else plain_config(cfg, device="cpu"))
    # Routing fields (and the device) are dispatch-time state, never job
    # identity: the scheduler injects live peer_addrs, the current
    # shard-map version and its device at every lease, so the stored cfg
    # (and the task-key plan derived from it) stays stable across
    # rebalances and devices.
    pcfg = dataclasses.replace(pcfg, transport="socket", peer_addrs=None,
                               exchange_namespace=None, shard_map_version=0,
                               device="cuda")
    walks = [list(w) for w in walks]
    plan = phase_task_plan(pcfg, csr_variant=csr_variant,
                           walks=[tuple(w) for w in walks],
                           fuse_gen_relabel=fuse_gen_relabel,
                           fuse_walks=fuse_walks)
    state = load_state(root)
    job = JobSpec(job_id=int(state["next_id"]), cfg=_pcfg_to_wire(pcfg),
                  csr_variant=csr_variant, walks=walks,
                  fuse_walks=bool(fuse_walks),
                  fuse_gen_relabel=bool(fuse_gen_relabel),
                  name=name or f"scale{pcfg.scale}", plan=plan)
    state["next_id"] = job.job_id + 1
    state["jobs"].append(job.to_json())
    save_state(root, state)
    return job


# ---------------------------------------------------------------------------
# JobScheduler — concurrent drains over one shared controller
# ---------------------------------------------------------------------------


class JobScheduler:
    """Owns one ClusterController and drains the persistent queue through
    it: up to `max_concurrent` jobs run their phase-barrier loops on
    concurrent threads, so while job A waits on a straggler's barrier the
    hosts lease (or steal) job B's tasks.  `lease_size` bounds tasks per
    poll (small leases keep the tail stealable); `lease_budget` is the
    dispatch budget a deterministically failing task gets before its job
    dead-letters.

    Results per job land in <root>/<tag>/ on the controller and under the
    <tag>/ namespace subdir of every host workdir — bit-identical to
    running that job alone.

    Every job runs its hooks on `device` ("cuda" by default, which raises
    without CUDA); with "cuda" the kernel libraries are built here before
    the hosts start."""

    def __init__(self, spec: ClusterSpec, root: str,
                 backend: Optional[ExecBackend] = None,
                 max_concurrent: int = 2, lease_size: int = 2,
                 lease_budget: int = 2, heartbeat_timeout: float = 60.0,
                 max_restarts: int = 1, rendezvous_timeout: float = 120.0,
                 barrier_timeout: float = 600.0, checkpoint: bool = True,
                 advertise: Optional[str] = None, device="cuda"):
        self.device = str(resolve_device(device))
        self.spec = spec
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.max_concurrent = max(1, int(max_concurrent))
        self.lease_budget = max(1, int(lease_budget))
        self.barrier_timeout = barrier_timeout
        self.checkpoint = checkpoint
        self._state_lock = threading.Lock()
        self.state = load_state(root)
        self.makespan = 0.0
        # trace_dir is armed unconditionally: hosts only SHIP trace lines
        # when a traced job installed their tracer, so untraced queues never
        # create the directory.
        self.controller = ClusterController(
            spec, backend=backend, heartbeat_timeout=heartbeat_timeout,
            max_restarts=max_restarts, advertise=advertise,
            lease_size=lease_size,
            trace_dir=os.path.join(root, TRACE_DIR))
        try:
            if self.device.startswith("cuda"):
                build.library()   # nvcc here, once; hosts only load the .so
            self.controller.launch_hosts()
            self.controller.wait_for_hosts(rendezvous_timeout)
        except BaseException:
            self.controller.stop()
            raise

    # -- queue plumbing ------------------------------------------------------
    def submit(self, cfg, **kw) -> JobSpec:
        with self._state_lock:
            job = submit_job(self.root, cfg, **kw)
            self.state = load_state(self.root)
        return job

    def jobs(self) -> List[JobSpec]:
        with self._state_lock:
            return [JobSpec.from_json(d) for d in self.state["jobs"]]

    def _update(self, job: JobSpec, dead_letter: Optional[Dict] = None) -> None:
        with self._state_lock:
            for i, d in enumerate(self.state["jobs"]):
                if d["job_id"] == job.job_id:
                    self.state["jobs"][i] = job.to_json()
            if dead_letter is not None:
                self.state["dead_letters"].append(dead_letter)
            save_state(self.root, self.state)

    # -- execution -----------------------------------------------------------
    def _run_job(self, job: JobSpec) -> None:
        job.status = "running"
        self._update(job)
        gen = ClusterGenerator(
            _pcfg_from_wire(job.cfg), self.spec,
            workdir=os.path.join(self.root, job.tag),
            controller=self.controller, job=job.tag,
            checkpoint=self.checkpoint, barrier_timeout=self.barrier_timeout,
            lease_budget=self.lease_budget, device=self.device)
        dead_letter = None
        try:
            gen.run(csr_variant=job.csr_variant)
            specs = [tuple(w) for w in job.walks]
            if specs:
                if job.fuse_walks and len(specs) > 1:
                    gen.walk_corpus_fused(specs, checkpoint=self.checkpoint)
                else:
                    for (W, L, seed, out_name) in specs:
                        gen.walk_corpus(W, L, seed=seed, out_name=out_name,
                                        checkpoint=self.checkpoint)
            job.status = "done"
            job.error = ""
        except TaskError as e:
            # Poisoned task past its lease budget: dead-letter the JOB —
            # park it, cancel its queued tasks, GC its partial stores on
            # every host (one namespace rmtree) and on the controller —
            # and let every other job keep draining.
            dead_letter = {"job": job.tag, "task_key": e.task_key,
                           "attempts": e.attempts, "error": str(e)}
            job.status = "dead"
            job.error = str(e)
            self.controller.cancel_job(job.tag)
            try:
                gen.transport.purge_namespace()
            except Exception:
                pass   # a host died with the job; its relaunch re-sweeps
            shutil.rmtree(os.path.join(self.root, job.tag),
                          ignore_errors=True)
        finally:
            gen.close()    # transport only — the controller is shared
            self._update(job, dead_letter)

    def drain(self) -> Dict:
        """Run every queued job to done/dead, `max_concurrent` at a time,
        and return the fleet summary.  Jobs found 'running' (a killed
        scheduler) re-enter and resume from their checkpoints.  Utilization
        is busy-seconds summed over hosts divided by fleet-seconds of the
        drain — the number the work-stealing overlap is supposed to move."""
        todo = [j for j in self.jobs() if j.status in ("queued", "running")]
        with self.controller._lock:
            base_busy = dict(self.controller.busy_seconds)
        t0 = time.monotonic()
        if todo:
            with ThreadPoolExecutor(
                    max_workers=min(self.max_concurrent, len(todo)),
                    thread_name_prefix="jobq") as pool:
                futs = [pool.submit(self._run_job, j) for j in todo]
                for f in futs:
                    f.result()
        self.makespan = time.monotonic() - t0
        with self.controller._lock:
            busy = sum(v - base_busy.get(h, 0.0)
                       for h, v in self.controller.busy_seconds.items())
        fleet = self.spec.num_hosts * self.makespan
        self.state = load_state(self.root)
        summary = {
            "jobs": [{"job": j.tag, "name": j.name, "status": j.status,
                      "tasks": j.num_tasks} for j in self.jobs()],
            "makespan_s": self.makespan,
            "busy_s": busy,
            "utilization": (busy / fleet) if fleet > 0 else 0.0,
            "steals": self.controller.steals,
            "dead_letters": list(self.state["dead_letters"]),
        }
        return summary

    def close(self) -> None:
        self.controller.stop()

    def __enter__(self) -> "JobScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
