"""The port's twin of tests/test_jobqueue.py, on the CPU: the multi-tenant
job queue of `repro_torch` (work-stealing leases, fused walk batches, the
task-key plan, submission that touches no device), a 2-host queue of three
concurrent jobs, and the `submit`/`queue`/`drain` CLI.  The dead-letter,
host-kill and idle cases are in test_torch_jobqueue_faults.py.

Every job's CSR bucket files and corpus shards, as its hosts leave them in
the job's subdir, must be the reference's in-process PartitionedGenerator fs
run of that job alone (torch_cluster_parity): a queue changes when tasks
run, never what they compute.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import cluster as ref_cluster
from repro.core import jobqueue as ref_jobqueue
from repro.core.types import GraphConfig as RefConfig
from repro_torch.core.cluster import (
    ClusterController,
    ClusterError,
    ClusterSpec,
    TaskError,
    heartbeat_period,
)
from repro_torch.core.corpus import ShardedWalks, manifest_name
from repro_torch.core.jobqueue import JobSpec, load_state, submit_job
from repro_torch.core.phases import PartitionedGenerator, phase_task_plan, plain_config
from repro_torch.kernels import build

from torch_cluster_parity import (
    ENV, JOB_CFG as CFG, JOBS, job_reference, job_shas, scheduler, submit_all, workdir_shas,
)
from torch_parity import ROOT

# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


def test_heartbeat_period_derived_and_clamped():
    """timeout/8, clamped to [0.2, 15], as the reference's."""
    assert heartbeat_period(16.0) == 2.0
    assert heartbeat_period(60.0) == 7.5
    assert heartbeat_period(0.5) == 0.2
    assert heartbeat_period(1e6) == 15.0
    for t in (0.1, 0.5, 3.0, 16.0, 60.0, 200.0, 1e6):
        assert heartbeat_period(t) == ref_cluster.heartbeat_period(t)


def test_task_error_is_structured_and_job_scoped():
    e = TaskError("task k failed", task_key="gen:generate:3", attempts=2, job="job0007")
    assert (e.task_key, e.attempts, e.job) == ("gen:generate:3", 2, "job0007")
    assert isinstance(e, ClusterError)


def test_lease_steals_only_migratable_tail_tasks(tmp_path):
    """An idle host's lease first drains its own queue head; only then does
    it steal stealable tasks from the longest victim queue's TAIL, leaving
    the owner-bound tasks in order."""
    spec = ClusterSpec.local(2, str(tmp_path), nb=CFG.nb)
    ctl = ClusterController(spec, backend=None, lease_size=2)
    try:
        def _task(tid, owner, stealable):
            return {"id": tid, "key": f"k{tid}", "kernel": "x", "args": (),
                    "attempt": 0, "job": "job0000", "stealable": stealable,
                    "owner": owner}
        with ctl._lock:
            ctl._queues[1].extend(_task(t, 1, s) for t, s in
                                  ((0, False), (1, True), (2, False), (3, True), (4, True)))
            lease = ctl._lease_locked(1)
            assert [t["id"] for t in lease] == [0, 1] and ctl.steals == 0
            lease = ctl._lease_locked(0)
            assert [t["id"] for t in lease] == [4, 3]
            assert ctl.steals == 2
            assert set(ctl._inflight[0]) == {3, 4}
            assert [t["id"] for t in ctl._queues[1]] == [2]
            assert ctl._lease_locked(0) == [] and ctl.steals == 2
    finally:
        ctl.stop()


def test_phase_task_plan_shapes_and_rejections():
    """The task-key plan the queue exports is the reference's, key for key."""
    from repro.core.phases import phase_task_plan as ref_plan
    from repro.core.phases import plain_config as ref_plain

    ref_cfg = RefConfig(scale=8, nb=4, chunk_edges=256, edge_factor=4,
                        shuffle_variant="recompute", transport="socket")
    pcfg = plain_config(CFG, "cpu")
    plan = phase_task_plan(pcfg, walks=[(8, 3, 1, "a.npy")])
    assert plan == ref_plan(ref_plain(ref_cfg), walks=[(8, 3, 1, "a.npy")])
    phases = [p["phase"] for p in plan]
    assert phases[0] == "generate" and "csr_sorted" in phases
    for p in plan:
        for d in p["deps"]:
            assert phases.index(d) < phases.index(p["phase"])
    kw = dict(walks=[(8, 3, 1, "a.npy"), (8, 3, 2, "b.npy")], fuse_walks=True,
              fuse_gen_relabel=True)
    fused = phase_task_plan(pcfg, **kw)
    assert fused == ref_plan(ref_plain(ref_cfg), **kw)
    hop = [p for p in fused if p["phase"] == "walk_hop_0000"]
    assert len(hop) == 1 and len(hop[0]["keys"]) == pcfg.nb
    init = next(p for p in fused if p["phase"] == "walk_init")
    assert len(init["keys"]) == 2 * pcfg.nb
    assert any(k.endswith(":w1_") for k in init["keys"])
    with pytest.raises(ValueError, match="pooled_cascade"):
        phase_task_plan(plain_config(CFG.with_(pooled_cascade=True), "cpu"))
    with pytest.raises(ValueError, match="equal lengths"):
        phase_task_plan(pcfg, walks=[(8, 3, 1, "a.npy"), (8, 4, 2, "b.npy")], fuse_walks=True)
    with pytest.raises(ValueError, match="recompute"):
        phase_task_plan(plain_config(CFG.with_(shuffle_variant="external"), "cpu"),
                        fuse_gen_relabel=True)


def test_submit_persists_and_round_trips(tmp_path, monkeypatch):
    """Submission is a pure queue edit: it touches no device (CUDA absent,
    the kernel build forbidden), stores the device normalized, and writes
    the reference's plan."""
    def no_build():
        raise AssertionError("submit_job built the kernels")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "library", no_build)
    root = str(tmp_path)
    j = submit_job(root, CFG, walks=[(8, 3, 1, "a.npy")], fuse_walks=False, name="first")
    assert j.job_id == 0 and j.tag == "job0000"
    assert j.cfg["device"] == "cuda" and j.cfg["transport"] == "socket"
    j2 = submit_job(root, CFG.with_(seed=9))
    assert j2.job_id == 1
    state = load_state(root)
    back = [JobSpec.from_json(d) for d in state["jobs"]]
    assert [b.tag for b in back] == ["job0000", "job0001"]
    assert back[0].name == "first" and back[0].status == "queued"
    assert back[0].num_tasks == j.num_tasks > 0
    assert back[0].plan == j.plan
    ref = ref_jobqueue.submit_job(str(tmp_path / "ref"), RefConfig(
        scale=8, nb=4, chunk_edges=256, edge_factor=4, shuffle_variant="recompute",
        transport="socket"), walks=[(8, 3, 1, "a.npy")], name="first")
    assert ref.plan == j.plan
    assert {k: v for k, v in j.cfg.items() if k != "device"} == ref.cfg


# ---------------------------------------------------------------------------
# fused corpora (single host — the fusion itself, no cluster)
# ---------------------------------------------------------------------------


def test_fused_walks_and_gen_relabel_bit_identical(tmp_path, tmp_path_factory):
    """walk_corpus_fused: k corpora through one CSR scan per hop, and the
    fused gen_relabel: the reference's unfused files, corpus for corpus."""
    specs = [(12, 4, 3, "s3.npy"), (12, 4, 5, "s5.npy"), (12, 4, 9, "s9.npy")]
    want = job_reference(tmp_path_factory, dict(cfg=CFG, walks=specs))
    d = str(tmp_path / "f")
    gen = PartitionedGenerator(CFG.with_(transport="fs"), d, max_workers=0, device="cpu")
    gen._fuse_gen_relabel = True
    with gen:
        gen.run()
        gen.walk_corpus_fused(specs)
    assert workdir_shas([d]) == want


# ---------------------------------------------------------------------------
# a 3-job concurrent queue on 2 hosts == each job alone
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_three_job_queue_bit_identical_to_serial(tmp_path, tmp_path_factory):
    sched = scheduler(str(tmp_path / "q"), max_concurrent=3, lease_size=2)
    try:
        jobs = submit_all(sched)
        assert all(j.cfg["device"] == "cuda" for j in jobs)   # stored normalized
        summary = sched.drain()
        assert [j["status"] for j in summary["jobs"]] == ["done"] * 3
        assert summary["utilization"] > 0 and summary["dead_letters"] == []
        assert {e["job"] for e in sched.controller.task_log} == {j.tag for j in jobs}
        for j, d in zip(jobs, JOBS):
            assert job_shas(sched, j.tag) == job_reference(tmp_path_factory, d), j.tag
            for (W, L, _, o) in d.get("walks", []):
                walks = ShardedWalks(os.path.join(sched.root, j.tag, manifest_name(o)))
                assert np.asarray(walks).shape == (W, L + 1)
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# CLI: submit -> queue -> drain
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_jobqueue_cli_end_to_end(tmp_path, tmp_path_factory):
    root = str(tmp_path / "cli")
    env = dict(os.environ, **ENV)

    def cli(*args, timeout=300):
        return subprocess.run([sys.executable, "-m", "repro_torch.launch.cluster", *args],
                              env=env, cwd=ROOT, capture_output=True, text=True,
                              timeout=timeout)

    s1 = cli("submit", "--workdir", root, "--scale", "8", "--nb", "4",
             "--chunk-edges", "256", "--recompute", "--fuse-gen-relabel",
             "--walks", "8:3:1:a.npy", "--walks", "8:3:2:b.npy", "--fuse-walks")
    s2 = cli("submit", "--workdir", root, "--scale", "9", "--nb", "4",
             "--chunk-edges", "256", "--recompute")
    assert s1.returncode == 0 and s2.returncode == 0, s1.stderr + s2.stderr
    q = cli("queue", "--workdir", root)
    assert "queued" in q.stdout and "scale9" in q.stdout
    bad = cli("drain", "--workdir", root, "--hosts", "2", "--nb", "4")
    assert bad.returncode != 0 and "torch.cuda.is_available() is False" in bad.stderr
    d = cli("drain", "--workdir", root, "--hosts", "2", "--nb", "4",
            "--max-concurrent", "2", "--device", "cpu")
    assert d.returncode == 0, d.stderr[-2000:]
    summary = json.loads(d.stdout[d.stdout.index("{"):])
    assert [j["status"] for j in summary["jobs"]] == ["done", "done"]
    walks = ShardedWalks(os.path.join(root, "ctrl", "job0000", "a_manifest.json"))
    assert np.asarray(walks).shape == (8, 4)
    hosts = [os.path.join(root, f"host{h}") for h in range(2)]
    seed = 0x5EED_1234
    assert workdir_shas(hosts, "job0000") == job_reference(tmp_path_factory, dict(
        cfg=CFG.with_(seed=seed), walks=[(8, 3, 1, "a.npy"), (8, 3, 2, "b.npy")]))
    assert workdir_shas(hosts, "job0001") == job_reference(tmp_path_factory, dict(
        cfg=CFG.with_(scale=9, seed=seed)))
