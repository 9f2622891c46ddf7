"""The port's job queue when a job or a host fails, on the CPU: a poisoned
job dead-letters after its lease budget while the other jobs drain and its
partial stores are collected; a host killed mid-lease is relaunched and its
leased tasks re-dispatch without re-running a completed task; an idle fleet
burns no CPU.  Every surviving job's files are the reference's in-process
run of that job alone (torch_cluster_parity), as in test_torch_jobqueue.py.
"""

import os
import time

import pytest

from repro_torch.core.jobqueue import load_state

from torch_cluster_parity import (
    JOB_CFG as CFG, JOBS, KillHostFirst, job_reference, job_shas, scheduler, submit_all,
)


@pytest.mark.slow
def test_poisoned_job_dead_letters_fleet_drains_and_gc(tmp_path, tmp_path_factory):
    """A job whose CSR kernel raises deterministically (csr 'scatter' under
    the feistel family) burns its lease budget and lands in the dead-letter
    queue with the task key and attempt count; the OTHER jobs drain to done
    with the reference's files; the dead job's partial stores are gone on
    every host and the controller."""
    sched = scheduler(str(tmp_path), max_concurrent=3, lease_budget=2)
    try:
        good = submit_all(sched, JOBS[:2])
        bad = sched.submit(CFG.with_(seed=13), csr_variant="scatter")
        summary = sched.drain()
        by_tag = {j["job"]: j["status"] for j in summary["jobs"]}
        assert by_tag[bad.tag] == "dead"
        assert all(by_tag[j.tag] == "done" for j in good)
        (dl,) = summary["dead_letters"]
        assert dl["job"] == bad.tag
        assert dl["attempts"] == 2
        assert "csr_scatter" in dl["task_key"]
        assert load_state(sched.root)["dead_letters"] == summary["dead_letters"]
        for h in sched.spec.hosts:
            assert not os.path.exists(os.path.join(h.workdir, bad.tag))
        assert not os.path.exists(os.path.join(sched.root, bad.tag))
        for j, d in zip(good, JOBS[:2]):
            assert job_shas(sched, j.tag) == job_reference(tmp_path_factory, d), j.tag
    finally:
        sched.close()


@pytest.mark.slow
def test_killed_host_leases_redispatch_without_rerunning_done_work(tmp_path,
                                                                  tmp_path_factory):
    """Host 1 dies hard mid-lease; its inflight tasks requeue to their owner,
    the relaunch resumes from checkpoints, every job finishes with the
    reference's files, and no task that completed fresh runs fresh again."""
    sched = scheduler(str(tmp_path / "q"), backend=KillHostFirst(),
                      max_concurrent=3, max_restarts=1)
    try:
        jobs = submit_all(sched)
        summary = sched.drain()
        assert [j["status"] for j in summary["jobs"]] == ["done"] * 3
        assert sched.controller.restarts[1] == 1
        fresh = {}
        for e in sched.controller.task_log:
            if e["ok"] and not e["resumed"]:
                k = (e["job"], e["key"])   # keys repeat across jobs by design
                fresh[k] = fresh.get(k, 0) + 1
        rerun = {k: n for k, n in fresh.items() if n > 1}
        assert not rerun, f"completed tasks re-ran fresh: {rerun}"
        for j, d in zip(jobs, JOBS):
            assert job_shas(sched, j.tag) == job_reference(tmp_path_factory, d), j.tag
    finally:
        sched.close()


def _proc_cpu_seconds(pid):
    with open(f"/proc/{pid}/stat") as f:
        parts = f.read().rsplit(") ", 1)[1].split()
    return (int(parts[11]) + int(parts[12])) / os.sysconf("SC_CLK_TCK")


@pytest.mark.slow
@pytest.mark.skipif(not os.path.exists("/proc/self/stat"), reason="needs /proc")
def test_idle_cluster_burns_no_cpu(tmp_path):
    """2 live hosts + controller, zero queued tasks, for 2 wall seconds: the
    condition-variable barriers and long-poll leases leave the whole fleet
    asleep."""
    sched = scheduler(str(tmp_path), max_concurrent=2)
    try:
        pids = [h.pid for h in sched.controller._handles.values()]
        t0_self = time.process_time()
        t0_hosts = sum(_proc_cpu_seconds(p) for p in pids)
        time.sleep(2.0)
        d_self = time.process_time() - t0_self
        d_hosts = sum(_proc_cpu_seconds(p) for p in pids) - t0_hosts
        assert d_self < 0.4, f"controller burned {d_self:.2f}s CPU while idle"
        assert d_hosts < 0.6, f"hosts burned {d_hosts:.2f}s CPU while idle"
    finally:
        sched.close()
