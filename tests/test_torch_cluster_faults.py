"""The port's cluster runtime when a host fails, on the CPU against the
reference: the controller's auto-restart of a host killed mid-phase, the
relaunch of the whole cluster that re-executes only the killed host's
unfinished tasks, and a host without CUDA handed a CUDA task, which fails
the task instead of running it on the CPU.

As in test_torch_cluster.py, the oracle is the reference's in-process
PartitionedGenerator fs run of the same graph (torch_cluster_parity).
"""

import dataclasses

import numpy as np
import pytest

from repro_torch.core.cluster import (
    ClusterError,
    ClusterGenerator,
    LocalExecBackend,
    TaskError,
)

from torch_cluster_parity import (
    CFG, ENV, L, W, WSEED, KillHostFirst, host_shas, make_cluster, reference,
)
# ---------------------------------------------------------------------------
# failure handling
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_cluster_auto_restart_dead_host(tmp_path, tmp_path_factory):
    """Host 1 is killed (hard exit) mid-phase; the controller relaunches it,
    re-dispatches the lost tasks, and the run completes bit-identical."""
    want, corpora, _ = reference(tmp_path_factory)
    _, gen = make_cluster(tmp_path, "ar", backend=KillHostFirst(), max_restarts=1)
    try:
        gen.run()
        walks = np.asarray(gen.walk_corpus(W, L, seed=WSEED)).copy()
        assert gen.controller.restarts[1] == 1, gen.controller.restarts
        np.testing.assert_array_equal(walks, corpora["walks.npy"])
        assert host_shas(gen) == want
    finally:
        gen.close()


@pytest.mark.slow
def test_cluster_host_kill_relaunch_resumes_host_only(tmp_path, tmp_path_factory):
    """With the restart budget spent, a mid-phase host kill fails the run;
    relaunching the whole cluster over the same workdirs resumes: host 0
    replays NOTHING it completed, only host 1 recomputes, and the files are
    the reference's."""
    want, corpora, _ = reference(tmp_path_factory)
    spec, gen = make_cluster(tmp_path, "kr", backend=KillHostFirst(), max_restarts=0)
    try:
        with pytest.raises(ClusterError, match="restart budget"):
            gen.run()
    finally:
        run1_done = {e["key"] for e in gen.controller.task_log
                     if e["host"] == 0 and e["ok"]}
        gen.close()
    assert run1_done, "host 0 should have completed some tasks before abort"
    gen = ClusterGenerator(CFG.with_(transport="socket"), spec, str(tmp_path / "kr" / "ctrl"),
                           backend=LocalExecBackend(env=ENV), checkpoint=True, device="cpu")
    try:
        gen.run()
        walks = np.asarray(gen.walk_corpus(W, L, seed=WSEED)).copy()
        log = gen.controller.task_log
        recomputed = [e for e in log if e["host"] == 0
                      and e["key"] in run1_done and not e["resumed"]]
        assert not recomputed, f"host 0 recomputed: {recomputed[:5]}"
        assert any(e["host"] == 1 and not e["resumed"] for e in log)
        np.testing.assert_array_equal(walks, corpora["walks.npy"])
        assert host_shas(gen) == want
    finally:
        gen.close()


# ---------------------------------------------------------------------------
# a host without CUDA never runs a CUDA task on the CPU
# ---------------------------------------------------------------------------


def test_host_without_cuda_fails_a_cuda_task(tmp_path):
    """Hosts that see no card (CUDA_VISIBLE_DEVICES empty) handed a "cuda"
    config fail the first task that reaches a kernel hook (R-MAT generation)
    with a TaskError naming it; no such task ever reports success."""
    _, gen = make_cluster(tmp_path, "nc", lease_budget=1,
                          backend=LocalExecBackend(env={**ENV, "CUDA_VISIBLE_DEVICES": ""}))
    try:
        gen.pcfg = dataclasses.replace(gen.pcfg, device="cuda")
        with pytest.raises(TaskError, match="torch.cuda.is_available") as e:
            gen.run()
        assert ":generate:" in e.value.task_key and e.value.attempts == 1
        assert not any(r["ok"] and ":generate:" in r["key"] for r in gen.controller.task_log)
    finally:
        gen.close()
