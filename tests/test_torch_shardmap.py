"""The port's twin of tests/test_shardmap.py, on the CPU: the skew-aware
shard map's migration resume, stale-route fencing, and the rebalanced /
elastic cluster scenarios of `repro_torch`, each cluster run held to the
reference's in-process PartitionedGenerator fs run (torch_cluster_parity):
its CSR bucket files and corpus shards, byte for byte.

The contract under test: the ShardMap changes *where* bytes live, never
*what* they are — a rebalanced (or elastically grown) cluster run is
bit-identical to the static map; a mid-migration kill resumes without
re-sending completed files; frames routed under a stale map are refused.
"""

import json
import os

import numpy as np
import pytest

from repro.core import cluster as ref_cluster
from repro_torch.core.blockstore import BlockStore, IOLedger, split_counter_key
from repro_torch.core.cluster import (
    ClusterGenerator,
    LocalExecBackend,
    bucket_file_relpaths,
    migrate_bucket_files,
)
from repro_torch.core.corpus import ShardedWalks, shard_name
from repro_torch.core.phases import PhaseOrchestrator
from repro_torch.core.shardmap import ShardMap, plan_rebalance
from repro_torch.core.transport import (
    ExchangeServer,
    SocketTransport,
    TransportError,
    store_bucket,
)

from torch_cluster_parity import (
    CFG, ENV, L, W, WSEED, KillHostFirst, host_shas, make_cluster, reference,
)

# Synthetic per-bucket load profile forcing a deterministic plan on the
# contiguous 2-host split of nb=4 (host0 owns {0,1}, host1 owns {2,3}):
# bucket 0 dominates, so the greedy planner ships it to the cold host and
# backfills the cold buckets the other way — the straggler host ends up
# holding only the cold remainder.
SKEW_LOADS = {0: 1 << 30, 1: 1 << 24, 2: 1 << 20, 3: 1 << 20}


@pytest.fixture(scope="module")
def single_host_ref(tmp_path_factory):
    """The reference's files and corpus every cluster scenario is held to."""
    shas, corpora, _ = reference(tmp_path_factory)
    return {"shas": shas, "walks": corpora["walks.npy"]}


# ---------------------------------------------------------------------------
# IOLedger per-bucket counters (the rebalancer's skew signal)
# ---------------------------------------------------------------------------


def test_ledger_bucket_counters_flatten_and_merge():
    a = IOLedger()
    a.bucket(3, 100, rows=10)
    a.bucket(3, 50, rows=5)
    a.bucket(0, 7, rows=1)
    d = a.as_dict()
    assert d["bucket_bytes[0]"] == 7 and d["bucket_bytes[3]"] == 150
    assert d["bucket_rows[3]"] == 15
    b = IOLedger()
    b.write(9)
    b.merge(d)
    assert b.bucket_bytes == {0: 7, 3: 150}
    assert b.bucket_rows == {0: 1, 3: 15}
    assert b.bytes_written == 9
    # flattened keys parse back; plain keys pass through
    assert split_counter_key("bucket_bytes[12]") == ("bucket_bytes", 12)
    assert split_counter_key("bytes_read") == ("bytes_read", None)
    # unknown keys are ignored (forward compatibility), not an error
    b.merge({"not_a_counter": 5, "bucket_bytes[1]": 1})
    assert b.bucket_bytes[1] == 1


def test_blockstore_names_carry_bucket_attribution(tmp_path):
    assert store_bucket("owned_b003_sorted") == 3
    assert store_bucket("rl2_b000") == 0
    assert store_bucket("walks_b012.npy") == 12
    assert store_bucket("graph_manifest.json") is None
    ledger = IOLedger()
    st = BlockStore(str(tmp_path), "edges_b001", ledger)
    st.append_run(np.arange(4), np.arange(4))
    assert ledger.rows_written == 4


# ---------------------------------------------------------------------------
# migration: file discovery + resumable micro-phases
# ---------------------------------------------------------------------------


def _seed_host_workdir(workdir):
    """A host workdir shaped like a real run: bucket stores at top level,
    a namespaced job subdir, CSR files, a corpus shard, and distractors."""
    os.makedirs(workdir, exist_ok=True)
    ledger = IOLedger()
    st = BlockStore(workdir, "owned_b001", ledger)
    st.append_run(np.arange(8), np.arange(8) + 1)
    st.append_run(np.arange(3), np.arange(3) * 2)
    os.makedirs(os.path.join(workdir, "jobA"), exist_ok=True)
    st2 = BlockStore(os.path.join(workdir, "jobA"), "rl0_b001", ledger,
                     columns=("v",))
    st2.append_run(np.arange(5))
    np.save(os.path.join(workdir, "csr_offv_001.npy"), np.arange(6))
    np.save(os.path.join(workdir, "csr_adjv_001.npy"), np.arange(9))
    np.save(os.path.join(workdir, shard_name("walks.npy", 1)),
            np.arange(12).reshape(3, 4))
    # distractors that must NOT migrate with bucket 1
    st3 = BlockStore(workdir, "owned_b000", ledger)
    st3.append_run(np.arange(2), np.arange(2))
    np.save(os.path.join(workdir, "csr_offv_000.npy"), np.arange(2))
    with open(os.path.join(workdir, "host_phases.json"), "w") as f:
        json.dump({}, f)


def test_bucket_file_relpaths_spans_namespaces_and_csr(tmp_path):
    wd = str(tmp_path)
    _seed_host_workdir(wd)
    rels = bucket_file_relpaths(wd, 1)
    assert rels == ref_cluster.bucket_file_relpaths(wd, 1)
    assert "csr_offv_001.npy" in rels and "csr_adjv_001.npy" in rels
    assert shard_name("walks.npy", 1) in rels
    assert sum(r.startswith("owned_b001/") for r in rels) == 2
    assert sum(r.startswith("jobA/rl0_b001/") for r in rels) == 1
    # bucket 0's store and CSR file stay put; checkpoint state never moves
    assert not any("b000" in r.split("/")[0] or r.startswith("csr_offv_000")
                   for r in rels)
    assert not any(r.endswith(".json") for r in rels)


def test_migrate_resumes_without_resending_completed_files(tmp_path):
    """The acceptance criterion, file-granular: kill the migration after N
    files, resume, and the completed files are never re-sent."""
    src_dir, dst_dir = str(tmp_path / "src"), str(tmp_path / "dst")
    _seed_host_workdir(src_dir)
    os.makedirs(dst_dir, exist_ok=True)
    all_rels = bucket_file_relpaths(src_dir, 1)
    originals = {}
    for rel in all_rels:
        with open(os.path.join(src_dir, *rel.split("/")), "rb") as f:
            originals[rel] = f.read()
    srv = ExchangeServer(dst_dir)
    try:
        class _Dies(SocketTransport):
            budget = 2

            def send_file(self, addr, src_path, rel_path, **kw):
                if _Dies.budget <= 0:
                    raise TransportError("injected mid-migration crash")
                _Dies.budget -= 1
                return super().send_file(addr, src_path, rel_path, **kw)

        tr = _Dies(src_dir, IOLedger(), peers=(srv.addr,))
        orch = PhaseOrchestrator(src_dir, IOLedger(), checkpoint=True,
                                 state_name="host_phases.json")
        with pytest.raises(TransportError, match="injected"):
            migrate_bucket_files(src_dir, 1, srv.addr, tr, orch=orch,
                                 key="mig:1:0")
        tr.close()
        done = [r for r in all_rels
                if not os.path.exists(os.path.join(src_dir, *r.split("/")))]
        assert len(done) == 2    # sent+unlinked before the injected crash

        # resume: fresh transport + fresh orchestrator (state reloads)
        sent_rels = []

        class _Records(SocketTransport):
            def send_file(self, addr, src_path, rel_path, **kw):
                sent_rels.append(rel_path)
                return super().send_file(addr, src_path, rel_path, **kw)

        tr2 = _Records(src_dir, IOLedger(), peers=(srv.addr,))
        orch2 = PhaseOrchestrator(src_dir, IOLedger(), checkpoint=True,
                                  state_name="host_phases.json")
        out = migrate_bucket_files(src_dir, 1, srv.addr, tr2, orch=orch2,
                                   key="mig:1:0")
        tr2.close()
        assert set(sent_rels) == set(all_rels) - set(done)
        assert out["files"] == len(all_rels) - len(done)
    finally:
        srv.stop()
    # destination holds every file of bucket 1, bit-identical
    for rel, blob in originals.items():
        with open(os.path.join(dst_dir, *rel.split("/")), "rb") as f:
            assert f.read() == blob, rel
        assert not os.path.exists(os.path.join(src_dir, *rel.split("/")))
    # emptied bucket-1 store dirs are gone; bucket 0 data untouched
    assert not os.path.exists(os.path.join(src_dir, "owned_b001"))
    assert os.path.exists(os.path.join(src_dir, "owned_b000"))
    assert os.path.exists(os.path.join(src_dir, "csr_offv_000.npy"))


# ---------------------------------------------------------------------------
# stale-route fencing
# ---------------------------------------------------------------------------


def test_stale_routed_frames_refused(tmp_path):
    srv = ExchangeServer(str(tmp_path / "recv"))
    os.makedirs(str(tmp_path / "send"), exist_ok=True)
    np.save(str(tmp_path / "send" / "csr_offv_001.npy"), np.arange(4))
    try:
        srv.set_min_map_version(2)
        # versioned sender below the ratchet: DATA and MIGRATE both refused
        old = SocketTransport(str(tmp_path / "send"), IOLedger(),
                              peers=(srv.addr,), map_version=1)
        with pytest.raises(TransportError, match="stale shard-map route"):
            old.channel(0, "edges_b000").append_run(np.arange(2), np.arange(2))
        old.close()
        old2 = SocketTransport(str(tmp_path / "send"), IOLedger(),
                               peers=(srv.addr,), map_version=1)
        with pytest.raises(TransportError, match="stale shard-map route"):
            old2.send_file(srv.addr,
                           str(tmp_path / "send" / "csr_offv_001.npy"),
                           "csr_offv_001.npy")
        old2.close()
        # current-version sender passes; unversioned (legacy) sender passes
        cur = SocketTransport(str(tmp_path / "send"), IOLedger(),
                              peers=(srv.addr,), map_version=2)
        cur.channel(0, "edges_b000").append_run(np.arange(2), np.arange(2))
        cur.close()
        legacy = SocketTransport(str(tmp_path / "send"), IOLedger(),
                                 peers=(srv.addr,))
        legacy.channel(0, "edges_b000").append_run(np.arange(2), np.arange(2))
        legacy.close()
        # the ratchet is monotone: it never lowers
        srv.set_min_map_version(1)
        assert srv.min_map_version == 2
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# acceptance: rebalanced 2-host parity, elastic admission, kill-resume
# ---------------------------------------------------------------------------


def _rebalanced_cluster(tmp_path, name, backend=None, **kw):
    spec, gen = make_cluster(tmp_path, name, backend=backend, rebalance=True, **kw)
    # Deterministic skew baseline: the run's own accounting adds on top, but
    # this dominates, so the first barrier's plan is known in advance.
    gen.controller.bucket_loads.update(SKEW_LOADS)
    return spec, gen


@pytest.mark.slow
def test_rebalanced_run_bit_identical_and_serves_from_new_owner(
        tmp_path, single_host_ref):
    spec, gen = _rebalanced_cluster(tmp_path, "rb")
    try:
        manifest_path, _ = gen.run()
        ctl = gen.controller
        assert ctl.shard_map.version > 0, "rebalance never committed"
        moved = [b for b in range(CFG.nb)
                 if ctl.owner_of(b) != spec.owner_of(b)]
        assert moved, "skew profile should force at least one move"
        # parity: bit-identical CSR + corpus vs the single-host oracle
        walks = gen.walk_corpus(W, L, seed=WSEED)
        np.testing.assert_array_equal(np.asarray(walks),
                                      single_host_ref["walks"])
        assert host_shas(gen) == single_host_ref["shas"]
        # the manifest names the LIVE owner, whose workdir holds the files
        m = json.load(open(manifest_path))
        for entry in m["buckets"]:
            assert entry["host"] == ctl.owner_of(entry["bucket"])
            assert os.path.exists(os.path.join(entry["workdir"],
                                               entry["offv"]))
        # a moved bucket's walk shard lives ONLY on its new owner
        for b in moved:
            new_dir = spec.hosts[ctl.owner_of(b)].workdir
            old_dir = spec.hosts[spec.owner_of(b)].workdir
            assert os.path.exists(os.path.join(new_dir,
                                               shard_name("walks.npy", b)))
            assert not os.path.exists(os.path.join(old_dir,
                                                   shard_name("walks.npy", b)))
        # the migration actually ran as dispatched tasks
        assert any(e["key"].startswith("rebalance[") and e["ok"]
                   for e in ctl.task_log), [e["key"] for e in ctl.task_log][:8]
        np.testing.assert_array_equal(
            np.asarray(ShardedWalks(walks.manifest_path)),
            single_host_ref["walks"])
    finally:
        gen.close()


@pytest.mark.slow
def test_admitted_host_receives_shards_and_serves_phases(tmp_path,
                                                         single_host_ref):
    """Elastic admission: a third host joins after rendezvous, the next
    barrier's rebalance fills it (empty hosts attract moves), and it serves
    CSR + walk phases — output still bit-identical."""
    name = "adm"
    spec, gen = make_cluster(tmp_path, name, rebalance=True)
    try:
        ctl = gen.controller
        hid = ctl.admit_host(str(tmp_path / name / "host2"))
        assert hid == 2
        ctl.wait_for_hosts(timeout=60.0)
        # balanced-looking load on hosts 0/1 + an empty host 2: the greedy
        # planner's dst tie-break (highest id) fills the late joiner first
        ctl.bucket_loads.update({0: 1 << 26, 1: 1 << 25,
                                 2: 1 << 25, 3: 1 << 26})
        gen.run()
        assert ctl.spec.num_hosts == 3
        owners = {ctl.owner_of(b) for b in range(CFG.nb)}
        assert 2 in owners, "admitted host never received a shard"
        walks = gen.walk_corpus(W, L, seed=WSEED)
        np.testing.assert_array_equal(np.asarray(walks),
                                      single_host_ref["walks"])
        assert host_shas(gen) == single_host_ref["shas"]
        # host 2 did real work after admission
        assert any(e["host"] == 2 and e["ok"] for e in ctl.task_log)
        moved_to_2 = [b for b in range(CFG.nb) if ctl.owner_of(b) == 2]
        for b in moved_to_2:
            assert os.path.exists(os.path.join(
                str(tmp_path / name / "host2"), shard_name("walks.npy", b)))
    finally:
        gen.close()


@pytest.mark.slow
def test_rebalanced_run_survives_host_kill(tmp_path, single_host_ref):
    """Kill the migration-source host mid-run (restart budget 1): the
    controller revives it, the host's checkpointed micro-phases skip every
    file already acked, and the rebalanced output stays bit-identical."""
    # host 0 is the migration SOURCE under SKEW_LOADS; with this task
    # budget it dies inside the rebalance window
    spec, gen = _rebalanced_cluster(tmp_path, "kr",
                                    backend=KillHostFirst(host_id=0, max_tasks=6),
                                    max_restarts=1)
    try:
        gen.run()
        assert gen.controller.restarts[0] == 1, gen.controller.restarts
        assert gen.controller.shard_map.version > 0
        walks = gen.walk_corpus(W, L, seed=WSEED)
        np.testing.assert_array_equal(np.asarray(walks),
                                      single_host_ref["walks"])
        assert host_shas(gen) == single_host_ref["shas"]
    finally:
        gen.close()


@pytest.mark.slow
def test_committed_rebalance_restores_on_controller_relaunch(
        tmp_path, single_host_ref):
    """Controller relaunch AFTER a committed rebalance: the fresh controller
    seeds the contiguous map, but the checkpointed commit phase restores the
    moved ownership before any later phase routes — the resumed run replays
    from checkpoints and stays bit-identical."""
    spec, gen = _rebalanced_cluster(tmp_path, "cr")
    try:
        gen.run()
        committed = gen.controller.shard_map.to_json()
        assert committed["version"] > 0
    finally:
        gen.close()
    # relaunch WITHOUT the rebalance flag: restore must not depend on it
    gen2 = ClusterGenerator(
        CFG.with_(transport="socket"), spec, str(tmp_path / "cr" / "ctrl"),
        backend=LocalExecBackend(env=ENV), checkpoint=True, device="cpu")
    try:
        gen2.run()
        assert gen2.controller.shard_map.owners == committed["owners"]
        assert gen2.controller.shard_map.version >= committed["version"]
        walks = gen2.walk_corpus(W, L, seed=WSEED)
        np.testing.assert_array_equal(np.asarray(walks),
                                      single_host_ref["walks"])
        assert host_shas(gen2) == single_host_ref["shas"]
    finally:
        gen2.close()


# ---------------------------------------------------------------------------
# planner sanity (the hypothesis laws live in test_cluster_property.py)
# ---------------------------------------------------------------------------


def test_plan_rebalance_offloads_straggler_deterministically():
    smap = ShardMap.contiguous(4, 2)
    moves = plan_rebalance(smap, SKEW_LOADS)
    # hot bucket to the cold host, cold buckets backfill the other way —
    # and each bucket moves AT MOST once per plan (one barrier dispatch)
    assert moves == [(0, 0, 1), (2, 1, 0), (3, 1, 0)]
    assert len({b for b, _, _ in moves}) == len(moves)
    assert plan_rebalance(smap, SKEW_LOADS) == moves   # pure function
    from repro.core.shardmap import ShardMap as RefShardMap, plan_rebalance as ref_plan
    assert ref_plan(RefShardMap.contiguous(4, 2), SKEW_LOADS) == moves
    # the plan strictly shrinks the load spread
    owner = list(smap.owners)
    for b, _, d in moves:
        owner[b] = d
    def spread(ow):
        hl = [0, 0]
        for b, v in SKEW_LOADS.items():
            hl[ow[b]] += v
        return max(hl) - min(hl)
    assert spread(owner) < spread(smap.owners)
    # an admitted empty host attracts the move instead (dst tie-break)
    smap3 = ShardMap.contiguous(4, 2)
    smap3.admit_host()
    assert all(dst == 2 for _, _, dst in plan_rebalance(smap3, SKEW_LOADS))
    # no loads, no moves; single host, no moves
    assert plan_rebalance(smap, {}) == []
    assert plan_rebalance(ShardMap.contiguous(4, 1), SKEW_LOADS) == []
