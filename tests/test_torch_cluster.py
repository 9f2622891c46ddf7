"""The port's cluster runtime (`repro_torch/core/cluster.py`) on the CPU
against the reference: 2-host loopback parity (external and recompute), the
device rules and the hosts' launch counts, the partitioned scatter CSR and
pooled cascade, the spec and config-key invariants, and the `run` CLI (the
host-kill cases are in test_torch_cluster_faults.py).

Every port run uses `device="cpu"` (its hosts run the kernels' plain
versions) at the reference's test sizes.  The oracle is the reference's
in-process PartitionedGenerator fs run of the same graph
(torch_cluster_parity): the CSR bucket files and corpus shards the hosts
leave must have its sha256, and the pv bucket stores its contents.  The
reference's own tests hold its cluster runs equal to that oracle, so no
reference host is spawned here.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core.phases import PartitionedGenerator as RefPartitioned
from repro.core.types import GraphConfig as RefConfig
from repro_torch.core.blockstore import IOLedger, MemoryGauge
from repro_torch.core.cluster import (
    ClusterGenerator,
    ClusterSpec,
    HostSpec,
    LocalExecBackend,
    format_peer_addrs,
    parse_peer_addrs,
)
from repro_torch.core.corpus import ShardedWalks, shard_name
from repro_torch.core.phases import PartitionedGenerator, plain_config, result_config_key
from repro_torch.core.transport import TransportStats
from repro_torch.kernels import build

from torch_cluster_parity import (
    BASE, CFG, ENV, L, W, WSEED, cluster_pv, host_shas, make_cluster, reference,
)
from torch_parity import ROOT, npy_shas


# ---------------------------------------------------------------------------
# 2-host parity + shard placement
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_two_host_cluster_bit_identical_to_single_host(tmp_path, tmp_path_factory):
    want, corpora, want_pv = reference(tmp_path_factory)
    want_walks = corpora["walks.npy"]
    spec, gen = make_cluster(tmp_path, "cl")
    try:
        manifest_path, ledger = gen.run()
        walks = gen.walk_corpus(W, L, seed=WSEED)
        np.testing.assert_array_equal(np.asarray(walks), want_walks)
        assert host_shas(gen) == want                  # CSR files + corpus shards
        np.testing.assert_array_equal(cluster_pv(gen), want_pv)
        m = json.load(open(manifest_path))
        assert [b["host"] for b in m["buckets"]] == [0, 0, 1, 1]
        for b in m["buckets"]:
            assert os.path.exists(os.path.join(b["workdir"], b["offv"]))
        # every shard lives on its OWNER host's workdir and nowhere else; the
        # controller's workdir holds manifests and checkpoint state only
        for j in range(CFG.nb):
            owner_dir = spec.hosts[spec.owner_of(j)].workdir
            other_dir = spec.hosts[1 - spec.owner_of(j)].workdir
            assert os.path.exists(os.path.join(owner_dir, shard_name("walks.npy", j)))
            assert not os.path.exists(os.path.join(other_dir, shard_name("walks.npy", j)))
            assert not os.path.exists(os.path.join(gen.workdir, shard_name("walks.npy", j)))
        np.testing.assert_array_equal(np.asarray(ShardedWalks(walks.manifest_path)),
                                      want_walks)
        assert gen.exchange_stats.frames_recv > 0
        assert gen.pcfg.device == "cpu"
    finally:
        gen.close()


@pytest.mark.slow
def test_two_host_cluster_recompute_parity(tmp_path, tmp_path_factory):
    """shuffle_variant='recompute' across two hosts: the reference's CSR files
    and corpus, with ZERO shuffle phases in the schedule."""
    want, corpora, _ = reference(tmp_path_factory, {**BASE, "shuffle_variant": "recompute"})
    want_walks = corpora["walks.npy"]
    _, gen = make_cluster(tmp_path, "cl", cfg=CFG.with_(shuffle_variant="recompute"))
    try:
        gen.run()
        walks = gen.walk_corpus(W, L, seed=WSEED)
        np.testing.assert_array_equal(np.asarray(walks), want_walks)
        assert host_shas(gen) == want
        phases = [r["phase"] for r in gen.orchestrator.report()]
        assert not any(p.startswith("shuffle") for p in phases)
        assert "relabel_recompute_map" in phases
    finally:
        gen.close()


# ---------------------------------------------------------------------------
# device: the hosts run on the driver's device, and the launches come back
# ---------------------------------------------------------------------------


def test_host_launches_are_added_to_the_driver(tmp_path, monkeypatch):
    """Each report's `launched` (the kernel launches its task made on the
    host) is added to the driver's build.LAUNCHES, with the ledgers."""
    spec = ClusterSpec.local(2, str(tmp_path / "h"), nb=CFG.nb)

    class _Controller:
        def __init__(self):
            self.spec = spec

        def run_tasks(self, kernel, argss, pcfg, namespace, **kw):
            return [{"ok": True, "out": [i, 1], "ledger": {"bytes_read": 8}, "peak": 3,
                     "stats": {}, "launched": {"rmat_edges": 2, "bucket_hist": i}}
                    for i, _ in enumerate(argss)]

    gen = ClusterGenerator.__new__(ClusterGenerator)   # no hosts: a stub controller
    gen.pcfg = plain_config(CFG.with_(transport="socket"), "cpu")
    gen.controller, gen.barrier_timeout, gen._job, gen.lease_budget = (
        _Controller(), 1.0, "", 1)
    gen._namespace = "gen"
    gen.ledger, gen.gauge, gen.exchange_stats = IOLedger(), MemoryGauge(), TransportStats()
    monkeypatch.setattr(build, "LAUNCHES", {k: 0 for k in build.LAUNCHES})
    outs = gen._map("generate", [(i,) for i in range(CFG.nb)])
    assert outs == [(i, 1) for i in range(CFG.nb)]
    assert build.LAUNCHES["rmat_edges"] == 2 * CFG.nb
    assert build.LAUNCHES["bucket_hist"] == sum(range(CFG.nb))
    assert gen.ledger.bytes_read == 8 * CFG.nb and gen.gauge.peak_rows == 3


# ---------------------------------------------------------------------------
# pooled cascade + partitioned scatter
# ---------------------------------------------------------------------------


def test_partitioned_scatter_bit_identical_to_sorted(tmp_path, tmp_path_factory):
    """csr_variant='scatter' under the partitioned driver: the reference's
    sorted files, with the random-write ledger of the scatter."""
    want, corpora, _ = reference(tmp_path_factory)
    want_walks = corpora["walks.npy"]
    with PartitionedGenerator(CFG, str(tmp_path), max_workers=0, device="cpu") as part:
        _, ledger = part.run(csr_variant="scatter")
        assert ledger.rand_writes > 0
        walks = np.asarray(part.walk_corpus(W, L, seed=WSEED))
        np.testing.assert_array_equal(walks, want_walks)
    assert {k: v for k, v in npy_shas(str(tmp_path)).items() if k in want} == want


def test_partitioned_scatter_after_checkpointed_sorted_fails_with_guidance(tmp_path):
    d = str(tmp_path)
    with PartitionedGenerator(CFG, d, max_workers=0, checkpoint=True, device="cpu") as p:
        p.run("sorted")
    with PartitionedGenerator(CFG, d, max_workers=0, checkpoint=True, device="cpu") as p:
        with pytest.raises(ValueError, match="keep_phase_stores"):
            p.run("scatter")


def test_pooled_cascade_bit_identical_and_resumable(tmp_path, tmp_path_factory):
    """pooled_cascade at fan-in 2 forces several cascade LEVELS; the files
    are the reference's flat-merge ones and a completed checkpoint resumes
    every phase."""
    want, corpora, _ = reference(tmp_path_factory)
    want_walks = corpora["walks.npy"]
    pcfg = CFG.with_(pooled_cascade=True, merge_fanin=2)
    d = str(tmp_path)
    with PartitionedGenerator(pcfg, d, max_workers=0, checkpoint=True, device="cpu") as p:
        p.run("sorted")
        phases = [r["phase"] for r in p.orchestrator.report()]
        assert any(ph.startswith("csr_cascade_l") for ph in phases), phases
        walks = np.asarray(p.walk_corpus(W, L, seed=WSEED))
        np.testing.assert_array_equal(walks, want_walks)
    assert {k: v for k, v in npy_shas(d).items() if k in want} == want
    with PartitionedGenerator(pcfg, d, max_workers=0, checkpoint=True, device="cpu") as p:
        p.run("sorted")
        assert all(r["status"] == "resumed" for r in p.orchestrator.report())
    assert {k: v for k, v in npy_shas(d).items() if k in want} == want


# ---------------------------------------------------------------------------
# spec / config-shape invariants (tier-1 twins of the hypothesis suite)
# ---------------------------------------------------------------------------


def test_cluster_spec_round_trip_and_ownership(tmp_path):
    spec = ClusterSpec(nb=8, hosts=(HostSpec(0, "/a", "n1"), HostSpec(1, "/b", "n2"),
                                    HostSpec(2, "/c")))
    assert ClusterSpec.from_json(spec.to_json()) == spec
    p = spec.save(str(tmp_path / "spec.json"))
    assert ClusterSpec.load(p) == spec
    owned = [b for h in range(3) for b in spec.buckets_of(h)]
    assert owned == list(range(8))
    for b in range(8):
        assert b in spec.buckets_of(spec.owner_of(b))


def test_cluster_spec_validation():
    with pytest.raises(ValueError, match="host_ids"):
        ClusterSpec(nb=4, hosts=(HostSpec(0, "/a"), HostSpec(2, "/b")))
    with pytest.raises(ValueError, match="distinct"):
        ClusterSpec(nb=4, hosts=(HostSpec(0, "/a"), HostSpec(1, "/a")))
    with pytest.raises(ValueError, match="cover"):
        ClusterSpec(nb=1, hosts=(HostSpec(0, "/a"), HostSpec(1, "/b")))


def test_peer_addrs_parse_format_round_trip():
    addrs = ("127.0.0.1:1234", "node1:80", "[::1]:9")
    assert parse_peer_addrs(format_peer_addrs(addrs)) == addrs
    with pytest.raises(ValueError):
        parse_peer_addrs("no-port")
    with pytest.raises(ValueError):
        parse_peer_addrs("host:notaport")


def test_result_config_key_normalizes_cluster_fields():
    """Resume across cluster shapes and devices hits the same key: transport,
    rendezvous addresses and the device never affect the result bytes."""
    base = plain_config(CFG, "cpu")
    sock = plain_config(CFG.with_(transport="socket",
                                  peer_addrs=("h1:1", "h2:2", "h1:3", "h2:4")), "cpu")
    assert result_config_key(base) == result_config_key(sock)
    assert result_config_key(dataclasses.replace(base, device="cuda")) == result_config_key(base)
    pooled = plain_config(CFG.with_(pooled_cascade=True), "cpu")
    assert result_config_key(pooled) != result_config_key(base)


def test_cluster_wire_config_keeps_the_device():
    """The device rides the wire with the rest of the config, so every host
    runs its hooks where the driver chose."""
    from repro_torch.core.cluster import _pcfg_from_wire, _pcfg_to_wire

    pcfg = dataclasses.replace(plain_config(CFG.with_(transport="socket"), "cpu"),
                               peer_addrs=("a:1", "b:2", "c:3", "d:4"))
    for device in ("cpu", "cuda"):
        wire = json.loads(json.dumps(_pcfg_to_wire(dataclasses.replace(pcfg, device=device))))
        back = _pcfg_from_wire(wire)
        assert back.device == device
        assert back == dataclasses.replace(pcfg, device=device)


def test_local_backend_spawns_the_port_host(monkeypatch):
    """Every host the local backend starts runs the port's `host` command."""
    class _Popen:
        def __init__(self, cmd, env=None):
            self.cmd = cmd

    monkeypatch.setattr(subprocess, "Popen", _Popen)
    spec = ClusterSpec.local(2, "/w", nb=4)
    h = LocalExecBackend(env=ENV, workers=2).launch(spec, spec.hosts[1], "127.0.0.1:9")
    assert h.cmd[1:5] == ["-m", "repro_torch.launch.cluster", "host", "--controller"]
    assert h.cmd[h.cmd.index("--workers") + 1] == "2"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_cluster_cli_end_to_end(tmp_path, tmp_path_factory):
    """`python -m repro_torch.launch.cluster run --device cpu`: controller +
    2 hosts + corpus from the CLI, the reference's files; without --device
    it asks for CUDA and fails."""
    root = str(tmp_path / "cli")
    env = dict(os.environ, **ENV)

    def run(workdir, *extra):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.cluster", "run", "--hosts", "2",
             "--workdir", workdir, "--scale", "8", "--nb", "4", "--edge-factor", "2",
             "--chunk-edges", "256", "--walkers", "12", "--length", "4", *extra],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)

    out = run(root, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    walks = ShardedWalks(os.path.join(root, "ctrl", "walks_manifest.json"))
    assert np.asarray(walks).shape == (12, 5)
    assert os.path.exists(os.path.join(root, "ctrl", "graph_manifest.json"))
    d = str(tmp_path_factory.mktemp("ref_cli"))
    with RefPartitioned(RefConfig(scale=8, nb=4, edge_factor=2, chunk_edges=256,
                                  shuffle_variant="external"), d, max_workers=0) as part:
        part.run()
        want_walks = np.asarray(part.walk_corpus(12, 4)).copy()
    np.testing.assert_array_equal(np.asarray(walks), want_walks)
    got = {**npy_shas(os.path.join(root, "host0")), **npy_shas(os.path.join(root, "host1"))}
    assert got == npy_shas(d)
    bad = run(str(tmp_path / "nocuda"))
    assert bad.returncode != 0 and "torch.cuda.is_available() is False" in bad.stderr
