"""The port's PartitionedGenerator (`repro_torch/core/phases.py`) on the CPU
against the reference's, file for file.

Worker counts {0, 2} (2: a spawned pool whose workers run the hooks' plain
versions), transports {fs, socket}, the pooled cascade, the fused recompute
generate+relabel, scatter CSR, and a resume after a kernel that failed.
The CSR bucket files must have the sha256 of the reference's in-process
fs run of the same graph, and the pv bucket stores the same contents; the
reference's own tests hold its runs equal across workers and transports.
"""

import numpy as np
import pytest

from repro.core.phases import PartitionedGenerator as RefPartitioned
from repro.core.types import GraphConfig as RefConfig
from repro_torch.core import phases
from repro_torch.core.phases import PartitionedGenerator
from repro_torch.core.types import GraphConfig

from torch_parity import npy_shas

BASE = dict(scale=9, nb=4, edge_factor=4, chunk_edges=256, merge_fanin=4)
_REF = {}


def _pv(part):
    return np.concatenate([np.concatenate([v for (v,) in b.iter_runs()])
                           for b in part.pv_buckets()])


def _reference(tmp_path_factory, kw, csr_variant="sorted"):
    """File sha256s (and pv, where stores exist) of the reference's
    in-process fs run, once per configuration."""
    key = (tuple(sorted(kw.items())), csr_variant)
    if key not in _REF:
        d = str(tmp_path_factory.mktemp("ref"))
        with RefPartitioned(RefConfig(**{**BASE, **kw}), d, max_workers=0) as part:
            part.run(csr_variant)
            pv = None if kw["shuffle_variant"] == "recompute" else _pv(part)
        _REF[key] = (npy_shas(d), pv)
    return _REF[key]


@pytest.mark.parametrize("transport", ["fs", "socket"])
@pytest.mark.parametrize("workers", [0, 2])
def test_partitioned_external_matches_reference(tmp_path, tmp_path_factory, workers,
                                                transport):
    kw = dict(shuffle_variant="external")
    want, want_pv = _reference(tmp_path_factory, kw)
    d = str(tmp_path / "port")
    with PartitionedGenerator(GraphConfig(**BASE, **kw, transport=transport), d,
                              max_workers=workers, exchange_servers=2,
                              device="cpu") as part:
        part.run()
        np.testing.assert_array_equal(_pv(part), want_pv)
        if transport == "socket":
            assert part.exchange_stats.frames_recv > 0
    assert len(want) == 2 * BASE["nb"]
    assert npy_shas(d) == want


@pytest.mark.parametrize("kw,workers", [
    (dict(shuffle_variant="external", pooled_cascade=True, merge_fanin=2), 2),
    (dict(shuffle_variant="external", perm_family="feistel"), 2),
    (dict(shuffle_variant="recompute"), 0),
    (dict(shuffle_variant="recompute"), 2),
    (dict(shuffle_variant="recompute", pooled_cascade=True, merge_fanin=2), 0),
], ids=["pooled-cascade", "external-feistel", "recompute-w0", "recompute-w2",
        "recompute-pooled"])
def test_partitioned_variants_match_reference(tmp_path, tmp_path_factory, kw, workers):
    want, _ = _reference(tmp_path_factory, kw)
    d = str(tmp_path / "port")
    with PartitionedGenerator(GraphConfig(**{**BASE, **kw}), d, max_workers=workers,
                              device="cpu") as part:
        part.run()
    assert npy_shas(d) == want


def test_partitioned_fused_gen_relabel_matches_reference(tmp_path, tmp_path_factory):
    """The fused recompute generate+relabel (_RegenRuns: the edges regenerated
    by rmat_chunk and never stored) writes the unfused reference's files."""
    kw = dict(shuffle_variant="recompute")
    want, _ = _reference(tmp_path_factory, kw)
    d = str(tmp_path / "port")
    with PartitionedGenerator(GraphConfig(**BASE, **kw), d, max_workers=0,
                              device="cpu") as part:
        part._fuse_gen_relabel = True
        part.run()
        phase_names = [r["phase"] for r in part.orchestrator.report()]
    assert "generate" not in phase_names
    assert npy_shas(d) == want


def test_partitioned_scatter_csr_matches_reference(tmp_path, tmp_path_factory):
    kw = dict(shuffle_variant="external")
    want, _ = _reference(tmp_path_factory, kw, "scatter")
    d = str(tmp_path / "port")
    with PartitionedGenerator(GraphConfig(**BASE, **kw), d, max_workers=2,
                              device="cpu") as part:
        part.run("scatter")
    assert npy_shas(d) == want


def test_partitioned_resume_after_a_failed_kernel(tmp_path, tmp_path_factory, monkeypatch):
    """A kernel that raises mid-phase fails the run; a rerun over the same
    checkpointed workdir resumes the completed phases and writes the
    reference's files."""
    kw = dict(shuffle_variant="external")
    want, _ = _reference(tmp_path_factory, kw)
    d = str(tmp_path / "port")
    cfg = GraphConfig(**BASE, **kw)
    orig = phases._KERNELS["redistribute"]

    def failing(pcfg, workdir, i, **k):
        if i == 2:
            raise RuntimeError("injected kernel failure")
        return orig(pcfg, workdir, i, **k)

    monkeypatch.setitem(phases._KERNELS, "redistribute", failing)
    with PartitionedGenerator(cfg, d, max_workers=0, checkpoint=True, device="cpu") as part:
        with pytest.raises(RuntimeError, match="injected"):
            part.run()
    monkeypatch.setitem(phases._KERNELS, "redistribute", orig)
    with PartitionedGenerator(cfg, d, max_workers=0, checkpoint=True, device="cpu") as part:
        part.run()
        status = {r["phase"]: r["status"] for r in part.orchestrator.report()}
    assert status["shuffle"] == status["generate"] == status["relabel"] == "resumed"
    assert status["redistribute"] == status["csr_sorted"] == "done"
    assert npy_shas(d) == want


def test_partitioned_takes_a_plain_config_and_its_device(tmp_path):
    pcfg = phases.plain_config(GraphConfig(**BASE, shuffle_variant="recompute"), "cpu")
    with PartitionedGenerator(pcfg, str(tmp_path), max_workers=0, device="cpu") as part:
        assert part.pcfg.device == "cpu"
        assert phases.result_config_key(part.pcfg) == phases.result_config_key(pcfg)
