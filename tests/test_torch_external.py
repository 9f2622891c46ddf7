"""The port's StreamingGenerator (`repro_torch/core/external.py`) on the CPU
against the reference's, file for file.

Every variant of the disk tier — shuffle variant {device, external,
recompute}, CSR {sorted, scatter}, permutation family {shuffle, feistel},
nb {1, 4, 8} — at scale 9-10 with small chunks (256-512 edges) and merge
fan-in 4, so that stores hold many runs and every merge cascades.  The CSR
bucket files and pv.npy must have the reference's sha256, and the
orchestrator's per-phase ledger rows (timing keys dropped) and the peak
resident rows must be the reference's too.
"""

import numpy as np
import pytest
import torch

from repro.core.external import StreamingGenerator as RefStreaming
from repro.core.types import GraphConfig as RefConfig
from repro_torch.core.external import StreamingGenerator
from repro_torch.core.types import GraphConfig

from torch_parity import npy_shas, report_rows

BASE = dict(scale=9, edge_factor=4, chunk_edges=256, merge_fanin=4)

CASES = {
    "device-nb1-sorted": dict(shuffle_variant="device", nb=1),
    "device-nb1-scatter": dict(shuffle_variant="device", nb=1, csr_variant="scatter"),
    "external-nb1": dict(shuffle_variant="external", nb=1),
    "external-nb4": dict(shuffle_variant="external", nb=4),
    "external-nb8-scale10": dict(shuffle_variant="external", nb=8, scale=10, chunk_edges=512),
    "external-nb4-scatter": dict(shuffle_variant="external", nb=4, csr_variant="scatter"),
    "external-nb8-scatter": dict(shuffle_variant="external", nb=8, csr_variant="scatter"),
    "external-feistel-nb4": dict(shuffle_variant="external", perm_family="feistel", nb=4),
    "external-feistel-nb8": dict(shuffle_variant="external", perm_family="feistel", nb=8),
    "recompute-nb1": dict(shuffle_variant="recompute", nb=1),
    "recompute-nb4": dict(shuffle_variant="recompute", nb=4),
    "recompute-nb8-scale10": dict(shuffle_variant="recompute", nb=8, scale=10,
                                  chunk_edges=512),
}


def _run(kw, ref_dir, port_dir, checkpoint=None):
    """(generator, its run()'s CSR) of the reference and of the port."""
    kw = {**BASE, **kw}
    ref = RefStreaming(RefConfig(**kw), ref_dir, checkpoint=checkpoint)
    _, ref_csr, _ = ref.run()
    port = StreamingGenerator(GraphConfig(**kw), port_dir, checkpoint=checkpoint,
                              device="cpu")
    _, port_csr, _ = port.run()
    return (ref, ref_csr), (port, port_csr)


@pytest.mark.parametrize("case", list(CASES))
def test_streaming_generator_matches_reference(tmp_path, case):
    (ref, ref_csr), (port, port_csr) = _run(CASES[case], str(tmp_path / "ref"),
                                            str(tmp_path / "port"))
    want = npy_shas(str(tmp_path / "ref"))
    kw = {**BASE, **CASES[case]}
    # sorted: offv + adjv per bucket; scatter keeps offv in memory only
    per_bucket = 1 if kw.get("csr_variant") == "scatter" else 2
    assert "pv.npy" in want and len(want) == 1 + per_bucket * kw["nb"]
    assert npy_shas(str(tmp_path / "port")) == want
    for (ro, ra), (po, pa) in zip(ref_csr, port_csr, strict=True):
        assert np.asarray(po).tobytes() == np.asarray(ro).tobytes()
        assert np.asarray(pa).tobytes() == np.asarray(ra).tobytes()
    assert report_rows(port.orchestrator) == report_rows(ref.orchestrator)
    assert port.gauge.peak_rows == ref.gauge.peak_rows


def test_streaming_checkpoint_resume_on_reused_workdir(tmp_path):
    """A second run over the same workdir resumes every phase and leaves the
    reference's files; a run with another config starts over."""
    kw = dict(shuffle_variant="external", nb=4)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    _run(kw, ref_dir, port_dir, checkpoint=True)
    want = npy_shas(ref_dir)
    again = StreamingGenerator(GraphConfig(**BASE, **kw), port_dir, checkpoint=True,
                               device="cpu")
    again.run()
    assert {r["status"] for r in again.orchestrator.report()} == {"resumed"}
    assert npy_shas(port_dir) == want
    other = StreamingGenerator(GraphConfig(**BASE, **kw, seed=99), port_dir, checkpoint=True,
                               device="cpu")
    other.run()
    assert {r["status"] for r in other.orchestrator.report()} == {"done"}
    assert npy_shas(port_dir) != want


def test_streaming_refusals_match_reference(tmp_path):
    """recompute + scatter CSR and a socket transport are refused alike."""
    msgs = []
    for label, gen, cfg, kw in (("ref", RefStreaming, RefConfig, {}),
                                ("port", StreamingGenerator, GraphConfig, {"device": "cpu"})):
        got = []
        g = gen(cfg(**BASE, nb=4, shuffle_variant="recompute", csr_variant="scatter"),
                str(tmp_path / label), **kw)
        with pytest.raises(ValueError) as e:
            g.run()
        got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            gen(cfg(**BASE, nb=4, shuffle_variant="external", transport="socket"),
                str(tmp_path / label), **kw)
        got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def test_streaming_generator_asks_for_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        StreamingGenerator(GraphConfig(**BASE, nb=4, shuffle_variant="external"),
                           str(tmp_path))


def test_from_reference_carries_the_disk_tier_fields():
    ref = RefConfig(scale=10, nb=8, chunk_edges=512, shuffle_variant="recompute",
                    merge_fanin=4, io_overlap=False, pooled_cascade=True,
                    transport="socket", peer_addrs=("a:1",) * 8, keep_phase_stores=True)
    port = GraphConfig.from_reference(ref)
    for f in ("chunk_edges", "shuffle_variant", "perm_family", "merge_fanin", "io_overlap",
              "pooled_cascade", "transport", "peer_addrs", "keep_phase_stores",
              "checkpoint_phases", "trace", "merge_block_rows"):
        assert getattr(port, f) == getattr(ref, f), f
    assert np.dtype(np.int32) == np.dtype(str(port.vertex_dtype).split(".")[-1])


def test_trace_lint_and_metadata():
    """Every registered kernel carries the span wrapper (the reference's CI
    lint, over the port's _KERNELS)."""
    from repro_torch.core import trace

    assert trace.lint_kernel_coverage() == []
