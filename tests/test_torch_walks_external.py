"""The port's out-of-core walk corpus (`external_walks`,
`PartitionedGenerator.walk_corpus`, `ExternalWalkLoader`) on the CPU against
the reference's: the same corpus shard files (sha256) over the same CSR
bucket files, and the same loader batches.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.core.external import StreamingGenerator as RefStreaming
from repro.core.phases import PartitionedGenerator as RefPartitioned
from repro.core.types import GraphConfig as RefConfig
from repro.data import ExternalWalkLoader as RefExternalWalkLoader
from repro.data import LoaderConfig as RefLoaderConfig
from repro.data.walks import concat_bucket_csr as ref_concat
from repro.data.walks import external_walks as ref_external_walks
from repro_torch.core.external import StreamingGenerator
from repro_torch.core.phases import PartitionedGenerator
from repro_torch.core.types import GraphConfig
from repro_torch.data import ExternalWalkLoader, LoaderConfig
from repro_torch.data.walks import concat_bucket_csr, external_walks, host_walks, start_vertex

from torch_parity import npy_shas


def _graphs(tmp_path, kw):
    """The same graph generated by the reference and by the port (CSR files
    checked equal), in two workdirs; returns them and the port's CSR."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    RefStreaming(RefConfig(**kw), ref_dir).run()
    _, csr, _ = StreamingGenerator(GraphConfig(**kw), port_dir, device="cpu").run()
    assert npy_shas(port_dir) == npy_shas(ref_dir)
    return ref_dir, port_dir, csr


@pytest.mark.parametrize("scale,nb,edge_factor,seed,W,L,fanin", [
    (8, 1, 4, 0, 13, 6, 64),
    (9, 4, 4, 1, 64, 10, 64),
    (9, 4, 1, 2, 50, 12, 4),        # sink-heavy (teleports), cascading merges
    (10, 8, 2, 3, 33, 7, 4),        # walkers not divisible by nb
])
def test_external_walks_match_reference(tmp_path, scale, nb, edge_factor, seed, W, L, fanin):
    kw = dict(scale=scale, nb=nb, chunk_edges=256, edge_factor=edge_factor,
              shuffle_variant="external", merge_fanin=fanin)
    ref_dir, port_dir, csr = _graphs(tmp_path, kw)
    want = ref_external_walks(RefConfig(**kw), ref_dir, num_walkers=W, length=L, seed=seed)
    got = external_walks(GraphConfig(**kw), port_dir, num_walkers=W, length=L, seed=seed,
                         device="cpu")
    assert npy_shas(port_dir) == npy_shas(ref_dir)          # CSR, pv and every shard
    assert got.walks.dtype == np.int64
    np.testing.assert_array_equal(np.asarray(got.walks), np.asarray(want.walks))
    assert got.gauge.peak_rows == want.gauge.peak_rows
    offv, adjv = concat_bucket_csr(csr)
    ro, ra = ref_concat(csr)
    assert offv.tobytes() == ro.tobytes() and adjv.tobytes() == ra.tobytes()
    wid = np.arange(W, dtype=np.uint32)
    oracle = host_walks(offv, adjv, start_vertex(seed, wid, 1 << scale), L, seed,
                        n=1 << scale, walker_ids=wid)
    np.testing.assert_array_equal(np.asarray(got.walks), oracle)


@pytest.mark.parametrize("workers", [0, 2])
def test_walk_corpus_matches_reference(tmp_path, workers):
    """PartitionedGenerator.walk_corpus (the pool drives the walk kernels)
    writes the reference's shards and manifest."""
    kw = dict(scale=9, nb=4, chunk_edges=256, edge_factor=4, shuffle_variant="external",
              merge_fanin=4)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    with RefPartitioned(RefConfig(**kw), ref_dir, max_workers=0) as part:
        part.run()
        ref_manifest = part.walk_corpus(40, 8, seed=5).manifest_path
    with PartitionedGenerator(GraphConfig(**kw), port_dir, max_workers=workers,
                              device="cpu") as part:
        part.run()
        manifest = part.walk_corpus(40, 8, seed=5).manifest_path
    assert npy_shas(port_dir) == npy_shas(ref_dir)
    with open(manifest) as f, open(ref_manifest) as g:
        assert json.load(f) == json.load(g)


def test_external_walk_loader_matches_reference(tmp_path):
    kw = dict(scale=9, nb=4, chunk_edges=256, edge_factor=4, shuffle_variant="external")
    ref_dir, port_dir, _ = _graphs(tmp_path, kw)
    lc = dict(batch_size=6, seq_len=9, vocab=97, seed=4)
    ref = RefExternalWalkLoader(RefConfig(**kw), ref_dir, RefLoaderConfig(**lc),
                                num_walkers=20)
    port = ExternalWalkLoader(GraphConfig(**kw), port_dir, LoaderConfig(**lc),
                              num_walkers=20, device="cpu")
    for step in range(5):              # past 20 walkers the corpus wraps
        want, got = ref.batch(step), port.batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    manifest = os.path.join(port_dir, "walks_manifest.json")
    assert os.path.exists(manifest)
    again = ExternalWalkLoader(GraphConfig(**kw), port_dir, LoaderConfig(**lc),
                               corpus_manifest=manifest, device="cpu")
    np.testing.assert_array_equal(again.batch(3)["tokens"].numpy(),
                                  np.asarray(ref.batch(3)["tokens"]))
