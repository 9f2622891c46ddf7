"""The CUDA kernels against their plain PyTorch versions, on the card, and
the disk tier's per-chunk hooks against their CPU path.

Marked `gpu`: they skip where torch.cuda.is_available() is false.  This file
imports no jax, so it runs on a machine that has only the port's packages:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import ctypes

import pytest
import torch

from repro_torch.core.types import GraphConfig
from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import TOLERANCE, row_error


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("scale,start,count", [(25, 0, 1 << 20), (16, (1 << 32) - 1000, 100003)])
def test_rmat_kernel_matches_plain(cuda, scale, start, count):
    cfg = GraphConfig(scale=scale)
    got = ops.rmat_edges(cfg, start, count, device=cuda)
    want = ops.rmat_edges_plain(cfg, start, count, cuda)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("nbits", [1, 16, 25, 31])
def test_feistel_kernel_matches_plain(cuda, nbits):
    g = torch.Generator(device="cpu").manual_seed(nbits)
    x = torch.randint(0, 1 << nbits, (100003,), generator=g, dtype=torch.int64)
    x = x.to(torch.int32).to(cuda)
    assert torch.equal(ops.feistel_perm(x, 0xBEEF, nbits), ops.feistel_perm_plain(x, 0xBEEF, nbits))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 8, 32, 33, 64, 8192])
@pytest.mark.parametrize("n", [0, 1, 17, 1_000_003, 1 << 22])
def test_bucket_hist_kernel_matches_plain(cuda, k, n):
    """Register bins (k <= 32) and shared-memory histograms (k > 32), with
    the pad value k and negatives mixed in."""
    g = torch.Generator(device="cpu").manual_seed(k * 7 + n)
    dest = torch.randint(-1, k + 1, (n,), generator=g, dtype=torch.int32).to(cuda)
    before = ops.LAUNCHES["bucket_hist"]
    got = ops.bucket_hist(dest, k)
    assert ops.LAUNCHES["bucket_hist"] == before + 1
    assert torch.equal(got, ops.bucket_hist_plain(dest, k))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [2, 1_000_003])
def test_bucket_hist_kernel_misaligned_start(cuda, k, offset, n):
    """A slice whose data_ptr is not 16-byte aligned: the scalar head and
    tail count the ids around the 16-byte vectors."""
    g = torch.Generator(device="cpu").manual_seed(offset)
    dest = torch.randint(0, k + 1, (n + offset,), generator=g, dtype=torch.int32).to(cuda)
    part = dest[offset:]
    assert part.data_ptr() % 16
    assert torch.equal(ops.bucket_hist(part, k), ops.bucket_hist_plain(part, k))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 8192])
def test_bucket_hist_kernel_all_pad(cuda, k):
    dest = torch.full((1_000_003,), k, dtype=torch.int32, device=cuda)
    assert torch.equal(ops.bucket_hist(dest, k), torch.zeros(k, dtype=torch.int32, device=cuda))
    # the last block left its ticket at 0: the next call is right too
    dest[::3] = 0
    assert int(ops.bucket_hist(dest, k)[0]) == 333_335


@pytest.mark.gpu
@pytest.mark.parametrize("base", [0, 3 << 12])
def test_relabel_gather_kernel_matches_plain(cuda, base):
    g = torch.Generator(device="cpu").manual_seed(base)
    chunk = torch.randperm(1 << 12, generator=g).to(torch.int32).to(cuda)
    keys = torch.sort(torch.randint(-1, 5 << 12, (100003,), generator=g, dtype=torch.int32)).values
    keys = keys.to(cuda)
    assert torch.equal(ops.relabel_gather(keys, chunk, base),
                       ops.relabel_gather_plain(keys, chunk, base))
    assert ops.relabel_gather(keys[:0], chunk, base).numel() == 0


# flash_attention: (b) the decode wave at full width (bf16, per-slot offsets),
# (c) non-causal with ragged Sq / Skv (f32), (d) the smoke configs' D 16 (f32),
# the decode kernel's split-KV path (few blocks, long keys) with ragged
# chunks, decode waves with GQA groups 1, 4 and 5 whose slots sit at offset
# 0, on a 32-key tile edge, on a 128-key chunk edge, at the last key and at
# or past Skv (idle slots), and the prefill kernel (bf16, >= 16 queries,
# D >= 64) with Sq not a multiple of its 64-row tile, against a cache at
# offsets > 0, non-causal, and with GQA group 5; bf16 prefill with D 16
# takes the decode kernel.  Each output row is held to its error relative
# to its own largest value, at flash_attention.TOLERANCE: f32 1e-5 (the sum
# order differs); bf16 2^-6 (two bf16 ulps of the row's largest value).
FLASH_CASES = {
    "b_decode_wave": (8, 16, 8, 1, 4096, 128, "offsets", True, torch.bfloat16),
    "c_noncausal_ragged": (2, 16, 8, 1000, 1531, 128, None, False, torch.float32),
    "d_smoke_d16": (2, 4, 2, 37, 64, 16, [3, 27], True, torch.float32),
    "split_kv_ragged": (2, 4, 2, 3, 1000, 64, [500, 990], True, torch.float32),
    "split_kv_noncausal": (1, 2, 1, 1, 700, 32, None, False, torch.float32),
    "tensor_cores_ragged": (2, 10, 2, 37, 100, 64, [0, 50], True, torch.bfloat16),
    "tensor_cores_noncausal": (1, 4, 4, 100, 77, 32, None, False, torch.bfloat16),
    "decode_g1_edges": (8, 8, 8, 1, 2048, 128, [0, 31, 32, 127, 128, 2047, 2048, 5000], True,
                        torch.bfloat16),
    "decode_g4_edges": (4, 16, 4, 1, 3000, 64, [0, 479, 480, 2999], True, torch.bfloat16),
    "decode_g5_idle": (4, 40, 8, 1, 4096, 128, [0, 959, 4095, 4096], True, torch.bfloat16),
    "decode_g5_f32": (2, 10, 2, 3, 700, 128, [96, 699], True, torch.float32),
    "prefill_sq16": (1, 16, 8, 16, 16, 128, None, True, torch.bfloat16),
    "prefill_sq37": (1, 16, 8, 37, 37, 128, None, True, torch.bfloat16),
    "prefill_sq100": (2, 16, 8, 100, 100, 128, None, True, torch.bfloat16),
    "prefill_sq129": (1, 16, 8, 129, 129, 128, None, True, torch.bfloat16),
    "prefill_cache_offset": (2, 16, 8, 100, 4096, 128, [300, 1000], True, torch.bfloat16),
    "prefill_noncausal": (2, 16, 8, 129, 300, 128, None, False, torch.bfloat16),
    "prefill_bf16_d16": (2, 4, 2, 37, 64, 16, [3, 27], True, torch.bfloat16),
}


def _flash_inputs(name, cuda):
    B, Hq, Hkv, Sq, Skv, D, offset, causal, dtype = FLASH_CASES[name]
    g = torch.Generator(device="cpu").manual_seed(len(name))
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype)
               for shape in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    if offset == "offsets":
        offset = torch.randint(127, 4095, (B,), generator=g, dtype=torch.int32)
    if offset is not None:
        offset = torch.as_tensor(offset, dtype=torch.int32).to(cuda)
    return q, k, v, offset, causal


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda, name):
    q, k, v, offset, causal = _flash_inputs(name, cuda)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, offset=offset)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ops.flash_attention_plain(q, k, v, causal=causal, offset=offset)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and bool(torch.isfinite(got).all())
    assert row_error(got, want) <= TOLERANCE[q.dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["b_decode_wave", "decode_g5_idle", "prefill_cache_offset"])
@pytest.mark.parametrize("fault", ["scale", "drop_last_keys"])
def test_flash_attention_check_rejects_planted_faults(cuda, fault, name):
    """A decode wave or a prefill against the cache run with the softmax
    scale 5 % off, or with the last 32 keys of each row dropped, fails the
    check the kernel passes."""
    q, k, v, offset, causal = _flash_inputs(name, cuda)
    want = ops.flash_attention_plain(q, k, v, causal=causal, offset=offset)
    if fault == "scale":
        bad = ops.flash_attention(q, k, v, causal=causal, offset=offset,
                                  scale=1.05 / q.shape[-1] ** 0.5)
    else:
        bad = ops.flash_attention(q, k, v, causal=causal, offset=offset - 32)
    assert row_error(bad, want) > TOLERANCE[q.dtype]


@pytest.mark.gpu
def test_rebuilt_library_loads_every_kernel(cuda, tmp_path, monkeypatch):
    """Each source compiles into a fresh library of its own; together they
    export the four graph kernels and the flash attention."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    paths = build.build()
    assert [p.parent for p in paths] == [tmp_path] * len(build.SOURCES)
    libs = [ctypes.CDLL(str(p)) for p in paths]
    for name in build.KERNELS:
        assert any(hasattr(lib, f"{name}_launch") for lib in libs), name
    logs = "".join(p.with_suffix(".log").read_text() for p in paths)
    assert "flash_attention_decode_kernel" in logs and "flash_attention_prefill_kernel" in logs
    assert "rmat_edges_kernel" in logs
    assert build.build() == paths and not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------------------
# the disk tier's per-chunk hooks (core/chunks.py): card == plain path
# ---------------------------------------------------------------------------

CHUNK_SHAPES = [1 << 14, 1 << 21, 100_003, 0]


def _hook_cfg(scale=20):
    from repro_torch.core.phases import plain_config
    return plain_config(GraphConfig(scale=scale, nb=8), "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("count", CHUNK_SHAPES)
def test_rmat_chunk_on_the_card(cuda, count):
    import numpy as np

    from repro_torch.core import chunks
    pcfg = _hook_cfg()
    start = (1 << 32) - 5000
    before = ops.LAUNCHES["rmat_edges"]
    got = chunks.rmat_chunk(pcfg, start, count, cuda)
    assert ops.LAUNCHES["rmat_edges"] == before + (count > 0)
    want = chunks.rmat_chunk(pcfg, start, count, "cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and g.flags.c_contiguous
        assert g.tobytes() == w.tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("count", CHUNK_SHAPES)
@pytest.mark.parametrize("n", [1 << 20, 1_000_003])
def test_graph_perm_chunk_on_the_card(cuda, count, n):
    import numpy as np

    from repro_torch.core import chunks
    x = np.random.default_rng(count).integers(0, n, count, dtype=np.int64)
    before = ops.LAUNCHES["feistel_perm"]
    got = chunks.graph_perm_chunk(0x5EED, x, n, 4, cuda)
    assert ops.LAUNCHES["feistel_perm"] > before or count == 0
    assert got.tobytes() == chunks.graph_perm_chunk(0x5EED, x, n, 4, "cpu").tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("count", CHUNK_SHAPES)
def test_partition_chunk_on_the_card(cuda, count):
    import numpy as np

    from repro_torch.core import chunks
    rng = np.random.default_rng(count + 1)
    cols = (rng.integers(0, 1 << 20, count, dtype=np.int64),
            rng.integers(0, 1 << 20, count, dtype=np.int64))
    before = ops.LAUNCHES["bucket_hist"]
    got, counts = chunks.partition_chunk(cols, lambda a, b: a // (1 << 17), 8, cuda, "s")
    assert ops.LAUNCHES["bucket_hist"] == before + 1
    want, want_counts = chunks.partition_chunk(cols, lambda a, b: a // (1 << 17), 8, "cpu", "s")
    assert counts.tobytes() == want_counts.tobytes() and int(counts.sum()) == count
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [-1, 8, 1 << 40])
def test_partition_chunk_on_the_card_rejects_a_planted_bucket(cuda, bad):
    import numpy as np

    from repro_torch.core import chunks
    a = np.arange(1 << 14, dtype=np.int64)
    a[777] = bad * 2048
    with pytest.raises(ValueError, match=f"bucket {bad} outside"):
        chunks.partition_chunk((a, a), lambda s, d: s // 2048, 8, cuda, "planted")


@pytest.mark.gpu
@pytest.mark.parametrize("count", CHUNK_SHAPES)
def test_gather_chunk_on_the_card(cuda, count):
    import numpy as np

    from repro_torch.core import chunks
    rng = np.random.default_rng(count + 2)
    base, rows = 3 << 17, 1 << 17
    vals = rng.permutation(1 << 20)[:rows].astype(np.int64)
    keys = np.sort(rng.integers(base, base + rows, count, dtype=np.int64))
    before = ops.LAUNCHES["relabel_gather"]
    got = chunks.gather_chunk(keys, chunks.table_block(vals, cuda), base)
    assert ops.LAUNCHES["relabel_gather"] == before + (count > 0)
    want = chunks.gather_chunk(keys, chunks.table_block(vals, "cpu"), base)
    assert got.dtype == np.int64 and got.tobytes() == want.tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["external", "recompute"])
def test_partitioned_workers_on_the_card_write_the_cpu_files(cuda, tmp_path, variant):
    """Two spawned workers run the hooks on the card: their launches reach
    the parent's counts, and the files equal an in-process CPU run's."""
    import hashlib
    import os

    from repro_torch.core.phases import PartitionedGenerator

    def shas(d):
        return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
                for f in sorted(os.listdir(d)) if f.endswith(".npy")}

    cfg = GraphConfig(scale=12, nb=4, edge_factor=8, chunk_edges=4096,
                      shuffle_variant=variant)
    with PartitionedGenerator(cfg, str(tmp_path / "cpu"), max_workers=0, device="cpu") as p:
        p.run()
    build.reset_launches()
    with PartitionedGenerator(cfg, str(tmp_path / "card"), max_workers=2, device=cuda) as p:
        p.run()
    assert shas(str(tmp_path / "card")) == shas(str(tmp_path / "cpu"))
    kernels = ["rmat_edges", "bucket_hist"] + (
        ["feistel_perm"] if variant == "recompute" else ["relabel_gather"])
    assert all(ops.LAUNCHES[k] > 0 for k in kernels), dict(ops.LAUNCHES)


@pytest.mark.gpu
def test_external_walks_on_the_card_write_the_cpu_corpus(cuda, tmp_path):
    """external_walks and ExternalWalkLoader with device cuda: the corpus
    shards equal a CPU run's over the same CSR files, the loader's batches
    too, and the walk's frontier partitions launched bucket_hist."""
    import hashlib
    import os
    import shutil

    import numpy as np

    from repro_torch.core.external import StreamingGenerator
    from repro_torch.data import ExternalWalkLoader, LoaderConfig
    from repro_torch.data.walks import external_walks

    def shas(d):
        return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
                for f in sorted(os.listdir(d)) if f.endswith(".npy")}

    cfg = GraphConfig(scale=11, nb=4, edge_factor=8, chunk_edges=2048,
                      shuffle_variant="external", merge_fanin=4)
    cpu_dir, card_dir = str(tmp_path / "cpu"), str(tmp_path / "card")
    StreamingGenerator(cfg, cpu_dir, device="cpu").run()
    shutil.copytree(cpu_dir, card_dir)
    want = external_walks(cfg, cpu_dir, num_walkers=300, length=9, seed=3, device="cpu")
    build.reset_launches()
    got = external_walks(cfg, card_dir, num_walkers=300, length=9, seed=3, device=cuda)
    assert ops.LAUNCHES["bucket_hist"] > 0
    assert shas(card_dir) == shas(cpu_dir)
    np.testing.assert_array_equal(np.asarray(got.walks), np.asarray(want.walks))
    lc = LoaderConfig(batch_size=16, seq_len=9, seed=3)
    a = ExternalWalkLoader(cfg, cpu_dir, lc, num_walkers=300, device="cpu")
    b = ExternalWalkLoader(cfg, card_dir, lc, num_walkers=300, device=cuda)
    for step in (0, 19):
        x, y = a.batch(step), b.batch(step)
        assert all(y[k].device.type == "cuda" and torch.equal(y[k].cpu(), x[k]) for k in x)


# ---------------------------------------------------------------------------
# the cluster runtime: hosts that run their hooks on the card
# ---------------------------------------------------------------------------


def _cluster_files(cfg, root, device, backend, walks=False, **kw):
    """Run a 2-host ClusterGenerator of cfg on `device` under root (and a
    W 64 x L 3 corpus with `walks`); returns ({host file: sha256}, the
    generator's restarts)."""
    import hashlib
    import os

    from repro_torch.core.cluster import ClusterGenerator, ClusterSpec

    spec = ClusterSpec.local(2, os.path.join(root, "hosts"), nb=cfg.nb)
    gen = ClusterGenerator(cfg.with_(transport="socket"), spec, os.path.join(root, "ctrl"),
                           backend=backend, checkpoint=True, device=device, **kw)
    try:
        gen.run()
        if walks:
            gen.walk_corpus(64, 3)
        restarts = dict(gen.controller.restarts)
    finally:
        gen.close()
    out = {}
    for h in spec.hosts:
        for f in sorted(os.listdir(h.workdir)):
            if f.endswith(".npy"):
                out[f] = hashlib.sha256(open(os.path.join(h.workdir, f), "rb").read()).hexdigest()
    return out, restarts


def _local_backend(**kw):
    import os

    import repro_torch
    from repro_torch.core.cluster import LocalExecBackend

    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    return LocalExecBackend(env={"PYTHONPATH": src}, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("variant,workers", [("external", 0), ("recompute", 2)])
def test_two_host_cluster_on_the_card_writes_the_cpu_files(cuda, tmp_path, variant, workers):
    """Two host processes (each with its own CUDA context, and with 2 pool
    workers each for recompute) run the hooks on the card: the CSR files and
    corpus shards equal a 2-host CPU cluster's, and the hosts' launches of
    every kernel of the variant reach this process's counts."""
    cfg = GraphConfig(scale=12, nb=4, edge_factor=8, chunk_edges=4096, shuffle_variant=variant)
    want, _ = _cluster_files(cfg, str(tmp_path / "cpu"), "cpu", _local_backend(), walks=True)
    build.reset_launches()
    got, _ = _cluster_files(cfg, str(tmp_path / "card"), cuda, _local_backend(workers=workers),
                            walks=True)
    assert got == want and len(got) == 3 * cfg.nb
    kernels = ["rmat_edges", "bucket_hist"] + (
        ["feistel_perm"] if variant == "recompute" else ["relabel_gather"])
    assert all(ops.LAUNCHES[k] > 0 for k in kernels), dict(ops.LAUNCHES)


@pytest.mark.gpu
def test_killed_card_host_is_relaunched_and_writes_the_cpu_files(cuda, tmp_path):
    """A card host killed mid-phase (hard exit after 6 tasks) is relaunched by
    the controller; the run's files still equal a CPU cluster's."""
    from repro_torch.core.cluster import LocalExecBackend

    class KillHost1First(LocalExecBackend):
        def host_args(self, host, attempt):
            return ["--max-tasks", "6"] if host.host_id == 1 and attempt == 0 else []

    cfg = GraphConfig(scale=12, nb=4, edge_factor=8, chunk_edges=4096,
                      shuffle_variant="external")
    want, _ = _cluster_files(cfg, str(tmp_path / "cpu"), "cpu", _local_backend())
    backend = KillHost1First(env=_local_backend().env)
    got, restarts = _cluster_files(cfg, str(tmp_path / "card"), cuda, backend, max_restarts=1)
    assert restarts[1] == 1
    assert got == want


@pytest.mark.gpu
def test_cluster_entry_points_raise_where_cuda_is_unavailable(cuda, tmp_path, monkeypatch):
    """On a machine whose torch reports no CUDA, ClusterGenerator and
    JobScheduler with the default device raise before any host starts."""
    from repro_torch.core.cluster import ClusterGenerator, ClusterSpec
    from repro_torch.core.jobqueue import JobScheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ClusterSpec.local(2, str(tmp_path / "hosts"), nb=4)
    cfg = GraphConfig(scale=12, nb=4, shuffle_variant="external", transport="socket")
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterGenerator(cfg, spec, str(tmp_path / "ctrl"))
    with pytest.raises(RuntimeError, match="cuda"):
        JobScheduler(spec, str(tmp_path / "q"))
