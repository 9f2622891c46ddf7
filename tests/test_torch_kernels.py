"""The port's kernels (`repro_torch.kernels`) against the reference's.

On the CPU each wrapper runs its kernel's plain PyTorch version; these tests
hold it bit for bit (tolerance zero: all values are integers) against the
reference's `kernels/ops.py` in "xla" mode (the jnp oracle) and in
"interpret" mode (the Pallas kernel run by the interpreter).  The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shuffle as ref_shuffle
from repro.core.types import GraphConfig as RefConfig, quadrant_thresholds as ref_thresholds
from repro.kernels import ops as ref_ops
from repro.kernels.rmat import TILE, feistel_perm_pallas
from repro_torch.core import shuffle
from repro_torch.core.hostgen import feistel_round_key, graph_perm_key, perm_domain_bits
from repro_torch.core.types import GraphConfig, quadrant_thresholds
from repro_torch.kernels import bucket, ops

MODES = ["xla", "interpret"]


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# configuration and key schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"scale": 12, "nb": 8, "seed": 7},
                                {"a": 0.7, "b": 0.1, "c": 0.1, "d": 0.1}])
def test_config_from_reference(kw):
    rcfg = RefConfig(**kw)
    cfg = GraphConfig.from_reference(rcfg)
    assert cfg.vertex_dtype == torch.int32
    assert quadrant_thresholds(cfg) == ref_thresholds(rcfg)
    for name in ("n", "m", "bucket_size", "edges_per_shard", "rounds"):
        assert getattr(cfg, name) == getattr(rcfg, name), name


def test_key_schedule_matches_reference():
    from repro.core import hostgen as ref_hostgen

    for key in (0, 1, 0xDEADBEEF, graph_perm_key(0x5EED1234)):
        for i in range(8):
            assert feistel_round_key(key, i) == int(ref_hostgen.feistel_round_key_np(key, i))
    for seed in (0, 3, 0x5EED1234):
        assert graph_perm_key(seed) == ref_hostgen.graph_perm_key(seed)
    for n in (1, 2, 3, 1 << 20, (1 << 20) + 1):
        assert perm_domain_bits(n) == ref_hostgen.perm_domain_bits(n)


# ---------------------------------------------------------------------------
# R-MAT edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scale", [4, 10, 16, 20])
@pytest.mark.parametrize("count", [64, 1000, 4096])
def test_rmat_plain_matches_reference(mode, scale, count):
    rcfg = RefConfig(scale=scale)
    want_s, want_d = ref_ops.rmat_edges(rcfg, 0, count, mode=mode)
    got_s, got_d = ops.rmat_edges(GraphConfig.from_reference(rcfg), 0, count, device="cpu")
    assert got_s.dtype == got_d.dtype == torch.int32
    _eq(got_s, want_s)
    _eq(got_d, want_d)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("start", [0, 1000, 123457, (1 << 32) - 300])
def test_rmat_plain_start_offset(mode, start):
    """Edges are a pure function of the global index, which wraps mod 2**32."""
    rcfg = RefConfig(scale=12)
    want_s, want_d = ref_ops.rmat_edges(rcfg, start, 512, mode=mode)
    got_s, got_d = ops.rmat_edges(GraphConfig.from_reference(rcfg), start, 512, device="cpu")
    _eq(got_s, want_s)
    _eq(got_d, want_d)


# ---------------------------------------------------------------------------
# keyed Feistel permutation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", range(1, 32))
def test_feistel_perm_matches_reference(nbits):
    rng = np.random.default_rng(nbits)
    x = rng.integers(0, 1 << nbits, 777, dtype=np.int64)
    key = graph_perm_key(0x5EED1234 + nbits)
    want = ref_shuffle.feistel_perm(jnp.asarray(x, jnp.uint32), key, nbits)
    got = shuffle.feistel_perm(torch.from_numpy(x), key, nbits)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want, np.int64))


@pytest.mark.parametrize("nbits", [1, 10, 16, 25, 31])
def test_feistel_plain_matches_pallas_interpret(nbits):
    rng = np.random.default_rng(100 + nbits)
    x = rng.integers(0, 1 << nbits, TILE, dtype=np.int32)
    key = 0xC0FFEE ^ nbits
    want = feistel_perm_pallas(jnp.asarray(x), key, nbits)
    _eq(ops.feistel_perm(torch.from_numpy(x), key, nbits), want)


@pytest.mark.parametrize("nbits", range(1, 32))
def test_feistel_perm_matches_pallas_every_width_and_rounds(nbits):
    """Every nbits (1: the empty low half) and every rounds value the kernel
    takes, at an n that is no multiple of 4 (the kernel's ragged tail)."""
    n = TILE + 3                      # the Pallas kernel takes whole tiles: pad, then cut
    rng = np.random.default_rng(500 + nbits)
    x = rng.integers(0, 1 << nbits, n, dtype=np.int64).astype(np.int32)
    padded = jnp.asarray(np.concatenate([x, np.zeros(2 * TILE - n, np.int32)]))
    for rounds in (2, 4, 6, 8):
        key = 0xFACADE ^ (nbits << 8) ^ rounds
        want = np.asarray(feistel_perm_pallas(padded, key, nbits, rounds=rounds))[:n]
        _eq(ops.feistel_perm(torch.from_numpy(x), key, nbits, rounds), want)


@pytest.mark.parametrize("n", [5, 1000, 4096])
def test_keyed_perm_cycle_walk_matches_reference(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, n, 300, dtype=np.int64)
    want = ref_shuffle.keyed_perm(jnp.asarray(x, jnp.uint32), 12345, n)
    got = shuffle.keyed_perm(torch.from_numpy(x).to(torch.int32), 12345, n)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want, np.int64))


# ---------------------------------------------------------------------------
# bucket histogram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [2, 8, 64])
@pytest.mark.parametrize("n", [16, 1000, 8192])
def test_bucket_hist_plain_matches_reference(mode, k, n):
    rng = np.random.default_rng(k * 1000 + n)
    dest = rng.integers(0, k, n).astype(np.int32)
    want = ref_ops.bucket_hist(jnp.asarray(dest), k, mode=mode)
    got = ops.bucket_hist(torch.from_numpy(dest), k)
    assert got.dtype == torch.int32
    _eq(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_bucket_hist_ignores_pad_value(mode):
    """The pad value k (the reference wrapper's own pad) is never counted."""
    rng = np.random.default_rng(5)
    dest = np.concatenate([rng.integers(0, 8, 1500), np.full(77, 8)]).astype(np.int32)
    want = ref_ops.bucket_hist(jnp.asarray(dest), 8, mode=mode)
    _eq(ops.bucket_hist(torch.from_numpy(dest), 8), want)
    np.testing.assert_array_equal(np.asarray(want), np.bincount(dest[dest < 8], minlength=8))


@pytest.mark.parametrize("k,bins", [(1, 4), (4, 4), (5, 8), (8, 8), (9, 16), (32, 32), (33, 0),
                                    (8192, 0)])
def test_bucket_hist_plan_bins(k, bins):
    """Register bins: the least of 4, 8, 16, 32 that holds k; above 32 the
    shared-memory histograms (bins 0)."""
    assert bucket.plan(1 << 20, k, 132).bins == bins


@pytest.mark.parametrize("n,k,sms,grid", [
    (1 << 27, 8, 132, 132 * bucket.BLOCKS_PER_SM),   # the main shape: as many as fit at once
    (1 << 22, 8, 132, 132 * bucket.BLOCKS_PER_SM),   # the walk shape: 1024 tiles > 528
    (4097, 8, 132, 2),                               # no more blocks than tiles
    (0, 8, 132, 1),
    (1 << 22, 64, 132, 132 * bucket.BLOCKS_PER_SM),
    (1 << 22, 8192, 132, bucket.PARTIAL_ROWS_IDS // 8192),   # the last block's sum stays short
])
def test_bucket_hist_plan_grid(n, k, sms, grid):
    p = bucket.plan(n, k, sms)
    assert p.grid == grid
    assert p.grid * k <= max(bucket.PARTIAL_ROWS_IDS, k)
    assert p.grid <= max(1, -(-n // bucket.TILE_IDS))


@pytest.mark.parametrize("k,copies", [(8, 1), (64, 8), (1024, 8), (1025, 1), (8192, 1)])
def test_bucket_hist_plan_shared_copies(k, copies):
    """One shared histogram per warp where all fit in SMEM_BYTES, else one
    per block."""
    p = bucket.plan(1 << 22, k, 132)
    assert p.copies == copies
    assert 4 * k * p.copies <= bucket.SMEM_BYTES


def test_bucket_hist_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        ops.bucket_hist(torch.zeros(4, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        ops.bucket_hist(torch.zeros(4, dtype=torch.int32), bucket.MAX_K + 1)


# ---------------------------------------------------------------------------
# relabel gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("chunk", [128, 1024])
@pytest.mark.parametrize("n_keys", [64, 500, 2048])
def test_relabel_gather_plain_matches_reference(mode, chunk, n_keys):
    rng = np.random.default_rng(chunk + n_keys)
    pv = rng.permutation(chunk).astype(np.int32)
    keys = np.sort(rng.integers(0, chunk, n_keys)).astype(np.int32)
    want = ref_ops.relabel_gather(jnp.asarray(keys), jnp.asarray(pv), 0, mode=mode)
    got = ops.relabel_gather(torch.from_numpy(keys), torch.from_numpy(pv), 0)
    _eq(got, want)
    np.testing.assert_array_equal(got.numpy(), pv[keys])


@pytest.mark.parametrize("mode", MODES)
def test_relabel_gather_base_offset_and_pass_through(mode):
    """base > 0; keys below, inside and above the chunk, and -1 pads."""
    rng = np.random.default_rng(7)
    chunk, base = 256, 1024
    pv = rng.permutation(chunk).astype(np.int32)
    keys = np.sort(np.concatenate([rng.integers(0, 3 * base, 600), [-1, -1]])).astype(np.int32)
    want = ref_ops.relabel_gather(jnp.asarray(keys), jnp.asarray(pv), base, mode=mode)
    _eq(ops.relabel_gather(torch.from_numpy(keys), torch.from_numpy(pv), base), want)


# ---------------------------------------------------------------------------
# wrappers: CPU runs the plain version and counts no launch
# ---------------------------------------------------------------------------


def test_cpu_wrappers_count_no_launch():
    ops.reset_launches()
    ops.rmat_edges(GraphConfig(scale=8), 0, 100, device="cpu")
    ops.feistel_perm(torch.arange(64, dtype=torch.int32), 3, 6)
    ops.bucket_hist(torch.zeros(10, dtype=torch.int32), 4)
    ops.relabel_gather(torch.zeros(10, dtype=torch.int32), torch.ones(4, dtype=torch.int32), 0)
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
