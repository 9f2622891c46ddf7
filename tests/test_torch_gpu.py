"""The CUDA kernels against their plain PyTorch versions, on the card.

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
