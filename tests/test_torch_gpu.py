"""The CUDA kernels against their plain PyTorch versions, on the card, the
disk tier's per-chunk hooks against their CPU path, and the train path's
steps and checkpoints on the card against the CPU.

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


# sizes around the 16-byte vectors and the 4096-id tiles of the two maps
MAP_SIZES = [1, 3, 4, 5, 1023, 1025, (1 << 20) + 3]


@pytest.mark.gpu
@pytest.mark.parametrize("rounds", [2, 4, 6, 8])
@pytest.mark.parametrize("nbits", [1, 2, 31])
@pytest.mark.parametrize("n", MAP_SIZES)
def test_feistel_kernel_sizes_widths_rounds(cuda, n, nbits, rounds):
    g = torch.Generator(device="cpu").manual_seed(n * 64 + nbits * 8 + rounds)
    x = torch.randint(0, 1 << nbits, (n,), generator=g, dtype=torch.int64).to(torch.int32).to(cuda)
    assert torch.equal(ops.feistel_perm(x, 0x5EED, nbits, rounds),
                       ops.feistel_perm_plain(x, 0x5EED, nbits, rounds))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [5, 1025, (1 << 20) + 3])
def test_feistel_kernel_misaligned_input(cuda, offset, n):
    """An input 1-3 ids off a 16-byte boundary and a fresh (aligned) output:
    no vector fits both, so the kernel's scalar instance runs."""
    g = torch.Generator(device="cpu").manual_seed(offset * 7 + n)
    buf = torch.randint(0, 1 << 26, (n + offset,), generator=g, dtype=torch.int32).to(cuda)
    x = buf[offset:]
    assert x.data_ptr() % 16
    assert torch.equal(ops.feistel_perm(x, 0xF00D, 26), ops.feistel_perm_plain(x, 0xF00D, 26))


@pytest.mark.gpu
@pytest.mark.parametrize("key_off,out_off", [(0, 0), (1, 1), (2, 2), (3, 3), (1, 2), (0, 3), (2, 0)])
@pytest.mark.parametrize("n", MAP_SIZES)
def test_relabel_gather_kernel_into_views(cuda, n, key_off, out_off):
    """Keys and outputs 0-3 ids off a 16-byte boundary, aligned alike (the
    vector path with its scalar head and tail) and differently (the scalar
    instance); nothing outside the output view is written."""
    g = torch.Generator(device="cpu").manual_seed(n + 10 * key_off + out_off)
    chunk = torch.randperm(1 << 12, generator=g).to(torch.int32).to(cuda)
    kbuf = torch.sort(torch.randint(-3, 3 << 12, (n + 4,), generator=g, dtype=torch.int32)).values
    keys = kbuf.to(cuda)[key_off:key_off + n]
    obuf = torch.full((n + 4,), 77, dtype=torch.int32, device=cuda)
    out = obuf[out_off:out_off + n]
    before = ops.LAUNCHES["relabel_gather"]
    got = ops.relabel_gather(keys, chunk, 1 << 12, out=out)
    assert ops.LAUNCHES["relabel_gather"] == before + 1
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, ops.relabel_gather_plain(keys, chunk, 1 << 12))
    assert bool((obuf[:out_off] == 77).all()) and bool((obuf[out_off + n:] == 77).all())


@pytest.mark.gpu
@pytest.mark.parametrize("rows,row_len", [(8, 4096), (8, 1001), (3, (1 << 18) + 4), (50, 64)])
def test_relabel_gather_kernel_rows_and_in_place(cuda, rows, row_len):
    """[rows, N] sorted keys (rows walked side by side where N % 4 == 0 and
    rows <= 42, else as one flat row), into a new tensor and in place."""
    g = torch.Generator(device="cpu").manual_seed(rows * row_len)
    n = 1 << 16
    pv = torch.randperm(n, generator=g).to(torch.int32).to(cuda)
    keys = torch.sort(torch.randint(-2, n + 2, (rows, row_len), generator=g,
                                    dtype=torch.int32), dim=1).values.to(cuda)
    want = ops.relabel_gather_plain(keys, pv, 0)
    assert torch.equal(ops.relabel_gather(keys, pv, 0), want)
    assert ops.relabel_gather(keys, pv, 0, out=keys).data_ptr() == keys.data_ptr()
    assert torch.equal(keys, want)
    with pytest.raises(ValueError, match="overlaps"):
        ops.relabel_gather(keys.reshape(-1)[1:], pv, 0, out=keys.reshape(-1)[:-1])


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [1, 2, 8])
def test_relabel_ring_launches_once_per_field(cuda, nb):
    from repro_torch.core.relabel import relabel_ring

    cfg = GraphConfig(scale=14, nb=nb)
    g = torch.Generator(device="cpu").manual_seed(nb)
    src = torch.randint(0, cfg.n, (cfg.m,), generator=g, dtype=torch.int32)
    dst = torch.randint(0, cfg.n, (cfg.m,), generator=g, dtype=torch.int32)
    pv = torch.randperm(cfg.n, generator=g).to(torch.int32)
    before = ops.LAUNCHES["relabel_gather"]
    got = relabel_ring(cfg, src.to(cuda), dst.to(cuda), pv.to(cuda))
    assert ops.LAUNCHES["relabel_gather"] == before + 2
    want = relabel_ring(cfg, src, dst, pv)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


# flash_attention: (b) the decode wave at full width (bf16, per-slot offsets),
# (c) non-causal with ragged Sq / Skv (f32), (d) the smoke configs' D 16 (f32),
# the decode kernel's split-KV path (few blocks, long keys) with ragged
# chunks, decode waves with GQA groups 1, 4 and 5 whose slots sit at offset
# 0, on a 32-key tile edge, on a 128-key chunk edge, at the last key and at
# or past Skv (idle slots), and the prefill kernel (bf16, >= 16 queries,
# D >= 64) with Sq not a multiple of its 64-row tile, against a cache at
# offsets > 0, non-causal, and with GQA group 5; bf16 prefill with D 16
# takes the decode kernel; MLA's widths (q, k 192, v 128; D given as (D, Dv)):
# the prefill kernel at an admission's shape and ragged, the decode wave,
# f32 with 16 queries (two tiles of 8 rows); zamba2's 80-wide heads (10 or 20
# vectors a q/k row, 16 tail columns in P V; the prefill kernel padded to 128):
# its decode wave and prefill, ragged and non-causal, f32 with the key loop
# split, GQA 4 at tile edges, 16 rows a block in f32.  Each output row is held to its error relative
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
    "mla_prefill": (1, 16, 16, 2048, 4096, (192, 128), [2048], True, torch.bfloat16),
    "mla_prefill_ragged": (2, 16, 16, 100, 300, (192, 128), [0, 200], True, torch.bfloat16),
    "mla_decode_wave": (8, 16, 16, 1, 4096, (192, 128), "offsets", True, torch.bfloat16),
    "mla_f32_sq16": (2, 16, 16, 16, 700, (192, 128), [96, 684], True, torch.float32),
    "d80_decode_wave": (8, 32, 32, 1, 4096, 80, "offsets", True, torch.bfloat16),
    "d80_prefill": (1, 32, 32, 2048, 4096, 80, [0], True, torch.bfloat16),
    "d80_prefill_ragged_g2": (2, 8, 4, 100, 300, 80, [0, 200], True, torch.bfloat16),
    "d80_prefill_noncausal": (1, 4, 4, 100, 77, 80, None, False, torch.bfloat16),
    "d80_f32_noncausal_ragged": (2, 8, 8, 37, 131, 80, None, False, torch.float32),
    "d80_f32_split_kv": (2, 32, 32, 1, 3000, 80, [5, 2999], True, torch.float32),
    "d80_decode_g4_edges": (4, 16, 4, 1, 1000, 80, [0, 31, 32, 999], True, torch.bfloat16),
    "d80_f32_16_rows": (1, 16, 1, 3, 700, 80, [96], True, torch.float32),
}


def _flash_inputs(name, cuda):
    B, Hq, Hkv, Sq, Skv, D, offset, causal, dtype = FLASH_CASES[name]
    D, Dv = D if isinstance(D, tuple) else (D, D)
    g = torch.Generator(device="cpu").manual_seed(len(name))
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype)
               for shape in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, Dv)))
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
@pytest.mark.parametrize("name", ["b_decode_wave", "decode_g5_idle", "prefill_cache_offset",
                                  "mla_decode_wave", "mla_prefill", "d80_decode_wave",
                                  "d80_prefill"])
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
@pytest.mark.parametrize("name", ["d80_decode_wave", "d80_prefill", "d80_f32_split_kv"])
@pytest.mark.parametrize("fault", ["qk_first_64", "out_first_64"])
def test_flash_attention_d80_check_rejects_a_64_column_kernel(cuda, fault, name):
    """A kernel that kept 64-column atoms at width 80 would drop q.k columns
    64-79 (the prefill's one 64-column box) or output columns 64-79 (the
    decode kernel's 2 columns a lane): either fails the check."""
    q, k, v, offset, causal = _flash_inputs(name, cuda)
    want = ops.flash_attention_plain(q, k, v, causal=causal, offset=offset)
    if fault == "qk_first_64":
        q64 = q.clone()
        q64[..., 64:] = 0
        bad = ops.flash_attention(q64, k, v, causal=causal, offset=offset)
    else:
        head = ops.flash_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                                   v[..., :64].contiguous(), causal=causal, offset=offset,
                                   scale=80 ** -0.5)
        bad = torch.cat([head, torch.zeros_like(want[..., 64:])], dim=-1)
    assert row_error(bad, want) > TOLERANCE[q.dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("D,Dv", [(24, 16), (192, 192), (128, 64), (96, 96), (80, 64)])
def test_flash_attention_kernel_rejects_other_widths(cuda, D, Dv):
    """The MLA smoke's (24, 16) and other pairs the kernels were not built
    for raise on the card; nothing gives way to the plain version."""
    q = torch.zeros(1, 4, 16, D, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 32, D, device=cuda, dtype=torch.bfloat16)
    v = torch.zeros(1, 4, 32, Dv, device=cuda, dtype=torch.bfloat16)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, k, v)
    assert ops.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("over", [{}, {"num_experts": 64, "experts_per_tok": 6}])
def test_moe_ffn_on_the_card_makes_no_host_sync(cuda, monkeypatch, over):
    """The deepseek-v2 smoke's MoE layer on the card, with its own experts
    and with serve_moe's 64 (top 6): one bucket_hist launch, no host sync
    (CUDA sync debug mode "error"), no torch.bincount, and the CPU's y and
    aux."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_all, moe

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(cuda) for k, v in tree.items()}

    def refuse(*args, **kw):
        raise AssertionError("torch.bincount called")

    cfg = get_smoke_config("deepseek-v2-lite-16b").with_(**over)
    p = init_all(cfg, seed=0, device="cpu")["blocks"][cfg.first_k_dense]["ffn"]
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(0))
    want_y, want_aux = moe.moe_ffn(p, cfg, x)
    p, x = to(p), x.to(cuda)
    moe.moe_ffn(p, cfg, x)                      # builds and loads the kernels
    torch.cuda.synchronize()
    monkeypatch.setattr(torch, "bincount", refuse)
    before = ops.LAUNCHES["bucket_hist"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_ffn(p, cfg, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.LAUNCHES["bucket_hist"] == before + 1
    torch.testing.assert_close(y.cpu(), want_y, atol=1e-5, rtol=1e-5)
    assert int(aux["dropped"]) == int(want_aux["dropped"])
    for k in ("lb_loss", "z_loss"):
        torch.testing.assert_close(aux[k].cpu(), want_aux[k], atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("S,int8", [(16, False), (1, False), (6, False), (16, True)])
def test_moe_ffn_expert_parallel_on_the_card_matches_the_cpu(cuda, S, int8):
    """The deepseek-v2 smoke's MoE layer (f32) under a (1, 4) expert
    dispatch: all_to_all (S 16, with and without the int8 payload) and
    gather (S 1, 6) on the card equal the CPU path (plain bucket_hist)
    within 1e-5, plus one quantisation step of the output (1/127 of its
    largest magnitude) for int8, whose y is farther than 1e-5 from the
    full-precision payload's; dropped equal; bucket_hist launched, no host
    sync."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import make_dist
    from repro_torch.models import init_all, moe

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(cuda) for k, v in tree.items()}

    cfg = get_smoke_config("deepseek-v2-lite-16b").with_(moe_dispatch_int8=int8)
    dist = make_dist(cfg, {"data": 1, "model": 4})
    p = init_all(cfg, seed=0, device="cpu")["blocks"][cfg.first_k_dense]["ffn"]
    x = torch.randn(2, S, cfg.d_model, generator=torch.Generator().manual_seed(S))
    want_y, want_aux = moe.moe_ffn(p, cfg, x, dist)
    p, x = to(p), x.to(cuda)
    moe.moe_ffn(p, cfg, x, dist)                # builds and loads the kernels
    torch.cuda.synchronize()
    before = ops.LAUNCHES["bucket_hist"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_ffn(p, cfg, x, dist)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.LAUNCHES["bucket_hist"] > before
    atol = 1e-5 + (float(want_y.abs().max()) / 127 if int8 else 0.0)
    torch.testing.assert_close(y.cpu(), want_y, atol=atol, rtol=0)
    assert int(aux["dropped"]) == int(want_aux["dropped"])
    for k in ("lb_loss", "z_loss"):
        torch.testing.assert_close(aux[k].cpu(), want_aux[k], atol=1e-5, rtol=1e-5)
    if int8:            # the int8 payload ran: y is not the full-precision payload's
        full = moe.moe_ffn(p, cfg.with_(moe_dispatch_int8=False), x, dist)[0]
        assert float((y - full).abs().max()) > 1e-5


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


# ---------------------------------------------------------------------------
# The train path on the card: attention by the reference's chunked route
# (the flash kernel has no backward and refuses inputs that need one)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_flash_attention_refuses_inputs_that_need_grad(cuda):
    g = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (torch.randn(1, 2, 32, 64, generator=g).to(cuda, torch.bfloat16) for _ in range(3))
    q.requires_grad_(True)
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == before
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert row_error(out, ops.flash_attention_plain(q.detach(), k, v)) <= TOLERANCE[torch.bfloat16]


TRAIN_ARCHS = ("internlm2-1.8b", "qwen3-moe-235b-a22b", "mamba2-780m")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """3 steps of a smoke (f32) from the same params and batch: losses within
    1e-4 relative, params within 1e-3 (Adam's first steps are about
    sign(g)), no flash launch."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_all, input_specs
    from repro_torch.train import OptimConfig, init_state, make_train_step, tree

    cfg = get_smoke_config(arch)
    ocfg = OptimConfig(lr=3e-3, warmup_steps=2, total_steps=100)
    params = init_all(cfg, seed=0, device="cpu")
    on_card = tree.tree_map(lambda t: t.to(cuda), params)
    batch = input_specs(cfg, "train", 4, 16, seed=0, device="cpu")
    cpu_state = init_state(cfg, ocfg, params=params)
    card_state = init_state(cfg, ocfg, params=on_card)
    step = make_train_step(cfg, ocfg)
    before = ops.LAUNCHES["flash_attention"]
    for _ in range(3):
        cpu_state, want = step(cpu_state, batch)
        card_state, got = step(card_state, {k: v.to(cuda) for k, v in batch.items()})
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-4 * abs(float(want["loss"]))
    assert ops.LAUNCHES["flash_attention"] == before
    for a, b in zip(tree.leaves(card_state.params), tree.leaves(cpu_state.params)):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_ep_train_step_on_the_card_matches_the_cpu(cuda, int8):
    """The deepseek-v2 smoke (f32) trained 3 steps under a (1, 4) expert
    dispatch (all_to_all at S 16), card against CPU from the same params and
    batch: losses within 1e-4 relative, params within 1e-3, dropped equal,
    bucket_hist launched (6 a MoE layer's forward, 10 with int8), no flash
    launch.  With the int8 payload a last-bit difference can move a code by
    one step (round(x / scale)), as the int8 gradient codec does in
    tests/test_torch_train.py: losses within its 2e-3 relative, params
    within 3 steps x 2 lr (a gradient near 0 whose sign flips moves its
    param by up to 2 lr a step; 1.4e-4 relative loss seen on the card)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import make_dist
    from repro_torch.models import init_all, input_specs
    from repro_torch.train import OptimConfig, init_state, make_train_step, tree

    cfg = get_smoke_config("deepseek-v2-lite-16b").with_(moe_dispatch_int8=int8)
    ocfg = OptimConfig(lr=3e-3, warmup_steps=2, total_steps=100)
    params = init_all(cfg, seed=0, device="cpu")
    on_card = tree.tree_map(lambda t: t.to(cuda), params)
    batch = input_specs(cfg, "train", 4, 16, seed=0, device="cpu")
    cpu_state = init_state(cfg, ocfg, params=params)
    card_state = init_state(cfg, ocfg, params=on_card)
    step = make_train_step(cfg, ocfg, make_dist(cfg, {"data": 1, "model": 4}))
    before = dict(ops.LAUNCHES)
    for _ in range(3):
        cpu_state, want = step(cpu_state, batch)
        card_state, got = step(card_state, {k: v.to(cuda) for k, v in batch.items()})
        rtol = 2e-3 if int8 else 1e-4
        assert abs(float(got["loss"]) - float(want["loss"])) <= rtol * abs(float(want["loss"]))
        if not int8:
            assert int(got["dropped"]) == int(want["dropped"])
    moe_layers = cfg.num_layers - cfg.first_k_dense
    assert ops.LAUNCHES["bucket_hist"] - before["bucket_hist"] == 3 * moe_layers * (10 if int8 else 6)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"]
    atol = 3 * 2 * ocfg.lr if int8 else 1e-3
    for a, b in zip(tree.leaves(card_state.params), tree.leaves(cpu_state.params)):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= atol


@pytest.mark.gpu
def test_gather_ep_is_repeatable_on_the_card(cuda):
    """A bf16 decode wave (8 tokens, S 1: the gather route) through the
    deepseek-v2 smoke's MoE layer at serve_moe's routing (64 experts, top 6)
    over 4 expert shards: every token has two or more of its experts on one
    shard, and 20 runs give the same bits; within the bf16 tolerance of the
    CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import make_dist
    from repro_torch.models import init_all, moe

    cfg = get_smoke_config("deepseek-v2-lite-16b").with_(
        num_experts=64, experts_per_tok=6, dtype="bfloat16")
    dist = make_dist(cfg, {"data": 1, "model": 4})
    p = init_all(cfg, seed=0, device="cpu")["blocks"][cfg.first_k_dense]["ffn"]
    x = torch.randn(8, 1, cfg.d_model, generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16)
    want = moe.moe_ffn(p, cfg, x, dist)[0]
    p = {k: v.to(cuda) if torch.is_tensor(v) else {kk: vv.to(cuda) for kk, vv in v.items()}
         for k, v in p.items()}
    x = x.to(cuda)
    owners = torch.sort(moe.route(p, cfg, x.reshape(8, -1))[1] // 16, dim=1).values
    assert bool((owners[:, 1:] == owners[:, :-1]).any(dim=1).all())
    ys = [moe.moe_ffn(p, cfg, x, dist)[0] for _ in range(20)]
    assert all(torch.equal(y, ys[0]) for y in ys[1:])
    torch.testing.assert_close(ys[0].float().cpu(), want.float(), atol=1e-1, rtol=0)


@pytest.mark.gpu
def test_from_measured_counts_the_cpu_flops(cuda):
    """roofline.from_measured on one train step of the deepseek-v2 smoke
    under a (1, 4) expert dispatch: the card's counted flops within 1 % of
    FlopCounterMode's count of the same step on the CPU; bytes the state's."""
    from repro_torch.configs import ShapeSpec, get_smoke_config
    from repro_torch.distributed.sharding import make_dist
    from repro_torch.launch import roofline
    from repro_torch.models import init_all, input_specs
    from repro_torch.train import OptimConfig, init_state, make_train_step, tree

    cfg = get_smoke_config("deepseek-v2-lite-16b")
    ocfg = OptimConfig()
    step = make_train_step(cfg, ocfg, make_dist(cfg, {"data": 1, "model": 4}))
    flops = roofline.model_flops_for_cell(cfg, ShapeSpec("t", 32, 4, "train"))
    out = {}
    for dev in ("cpu", cuda):
        params = tree.tree_map(lambda t: t.to(dev), init_all(cfg, seed=0, device="cpu"))
        state = init_state(cfg, ocfg, params=params)
        batch = input_specs(cfg, "train", 4, 32, seed=0, device=dev)
        out[str(dev)], _ = roofline.from_measured(step, (state, batch), model_flops=flops,
                                                  kind="train")
    cpu, card = out["cpu"], out[str(cuda)]
    assert cpu.flops_per_chip > flops
    assert abs(card.flops_per_chip - cpu.flops_per_chip) <= 0.01 * cpu.flops_per_chip
    assert card.bytes_per_chip == cpu.bytes_per_chip == 40 * sum(
        p.numel() for p in tree.leaves(state.params))


@pytest.mark.gpu
def test_checkpoint_of_a_card_state_restores_equal_leaves(cuda, tmp_path):
    """A bf16 smoke TrainState on the card (bf16 leaves stored as 16-bit
    patterns) saved asynchronously and restored leaf for leaf."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import OptimConfig, checkpoint, init_state, tree

    cfg = get_smoke_config("internlm2-1.8b").with_(dtype="bfloat16")
    state = init_state(cfg, OptimConfig(), seed=1, device=cuda)
    checkpoint.save(str(tmp_path), 5, state, blocking=False)
    checkpoint.wait_for_async_saves()
    restored, step = checkpoint.restore_latest(str(tmp_path), state)
    assert step == 5
    for a, b in zip(tree.leaves(restored), tree.leaves(state)):
        assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
        assert a.requires_grad == b.requires_grad
