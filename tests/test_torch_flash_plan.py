"""The flash_attention wrapper's layout of a kernel call (`plan`): which of
the two kernels a call takes, the decode kernel's query tiles, key chunks
and scratch.  Pure shape arithmetic: it runs here without a card."""

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DECODE_BLOCKS_PER_SM, DECODE_TILE_KEYS,
                                                 HEAD_DIMS, KERNEL_ROWS, PREFILL_HEAD_DIMS,
                                                 flash_attention, kernel_rows, plan)

SMS = 132   # an H100 SXM

bf16, f32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,Sq,Skv,D,kernel", [
    (bf16, 2048, 4096, 128, "prefill"),   # an admission of the serve path
    (bf16, 16, 16, 64, "prefill"),        # the smallest prefill
    (bf16, 15, 4096, 128, "decode"),      # too few queries for a 64-row tile
    (bf16, 1, 4096, 128, "decode"),       # the decode wave
    (bf16, 37, 64, 16, "decode"),         # D < 64: dispatched by shape to decode
    (bf16, 37, 64, 32, "decode"),
    (f32, 2048, 4096, 128, "decode"),     # f32 never takes the tensor cores
    (bf16, 100, 0, 128, "decode"),        # no key: nothing for TMA to load
])
def test_plan_picks_the_kernel(dtype, Sq, Skv, D, kernel):
    assert plan(dtype, 2, 16, 8, Sq, Skv, D, D, SMS).kernel == kernel


# MLA (deepseek-v2): q and k 192 wide, v 128, 16 heads with kv heads of their own
@pytest.mark.parametrize("dtype,Sq,Skv,Dv,kernel", [
    (bf16, 2048, 4096, 128, "prefill"),   # an admission of serve_moe
    (bf16, 16, 16, 128, "prefill"),
    (bf16, 1, 4096, 128, "decode"),       # the decode wave
    (f32, 16, 4096, 128, "decode"),
    (bf16, 2048, 4096, 192, "decode"),    # (192, 192) has no prefill instance
])
def test_plan_picks_the_kernel_mla(dtype, Sq, Skv, Dv, kernel):
    assert plan(dtype, 8, 16, 16, Sq, Skv, 192, Dv, SMS).kernel == kernel


def test_mla_decode_rows_are_capped():
    """A 192-wide q row takes at most 8 rows a decode block: f32 with 16
    queries per slot is two query tiles of 8 (R 8), and the decode wave one
    row per block (R 1)."""
    assert kernel_rows(192) == 8 and kernel_rows(128) == KERNEL_ROWS == 16
    p = plan(f32, 2, 16, 16, 16, 4096, 192, 128, SMS)
    assert (p.bq, p.rows, p.groups) == (8, 8, 2 * 16 * 2)
    p = plan(bf16, 8, 16, 16, 1, 4096, 192, 128, SMS)
    assert (p.kernel, p.bq, p.rows, p.groups) == ("decode", 1, 1, 8 * 16)
    assert p.scratch_rows == p.groups * p.splits * p.rows and p.splits > 1
    # the same shape at D 128 fills a block with 16 rows
    assert plan(f32, 2, 16, 16, 16, 4096, 128, 128, SMS).bq == 16


# zamba2's shared attention block: 32 heads of 80, each its own kv head
@pytest.mark.parametrize("dtype,Sq,Skv,kernel", [
    (bf16, 2048, 4096, "prefill"),   # an admission of serve_hybrid, at each of the 9 sites
    (bf16, 16, 16, "prefill"),
    (bf16, 15, 4096, "decode"),
    (bf16, 1, 4096, "decode"),       # the decode wave
    (f32, 2048, 4096, "decode"),
])
def test_plan_picks_the_kernel_d80(dtype, Sq, Skv, kernel):
    assert (80, 80) in HEAD_DIMS and (80, 80) in PREFILL_HEAD_DIMS
    assert plan(dtype, 8, 32, 32, Sq, Skv, 80, 80, SMS).kernel == kernel


def test_decode_plan_of_the_hybrid_wave():
    """zamba2's decode wave, 8 slots x 32 heads of 80: 16 rows a block at
    D 80 (as at 128), one row per block here, 3 chunks of 1376 keys."""
    assert kernel_rows(80) == KERNEL_ROWS
    p = plan(bf16, 8, 32, 32, 1, 4096, 80, 80, SMS)
    assert (p.kernel, p.bq, p.splits, p.chunk, p.groups, p.rows) == ("decode", 1, 3, 1376, 256, 1)
    assert p.scratch_rows == 256 * 3 * 1
    # f32 with 16 query heads per kv head fills a block's 16 rows
    assert plan(f32, 1, 16, 1, 3, 700, 80, 80, SMS).rows == 16


# B, Hq, Hkv, Sq, Skv, D
DECODE_SHAPES = [
    (8, 16, 8, 1, 4096, 128),     # internlm2-1.8b's decode wave, 8 slots x 4096
    (8, 40, 8, 1, 4096, 128),     # GQA group 5
    (4, 8, 8, 1, 2048, 128),      # group 1
    (2, 4, 2, 3, 1000, 64),       # a few queries per slot
    (1, 2, 1, 1, 700, 32),
    (2, 16, 8, 1000, 1531, 128),  # f32 prefill: enough blocks without a split
    (64, 16, 8, 1, 64, 16),       # many short slots
    (8, 32, 32, 1, 4096, 80),     # zamba2-2.7b's decode wave
    (2, 16, 16, 5, 2000, 80),
    (1, 2, 1, 1, 0, 32),          # no key
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", DECODE_SHAPES)
def test_decode_plan_covers_the_keys(B, Hq, Hkv, Sq, Skv, D):
    p = plan(f32, B, Hq, Hkv, Sq, Skv, D, D, SMS)
    g = Hq // Hkv
    assert p.kernel == "decode"
    assert 1 <= p.bq and g * p.bq <= KERNEL_ROWS and p.rows == g * p.bq
    assert p.bq == min(KERNEL_ROWS // g, Sq)
    assert p.groups == B * Hkv * -(-Sq // p.bq)
    # whole tiles, every key in a chunk, no chunk empty
    assert p.chunk % DECODE_TILE_KEYS == 0 and p.chunk >= DECODE_TILE_KEYS
    assert p.splits * p.chunk >= Skv and (p.splits == 1 or (p.splits - 1) * p.chunk < Skv)
    # enough blocks for full caches, or one tile per block already
    assert p.groups * p.splits >= DECODE_BLOCKS_PER_SM * SMS * 0.8 or p.chunk == DECODE_TILE_KEYS \
        or p.splits == 1
    assert p.scratch_rows == (p.groups * p.splits * p.rows if p.splits > 1 else 0)


def test_decode_plan_of_the_serve_wave():
    """8 slots x 8 kv heads: 9 chunks of 480 keys, about 4 blocks per SM
    for full caches; scratch for 2 rows per group."""
    p = plan(bf16, 8, 16, 8, 1, 4096, 128, 128, SMS)
    assert (p.bq, p.splits, p.chunk, p.groups, p.rows) == (1, 9, 480, 64, 2)
    assert p.scratch_rows == 64 * 9 * 2


@pytest.mark.parametrize("name", build.FLASH_KERNELS)
def test_each_flash_kernel_has_a_count(name):
    """Each kernel's count is zeroed by `reset_launches` and moved only by a
    launch: a call on CPU tensors at a shape planned for that kernel runs the
    plain version and counts nothing."""
    kernel = name.removeprefix("flash_attention_")
    B, Hq, Hkv, Sq, Skv, D = 1, 4, 2, (32 if kernel == "prefill" else 1), 64, 64
    assert plan(bf16, B, Hq, Hkv, Sq, Skv, D, D, SMS).kernel == kernel
    build.LAUNCHES[name] = 7
    build.reset_launches()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, Hq, Sq, D, generator=gen).to(bf16)
    k = torch.randn(B, Hkv, Skv, D, generator=gen).to(bf16)
    v = torch.randn(B, Hkv, Skv, D, generator=gen).to(bf16)
    out = flash_attention(q, k, v)
    assert out.shape == q.shape and bool(torch.isfinite(out.float()).all())
    assert all(count == 0 for count in build.LAUNCHES.values())
