"""The port's attention (`repro_torch.kernels.flash_attention`, on the CPU: its
plain version) against the reference's two attention functions.

The reference runs once per file in a subprocess (tests/torch_parity.py), on
inputs both sides draw with numpy from the same seeds:

  * `repro.kernels.ops.flash_attention` in mode "xla" (the jnp oracle) and
    "interpret" (the Pallas kernel run by the interpreter), over the grid of
    tests/test_kernels.py, causal and non-causal, at that file's tolerances
    (f32 2e-6; bf16 2e-2, the oracle keeps the softmax weights in f32 where
    the plain version rounds them to bf16);
  * `repro.models.layers._chunked_attention`, the attention the serving path
    runs, with scalar and per-sequence [B] offsets (an idle slot's offset past
    the buffer included), GQA groups 1 and 2, D 16, 80 (zamba2) and 128, ragged Sq/Skv,
    several query chunks: f32 2e-6, bf16 2e-2; and MLA's shapes, where v is
    narrower than q and k (the smoke's (24, 16), deepseek-v2's (192, 128)).

The CUDA kernel is held against this plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from torch_parity import run_reference

GRID = [(B, H, S, hd, dt) for B, H, S, hd in [(1, 1, 128, 64), (2, 4, 256, 64), (1, 2, 512, 128)]
        for dt in ("float32", "bfloat16")]
MODES = ("xla", "interpret")
# name: B, Hq, Hkv, Sq, Skv, D, offset (None: Skv - Sq; int; list: per sequence), causal,
# dtype, the reference's q_chunk
CHUNKED = {
    "prefill_into_cache": (1, 4, 2, 37, 100, 16, 0, True, "float32", 1024),
    "scalar_offset_mha": (2, 4, 4, 45, 131, 128, 20, True, "float32", 1024),
    "decode_per_slot": (3, 4, 2, 1, 64, 16, [0, 30, 63], True, "float32", 1024),
    "idle_slot_past_buffer": (2, 2, 2, 1, 64, 128, [70, 5], True, "float32", 1024),
    "multi_token_per_slot": (2, 4, 2, 5, 33, 128, [3, 28], True, "float32", 1024),
    "query_chunks": (1, 4, 2, 1280, 1280, 16, None, True, "float32", 256),
    "non_causal_ragged": (1, 4, 2, 7, 19, 16, None, False, "float32", 1024),
    "decode_bf16": (2, 16, 8, 1, 300, 128, [10, 250], True, "bfloat16", 1024),
    # zamba2's 80-wide heads (MHA)
    "d80_prefill_into_cache": (1, 4, 4, 37, 100, 80, 0, True, "float32", 1024),
    "d80_decode_per_slot": (3, 4, 4, 1, 64, 80, [0, 30, 70], True, "float32", 1024),
    "d80_query_chunks": (1, 2, 2, 640, 640, 80, None, True, "float32", 128),
    "d80_non_causal": (1, 4, 4, 7, 19, 80, None, False, "float32", 1024),
    "d80_bf16": (2, 8, 8, 5, 300, 80, [10, 250], True, "bfloat16", 1024),
}
# MLA: v of its own width Dv.  name: B, Hq, Hkv, Sq, Skv, D, Dv, offset, causal, dtype, q_chunk
CHUNKED_MLA = {
    "mla_smoke_prefill": (2, 4, 4, 12, 32, 24, 16, 0, True, "float32", 1024),
    "mla_decode_per_slot": (3, 4, 4, 1, 64, 192, 128, [0, 30, 70], True, "float32", 1024),
    "mla_prefill_scalar": (1, 4, 4, 37, 100, 192, 128, 20, True, "float32", 1024),
    "mla_query_chunks": (1, 2, 2, 512, 512, 192, 128, None, True, "float32", 128),
    "mla_bf16": (2, 16, 16, 5, 300, 192, 128, [10, 250], True, "bfloat16", 1024),
}
TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _grid_inputs(B, H, S, hd):
    rng = np.random.default_rng(B * H * S)
    return [rng.standard_normal((B, H, S, hd)) for _ in range(3)]


def _chunked_inputs(name):
    B, Hq, Hkv, Sq, Skv, D = CHUNKED[name][:6]
    rng = np.random.default_rng(sum(map(ord, name)))
    return (rng.standard_normal((B, Hq, Sq, D)), rng.standard_normal((B, Hkv, Skv, D)),
            rng.standard_normal((B, Hkv, Skv, D)))


def _mla_inputs(name):
    B, Hq, Hkv, Sq, Skv, D, Dv = CHUNKED_MLA[name][:7]
    rng = np.random.default_rng(sum(map(ord, name)))
    return (rng.standard_normal((B, Hq, Sq, D)), rng.standard_normal((B, Hkv, Skv, D)),
            rng.standard_normal((B, Hkv, Skv, Dv)))


def _grid_key(B, H, S, hd, dt):
    return f"{B}_{H}_{S}_{hd}_{dt}"


@pytest.fixture(scope="module")
def reference():
    import inspect
    body = f"""
import jax.numpy as jnp
from repro.kernels import ops
from repro.models.layers import _chunked_attention
CHUNKED = {CHUNKED!r}
CHUNKED_MLA = {CHUNKED_MLA!r}
{inspect.getsource(_grid_inputs)}
{inspect.getsource(_chunked_inputs)}
{inspect.getsource(_mla_inputs)}
for B, H, S, hd, dt in {GRID!r}:
    q, k, v = (jnp.asarray(x, dt) for x in _grid_inputs(B, H, S, hd))
    for mode in {MODES!r}:
        out = ops.flash_attention(q, k, v, causal=True, mode=mode)
        OUT[f"grid/{{B}}_{{H}}_{{S}}_{{hd}}_{{dt}}/{{mode}}"] = np.asarray(out, np.float32)
q, k, v = (jnp.asarray(x, jnp.float32) for x in _grid_inputs(1, 2, 128, 64))
for mode in {MODES!r}:
    OUT[f"noncausal/{{mode}}"] = np.asarray(ops.flash_attention(q, k, v, causal=False, mode=mode))
for name, (B, Hq, Hkv, Sq, Skv, D, offset, causal, dt, q_chunk) in CHUNKED.items():
    q, k, v = (jnp.asarray(x, dt) for x in _chunked_inputs(name))
    if offset is not None:
        offset = jnp.asarray(offset, jnp.int32)
    out = _chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk, dist=None, offset=offset)
    OUT["chunked/" + name] = np.asarray(out, np.float32)
for name, (B, Hq, Hkv, Sq, Skv, D, Dv, offset, causal, dt, q_chunk) in CHUNKED_MLA.items():
    q, k, v = (jnp.asarray(x, dt) for x in _mla_inputs(name))
    if offset is not None:
        offset = jnp.asarray(offset, jnp.int32)
    out = _chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk, dist=None, offset=offset)
    OUT["mla/" + name] = np.asarray(out, np.float32)
"""
    return run_reference(body)


def _t(x, dt):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dt))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,H,S,hd,dt", GRID)
def test_plain_matches_reference_flash(reference, B, H, S, hd, dt, mode):
    q, k, v = (_t(x, dt) for x in _grid_inputs(B, H, S, hd))
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               reference[f"grid/{_grid_key(B, H, S, hd, dt)}/{mode}"],
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_reference_flash_noncausal(reference, mode):
    q, k, v = (_t(x, "float32") for x in _grid_inputs(1, 2, 128, 64))
    got = ops.flash_attention(q, k, v, causal=False)
    np.testing.assert_allclose(got.numpy(), reference[f"noncausal/{mode}"], atol=2e-6)


@pytest.mark.parametrize("name", list(CHUNKED))
def test_plain_matches_chunked_attention(reference, name):
    offset, causal, dt = CHUNKED[name][6:9]
    q, k, v = (_t(x, dt) for x in _chunked_inputs(name))
    if offset is not None:
        offset = torch.tensor(offset, dtype=torch.int32)
    got = ops.flash_attention(q, k, v, causal=causal, offset=offset)
    assert got.shape == q.shape and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(), reference["chunked/" + name],
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("name", list(CHUNKED_MLA))
def test_plain_matches_chunked_attention_mla(reference, name):
    """v narrower than q and k: the output takes v's width."""
    offset, causal, dt = CHUNKED_MLA[name][7:10]
    q, k, v = (_t(x, dt) for x in _mla_inputs(name))
    if offset is not None:
        offset = torch.tensor(offset, dtype=torch.int32)
    got = ops.flash_attention(q, k, v, causal=causal, offset=offset)
    assert got.shape == q.shape[:3] + v.shape[3:] and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(), reference["mla/" + name],
                               atol=TOL[dt], rtol=TOL[dt])


def test_fully_masked_rows_give_zero():
    """Sq > Skv with the default offset Skv - Sq: the first rows see no key
    and give 0, as the Pallas kernel's finalize does."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, n, 32, generator=g) for n in (64, 32, 32))
    out = ops.flash_attention(q, k, v)
    assert torch.equal(out[:, :, :32], torch.zeros_like(out[:, :, :32]))
    assert bool((out[:, :, 32].abs().sum(-1) > 0).all())


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 3, 4, 16)
    with pytest.raises(ValueError, match="GQA"):
        ops.flash_attention(q, torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 4, 16))
    with pytest.raises(ValueError, match="k = v"):
        ops.flash_attention(q, torch.zeros(1, 3, 4, 16), torch.zeros(1, 3, 5, 16))
    with pytest.raises(ValueError, match="k = v"):      # v's heads must be k's
        ops.flash_attention(q, torch.zeros(1, 3, 4, 16), torch.zeros(1, 1, 4, 16))


def _decode_wave(seed=7):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(4, 4, 1, 128, generator=g)
    k, v = (torch.randn(4, 2, 1024, 128, generator=g) for _ in range(2))
    return q, k, v, torch.randint(127, 1023, (4,), generator=g, dtype=torch.int32)


@pytest.mark.parametrize("fault", ["scale", "drop_last_keys"])
def test_row_error_rejects_planted_faults(fault):
    """The planted faults that chip_smoke.py and tests/test_torch_gpu.py put
    into the kernel's decode wave, here put into the plain version, exceed
    the bf16 limit of `row_error`; rounding the sound output to bf16 does not."""
    from repro_torch.kernels.flash_attention import TOLERANCE, row_error
    q, k, v, off = _decode_wave()
    want = ops.flash_attention(q, k, v, offset=off)
    assert row_error(want.to(torch.bfloat16), want) <= 2.0 ** -8 < TOLERANCE[torch.bfloat16]
    if fault == "scale":
        bad = ops.flash_attention(q, k, v, offset=off, scale=1.05 / 128 ** 0.5)
    else:
        bad = ops.flash_attention(q, k, v, offset=off - 32)
    assert row_error(bad, want) > TOLERANCE[torch.bfloat16]


def test_row_error_is_relative_to_each_row():
    from repro_torch.kernels.flash_attention import row_error
    want = torch.tensor([[[100.0, -50.0], [0.01, 0.02]], [[0.0, 0.0], [1.0, 1.0]]])
    assert row_error(want, want) == 0.0
    got = want.clone()
    got[0, 1, 0] += 0.001                       # small in absolute terms, 5 % of its row
    assert row_error(got, want) == pytest.approx(0.05)
    got = want.clone()
    got[0, 0, 1] += 1.0                         # large in absolute terms, 1 % of its row
    assert row_error(got, want) == pytest.approx(0.01)
    got = want.clone()
    got[1, 0, 0] = 1e-3                         # a row that must be 0 is not
    assert row_error(got, want) == float("inf")
    assert row_error(want[:, :0], want[:, :0]) == 0.0
