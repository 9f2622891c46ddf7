"""The port's dense LM (`repro_torch.models`, device="cpu") against the reference's.

The reference runs once per file in a subprocess (tests/torch_parity.py): it
initialises each smoke config, exports its parameters as numpy and computes
`forward`, `prefill` and `decode_step` (scalar cache length, then per-sequence
[B] lengths) on tokens drawn with numpy from a seed.  The port loads the same
parameters through `params_from_reference` and must give the same logits and
cache contents.

Tolerances: the f32 configs agree to 1e-5 absolute on logits and cache
values up to ~3.6 (sums in another order; rsqrt, silu, exp and the rope
angles round differently in XLA and in PyTorch; the largest difference seen
is 2.6e-6).  The bf16 case rounds every activation to 8 significant bits,
and XLA and PyTorch round at different places (XLA fuses elementwise chains
in f32, PyTorch rounds after each op): the cache differs by one or two bf16
ulps (2^-6 = 0.016 in [2, 4)), and the f32 logits, a product of the rounded
final activations, by up to 0.051.  The bf16 tolerance is 1e-1.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import convert, transformer
from torch_parity import run_reference

CASES = [("internlm2-1.8b", "float32"), ("codeqwen1.5-7b", "float32"),
         ("internlm2-1.8b", "bfloat16")]
TOL = {"float32": 1e-5, "bfloat16": 1e-1}
B, S, N_PRE, MAX_LEN = 2, 12, 7, 32
DECODE_STEPS = 3
VEC_LENGTHS = [7, 4]          # per-sequence lengths for the [B]-length decode


def _key(arch, dtype):
    return f"{arch}_{dtype}"


def _cfg(arch, dtype):
    return get_smoke_config(arch).with_(dtype=dtype)


def _tokens(vocab):
    return np.random.default_rng(5).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def reference():
    body = f"""
import jax.numpy as jnp
from repro.configs.base import get_smoke_config
from repro.models.nn import paths_from_tree
from repro.models.registry import get_model, init_all

def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))

for arch, dtype in {CASES!r}:
    key = arch + "_" + dtype
    cfg = get_smoke_config(arch).with_(dtype=dtype)
    params, _ = init_all(cfg, seed=0)
    flat = paths_from_tree({{k: v for k, v in params.items() if k != "prefix"}})
    for path, v in flat.items():
        OUT[key + "/param/" + path] = f32(v)
    api = get_model(cfg)
    tokens = jnp.asarray(np.random.default_rng(5).integers(0, cfg.vocab_size, ({B}, {S})), jnp.int32)
    OUT[key + "/forward"] = f32(api.forward(cfg, params, {{"tokens": tokens}})[0])
    cache = api.init_cache(cfg, {B}, {MAX_LEN})
    logits, cache = api.prefill(cfg, params, {{"tokens": tokens[:, :{N_PRE}]}}, cache)
    OUT[key + "/prefill"] = f32(logits)
    for i in range({DECODE_STEPS}):
        logits, cache = api.decode_step(cfg, params, tokens[:, {N_PRE} + i:{N_PRE} + i + 1], cache)
        OUT[key + f"/decode{{i}}"] = f32(logits)
    for f in ("k", "v", "length"):
        OUT[key + "/cache_" + f] = f32(cache["blocks"][f])
    L = cfg.num_layers
    lengths = jnp.broadcast_to(jnp.asarray({VEC_LENGTHS!r}, jnp.int32), (L, {B}))
    cache = dict(cache, blocks=dict(cache["blocks"], length=lengths))
    for i in range(2):
        logits, cache = api.decode_step(cfg, params, tokens[:, {S} - 2 + i:{S} - 1 + i], cache)
        OUT[key + f"/vdecode{{i}}"] = f32(logits)
    for f in ("k", "v", "length"):
        OUT[key + "/vcache_" + f] = f32(cache["blocks"][f])
"""
    return run_reference(body)


def _flat(ref, key):
    pre = key + "/param/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _close(got: torch.Tensor, want: np.ndarray, tol: float, what: str):
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape), want.shape)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_params_from_reference_round_trip(reference, arch, dtype):
    cfg = _cfg(arch, dtype)
    flat = _flat(reference, _key(arch, dtype))
    params = convert.params_from_reference(cfg, flat, device="cpu")
    assert len(params["blocks"]) == cfg.num_layers
    # the port's tree, restacked, is the reference's: every leaf, no more
    back = {"embed/tokens": params["embed"]["tokens"], "ln_f/scale": params["ln_f"]["scale"],
            "unembed/w": params["unembed"]["w"]}
    for group in ("ln1", "ln2", "attn", "ffn"):
        for name in params["blocks"][0][group]:
            back[f"blocks/{group}/{name}"] = torch.stack([b[group][name] for b in params["blocks"]])
    assert sorted(back) == sorted(flat)
    for path, t in back.items():
        assert t.dtype == cfg.torch_dtype, path
        np.testing.assert_array_equal(t.float().numpy(), flat[path], err_msg=path)
    # the port's own initialiser gives the same tree of shapes and dtypes
    own = transformer.init_params(cfg, _factory(cfg))
    assert _shapes(own) == _shapes(params)


def _factory(cfg):
    from repro_torch.models.nn import ParamFactory
    return ParamFactory(torch.Generator().manual_seed(0), "cpu", cfg.torch_dtype)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_prefill_decode_match_reference(reference, arch, dtype):
    key, cfg, tol = _key(arch, dtype), _cfg(arch, dtype), TOL[dtype]
    params = convert.params_from_reference(cfg, _flat(reference, key), device="cpu")
    tokens = torch.from_numpy(_tokens(cfg.vocab_size))
    _close(transformer.forward(cfg, params, {"tokens": tokens}), reference[key + "/forward"],
           tol, "forward")

    cache = transformer.init_cache(cfg, B, MAX_LEN, device="cpu")
    logits, cache = transformer.prefill(cfg, params, {"tokens": tokens[:, :N_PRE]}, cache)
    _close(logits, reference[key + "/prefill"], tol, "prefill")
    for i in range(DECODE_STEPS):
        logits, cache = transformer.decode_step(cfg, params, tokens[:, N_PRE + i:N_PRE + i + 1],
                                                cache)
        _close(logits, reference[key + f"/decode{i}"], tol, f"decode {i}")
    _close(cache["k"], reference[key + "/cache_k"], tol, "cache k")
    _close(cache["v"], reference[key + "/cache_v"], tol, "cache v")
    assert int(cache["length"]) == N_PRE + DECODE_STEPS
    assert (reference[key + "/cache_length"] == N_PRE + DECODE_STEPS).all()

    # per-sequence lengths, as the serve engine keeps them
    cache["length"] = torch.tensor(VEC_LENGTHS, dtype=torch.int32)
    for i in range(2):
        logits, cache = transformer.decode_step(cfg, params, tokens[:, S - 2 + i:S - 1 + i], cache)
        _close(logits, reference[key + f"/vdecode{i}"], tol, f"[B]-length decode {i}")
    _close(cache["k"], reference[key + "/vcache_k"], tol, "[B]-length cache k")
    _close(cache["v"], reference[key + "/vcache_v"], tol, "[B]-length cache v")
    np.testing.assert_array_equal(cache["length"].numpy(), reference[key + "/vcache_length"][0])


def test_non_dense_configs_raise():
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    for arch in ("qwen3-moe-235b-a22b", "mamba2-780m"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 11"):
            get_config(arch)
    cfg = get_smoke_config("internlm2-1.8b")
    with pytest.raises(NotImplementedError, match="item 11b"):
        get_model(cfg.with_(family="moe"))
    with pytest.raises(NotImplementedError, match="item 11b"):
        transformer.init_cache(cfg.with_(num_experts=4), 1, 8)
