"""The port's ssm, hybrid, encdec and vlm families (`repro_torch.models`,
device="cpu") against the reference's: the mamba2, zamba2, seamless and
llava smokes in f32, zamba2 and llava in bf16.

The reference runs once per file in a subprocess (tests/torch_parity.py): it
initialises each smoke config, exports its parameters as numpy, draws a
batch with its `input_specs(mode="init")` (tokens, and enc_embeds or
patch_embeds) and computes `forward`, `prefill` (the first N_PRE tokens;
encdec and vlm with the whole encoder input or image) and `decode_step`
(scalar cache length, then per-sequence [B] lengths), with the caches after
each.  The port draws its batch with its own `input_specs` (equal to the
reference's), loads the parameters through `params_from_reference` and must
give the same logits, states and caches: ssm (conv, ssm) per layer; hybrid
the mamba states of every layer and the K/V of every attention site; encdec
the self K/V and the cross K/V, which holds exactly the encoder's Se keys;
vlm the dense K/V of image and text positions.

Tolerances, as tests/test_torch_lm.py states them: f32 1e-5 absolute on
logits and cache or state values (sums in another order; exp, softplus,
silu, rsqrt and the rope angles round differently in XLA and PyTorch; the
largest difference seen is 3.9e-6); bf16 1e-1 (XLA and PyTorch round
activations to 8 bits at different places, and the f32 logits are products
of rounded activations; 0.066 seen).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import arch_ids, get_config, get_smoke_config
from repro_torch.models import convert, get_model, init_all, input_specs
from torch_parity import run_reference

CASES = [("mamba2-780m", "float32"), ("zamba2-2.7b", "float32"),
         ("seamless-m4t-large-v2", "float32"), ("llava-next-mistral-7b", "float32"),
         ("zamba2-2.7b", "bfloat16"), ("llava-next-mistral-7b", "bfloat16")]
TOL = {"float32": 1e-5, "bfloat16": 1e-1}
B, S, N_PRE, MAX_LEN, SEED = 2, 12, 7, 40, 3
DECODE_STEPS = 3
VEC_LENGTHS = [5, 2]          # per-sequence lengths, beyond the prefill's positions


def _cfg(arch, dtype):
    return get_smoke_config(arch).with_(dtype=dtype)


def _seq(cfg):
    """input_specs's seq_len: S text tokens (after the image for vlm)."""
    return S + cfg.num_image_tokens


def _key(arch, dtype):
    return f"{arch}_{dtype}"


@pytest.fixture(scope="module")
def reference():
    body = f"""
import jax.numpy as jnp
from repro.configs.base import ShapeSpec, get_smoke_config
from repro.models.nn import paths_from_tree
from repro.models.registry import get_model, init_all, input_specs

def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))

def export_cache(prefix, family, cache):
    if family == "ssm":
        OUT[prefix + "conv"], OUT[prefix + "ssm"] = map(f32, cache["states"])
        OUT[prefix + "length"] = np.asarray(cache["length"])
    elif family == "hybrid":
        OUT[prefix + "conv"], OUT[prefix + "ssm"] = map(f32, cache["mamba"])
        for f in ("k", "v", "length"):
            OUT[prefix + f] = f32(cache["sites"][f])
    elif family == "encdec":
        for f in ("k", "v", "length"):
            OUT[prefix + f] = f32(cache["self"][f])
        OUT[prefix + "cross_k"] = f32(cache["cross"]["k"])
        OUT[prefix + "cross_v"] = f32(cache["cross"]["v"])
    else:
        for f in ("k", "v", "length"):
            OUT[prefix + f] = f32(cache["blocks"][f])

def with_lengths(family, cache, lengths):
    if family == "ssm":
        return dict(cache, length=lengths)
    if family == "hybrid":
        n = cache["sites"]["length"].shape[0]
        return dict(cache, sites=dict(cache["sites"], length=jnp.broadcast_to(lengths, (n, {B}))))
    if family == "encdec":
        n = cache["self"]["length"].shape[0]
        return dict(cache, self=dict(cache["self"], length=jnp.broadcast_to(lengths, (n, {B}))))
    n = cache["blocks"]["length"].shape[0]
    return dict(cache, blocks=dict(cache["blocks"], length=jnp.broadcast_to(lengths, (n, {B}))))

for arch, dtype in {CASES!r}:
    key = arch + "_" + dtype
    cfg = get_smoke_config(arch).with_(dtype=dtype)
    params, _ = init_all(cfg, seed=0)
    for path, v in paths_from_tree({{k: v for k, v in params.items() if k != "prefix"}}).items():
        OUT[key + "/param/" + path] = f32(v)
    api = get_model(cfg)
    shape = ShapeSpec("t", {S} + cfg.num_image_tokens, {B}, "train")
    batch = input_specs(cfg, shape, "init", {SEED})
    for f, v in batch.items():
        OUT[key + "/batch_" + f] = f32(v)
    OUT[key + "/forward"] = f32(api.forward(cfg, params, batch)[0])
    tokens = batch["tokens"]
    pre = dict(batch, tokens=tokens[:, :{N_PRE}])
    pre.pop("labels")
    cache = api.init_cache(cfg, {B}, {MAX_LEN})
    logits, cache = api.prefill(cfg, params, pre, cache)
    OUT[key + "/prefill"] = f32(logits)
    export_cache(key + "/pcache_", cfg.family, cache)
    for i in range({DECODE_STEPS}):
        logits, cache = api.decode_step(cfg, params, tokens[:, {N_PRE} + i:{N_PRE} + i + 1], cache)
        OUT[key + f"/decode{{i}}"] = f32(logits)
    export_cache(key + "/cache_", cfg.family, cache)
    lengths = jnp.asarray({VEC_LENGTHS!r}, jnp.int32) + cfg.num_image_tokens
    cache = with_lengths(cfg.family, cache, lengths)
    for i in range(2):
        logits, cache = api.decode_step(cfg, params, tokens[:, {S} - 2 + i:{S} - 1 + i], cache)
        OUT[key + f"/vdecode{{i}}"] = f32(logits)
    export_cache(key + "/vcache_", cfg.family, cache)
"""
    return run_reference(body)


def _flat(ref, key):
    pre = key + "/param/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _params(reference, arch, dtype):
    return convert.params_from_reference(_cfg(arch, dtype), _flat(reference, _key(arch, dtype)),
                                         device="cpu")


def _close(got, want, tol, what):
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape), want.shape)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0, err_msg=what)


def _port_cache(cfg, cache):
    """The port's cache in the reference's layout: {leaf: tensor}, lengths aside."""
    out = {k: v for k, v in cache.items() if k != "length"}
    if cfg.family == "hybrid":
        n_groups = cfg.num_layers // cfg.shared_attn_every
        for f in ("conv", "ssm"):
            out[f] = out[f].reshape(n_groups, cfg.shared_attn_every, *out[f].shape[1:])
    return out


def _check_cache(ref, prefix, cfg, cache, tol, what):
    for f, t in _port_cache(cfg, cache).items():
        _close(t, ref[prefix + f], tol, f"{what} {f}")
    want = ref[prefix + "length"]
    got = cache["length"].numpy()
    if cfg.family != "ssm":     # the reference keeps one length per layer or site, all equal
        assert (want == want[:1]).all()
        want = want[0]
    np.testing.assert_array_equal(got, want, err_msg=f"{what} length")


@pytest.mark.parametrize("arch,dtype", CASES)
def test_input_specs_match_reference(reference, arch, dtype):
    """The port's random batch is the reference's `input_specs(mode="init")`."""
    cfg = _cfg(arch, dtype)
    batch = input_specs(cfg, "train", B, _seq(cfg), seed=SEED, device="cpu")
    pre = _key(arch, dtype) + "/batch_"
    assert sorted(batch) == sorted(k[len(pre):] for k in reference if k.startswith(pre))
    for f, t in batch.items():
        assert t.dtype == (torch.int32 if f in ("tokens", "labels") else cfg.torch_dtype), f
        np.testing.assert_array_equal(t.float().numpy(), reference[pre + f], err_msg=f)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_params_from_reference_round_trip(reference, arch, dtype):
    """Every reference leaf lands in the port's tree, restacked it is the
    reference's, and the port's own initialiser gives the same shapes."""
    cfg = _cfg(arch, dtype)
    flat = _flat(reference, _key(arch, dtype))
    params = _params(reference, arch, dtype)
    every = cfg.shared_attn_every
    stacked = {"ssm": lambda: {"layers": (cfg.num_layers,)},
               "hybrid": lambda: {"mamba": (cfg.num_layers // every, every)},
               "encdec": lambda: {"enc": (cfg.encoder_layers,), "dec": (cfg.num_layers,)},
               "vlm": lambda: {"blocks": (cfg.num_layers,)}}[cfg.family]()
    back = {}
    for top, value in params.items():
        if top in stacked:
            assert len(value) == int(np.prod(stacked[top]))
            layers = [_tree_paths(layer, top) for layer in value]
            for path in layers[0]:
                t = torch.stack([layer[path] for layer in layers])
                back[path] = t.reshape(*stacked[top], *t.shape[1:])
        else:
            back.update(_tree_paths(value, top))
    assert sorted(back) == sorted(flat)
    for path, t in back.items():
        assert t.dtype == cfg.torch_dtype, path
        np.testing.assert_array_equal(t.float().numpy(), flat[path], err_msg=path)
    own = init_all(cfg, seed=0, device="cpu")
    assert _shapes(own) == _shapes(params)


def _tree_paths(tree, prefix):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_tree_paths(v, f"{prefix}/{k}"))
    return out


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_prefill_decode_match_reference(reference, arch, dtype):
    key, cfg, tol = _key(arch, dtype), _cfg(arch, dtype), TOL[dtype]
    api = get_model(cfg)
    params = _params(reference, arch, dtype)
    batch = input_specs(cfg, "train", B, _seq(cfg), seed=SEED, device="cpu")
    logits, aux = api.forward(cfg, params, batch)
    _close(logits, reference[key + "/forward"], tol, "forward")
    assert all(float(v) == 0.0 for v in aux.values())

    tokens = batch["tokens"]
    pre = {k: v for k, v in batch.items() if k != "labels"}
    pre["tokens"] = tokens[:, :N_PRE]
    cache = api.init_cache(cfg, B, MAX_LEN, device="cpu")
    assert "cross_k" not in cache and "cross_v" not in cache   # prefill adds them
    logits, cache = api.prefill(cfg, params, pre, cache)
    _close(logits, reference[key + "/prefill"], tol, "prefill")
    _check_cache(reference, key + "/pcache_", cfg, cache, tol, "prefill cache")
    if cfg.family == "encdec":   # the cross cache holds exactly the encoder's keys
        assert cache["cross_k"].shape[3] == cache["cross_v"].shape[3] == S != MAX_LEN
    for i in range(DECODE_STEPS):
        logits, cache = api.decode_step(cfg, params, tokens[:, N_PRE + i:N_PRE + i + 1], cache)
        _close(logits, reference[key + f"/decode{i}"], tol, f"decode {i}")
    _check_cache(reference, key + "/cache_", cfg, cache, tol, "cache")

    # per-sequence lengths, as the serve engine keeps them
    cache["length"] = torch.tensor(VEC_LENGTHS, dtype=torch.int32) + cfg.num_image_tokens
    for i in range(2):
        logits, cache = api.decode_step(cfg, params, tokens[:, S - 2 + i:S - 1 + i], cache)
        _close(logits, reference[key + f"/vdecode{i}"], tol, f"[B]-length decode {i}")
    _check_cache(reference, key + "/vcache_", cfg, cache, tol, "[B]-length cache")


def test_every_reference_architecture_loads():
    """All ten architecture ids of the reference load in the port, with a
    family `get_model` serves; unknown ids and families raise."""
    import repro.configs.base as ref_base
    assert sorted(arch_ids()) == sorted(ref_base.arch_ids())
    for arch in arch_ids():
        for cfg in (get_config(arch), get_smoke_config(arch)):
            assert cfg == _as_port(ref_base.get_config(arch) if cfg.name == arch
                                   else ref_base.get_smoke_config(arch))
            api = get_model(cfg)
            assert api.init_params.__module__.startswith("repro_torch.models.")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba3-1b")
    with pytest.raises(KeyError, match="unknown family"):
        get_model(get_smoke_config("mamba2-780m").with_(family="rnn"))


def _as_port(ref_cfg):
    import dataclasses
    from repro_torch.configs import ModelConfig
    return ModelConfig(**dataclasses.asdict(ref_cfg))
