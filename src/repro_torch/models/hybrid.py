"""Zamba2-style hybrid (twin of `repro/models/hybrid.py`): a Mamba2 backbone
and ONE shared attention + MLP block.

The L mamba layers run in n_groups = L / shared_attn_every groups; after
each group the same transformer block (one weight copy) is applied, so the
block has n_groups call sites, and each site keeps its own KV cache (the
weights are shared, the activations are not).  As in the reference, the
shared block has no per-site LoRA adapters and does not take the original
embedding.

Parameters: "mamba", one dict per layer in order (the reference stacks them
[n_groups, every, ...]), and "shared" {"ln1", "attn", "ln2", "mlp"}.  The
decode cache is {"conv": [L, B, conv_ch, w - 1], "ssm": [L, B, H, P, N],
"k", "v": [n_groups, B, Hkv, max_len, hd], "length"}: one length for all
sites (the reference's n_groups copies are always equal), int32 0-d or [B]
per slot in the serve engine; decode positions come from it.  Prefill and
decode write states and K/V into the cache's buffers in place.

`forward`, `prefill` and `decode_step` take the reference's optional
`dist` and leave it unused: in the reference it reaches only sharding
constraints.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .layers import attention, decode_positions, embed, mlp, rmsnorm
from .ssm import init_layer_states, init_mamba2, mamba2_cached, mamba2_forward
from .transformer import final_logits, init_attention, init_mlp, zero_aux


def _groups(cfg):
    every = cfg.shared_attn_every
    if cfg.num_layers % every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers in groups of {every}")
    return cfg.num_layers // every, every


def init_params(cfg, f):
    _groups(cfg)
    d = cfg.d_model
    return {
        "embed": {"tokens": f.param((cfg.vocab_padded, d), "embed", scale=0.02)},
        "mamba": [{"ln": {"scale": f.param((d,), "ones")}, "mix": init_mamba2(f, cfg)}
                  for _ in range(cfg.num_layers)],
        "shared": {"ln1": {"scale": f.param((d,), "ones")}, "attn": init_attention(f, cfg),
                   "ln2": {"scale": f.param((d,), "ones")}, "mlp": init_mlp(f, cfg)},
        "ln_f": {"scale": f.param((d,), "ones")},
        "unembed": {"w": f.param((d, cfg.vocab_padded))},
    }


def _shared_block(p, cfg, x, positions, cache=None):
    a, _ = attention(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps), positions,
                     kv_cache=cache)
    x = x + a
    return x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps))


def forward(cfg, params, batch, dist=None):
    """tokens [B, S] -> (logits [B, S, V], zero aux)."""
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens).to(cfg.torch_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    every = _groups(cfg)[1]
    for l, p_l in enumerate(params["mamba"]):
        x = x + mamba2_forward(p_l["mix"], cfg, rmsnorm(p_l["ln"], x, cfg.norm_eps))
        if (l + 1) % every == 0:
            x = _shared_block(params["shared"], cfg, x, positions)
    return final_logits(cfg, params, x), zero_aux(x.device)


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Zero mamba states of all L layers and K/V of every site, length 0."""
    dev = resolve_device(device)
    n_groups, _ = _groups(cfg)
    kv = (n_groups, batch, cfg.num_kv_heads, max_len, cfg.hd)
    return {**init_layer_states(cfg, batch, dev),
            "k": torch.zeros(kv, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(kv, dtype=cfg.torch_dtype, device=dev),
            "length": torch.zeros((), dtype=torch.int32, device=dev)}


def _run_cached(cfg, params, tokens, cache, positions):
    x = embed(params["embed"], tokens).to(cfg.torch_dtype)
    step = tokens.shape[1] == 1
    every = _groups(cfg)[1]
    for l, p_l in enumerate(params["mamba"]):
        h = rmsnorm(p_l["ln"], x, cfg.norm_eps)
        x = x + mamba2_cached(p_l["mix"], cfg, h, cache, l, step)
        if (l + 1) % every == 0:
            site = l // every
            x = _shared_block(params["shared"], cfg, x, positions,
                              {"k": cache["k"][site], "v": cache["v"][site],
                               "length": cache["length"]})
    return x, dict(cache, length=cache["length"] + tokens.shape[1])


def prefill(cfg, params, batch, cache, dist=None):
    """The prompt into an empty cache.  Returns (last-token logits [B, 1, V], cache)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, cache = _run_cached(cfg, params, tokens, cache, positions)
    return final_logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg, params, tokens, cache, dist=None):
    """One token per sequence, tokens [B, 1].  Returns (logits [B, 1, V], cache)."""
    positions = decode_positions(cache["length"], tokens.shape[1])
    x, cache = _run_cached(cfg, params, tokens, cache, positions)
    return final_logits(cfg, params, x), cache
