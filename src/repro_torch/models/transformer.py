"""Decoder-only LM: dense GQA, MoE (qwen3), MLA + MoE (deepseek) (twin of
`repro/models/transformer.py`).

The reference stacks its layers along a leading dim and runs them with
`lax.scan`, keeping deepseek's `first_k_dense` prefix (dense MLP layers
before the MoE ones) apart in `params["prefix"]`.  The port keeps one
parameter dict per layer in `params["blocks"]`, the prefix layers first
(`models/convert.py` carries the reference's `prefix/<i>` and stacked
`blocks` leaves there), and runs them in a Python loop.  The decode cache
stacks all L layers, prefix included, with one `length` for all (the
reference's copies are always equal): GQA {"k", "v": [L, B, Hkv, max_len,
hd]}, MLA {"c_kv": [L, B, max_len, kv_lora_rank], "k_rope": [L, B, 1,
max_len, qk_rope_dim]}, "length" a 0-d int32 from `init_cache` or [B]
per-slot lengths in the serve engine.  Prefill and decode write the cache's
buffers in place (see `layers.py`).

The MoE aux outputs (lb_loss, z_loss, dropped) are summed over the layers in
f32, as the reference's `_accumulate` does; `forward` returns them, and
prefill and decode drop them, as the reference's do.  `forward_embeds` and
`prefill_embeds` start from embeddings instead of tokens (the vlm family
puts its image patches before the token embeddings); `init_attention`,
`init_mlp` and `zero_aux` serve the other families too.  Every entry point
takes the reference's optional `dist` (`models/nn.py::DistContext`), which
reaches the MoE layers' dispatch; attention keeps the port's own route.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from .layers import (attention, decode_positions, embed, init_mla, mla_attention, mlp, rmsnorm,
                     unembed)
from .moe import init_moe, moe_ffn
from .nn import DistContext, ParamFactory

AUX_KEYS = ("lb_loss", "z_loss", "dropped")


def zero_aux(device) -> Dict[str, torch.Tensor]:
    """The aux outputs of a model without MoE layers: f32 zeros."""
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in AUX_KEYS}


def _is_moe_layer(cfg, layer: int) -> bool:
    return cfg.num_experts > 0 and layer >= cfg.first_k_dense


def init_attention(f: ParamFactory, cfg) -> Dict[str, Any]:
    d, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads
    attn = {
        "wq": f.param((d, Hq * hd)),
        "wk": f.param((d, Hkv * hd)),
        "wv": f.param((d, Hkv * hd)),
        "wo": f.param((Hq * hd, d)),
    }
    if cfg.qkv_bias:
        attn.update(bq=f.param((Hq * hd,), "zeros"), bk=f.param((Hkv * hd,), "zeros"),
                    bv=f.param((Hkv * hd,), "zeros"))
    return attn


def init_mlp(f: ParamFactory, cfg) -> Dict[str, Any]:
    d = cfg.d_model
    return {"w_gate": f.param((d, cfg.d_ff)), "w_up": f.param((d, cfg.d_ff)),
            "w_down": f.param((cfg.d_ff, d))}


def _init_block(f: ParamFactory, cfg, moe: bool) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": {"scale": f.param((d,), "ones")},
        "ln2": {"scale": f.param((d,), "ones")},
        "attn": init_mla(f, cfg) if cfg.kv_lora_rank else init_attention(f, cfg),
        "ffn": init_moe(f, cfg) if moe else init_mlp(f, cfg),
    }


def init_params(cfg, f: ParamFactory) -> Dict[str, Any]:
    return {
        "embed": {"tokens": f.param((cfg.vocab_padded, cfg.d_model), "embed", scale=0.02)},
        "blocks": [_init_block(f, cfg, _is_moe_layer(cfg, l)) for l in range(cfg.num_layers)],
        "ln_f": {"scale": f.param((cfg.d_model,), "ones")},
        "unembed": {"w": f.param((cfg.d_model, cfg.vocab_padded))},
    }


def _block(p, cfg, x, positions, cache, moe: bool, dist: Optional[DistContext] = None):
    """One layer: (x, updated cache or None, MoE aux or None)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.kv_lora_rank:
        a, new_cache = mla_attention(p["attn"], cfg, h, positions, kv_cache=cache)
    else:
        a, new_cache = attention(p["attn"], cfg, h, positions, kv_cache=cache)
    x = x + a
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if moe:
        f, aux = moe_ffn(p["ffn"], cfg, h, dist)
    else:
        f, aux = mlp(p["ffn"], h), None
    return x + f, new_cache, aux


def _layers(cfg, params, x, positions, cache=None, dist=None):
    """Every layer in turn; returns (x, aux summed over the MoE layers)."""
    total = zero_aux(x.device)
    for l, p_l in enumerate(params["blocks"]):
        layer = None
        if cache is not None:
            layer = {name: buf[l] for name, buf in cache.items() if name != "length"}
            layer["length"] = cache["length"]
        x, _, aux = _block(p_l, cfg, x, positions, layer, _is_moe_layer(cfg, l), dist)
        if aux is not None:
            total = {k: total[k] + aux[k] for k in AUX_KEYS}
    return x, total


def final_logits(cfg, params, x):
    """ln_f, then the f32 unembedding with the vocabulary padding masked."""
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params["unembed"], x, fp32=cfg.logits_fp32, valid_vocab=cfg.vocab_size)


def forward_embeds(cfg, params, x, dist: Optional[DistContext] = None):
    """Forward without a cache from embeddings x [B, S, d] -> (logits [B, S, V], aux)."""
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _layers(cfg, params, x, positions, dist=dist)
    return final_logits(cfg, params, x), aux


def forward(cfg, params, batch, dist: Optional[DistContext] = None):
    """Forward without a cache: tokens [B, S] -> (logits [B, S, V], aux)."""
    x = embed(params["embed"], batch["tokens"]).to(cfg.torch_dtype)
    return forward_embeds(cfg, params, x, dist)


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Decode cache of all L layers, zeros, length 0 (0-d int32)."""
    dev = resolve_device(device)
    L = cfg.num_layers
    if cfg.kv_lora_rank:
        shapes = {"c_kv": (L, batch, max_len, cfg.kv_lora_rank),
                  "k_rope": (L, batch, 1, max_len, cfg.qk_rope_dim)}
    else:
        shapes = dict.fromkeys(("k", "v"), (L, batch, cfg.num_kv_heads, max_len, cfg.hd))
    cache = {name: torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
             for name, shape in shapes.items()}
    cache["length"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


def _run_with_cache(cfg, params, x, cache, positions, last_only: bool, dist=None):
    S = x.shape[1]
    x, _ = _layers(cfg, params, x, positions, cache, dist)
    if last_only:
        x = x[:, -1:]  # unembed only the sampled position
    return final_logits(cfg, params, x), dict(cache, length=cache["length"] + S)


def prefill_embeds(cfg, params, x, cache, dist: Optional[DistContext] = None):
    """The prompt's embeddings x [B, S, d] into an empty cache.  Returns
    (last-position logits [B, 1, V], cache)."""
    positions = torch.arange(x.shape[1], device=x.device)
    return _run_with_cache(cfg, params, x, cache, positions, last_only=True, dist=dist)


def prefill(cfg, params, batch, cache, dist: Optional[DistContext] = None):
    """Process the prompt, filling the cache.  Returns (last-token logits [B,1,V], cache)."""
    x = embed(params["embed"], batch["tokens"]).to(cfg.torch_dtype)
    return prefill_embeds(cfg, params, x, cache, dist)


def decode_step(cfg, params, tokens, cache, dist: Optional[DistContext] = None):
    """One token per sequence.  tokens [B, 1].  Returns (logits [B, 1, V], cache)."""
    positions = decode_positions(cache["length"], tokens.shape[1])
    x = embed(params["embed"], tokens).to(cfg.torch_dtype)
    return _run_with_cache(cfg, params, x, cache, positions, last_only=False, dist=dist)
