"""Decoder-only dense LM (twin of the dense family of `repro/models/transformer.py`).

The reference stacks its layers along a leading dim and runs them with
`lax.scan`; the port keeps one parameter dict per layer in
`params["blocks"]` and runs them in a Python loop.  The decode cache keeps
the stacked layout, {"k", "v": [L, B, Hkv, max_len, hd], "length"}, with one
`length` for all layers (the reference's [L] copies are always equal): a
0-d int32 from `init_cache`, or [B] per-slot lengths in the serve engine.
Prefill and decode write the cache's buffers in place (see `layers.py`).

MoE (`num_experts > 0`, `first_k_dense`) and MLA (`kv_lora_rank`) are not
ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..device import resolve_device
from .layers import attention, decode_positions, embed, mlp, rmsnorm, unembed
from .nn import ParamFactory


def check_dense(cfg) -> None:
    if cfg.num_experts or cfg.first_k_dense or cfg.kv_lora_rank:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA are not ported yet (ROADMAP.md queue 1 item 11b)")


def _init_block(f: ParamFactory, cfg) -> Dict[str, Any]:
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
    return {
        "ln1": {"scale": f.param((d,), "ones")},
        "ln2": {"scale": f.param((d,), "ones")},
        "attn": attn,
        "ffn": {"w_gate": f.param((d, cfg.d_ff)), "w_up": f.param((d, cfg.d_ff)),
                "w_down": f.param((cfg.d_ff, d))},
    }


def init_params(cfg, f: ParamFactory) -> Dict[str, Any]:
    check_dense(cfg)
    return {
        "embed": {"tokens": f.param((cfg.vocab_padded, cfg.d_model), "embed", scale=0.02)},
        "blocks": [_init_block(f, cfg) for _ in range(cfg.num_layers)],
        "ln_f": {"scale": f.param((cfg.d_model,), "ones")},
        "unembed": {"w": f.param((cfg.d_model, cfg.vocab_padded))},
    }


def _block(p, cfg, x, positions, cache=None):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, new_cache = attention(p["attn"], cfg, h, positions, kv_cache=cache)
    x = x + a
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h), new_cache


def _logits(cfg, params, x):
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params["unembed"], x, fp32=cfg.logits_fp32, valid_vocab=cfg.vocab_size)


def forward(cfg, params, batch) -> torch.Tensor:
    """Forward without a cache: tokens [B, S] -> logits [B, S, V].  (The
    reference also returns the MoE aux losses, always zero for dense.)"""
    check_dense(cfg)
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens).to(cfg.torch_dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for p_l in params["blocks"]:
        x, _ = _block(p_l, cfg, x, positions)
    return _logits(cfg, params, x)


def init_cache(cfg, batch: int, max_len: int, device="cuda") -> Dict[str, torch.Tensor]:
    """Decode cache: k/v [L, B, Hkv, max_len, hd] zeros, length 0 (0-d int32)."""
    check_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "length": torch.zeros((), dtype=torch.int32, device=dev)}


def _run_with_cache(cfg, params, tokens, cache, positions, last_only: bool):
    check_dense(cfg)
    x = embed(params["embed"], tokens).to(cfg.torch_dtype)
    length = cache["length"]
    for l, p_l in enumerate(params["blocks"]):
        layer = {"k": cache["k"][l], "v": cache["v"][l], "length": length}
        x, _ = _block(p_l, cfg, x, positions, layer)
    if last_only:
        x = x[:, -1:]  # unembed only the sampled position
    new_cache = {"k": cache["k"], "v": cache["v"], "length": length + tokens.shape[1]}
    return _logits(cfg, params, x), new_cache


def prefill(cfg, params, batch, cache):
    """Process the prompt, filling the cache.  Returns (last-token logits [B,1,V], cache)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    return _run_with_cache(cfg, params, tokens, cache, positions, last_only=True)


def decode_step(cfg, params, tokens, cache):
    """One token per sequence.  tokens [B, 1].  Returns (logits [B, 1, V], cache)."""
    positions = decode_positions(cache["length"], tokens.shape[1])
    return _run_with_cache(cfg, params, tokens, cache, positions, last_only=False)
