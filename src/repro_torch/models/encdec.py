"""Encoder-decoder backbone, the seamless-m4t family (twin of
`repro/models/encdec.py`).

Encoder: bidirectional self-attention over precomputed frame embeddings
"enc_embeds" [B, Se, d_model] (the audio frontend is a stub, as in the
reference; `registry.input_specs` draws them).  Decoder: causal
self-attention, then cross-attention to the encoder output (queries not
roped, keys and values the encoder output's projections, no mask), then
the MLP.

Parameters: "enc" and "dec", one dict per layer (the reference stacks them
[Le, ...] and [Ld, ...]), "enc_ln_f", "embed", "ln_f", "unembed".  The
decode cache is {"k", "v": [Ld, B, Hkv, max_len, hd] (self-attention,
written in place as the dense family's), "cross_k", "cross_v": [Ld, B, Hkv,
Se, hd], "length"}.  `init_cache` holds no cross buffers: prefill adds the
encoder's K/V of exactly Se keys, computed once (cross-attention has no
mask, so a longer buffer's zero keys would take weight), and decode_step
needs a prefill first.

`forward`, `prefill` and `decode_step` take the reference's optional
`dist` and leave it unused: in the reference it reaches only sharding
constraints.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .layers import attend, attention, decode_positions, embed, mlp, rmsnorm, unembed
from .transformer import init_attention, init_mlp, zero_aux


def _init_layer(f, cfg, decoder: bool):
    d = cfg.d_model

    def norm():
        return {"scale": f.param((d,), "ones")}

    if not decoder:
        return {"ln1": norm(), "attn": init_attention(f, cfg), "ln2": norm(),
                "mlp": init_mlp(f, cfg)}
    return {"ln1": norm(), "self_attn": init_attention(f, cfg), "ln_x": norm(),
            "cross": init_attention(f, cfg), "ln2": norm(), "mlp": init_mlp(f, cfg)}


def init_params(cfg, f):
    d = cfg.d_model
    return {
        "enc": [_init_layer(f, cfg, False) for _ in range(cfg.encoder_layers)],
        "enc_ln_f": {"scale": f.param((d,), "ones")},
        "embed": {"tokens": f.param((cfg.vocab_padded, d), "embed", scale=0.02)},
        "dec": [_init_layer(f, cfg, True) for _ in range(cfg.num_layers)],
        "ln_f": {"scale": f.param((d,), "ones")},
        "unembed": {"w": f.param((d, cfg.vocab_padded))},
    }


def encode(cfg, params, enc_embeds):
    """Frame embeddings [B, Se, d] -> encoder output [B, Se, d]."""
    x = enc_embeds.to(cfg.torch_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for p_l in params["enc"]:
        a, _ = attention(p_l["attn"], cfg, rmsnorm(p_l["ln1"], x, cfg.norm_eps), positions,
                         causal=False)
        x = x + a
        x = x + mlp(p_l["mlp"], rmsnorm(p_l["ln2"], x, cfg.norm_eps))
    return rmsnorm(params["enc_ln_f"], x, cfg.norm_eps)


def _enc_kv(p_cross, cfg, enc_out):
    """One layer's cross K/V [B, Hkv, Se, hd] from the encoder output (not roped)."""
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.num_kv_heads, cfg.hd)
    k = (enc_out @ p_cross["wk"]).reshape(shape).transpose(1, 2).contiguous()
    v = (enc_out @ p_cross["wv"]).reshape(shape).transpose(1, 2).contiguous()
    return k, v


def _cross_attn(p, cfg, x, k, v):
    """x [B, S, d] attends, non-causally, to all Se encoder keys."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.hd).transpose(1, 2).contiguous()
    out = attend(q, k, v, causal=False)
    return out.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.hd) @ p["wo"]


def _decoder(cfg, params, tokens, enc_out, positions, cache=None):
    """Decoder layers.  With enc_out (forward, prefill) each layer's cross
    K/V come from it, else (decode) from the cache.  Returns (x after ln_f,
    the cross K/V of each layer)."""
    x = embed(params["embed"], tokens).to(cfg.torch_dtype)
    cross = []
    for l, p_l in enumerate(params["dec"]):
        self_cache = None if cache is None else {
            "k": cache["k"][l], "v": cache["v"][l], "length": cache["length"]}
        a, _ = attention(p_l["self_attn"], cfg, rmsnorm(p_l["ln1"], x, cfg.norm_eps), positions,
                         kv_cache=self_cache, causal=True)
        x = x + a
        if enc_out is not None:
            k, v = _enc_kv(p_l["cross"], cfg, enc_out)
        else:
            k, v = cache["cross_k"][l], cache["cross_v"][l]
        cross.append((k, v))
        x = x + _cross_attn(p_l["cross"], cfg, rmsnorm(p_l["ln_x"], x, cfg.norm_eps), k, v)
        x = x + mlp(p_l["mlp"], rmsnorm(p_l["ln2"], x, cfg.norm_eps))
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), cross


def _unembed(cfg, params, x):
    return unembed(params["unembed"], x, fp32=cfg.logits_fp32, valid_vocab=cfg.vocab_size)


def forward(cfg, params, batch, dist=None):
    """batch {enc_embeds [B, Se, d], tokens [B, Sd]} -> (logits [B, Sd, V], zero aux)."""
    tokens = batch["tokens"]
    enc_out = encode(cfg, params, batch["enc_embeds"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, _ = _decoder(cfg, params, tokens, enc_out, positions)
    return _unembed(cfg, params, x), zero_aux(x.device)


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Zero self-attention K/V of max_len positions, length 0 (prefill adds
    the cross K/V)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.hd)
    cache = {name: torch.zeros(shape, dtype=cfg.torch_dtype, device=dev) for name in ("k", "v")}
    cache["length"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


def prefill(cfg, params, batch, cache, dist=None):
    """Encode, then the decoder prompt into an empty cache; the cross K/V of
    every layer computed once here and added to the cache.  Returns (last-token logits [B, 1, V], cache)."""
    tokens = batch["tokens"]
    enc_out = encode(cfg, params, batch["enc_embeds"])
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, cross = _decoder(cfg, params, tokens, enc_out, positions, cache)
    cache = dict(cache, cross_k=torch.stack([k for k, _ in cross]),
                 cross_v=torch.stack([v for _, v in cross]),
                 length=cache["length"] + tokens.shape[1])
    return _unembed(cfg, params, x[:, -1:]), cache


def decode_step(cfg, params, tokens, cache, dist=None):
    """One token per sequence, tokens [B, 1], against the cached cross K/V.
    Returns (logits [B, 1, V], cache)."""
    positions = decode_positions(cache["length"], tokens.shape[1])
    x, _ = _decoder(cfg, params, tokens, None, positions, cache)
    return _unembed(cfg, params, x), dict(cache, length=cache["length"] + tokens.shape[1])
