"""Pure Mamba2 LM, the mamba2-780m family (twin of `repro/models/ssm_lm.py`):
attention-free, with O(1) decode state.

Parameters: one dict per layer in "layers" ({"ln", "mix"}; the reference
stacks them [L, ...], `models/convert.py` splits them).  The decode cache is
{"conv": [L, B, conv_ch, w - 1], "ssm": [L, B, H, P, N], "length": int32
0-d, or [B] in the serve engine}; max_len never appears.  Prefill and decode
write the new states into the cache's buffers in place (the reference
returns new ones) and return the same buffers with "length" + S.

`forward`, `prefill` and `decode_step` take the reference's optional
`dist` and leave it unused: in the reference it reaches only sharding
constraints.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .layers import embed, rmsnorm
from .ssm import init_layer_states, init_mamba2, mamba2_cached, mamba2_forward
from .transformer import final_logits, zero_aux


def init_params(cfg, f):
    d = cfg.d_model
    return {
        "embed": {"tokens": f.param((cfg.vocab_padded, d), "embed", scale=0.02)},
        "layers": [{"ln": {"scale": f.param((d,), "ones")}, "mix": init_mamba2(f, cfg)}
                   for _ in range(cfg.num_layers)],
        "ln_f": {"scale": f.param((d,), "ones")},
        "unembed": {"w": f.param((d, cfg.vocab_padded))},
    }


def forward(cfg, params, batch, dist=None):
    """tokens [B, S] -> (logits [B, S, V], zero aux)."""
    x = embed(params["embed"], batch["tokens"]).to(cfg.torch_dtype)
    for p_l in params["layers"]:
        x = x + mamba2_forward(p_l["mix"], cfg, rmsnorm(p_l["ln"], x, cfg.norm_eps))
    return final_logits(cfg, params, x), zero_aux(x.device)


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Zero states of all L layers, length 0 (max_len is not used)."""
    dev = resolve_device(device)
    return {**init_layer_states(cfg, batch, dev),
            "length": torch.zeros((), dtype=torch.int32, device=dev)}


def _run(cfg, params, tokens, cache, step: bool):
    x = embed(params["embed"], tokens).to(cfg.torch_dtype)
    for l, p_l in enumerate(params["layers"]):
        h = rmsnorm(p_l["ln"], x, cfg.norm_eps)
        x = x + mamba2_cached(p_l["mix"], cfg, h, cache, l, step)
    return x, dict(cache, length=cache["length"] + tokens.shape[1])


def prefill(cfg, params, batch, cache, dist=None):
    """The prompt from the cache's states.  Returns (last-token logits [B, 1, V], cache)."""
    x, cache = _run(cfg, params, batch["tokens"], cache, step=False)
    return final_logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg, params, tokens, cache, dist=None):
    """One token per sequence, tokens [B, 1].  Returns (logits [B, 1, V], cache)."""
    x, cache = _run(cfg, params, tokens, cache, step=True)
    return final_logits(cfg, params, x), cache
