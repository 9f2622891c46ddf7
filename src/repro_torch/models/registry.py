"""Family -> model implementation dispatch, and the random batches of a
config (twin of `repro/models/registry.py`)."""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import encdec, hybrid, ssm_lm, transformer, vlm
from .nn import ParamFactory


class ModelApi(NamedTuple):
    init_params: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


def _api(module) -> ModelApi:
    return ModelApi(module.init_params, module.forward, module.init_cache, module.prefill,
                    module.decode_step)


_FAMILIES: Dict[str, ModelApi] = {
    "dense": _api(transformer), "moe": _api(transformer), "ssm": _api(ssm_lm),
    "hybrid": _api(hybrid), "encdec": _api(encdec), "vlm": _api(vlm),
}


def get_model(cfg) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}; known: {sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family]


def init_all(cfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random parameters for a config, drawn on `device` from a generator
    seeded with `seed` (on the meta device: their shapes and dtypes)."""
    dev = resolve_device(device)
    api = get_model(cfg)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    return api.init_params(cfg, ParamFactory(gen, dev, cfg.torch_dtype))


def input_specs(cfg, kind: str, batch: int, seq_len: int, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch for one (kind, batch, seq_len) shape, the numbers of the
    reference's `input_specs(cfg, ShapeSpec(.., seq_len, batch, kind),
    mode="init", seed=seed)`: drawn in the same order from numpy's generator
    seeded with `seed` (tokens uniform in [0, vocab), embeddings normal x
    0.02 in the config's dtype).

    decode -> {tokens [B, 1]}; prefill -> {tokens} plus, for vlm,
    patch_embeds [B, num_image_tokens, d] (tokens then [B, S - n_img]) and,
    for encdec, enc_embeds [B, S, d]; train adds labels [B, S].  On the meta
    device nothing is drawn: the tensors have the shapes and dtypes alone."""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"kind {kind!r}: train, prefill or decode")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B, S, V = batch, seq_len, cfg.vocab_size

    def ints(shape):
        if dev.type == "meta":
            return torch.empty(shape, dtype=torch.int32, device=dev)
        return torch.from_numpy(rng.integers(0, V, size=shape).astype(np.int32)).to(dev)

    def floats(shape):
        if dev.type == "meta":
            return torch.empty(shape, dtype=cfg.torch_dtype, device=dev)
        x = torch.from_numpy(rng.standard_normal(shape) * 0.02)
        return x.to(dtype=cfg.torch_dtype).to(dev)

    if kind == "decode":
        return {"tokens": ints((B, 1))}
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        n_img = cfg.num_image_tokens
        out["tokens"] = ints((B, S - n_img))
        out["patch_embeds"] = floats((B, n_img, cfg.d_model))
    elif cfg.family == "encdec":
        out["tokens"] = ints((B, S))
        out["enc_embeds"] = floats((B, S, cfg.d_model))
    else:
        out["tokens"] = ints((B, S))
    if kind == "train":
        out["labels"] = ints((B, S))
    return out
