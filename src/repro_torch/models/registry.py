"""Family -> model implementation dispatch (twin of `repro/models/registry.py`).

The port serves the dense and moe families; the other families raise
`NotImplementedError` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from ..device import resolve_device
from . import transformer
from .nn import ParamFactory


class ModelApi(NamedTuple):
    init_params: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


_LM = ModelApi(transformer.init_params, transformer.forward, transformer.init_cache,
               transformer.prefill, transformer.decode_step)
_FAMILIES: Dict[str, ModelApi] = {"dense": _LM, "moe": _LM}
_NOT_PORTED = {
    "ssm": "queue 1 item 11c (ssm, hybrid, encdec and vlm)",
    "hybrid": "queue 1 item 11c (ssm, hybrid, encdec and vlm)",
    "encdec": "queue 1 item 11c (ssm, hybrid, encdec and vlm)",
    "vlm": "queue 1 item 11c (ssm, hybrid, encdec and vlm)",
}


def get_model(cfg) -> ModelApi:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP.md {_NOT_PORTED[cfg.family]}")
    return _FAMILIES[cfg.family]


def init_all(cfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random parameters for a config, drawn on `device` from a generator seeded with `seed`."""
    dev = resolve_device(device)
    api = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return api.init_params(cfg, ParamFactory(gen, dev, cfg.torch_dtype))
