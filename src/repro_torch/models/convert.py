"""The reference's parameters carried into the port's layout.

`params_from_reference(cfg, flat)` takes `{path: array}` as
`repro.models.nn.paths_from_tree` gives it for the reference's
`init_params`, with the unstacked "prefix" layers (deepseek's
`first_k_dense` dense layers) under "prefix/<i>/...", and returns the
port's parameter dict.  The reference stacks its layers along leading
dimensions; the port keeps one dict per layer in a list:

  * dense, moe, vlm: "blocks" [L - first_k_dense, ...] -> "blocks", the
    prefix layers first;
  * ssm: "layers" [L, ...] -> "layers";
  * hybrid: "mamba" [n_groups, every, ...] -> "mamba", L layers in order
    ("shared" stays one dict);
  * encdec: "enc" [Le, ...] -> "enc", "dec" [Ld, ...] -> "dec".

Weights keep the reference's [in, out] layout; values are cast to the
config's dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device


def _stacked(cfg) -> Dict[str, tuple]:
    """{top-level key: leading dims of its stacked leaves} of the family."""
    if cfg.family == "ssm":
        return {"layers": (cfg.num_layers,)}
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        return {"mamba": (cfg.num_layers // every, every)}
    if cfg.family == "encdec":
        return {"enc": (cfg.encoder_layers,), "dec": (cfg.num_layers,)}
    n_prefix = cfg.first_k_dense if cfg.num_experts else 0
    return {"blocks": (cfg.num_layers - n_prefix,)}


def params_from_reference(cfg, flat: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    n_prefix = cfg.first_k_dense if cfg.num_experts else 0
    stacked = _stacked(cfg)
    out: Dict[str, Any] = {}
    for top, lead in stacked.items():
        out[top] = [{} for _ in range(int(np.prod(lead)) + (n_prefix if top == "blocks" else 0))]
    for path, value in flat.items():
        t = torch.from_numpy(np.asarray(value, np.float32)).to(device=dev, dtype=cfg.torch_dtype)
        top, *rest = path.split("/")
        if top == "prefix":
            i, *rest = rest
            if not 0 <= int(i) < n_prefix:
                raise ValueError(f"{path}: prefix layer {i} of {n_prefix}")
            _set(out["blocks"][int(i)], rest, t)
        elif top in stacked:
            lead = stacked[top]
            if tuple(t.shape[:len(lead)]) != lead:
                raise ValueError(f"{path}: leading dims {tuple(t.shape[:len(lead)])} != "
                                 f"{lead} stacked layers")
            layers = out[top][n_prefix:] if top == "blocks" else out[top]
            for layer, leaf in zip(layers, t.reshape(-1, *t.shape[len(lead):])):
                _set(layer, rest, leaf.clone())
        else:
            _set(out, [top, *rest], t)
    return out


def _set(tree: Dict[str, Any], parts, value) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value
