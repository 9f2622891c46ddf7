"""The reference's parameters carried into the port's layout.

`params_from_reference(cfg, flat)` takes `{path: array}` as
`repro.models.nn.paths_from_tree` gives it for the reference's
`init_params`, with the unstacked "prefix" layers (deepseek's
`first_k_dense` dense layers) under "prefix/<i>/...", and returns the
port's parameter dict: one dict per layer in "blocks", the prefix layers
first, then the stacked [L - first_k_dense, ...] leaves under "blocks/"
split by layer.  Weights keep the reference's [in, out] layout; values are
cast to the config's dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device


def params_from_reference(cfg, flat: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    n_prefix = cfg.first_k_dense if cfg.num_experts else 0
    out: Dict[str, Any] = {"blocks": [{} for _ in range(cfg.num_layers)]}
    for path, value in flat.items():
        t = torch.from_numpy(np.asarray(value, np.float32)).to(device=dev, dtype=cfg.torch_dtype)
        top, *rest = path.split("/")
        if top == "prefix":
            i, *rest = rest
            if not 0 <= int(i) < n_prefix:
                raise ValueError(f"{path}: prefix layer {i} of {n_prefix}")
            _set(out["blocks"][int(i)], rest, t)
        elif top == "blocks":
            if t.shape[0] != cfg.num_layers - n_prefix:
                raise ValueError(f"{path}: leading dim {t.shape[0]} != "
                                 f"{cfg.num_layers - n_prefix} stacked layers")
            for layer, leaf in zip(out["blocks"][n_prefix:], t):
                _set(layer, rest, leaf.clone())
        else:
            _set(out, [top, *rest], t)
    return out


def _set(tree: Dict[str, Any], parts, value) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value
