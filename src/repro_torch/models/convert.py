"""The reference's parameters carried into the port's layout.

`params_from_reference(cfg, flat)` takes `{path: array}` as
`repro.models.nn.paths_from_tree` gives it for the reference's
`init_params` (the dense family's empty "prefix" list dropped first) and
returns the port's parameter dict: the stacked [L, ...] leaves under
"blocks/" split into one dict per layer.  Weights keep the reference's
[in, out] layout; values are cast to the config's dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device


def params_from_reference(cfg, flat: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    out: Dict[str, Any] = {"blocks": [{} for _ in range(cfg.num_layers)]}
    for path, value in flat.items():
        t = torch.from_numpy(np.asarray(value, np.float32)).to(device=dev, dtype=cfg.torch_dtype)
        top, *rest = path.split("/")
        if top == "blocks":
            if t.shape[0] != cfg.num_layers:
                raise ValueError(f"{path}: leading dim {t.shape[0]} != {cfg.num_layers} layers")
            for layer, leaf in zip(out["blocks"], t):
                _set(layer, rest, leaf.clone())
        else:
            _set(out, [top, *rest], t)
    return out


def _set(tree: Dict[str, Any], parts, value) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value
