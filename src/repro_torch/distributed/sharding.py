"""The dispatch context of a mesh shape (twin of `repro/distributed/sharding.py`,
its `make_dist`).

The reference maps logical axes onto a (pod, data, model) device mesh.  On
one card that mesh's shards are leading dimensions of one device's tensors,
so `make_dist` keeps the mesh's sizes: `dp`, the product of the axes other
than "model", and `ep`, the "model" axis, over which the "alltoall" MoE
dispatch shards the experts (`models/moe.py`).  A mesh is given by its
axis sizes, as `launch/mesh.py::make_production_mesh` returns them.

The reference's `make_rules`, `param_shardings`, `cache_shardings`,
`batch_shardings` and `dp_size` have no counterpart: they map logical axes
onto mesh axes and place each array's blocks on devices (tensor, data and
FSDP sharding), and on one card every array lies whole on the one device.
`dp` here is the reference's `dp_size`.  For the same reason the reference
`make_dist`'s `shape` and `fsdp`, which only move those rules, are not
taken.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

from ..models.nn import DistContext

MESH_AXES = ("pod", "data", "model")
MOE_DISPATCH = ("dense", "alltoall")


def make_dist(cfg, mesh_shape: Mapping[str, int], *,
              moe_dispatch: Optional[str] = None) -> DistContext:
    """DistContext of a mesh shape, e.g. {"data": 1, "model": 4}.

    The dispatch defaults to the reference's: "alltoall" for a config with
    experts, else "dense".  An "alltoall" dispatch needs `num_experts` to be
    a multiple of the "model" axis (the reference's assert in `moe_ffn`)."""
    axes = dict(mesh_shape)
    unknown = sorted(set(axes) - set(MESH_AXES))
    if unknown or "model" not in axes:
        raise ValueError(f"mesh axes {sorted(axes)}: want 'model' and any of 'pod', 'data'")
    if any(int(n) < 1 for n in axes.values()):
        raise ValueError(f"mesh shape {axes}: every axis needs a size >= 1")
    ep = int(axes.pop("model"))
    dp = math.prod(int(n) for n in axes.values())
    if moe_dispatch is None:
        moe_dispatch = "alltoall" if cfg.num_experts else "dense"
    if moe_dispatch not in MOE_DISPATCH:
        raise ValueError(f"moe_dispatch {moe_dispatch!r}: one of {MOE_DISPATCH}")
    if moe_dispatch == "alltoall" and cfg.num_experts % ep:
        raise ValueError(f"{cfg.num_experts} experts do not split over {ep} expert shards")
    return DistContext(dp=dp, ep=ep, moe_dispatch=moe_dispatch)
