"""Parameter initialisers and the dispatch context (twin of
`repro/models/nn.py::ParamFactory.param` and `DistContext`).

Numbers come from an explicit `torch.Generator` on the target device, so they
differ from the reference's `jax.random` ones; parity tests carry the
reference's parameters across with `models/convert.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DistContext:
    """The reference mesh's axis sizes, threaded through the model entry points.

    On one card the mesh's shards are leading dimensions of one device's
    tensors, so what the model code needs of the reference's `DistContext`
    is the sizes: `dp`, the product of every axis but "model" (the batch
    shards), and `ep`, the "model" axis (the expert shards of the
    "alltoall" MoE dispatch).  `distributed/sharding.py::make_dist` builds
    one from a mesh shape.  The reference's `mesh`, `rules`, `spec`,
    `sharding` and `shard` (sharding constraints on a device mesh) have no
    counterpart on one device, nor has its `attn_mode`: attention keeps the
    port's own route.
    """

    dp: int = 1
    ep: int = 1
    moe_dispatch: str = "dense"    # "dense" | "alltoall" (expert parallel over ep shards)


class ParamFactory:
    """Creates parameters of one dtype on one device from one generator (on
    the meta device, shapes only: no generator, no numbers)."""

    def __init__(self, generator: Optional[torch.Generator], device, dtype: torch.dtype):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def param(self, shape: Tuple[int, ...], init: str = "normal", scale: float = 1.0):
        """`normal`: std scale / sqrt(fan_in), fan_in = shape[-2] (shape[-1] for
        a vector); `embed`: std `scale`; `zeros`; `ones`.  Drawn in f32, then
        cast to the factory's dtype."""
        if self.device.type == "meta":
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        if init in ("normal", "embed"):
            std = scale
            if init == "normal":
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                std = scale / (fan_in ** 0.5)
            x = torch.randn(shape, generator=self.generator, device=self.device,
                            dtype=torch.float32)
            return x.mul_(std).to(self.dtype)
        if init == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        raise ValueError(init)
