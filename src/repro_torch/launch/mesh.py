"""One H100's roofline constants and the reference's mesh shapes (counterpart
of `repro/launch/mesh.py`).

The constants are one NVIDIA H100 SXM's published peaks (NVIDIA's data
sheet, https://www.nvidia.com/en-us/data-center/h100/, dense rates without
sparsity, at the full 700 W power limit; a card set below it runs slower
under load).  The reference's TPU v5e constants have no place here.  A
kernel's roofline has no interconnect term: no ICI, and NVLink only between
cards, so `launch/roofline.py` takes no link bandwidth.  The graph path
copies between cards when its shards lie on several
(`distributed/collectives.py::CardExchange`).

The reference builds a (data 16, model 16) device mesh, or (pod 2, data 16,
model 16) across two pods.  On one card a mesh's shards are leading
dimensions of one device's tensors, so a mesh is its axis sizes:
`make_production_mesh` returns the dict that
`distributed/sharding.py::make_dist` takes.  `make_graph_mesh` gives the
graph path's placement: its nb shards over 1 or D cards, consecutive
shards on each, in one process (`core/pipeline.py::generate`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..distributed.collectives import Cards, place

MEM_BYTES_PER_S = 3.35e12          # HBM3 bandwidth
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
# Integer operations per SM and clock: the four schedulers issue 4 x 32
# thread-instructions, split between the INT32 pipe (64 lanes: shifts, logic,
# adds, compares) and the FP32 pipe (128 lanes), which runs the integer
# multiply-adds.  64 alone is beaten by the measured rmat_edges kernel.  A
# kernel's operations are its per-thread SASS instructions per item
# (`kernels/sass.py`); times the card's SMs and clock this is its peak.
INT_OPS_PER_SM_CLK = 128
MEM_BYTES = 80e9                   # device memory of one card


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh as axis sizes."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_graph_mesh(n_shards: Optional[int] = None, devices: Sequence = ("cuda",)) -> Cards:
    """The graph path's placement of nb shards (the reference's 1-D mesh
    over nb devices; one shard when not given) over `devices`: shard i on
    devices[i // (nb / D)]."""
    return place(n_shards or 1, devices)
