"""Configuration and notation of the generator (twin of `repro.core.types`).

  n  = 2**scale          number of vertices
  m  = n * edge_factor   number of generated (directed) edges
  nb = number of shards  (the paper's "compute nodes"; a leading dimension here)
  B  = n / nb            vertices owned by each shard; owner(v) = v // B
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

RMAT_A = 0.57
RMAT_B = 0.19
RMAT_C = 0.19
RMAT_D = 0.05
DEFAULT_EDGE_FACTOR = 16

_VERTEX_DTYPES = {"int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """The reference `GraphConfig`'s fields: those the device pipeline reads
    and those of the disk tier (`core/external.py`, `core/phases.py`), with
    the reference's defaults.  The disk tier's fields are documented where
    `phases.PlainCfg` mirrors them."""

    scale: int = 16
    edge_factor: int = DEFAULT_EDGE_FACTOR
    seed: int = 0x5EED_1234
    a: float = RMAT_A
    b: float = RMAT_B
    c: float = RMAT_C
    d: float = RMAT_D
    nb: int = 1
    capacity_factor: float = 2.0
    shuffle_rounds: int = 0               # 0 = auto = ceil(log_nb(n)) (paper)
    relabel_variant: str = "ring"         # "ring" | "alltoall"
    csr_variant: str = "sorted"           # "sorted" | "scatter"
    vertex_dtype: torch.dtype = torch.int32
    feistel_rounds: int = 4
    # --- disk tier ----------------------------------------------------------
    chunk_edges: int = 1 << 16            # edges per in-memory chunk (the paper's mmc)
    shuffle_variant: str = "device"       # "device" | "external" | "recompute"
    perm_family: str = "shuffle"          # "shuffle" | "feistel" (recompute implies feistel)
    merge_block_rows: int = 0
    merge_fanin: int = 64
    io_overlap: bool = True
    trace: bool = False
    pooled_cascade: bool = False
    checkpoint_phases: bool = False
    transport: str = "fs"                 # "fs" | "socket"
    peer_addrs: Optional[Tuple[str, ...]] = None
    keep_phase_stores: bool = False

    @classmethod
    def from_reference(cls, obj) -> "GraphConfig":
        """Read the fields of any object shaped like the reference's config.

        No isinstance check and no jax import: fields are read by name, and
        `vertex_dtype` is mapped by its dtype name (`jnp.int32` -> int32).
        """
        kw = {}
        for f in dataclasses.fields(cls):
            if not hasattr(obj, f.name):
                continue
            value = getattr(obj, f.name)
            if f.name == "vertex_dtype":
                name = np.dtype(value).name
                if name not in _VERTEX_DTYPES:
                    raise ValueError(f"vertex_dtype {name} is not supported by the port")
                value = _VERTEX_DTYPES[name]
            kw[f.name] = value
        return cls(**kw)

    @property
    def n(self) -> int:
        return 1 << self.scale

    @property
    def m(self) -> int:
        return self.n * self.edge_factor

    @property
    def bucket_size(self) -> int:
        if self.n % self.nb:
            raise ValueError(f"nb={self.nb} must divide n={self.n}")
        return self.n // self.nb

    @property
    def edges_per_shard(self) -> int:
        if self.m % self.nb:
            raise ValueError(f"nb={self.nb} must divide m={self.m}")
        return self.m // self.nb

    @property
    def rounds(self) -> int:
        """Shuffle rounds: the paper's log_nb(n) (Alg. 4 line 8)."""
        if self.shuffle_rounds > 0:
            return self.shuffle_rounds
        if self.nb <= 1:
            return 1
        return max(1, int(math.ceil(math.log(self.n) / math.log(self.nb))))

    def with_(self, **kw) -> "GraphConfig":
        return dataclasses.replace(self, **kw)


def owner_of(v: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """Range-partition owner: owner(v) = v // B (the paper's RP(n, nb))."""
    return torch.div(v, bucket_size, rounding_mode="floor")


def quadrant_thresholds(cfg: GraphConfig) -> Tuple[int, int, int]:
    """uint32 cut points of one R-MAT level: P(src bit), P(dst bit | src 0/1)."""
    two32 = float(1 << 32)
    t_src = int((cfg.c + cfg.d) * two32)
    t_dst0 = int((cfg.b / (cfg.a + cfg.b)) * two32)
    t_dst1 = int((cfg.d / (cfg.c + cfg.d)) * two32)
    return t_src, t_dst0, t_dst1
