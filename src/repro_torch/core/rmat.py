"""Vectorized R-MAT edge generation (paper Alg. 5), twin of `repro.core.rmat`.

Every edge is a pure function of (seed, global edge index): a counter-based
hash RNG, so any block of edges can be generated anywhere, bit-exact with the
reference.  The work is the `rmat_edges` kernel (`kernels/rmat.py`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.ref import counter_uniform_u32, mix32  # noqa: F401
from ..kernels.rmat import rmat_edges
from .types import GraphConfig


def rmat_edge_block(cfg: GraphConfig, start: int, count: int,
                    device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 (src, dst) of the `count` edges with global ids [start, start+count)."""
    return rmat_edges(cfg, start, count, device)


def degree_bias_stat(src: torch.Tensor, dst: torch.Tensor, n: int) -> float:
    """Fraction of edge endpoints landing in the lowest n/16 vertex ids.

    R-MAT with (a,b,c,d)=(.57,.19,.19,.05) concentrates mass on small ids,
    the bias the paper removes by shuffling (its section I): raw R-MAT output
    is biased, relabeled output is not."""
    lo = n // 16
    cnt = int((src < lo).sum()) + int((dst < lo).sum())
    return float(cnt) / float(2 * src.shape[0])
