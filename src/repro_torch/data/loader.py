"""Graph -> LM-batch loader with deterministic restart (twin of
`repro.data.loader`'s `WalkLoader`).

Batches are a pure function of (graph, loader config, step): batch(step)
derives its walker ids from the step index, so a job restored from a step-N
checkpoint consumes exactly the batches it would have seen without the
failure, and the loader has no state to checkpoint.  The walks are sampled
on the loader's device (`csr_walks` over the CSR held there) and the batches
are tensors on that device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.csr import CSRShards, csr_global
from ..core.hostgen import MASK32
from ..core.types import GraphConfig
from ..device import resolve_device
from .walks import csr_walks, start_vertex, walks_to_tokens


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    batch_size: int = 8
    seq_len: int = 128
    vocab: int = 512
    seed: int = 0


class WalkLoader:
    """Deterministic batches of random-walk token sequences."""

    def __init__(self, graph_cfg: GraphConfig, csr: Optional[CSRShards], cfg: LoaderConfig,
                 host_csr: Optional[Tuple[np.ndarray, np.ndarray]] = None, device="cuda"):
        # `host_csr` takes an assembled (offv, adjv) pair in place of the
        # CSRShards: walks follow the order of each CSR row, so a parity
        # comparison must pin the layout.
        self.gcfg = graph_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        if host_csr is not None:
            offv, adjv = (torch.as_tensor(np.asarray(a)) for a in host_csr)
        else:
            offv, adjv = csr_global(csr, graph_cfg)   # assembled where the CSR lies
        self.offv = offv.to(self.device, torch.int64)
        self.adjv = adjv.to(self.device)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """{tokens [B, S], labels [B, S]} (int32) for train step `step` (a pure function)."""
        c = self.cfg
        wid = (step * c.batch_size
               + torch.arange(c.batch_size, dtype=torch.int64, device=self.device)) & MASK32
        starts = start_vertex(c.seed, wid, self.gcfg.n, dtype=torch.int64)
        walks = csr_walks(self.offv, self.adjv, starts, c.seq_len, c.seed, n=self.gcfg.n,
                          walker_ids=wid)
        tokens, labels = walks_to_tokens(walks, c.vocab)
        return {"tokens": tokens.contiguous(), "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
