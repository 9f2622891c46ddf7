"""Graph -> LM-batch loaders with deterministic restart (twin of
`repro.data.loader`).

Batches are a pure function of (graph, loader config, step): batch(step)
derives its walker ids from the step index, so a job restored from a step-N
checkpoint consumes exactly the batches it would have seen without the
failure, and the loader has no state to checkpoint.  Two loaders share that
contract, and both give tensors on their device:

  WalkLoader          samples each batch on the loader's device (`csr_walks`
                      over the CSR held there);
  ExternalWalkLoader  streams batches out of a sharded `external_walks`
                      corpus (per-bucket shard files + manifest) built from
                      the disk tier's CSR bucket files; rows are gathered
                      across the shard memmaps on the host.
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
from .walks import csr_walks, external_walks, start_vertex, walks_to_tokens


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


class ExternalWalkLoader:
    """Deterministic walk-token batches from an out-of-core SHARDED corpus.

    Builds (or, with checkpoint=True, resumes) an external_walks corpus of
    `num_walkers` walks over the CSR bucket files in `workdir`, then serves
    batch(step) as rows [step*B : (step+1)*B) of the sharded corpus (mod W)
    — the same pure-function-of-step contract as WalkLoader, with the CSR
    on disk the whole time.  The corpus is per-bucket shard files + a
    manifest (core/corpus.py); batches gather rows across shard memmaps, so
    no host ever holds the whole corpus.  Walk length is seq_len (tokens
    drop the last vertex's label shift, exactly like WalkLoader).  The
    corpus's frontier partitions and the batches are on `device`.

    `corpus_manifest` streams batches straight from an existing manifest,
    skipping generation entirely; `workdir` is then unused.
    """

    def __init__(self, graph_cfg: GraphConfig, workdir: str, cfg: LoaderConfig,
                 *, num_walkers: int = 0, checkpoint: bool = True,
                 corpus_manifest: Optional[str] = None, device="cuda"):
        from ..core.corpus import ShardedWalks

        self.gcfg = graph_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        if corpus_manifest is not None:
            self.result = None
            self.walks = ShardedWalks(corpus_manifest)
            if self.walks.length != cfg.seq_len:
                raise ValueError(
                    f"corpus manifest holds walks of length "
                    f"{self.walks.length}, loader needs seq_len={cfg.seq_len}")
        else:
            if num_walkers <= 0:
                raise ValueError("num_walkers required without corpus_manifest")
            self.result = external_walks(
                graph_cfg, workdir, num_walkers=num_walkers,
                length=cfg.seq_len, seed=cfg.seed, checkpoint=checkpoint,
                device=self.device)
            self.walks = self.result.walks

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """{tokens [B, S], labels [B, S]} (int32) for train step `step` (a pure function)."""
        c = self.cfg
        W = self.walks.shape[0]
        wid = (np.int64(step) * c.batch_size + np.arange(c.batch_size)) % W
        tokens, labels = walks_to_tokens(np.asarray(self.walks[wid]), c.vocab)
        return {"tokens": torch.from_numpy(np.ascontiguousarray(tokens)).to(self.device),
                "labels": torch.from_numpy(labels).to(self.device)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
