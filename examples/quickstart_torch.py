"""Quickstart of the PyTorch port (twin of examples/quickstart.py): generate
a scale-12 R-MAT graph with the paper's pipeline, validate it, and sample
random walks from it.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

`--device` defaults to cuda (and raises without it); `--device cpu` runs the
plain PyTorch path.
"""

import argparse

import numpy as np

from repro_torch.core import validate as V
from repro_torch.core.csr import csr_to_host
from repro_torch.core.pipeline import generate
from repro_torch.core.types import GraphConfig
from repro_torch.data.walks import host_walks
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = resolve_device(ap.parse_args().device)

# 1. configure: 2^12 vertices, 16 edges per vertex (Graph500 edge factor)
cfg = GraphConfig(scale=12, edge_factor=16, nb=1, capacity_factor=4.0)

# 2. run the paper's pipeline: shuffle -> edges -> relabel -> redistribute -> CSR
res = generate(cfg, device=device)
print(f"generated {cfg.m} edges over {cfg.n} vertices on {device} "
      f"(dropped: {int(res.dropped_redistribute)})")

# 3. validate (Graph500-style)
assert V.check_permutation(res.pv), "permutation must be a bijection"
checks = V.check_csr(res.csr, res.owned, cfg)
assert all(checks.values()), checks
stats = V.degree_stats(res.csr, cfg)
print(f"degree: mean={stats['mean_degree']:.1f} max={stats['max_degree']:.0f} "
      f"(heavy tail — it's a scale-free graph)")

# 4. de-biasing check: this is WHY the paper shuffles (paper §I)
skew = V.endpoint_skew(res.src, res.dst, cfg.n)
print(f"relabeled endpoint skew {skew:.4f} (unbiased = {1 / 16:.4f})")

# 5. walk the graph (the training-data pipeline)
offv, adjv = csr_to_host(res.csr, cfg)
walks = host_walks(offv, adjv, np.asarray([0, 1, 2]), 12, seed=0, n=cfg.n)
print("three 12-step walks:")
for w in walks:
    print("  ", w.tolist())
