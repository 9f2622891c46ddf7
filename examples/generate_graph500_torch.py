"""Graph500 kernel-1 style run of the PyTorch port (twin of
examples/generate_graph500.py): generation over `--nb` shards on one device,
the paper pipeline and the hash baseline, plus the literal out-of-core path.
The paper pipeline runs the ring relabel (one `relabel_gather` launch a
field); the out-of-core runs join their edges to pv through the same kernel,
one launch a pv-join segment.

    PYTHONPATH=src python examples/generate_graph500_torch.py --scale 14 [--nb 8] [--device cpu]

`--device` defaults to cuda (and raises without it); `--device cpu` runs the
plain PyTorch path.
"""

import argparse
import tempfile
import time

import torch

from repro_torch.core import validate as V
from repro_torch.core.external import StreamingGenerator
from repro_torch.core.pipeline import generate, generate_baseline_hash
from repro_torch.core.types import GraphConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=13)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--nb", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    nb = args.nb
    cfg = GraphConfig(scale=args.scale, edge_factor=args.edge_factor,
                      nb=nb, capacity_factor=4.0)
    print(f"scale={args.scale} -> {cfg.n} vertices, {cfg.m} edges, "
          f"{nb} shards ('compute nodes') on {dev}")

    # paper pipeline (sorted-merge CSR, the §III-B7 fast path)
    ops.reset_launches()
    t0 = time.time()
    res = generate(cfg, device=dev)
    sync()
    t_paper = time.time() - t0
    assert int(res.dropped_redistribute) == 0
    assert V.check_permutation(res.pv)
    print(f"[paper pipeline]   {t_paper:.2f}s  "
          f"(TEPS ~ {cfg.m / t_paper:,.0f}); launches "
          f"{ {k: ops.LAUNCHES[k] for k in ('rmat_edges', 'relabel_gather', 'bucket_hist')} }")

    # memory-resident hash baseline (what the paper replaces)
    t0 = time.time()
    generate_baseline_hash(cfg, device=dev)
    sync()
    print(f"[hash baseline]    {time.time() - t0:.2f}s (single shard, "
          f"all-in-memory)")

    # literal out-of-core run (bounded host memory, I/O ledger)
    ext_cfg = cfg.with_(nb=min(nb, 2), scale=min(args.scale, 12))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        _, _, ledger = StreamingGenerator(ext_cfg, d, device=dev).run()
        print(f"[out-of-core]      {time.time() - t0:.2f}s at scale "
              f"{ext_cfg.scale}; I/O ledger: {ledger.as_dict()}")
        assert ledger.rand_reads == 0 and ledger.rand_writes == 0, \
            "sorted path must be sequential-only"

    # fully external run: pv itself lives in disk bucket files (Alg. 2-4 on
    # disk); peak resident rows stay O(chunk_edges) regardless of scale
    xcfg = ext_cfg.with_(shuffle_variant="external")
    with tempfile.TemporaryDirectory() as d:
        ops.reset_launches()
        t0 = time.time()
        gen = StreamingGenerator(xcfg, d, device=dev)
        gen.run()
        print(f"[external shuffle] {time.time() - t0:.2f}s; peak resident "
              f"rows {gen.gauge.peak_rows} (n = {xcfg.n}); "
              f"relabel_gather launches {ops.LAUNCHES['relabel_gather']}; per-phase:")
        for rec in gen.orchestrator.report():
            print(f"    {rec['phase']:>14s}: {rec['seconds']:7.2f}s  "
                  f"seq r/w {rec['seq_reads']}/{rec['seq_writes']}  "
                  f"rand r/w {rec['rand_reads']}/{rec['rand_writes']}")


if __name__ == "__main__":
    main()
