"""Training driver (twin of `repro/launch/train.py`): generate a graph ->
walk corpus -> train an LM.

    PYTHONPATH=src python -m repro_torch.launch.train [--device cpu] [--data external]

This is the end-to-end path a real job takes (and what
examples/train_lm_on_graph_walks_torch.py drives at laptop scale):

  1. graph generation (the paper's pipeline, `generate` on the device:
     the rmat_edges, relabel_gather and bucket_hist kernels on a card)
  2. deterministic random-walk batches (data/loader.py)
  3. train steps with checkpoint/restart (train/)

`--data external` swaps 1+2 for the disk tier: the graph is generated
out-of-core (StreamingGenerator, CSR as bucket files in --workdir; each
chunk's hot loop on the graph kernels) and token batches stream from an
external_walks corpus memmap, so the CSR never materializes in RAM.
`--corpus-manifest` streams batches from an existing sharded corpus.

Takes the reference's flags plus `--device` (default `cuda`; it raises
without CUDA, `--device cpu` runs the plain path).  As in the reference it
trains `get_smoke_config(arch)`.  The reference's mesh has one shard per
device; the port has one device, so the host route generates with nb 1.
Restartable: re-running with the same --ckpt-dir resumes from the newest
valid checkpoint with identical data order (batches are a pure function of
the step index; the external corpus also resumes its own walk phases from
--workdir).
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np

from ..configs.base import get_smoke_config
from ..core.pipeline import generate
from ..core.types import GraphConfig
from ..data import ExternalWalkLoader, LoaderConfig, WalkLoader
from ..device import resolve_device
from ..train import OptimConfig, checkpoint, init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--scale", type=int, default=12, help="graph scale (2^s vertices)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--data", choices=("host", "external"), default="host",
                    help="host: device pipeline + on-demand sampler; "
                         "external: out-of-core generation + walk corpus")
    ap.add_argument("--workdir", default="",
                    help="disk-tier workdir for --data external "
                         "(temp dir if empty; reuse to resume)")
    ap.add_argument("--walkers", type=int, default=0,
                    help="external corpus size (0 = min(steps*batch, 8192))")
    ap.add_argument("--corpus-manifest", default="",
                    help="stream batches from an existing sharded corpus "
                         "manifest (e.g. a launch/cluster.py run's output) "
                         "instead of generating; implies --data external")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.corpus_manifest:
        args.data = "external"
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    lcfg = LoaderConfig(batch_size=args.batch, seq_len=args.seq, vocab=cfg.vocab_size)
    t0 = time.time()
    scratch_workdir = None
    # everything below runs under the finally that reclaims a scratch
    # workdir: generation and corpus build can fail (or be interrupted)
    # with gigabytes already on disk
    try:
        if args.corpus_manifest:
            # 1+2 already happened elsewhere (e.g. a multi-host cluster run):
            # stream token batches straight from the sharded corpus manifest
            gcfg = GraphConfig(scale=args.scale)
            loader = ExternalWalkLoader(gcfg, "", lcfg, corpus_manifest=args.corpus_manifest,
                                        device=dev)
            print(f"[corpus] streaming {loader.walks.num_walkers} x "
                  f"{args.seq + 1} walks from {args.corpus_manifest}")
        elif args.data == "external":
            # 1+2. out-of-core generation + walk corpus: CSR and walks stay
            # on disk end to end (resumable via the workdir's phase
            # checkpoints; only an explicit --workdir persists for resume)
            from ..core.external import StreamingGenerator

            workdir = args.workdir
            if not workdir:
                workdir = scratch_workdir = tempfile.mkdtemp(prefix="repro_torch_external_")
            gcfg = GraphConfig(scale=args.scale, nb=4, chunk_edges=1 << 14,
                               shuffle_variant="external", checkpoint_phases=True)
            StreamingGenerator(gcfg, workdir, device=dev).run()
            print(f"[graphgen external] scale={args.scale} edges={gcfg.m} "
                  f"workdir={workdir} in {time.time() - t0:.1f}s")
            walkers = args.walkers or min(args.steps * args.batch, 8192)
            loader = ExternalWalkLoader(gcfg, workdir, lcfg, num_walkers=walkers, device=dev)
            print(f"[corpus] {walkers} walks x {args.seq + 1} vertices, "
                  f"peak resident rows {loader.result.gauge.peak_rows}")
        else:
            # 1. graph generation (the paper's kernel is the data source)
            gcfg = GraphConfig(scale=args.scale, nb=1, capacity_factor=4.0)
            res = generate(gcfg, device=dev)
            if int(res.dropped_redistribute):
                raise RuntimeError(f"generate dropped {int(res.dropped_redistribute)} records")
            print(f"[graphgen] scale={args.scale} edges={gcfg.m} "
                  f"in {time.time() - t0:.1f}s")
            # 2. corpus
            loader = WalkLoader(gcfg, res.csr, lcfg, device=dev)

        # 3. train with restart support
        ocfg = OptimConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
        state = init_state(cfg, ocfg, device=dev)
        start = 0
        if args.ckpt_dir:
            restored, step = checkpoint.restore_latest(args.ckpt_dir, state)
            if restored is not None:
                state, start = restored, step + 1
                print(f"[restore] resumed from step {step}")
        step_fn = make_train_step(cfg, ocfg, accum_steps=args.accum)

        losses = []
        for step in range(start, args.steps):
            batch = loader.batch(step)
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                checkpoint.save(args.ckpt_dir, step, state, keep=3)
        if args.ckpt_dir:
            checkpoint.save(args.ckpt_dir, args.steps - 1, state, keep=3)
        print(f"final loss {np.mean(losses[-10:]):.4f} "
              f"(first-10 avg {np.mean(losses[:10]):.4f})")
        return losses
    finally:
        if scratch_workdir is not None:
            shutil.rmtree(scratch_workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
