"""Named variants of a cell, run and measured on the card (counterpart of
`repro/launch/perf.py`).

    PYTHONPATH=src python -m repro_torch.launch.perf --arch deepseek-v2-lite-16b \
        --shape train_4k --variants baseline,dispatch_int8 --layers 4 --batch 1 \
        --mesh 1x4 [--steps 8] [--device cpu] [--out perf.jsonl]

The reference re-lowers a cell under each variant and diffs the roofline
terms of the compiled module.  Here a variant changes the config, the
optimizer config or the step's arguments, the cell is built on the card and
runs `steps` steps on one seeded batch, and the record gives what the card
did: the median CUDA-event step ms, the peak device memory, the losses and
drops, the Roofline of one step (`roofline.from_measured`: flops counted by
FlopCounterMode on the first step), the measured share of the bf16 peak
(model flops / (989e12 x step seconds)) and the heaviest kernels of the last
step under torch.profiler (`attribution`).  The first step (counted) and
the last (profiled) are not timed.  On the CPU the run checks the code
path: the device numbers are None ("not measured").

`VARIANTS` holds the reference's variants whose overrides the port reads,
with the reference's exact overrides; variants compose with '+'.  The rest
have no counterpart (`NO_COUNTERPART`, with the reason).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
from typing import Dict, Optional, Union

import torch

from ..configs.base import SHAPES, ShapeSpec, get_config
from ..kernels import ops
from ..train import OptimConfig, tree
from . import attribution
from . import roofline as rl
from .cells import build_cell
from .mesh import BF16_OPS_PER_S

VARIANTS: Dict[str, Dict] = {
    "baseline": {},
    "accum8": {"accum_steps": 8},
    "accum4": {"accum_steps": 4},
    "accum16": {"accum_steps": 16},
    "logits_bf16": {"cfg_update": {"logits_fp32": False}},
    "moecap125": {"cfg_update": {"moe_capacity_factor": 1.25}},
    "ep_off": {"moe_dispatch": "dense"},
    "dispatch_int8": {"cfg_update": {"moe_dispatch_int8": True}},
    "opt_bf16": {"ocfg_update": {"moments_dtype": "bfloat16"}},
    "ssdchunk512": {"cfg_update": {"ssm_chunk": 512}},
    "ssdchunk1024": {"cfg_update": {"ssm_chunk": 1024}},
}

NO_COUNTERPART: Dict[str, str] = {
    "sp": "moves a sharding rule (sequence over the model axis); one card places nothing",
    "no_fsdp": "moves a sharding rule (params replicated over data); one card places nothing",
    "dp_pure": "moves sharding rules (batch over both axes, no tensor parallelism)",
    "remat_none": "the port does not read cfg.remat: eager autograd keeps every activation "
                  "and recomputes none",
    "qchunk512": "the port's train attention does not read cfg.attn_q_chunk (its chunk is "
                 "kernels/flash_attention.py::PLAIN_Q_CHUNK)",
    "qchunk2048": "the port's train attention does not read cfg.attn_q_chunk (its chunk is "
                  "kernels/flash_attention.py::PLAIN_Q_CHUNK)",
}

TOP_KERNELS = 10


def resolve(arch: str, names: str, cfg_update: Optional[Dict] = None,
            ocfg: Optional[OptimConfig] = None):
    """(cfg, ocfg, build_cell keyword arguments) of the '+'-joined variant
    names, `cfg_update` applied to the config first (e.g. a depth cut)."""
    cfg = get_config(arch).with_(**(cfg_update or {}))
    ocfg = ocfg or OptimConfig()
    kwargs: Dict = {}
    for name in names.split("+"):
        if name in NO_COUNTERPART:
            raise ValueError(f"variant {name!r} has no counterpart on one card: "
                             f"{NO_COUNTERPART[name]}")
        v = dict(VARIANTS[name])
        cfg = cfg.with_(**v.pop("cfg_update", {}))
        ocfg = dataclasses.replace(ocfg, **v.pop("ocfg_update", {}))
        kwargs.update(v)
    return cfg, ocfg, kwargs


def run_variant(arch: str, shape: Union[str, ShapeSpec], names: str, *,
                cfg_update: Optional[Dict] = None, ocfg: Optional[OptimConfig] = None,
                mesh_shape: Optional[Dict[str, int]] = None, batch: Optional[int] = None,
                steps: int = 8, device="cuda", seed: int = 0) -> Dict:
    """Build the train cell of `arch` x `shape` under the variants `names`
    and run `steps` (>= 3) steps of its batch; the record of the module
    docstring."""
    if steps < 3:
        raise ValueError(f"steps {steps}: one counted, one or more timed, one profiled")
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if shape.kind != "train":
        raise ValueError(f"run_variant runs train cells, not {shape.kind}")
    mesh_shape = mesh_shape or {"data": 1, "model": 1}
    cfg, ocfg, kwargs = resolve(arch, names, cfg_update, ocfg)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cell = build_cell(arch, shape, mesh_shape, cfg=cfg, ocfg=ocfg, batch=batch, device=dev,
                      seed=seed, **kwargs)
    state, data = cell.args
    model_flops = rl.model_flops_for_cell(cfg, cell.shape)
    ops.reset_launches()
    metrics = []
    roof, (state, m) = rl.from_measured(cell.fn, (state, data), model_flops=model_flops,
                                        kind="train")
    metrics.append(m)
    step_ms = []
    for _ in range(1, steps - 1):
        if on_card:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        state, m = cell.fn(state, data)
        metrics.append(m)
        if on_card:
            b.record()
            step_ms.append((a, b))
    top, kinds = [], []
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, m = cell.fn(state, data)
            torch.cuda.synchronize(dev)
        top = [{"name": name[:90], "ms": ms, "launches": n}
               for ms, name, n in attribution.top_bytes(prof, TOP_KERNELS)]
        kinds = attribution.by_op(prof)
        step_ms = [a.elapsed_time(b) for a, b in step_ms]
    else:
        state, m = cell.fn(state, data)
    metrics.append(m)
    launches = dict(ops.LAUNCHES)
    median = statistics.median(step_ms) if step_ms else None
    rec = {
        "arch": arch, "shape": shape.name, "variant": names, "cfg_update": cfg_update or {},
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "mesh": dict(mesh_shape), "moe_dispatch": cell.dist.moe_dispatch,
        "batch": cell.shape.global_batch, "seq_len": shape.seq_len,
        "layers": cfg.num_layers, "steps": steps,
        "params": sum(p.numel() for p in tree.leaves(state.params)),
        "param_count": cfg.param_count(),
        "losses": [float(x["loss"]) for x in metrics],
        "lb_loss": [float(x["lb_loss"]) for x in metrics],
        "dropped": [int(x["dropped"]) for x in metrics],
        "grad_norms": [float(x["grad_norm"]) for x in metrics],
        "step_ms": step_ms if on_card else None, "step_ms_median": median,
        "tokens_per_s": cell.shape.global_batch * shape.seq_len / (median / 1e3)
        if median else None,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None,
        "roofline": roof.as_dict(),
        "mfu": model_flops / (BF16_OPS_PER_S * median / 1e3) if median else None,
        "top_kernels": top, "device_ms_by_kind": kinds, "launches": launches,
    }
    del state, data, cell
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="measured variants of a train cell")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--variants", default="baseline", help="comma-separated; '+' composes")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--batch", type=int, default=0, help="sequences a step (0: the shape's)")
    ap.add_argument("--mesh", default="1x1", help="data x model, e.g. 1x4")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dp, ep = (int(x) for x in args.mesh.split("x"))
    records = []
    for names in args.variants.split(","):
        rec = run_variant(args.arch, args.shape, names,
                          cfg_update={"num_layers": args.layers} if args.layers else None,
                          mesh_shape={"data": dp, "model": ep}, batch=args.batch or None,
                          steps=args.steps, device=args.device)
        records.append(rec)
        print(json.dumps({k: rec[k] for k in ("variant", "losses", "step_ms_median", "mfu",
                                              "peak_gib", "dropped")}), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return records


if __name__ == "__main__":
    main()
