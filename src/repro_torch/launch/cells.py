"""Cell assembly: one (arch x shape) on one card -> a step and its arguments
(counterpart of `repro/launch/cells.py`).  Shared by the dry run
(`launch/dryrun.py`) and the measured variants (`launch/perf.py`).

  train cells   -> make_train_step(cfg, ocfg, dist)(state, batch)
  prefill cells -> prefill(params, batch, cache)
  decode cells  -> decode_step(params, tokens, cache)   (1 new token against
                   a cache of seq_len positions, its length set to
                   seq_len - 1: the reference's decode semantics)

The reference builds each cell on its 256- or 512-chip production mesh and
returns abstract arguments with their shardings, to lower and compile.  On
one card a cell runs `batch` sequences (the shape's global batch unless
given) under `make_dist(cfg, mesh_shape)`: the mesh's axes are leading
dimensions, so an MoE model dispatches its experts over the "model" axis's
ep shards (`models/moe.py`); the shardings have no counterpart.  The
arguments are real tensors on `device`, drawn from `seed`, or on the meta
device their shapes and dtypes alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeSpec, get_config, long_context_supported
from ..distributed.sharding import make_dist
from ..models.nn import DistContext
from ..models.registry import get_model, init_all, input_specs
from ..train import OptimConfig, init_state, make_train_step


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec        # global_batch: the sequences this card runs a step
    cfg: ModelConfig
    fn: Callable            # the step
    args: Tuple             # its arguments
    dist: DistContext
    kind: str


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not long_context_supported(cfg):
        return False, ("full-attention family: 524288-token context is "
                       "quadratic; run for ssm/hybrid only (DESIGN.md §5)")
    return True, ""


def build_cell(arch: str, shape: ShapeSpec, mesh_shape: Mapping[str, int], *,
               cfg: Optional[ModelConfig] = None, ocfg: Optional[OptimConfig] = None,
               accum_steps: int = 1, moe_dispatch: Optional[str] = None,
               batch: Optional[int] = None, device="cuda", seed: int = 0) -> Cell:
    cfg = cfg or get_config(arch)
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape.name} skipped: {why}")
    shape = dataclasses.replace(shape, global_batch=batch or shape.global_batch)
    B, S = shape.global_batch, shape.seq_len
    dist = make_dist(cfg, mesh_shape, moe_dispatch=moe_dispatch)
    api = get_model(cfg)

    if shape.kind == "train":
        ocfg = ocfg or OptimConfig()
        state = init_state(cfg, ocfg, seed=seed, device=device)
        data = input_specs(cfg, "train", B, S, seed=seed, device=device)
        fn = make_train_step(cfg, ocfg, dist, accum_steps=accum_steps)
        return Cell(arch, shape, cfg, fn, (state, data), dist, "train")

    params = init_all(cfg, seed=seed, device=device)
    cache = init_cache(cfg, B, S, device)
    if shape.kind == "prefill":
        data = input_specs(cfg, "prefill", B, S, seed=seed, device=device)

        def prefill(p, b, c):
            with torch.no_grad():
                return api.prefill(cfg, p, b, c, dist)

        return Cell(arch, shape, cfg, prefill, (params, data, cache), dist, "prefill")

    tokens = input_specs(cfg, "decode", B, S, seed=seed, device=device)["tokens"]
    cache["length"] = torch.full((), S - 1, dtype=torch.int32, device=cache["length"].device)

    def decode(p, t, c):
        with torch.no_grad():
            return api.decode_step(cfg, p, t, c, dist)

    return Cell(arch, shape, cfg, decode, (params, tokens, cache), dist, "decode")


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> Any:
    """The model's cache of seq_len positions; for encdec with the cross
    K/V of seq_len encoder positions beside it, which the reference's cache
    holds from the start (the port's prefill adds them)."""
    cache = get_model(cfg).init_cache(cfg, batch, seq_len, device=device)
    if cfg.family == "encdec":
        kv = cache["k"].shape[:3] + (seq_len, cfg.hd)
        for name in ("cross_k", "cross_v"):
            cache[name] = torch.zeros(kv, dtype=cfg.torch_dtype, device=cache["k"].device)
    return cache
