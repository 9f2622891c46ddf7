"""Optimizer: AdamW with decoupled weight decay, global-norm clipping,
warmup+cosine schedule, and optional f32 master weights for bf16 params
(twin of `repro/train/optim.py`).

State is a tree congruent with the params (`train/tree.py`): the Adam
moments and the master copy of each leaf.  `apply_updates` keeps the
reference's arithmetic, in f32, leaf by leaf: clip, the moments, bias
correction, decoupled decay on the master copy (or on the f32 param without
one), the cast back to the param's dtype.  It writes the new values into the
params, moments and master tensors in place (the reference returns new
trees; in place keeps a full-width model's state once in memory) and returns
the same trees.  The scalars (count, lr, bias corrections, clip factor) stay
0-d tensors on the params' device, so a step reads nothing back to the host.

The decay mask comes from a leaf's path as in the reference.  The port's
list indices (`params["blocks"][i]`) add digits only, which no substring of
`_NO_DECAY_SUBSTR` contains, so each leaf gets its reference counterpart's
decision.  `init_abstract` is the state on the meta device, shapes and
dtypes without storage, for the dry run (`launch/dryrun.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from . import tree


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_fp32: bool = True   # keep f32 master copy when params are low-precision
    moments_dtype: str = "float32"   # "bfloat16" halves mu/nu memory (8-bit-Adam-lite)
    schedule: str = "warmup_cosine"  # "warmup_cosine" | "constant"

    @property
    def torch_moments(self) -> torch.dtype:
        return getattr(torch, self.moments_dtype)


class OptState(NamedTuple):
    mu: Any              # first moment, congruent with params
    nu: Any              # second moment
    master: Any          # f32 master copy (or 0-d f32 zeros when disabled)
    count: torch.Tensor  # int32 step counter, 0-d


def schedule(cfg: OptimConfig, step) -> torch.Tensor:
    """Learning rate at `step` (f32, 0-d)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    # cosine decay from lr to lr*min_lr_ratio over the post-warmup span
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    decayed = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decayed


def init(cfg: OptimConfig, params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.torch_moments, device=p.device)

    if cfg.master_fp32:
        master = tree.tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    else:
        master = tree.tree_map(lambda p: torch.zeros((), dtype=torch.float32, device=p.device),
                               params)
    device = tree.leaves(params)[0].device
    return OptState(mu=tree.tree_map(zeros, params), nu=tree.tree_map(zeros, params),
                    master=master, count=torch.zeros((), dtype=torch.int32, device=device))


def init_abstract(cfg: OptimConfig, params) -> OptState:
    """`init`'s state on the meta device (shapes and dtypes, no storage), for
    the dry run: the reference's ShapeDtypeStruct mirror."""
    return init(cfg, tree.tree_map(lambda p: p.to("meta"), params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (summed per leaf,
    then over the leaves: the reference sums its stacked leaves, so the
    order differs)."""
    return torch.sqrt(torch.stack([(g.float() ** 2).sum() for g in tree.leaves(grads)]).sum())


_NO_DECAY_SUBSTR = ("ln", "norm", "bias", "scale", "length")


def _decay_mask(path: Tuple) -> bool:
    s = "/".join(str(k) for k in path).lower()
    return not any(t in s for t in _NO_DECAY_SUBSTR)


@torch.no_grad()
def apply_updates(cfg: OptimConfig, params, grads, state: OptState):
    """One AdamW step.  Returns (params, state, metrics): the params, moments
    and master leaves updated in place, a new count."""
    count = state.count + 1
    lr = schedule(cfg, count)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0) if cfg.clip_norm > 0 else 1.0
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()

    flat = tree.leaves_with_path(params)
    gs, mus, nus = tree.leaves(grads), tree.leaves(state.mu), tree.leaves(state.nu)
    masters = tree.leaves(state.master)
    for (path, p), g, mu, nu, master in zip(flat, gs, mus, nus, masters):
        g = g.float() * clip
        m = cfg.b1 * mu.float() + (1.0 - cfg.b1) * g
        v = cfg.b2 * nu.float() + (1.0 - cfg.b2) * (g * g)
        del g
        update = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        mu.copy_(m)
        nu.copy_(v)
        del m, v
        base = master if cfg.master_fp32 else p.float()
        if _decay_mask(path):
            update.add_(cfg.weight_decay * base)
        new_master = base - lr * update
        del update
        p.copy_(new_master)
        if cfg.master_fp32:
            master.copy_(new_master)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, OptState(state.mu, state.nu, state.master, count), metrics
