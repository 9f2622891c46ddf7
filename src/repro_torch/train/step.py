"""Train-step assembly: loss, gradient accumulation, optimizer (twin of
`repro/train/step.py`).

`make_train_step` returns a (state, batch) -> (state, metrics) function.
Gradients come from autograd over the model's forward, which runs inside
`models.layers.train_attention()`: attention takes the reference's
`_chunked_attention`, the route its train step takes, never the flash
kernel (forward only, as the reference's Pallas kernel is).  Gradient
accumulation is a Python loop over microbatches (the reference's
`lax.scan`), summing grads in f32 and averaging grads and metrics; the
optional gradient compression (train/compression.py) runs between
accumulation and the optimizer.  No `torch.compile`: the step runs eagerly.

`dist` (a `models.nn.DistContext` from `distributed/sharding.py::make_dist`)
is threaded into the loss and the model's forward, as in the reference: an
MoE model then trains under expert-parallel dispatch over the mesh's "model"
axis, its shards leading dimensions on the one card (`models/moe.py`).
Autograd runs through that dispatch: the exchanges' bucketed writes are
index writes whose gradient is the gather of the same positions (the
transpose of the reference's `.at[].set`), so a dropped record, written to
a row past the buckets, gets none; the int8 payload's codes carry no
gradient (a cast to int8), its scales do, through `amax`, which splits the
gradient among ties as `jnp.max` does.

The reference's `state_shardings` and `batch_sharding_tree` (NamedShardings
for a mesh) have no counterpart on one card, as `models/nn.py` has none for
`shard`.  `init_state` draws the params from a seeded generator on the
device (or takes given ones, e.g. `models.convert.params_from_reference`'s)
and returns the state alone: the reference's ParamFactory exists for its
shardings.  On the meta device it gives the state's shapes and dtypes (the
reference's `mode="shape"`), for the dry run.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ..models.layers import train_attention
from ..models.nn import DistContext
from ..models.registry import ModelApi, get_model, init_all
from . import optim as optim_lib
from . import tree
from .compression import CompressionConfig, compress_state_init, compressed_grads

METRIC_KEYS = ("loss", "ntok", "lb_loss", "dropped")


class TrainState(NamedTuple):
    params: Any
    opt: optim_lib.OptState
    comp: Any             # compression error-feedback state (possibly empty tuple)
    step: torch.Tensor    # int32, 0-d


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, ignore: int = -100):
    """Mean token cross-entropy; labels == `ignore` are masked out.
    Returns (loss, number of counted tokens)."""
    mask = labels != ignore
    labels_safe = torch.where(mask, labels, 0).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels_safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1)
    return nll.sum() / denom, denom


def make_loss_fn(cfg, api: Optional[ModelApi] = None, lb_coef: float = 1e-2,
                 z_coef: float = 0.0):
    api = api or get_model(cfg)

    def loss_fn(params, batch, dist: Optional[DistContext] = None):
        logits, aux = api.forward(cfg, params, batch, dist)
        xent, ntok = softmax_xent(logits, batch["labels"])
        loss = xent
        if cfg.num_experts:
            loss = loss + lb_coef * aux["lb_loss"]
        if z_coef:
            loss = loss + z_coef * aux["z_loss"]
        metrics = {"loss": xent, "ntok": ntok.float(), "lb_loss": aux["lb_loss"],
                   "dropped": aux["dropped"]}
        return loss, metrics

    return loss_fn


# ---------------------------------------------------------------------------
# Step builder
# ---------------------------------------------------------------------------


def _split_microbatches(batch: Dict[str, torch.Tensor], accum: int):
    """[{key: rows [i b/accum, (i+1) b/accum)} for i < accum]."""
    for key, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(f"batch {key}: {x.shape[0]} rows % accum {accum} != 0")
    return [{key: x.reshape(accum, x.shape[0] // accum, *x.shape[1:])[i]
             for key, x in batch.items()} for i in range(accum)]


def make_train_step(cfg, ocfg: optim_lib.OptimConfig, dist: Optional[DistContext] = None, *,
                    accum_steps: int = 1, compression: Optional[CompressionConfig] = None,
                    lb_coef: float = 1e-2) -> Callable:
    """(state, batch) -> (state, metrics).  The params, moments and master
    copy are updated in place (`optim.apply_updates`); metrics are 0-d
    tensors on the params' device."""
    loss_fn = make_loss_fn(cfg, lb_coef=lb_coef)

    def grad_fn(params, batch):
        leaves = tree.leaves(params)
        with torch.enable_grad(), train_attention():
            loss, metrics = loss_fn(params, batch, dist)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    def train_step(state: TrainState, batch):
        if accum_steps == 1:
            metrics, grads = grad_fn(state.params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree.leaves(state.params)]
            metrics = {k: torch.zeros((), dtype=torch.float32, device=state.step.device)
                       for k in METRIC_KEYS}
            for mb in _split_microbatches(batch, accum_steps):
                m, g = grad_fn(state.params, mb)
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                del g
                metrics = {k: metrics[k] + m[k] for k in METRIC_KEYS}
            grads = [g / accum_steps for g in grads]
            metrics = {k: v / accum_steps for k, v in metrics.items()}
        grads = tree.unflatten(state.params, grads)

        comp_state = state.comp
        if compression is not None and compression.kind != "none":
            grads, comp_state = compressed_grads(compression, grads, comp_state)

        params, opt, om = optim_lib.apply_updates(ocfg, state.params, grads, state.opt)
        metrics = dict(metrics, **om)
        return TrainState(params, opt, comp_state, state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# State init
# ---------------------------------------------------------------------------


def init_state(cfg, ocfg: optim_lib.OptimConfig, seed: int = 0,
               compression: Optional[CompressionConfig] = None, device="cuda",
               params=None) -> TrainState:
    """A fresh TrainState: params from `init_all(cfg, seed, device)` unless
    given (their device is then the state's), each made a leaf that requires
    grad and that the optimizer updates in place; the optimizer and EF
    state; step 0.  With device="meta", every leaf on the meta device."""
    if params is None:
        params = init_all(cfg, seed=seed, device=device)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    opt = optim_lib.init(ocfg, params)
    comp = compress_state_init(compression, params)
    step = torch.zeros((), dtype=torch.int32, device=opt.count.device)
    return TrainState(params, opt, comp, step)
