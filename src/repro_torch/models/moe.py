"""Mixture-of-Experts layer on one card (twin of `repro/models/moe.py`, its
`dist is None` / "dense" dispatch).

The reference's dense dispatch capacity-gathers the tokens of every expert
and runs every expert on its block: a stable argsort of the (token, choice)
records by expert, group starts by `searchsorted`, a rank inside the group
and a slot `expert * cap + rank` (records past `cap` are dropped).  That is
`distributed/collectives.py::bucket_by_destination` bit for bit, whose group
starts come from the `bucket_hist` kernel (k = num_experts): the records are
the token ids, bucketed by expert.  The same counts give the load-balance
loss its assignments per expert, so a layer computes one histogram and
reads nothing back to the host.  The expert products stay batched matrix
products (`torch.bmm`), as the reference leaves them to XLA.

Two orders are pinned where PyTorch would leave them open:

  * top-k: a stable descending sort of the router probabilities, so equal
    probabilities keep the lower expert first, as `jax.lax.top_k` does
    (`torch.topk` promises no order among ties);
  * combine: each token sums its k weighted expert outputs in ascending
    expert order, in the activation dtype, a dropped one adding 0: the order
    of the reference's scatter-add over the expert-sorted records, with no
    atomics, so the card gives the same sums on every run.

The EP dispatch modes (`_moe_alltoall`, `_moe_gather_ep`, int8 dispatch) are
not ported (ROADMAP.md queue 1 item 11e).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed.collectives import bucket_by_destination, unbucket
from .nn import ParamFactory


def init_moe(f: ParamFactory, cfg) -> Dict[str, Any]:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": f.param((d, E)),
        "w_gate": f.param((E, d, ff)),
        "w_up": f.param((E, d, ff)),
        "w_down": f.param((E, ff, d)),
    }
    if cfg.num_shared_experts:
        sff = cfg.moe_d_ff * cfg.num_shared_experts
        p["shared"] = {"w_gate": f.param((d, sff)), "w_up": f.param((d, sff)),
                       "w_down": f.param((sff, d))}
    return p


def route(p, cfg, x_tokens: torch.Tensor):
    """x_tokens [T, d] -> (weights [T, k] in x's dtype, experts [T, k] int64,
    probs [T, E] f32, router z-loss [] f32).  The load-balance loss needs the
    records per expert, which the dispatch's `bucket_hist` counts (`moe_ffn`)."""
    logits = (x_tokens @ p["router"]).float()                 # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_tok
    weights, experts = top.values[:, :k], top.indices[:, :k]
    if cfg.norm_topk_prob:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return weights.to(x_tokens.dtype), experts, probs, z_loss


def expert_ffn(w_gate, w_up, w_down, x: torch.Tensor) -> torch.Tensor:
    """Batched per-expert SwiGLU: x [E, C, d] with stacked weights [E, ...]."""
    return torch.bmm(F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up), w_down)


def moe_dense(p, cfg, x_tokens: torch.Tensor, weights: torch.Tensor, experts: torch.Tensor):
    """Every expert on its capacity-gathered tokens: (y [T, d], records per
    expert [E] int32, dropped [] int32).  cap = max(8, T k 4 / E), T counting
    every token given (a bucketed prefill's right-padding too), as the
    reference does."""
    T = x_tokens.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_tok
    cap = max(8, (T * k * 4) // E)
    token = torch.arange(T * k, device=x_tokens.device) // k               # [T*k]
    b = bucket_by_destination(token, experts.reshape(-1), E, cap)
    out = expert_ffn(p["w_gate"], p["w_up"], p["w_down"], x_tokens[b.data])   # [E, cap, d]
    contrib = unbucket(out, b.position).reshape(T, k, -1) * weights[..., None]
    # the reference's summation order: ascending expert per token
    order = torch.argsort(experts, dim=1)
    contrib = contrib.gather(1, order[..., None].expand_as(contrib))
    y = contrib[:, 0].clone()
    for j in range(1, k):
        y += contrib[:, j]
    return y, b.counts, b.dropped


def moe_ffn(p, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Full MoE sublayer on [B, S, d].  Returns (y, aux): aux holds lb_loss,
    z_loss (f32) and dropped (int32), each a 0-d tensor."""
    B, S, d = x.shape
    toks = x.reshape(B * S, d)
    w, e, probs, z_loss = route(p, cfg, toks)
    y, counts, dropped = moe_dense(p, cfg, toks, w, e)
    # Switch-style load-balance aux: mean probability times mean assignments
    # per expert (integer counts: exact in any order)
    lb_loss = cfg.num_experts * (probs.mean(dim=0) * (counts.float() / (B * S))).sum()
    aux = {"lb_loss": lb_loss, "z_loss": z_loss, "dropped": dropped}
    y = y.reshape(B, S, d)
    if "shared" in p:
        sp = p["shared"]
        y = y + (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    return y, aux
