"""Mixture-of-Experts layer on one card (twin of `repro/models/moe.py`): a
top-k router, shared experts, and the reference's two dispatch modes.

"dense" (`dist` None or `moe_dispatch == "dense"`): every expert runs on its
capacity-gathered tokens.  The reference's dispatch is a stable argsort of
the (token, choice) records by expert, group starts by `searchsorted`, a
rank inside the group and a slot `expert * cap + rank` (records past `cap`
are dropped).  That is `distributed/collectives.py::bucket_by_destination`
bit for bit, whose group starts come from the `bucket_hist` kernel (k =
num_experts): the records are the token ids, bucketed by expert.  The same
counts give the load-balance loss its assignments per expert, so a layer
computes one histogram and reads nothing back to the host.

"alltoall" (a `DistContext` from `distributed/sharding.py::make_dist`):
expert parallelism over the reference mesh's "model" axis, whose `ep`
shards (and `dp` batch shards) are leading dimensions here, as the graph
path's shards are.  Shard r owns experts r e_local .. (r+1) e_local - 1 (the
weights' E axis read as [ep, e_local]).  The reference's choice of mode:

  * all_to_all (S % ep == 0 and S >= ep, `_moe_alltoall`): the tokens are
    split [dp, ep, (B/dp)(S/ep)]; each record is bucketed by the owner of
    its expert and exchanged by `capacity_all_to_all` (one exchange per dp
    row, capacity cf (B/dp)(S/ep) k / ep + 8), the local expert id riding
    as one more column in the activation dtype; each receiver buckets its
    rows by local expert at capacity max(8, 2 rows / e_local), whose
    overflow is zeroed and not counted (only the exchange's drops are);
    `return_all_to_all` brings the outputs back, and each token sums its k
    in f32 in top-k order.  With `cfg.moe_dispatch_int8` the tokens travel
    as int8 with a per-row f32 scale (amax / 127, round half to even, clip
    to +-127) beside the local expert id in a narrow f32 exchange, and the
    outputs are quantised again for the return trip;
  * gather (decode and other short S, `_moe_gather_ep`): every shard sees
    its dp row's T tokens, buckets the records of its own experts at
    capacity max(8, 2 T k / ep), and scatter-adds its weighted outputs in
    the activation dtype onto the token id that rode as an activation-dtype
    column (in bf16 an id above 256 may round onto its neighbour's row, as
    in the reference; ROADMAP.md queue 3); the ep partial outputs are
    summed (the reference's psum).

The load-balance loss is computed per shard and averaged (all_to_all: over
every shard; gather: over dp), the reference's pmean; `dropped` sums every
shard's.  The shards' groups are disjoint and a stable bucketing keeps each
group's order, so every shard's bucketing by local expert is one
`bucket_by_destination` by global expert (receiver r's local expert l is
group r e_local + l), which gives the [E, cap] blocks in shard order; the
expert products stay batched matrix products (`torch.bmm`) over them, as
the reference leaves them to XLA.

Orders pinned where PyTorch would leave them open:

  * top-k: a stable descending sort of the router probabilities, so equal
    probabilities keep the lower expert first, as `jax.lax.top_k` does
    (`torch.topk` promises no order among ties);
  * dense combine: each token sums its k weighted expert outputs in
    ascending expert order, in the activation dtype, a dropped one adding 0:
    the order of the reference's scatter-add over the expert-sorted
    records, with no atomics, so the card gives the same sums on every run;
  * gather combine: each shard's partial row sums its records in slot
    order (expert, then record) in f32, rounded once to the activation dtype
    (what the CPU's `index_add_` does), with no atomics (the records sorted
    by row, then added one position at a time), and the ep partials are
    summed in shard order in the activation dtype: the same sums on every
    run.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.collectives import (bucket_by_destination, capacity_all_to_all,
                                       return_all_to_all, unbucket)
from ..kernels.bucket import bucket_hist
from .nn import DistContext, ParamFactory


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


def q8(rows: torch.Tensor):
    """int8 codes and f32 scales [..., 1] of `rows`: the scale is the row's
    largest magnitude / 127 (1 for a row of zeros), the code round(row /
    scale) (half to even) clipped to +-127.  The scale is a product with the
    f32 reciprocal of 127, bit for bit what XLA makes of the reference's
    division by that constant."""
    amax = rows.float().abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    return torch.clamp(torch.round(rows / scale), -127, 127).to(torch.int8), scale


def _moe_alltoall(p, cfg, toks: torch.Tensor, weights: torch.Tensor, experts: torch.Tensor,
                  capacity: int):
    """One dp row's all_to_all dispatch: toks [ep, T, d] (shard r's T
    tokens), weights and experts [ep, T, k].  Returns (y [ep, T, d],
    exchange drops [] int32)."""
    ep, T, d = toks.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    e_local = E // ep
    flat_expert = experts.reshape(ep, T * k)
    owner, local = flat_expert // e_local, flat_expert % e_local
    xk = toks.repeat_interleave(k, dim=1)                     # [ep, T*k, d]
    if cfg.moe_dispatch_int8:
        q, scale = q8(xk)
        # int8 tokens in one exchange; (scale, local expert) in a narrow f32 one
        ex = capacity_all_to_all(q, owner, capacity=capacity)
        side = capacity_all_to_all(torch.cat([scale, local.float()[..., None]], dim=-1), owner,
                                   capacity=capacity)
        recv_tok = (ex.data.float() * side.data[..., :1]).to(toks.dtype)
        recv_e = side.data[..., 1]
    else:
        ex = capacity_all_to_all(torch.cat([xk, local.to(toks.dtype)[..., None]], dim=-1), owner,
                                 capacity=capacity)
        recv_tok, recv_e = ex.data[..., :d], ex.data[..., d]
    # each receiver's ep x capacity rows, bucketed by its local expert at cap2
    # (the overflow is zeroed, uncounted): one bucketing of every receiver's
    # rows by global expert, empty slots to the sentinel E
    rows = ep * capacity
    cap2 = max(8, int(rows * 2 // max(e_local, 1)))
    owner_of_row = torch.arange(ep, device=toks.device)[:, None, None] * e_local
    global_e = torch.where(ex.valid, recv_e.to(torch.int64) + owner_of_row, E)
    local_b = bucket_by_destination(recv_tok.reshape(ep * rows, d), global_e.reshape(-1), E, cap2)
    out = expert_ffn(p["w_gate"], p["w_up"], p["w_down"], local_b.data)   # [E, cap2, d]
    res = unbucket(out, local_b.position)
    res = res.reshape(ep, ep, capacity, d)                    # [receiver, sender, cap, d]
    if cfg.moe_dispatch_int8:
        rq, rscale = q8(res)
        back = (return_all_to_all(rq, ex.position).float()
                * return_all_to_all(rscale, ex.position))
    else:
        back = return_all_to_all(res, ex.position)            # [ep, T*k, d]
    contrib = back.reshape(ep, T, k, d).float() * weights[..., None].float()
    y = contrib[:, :, 0].clone()                              # f32, in top-k order
    for j in range(1, k):
        y += contrib[:, :, j]
    return y.to(toks.dtype), ex.dropped


def _moe_gather_ep(p, cfg, toks: torch.Tensor, weights: torch.Tensor, experts: torch.Tensor,
                   ep: int):
    """One dp row's gather dispatch: toks [T, d] seen by every one of the ep
    shards, weights and experts [T, k].  Returns (y [T, d], records per
    expert [E] int32, drops [] int32)."""
    T, d = toks.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    cap = max(8, int(2 * T * k // ep))
    flat_expert = experts.reshape(-1)
    record = torch.arange(T * k, device=toks.device)
    # shard r buckets the records of its own experts: over every shard, one
    # bucketing by global expert ([E, cap], shard-major)
    b = bucket_by_destination(record, flat_expert, E, cap)
    out = expert_ffn(p["w_gate"], p["w_up"], p["w_down"], toks[b.data // k])
    # each record's weighted output, 0 for a record past its expert's capacity
    contrib = unbucket(out, b.position) * weights.reshape(-1)[:, None]
    # the token id rides as an activation-dtype column; an id that rounds
    # past the last token is dropped, as the reference's scatter drops it
    row = (record // k).to(toks.dtype).to(torch.int64)
    row = torch.where(row < T, row, T)
    # Each shard's scatter-add in its slot order (expert, then record), with
    # no atomics: every row's records sorted by (row, expert, record), then
    # summed one position at a time into that row of their shard's partial,
    # in f32 and rounded once, as index_add_ sums a low-precision dtype on
    # the CPU
    order = torch.argsort((row * E + flat_expert) * (T * k) + record)
    sorted_row = row[order]
    rows = torch.arange(T, device=toks.device)
    start = torch.searchsorted(sorted_row, rows)
    end = torch.searchsorted(sorted_row, rows, right=True)
    at = start[:, None] + torch.arange(k * _tokens_per_row(T, toks.dtype), device=toks.device)
    rec = order[at.clamp(max=T * k - 1)]                      # [T, L]
    owner = flat_expert[rec] // (E // ep)
    mine = (at < end[:, None]) & (owner == torch.arange(ep, device=toks.device)[:, None, None])
    parts = torch.where(mine[..., None], contrib[rec].float(), 0)   # [ep, T, L, d]
    partial = torch.zeros(ep, T, d, dtype=torch.float32, device=toks.device)
    for j in range(parts.shape[2]):
        partial += parts[:, :, j]
    partial = partial.to(toks.dtype)
    y = partial[0].clone()                                    # the psum over the ep shards
    for r in range(1, ep):
        y += partial[r]
    return y, b.counts, b.dropped


@functools.lru_cache(maxsize=None)
def _tokens_per_row(T: int, dtype: torch.dtype) -> int:
    """The most token ids below T that round to one row id in `dtype` (1
    wherever the dtype holds every id exactly), computed on the host."""
    ids = torch.arange(T).to(dtype).to(torch.int64)
    ids = ids[ids < T]
    return int(torch.unique_consecutive(ids, return_counts=True)[1].max()) if T else 1


def _lb_loss(cfg, probs: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss of each shard, probs [n, T, E] and
    records per expert [n, E]: E * sum(mean probability * mean assignments)
    (integer counts: exact in any order)."""
    T = probs.shape[1]
    return cfg.num_experts * (probs.mean(dim=1) * (counts.float() / T)).sum(dim=-1)


def moe_expert_parallel(p, cfg, x: torch.Tensor, dist: DistContext):
    """The routed experts of [B, S, d] over dist.dp x dist.ep shards (the
    reference's `moe_ffn` under a "model" mesh axis).  Returns (y, aux)."""
    B, S, d = x.shape
    dp, ep = dist.dp, dist.ep
    E, k = cfg.num_experts, cfg.experts_per_tok
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} expert shards")
    if B % dp:
        raise ValueError(f"batch {B} does not split over {dp} data shards")
    Bl = B // dp
    if S % ep == 0 and S >= ep:
        Sl = S // ep
        T = Bl * Sl
        cap = int(cfg.moe_capacity_factor * Bl * Sl * k / ep) + 8
        # shard (i, r): batch rows of data shard i, sequence block r
        toks = x.reshape(dp, Bl, ep, Sl, d).transpose(1, 2).reshape(dp, ep, T, d)
        w, e, probs, z_loss = route(p, cfg, toks.reshape(-1, d))
        w, e = w.reshape(dp, ep, T, k), e.reshape(dp, ep, T, k)
        ys, drops = [], []
        for i in range(dp):
            y_i, drop_i = _moe_alltoall(p, cfg, toks[i], w[i], e[i], cap)
            ys.append(y_i)
            drops.append(drop_i)
        y = torch.stack(ys).reshape(dp, ep, Bl, Sl, d).transpose(1, 2).reshape(B, S, d)
        # every shard's records per expert from one histogram of (shard, expert)
        shard = torch.arange(dp * ep, device=x.device).repeat_interleave(T * k)
        counts = bucket_hist((shard * E + e.reshape(-1)).to(torch.int32), dp * ep * E)
        lb = _lb_loss(cfg, probs.reshape(dp * ep, T, E), counts.reshape(dp * ep, E))
    else:
        T = Bl * S
        toks = x.reshape(dp, T, d)
        w, e, probs, z_loss = route(p, cfg, x.reshape(B * S, d))
        w, e = w.reshape(dp, T, k), e.reshape(dp, T, k)
        ys, counts, drops = [], [], []
        for i in range(dp):
            y_i, counts_i, drop_i = _moe_gather_ep(p, cfg, toks[i], w[i], e[i], ep)
            ys.append(y_i)
            counts.append(counts_i)
            drops.append(drop_i)
        y = torch.stack(ys).reshape(B, S, d)
        lb = _lb_loss(cfg, probs.reshape(dp, T, E), torch.stack(counts))
    aux = {"lb_loss": lb.mean(), "z_loss": z_loss,
           "dropped": torch.stack(drops).sum().to(torch.int32)}
    return y, aux


def moe_ffn(p, cfg, x: torch.Tensor,
            dist: Optional[DistContext] = None) -> Tuple[torch.Tensor, dict]:
    """Full MoE sublayer on [B, S, d].  Returns (y, aux): aux holds lb_loss,
    z_loss (f32) and dropped (int32), each a 0-d tensor.  The dense dispatch
    without `dist` or under moe_dispatch "dense", else expert parallel."""
    B, S, d = x.shape
    if dist is not None and dist.moe_dispatch not in ("dense", "alltoall"):
        raise ValueError(f"moe_dispatch {dist.moe_dispatch!r}: 'dense' or 'alltoall'")
    if dist is not None and dist.moe_dispatch == "alltoall":
        y, aux = moe_expert_parallel(p, cfg, x, dist)
    else:
        toks = x.reshape(B * S, d)
        w, e, probs, z_loss = route(p, cfg, toks)
        y, counts, dropped = moe_dense(p, cfg, toks, w, e)
        lb_loss = _lb_loss(cfg, probs[None], counts[None])[0]
        aux = {"lb_loss": lb_loss, "z_loss": z_loss, "dropped": dropped}
        y = y.reshape(B, S, d)
    if "shared" in p:
        sp = p["shared"]
        y = y + (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    return y, aux
