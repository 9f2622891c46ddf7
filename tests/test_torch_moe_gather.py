"""The expert-parallel gather route's combine (`models/moe.py::_moe_gather_ep`)
on the CPU against a scatter-add by `index_add_` over the same bucketed
records in slot order, the combine the route had before it summed without
atomics: bit for bit, in f32 and bf16, with records past capacity dropped
and, at T above 256 in bf16, token ids that round onto a neighbour's row
(the reference's quirk, tests/test_torch_moe_ep.py).  The reference's own
gather route is held to the port in tests/test_torch_moe_ep.py; this file
pins that the order-fixed sum kept the CPU's bits."""

import numpy as np
import pytest
import torch

from repro_torch.distributed.collectives import bucket_by_destination
from repro_torch.models import moe
from repro_torch.models.nn import DistContext

# (T, ep, E, k, skew); skew favours the first 3 experts.  The capacity
# max(8, 2 T k / ep) holds every record of an expert (at most T) unless
# ep > 2 k: at (8, 16, 2) the skewed experts overflow
CASES = [(T, ep, E, k, skew) for T in (6, 37, 300)
         for ep, E, k in ((2, 8, 2), (4, 64, 6), (8, 16, 2)) for skew in (False, True)]


class _Cfg:
    def __init__(self, E, k):
        self.num_experts, self.experts_per_tok = E, k


def _index_add_gather(p, cfg, toks, weights, experts, ep):
    """The scatter-add of each shard's weighted expert outputs onto the row
    of the token id carried in the activation dtype, by index_add_ in slot
    order, then the sum over shards."""
    T, d = toks.shape
    E, k = cfg.num_experts, cfg.experts_per_tok
    cap = max(8, int(2 * T * k // ep))
    record = torch.arange(T * k)
    b = bucket_by_destination(record, experts.reshape(-1), E, cap)
    rec, valid = b.data, b.valid
    tok = rec // k
    out = moe.expert_ffn(p["w_gate"], p["w_up"], p["w_down"], toks[tok])
    contrib = torch.where(valid[..., None], out * weights.reshape(-1)[rec][..., None], 0)
    row = tok.to(toks.dtype).to(torch.int64)
    inside = row < T
    contrib = torch.where(inside[..., None], contrib, 0)
    row = torch.where(inside, row, 0).reshape(ep, -1) + T * torch.arange(ep)[:, None]
    partial = torch.zeros(ep * T, d, dtype=toks.dtype)
    partial.index_add_(0, row.reshape(-1), contrib.reshape(-1, d))
    partial = partial.reshape(ep, T, d)
    y = partial[0].clone()
    for r in range(1, ep):
        y += partial[r]
    return y, b.counts, b.dropped


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,ep,E,k,skew", CASES)
def test_gather_combine_is_index_add_bit_for_bit(T, ep, E, k, skew, dtype):
    g = torch.Generator().manual_seed(T * 131 + E + k + skew)
    d, ff = 32, 24
    p = {name: (torch.randn(shape, generator=g) / shape[1] ** 0.5).to(dtype)
         for name, shape in (("w_gate", (E, d, ff)), ("w_up", (E, d, ff)), ("w_down", (E, ff, d)))}
    toks = torch.randn(T, d, generator=g).to(dtype)
    logits = torch.randn(T, E, generator=g)
    if skew:
        logits[:, :3] += 5.0
    top = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True)
    weights, experts = top.values[:, :k].to(dtype), top.indices[:, :k]
    cfg = _Cfg(E, k)
    y, counts, dropped = moe._moe_gather_ep(p, cfg, toks, weights, experts, ep)
    want_y, want_counts, want_dropped = _index_add_gather(p, cfg, toks, weights, experts, ep)
    assert torch.equal(y, want_y)
    assert torch.equal(counts, want_counts) and int(dropped) == int(want_dropped)
    if skew and T >= 37 and ep > 2 * k:
        assert int(dropped) > 0


def test_gather_route_keeps_the_dense_gradient():
    """Under autograd the gather route's gradient is dense dispatch's where
    nothing drops (f32): the order-fixed sum differentiates like a scatter."""
    gen = torch.Generator().manual_seed(5)
    d, E, k, ff = 16, 8, 2, 12
    p = {"router": torch.randn(d, E, generator=gen) / d ** 0.5,
         "w_gate": torch.randn(E, d, ff, generator=gen) / d ** 0.5,
         "w_up": torch.randn(E, d, ff, generator=gen) / d ** 0.5,
         "w_down": torch.randn(E, ff, d, generator=gen) / ff ** 0.5}
    cfg = type("C", (), dict(num_experts=E, experts_per_tok=k, norm_topk_prob=True,
                             num_shared_experts=0))()
    x = torch.randn(2, 3, d, generator=gen)
    grads = []
    for dist in (None, DistContext(dp=1, ep=4, moe_dispatch="alltoall")):
        leaves = [v.clone().requires_grad_(True) for v in p.values()]
        xx = x.clone().requires_grad_(True)
        y, aux = moe.moe_ffn(dict(zip(p, leaves)), cfg, xx, dist)
        assert int(aux["dropped"]) == 0
        grads.append(torch.autograd.grad((y ** 2).sum(), leaves + [xx]))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
