"""The port's MoE layer (`repro_torch.models.moe.moe_ffn`, device="cpu") against
the reference's (`repro.models.moe.moe_ffn` with `dist=None`, its dense
dispatch).

The reference runs once per file in a subprocess (tests/torch_parity.py): it
initialises a smoke config, takes the first MoE layer's parameters, and runs
`moe_ffn` on inputs drawn with numpy from a seed (the same helper builds them
on both sides).  The cases: both MoE smokes on random activations; every
token sent to one expert (16 experts, so the capacity of T k 4 / E = T / 2
drops half of each of the two chosen experts' records); a planted three-way
tie of router probabilities at the top-k boundary; a bucketed prefill whose
right-padding (identical rows) takes capacity.  y, lb_loss and z_loss
agree to 1e-5 (f32; sums in another order), `dropped` is equal.
"""

import inspect

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import collectives
from repro_torch.models import moe
from torch_parity import run_reference

# name: arch, config overrides, input kind, (B, S)
CASES = {
    "qwen3_smoke": ("qwen3-moe-235b-a22b", {}, "random", (2, 12)),
    "deepseek_smoke": ("deepseek-v2-lite-16b", {}, "random", (2, 12)),
    "forced_drop": ("qwen3-moe-235b-a22b", {"num_experts": 16}, "one_expert", (2, 16)),
    "topk_tie": ("qwen3-moe-235b-a22b", {}, "tie", (2, 12)),
    "padded_prefill": ("deepseek-v2-lite-16b", {"num_experts": 16}, "padded", (1, 64)),
}
TOL = 1e-5
TIED = (6, 2, 5)          # experts of equal router probability in "topk_tie"
REAL_TOKENS = 30          # "padded_prefill": the rest are the pad token's identical rows


def _inputs(name, router):
    """(x [B, S, d], router [d, E]) of a case, from numpy seeds."""
    _, _, kind, (B, S) = CASES[name]
    d, E = router.shape
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    if kind == "one_expert":       # x > 0, only expert 3's column is nonzero
        x, router = np.abs(x), np.zeros_like(router)
        router[:, 3] = 1.0 / d
    elif kind == "tie":            # x > 0; the TIED columns 0 (logit exactly 0), the rest < 0
        x, router = np.abs(x), np.full_like(router, -1.0 / d)
        router[:, list(TIED)] = 0.0
    elif kind == "padded":         # a bucketed prefill: right-padding of one token's rows
        x[:, REAL_TOKENS:] = x[:, REAL_TOKENS - 1:REAL_TOKENS] + 0.5
    return x, router


@pytest.fixture(scope="module")
def reference():
    body = f"""
import jax
import jax.numpy as jnp
from repro.configs.base import get_smoke_config
from repro.models.moe import moe_ffn
from repro.models.nn import paths_from_tree
from repro.models.registry import init_all
CASES = {CASES!r}
TIED = {TIED!r}
REAL_TOKENS = {REAL_TOKENS!r}
{inspect.getsource(_inputs)}
for name, (arch, over, kind, shape) in CASES.items():
    cfg = get_smoke_config(arch).with_(**over)
    params, _ = init_all(cfg, seed=0)
    p = jax.tree.map(lambda a: a[0], params["blocks"]["ffn"])
    x, router = _inputs(name, np.asarray(p["router"], np.float32))
    p = dict(p, router=jnp.asarray(router))
    for path, v in paths_from_tree(p).items():
        OUT[name + "/param/" + path] = np.asarray(v, np.float32)
    OUT[name + "/x"] = x
    y, aux = moe_ffn(p, cfg, jnp.asarray(x), None)
    OUT[name + "/y"] = np.asarray(y, np.float32)
    for k, v in aux.items():
        OUT[name + "/aux_" + k] = np.asarray(v, np.float32)
"""
    return run_reference(body)


def _params(ref, name):
    pre = name + "/param/"
    out = {}
    for path, v in ref.items():
        if path.startswith(pre):
            *groups, leaf = path[len(pre):].split("/")
            tree = out
            for g in groups:
                tree = tree.setdefault(g, {})
            tree[leaf] = torch.from_numpy(v)
    return out


def _run(ref, name):
    arch, over = CASES[name][:2]
    cfg = get_smoke_config(arch).with_(**over)
    p = _params(ref, name)
    return cfg, p, moe.moe_ffn(p, cfg, torch.from_numpy(ref[name + "/x"]))


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_reference(reference, name):
    _, _, (y, aux) = _run(reference, name)
    np.testing.assert_allclose(y.numpy(), reference[name + "/y"], atol=TOL, rtol=0)
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(reference[name + "/aux_" + k]),
                                   atol=TOL, rtol=TOL, err_msg=k)
    assert aux["dropped"].dtype == torch.int32
    assert int(aux["dropped"]) == int(reference[name + "/aux_dropped"])


def test_forced_drop_drops_past_capacity(reference):
    """Every token's first choice is expert 3 and its second expert 0 (a tie
    of the other 15 at logit 0): 32 records each for a capacity of 16."""
    cfg, p, (_, aux) = _run(reference, "forced_drop")
    x = torch.from_numpy(reference["forced_drop/x"])
    experts = moe.route(p, cfg, x.reshape(-1, x.shape[-1]))[1]
    assert (experts == torch.tensor([3, 0])).all()
    assert int(aux["dropped"]) == 32


def test_topk_tie_keeps_the_lower_experts(reference):
    """Three experts of exactly equal probability at the top-k boundary
    (k = 2): the two lowest are taken, in index order, as jax.lax.top_k does."""
    cfg, p, _ = _run(reference, "topk_tie")
    x = torch.from_numpy(reference["topk_tie/x"])
    weights, experts, _, _ = moe.route(p, cfg, x.reshape(-1, x.shape[-1]))
    assert (experts == torch.tensor(sorted(TIED)[:2])).all()
    assert torch.equal(weights, torch.full_like(weights, 0.5))


def test_padded_prefill_takes_capacity(reference):
    """The capacity counts every token given, right-padding included:
    max(8, 64 * 2 * 4 / 16) = 32, not the 30 real tokens' 15; the 34
    identical pad rows overflow their experts."""
    cfg, p, (_, aux) = _run(reference, "padded_prefill")
    dropped = int(aux["dropped"])
    assert dropped == int(reference["padded_prefill/aux_dropped"]) > 0
    x = torch.from_numpy(reference["padded_prefill/x"])
    _, real_aux = moe.moe_ffn(p, cfg, x[:, :REAL_TOKENS])
    assert int(real_aux["dropped"]) != dropped


def test_moe_ffn_counts_the_experts_once(reference, monkeypatch):
    """One histogram a layer: lb_loss's assignments per expert are the
    dispatch's bucket_hist counts (one call, and no torch.bincount, which on
    the card reads the ids' min and max back to the host)."""
    calls = []
    hist = collectives.bucket_hist

    def counting(dest, k):
        calls.append(k)
        return hist(dest, k)

    def refuse(*args, **kw):
        raise AssertionError("torch.bincount called")

    monkeypatch.setattr(collectives, "bucket_hist", counting)
    monkeypatch.setattr(torch, "bincount", refuse)
    cfg, _, (_, aux) = _run(reference, "deepseek_smoke")
    assert calls == [cfg.num_experts]
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(reference["deepseek_smoke/aux_lb_loss"]), atol=TOL, rtol=TOL)


def test_combine_sums_in_ascending_expert_order():
    """bf16: each token's k weighted expert outputs are summed in ascending
    expert order, each add rounded to bf16 (the reference's scatter-add order
    over the expert-sorted records), whatever order top-k gave them in."""
    cfg = get_smoke_config("deepseek-v2-lite-16b").with_(dtype="bfloat16", experts_per_tok=4)
    gen = torch.Generator().manual_seed(3)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {name: torch.randn(shape, generator=gen).to(torch.bfloat16) * 0.2 for name, shape in
         (("w_gate", (E, d, ff)), ("w_up", (E, d, ff)), ("w_down", (E, ff, d)))}
    x = torch.randn(10, d, generator=gen).to(torch.bfloat16)
    weights = torch.rand(10, 4, generator=gen).to(torch.bfloat16)
    experts = torch.stack([torch.randperm(E, generator=gen)[:4] for _ in range(10)])
    y, counts, dropped = moe.moe_dense(p, cfg, x, weights, experts)
    assert int(dropped) == 0
    assert torch.equal(counts, torch.bincount(experts.reshape(-1), minlength=E).int())
    for t in range(10):
        order = torch.argsort(experts[t])
        want = torch.zeros(d, dtype=torch.bfloat16)
        for j in order.tolist():
            e = int(experts[t, j])
            h = moe.expert_ffn(p["w_gate"][e:e + 1], p["w_up"][e:e + 1], p["w_down"][e:e + 1],
                               x[t].reshape(1, 1, d))
            want = want + h.reshape(d) * weights[t, j]
        assert torch.equal(y[t], want), t
