"""The port's LM (`repro_torch.models`, device="cpu") against the reference's:
the dense family, MoE (qwen3-moe smoke) and MLA + MoE with a dense prefix
layer (deepseek-v2 smoke).

The reference runs once per file in a subprocess (tests/torch_parity.py): it
initialises each smoke config, exports its parameters as numpy and computes
`forward` (logits and the MoE aux sums), `prefill` and `decode_step` (scalar
cache length, then per-sequence [B] lengths) on tokens drawn with numpy from
a seed.  The port loads the same parameters through `params_from_reference`
and must give the same logits, aux sums and cache contents (the reference's
prefix and stacked block caches, stacked, against the port's [L, ...] ones:
k/v for GQA, c_kv/k_rope for MLA).

Tolerances: the f32 configs agree to 1e-5 absolute on logits and cache
values up to ~3.6 (sums in another order; rsqrt, silu, exp and the rope
angles round differently in XLA and in PyTorch; the largest difference seen
is 2.6e-6).  The bf16 case rounds every activation to 8 significant bits,
and XLA and PyTorch round at different places (XLA fuses elementwise chains
in f32, PyTorch rounds after each op): the cache differs by one or two bf16
ulps (2^-6 = 0.016 in [2, 4)), and the f32 logits, a product of the rounded
final activations, by up to 0.051.  The bf16 tolerance is 1e-1.  The MoE
`dropped` sums are counts and must be equal.

MoE routing is a discrete choice: the reference records the experts of
every router call (a `jax.debug.callback` on its `_route`, which leaves its
values as they were), and the port runs with those experts (its own
probabilities at them), so the rest of the model is held at TOL.  The
port's own top-k must equal the reference's in f32.  In bf16 the router
logits keep 8 bits, so ties and near-ties are common, and 1-ulp
differences of the activations flip them (2 of the deepseek smoke's 96
bf16 token routes here); there the port's own choice may differ only where
its logits of the experts in question lie within ROUTE_TIE of its k-th
largest (8 ulps of a logit near 1).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import convert, moe, transformer
from torch_parity import run_reference

CASES = [("internlm2-1.8b", "float32"), ("codeqwen1.5-7b", "float32"),
         ("internlm2-1.8b", "bfloat16"), ("qwen3-moe-235b-a22b", "float32"),
         ("deepseek-v2-lite-16b", "float32"), ("deepseek-v2-lite-16b", "bfloat16")]
TOL = {"float32": 1e-5, "bfloat16": 1e-1}
ROUTE_TIE = 2.0 ** -4
_PORT_ROUTE = moe.route
B, S, N_PRE, MAX_LEN = 2, 12, 7, 32
DECODE_STEPS = 3
VEC_LENGTHS = [7, 4]          # per-sequence lengths for the [B]-length decode


def _key(arch, dtype):
    return f"{arch}_{dtype}"


def _cfg(arch, dtype):
    return get_smoke_config(arch).with_(dtype=dtype)


def _tokens(vocab):
    return np.random.default_rng(5).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def reference():
    body = f"""
import jax.numpy as jnp
from repro.configs.base import get_smoke_config
from repro.models.nn import paths_from_tree
from repro.models.registry import get_model, init_all

import jax
from repro.models import moe

def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))

ROUTES = []
_route = moe._route

def recorded_route(p, cfg, x):   # the reference's _route, its experts recorded
    w, e, aux = _route(p, cfg, x)
    jax.debug.callback(lambda e: ROUTES.append(np.asarray(e)), e, ordered=True)
    return w, e, aux

def stacked(cache, f):   # a cache leaf of every layer, the prefix layers first: [L, ...]
    return f32(jnp.concatenate([c[f][None] for c in cache["prefix"]] + [cache["blocks"][f]]))

for arch, dtype in {CASES!r}:
    key = arch + "_" + dtype
    cfg = get_smoke_config(arch).with_(dtype=dtype)
    params, _ = init_all(cfg, seed=0)
    flat = paths_from_tree({{k: v for k, v in params.items() if k != "prefix"}})
    for i, layer in enumerate(params["prefix"]):
        flat.update(paths_from_tree(layer, f"prefix/{{i}}"))
    for path, v in flat.items():
        OUT[key + "/param/" + path] = f32(v)
    api = get_model(cfg)
    tokens = jnp.asarray(np.random.default_rng(5).integers(0, cfg.vocab_size, ({B}, {S})), jnp.int32)
    plain_logits = f32(api.forward(cfg, params, {{"tokens": tokens}})[0])
    moe._route = recorded_route
    ROUTES.clear()
    logits, aux = api.forward(cfg, params, {{"tokens": tokens}})
    assert (f32(logits) == plain_logits).all(), "recording the routes changed the reference"
    OUT[key + "/forward"] = f32(logits)
    for f, v in aux.items():
        OUT[key + "/aux_" + f] = f32(v)
    cache = api.init_cache(cfg, {B}, {MAX_LEN})
    logits, cache = api.prefill(cfg, params, {{"tokens": tokens[:, :{N_PRE}]}}, cache)
    OUT[key + "/prefill"] = f32(logits)
    for i in range({DECODE_STEPS}):
        logits, cache = api.decode_step(cfg, params, tokens[:, {N_PRE} + i:{N_PRE} + i + 1], cache)
        OUT[key + f"/decode{{i}}"] = f32(logits)
    for f in cache["blocks"]:
        OUT[key + "/cache_" + f] = stacked(cache, f)
    lengths = jnp.asarray({VEC_LENGTHS!r}, jnp.int32)
    L = cache["blocks"]["length"].shape[0]
    cache = {{"prefix": [dict(c, length=lengths) for c in cache["prefix"]],
              "blocks": dict(cache["blocks"], length=jnp.broadcast_to(lengths, (L, {B})))}}
    for i in range(2):
        logits, cache = api.decode_step(cfg, params, tokens[:, {S} - 2 + i:{S} - 1 + i], cache)
        OUT[key + f"/vdecode{{i}}"] = f32(logits)
    for f in cache["blocks"]:
        OUT[key + "/vcache_" + f] = stacked(cache, f)
    jax.effects_barrier()
    moe._route = _route
    for i, e in enumerate(ROUTES):
        OUT[key + f"/route{{i}}"] = e
"""
    return run_reference(body)


def _flat(ref, key):
    pre = key + "/param/"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _close(got: torch.Tensor, want: np.ndarray, tol: float, what: str):
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape), want.shape)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0, err_msg=what)


class _ReferenceRoutes:
    """Runs the port's router with the reference's recorded experts, in call
    order, and keeps the port's own choice and logits of each call."""

    def __init__(self, ref, key, cfg):
        self.cfg = cfg
        self.routes = [ref[f"{key}/route{i}"] for i in range(len(ref))
                       if f"{key}/route{i}" in ref]
        self.calls = []      # (own experts, own router logits f32, reference experts)

    def route(self, p, cfg, x):
        logits = (x @ p["router"]).float()
        probs = torch.softmax(logits, dim=-1)
        own = _PORT_ROUTE(p, cfg, x)[1]
        experts = torch.from_numpy(self.routes[len(self.calls)]).long()
        self.calls.append((own, logits, experts))
        weights = probs.gather(1, experts)
        if cfg.norm_topk_prob:
            weights = weights / weights.sum(dim=-1, keepdim=True)
        z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
        return weights.to(x.dtype), experts, probs, z_loss

    def check(self, dtype):
        """Every router call was replayed; the port's own top-k is the
        reference's, or in bf16 differs only at a near-tie."""
        assert len(self.calls) == len(self.routes)
        k = self.cfg.experts_per_tok
        flips = 0
        for own, logits, ref in self.calls:
            for t in range(own.shape[0]):
                a, b = set(own[t].tolist()), set(ref[t].tolist())
                if a == b:
                    continue
                flips += 1
                assert dtype == "bfloat16", ("f32 route differs", t, own[t], ref[t])
                kth = torch.sort(logits[t], descending=True).values[k - 1]
                gap = max(abs(float(logits[t, e] - kth)) for e in a ^ b)
                assert gap <= ROUTE_TIE * max(1.0, abs(float(kth))), (t, own[t], ref[t], logits[t])
        return flips


def _cache_leaves(cfg):
    return ("c_kv", "k_rope") if cfg.kv_lora_rank else ("k", "v")


def _tree_paths(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_paths(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


@pytest.mark.parametrize("arch,dtype", CASES)
def test_params_from_reference_round_trip(reference, arch, dtype):
    cfg = _cfg(arch, dtype)
    flat = _flat(reference, _key(arch, dtype))
    params = convert.params_from_reference(cfg, flat, device="cpu")
    assert len(params["blocks"]) == cfg.num_layers
    # the port's tree, restacked, is the reference's: every leaf, no more
    # (the first_k_dense prefix layers unstacked under prefix/<i>)
    n_prefix = cfg.first_k_dense if cfg.num_experts else 0
    back = {"embed/tokens": params["embed"]["tokens"], "ln_f/scale": params["ln_f"]["scale"],
            "unembed/w": params["unembed"]["w"]}
    for i in range(n_prefix):
        back.update(_tree_paths(params["blocks"][i], f"prefix/{i}"))
    stacked = [_tree_paths(b, "blocks") for b in params["blocks"][n_prefix:]]
    back.update({path: torch.stack([s[path] for s in stacked]) for path in stacked[0]})
    assert sorted(back) == sorted(flat)
    for path, t in back.items():
        assert t.dtype == cfg.torch_dtype, path
        np.testing.assert_array_equal(t.float().numpy(), flat[path], err_msg=path)
    # the port's own initialiser gives the same tree of shapes and dtypes
    own = transformer.init_params(cfg, _factory(cfg))
    assert _shapes(own) == _shapes(params)


def _factory(cfg):
    from repro_torch.models.nn import ParamFactory
    return ParamFactory(torch.Generator().manual_seed(0), "cpu", cfg.torch_dtype)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_prefill_decode_match_reference(reference, arch, dtype, monkeypatch):
    key, cfg, tol = _key(arch, dtype), _cfg(arch, dtype), TOL[dtype]
    params = convert.params_from_reference(cfg, _flat(reference, key), device="cpu")
    routes = _ReferenceRoutes(reference, key, cfg)
    monkeypatch.setattr(moe, "route", routes.route)
    tokens = torch.from_numpy(_tokens(cfg.vocab_size))
    logits, aux = transformer.forward(cfg, params, {"tokens": tokens})
    _close(logits, reference[key + "/forward"], tol, "forward")
    for f in ("lb_loss", "z_loss"):
        _close(aux[f], reference[key + "/aux_" + f], tol, f"forward aux {f}")
    assert float(aux["dropped"]) == float(reference[key + "/aux_dropped"])

    cache = transformer.init_cache(cfg, B, MAX_LEN, device="cpu")
    logits, cache = transformer.prefill(cfg, params, {"tokens": tokens[:, :N_PRE]}, cache)
    _close(logits, reference[key + "/prefill"], tol, "prefill")
    for i in range(DECODE_STEPS):
        logits, cache = transformer.decode_step(cfg, params, tokens[:, N_PRE + i:N_PRE + i + 1],
                                                cache)
        _close(logits, reference[key + f"/decode{i}"], tol, f"decode {i}")
    for f in _cache_leaves(cfg):
        _close(cache[f], reference[key + "/cache_" + f], tol, "cache " + f)
    assert int(cache["length"]) == N_PRE + DECODE_STEPS
    assert (reference[key + "/cache_length"] == N_PRE + DECODE_STEPS).all()

    # per-sequence lengths, as the serve engine keeps them
    cache["length"] = torch.tensor(VEC_LENGTHS, dtype=torch.int32)
    for i in range(2):
        logits, cache = transformer.decode_step(cfg, params, tokens[:, S - 2 + i:S - 1 + i], cache)
        _close(logits, reference[key + f"/vdecode{i}"], tol, f"[B]-length decode {i}")
    for f in _cache_leaves(cfg):
        _close(cache[f], reference[key + "/vcache_" + f], tol, "[B]-length cache " + f)
    np.testing.assert_array_equal(cache["length"].numpy(), reference[key + "/vcache_length"][0])
    routes.check(dtype)
