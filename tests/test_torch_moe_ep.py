"""The port's expert-parallel MoE dispatch (`repro_torch.models.moe` under a
`DistContext` of moe_dispatch "alltoall", device="cpu") against the
reference's (`repro.models.moe.moe_ffn` inside `shard_map` over a ("data",
"model") mesh of fake CPU devices).

The reference runs once per file in a subprocess (tests/torch_parity.py, 8
fake devices): it builds `Mesh(devices[:dp * ep].reshape(dp, ep), ("data",
"model"))` and `make_dist(cfg, mesh, None, fsdp=False,
moe_dispatch="alltoall")`, takes the first MoE layer's parameters of a smoke
config, and runs `moe_ffn` on inputs drawn with numpy from a seed (the same
helper builds them on both sides); the port takes the same parameters and a
`make_dist(cfg, {"data": dp, "model": ep})`.  The cases:

  * both MoE smokes (f32) at meshes (1, 2), (1, 4), (2, 4), (1, 8), with S a
    multiple of ep (all_to_all) and S 1 and 6 (gather): y within 1e-5,
    lb_loss and z_loss within 1e-6, `dropped` equal;
  * capacity factor 0.25: the exchange drops, as many as the reference;
  * every token to experts 0 and 1, both on shard 0 (16 experts over 2
    shards): the receiver's local capacity overflows, zeroed and not counted;
  * the int8 payload: the codes, scales and local expert ids the port's
    layer hands `capacity_all_to_all` bit-equal to the reference's (recorded
    inside its shard_map by a `jax.debug.callback` on the same function),
    the layer within one quantisation step of the reference's and farther
    than 1e-5 from the full-precision payload's output;
  * bf16 gather at T 300: the port equals the reference (1e-1, the tests'
    bf16 tolerance), and both carry the reference's token-id column in bf16,
    where token 257's partial lands on row 256 and token 299's rounds to 300
    and is dropped;
  * `forward` at (2, 4): the reference's EP logits within 1e-5, and dense
    dispatch's within 3e-2 (the reference's tests/test_distributed.py);
  * the Engine at (1, 4): the reference's `Engine(dist=...)` greedy tokens.

Port-only: EP equals dense dispatch where nothing drops, at ep 2, 4, 8.
"""

import inspect

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import make_dist
from repro_torch.models import get_model, moe
from repro_torch.models.convert import params_from_reference
from repro_torch.models.nn import DistContext
from repro_torch.serve import Engine, Request, generate_reference
from torch_parity import run_reference

DS, QW = "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"
MESHES = ((1, 2), (1, 4), (2, 4), (1, 8))


def _cases():
    """name: (arch, config overrides, (dp, ep), (B, S), input kind)."""
    out = {}
    for arch, short in ((DS, "ds"), (QW, "qw")):
        for mesh in MESHES:
            for S in (16, 1, 6):
                out[f"{short}_{mesh[0]}x{mesh[1]}_S{S}"] = (arch, {}, mesh, (2, S), "random")
        out[f"{short}_int8"] = (arch, {"moe_dispatch_int8": True}, (1, 4), (2, 16), "random")
    out["forced_drop"] = (DS, {"moe_capacity_factor": 0.25}, (1, 4), (2, 64), "random")
    out["local_overflow"] = (QW, {"num_experts": 16}, (1, 2), (2, 16), "expert0")
    out["int8_2x4"] = (QW, {"moe_dispatch_int8": True}, (2, 4), (2, 16), "random")
    out["bf16_quirk"] = (QW, {"dtype": "bfloat16"}, (1, 4), (50, 6), "random")
    return out


CASES = _cases()
TOL, AUX_TOL, BF16_TOL = 1e-5, 1e-6, 1e-1
FORWARD_MESH = (2, 4)
ENGINE_ARCH, ENGINE_MESH, ENGINE_REQUESTS = DS, (1, 4), 4


def _inputs(name, router):
    """(x [B, S, d], router [d, E]) of a case, from numpy seeds."""
    _, _, _, (B, S), kind = CASES[name]
    d, E = router.shape
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    if kind == "expert0":          # x > 0, only expert 0's column nonzero: top-2 = experts 0, 1
        x, router = np.abs(x), np.zeros_like(router)
        router[:, 0] = 1.0 / d
    return x, router


def _requests(n, vocab, seed=0, max_new=5):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(1, 7))).tolist(),
                    max_new_tokens=max_new) for i in range(n)]


@pytest.fixture(scope="module")
def reference():
    body = f"""
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.base import get_smoke_config
from repro.distributed.sharding import make_dist
from repro.models import moe as ref_moe
from repro.models.nn import paths_from_tree
from repro.models.registry import get_model, init_all
from repro.serve import Engine, Request
CASES = {CASES!r}
{inspect.getsource(_inputs)}
{inspect.getsource(_requests)}


def mesh_of(shape):
    n = shape[0] * shape[1]
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), ("data", "model"))


def export(prefix, tree):
    flat = paths_from_tree({{k: v for k, v in tree.items() if k != "prefix"}})
    for i, layer in enumerate(tree.get("prefix", [])):
        flat.update(paths_from_tree(layer, f"prefix/{{i}}"))
    for path, v in flat.items():
        OUT[prefix + "/param/" + path] = np.asarray(v, np.float32)


# the int8 cases' exchanges: each shard's payload, by its (data, model) index
exchanged = {{}}
_a2a = ref_moe.capacity_all_to_all


def recording_a2a(data, dest, *, axis, capacity, valid=None):
    def record(i, r, arr):
        kind = "q" if arr.dtype == np.int8 else "side"
        exchanged[(kind, int(i), int(r))] = np.asarray(arr)
    jax.debug.callback(record, jax.lax.axis_index("data"), jax.lax.axis_index("model"), data)
    return _a2a(data, dest, axis=axis, capacity=capacity, valid=valid)


full_params = {{}}


def params_of(arch, num_experts=None):   # init_all(seed=0), f32, once per (arch, experts)
    cfg = get_smoke_config(arch)
    cfg = cfg.with_(num_experts=num_experts or cfg.num_experts)
    key = (arch, cfg.num_experts)
    if key not in full_params:
        full_params[key] = init_all(cfg, seed=0)[0]
    return full_params[key]


def moe_ffn(p, cfg, x, dist):   # under jit: shard_map run eagerly takes ~16 s a call
    return jax.jit(lambda p, x: ref_moe.moe_ffn(p, cfg, x, dist))(p, x)


for name, (arch, over, mesh, shape, kind) in CASES.items():
    cfg = get_smoke_config(arch).with_(**over)
    p = jax.tree.map(lambda a: a[0].astype(cfg.jdtype),
                     params_of(arch, over.get("num_experts"))["blocks"]["ffn"])
    x, router = _inputs(name, np.asarray(p["router"], np.float32))
    p = dict(p, router=jnp.asarray(router, cfg.jdtype))
    for path, v in paths_from_tree(p).items():
        OUT[name + "/param/" + path] = np.asarray(v, np.float32)
    OUT[name + "/x"] = x
    xj = jnp.asarray(x, cfg.jdtype)
    dist = make_dist(cfg, mesh_of(mesh), None, fsdp=False, moe_dispatch="alltoall")
    exchanged.clear()
    ref_moe.capacity_all_to_all = recording_a2a if cfg.moe_dispatch_int8 else _a2a
    y, aux = moe_ffn(p, cfg, xj, dist)
    jax.effects_barrier()
    ref_moe.capacity_all_to_all = _a2a
    OUT[name + "/y"] = np.asarray(y, np.float32)
    for k, v in aux.items():
        OUT[name + "/aux_" + k] = np.asarray(v, np.float32)
    for (kind_, i, r), arr in exchanged.items():
        OUT[f"{{name}}/{{kind_}}_{{i}}_{{r}}"] = arr
    if name == "bf16_quirk":
        OUT[name + "/y_dense"] = np.asarray(moe_ffn(p, cfg, xj, None)[0], np.float32)

# forward at {FORWARD_MESH}: EP and dense logits of both smokes
for arch, layers in (({QW!r}, 2), ({DS!r}, 3)):
    cfg = get_smoke_config(arch)
    assert cfg.num_layers == layers
    params = params_of(arch)
    export("forward_" + arch, params)
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 8)), jnp.int32)
    OUT["forward_" + arch + "/tokens"] = np.asarray(tokens)
    dist = make_dist(cfg, mesh_of({FORWARD_MESH!r}), None, fsdp=False, moe_dispatch="alltoall")
    for tag, d in (("ep", dist), ("dense", None)):
        logits, aux = jax.jit(lambda p, b: get_model(cfg).forward(cfg, p, b, d))(
            params, {{"tokens": tokens}})
        OUT[f"forward_{{arch}}/{{tag}}"] = np.asarray(logits, np.float32)
        OUT[f"forward_{{arch}}/{{tag}}_dropped"] = np.asarray(aux["dropped"], np.float32)

# the Engine at {ENGINE_MESH} over EP dispatch
cfg = get_smoke_config({ENGINE_ARCH!r})
params = params_of({ENGINE_ARCH!r})
export("engine", params)
dist = make_dist(cfg, mesh_of({ENGINE_MESH!r}), None, fsdp=False, moe_dispatch="alltoall")
eng = Engine(cfg, params, max_batch=2, max_len=64, dist=dist)
for uid, toks in eng.run(_requests({ENGINE_REQUESTS}, cfg.vocab_size)).items():
    OUT[f"engine/{{uid}}"] = np.asarray(toks)
"""
    return run_reference(body)


def _cfg(name):
    arch, over = CASES[name][:2]
    return get_smoke_config(arch).with_(**over)


def _params(ref, prefix):
    pre = prefix + "/param/"
    out = {}
    for path, v in ref.items():
        if path.startswith(pre):
            *groups, leaf = path[len(pre):].split("/")
            tree = out
            for g in groups:
                tree = tree.setdefault(g, {})
            tree[leaf] = torch.from_numpy(v)
    return out


def _run(ref, name, cfg=None):
    """The port's moe_ffn on a case: (cfg, params, x, (y, aux))."""
    cfg = cfg or _cfg(name)
    dp, ep = CASES[name][2]
    p = {k: v.to(cfg.torch_dtype) if torch.is_tensor(v) else
         {kk: vv.to(cfg.torch_dtype) for kk, vv in v.items()} for k, v in _params(ref, name).items()}
    x = torch.from_numpy(ref[name + "/x"]).to(cfg.torch_dtype)
    dist = make_dist(cfg, {"data": dp, "model": ep})
    return cfg, p, x, moe.moe_ffn(p, cfg, x, dist)


F32_CASES = [n for n in CASES if n != "bf16_quirk"]


@pytest.mark.parametrize("name", F32_CASES)
def test_moe_ffn_ep_matches_reference(reference, name):
    """y within 1e-5 (1e-5 plus one quantisation step of the layer's output
    for the int8 payload), lb_loss and z_loss within 1e-6, dropped equal."""
    cfg, _, _, (y, aux) = _run(reference, name)
    want = reference[name + "/y"]
    atol = TOL + (np.abs(want).max() / 127 if cfg.moe_dispatch_int8 else 0)
    np.testing.assert_allclose(y.numpy(), want, atol=atol, rtol=0)
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(reference[name + "/aux_" + k]),
                                   atol=AUX_TOL, rtol=AUX_TOL, err_msg=k)
    assert aux["dropped"].dtype == torch.int32
    assert int(aux["dropped"]) == int(reference[name + "/aux_dropped"])


def test_forced_drop_counts_the_exchange_drops(reference):
    """Capacity factor 0.25: int(0.25 x 2 x 16 x 2 / 4) + 8 = 12 slots per
    (sender, receiver) for ~16 records: the exchange drops, as many as the
    reference's, and the local bucketing drops none on top."""
    _, _, _, (_, aux) = _run(reference, "forced_drop")
    assert int(aux["dropped"]) == int(reference["forced_drop/aux_dropped"]) > 0


def test_local_overflow_is_zeroed_and_uncounted(reference):
    """Every token's choices are experts 0 and 1, both on shard 0 of 2 (16
    experts, 8 a shard).  The exchange holds them (capacity 2 x 16 + 8 = 40
    a sender), but shard 0's local capacity is max(8, 2 x 80 / 8) = 20 a
    expert for 32 records: the last 12 of each expert (shard 1's tokens 4-15)
    are zeroed, uncounted, as in the reference; qwen3's smoke has no shared
    expert, so their rows are 0."""
    _, _, _, (y, aux) = _run(reference, "local_overflow")
    want = reference["local_overflow/y"]
    assert int(aux["dropped"]) == 0 == int(reference["local_overflow/aux_dropped"])
    zero = (y.abs().amax(dim=-1) == 0).numpy()
    assert zero.sum() == 12 and (zero == (np.abs(want).max(axis=-1) == 0)).all()
    # shard 1 holds positions 8-15 of each batch row; its tokens (b, s) in order
    assert zero[:, :8].sum() == 0 and zero[0, 12:].all() and zero[1, 8:].all()


@pytest.mark.parametrize("name", ["ds_int8", "qw_int8", "int8_2x4"])
def test_int8_payload_codes_equal_reference(reference, name, monkeypatch):
    """What the port's layer hands its exchanges (each (token, choice)
    record's int8 codes: amax / 127, round half to even, clip to +-127; and
    beside them the f32 scale and local expert id) is bit-equal to what the
    reference's shards exchanged; and the int8 payload changes the layer's
    output: it differs from the same input's full-precision payload by more
    than the f32 tolerance somewhere."""
    sent = []
    exchange = moe.capacity_all_to_all

    def recording(data, dest, **kw):
        sent.append(data.clone())
        return exchange(data, dest, **kw)

    monkeypatch.setattr(moe, "capacity_all_to_all", recording)
    cfg, _, _, (y, _) = _run(reference, name)
    dp, ep = CASES[name][2]
    assert len(sent) == 2 * dp                    # per dp row: the codes, then (scale, expert)
    for i in range(dp):
        q, side = sent[2 * i], sent[2 * i + 1]
        assert q.dtype == torch.int8 and side.dtype == torch.float32 and side.shape[-1] == 2
        for r in range(ep):
            assert torch.equal(q[r], torch.from_numpy(reference[f"{name}/q_{i}_{r}"]))
            assert torch.equal(side[r], torch.from_numpy(reference[f"{name}/side_{i}_{r}"]))
        assert int(q.abs().max()) == 127
    monkeypatch.setattr(moe, "capacity_all_to_all", exchange)
    _, _, _, (y_full, _) = _run(reference, name, cfg.with_(moe_dispatch_int8=False))
    assert float((y - y_full).abs().max()) > TOL


def test_q8_rounds_half_to_even_and_keeps_zero_rows():
    rows = torch.tensor([[0.5, 1.5, 2.5, -127.0], [0.0, 0.0, 0.0, 0.0], [-3.0, 1.0, 0.0, 3.0]])
    q, scale = moe.q8(rows)
    assert scale[:, 0].tolist() == [1.0, 1.0, pytest.approx(3.0 / 127)]
    assert q[0].tolist() == [0, 2, 2, -127] and q[1].tolist() == [0, 0, 0, 0]
    assert q[2].tolist() == [-127, 42, 0, 127]


def test_bf16_gather_token_id_column(reference):
    """bf16 gather (B 50, S 6 over 4 expert shards: T 300 tokens a data
    shard): the port equals the reference within the bf16 tolerance.  Both
    carry each record's token id as a bf16 column, exact only to 256: token
    257's partials land on row 256 (257 rounds to 256), whose output is then
    the dense dispatch's rows 256 + 257, while row 257 gets nothing; token
    299 rounds to 300, past the last row, and is dropped."""
    cfg, _, _, (y, aux) = _run(reference, "bf16_quirk")
    got = y.float().reshape(-1, cfg.d_model).numpy()
    want = reference["bf16_quirk/y"].reshape(-1, cfg.d_model)
    dense = reference["bf16_quirk/y_dense"].reshape(-1, cfg.d_model)
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)
    assert int(aux["dropped"]) == int(reference["bf16_quirk/aux_dropped"]) == 0
    assert float(torch.tensor(257.0).to(torch.bfloat16)) == 256.0
    moved = np.abs(dense[257]).max()          # what row 256 gains from token 257
    assert moved > 0.25
    for out in (got, want):
        np.testing.assert_allclose(out[:256], dense[:256], atol=BF16_TOL, rtol=0)
        assert not np.abs(out[257]).any() and not np.abs(out[299]).any()
        assert np.abs(out[256] - (dense[256] + dense[257])).max() < moved / 10


def _full_params(ref, prefix, cfg):
    pre = prefix + "/param/"
    flat = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
    return params_from_reference(cfg, flat, device="cpu")


@pytest.mark.parametrize("arch,layers", [(QW, 2), (DS, 3)])
def test_forward_ep_matches_reference(reference, arch, layers):
    """forward at (2, 4), tokens [4, 8]: the reference's EP logits within
    1e-5; and, with nothing dropped, its dense dispatch's within 3e-2
    (the reference's test_moe_alltoall_matches_dense_dispatch)."""
    cfg = get_smoke_config(arch).with_(num_layers=layers)
    params = _full_params(reference, "forward_" + arch, cfg)
    tokens = torch.from_numpy(reference[f"forward_{arch}/tokens"])
    dist = make_dist(cfg, {"data": FORWARD_MESH[0], "model": FORWARD_MESH[1]})
    logits, aux = get_model(cfg).forward(cfg, params, {"tokens": tokens}, dist)
    np.testing.assert_allclose(logits.numpy(), reference[f"forward_{arch}/ep"], atol=TOL, rtol=0)
    assert int(aux["dropped"]) == int(reference[f"forward_{arch}/ep_dropped"]) == 0
    np.testing.assert_allclose(logits.numpy(), reference[f"forward_{arch}/dense"],
                               atol=3e-2, rtol=3e-2)


def test_engine_ep_matches_reference(reference):
    """The Engine (2 slots, max_len 64) with a (1, 4) expert dispatch serves
    the reference's `Engine(dist=...)` greedy tokens; prefills of 1-2 tokens
    and the decode waves take the gather route, longer ones all_to_all."""
    cfg = get_smoke_config(ENGINE_ARCH)
    params = _full_params(reference, "engine", cfg)
    dist = make_dist(cfg, {"data": ENGINE_MESH[0], "model": ENGINE_MESH[1]})
    reqs = _requests(ENGINE_REQUESTS, cfg.vocab_size)
    got = Engine(cfg, params, max_batch=2, max_len=64, device="cpu", dist=dist).run(reqs)
    want = {int(k[len("engine/"):]): reference[k].tolist() for k in reference
            if k.startswith("engine/") and k[len("engine/"):].isdigit()}
    assert got == want and len(got) == ENGINE_REQUESTS
    for r in reqs[:2]:
        assert generate_reference(cfg, params, r, max_len=64, device="cpu", dist=dist) == want[r.uid]


@pytest.mark.parametrize("ep", [2, 4, 8])
@pytest.mark.parametrize("arch", [DS, QW])
def test_ep_equals_dense_dispatch_without_drops(arch, ep):
    """Port only: where nothing drops, both EP routes give dense dispatch's
    y and dropped (f32, 1e-5), at every expert-shard count."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(ep)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {"router": torch.randn(d, E, generator=gen) / d ** 0.5,
         "w_gate": torch.randn(E, d, ff, generator=gen) / d ** 0.5,
         "w_up": torch.randn(E, d, ff, generator=gen) / d ** 0.5,
         "w_down": torch.randn(E, ff, d, generator=gen) / ff ** 0.5}
    for S in (2 * ep, 1, ep + 1):
        x = torch.randn(2, S, d, generator=gen)
        want, want_aux = moe.moe_ffn(p, cfg, x)
        y, aux = moe.moe_ffn(p, cfg, x, DistContext(dp=1, ep=ep, moe_dispatch="alltoall"))
        assert int(aux["dropped"]) == int(want_aux["dropped"]) == 0, S
        torch.testing.assert_close(y, want, atol=TOL, rtol=0)


def test_make_dist_follows_the_reference():
    ds, dense = get_smoke_config(DS), get_smoke_config("internlm2-1.8b")
    assert make_dist(ds, {"data": 2, "model": 4}) == DistContext(dp=2, ep=4,
                                                                 moe_dispatch="alltoall")
    assert make_dist(ds, {"pod": 2, "data": 2, "model": 2}).dp == 4
    assert make_dist(dense, {"data": 1, "model": 4}).moe_dispatch == "dense"
    assert make_dist(ds, {"data": 1, "model": 4}, moe_dispatch="dense").moe_dispatch == "dense"
    with pytest.raises(ValueError, match="do not split"):
        make_dist(ds, {"data": 1, "model": 3})
    with pytest.raises(ValueError, match="mesh axes"):
        make_dist(ds, {"data": 1})
    with pytest.raises(ValueError, match="moe_dispatch"):
        make_dist(ds, {"model": 2}, moe_dispatch="ring")


def test_ep_refuses_what_the_reference_mesh_cannot_split():
    cfg = get_smoke_config(DS)
    p = {"router": torch.zeros(cfg.d_model, cfg.num_experts)}
    with pytest.raises(ValueError, match="batch 3"):
        moe.moe_ffn(p, cfg, torch.zeros(3, 4, cfg.d_model), DistContext(dp=2, ep=2,
                                                                         moe_dispatch="alltoall"))
    with pytest.raises(ValueError, match="dp 1"):
        Engine(cfg, {}, max_batch=2, device="cpu", dist=DistContext(dp=2, ep=2,
                                                                    moe_dispatch="alltoall"))
