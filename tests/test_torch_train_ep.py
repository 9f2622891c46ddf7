"""The port's train step under expert-parallel MoE dispatch
(`repro_torch.train.make_train_step(cfg, ocfg, dist)` with `dist =
make_dist(cfg, {"data": 1, "model": ep})`, device="cpu") against the
reference's (`repro.train.make_train_step(cfg, ocfg, dist)` over a ("data",
"model") mesh of fake CPU devices, whose `moe_ffn` runs inside shard_map).

The reference runs once for the file in a subprocess (tests/torch_parity.py,
8 fake devices).  Per case it draws `init_state` (seed 0) and `input_specs`
(seed 0), takes the gradients of its loss at those params
(`jax.value_and_grad` of `make_loss_fn`, the first step's gradients), and
runs 3 jitted train steps; the port starts from the same params
(`params_from_reference`) and batch.  Cases: both MoE smokes at meshes (1,
2) and (1, 4) in f32, all_to_all dispatch (S a multiple of ep); deepseek's
in bf16; qwen3's with the int8 payload; deepseek's at capacity factor 0.25,
where the exchange drops; qwen3's at S 6 over 4 shards, the gather route.

The gather case is held to the reference's dense dispatch: under the
installed jax the gradient of the reference's gather route (tokens
replicated over the "model" axis inside shard_map, the partial outputs
psum'd) is not the gradient of its forward, which equals dense dispatch's
where nothing drops: at this case its ln1 scale's gradient is off by more
than the leaf's largest (`test_reference_gather_grads_are_not_its_forwards`
pins that, ROADMAP.md queue 3).  The port's gather route differentiates to
dense dispatch's gradient, its loss equals both references' losses.

Tolerances are test_torch_train.py's for dense dispatch: losses within
LOSS_RTOL = 1e-5 relative, final params within PARAM_ATOL = 1e-4, and
test_torch_train_grads.py's GRAD_TOL = 1e-5 of each leaf's largest gradient;
lb_loss within 1e-5 and `dropped` equal at every step.  The bf16 case
rounds activations where XLA and PyTorch round apart: its losses within
BF16_LOSS_RTOL = 1e-2, as test_torch_train.py's bf16 smoke.

Port only: dist=None and a dist with moe_dispatch "dense" give the same
losses and params bit for bit (the dense dispatch ignores the mesh).
"""

import inspect

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import make_dist
from repro_torch.models import input_specs
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import train_attention
from repro_torch.train import OptimConfig, init_state, make_train_step, tree
from repro_torch.train.step import make_loss_fn
from torch_parity import one_torch_thread, run_reference  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DS, QW = "deepseek-v2-lite-16b", "qwen3-moe-235b-a22b"
STEPS = 3
LOSS_RTOL, PARAM_ATOL, GRAD_TOL, AUX_TOL = 1e-5, 1e-4, 1e-5, 1e-5
BF16_LOSS_RTOL = 1e-2
OPTIM = dict(lr=3e-3, warmup_steps=2, total_steps=100)

# name: (arch, config overrides, (dp, ep), (B, S))
CASES = {
    "ds_1x2": (DS, {}, (1, 2), (4, 16)),
    "ds_1x4": (DS, {}, (1, 4), (4, 16)),
    "qw_1x2": (QW, {}, (1, 2), (4, 16)),
    "qw_1x4": (QW, {}, (1, 4), (4, 16)),
    "ds_bf16_1x4": (DS, {"dtype": "bfloat16"}, (1, 4), (4, 16)),
    "qw_int8_1x4": (QW, {"moe_dispatch_int8": True}, (1, 4), (4, 16)),
    "ds_drop_1x4": (DS, {"moe_capacity_factor": 0.25}, (1, 4), (2, 64)),
    "qw_gather_1x4": (QW, {}, (1, 4), (4, 6)),
}
GATHER = "qw_gather_1x4"     # its gradients and steps from the reference's dense dispatch
F32_CASES = [n for n, c in CASES.items() if c[1].get("dtype") != "bfloat16"]


def _flat_tree(params):
    """{path: leaf} of a reference params tree, its dense prefix layers under
    prefix/<i>."""
    from repro.models.nn import paths_from_tree

    flat = paths_from_tree({k: v for k, v in params.items() if k != "prefix"})
    for i, layer in enumerate(params.get("prefix", [])):
        flat.update(paths_from_tree(layer, f"prefix/{i}"))
    return flat


@pytest.fixture(scope="module")
def reference():
    body = f"""
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.base import ShapeSpec, get_smoke_config
from repro.distributed.sharding import make_dist
from repro.models.registry import input_specs
from repro.train import OptimConfig, init_state, make_train_step
from repro.train.step import make_loss_fn
CASES = {CASES!r}
{inspect.getsource(_flat_tree)}


def export(prefix, params):
    for path, v in _flat_tree(params).items():
        OUT[prefix + path] = np.asarray(jnp.asarray(v, jnp.float32))


for name, (arch, over, (dp, ep), (B, S)) in CASES.items():
    cfg = get_smoke_config(arch).with_(**over)
    ocfg = OptimConfig(**{OPTIM!r})
    mesh = Mesh(np.asarray(jax.devices()[:dp * ep]).reshape(dp, ep), ("data", "model"))
    dist = make_dist(cfg, mesh, None, fsdp=False, moe_dispatch="alltoall")
    state, _ = init_state(cfg, ocfg)
    batch = input_specs(cfg, ShapeSpec("t", S, B, "train"), mode="init")
    for k, v in batch.items():
        OUT[f"{{name}}/batch/{{k}}"] = np.asarray(v)
    export(name + "/param/", state.params)
    loss_fn = make_loss_fn(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, batch, dist), has_aux=True))(state.params)
    export(name + "/grad/", grads)
    OUT[name + "/ep_loss"] = np.asarray(loss, np.float32)
    OUT[name + "/ep_xent"] = np.asarray(metrics["loss"], np.float32)
    if name == {GATHER!r}:
        export(name + "/grad_ep/", grads)
        dist = None
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, batch, None), has_aux=True))(state.params)
        export(name + "/grad/", grads)
    step = jax.jit(make_train_step(cfg, ocfg, dist))
    rows = []
    for _ in range({STEPS}):
        state, m = step(state, batch)
        rows.append([float(m[k]) for k in ("loss", "lb_loss", "dropped")])
    OUT[name + "/steps"] = np.asarray(rows, np.float64)
    export(name + "/final/", state.params)
"""
    return run_reference(body, timeout=900)


def _cfg(name):
    arch, over = CASES[name][:2]
    return get_smoke_config(arch).with_(**over)


def _params(ref, name, cfg):
    pre = f"{name}/param/"
    return params_from_reference(cfg, {k[len(pre):]: v.copy() for k, v in ref.items()
                                       if k.startswith(pre)}, device="cpu")


def _batch(ref, name, cfg):
    """The reference's batch, also the port's own `input_specs` draw."""
    pre = f"{name}/batch/"
    want = {k[len(pre):]: torch.from_numpy(v) for k, v in ref.items() if k.startswith(pre)}
    B, S = CASES[name][3]
    got = input_specs(cfg, "train", B, S, device="cpu")
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k].float(), want[k].float()), k
    return got


def _ref_leaf(ref, kind, name, path, n_prefix):
    """The reference's array for a port leaf: the dense prefix layers under
    prefix/<i>, the stacked layers indexed by their position after them."""
    if path[0] == "blocks" and path[1] < n_prefix:
        key, idx = "/".join(["prefix", str(path[1])] + list(path[2:])), []
    else:
        key = "/".join(k for k in path if not isinstance(k, int))
        idx = [k - n_prefix if path[0] == "blocks" else k for k in path if isinstance(k, int)]
    out = ref[f"{name}/{kind}/{key}"]
    for i in idx:
        out = out[i]
    return out


def _dist(name, cfg):
    dp, ep = CASES[name][2]
    return make_dist(cfg, {"data": dp, "model": ep})


@pytest.mark.parametrize("name", F32_CASES)
def test_ep_grads_match_reference(reference, name):
    """The first step's gradients leaf by leaf within GRAD_TOL of the leaf's
    largest; every leaf the reference gives a gradient gets one here, the
    experts' and the router's included; the loss within LOSS_RTOL, lb_loss
    within AUX_TOL and dropped equal."""
    cfg = _cfg(name)
    params = _params(reference, name, cfg)
    batch = _batch(reference, name, cfg)
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with train_attention():
        loss, metrics = make_loss_fn(cfg)(params, batch, _dist(name, cfg))
    metrics = {k: v.detach() for k, v in metrics.items()}
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    rows = reference[name + "/steps"]
    np.testing.assert_allclose(float(loss.detach()), float(reference[name + "/ep_loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["loss"]), rows[0, 0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["lb_loss"]), rows[0, 1], atol=AUX_TOL)
    assert int(metrics["dropped"]) == int(rows[0, 2])
    n_prefix = cfg.first_k_dense
    for (path, _), g in zip(tree.leaves_with_path(params), grads):
        want = _ref_leaf(reference, "grad", name, path, n_prefix)
        got = g.float().numpy()
        size = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(got - want).max() <= GRAD_TOL * size, (path, np.abs(got - want).max(), size)
        assert (np.abs(got).max() > 0) == (np.abs(want).max() > 0), path
    experts = [g for (path, _), g in zip(tree.leaves_with_path(params), grads)
               if path[-1] in ("w_gate", "router") and "ffn" in path]
    assert experts and all(float(g.abs().max()) > 0 for g in experts)


@pytest.mark.parametrize("name", list(CASES))
def test_ep_train_steps_match_reference(reference, name):
    """3 steps: losses within LOSS_RTOL, lb_loss within AUX_TOL and dropped
    equal at every step; f32 final params within PARAM_ATOL; the loss falls.
    bf16: losses and lb_loss within BF16_LOSS_RTOL relative (a routing
    choice at a near-tie may flip between the two roundings, which moves
    lb_loss's counts: 0.8 % seen)."""
    cfg = _cfg(name)
    ocfg = OptimConfig(**OPTIM)
    state = init_state(cfg, ocfg, params=_params(reference, name, cfg))
    batch = _batch(reference, name, cfg)
    step = make_train_step(cfg, ocfg, _dist(name, cfg))
    got = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        got.append([float(m["loss"]), float(m["lb_loss"]), int(m["dropped"])])
    got, want = np.asarray(got), reference[name + "/steps"]
    bf16 = cfg.dtype == "bfloat16"
    rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=rtol)
    if bf16:
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=BF16_LOSS_RTOL)
    else:
        np.testing.assert_allclose(got[:, 1], want[:, 1], atol=AUX_TOL)
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    assert got[-1, 0] < got[0, 0]
    if not bf16:
        for path, leaf in tree.leaves_with_path(state.params):
            want_leaf = _ref_leaf(reference, "final", name, path, cfg.first_k_dense)
            np.testing.assert_allclose(leaf.detach().float().numpy(), want_leaf,
                                       atol=PARAM_ATOL, rtol=0, err_msg=str(path))


def test_reference_gather_grads_are_not_its_forwards(reference):
    """The reference's gather route under grad (module docstring): its
    gradients differ from its dense dispatch's, whose forward it equals."""
    cfg = _cfg(GATHER)
    np.testing.assert_allclose(float(reference[GATHER + "/ep_xent"]),
                               reference[GATHER + "/steps"][0, 0], rtol=LOSS_RTOL)
    assert reference[GATHER + "/steps"][0, 2] == 0
    path = ("blocks", 0, "ln1", "scale")
    ep = _ref_leaf(reference, "grad_ep", GATHER, path, cfg.first_k_dense)
    dense = _ref_leaf(reference, "grad", GATHER, path, cfg.first_k_dense)
    assert np.abs(ep - dense).max() > 0.5 * np.abs(dense).max()


def test_drop_case_drops(reference):
    """Capacity factor 0.25 at B 2 x S 64 over 4 shards: int(0.25 x 2 x 16 x
    2 / 4) + 8 = 12 slots a (sender, receiver) for 16 records on average:
    the exchange drops at every step, in both."""
    assert (reference["ds_drop_1x4/steps"][:, 2] > 0).all()


@pytest.mark.parametrize("arch", [DS, QW])
def test_dense_dispatch_dist_is_bit_equal_to_no_dist(arch):
    """dist=None and make_dist(..., moe_dispatch="dense") at (1, 4): the same
    losses, metrics and params bit for bit over 3 steps."""
    cfg = get_smoke_config(arch)
    ocfg = OptimConfig(**OPTIM)
    batch = input_specs(cfg, "train", 4, 16, device="cpu")
    runs = []
    for dist in (None, make_dist(cfg, {"data": 1, "model": 4}, moe_dispatch="dense")):
        state = init_state(cfg, ocfg, device="cpu")
        step = make_train_step(cfg, ocfg, dist)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append({k: v.clone() for k, v in m.items()})
        runs.append((metrics, state.params))
    (m0, p0), (m1, p1) = runs
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(p0), tree.leaves(p1)))
