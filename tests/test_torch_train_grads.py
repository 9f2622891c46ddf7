"""Gradients of every family's smoke through the port's train route, against
the reference's `jax.value_and_grad` of its own loss (`make_loss_fn`), in
this process with jax on the CPU.

The port's loss runs the model's forward inside
`models.layers.train_attention()` and autograd: attention by the reference's
chunked route, the MoE dispatch, the SSD chunk loop, the vocabulary-padding
mask and the embedding gather all differentiate.  Each leaf's gradient
agrees with its reference counterpart's (prefix layers and stacked layers
carried by `models/convert.py`'s mapping) within GRAD_TOL of that leaf's
largest gradient (f32: the sums run in another order; 1e-5 on logits in
test_torch_lm.py), every leaf that gets a gradient in the reference gets
one here (so attention's wq, wk, wv are not cut off), and the loss and the
MoE aux agree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec
from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.models.nn import paths_from_tree
from repro.models.registry import init_all as ref_init_all
from repro.models.registry import input_specs as ref_input_specs
from repro.train.step import make_loss_fn as ref_make_loss_fn
from repro_torch.configs import get_smoke_config
from repro_torch.models import input_specs
from repro_torch.models.convert import params_from_reference
from repro_torch.models.layers import train_attention
from repro_torch.train import tree
from repro_torch.train.step import make_loss_fn
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAD_TOL = 1e-5
B, S = 2, 12
ARCHS = ("internlm2-1.8b", "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b", "mamba2-780m",
         "zamba2-2.7b", "seamless-m4t-large-v2", "llava-next-mistral-7b")


def _flat(params):
    flat = paths_from_tree({k: v for k, v in params.items() if k != "prefix"})
    for i, layer in enumerate(params.get("prefix", [])):
        flat.update(paths_from_tree(layer, f"prefix/{i}"))
    return {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in flat.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    rcfg = ref_smoke_config(arch)
    seq = S + rcfg.num_image_tokens
    r_params, _ = ref_init_all(rcfg, seed=0)
    r_batch = ref_input_specs(rcfg, ShapeSpec("t", seq, B, "train"), mode="init", seed=3)
    r_loss_fn = ref_make_loss_fn(rcfg)
    (r_loss, r_metrics), r_grads = jax.jit(jax.value_and_grad(
        lambda p: r_loss_fn(p, r_batch, None), has_aux=True))(r_params)
    want = _flat(r_grads)

    cfg = get_smoke_config(arch)
    params = params_from_reference(cfg, {k: v.copy() for k, v in _flat(r_params).items()},
                                   device="cpu")
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = input_specs(cfg, "train", B, seq, seed=3, device="cpu")
    with train_attention():
        loss, metrics = make_loss_fn(cfg)(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)

    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=GRAD_TOL)
    for k in ("lb_loss", "dropped"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(r_metrics[k]), atol=GRAD_TOL)
    n_prefix = cfg.first_k_dense if cfg.num_experts else 0
    seen = set()
    for (path, _), g in zip(tree.leaves_with_path(params), grads):
        if path[0] == "blocks" and path[1] < n_prefix:
            key, idx = "/".join(["prefix", str(path[1])] + list(path[2:])), []
        else:
            key = "/".join(k for k in path if not isinstance(k, int))
            idx = [k - n_prefix if path[0] == "blocks" else k
                   for k in path if isinstance(k, int)]
            if path[0] == "mamba":   # hybrid: stacked [n_groups, every]
                idx = list(divmod(idx[0], cfg.shared_attn_every))
        ref = want[key]
        for i in idx:
            ref = ref[i]
        seen.add(key)
        got = g.float().numpy()
        size = max(float(np.abs(ref).max()), 1e-30)
        assert np.abs(got - ref).max() <= GRAD_TOL * size, (path, np.abs(got - ref).max(), size)
        assert (np.abs(got).max() > 0) == (np.abs(ref).max() > 0), path
    assert seen == set(want)
    attn = [g for (path, _), g in zip(tree.leaves_with_path(params), grads)
            if any(k in ("wq", "wk", "wv") for k in path)]
    assert cfg.family == "ssm" or (attn and all(float(g.abs().max()) > 0 for g in attn))
