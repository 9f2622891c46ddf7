"""The port's train path (`repro_torch.train`, device="cpu") against the
reference's (`repro.train`), run in this process with jax on the CPU: the
twin of every test of tests/test_train.py, each held against the reference.

AdamW, the schedule, clipping, the int8 codec, top-k masks and error
feedback take the same numpy inputs on both sides.  The loss curves start
from the reference's `init_state` params carried across with
`params_from_reference`, on the same batch (`input_specs` draws the
reference's numbers), and run the reference's jitted step beside the port's.

Tolerances: one AdamW step agrees within ADAM_TOL = 1e-6 (f32 arithmetic in
the same order; XLA and PyTorch may round pow and sqrt apart by an ulp).
f32 loss curves agree within LOSS_RTOL = 1e-5 relative over 6 steps (the
forward sums in another order, 1e-5 absolute on logits in
test_torch_lm.py; 3.5e-7 seen) and final params within PARAM_ATOL = 1e-4
(4.1e-5 seen: Adam's first steps are about sign(g), and a grad near 0 that
flipped would move its param by up to 2 lr = 6e-3, so none did); both are
tighter than the reference's own rtol=2e-3 for accumulation.  The bf16
smoke rounds every activation to 8 bits, and XLA and PyTorch round at
different places (test_torch_lm.py's bf16 logits differ by up to 0.051):
its losses agree within BF16_LOSS_RTOL = 1e-2 (3.4e-3 seen).  The int8
codec rounds g / scale, so a grad that differs in its last bits can land on
the other side of a rounding boundary and move by one quantum (max|g| / 127),
which Adam's normalisation then magnifies: the compressed curve agrees within
the reference's own rtol 2e-3, COMPRESSED_LOSS_RTOL (2.3e-4 seen).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES
from repro.configs.base import get_smoke_config as ref_smoke_config
from repro.models.nn import paths_from_tree
from repro.models.registry import init_all as ref_init_all
from repro.models.registry import input_specs as ref_input_specs
from repro.train import OptimConfig as RefOptimConfig
from repro.train import compression as ref_comp
from repro.train import init_state as ref_init_state
from repro.train import make_train_step as ref_make_train_step
from repro.train import optim as ref_optim
from repro.train.step import softmax_xent as ref_softmax_xent
from repro_torch.configs import get_smoke_config
from repro_torch.models import input_specs
from repro_torch.models.convert import params_from_reference
from repro_torch.train import OptimConfig, init_state, make_train_step, optim, tree
from repro_torch.train.compression import (
    CompressionConfig, compress_state_init, compressed_grads, dequantize_int8, quantize_int8,
    topk_mask)
from repro_torch.train.step import softmax_xent
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=4)
ADAM_TOL = 1e-6
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
BF16_LOSS_RTOL = 1e-2
COMPRESSED_LOSS_RTOL = 2e-3
FAMILY_SMOKES = ("internlm2-1.8b", "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b", "mamba2-780m",
                 "zamba2-2.7b", "seamless-m4t-large-v2", "llava-next-mistral-7b")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.detach().float().numpy()


def test_configs_match_reference():
    assert dataclasses.asdict(OptimConfig()) == dataclasses.asdict(RefOptimConfig())
    assert dataclasses.asdict(CompressionConfig()) == \
        dataclasses.asdict(ref_comp.CompressionConfig())


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _adam_inputs(seed, param_dtype):
    rng = np.random.default_rng(seed)
    shapes = {"ln": {"scale": (4,)}, "attn": {"wq": (3, 5), "bq": (5,)}, "w": (2, 2)}
    params = {"ln": {"scale": rng.standard_normal(4)},
              "attn": {"wq": rng.standard_normal((3, 5)), "bq": rng.standard_normal(5)},
              "w": rng.standard_normal((2, 2))}
    grads = [jax.tree.map(lambda s: rng.standard_normal(s) * 3.0, shapes,
                          is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    cast = {"float32": np.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    params = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32).astype(cast)), params)
    return params, grads


def _to_torch(tree_np, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(
        dtype or torch.float32), tree_np)


@pytest.mark.parametrize("master_fp32,moments,param_dtype", [
    (True, "float32", "float32"), (False, "float32", "float32"),
    (True, "bfloat16", "float32"), (True, "float32", "bfloat16"),
    (False, "bfloat16", "bfloat16")])
def test_adamw_matches_reference_impl(master_fp32, moments, param_dtype):
    """Three AdamW steps (warmup + cosine, clipping active, decay on all but
    norm/scale/bias paths) on the same params and grads: params, moments,
    master copy, lr and grad norm within ADAM_TOL."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, clip_norm=1.0,
              master_fp32=master_fp32, moments_dtype=moments)
    params_np, grads_np = _adam_inputs(7, param_dtype)
    tdt = getattr(torch, param_dtype)
    r_params = jax.tree.map(jnp.asarray, params_np)
    r_state = ref_optim.init(RefOptimConfig(**kw), r_params)
    p_params = _to_torch(params_np, tdt)
    p_state = optim.init(OptimConfig(**kw), p_params)
    assert tree.leaves(p_state.mu)[0].dtype == getattr(torch, moments)
    for g in grads_np:
        r_params, r_state, r_m = ref_optim.apply_updates(
            RefOptimConfig(**kw), r_params, jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float32).astype(jnp.dtype(param_dtype)), g), r_state)
        p_params, p_state, p_m = optim.apply_updates(
            OptimConfig(**kw), p_params, _to_torch(g, tdt), p_state)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(p_m[k]), float(r_m[k]), rtol=ADAM_TOL)
    assert int(p_state.count) == int(r_state.count) == 3
    for name, got, want in (("params", p_params, r_params), ("mu", p_state.mu, r_state.mu),
                            ("nu", p_state.nu, r_state.nu),
                            ("master", p_state.master, r_state.master)):
        for path, a in tree.leaves_with_path(got):
            b = want
            for key in path:
                b = b[key]
            np.testing.assert_allclose(_t(a), _np(b), rtol=ADAM_TOL, atol=ADAM_TOL,
                                       err_msg=f"{name} {path}")


def test_adamw_matches_numpy():
    """The reference test's hand-rolled numpy step, on the port."""
    ocfg = OptimConfig(lr=1e-2, warmup_steps=0, weight_decay=0.1,
                       clip_norm=0.0, master_fp32=True, schedule="constant")
    p0 = np.asarray([[1.0, -2.0], [0.5, 3.0]], np.float32)
    g = np.asarray([[0.1, 0.2], [-0.3, 0.4]], np.float32)
    params = {"w": torch.from_numpy(p0.copy())}
    state = optim.init(ocfg, params)
    new_params, state, _ = optim.apply_updates(ocfg, params, {"w": torch.from_numpy(g)}, state)
    m, v = 0.1 * g, 0.05 * g * g
    upd = (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.95)) + ocfg.eps) + 0.1 * p0
    np.testing.assert_allclose(_t(new_params["w"]), p0 - 1e-2 * upd, rtol=1e-5)


def test_no_decay_on_norm_scale_params():
    ocfg = OptimConfig(lr=1e-2, warmup_steps=0, weight_decay=1.0,
                       clip_norm=0.0, schedule="constant")
    params = {"ln": {"scale": torch.ones(4)}, "w": torch.ones(4)}
    state = optim.init(ocfg, params)
    zero_g = tree.tree_map(torch.zeros_like, params)
    new_params, _, _ = optim.apply_updates(ocfg, params, zero_g, state)
    np.testing.assert_allclose(_t(new_params["ln"]["scale"]), 1.0)
    assert (new_params["w"] < 1.0).all()


def _ref_path(port_path, n_prefix):
    """The reference's path of a port leaf: the port's per-layer list index
    dropped (stacked layers), or kept under "prefix" for deepseek's dense
    prefix layers."""
    if port_path[0] == "blocks" and port_path[1] < n_prefix:
        return ("prefix",) + port_path[1:]
    return tuple(k for k in port_path if not isinstance(k, int))


@pytest.mark.parametrize("arch", FAMILY_SMOKES)
def test_decay_mask_matches_reference(arch):
    """Every leaf of every family's converted smoke params gets its
    reference counterpart's decay decision."""
    rcfg = ref_smoke_config(arch)
    r_params, _ = ref_init_all(rcfg, mode="shape")
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(r_params)[0]:
        keys = tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)
        want[tuple(str(k) for k in keys)] = ref_optim._decay_mask(path)
    r_params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), r_params)
    flat = paths_from_tree({k: v for k, v in r_params.items() if k != "prefix"})
    for i, layer in enumerate(r_params.get("prefix", [])):
        flat.update(paths_from_tree(layer, f"prefix/{i}"))
    cfg = get_smoke_config(arch)
    p_params = params_from_reference(cfg, flat, device="cpu")
    n_prefix = cfg.first_k_dense if cfg.num_experts else 0
    got = {}
    for path, _ in tree.leaves_with_path(p_params):
        key = tuple(str(k) for k in _ref_path(path, n_prefix))
        decision = optim._decay_mask(path)
        assert got.setdefault(key, decision) == decision, path
    assert got == want
    assert any(got.values()) and not all(got.values())


@pytest.mark.parametrize("kind", ["warmup_cosine", "constant"])
def test_schedule_warmup_cosine(kind):
    ocfg = OptimConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1,
                       schedule=kind)
    rcfg = RefOptimConfig(**dataclasses.asdict(ocfg))
    got = [float(optim.schedule(ocfg, torch.tensor(s))) for s in range(ocfg.total_steps + 6)]
    want = [float(ref_optim.schedule(rcfg, jnp.asarray(s))) for s in range(ocfg.total_steps + 6)]
    np.testing.assert_allclose(got, want, rtol=ADAM_TOL, atol=0)
    assert got[0] == 0.0 and abs(got[10] - 1.0) < 1e-6
    if kind == "warmup_cosine":
        assert abs(got[110] - 0.1) < 1e-6 and 0.1 < got[60] < 1.0


def test_global_norm_clipping():
    ocfg = OptimConfig(lr=1.0, warmup_steps=0, clip_norm=1.0, weight_decay=0.0,
                       schedule="constant")
    params = {"w": torch.zeros(3)}
    state = optim.init(ocfg, params)
    big = {"w": torch.tensor([300.0, 400.0, 0.0])}   # norm 500
    _, state2, metrics = optim.apply_updates(ocfg, params, big, state)
    rcfg = RefOptimConfig(**dataclasses.asdict(ocfg))
    r_params = {"w": jnp.zeros((3,))}
    _, r_state2, r_metrics = ref_optim.apply_updates(
        rcfg, r_params, {"w": jnp.asarray([300.0, 400.0, 0.0])}, ref_optim.init(rcfg, r_params))
    assert abs(float(metrics["grad_norm"]) - 500.0) < 1e-3
    np.testing.assert_allclose(_t(state2.mu["w"]), [0.06, 0.08, 0.0], atol=1e-6)
    np.testing.assert_allclose(_t(state2.mu["w"]), _np(r_state2.mu["w"]), atol=ADAM_TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(r_metrics["grad_norm"]),
                               rtol=ADAM_TOL)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 0.0)])
def test_int8_quantization_roundtrip_error(seed, scale):
    """Codes and scale equal to the reference's; the round trip within half
    a quantum."""
    g_np = (np.random.default_rng(seed).standard_normal(1000) * scale).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(g_np))
    rq, rs = ref_comp.quantize_int8(jnp.asarray(g_np))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    deq = dequantize_int8(q, s)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(ref_comp.dequantize_int8(rq, rs)))
    assert float((deq - torch.from_numpy(g_np)).abs().max()) <= float(s) * 0.5 + 1e-7


@pytest.mark.parametrize("frac", [0.4, 0.01, 0.3, 1.0])
def test_topk_mask_keeps_largest(frac):
    g = torch.tensor([0.1, -5.0, 0.3, 2.0, -0.2])
    if frac == 0.4:
        assert topk_mask(g, frac).tolist() == [False, True, False, True, False]
    x = np.random.default_rng(3).standard_normal((17, 13)).astype(np.float32)
    for arr in (x, g.numpy()):
        np.testing.assert_array_equal(topk_mask(torch.from_numpy(arr), frac).numpy(),
                                      np.asarray(ref_comp.topk_mask(jnp.asarray(arr), frac)))


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_error_feedback_preserves_signal(kind):
    """With EF, the sum of decoded grads tracks the sum of true grads; each
    step's decoded grads and residuals equal the reference's."""
    cfg = CompressionConfig(kind=kind, ef=True, topk_frac=0.25)
    rcfg = ref_comp.CompressionConfig(kind=kind, ef=True, topk_frac=0.25)
    rng = np.random.default_rng(1)
    ef = compress_state_init(cfg, {"w": torch.zeros(64)})
    r_ef = ref_comp.compress_state_init(rcfg, {"w": jnp.zeros((64,))})
    total_true, total_dec = np.zeros(64), np.zeros(64)
    for _ in range(50):
        g = (rng.standard_normal(64) * 0.01).astype(np.float32)
        dec, ef = compressed_grads(cfg, {"w": torch.from_numpy(g)}, ef)
        r_dec, r_ef = ref_comp.compressed_grads(rcfg, {"w": jnp.asarray(g)}, r_ef)
        np.testing.assert_allclose(_t(dec["w"]), _np(r_dec["w"]), atol=1e-9)
        np.testing.assert_allclose(_t(ef["w"]), _np(r_ef["w"]), atol=1e-9)
        total_true += g
        total_dec += _t(dec["w"])
    if kind == "int8":
        assert np.abs(total_true - total_dec).max() < 0.01 * 0.5 / 127 * 2 + 1e-4


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def test_labels_ignore_index_masks():
    loss, ntok = softmax_xent(torch.zeros((1, 4, 8)), torch.tensor([[1, 2, -100, -100]]))
    assert int(ntok) == 2
    np.testing.assert_allclose(float(loss), np.log(8), rtol=1e-5)
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[rng.random((3, 5)) < 0.3] = -100
    got, n = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    want, rn = ref_softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    assert int(n) == int(rn)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# train step integration (the reference's curve beside the port's)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _curves(arch="internlm2-1.8b", accum=1, compression=None, steps=6, dtype="float32"):
    """(reference losses, port losses, reference final params as
    {path: array}, port final params) from the reference's init_state
    (cached: several tests share the dense curve)."""
    rcfg = ref_smoke_config(arch)
    rcfg = dataclasses.replace(rcfg, dtype=dtype)
    rocfg = RefOptimConfig(lr=3e-3, warmup_steps=2, total_steps=100)
    r_comp = ref_comp.CompressionConfig(**dataclasses.asdict(compression)) if compression else None
    state, _ = ref_init_state(rcfg, rocfg, compression=r_comp)
    flat = {k: np.array(_np(v)) for k, v in paths_from_tree(
        {k: v for k, v in state.params.items() if k != "prefix"}).items()}
    batch = ref_input_specs(rcfg, SMALL, mode="init")
    fn = jax.jit(ref_make_train_step(rcfg, rocfg, None, accum_steps=accum, compression=r_comp))
    want = []
    for _ in range(steps):
        state, m = fn(state, batch)
        want.append(float(m["loss"]))
    r_final = {k: _np(v) for k, v in paths_from_tree(
        {k: v for k, v in state.params.items() if k != "prefix"}).items()}

    cfg = get_smoke_config(arch).with_(dtype=dtype)
    ocfg = OptimConfig(lr=3e-3, warmup_steps=2, total_steps=100)
    p_state = init_state(cfg, ocfg, compression=compression,
                         params=params_from_reference(cfg, flat, device="cpu"))
    p_batch = input_specs(cfg, "train", SMALL.global_batch, SMALL.seq_len, device="cpu")
    for k, v in batch.items():
        np.testing.assert_array_equal(p_batch[k].float().numpy(), _np(v))
    step = make_train_step(cfg, ocfg, accum_steps=accum, compression=compression)
    got = []
    for _ in range(steps):
        p_state, m = step(p_state, p_batch)
        got.append(float(m["loss"]))
    return want, got, r_final, p_state.params


def _params_close(r_final, p_params, atol):
    for path, leaf in tree.leaves_with_path(p_params):
        want = r_final["/".join(k for k in path if not isinstance(k, int))]
        for i in (k for k in path if isinstance(k, int)):
            want = want[i]
        np.testing.assert_allclose(_t(leaf), want, atol=atol, rtol=0, err_msg=str(path))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-235b-a22b", "mamba2-780m"])
def test_loss_decreases_and_matches_reference(arch):
    """The dense, moe and ssm smokes: 6 steps, losses within LOSS_RTOL of the
    reference's and falling, final params within PARAM_ATOL."""
    want, got, r_final, p_params = _curves(arch)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0] and np.isfinite(got).all()
    _params_close(r_final, p_params, PARAM_ATOL)


def test_grad_accum_equivalence():
    """accum=2 matches accum=1 on the same batch (mean of means) within the
    reference's rtol=2e-3, and the reference's accum=2 curve within LOSS_RTOL."""
    want2, got2, _, _ = _curves(accum=2, steps=3)
    _, got1, _, _ = _curves()
    np.testing.assert_allclose(got2, got1[:3], rtol=2e-3)
    np.testing.assert_allclose(got2, want2, rtol=LOSS_RTOL)


def test_compressed_training_converges():
    """int8 + EF: the reference's curve within COMPRESSED_LOSS_RTOL, falling,
    and near the uncompressed one."""
    want, comp, _, _ = _curves(compression=CompressionConfig(kind="int8", ef=True))
    _, base, _, _ = _curves()
    np.testing.assert_allclose(comp, want, rtol=COMPRESSED_LOSS_RTOL)
    assert comp[-1] < comp[0]
    assert abs(comp[-1] - base[-1]) < 0.25 * abs(base[0] - base[-1]) + 0.05


def test_bf16_smoke_matches_reference():
    want, got, _, p_params = _curves(dtype="bfloat16")
    assert tree.leaves(p_params)[0].dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)
    assert got[-1] < got[0]


def test_bf16_moments_still_converge():
    """bf16 Adam moments must not break descent; each step's params equal
    the reference's within ADAM_TOL."""
    ocfg = OptimConfig(lr=5e-2, warmup_steps=0, weight_decay=0.0,
                       clip_norm=0.0, schedule="constant", moments_dtype="bfloat16")
    rcfg = RefOptimConfig(**dataclasses.asdict(ocfg))
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    r_params = {"w": jnp.asarray([3.0, -2.0, 1.0])}
    state, r_state = optim.init(ocfg, params), ref_optim.init(rcfg, r_params)
    assert state.mu["w"].dtype == torch.bfloat16
    for _ in range(60):
        params, state, _ = optim.apply_updates(ocfg, params, {"w": params["w"].clone()}, state)
        r_params, r_state, _ = ref_optim.apply_updates(rcfg, r_params, {"w": r_params["w"]},
                                                       r_state)
        np.testing.assert_allclose(_t(params["w"]), _np(r_params["w"]), atol=ADAM_TOL)
    assert float(params["w"].abs().max()) < 0.5
