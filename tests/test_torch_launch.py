"""The port's one-card launch tooling (`repro_torch.launch.{mesh, roofline,
attribution, cells, dryrun, perf}`, `configs.base.SHAPES`) against the
reference's, in this process with jax on the CPU.

Plain data equals the reference's: the shapes, `long_context_supported`,
`cell_supported`'s decisions and reasons, `model_flops_for_cell` for every
arch x shape, the roofline arithmetic (the reference's test with H100
constants), and the overrides of every `perf.VARIANTS` entry.  The dry run
on the meta device counts the reference's parameter and cache elements
(`init_all(cfg, mode="shape")`, `init_cache(..., mode="shape")`) for every
arch.  `attribution` ranks a synthetic profile; `run_variant` and the dry
run's command line run on the CPU.

The reference's `launch/perf.py` and `launch/dryrun.py` set XLA_FLAGS to 512
fake devices when imported, so their VARIANTS are read from the source.
"""

import ast
import dataclasses
import json
import os
from types import SimpleNamespace

import pytest
import torch

from repro.configs import base as ref_base
from repro.launch import cells as ref_cells
from repro.launch import roofline as ref_roofline
from repro.models.registry import get_model as ref_get_model
from repro.models.registry import init_all as ref_init_all
from repro_torch.configs import SHAPES, ShapeSpec, get_config, get_smoke_config
from repro_torch.configs import base
from repro_torch.launch import attribution, cells, dryrun, mesh, perf, roofline
from repro_torch.train import tree
from torch_parity import ROOT, one_torch_thread  # noqa: F401

ARCHS = base.arch_ids()
CELLS = [(a, s) for a in ARCHS for s in SHAPES]


def _ref_variants():
    path = os.path.join(ROOT, "src", "repro", "launch", "perf.py")
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", "") == "VARIANTS":
            return ast.literal_eval(node.value)
    raise AssertionError("no VARIANTS in the reference's perf.py")


def test_shapes_equal_reference():
    assert [dataclasses.astuple(s) for s in SHAPES.values()] == \
        [dataclasses.astuple(s) for s in ref_base.SHAPES.values()]
    assert list(SHAPES) == list(ref_base.SHAPES)
    assert [f.name for f in dataclasses.fields(ShapeSpec)] == \
        [f.name for f in dataclasses.fields(ref_base.ShapeSpec)]
    assert sorted(ARCHS) == sorted(ref_base.arch_ids())
    for arch in ARCHS:
        assert base.long_context_supported(get_config(arch)) == \
            ref_base.long_context_supported(ref_base.get_config(arch))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cells_and_model_flops_equal_reference(arch, shape):
    got = cells.cell_supported(get_config(arch), SHAPES[shape])
    want = ref_cells.cell_supported(ref_base.get_config(arch), ref_base.SHAPES[shape])
    assert got == want
    assert roofline.model_flops_for_cell(get_config(arch), SHAPES[shape]) == \
        ref_roofline.model_flops_for_cell(ref_base.get_config(arch), ref_base.SHAPES[shape])


def test_roofline_terms_and_bottleneck():
    """tests/test_roofline.py's case on one H100: no collective term."""
    r = roofline.Roofline(flops_per_chip=989e12, bytes_per_chip=3.35e12 / 2,
                          coll_bytes_per_chip=0.0, coll_by_kind={}, chips=1,
                          model_flops=989e12 * 0.5)
    assert r.peak_flops == mesh.BF16_OPS_PER_S == 989e12
    assert r.hbm_bw == mesh.MEM_BYTES_PER_S == 3.35e12
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == 0.0
    assert r.bottleneck == "compute"
    assert r.mfu_bound == pytest.approx(0.5)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    m = roofline.Roofline(flops_per_chip=1e12, bytes_per_chip=3.35e12, coll_bytes_per_chip=0.0,
                          coll_by_kind={}, chips=1, model_flops=1e12)
    assert m.bottleneck == "memory" and m.step_time == pytest.approx(1.0)
    want = ref_roofline.Roofline(flops_per_chip=989e12, bytes_per_chip=3.35e12 / 2,
                                 coll_bytes_per_chip=0.0, coll_by_kind={}, chips=1,
                                 model_flops=989e12 * 0.5, peak_flops=989e12, hbm_bw=3.35e12)
    got = r.as_dict()
    for k, v in want.as_dict().items():
        if k != "t_collective_s":
            assert got[k] == pytest.approx(v), k


def test_kernel_bounds():
    """The bounds of chip_smoke.py's kernel lines: bytes over 3.35 TB/s
    against operations over their peak (flash: 2 (D + Dv) Hq per visible
    pair at 989 TFLOP/s)."""
    assert roofline.kernel_bound(3.35e9, 1.0, 1e12) == (pytest.approx(1.0), "bytes")
    ops_s = roofline.int_ops_per_s(132, 1980.0)
    assert ops_s == 132 * 128 * 1980e6
    assert roofline.kernel_bound(8, ops_s * 1e-3, ops_s) == (pytest.approx(1.0), "operations")
    B, H, S, D = 1, 2, 4, 8
    q = torch.zeros(B, H, S, D, dtype=torch.bfloat16)
    ms, by = roofline.flash_bound(q, q, q, torch.zeros(B, dtype=torch.int32), causal=True)
    pairs = S * (S + 1) // 2
    want = max(2 * (B * H * S * 2 * D + H * 2 * D * S) / 3.35e12,
               2 * 2 * D * H * pairs / 989e12) * 1e3
    assert ms == pytest.approx(want)
    assert roofline.flash_bound(q, q, q, None, causal=False)[0] == pytest.approx(
        max(2 * (B * H * S * 2 * D + H * 2 * D * S) / 3.35e12, 2 * 2 * D * H * S * S / 989e12)
        * 1e3)


def test_mesh_shapes():
    assert mesh.make_production_mesh() == {"data": 16, "model": 16}
    assert mesh.make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16, "model": 16}
    assert mesh.make_graph_mesh(8).nb == 8 and mesh.make_graph_mesh().nb == 1
    graph = mesh.make_graph_mesh(8, ["cpu"] * 4)
    assert (graph.count, graph.per_card) == (4, 2)


def test_variants_equal_reference():
    """Every variant carried over has the reference's exact overrides; the
    others are recorded with a reason; none is added."""
    ref = _ref_variants()
    assert set(perf.VARIANTS) | set(perf.NO_COUNTERPART) == set(ref)
    assert not set(perf.VARIANTS) & set(perf.NO_COUNTERPART)
    for name, v in perf.VARIANTS.items():
        assert v == ref[name], name
    for name in perf.NO_COUNTERPART:
        with pytest.raises(ValueError, match="no counterpart"):
            perf.resolve("internlm2-1.8b", f"baseline+{name}")
    cfg, ocfg, kw = perf.resolve("deepseek-v2-lite-16b", "dispatch_int8+opt_bf16+accum4",
                                 {"num_layers": 4})
    assert cfg.moe_dispatch_int8 and cfg.num_layers == 4
    assert ocfg.moments_dtype == "bfloat16" and kw == {"accum_steps": 4}


def _ref_elements(t, skip_length=True):
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(t)[0]
    return sum(int(x.size) for path, x in leaves
               if not (skip_length and getattr(path[-1], "key", None) == "length"))


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_counts_the_reference_elements(arch):
    """The meta cells hold the reference's parameter elements and (length
    counters aside: the port keeps one 0-d length, the reference one per
    layer) its cache elements, at decode_32k's B and S."""
    shape = SHAPES["decode_32k"]
    rec = dryrun.run_cell(arch, "decode_32k")
    rcfg = ref_base.get_config(arch)
    params, _ = ref_init_all(rcfg, mode="shape")
    assert rec["param_elements"] == _ref_elements(params, skip_length=False)
    cache = ref_get_model(rcfg).init_cache(rcfg, shape.global_batch, shape.seq_len, mode="shape")
    assert rec["cache_elements"] == _ref_elements(cache)
    cell = cells.build_cell(arch, shape, {"data": 1, "model": 1}, device="meta")
    assert all(t.device.type == "meta" for t in tree.leaves(cell.args))


def test_dry_run_cli(tmp_path, capsys):
    """Every arch x shape: ok or the reference's skip, one line each and the
    summary, the JSONL records; the train state counts 14 bytes a bf16
    parameter (grad 2, master 4, moments 4 + 4)."""
    out = tmp_path / "cells.jsonl"
    records = dryrun.main(["--arch", "all", "--shape", "all", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert len(records) == len(CELLS) and len(lines) == len(CELLS) + 1
    assert "dry-run" in lines[-1]
    assert [json.loads(x) for x in out.read_text().splitlines()] == records
    for rec, (arch, shape) in zip(records, CELLS):
        ok, why = ref_cells.cell_supported(ref_base.get_config(arch), ref_base.SHAPES[shape])
        assert rec["status"] == ("ok" if ok else "skipped")
        if not ok:
            assert rec["reason"] == why
            continue
        assert rec["fits_80gb"] == (rec["bytes"] <= mesh.MEM_BYTES)
        assert rec["max_batch_pow2"] <= SHAPES[shape].global_batch
        if rec["kind"] == "train":
            assert rec["state_bytes"] == 7 * rec["param_bytes"]
    by = {(r["arch"], r["shape"]): r for r in records}
    assert by[("internlm2-1.8b", "train_4k")]["fits_80gb"]
    assert by[("qwen3-moe-235b-a22b", "decode_32k")]["max_batch_pow2"] == 0


@pytest.mark.parametrize("master,moments", [(True, "float32"), (False, "bfloat16")])
def test_init_abstract_matches_reference(master, moments):
    """The optimizer state on the meta device: the reference's
    ShapeDtypeStruct state's elements by dtype, for the deepseek-v2 config."""
    import jax
    from repro.train import OptimConfig as RefOptimConfig
    from repro.train import optim as ref_optim
    from repro_torch.models import init_all
    from repro_torch.train import OptimConfig, optim

    kw = dict(master_fp32=master, moments_dtype=moments)
    rcfg = ref_base.get_config("deepseek-v2-lite-16b")
    want = ref_optim.init_abstract(RefOptimConfig(**kw), ref_init_all(rcfg, mode="shape")[0])
    got = optim.init_abstract(OptimConfig(**kw),
                              init_all(get_config("deepseek-v2-lite-16b"), device="meta"))
    for name in ("mu", "nu", "master"):
        by_dtype = {}
        for x in tree.leaves(getattr(got, name)):
            assert x.device.type == "meta"
            by_dtype[str(x.dtype).replace("torch.", "")] = \
                by_dtype.get(str(x.dtype).replace("torch.", ""), 0) + x.numel()
        ref = {}
        for x in jax.tree.leaves(getattr(want, name)):
            ref[str(x.dtype)] = ref.get(str(x.dtype), 0) + int(x.size)
        if name == "master" and not master:    # one 0-d f32 a leaf on both sides
            assert set(by_dtype) == set(ref) == {"float32"}
            continue
        assert by_dtype == ref, name


class _Event(SimpleNamespace):
    pass


def test_attribution_ranks_device_time():
    from torch.autograd import DeviceType

    def ev(key, us, count, dev=DeviceType.CUDA):
        return _Event(key=key, self_device_time_total=us, count=count, device_type=dev)

    events = [ev("void bucket_hist_kernel<4>(int const*)", 30.0, 6),
              ev("sm90_xmma_gemm_bf16bf16_bf16f32", 900.0, 40),
              ev("void at::native::vectorized_elementwise_kernel<4, ...>", 250.0, 300),
              ev("Memcpy DtoD (Device -> Device)", 120.0, 12),
              ev("void at::native::reduce_kernel<512, 1>", 0.0, 3),
              ev("aten::mm", 5000.0, 40, DeviceType.CPU),
              ev("void cutlass::Kernel<cutlass_80_tensorop_s1688gemm>", 400.0, 8)]
    prof = SimpleNamespace(key_averages=lambda: events)
    top = attribution.top_bytes(prof, 3)
    assert [name for _, name, _ in top] == [events[1].key, events[6].key, events[2].key]
    assert top[0] == (0.9, events[1].key, 40)
    assert attribution.by_op(prof) == [("matmul", 1.3), ("elementwise", 0.25), ("copy", 0.12),
                                       ("port_kernel", 0.03)]
    got = attribution.profiled_kernels(prof, ("bucket_hist", "rmat_edges"))
    assert got == {"bucket_hist": {"launches": 6, "ms": 0.03},
                   "rmat_edges": {"launches": 0, "ms": 0.0}}


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("variant", ["baseline", "dispatch_int8", "ep_off"])
def test_run_variant_smoke_on_cpu(variant):
    """deepseek-v2-lite's smoke widths (as a config update of the full
    config) over 4 expert shards, 4 x 32 tokens, 3 steps: finite falling
    losses, the counted flops of one step above the model flops (capacity
    padding), the least bytes of the step, no device number (CPU)."""
    smoke = dataclasses.asdict(get_smoke_config("deepseek-v2-lite-16b"))
    smoke.pop("name")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32)
    rec = perf.run_variant("deepseek-v2-lite-16b", shape, variant, cfg_update=smoke,
                           mesh_shape={"data": 1, "model": 4}, batch=4, steps=3, device="cpu")
    assert rec["moe_dispatch"] == ("dense" if variant == "ep_off" else "alltoall")
    assert len(rec["losses"]) == 3 and all(map(torch.isfinite, torch.tensor(rec["losses"])))
    assert rec["losses"][-1] < rec["losses"][0]
    ro = rec["roofline"]
    assert ro["model_flops"] == 6 * get_smoke_config(
        "deepseek-v2-lite-16b").active_param_count() * 4 * 32
    assert ro["flops_per_chip"] > 0 and 0 < ro["useful_flops_ratio"] < 1
    # f32 params read and written, grads written and read, master and two
    # moments (f32) read and written: 4 x 4 + 3 x 8 bytes a parameter
    assert ro["bytes_per_chip"] == 40 * rec["params"]
    assert rec["step_ms"] is None and rec["mfu"] is None and rec["peak_gib"] is None
    assert rec["top_kernels"] == [] and rec["launches"]["flash_attention"] == 0
    with pytest.raises(ValueError, match="train cells"):
        perf.run_variant("deepseek-v2-lite-16b", "decode_32k", variant, device="cpu")
