"""The port's `generate` (`repro_torch`, device="cpu") against the reference's.

The reference runs once per file, in one subprocess with 8 fake CPU devices
(tests/torch_parity.py), for every configuration below; each test compares
one configuration bit for bit (all values are integers: tolerance zero).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as ref_coll
from repro_torch import generate, generate_baseline_hash
from repro_torch.core import validate as V
from repro_torch.core.csr import csr_neighbors, csr_to_host
from repro_torch.core.pipeline import generate_edges
from repro_torch.core.types import GraphConfig
from repro_torch.distributed import collectives as coll
from torch_parity import ROOT, run_reference

SCALE = 10
VARIANTS = [(sv, rv, cv) for sv in ("paper", "argsort") for rv in ("ring", "alltoall")
            for cv in ("sorted", "scatter")] + [("recompute", "ring", cv)
                                                for cv in ("sorted", "scatter")]
CASES = [(nb, *v) for nb in (1, 8) for v in VARIANTS] + [(2, "paper", "ring", "sorted")]
BASELINE_SCALES = (9, 10)
FIELDS = ("pv", "src", "dst", "owned_src", "owned_dst", "owned_valid", "offv", "adjv",
          "num_edges", "dropped_relabel", "dropped_redistribute")


def _key(nb, sv, rv, cv):
    return f"{nb}_{sv}_{rv}_{cv}"


def _cfg_kw(nb, rv, cv):
    # capacity_factor 6.0 where the all_to_all relabel would drop at 2.0
    return dict(scale=SCALE, nb=nb, relabel_variant=rv, csr_variant=cv,
                capacity_factor=6.0 if rv == "alltoall" else 2.0)


@pytest.fixture(scope="module")
def reference():
    body = f"""
from repro.core.types import GraphConfig
from repro.core.pipeline import generate, generate_baseline_hash
for nb, sv, rv, cv, kw in {[(*c, _cfg_kw(c[0], c[2], c[3])) for c in CASES]!r}:
    r = generate(GraphConfig(**kw), shuffle_variant=sv)
    key = f"{{nb}}_{{sv}}_{{rv}}_{{cv}}"
    vals = dict(pv=r.pv, src=r.src, dst=r.dst, owned_src=r.owned.src, owned_dst=r.owned.dst,
                owned_valid=r.owned.valid, offv=r.csr.offv, adjv=r.csr.adjv,
                num_edges=r.csr.num_edges, dropped_relabel=r.dropped_relabel,
                dropped_redistribute=r.dropped_redistribute)
    for f, v in vals.items():
        OUT[key + "/" + f] = v
for scale in {BASELINE_SCALES!r}:
    offv, dst = generate_baseline_hash(GraphConfig(scale=scale))
    OUT[f"hash{{scale}}/offv"] = offv
    OUT[f"hash{{scale}}/dst"] = dst
"""
    return run_reference(body)


def _port_fields(r):
    return dict(pv=r.pv, src=r.src, dst=r.dst, owned_src=r.owned.src, owned_dst=r.owned.dst,
                owned_valid=r.owned.valid, offv=r.csr.offv, adjv=r.csr.adjv,
                num_edges=r.csr.num_edges, dropped_relabel=r.dropped_relabel,
                dropped_redistribute=r.dropped_redistribute)


@pytest.mark.parametrize("nb,sv,rv,cv", CASES)
def test_generate_matches_reference(reference, nb, sv, rv, cv):
    r = generate(GraphConfig(**_cfg_kw(nb, rv, cv)), shuffle_variant=sv, device="cpu")
    got = _port_fields(r)
    key = _key(nb, sv, rv, cv)
    for f in FIELDS:
        want = reference[key + "/" + f]
        assert tuple(got[f].shape) == want.shape, f
        np.testing.assert_array_equal(got[f].numpy(), want, err_msg=f)
    assert int(r.dropped_redistribute) == 0


@pytest.mark.parametrize("scale", BASELINE_SCALES)
def test_baseline_hash_matches_reference(reference, scale):
    offv, dst = generate_baseline_hash(GraphConfig(scale=scale), device="cpu")
    np.testing.assert_array_equal(offv.numpy(), reference[f"hash{scale}/offv"])
    np.testing.assert_array_equal(dst.numpy(), reference[f"hash{scale}/dst"])


def test_pipeline_8_shards_full_validation():
    """The reference's 8-shard checks (tests/test_distributed.py), with the
    port's validate, on the port's own graph."""
    cfg = GraphConfig(scale=12, nb=8, capacity_factor=4.0)
    res = generate(cfg, device="cpu")
    assert int(res.dropped_redistribute) == 0
    assert V.check_permutation(res.pv)
    src, dst = generate_edges(cfg, device="cpu")
    assert V.check_relabel(src, dst, res.src, res.dst, res.pv)
    assert V.check_ownership(res.owned.src, res.owned.valid, cfg)
    checks = V.check_csr(res.csr, res.owned, cfg)
    assert all(checks.values()), checks
    # de-biasing, the reason the paper relabels: raw R-MAT ids crowd the
    # lowest sixteenth of the id range, relabeled ones much less (hubs keep
    # the unbiased 1/16 noisy at this scale)
    assert V.endpoint_skew(src, dst, cfg.n) > 0.2
    assert V.endpoint_skew(res.src, res.dst, cfg.n) < 0.1
    # the checks are not vacuous: one corrupted neighbour fails the multiset
    bad = res.csr._replace(adjv=res.csr.adjv.clone())
    bad.adjv[0] += 1
    assert V.check_csr(bad, res.owned, cfg)["multiset"] is False
    assert not V.check_relabel(src, dst, res.src.flip(0), res.dst, res.pv)
    # host assembly agrees with per-vertex lookups
    offv, adjv = csr_to_host(res.csr, cfg)
    for v in (0, 1, cfg.n // 2, cfg.n - 1):
        np.testing.assert_array_equal(adjv[offv[v]:offv[v + 1]],
                                      csr_neighbors(res.csr, cfg, v).numpy())


@pytest.mark.parametrize("parts", [1, 3, 8])
def test_check_relabel_in_slices(parts):
    """The sliced multiset compare accepts the graph whatever the slice
    count, and rejects a moved destination and a source outside [0, n)."""
    cfg = GraphConfig(scale=8, nb=2)
    res = generate(cfg, device="cpu")
    src, dst = generate_edges(cfg, device="cpu")
    assert V.check_relabel(src, dst, res.src, res.dst, res.pv, parts=parts)
    moved = res.dst.clone()
    moved[0] = (moved[0] + 1) % cfg.n
    assert not V.check_relabel(src, dst, res.src, moved, res.pv, parts=parts)
    outside = res.src.clone()
    outside[0] = cfg.n
    assert not V.check_relabel(src, dst, outside, res.dst, res.pv, parts=parts)


@pytest.mark.parametrize("capacity,with_valid", [(40, False), (9, False), (40, True)])
def test_bucket_by_destination_matches_reference(capacity, with_valid):
    """Stable ranks, capacity drops and dead rows, against the reference's function."""
    rng = np.random.default_rng(capacity)
    k, n = 8, 300
    dest = rng.integers(0, k, n).astype(np.int32)
    data = rng.integers(0, 1 << 20, (n, 2)).astype(np.int32)
    valid = rng.random(n) < 0.8 if with_valid else None
    want = ref_coll.bucket_by_destination(
        jnp.asarray(data), jnp.asarray(dest), k, capacity,
        valid=None if valid is None else jnp.asarray(valid))
    got = coll.bucket_by_destination(
        torch.from_numpy(data), torch.from_numpy(dest), k, capacity,
        valid=None if valid is None else torch.from_numpy(valid))
    for f in ("data", "valid", "position", "dropped"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    live = dest if valid is None else dest[valid]
    np.testing.assert_array_equal(got.counts.numpy(), np.bincount(live, minlength=k))
    back = coll.unbucket(got.data, got.position, fill=-7)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        ref_coll.unbucket(want.data, want.position, fill=-7)))


def test_merge_sorted_runs_matches_reference():
    """Ties keep run order (a before b) through every pairwise round."""
    rng = np.random.default_rng(11)
    keys = np.sort(rng.integers(0, 50, (8, 64)), axis=1).astype(np.int32)
    pay = rng.integers(0, 1000, (8, 64, 2)).astype(np.int32)
    wk, wp = ref_coll.merge_sorted_runs(jnp.asarray(keys), jnp.asarray(pay))
    gk, gp = coll.merge_sorted_runs(torch.from_numpy(keys), torch.from_numpy(pay))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def test_port_imports_without_jax():
    """repro_torch and every submodule import with jax unavailable, and never
    pull in the reference package."""
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert {"repro_torch.serve", "repro_torch.models", "repro_torch.models.moe",
        "repro_torch.distributed.sharding",
        "repro_torch.launch.serve", "repro_torch.data", "repro_torch.data.walks",
        "repro_torch.data.loader"} <= set(names)
from repro_torch.distributed.sharding import make_dist
from repro_torch.models.moe import moe_expert_parallel
assert {f"repro_torch.core.{m}" for m in ("trace", "blockstore", "shardmap", "transport",
        "corpus", "phases", "external", "chunks", "hostgen", "types", "cluster",
        "jobqueue")} <= set(names)
assert "repro_torch.launch.cluster" in names
assert {f"repro_torch.launch.{m}" for m in ("mesh", "roofline", "attribution", "cells", "dryrun",
        "perf")} <= set(names)
from repro_torch.launch.perf import run_variant
from repro_torch.launch.dryrun import main as dryrun_main
from repro_torch.core import generate, GraphConfig, feistel_permute, pv_is_permutation
from repro_torch.configs import SHAPES, ShapeSpec, long_context_supported
from repro_torch.train.optim import init_abstract
assert {"repro_torch.train", "repro_torch.launch.train"} | {f"repro_torch.train.{m}" for m in (
        "optim", "step", "compression", "checkpoint", "fault", "tree")} <= set(names)
from repro_torch.train import OptimConfig, TrainState, init_state, make_train_step
from repro_torch.train.fault import run_with_restarts
from repro_torch.launch.train import main as train_main
from repro_torch.core import ClusterGenerator, HostRunner, PartitionedGenerator, StreamingGenerator
from repro_torch.core.cluster import ClusterController, LocalExecBackend
from repro_torch.core.jobqueue import JobScheduler, submit_job
from repro_torch.launch.cluster import main as cluster_main
from repro_torch.data import ExternalWalkLoader, concat_bucket_csr, external_walks
assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules), "reference imported"
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip()) >= 20


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """device="cuda" on a machine without CUDA raises; nothing falls back."""
    from repro_torch.core import shuffle
    from repro_torch.core.rmat import rmat_edge_block
    from repro_torch.kernels import ops

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cluster import ClusterGenerator, ClusterSpec
    from repro_torch.core.jobqueue import JobScheduler
    from repro_torch.core.phases import plain_config
    from repro_torch.launch import cluster as launch_cluster
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import init_all, transformer
    from repro_torch.serve import Engine, Request, generate_reference

    lm = get_smoke_config("internlm2-1.8b")
    lm_params = init_all(lm, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GraphConfig(scale=6, nb=2)
    calls = [
        lambda: generate(cfg, device="cuda"),
        lambda: generate(cfg),
        lambda: generate(cfg, shuffle_variant="recompute", device="cuda"),
        lambda: generate_baseline_hash(cfg, device="cuda"),
        lambda: generate_edges(cfg, device="cuda"),
        lambda: shuffle.distributed_shuffle(cfg, device="cuda"),
        lambda: shuffle.shuffle_argsort(cfg, device="cuda"),
        lambda: shuffle.shuffle_recompute(cfg, device="cuda"),
        lambda: rmat_edge_block(cfg, 0, 16, device="cuda"),
        lambda: ops.rmat_edges(cfg, 0, 16, device="cuda"),
        lambda: init_all(lm),
        lambda: transformer.init_cache(lm, 1, 8),
        lambda: init_all(lm, seed=1, device="cuda"),
        lambda: Engine(lm, lm_params),
        lambda: Engine(lm, lm_params, max_batch=2, max_len=16, device="cuda"),
        lambda: generate_reference(lm, lm_params, Request(uid=0, prompt=[1])),
        lambda: launch_serve.main([]),
        lambda: ClusterGenerator(cfg.with_(transport="socket", shuffle_variant="external"),
                                 ClusterSpec.local(2, str(tmp_path / "h"), nb=2),
                                 str(tmp_path / "c")),
        lambda: ClusterGenerator(plain_config(cfg.with_(transport="socket"), "cpu"),
                                 ClusterSpec.local(2, str(tmp_path / "h"), nb=2),
                                 str(tmp_path / "c"), device="cuda"),
        lambda: JobScheduler(ClusterSpec.local(2, str(tmp_path / "h"), nb=2),
                             str(tmp_path / "q")),
        lambda: launch_cluster.main(["run", "--workdir", str(tmp_path / "r"), "--nb", "2"]),
        lambda: launch_cluster.main(["drain", "--workdir", str(tmp_path / "d"), "--nb", "2"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not os.listdir(tmp_path)     # the cluster's entry points started nothing
