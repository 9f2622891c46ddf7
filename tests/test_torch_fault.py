"""The port's checkpoints, restart supervision, heartbeats, straggler plans
and pod-axis int8 reduction (`repro_torch.train`) against the reference's
(`repro.train`), and `launch/train.py` on the CPU.

The twins of tests/test_fault.py run each scenario on the reference and on
the port and require the same outcome (steps kept, steps replayed, the step
restored).  The reference's elastic re-mesh restore becomes a checkpoint
written by one side and restored by the other: leaves are whole logical
arrays under the same names on both.  The straggler plans are held to the
reference's for every hypothesis draw.  `podwise_psum_int8` over a leading
pod dimension is held to the reference's `shard_map` over 8 fake devices
(a subprocess, tests/torch_parity.py): equal codes, so equal results.

launch/train.py runs at scale 9 with --device cpu: the host and external
routes train, a resumed run continues where the checkpoint left off and
gives the uninterrupted run's losses (the CPU is deterministic: exactly),
and the host route's WalkLoader batches equal the reference's bit for bit
(both generate with nb 1, the reference on its one CPU device).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.pipeline import generate as ref_generate
from repro.core.types import GraphConfig as RefGraphConfig
from repro.data import LoaderConfig as RefLoaderConfig
from repro.data import WalkLoader as RefWalkLoader
from repro.train import checkpoint as ref_ck
from repro.train import fault as ref_fault
from repro_torch.core.pipeline import generate
from repro_torch.core.types import GraphConfig
from repro_torch.data import LoaderConfig, WalkLoader
from repro_torch.launch.train import main as train_main
from repro_torch.train import checkpoint as ck
from repro_torch.train import fault
from repro_torch.train.compression import podwise_psum_int8
from torch_parity import one_torch_thread, run_reference  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

IMPLS = {"reference": (ref_ck, ref_fault), "port": (ck, fault)}


def _state(impl, x=0.0):
    if impl == "reference":
        return {"params": {"w": jnp.full((4, 4), x)}, "step": jnp.asarray(x)}
    return {"params": {"w": torch.full((4, 4), float(x))}, "step": torch.tensor(float(x))}


def _both(scenario, tmp_path):
    """scenario(impl, checkpoint module, fault module, dir) on each side."""
    out = {}
    for impl, (ck_mod, fault_mod) in IMPLS.items():
        d = tmp_path / impl
        d.mkdir()
        out[impl] = scenario(impl, ck_mod, fault_mod, str(d))
    assert out["port"] == out["reference"], out
    return out["port"]


def test_save_restore_roundtrip(tmp_path):
    def scenario(impl, ck_mod, _, d):
        ck_mod.save(d, 7, _state(impl, 3.0))
        got = ck_mod.restore(d, 7, _state(impl))
        return (np.asarray(got["params"]["w"]).tolist(), float(got["step"]),
                ck_mod.latest_step(d), sorted(os.listdir(os.path.join(d, "step_00000007"))))

    w, step, latest, files = _both(scenario, tmp_path)
    assert np.all(np.asarray(w) == 3.0) and step == 3.0 and latest == 7
    assert files == ["manifest.json", "params.w.npy", "step.npy"]


def test_keep_k_gc(tmp_path):
    def scenario(impl, ck_mod, _, d):
        for i in range(6):
            ck_mod.save(d, i, _state(impl, i), keep=3)
        return ck_mod.all_steps(d)

    assert _both(scenario, tmp_path) == [3, 4, 5]


def test_corrupt_latest_falls_back(tmp_path):
    def scenario(impl, ck_mod, _, d):
        ck_mod.save(d, 1, _state(impl, 1.0))
        ck_mod.save(d, 2, _state(impl, 2.0))
        with open(os.path.join(d, "step_00000002", "params.w.npy"), "wb") as f:
            f.write(b"not-numpy")
        got, step = ck_mod.restore_latest(d, _state(impl))
        return ck_mod.latest_step(d), step, float(np.asarray(got["params"]["w"]).max())

    assert _both(scenario, tmp_path) == (1, 1, 1.0)


def test_mid_save_crash_leaves_no_trusted_ckpt(tmp_path):
    def scenario(impl, ck_mod, _, d):
        ck_mod.save(d, 1, _state(impl, 1.0))
        os.makedirs(os.path.join(d, "tmp.step_00000005"))
        with open(os.path.join(d, "tmp.step_00000005", "params.w.npy"), "wb") as f:
            f.write(b"partial")
        return ck_mod.latest_step(d), ck_mod.all_steps(d)

    assert _both(scenario, tmp_path) == (1, [1])


def test_manifest_shape_mismatch_rejected(tmp_path):
    def scenario(impl, ck_mod, _, d):
        ck_mod.save(d, 3, _state(impl, 1.0))
        man = os.path.join(d, "step_00000003", "manifest.json")
        with open(man) as f:
            m = json.load(f)
        m["leaves"]["params.w"]["shape"] = [9, 9]
        with open(man, "w") as f:
            json.dump(m, f)
        return ck_mod.latest_step(d)

    assert _both(scenario, tmp_path) is None


def test_async_save(tmp_path):
    def scenario(impl, ck_mod, _, d):
        state = _state(impl, 4.0)
        ck_mod.save(d, 4, state, blocking=False)
        if impl == "port":
            state["params"]["w"].add_(1.0)   # the next step's in-place update
        ck_mod.wait_for_async_saves()
        got = ck_mod.restore(d, 4, _state(impl))
        return ck_mod.latest_step(d), float(np.asarray(got["params"]["w"]).max())

    assert _both(scenario, tmp_path) == (4, 4.0)


def test_run_with_restarts_survives_failures(tmp_path):
    def scenario(impl, _, fault_mod, d):
        crashes = {"left": 3}
        seen = []

        def train_fn(state, step):
            seen.append(step)
            if step == 7 and crashes["left"] > 0:
                crashes["left"] -= 1
                raise fault_mod.WorkerFailure("node died")
            w = state["params"]["w"] + 1.0
            s = jnp.asarray(float(step)) if impl == "reference" else torch.tensor(float(step))
            return {"params": {"w": w}, "step": s}

        final = fault_mod.run_with_restarts(train_fn, ckpt_dir=d, init_state=_state(impl),
                                            total_steps=10, save_every=2, max_restarts=5)
        return float(final["step"]), float(np.asarray(final["params"]["w"]).max()), seen

    step, w, seen = _both(scenario, tmp_path)
    assert step == 9.0 and w == 10.0
    assert seen.count(7) == 4 and seen[:8] == list(range(8))


def test_run_with_restarts_gives_up(tmp_path):
    def scenario(impl, _, fault_mod, d):
        calls = []

        def always_fail(state, step):
            calls.append(step)
            raise fault_mod.WorkerFailure("dead")

        with pytest.raises(fault_mod.WorkerFailure):
            fault_mod.run_with_restarts(always_fail, ckpt_dir=d, init_state=_state(impl),
                                        total_steps=3, save_every=1, max_restarts=2)
        return calls

    assert _both(scenario, tmp_path) == [0, 0, 0]


def test_heartbeat_monitor():
    seen = {}
    for impl, (_, fault_mod) in IMPLS.items():
        t = {"now": 0.0}
        hb = fault_mod.HeartbeatMonitor([0, 1, 2], timeout=10.0, clock=lambda: t["now"])
        t["now"] = 5.0
        hb.beat(0)
        hb.beat(1)
        t["now"] = 12.0
        got = [hb.dead(), hb.alive()]
        hb.beat(2)
        seen[impl] = got + [hb.dead()]
    assert seen["port"] == seen["reference"] == [[2], [0, 1], []]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_implementations(tmp_path, writer):
    """The re-mesh restore's counterpart: whole logical arrays under the same
    names, so a checkpoint of one side restores on the other."""
    d = str(tmp_path)
    w = np.arange(16.0, dtype=np.float32).reshape(4, 4)
    state = {"ref": {"params": {"w": jnp.asarray(w)}, "step": jnp.asarray(2.0)},
             "port": {"params": {"w": torch.from_numpy(w.copy())}, "step": torch.tensor(2.0)}}
    reader = "port" if writer == "reference" else "reference"
    IMPLS[writer][0].save(d, 0, state["ref" if writer == "reference" else "port"])
    got, step = IMPLS[reader][0].restore_latest(
        d, state["ref" if reader == "reference" else "port"])
    assert step == 0
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]), w)
    assert float(got["step"]) == 2.0


def test_bf16_leaves_are_stored_as_bit_patterns(tmp_path):
    """bf16 leaves round-trip bit for bit through uint16 files marked
    "bfloat16"; a file whose dtype disagrees with the manifest is not
    trusted."""
    d = str(tmp_path)
    w = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    state = {"w": w.clone().requires_grad_(True), "n": torch.tensor(3, dtype=torch.int32)}
    ck.save(d, 1, state)
    with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves["w"] == {"shape": [3, 5], "dtype": "bfloat16"}
    assert np.load(os.path.join(d, "step_00000001", "w.npy")).dtype == np.uint16
    got = ck.restore(d, 1, state)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)
    assert got["w"].requires_grad and got["n"].dtype == torch.int32
    np.save(os.path.join(d, "step_00000001", "w.npy"), np.zeros((3, 5), np.int16))
    assert ck.latest_step(d) is None


# ---------------------------------------------------------------------------
# straggler planning (twins of tests/test_property.py's)
# ---------------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 16), mb_per=st.integers(1, 8), seed=st.integers(0, 2**31 - 1))
def test_straggler_plan_conserves_work(n, mb_per, seed):
    times = np.random.default_rng(seed).uniform(0.5, 5.0, n)
    policy = fault.StragglerPolicy()
    plan = policy.plan(times, n * mb_per)
    assert plan == ref_fault.StragglerPolicy().plan(times, n * mb_per)
    assert sum(plan) == n * mb_per
    assert all(p >= policy.min_share for p in plan)


def test_straggler_plan_shifts_work():
    times = [1.0, 1.0, 1.0, 10.0]   # worker 3 is 10x slower
    plan = fault.StragglerPolicy(slow_factor=1.5).plan(times, 16)
    assert plan == ref_fault.StragglerPolicy(slow_factor=1.5).plan(times, 16)
    assert plan[3] < 4 and max(plan[:3]) > 4 and sum(plan) == 16


# ---------------------------------------------------------------------------
# pod-axis int8 reduction (twin of tests/test_distributed.py's)
# ---------------------------------------------------------------------------


def test_podwise_int8_psum():
    """Cross-pod compressed gradient reduction: equal to the reference's
    shard_map over 8 pods, and near the exact mean."""
    g = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    g[3] *= 40.0   # one pod's gradients set the shared scale
    ref = run_reference(f"""
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.collectives import shard_map
from repro.train.compression import podwise_psum_int8

mesh = Mesh(np.asarray(jax.devices()).reshape(8), ('pod',))
g = jnp.asarray(np.asarray({g.tolist()!r}, np.float32))

def per_pod(gl):
    return podwise_psum_int8({{'w': gl[0]}}, 'pod')['w'][None]

OUT['out'] = np.asarray(shard_map(per_pod, mesh=mesh, in_specs=P('pod'),
                                  out_specs=P('pod'))(g))
""")
    got = podwise_psum_int8({"w": torch.from_numpy(g)})["w"]
    assert tuple(got.shape) == (8, 64)
    np.testing.assert_array_equal(got.numpy(), ref["out"])
    scale = np.abs(g).max() / 127.0
    for i in range(8):
        np.testing.assert_allclose(got[i].numpy(), g.mean(0), atol=scale)


# ---------------------------------------------------------------------------
# launch/train.py on the CPU
# ---------------------------------------------------------------------------

CLI = ["--scale", "9", "--batch", "4", "--seq", "32", "--lr", "3e-3", "--device", "cpu"]


def test_train_cli_host_route_trains(tmp_path):
    losses = train_main(CLI + ["--steps", "24", "--ckpt-dir", str(tmp_path / "ck")])
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert ck.latest_step(str(tmp_path / "ck")) == 23


def test_train_cli_resume_continues_and_matches(tmp_path):
    """Interrupted after 6 steps, resumed to 12: the resumed run executes only
    the remaining steps and gives the uninterrupted run's losses."""
    whole = train_main(CLI + ["--steps", "12", "--ckpt-dir", str(tmp_path / "a"),
                              "--ckpt-every", "3"])
    first = train_main(CLI + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b"),
                              "--ckpt-every", "3"])
    rest = train_main(CLI + ["--steps", "12", "--ckpt-dir", str(tmp_path / "b"),
                             "--ckpt-every", "3"])
    assert len(rest) == 6
    np.testing.assert_array_equal(first + rest, whole)


def test_train_cli_external_route_trains(tmp_path):
    losses = train_main(CLI + ["--steps", "20", "--data", "external",
                               "--workdir", str(tmp_path / "wd")])
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert os.path.isfile(tmp_path / "wd" / "pv.npy")


def test_train_cli_corpus_manifest_route(tmp_path):
    """--corpus-manifest streams the batches of a corpus an external run left."""
    wd = tmp_path / "wd"
    train_main(CLI + ["--steps", "2", "--data", "external", "--workdir", str(wd)])
    manifests = [n for n in os.listdir(wd) if n.endswith("manifest.json")]
    assert manifests, os.listdir(wd)
    losses = train_main(CLI + ["--steps", "2", "--corpus-manifest",
                               str(wd / manifests[0])])
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_train_cli_refuses_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        train_main(["--steps", "1"])


def test_walk_loader_batches_equal_reference():
    """The host route's batches: generate at scale 9 with nb 1, then
    WalkLoader, on both sides, bit for bit."""
    lcfg = dict(batch_size=4, seq_len=32, vocab=512)
    ref_cfg = RefGraphConfig(scale=9, nb=len(jax.devices()), capacity_factor=4.0)
    ref_loader = RefWalkLoader(ref_cfg, ref_generate(ref_cfg).csr, RefLoaderConfig(**lcfg))
    cfg = GraphConfig(scale=9, nb=1, capacity_factor=4.0)
    loader = WalkLoader(cfg, generate(cfg, device="cpu").csr, LoaderConfig(**lcfg),
                        device="cpu")
    for step in (0, 1, 7):
        want, got = ref_loader.batch(step), loader.batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
