"""The port's device walk corpus (`repro_torch.data`, device="cpu") against
the reference's (`repro.data`).

The reference's `distributed_walks` and `capacity_all_to_all` run under
shard_map, so they run once per file in one subprocess with 8 fake CPU
devices (tests/torch_parity.py); the jax-free parts are called in this
process.  Every value is an integer: tolerance zero throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import walks as ref_walks
from repro_torch import generate
from repro_torch.core.csr import csr_global, csr_to_host
from repro_torch.core.types import GraphConfig
from repro_torch.data import (LoaderConfig, WalkLoader, csr_walks, distributed_walks, host_walks,
                              start_vertex, walks_to_tokens)
from repro_torch.distributed import collectives as coll
from torch_parity import run_reference

SCALE, W, LENGTH = 10, 16, 12
# nb, seed, capacity factor, length; factor 1.0 drops walkers at nb 2 and 8
# (hubs make 4.0 drop some too at nb 8)
WALK_CASES = ([(nb, seed, 4.0, LENGTH) for nb in (1, 2, 8) for seed in (0, 7)]
              + [(8, 7, 1.0, LENGTH), (2, 0, 1.0, LENGTH), (2, 0, 4.0, 0)])
LOADER = dict(batch_size=4, seq_len=16, vocab=97, seed=3)
A2A_NB, A2A_N, A2A_CAP = 8, 40, 6


def _a2a_inputs():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 1 << 20, (A2A_NB, A2A_N, 3)).astype(np.int32)
    dest = rng.integers(0, A2A_NB, (A2A_NB, A2A_N)).astype(np.int32)
    valid = rng.random((A2A_NB, A2A_N)) < 0.7
    return data, dest, valid


@pytest.fixture(scope="module")
def reference():
    data, dest, valid = _a2a_inputs()
    body = f"""
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.types import GraphConfig
from repro.core.pipeline import generate
from repro.data.walks import distributed_walks
from repro.data.loader import LoaderConfig, WalkLoader
from repro.distributed.collectives import capacity_all_to_all, flat_mesh, shard_map

graphs = {{}}
for nb, seed, cf, length in {WALK_CASES!r}:
    cfg = GraphConfig(scale={SCALE}, nb=nb)
    mesh = flat_mesh(nb)
    if nb not in graphs:
        graphs[nb] = generate(cfg, mesh)
    res = graphs[nb]
    h, v, w, d = distributed_walks(cfg, mesh, res.csr.offv, res.csr.adjv, length=length,
                                   seed=seed, walkers_per_shard={W}, capacity_factor=cf)
    key = f"{{nb}}_{{seed}}_{{cf}}_{{length}}"
    OUT[key + "/hist"], OUT[key + "/valid"], OUT[key + "/wid"], OUT[key + "/dropped"] = h, v, w, d
try:
    cfg = GraphConfig(scale={SCALE}, nb=8)
    distributed_walks(cfg, flat_mesh(8), graphs[8].csr.offv, graphs[8].csr.adjv, length=2,
                      walkers_per_shard={W}, capacity_factor=0.5)
    OUT["raises_at_half"] = False
except Exception:
    OUT["raises_at_half"] = True

loader = WalkLoader(GraphConfig(scale={SCALE}, nb=8), graphs[8].csr, LoaderConfig(**{LOADER!r}))
for step in range(4):
    b = loader.batch(step)
    OUT[f"loader{{step}}/tokens"], OUT[f"loader{{step}}/labels"] = b["tokens"], b["labels"]

data = jnp.asarray(np.array({data.tolist()!r}, np.int32)).reshape(-1, 3)
dest = jnp.asarray(np.array({dest.tolist()!r}, np.int32)).reshape(-1)
valid = jnp.asarray(np.array({valid.tolist()!r}, bool)).reshape(-1)
mesh = flat_mesh({A2A_NB})

def per_shard(x, d, v):
    ex = capacity_all_to_all(x, d, axis="shards", capacity={A2A_CAP}, valid=v)
    return ex.data[None], ex.valid[None], ex.position[None], ex.dropped[None]

fn = shard_map(per_shard, mesh=mesh, in_specs=(P("shards"),) * 3, out_specs=(P("shards"),) * 4)
for f, val in zip(("data", "valid", "position", "dropped"), fn(data, dest, valid)):
    OUT["a2a/" + f] = val
"""
    return run_reference(body)


@pytest.fixture(scope="module")
def graphs():
    return {nb: generate(GraphConfig(scale=SCALE, nb=nb), device="cpu") for nb in (1, 2, 8)}


@pytest.mark.parametrize("nb,seed,cf,length", WALK_CASES)
def test_distributed_walks_match_reference(reference, graphs, nb, seed, cf, length):
    cfg = GraphConfig(scale=SCALE, nb=nb)
    csr = graphs[nb].csr
    got = distributed_walks(cfg, csr.offv, csr.adjv, length=length, seed=seed,
                            walkers_per_shard=W, capacity_factor=cf)
    key = f"{nb}_{seed}_{cf}_{length}"
    for f, g in zip(("hist", "valid", "wid", "dropped"), got):
        want = reference[f"{key}/{f}"]
        assert tuple(g.shape) == want.shape, f
        np.testing.assert_array_equal(g.numpy(), want, err_msg=f)
    if cf == 1.0 and nb > 1:   # drops and the rows they leave invalid match too
        assert int(got[3]) > 0 and int(got[1].sum()) < nb * W


def test_distributed_walks_match_host_oracle(graphs):
    """Every live walk equals host_walks from its own start (the reference's
    tests/test_distributed.py check, on the port)."""
    cfg = GraphConfig(scale=SCALE, nb=8)
    csr = graphs[8].csr
    hist, valid, wid, dropped = distributed_walks(cfg, csr.offv, csr.adjv, length=LENGTH, seed=7,
                                                  walkers_per_shard=W, capacity_factor=8.0)
    hist, valid, wid = hist.numpy(), valid.numpy(), wid.numpy()
    live = valid & (wid >= 0)
    assert int(dropped) == 0 and live.sum() == 8 * W
    starts = start_vertex(7, wid[live].astype(np.uint32), cfg.bucket_size,
                          (wid[live] // W) * cfg.bucket_size)
    offv, adjv = csr_to_host(csr, cfg)
    want = host_walks(offv, adjv, starts, LENGTH, 7, n=cfg.n, walker_ids=wid[live])
    np.testing.assert_array_equal(hist[live], want)


@pytest.mark.parametrize("nb,seed", [(1, 0), (2, 3), (8, 7)])
def test_walker_zero_keeps_its_history_among_empty_slots(graphs, nb, seed):
    """Factor 8 leaves 7 in 8 of the rows empty, and an empty slot carries
    walker id 0 and no walker: walker 0's one row still holds its own whole
    walk (host_walks from its start), so no empty slot wrote through id 0."""
    cfg = GraphConfig(scale=SCALE, nb=nb)
    csr = graphs[nb].csr
    hist, valid, wid, dropped = distributed_walks(cfg, csr.offv, csr.adjv, length=LENGTH,
                                                  seed=seed, walkers_per_shard=W,
                                                  capacity_factor=8.0)
    valid, wid = valid.numpy(), wid.numpy()
    assert int(dropped) == 0 and valid.sum() == nb * W and (~valid).sum() == 7 * nb * W
    assert (wid[~valid] == 0).all()
    zero = np.flatnonzero(valid & (wid == 0))
    assert zero.size == 1
    start = start_vertex(seed, np.zeros(1, np.uint32), cfg.bucket_size, 0)
    offv, adjv = csr_to_host(csr, cfg)
    want = host_walks(offv, adjv, start, LENGTH, seed, n=cfg.n, walker_ids=np.zeros(1, np.int64))
    np.testing.assert_array_equal(hist.numpy()[zero], want)
    assert (hist.numpy()[~valid] == 0).all()


def test_capacity_below_walkers_raises(reference, graphs):
    """Factor 0.5 leaves fewer rows per shard than walkers: the reference
    fails, the port raises ValueError."""
    assert bool(reference["raises_at_half"])
    csr = graphs[8].csr
    with pytest.raises(ValueError, match="rows per shard"):
        distributed_walks(GraphConfig(scale=SCALE, nb=8), csr.offv, csr.adjv, length=2,
                          walkers_per_shard=W, capacity_factor=0.5)


def test_vertex_dtype_overflow_raises():
    """n - 1 past int32's largest value: refused before any work."""
    none = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="overflows"):
        distributed_walks(GraphConfig(scale=32), none, none, length=1)
    assert GraphConfig(scale=31).n - 1 == torch.iinfo(torch.int32).max


@pytest.mark.parametrize("nb", [1, 2, 8])
def test_csr_global_matches_reference_assembly(graphs, nb):
    """The loader's CSR, assembled with tensor ops where the shards lie,
    equals the reference's host assembly of the same shards."""
    from repro.core.csr import csr_to_host as ref_csr_to_host

    cfg = GraphConfig(scale=SCALE, nb=nb)
    csr = graphs[nb].csr
    offv, adjv = csr_global(csr, cfg)
    want_offv, want_adjv = ref_csr_to_host(type(csr)(*(t.numpy() for t in csr)), cfg)
    assert offv.dtype == torch.int64 and adjv.dtype == csr.adjv.dtype
    np.testing.assert_array_equal(offv.numpy(), want_offv)
    np.testing.assert_array_equal(adjv.numpy(), want_adjv)


@pytest.mark.parametrize("step", range(4))
def test_walk_loader_matches_reference(reference, graphs, step):
    loader = WalkLoader(GraphConfig(scale=SCALE, nb=8), graphs[8].csr, LoaderConfig(**LOADER),
                        device="cpu")
    b = loader.batch(step)
    for f in ("tokens", "labels"):
        assert b[f].dtype == torch.int32 and b[f].is_contiguous()
        np.testing.assert_array_equal(b[f].numpy(), reference[f"loader{step}/{f}"], err_msg=f)


def test_walk_loader_defaults_to_cuda(graphs, monkeypatch):
    """The loader's device is CUDA unless the caller asks for the CPU; without
    CUDA it raises and nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GraphConfig(scale=SCALE, nb=8)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="cuda"):
            WalkLoader(cfg, graphs[8].csr, LoaderConfig(**LOADER), **kw)


def test_capacity_all_to_all_valid_matches_reference(reference):
    """Rows with valid=False take no slot and are not counted as dropped."""
    data, dest, valid = _a2a_inputs()
    got = coll.capacity_all_to_all(torch.from_numpy(data), torch.from_numpy(dest),
                                   capacity=A2A_CAP, valid=torch.from_numpy(valid))
    want = {f: reference["a2a/" + f] for f in ("data", "valid", "position", "dropped")}
    np.testing.assert_array_equal(got.data.numpy(), want["data"])
    np.testing.assert_array_equal(got.valid.numpy(), want["valid"])
    np.testing.assert_array_equal(got.position.numpy(), want["position"])
    # the reference's dropped count is psum'd: every shard holds the total
    assert (want["dropped"] == int(got.dropped)).all() and int(got.dropped) > 0
    everything = coll.capacity_all_to_all(torch.from_numpy(data), torch.from_numpy(dest),
                                          capacity=A2A_CAP)
    assert int(everything.dropped) > int(got.dropped)


# ---------------------------------------------------------------------------
# the jax-free parts, against the reference in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_start_vertex_matches_reference(seed):
    rng = np.random.default_rng(seed & 0xFF)
    wid = np.concatenate([rng.integers(0, 1 << 32, 300), [0, 0xFFFFFFFF]]).astype(np.uint32)
    n = 1 << 10
    np.testing.assert_array_equal(start_vertex(seed, wid, n), ref_walks.start_vertex(seed, wid, n))
    base = 3 << 7
    want = ref_walks.start_vertex(seed, jnp.asarray(wid), 1 << 7, jnp.int32(base))
    got = start_vertex(seed, torch.from_numpy(wid.astype(np.int64)), 1 << 7, base)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a padding row's id -1 is the walker 0xFFFFFFFF
    assert int(start_vertex(seed, torch.tensor([-1]), n)[0]) == int(
        ref_walks.start_vertex(seed, np.array([0xFFFFFFFF], np.uint32), n)[0])


@pytest.mark.parametrize("seed,length", [(0, 12), (7, 30)])
def test_host_walks_and_csr_walks_match_reference(graphs, seed, length):
    cfg = GraphConfig(scale=SCALE, nb=8)
    offv, adjv = csr_to_host(graphs[8].csr, cfg)
    wid = np.arange(100, 164).astype(np.uint32)
    starts = ref_walks.start_vertex(seed, wid, cfg.n)
    want = ref_walks.host_walks(offv, adjv, starts, length, seed, n=cfg.n, walker_ids=wid)
    np.testing.assert_array_equal(host_walks(offv, adjv, starts, length, seed, n=cfg.n,
                                             walker_ids=wid), want)
    got = csr_walks(torch.from_numpy(offv), torch.from_numpy(adjv), torch.from_numpy(starts),
                    length, seed, n=cfg.n, walker_ids=torch.from_numpy(wid.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_host_walks_teleport_from_sinks():
    """A graph whose vertices 1 and 3 have no edges: walkers there teleport
    to rand % n, as in the reference."""
    offv = np.array([0, 2, 2, 3, 3], np.int64)
    adjv = np.array([1, 3, 0], np.int32)
    starts = np.array([0, 1, 2, 3, 1], np.int64)
    want = ref_walks.host_walks(offv, adjv, starts, 9, 5)
    np.testing.assert_array_equal(host_walks(offv, adjv, starts, 9, 5), want)
    got = csr_walks(torch.from_numpy(offv), torch.from_numpy(adjv), torch.from_numpy(starts), 9, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("vocab", [7, 512])
def test_walks_to_tokens_matches_reference(vocab):
    walks = np.random.default_rng(vocab).integers(0, 1 << 20, (5, 9)).astype(np.int64)
    want = ref_walks.walks_to_tokens(walks, vocab)
    for got in (walks_to_tokens(walks, vocab), walks_to_tokens(torch.from_numpy(walks), vocab)):
        for g, w in zip(got, want):
            g = g.numpy() if isinstance(g, torch.Tensor) else g
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
