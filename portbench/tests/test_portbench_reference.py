"""The plain reference against the program's CPU path, bit for bit, at a
small scale: both relabel variants of `generate` (pv, relabelled edges,
owned edges, CSR, drops) and `distributed_walks` (every row's history,
validity and id, drops), with and without records beyond capacity."""

import pytest
import torch

from portbench.loops import common, walks as walk_loop
from portbench.reference import graph as G
from portbench.reference import walks as W
from repro_torch.core.pipeline import generate
from repro_torch.core.types import GraphConfig
from repro_torch.data.walks import distributed_walks

CPU = torch.device("cpu")


def spec_of(cfg: GraphConfig, permutation: str) -> G.GraphSpec:
    return G.GraphSpec(scale=cfg.scale, edge_factor=cfg.edge_factor, nb=cfg.nb, a=cfg.a, b=cfg.b,
                       c=cfg.c, d=cfg.d, permutation=permutation, feistel_rounds=cfg.feistel_rounds,
                       capacity_factor=cfg.capacity_factor, seed=cfg.seed)


CASES = [  # scale, nb, seed, capacity factor
    (10, 4, 2**31 + 17, 2.0),
    (11, 8, 4_000_000_007, 2.0),
    (10, 2, 5, 2.0),
    (10, 4, 99, 0.95),        # redistribute drops records past capacity
]


@pytest.mark.parametrize("variant,permutation", [("paper", "paper"), ("recompute", "feistel")])
@pytest.mark.parametrize("scale,nb,seed,factor", CASES)
def test_generate_matches_the_program(variant, permutation, scale, nb, seed, factor):
    cfg = GraphConfig(scale=scale, nb=nb, seed=seed, capacity_factor=factor)
    res = generate(cfg, shuffle_variant=variant, device="cpu")
    s = spec_of(cfg, permutation)
    numbers = common.compare(common.program_pieces(res, nb),
                             common.reference_pieces(s, CPU))
    assert set(numbers.values()) == {0}, numbers
    if factor < 1:
        assert int(res.dropped_redistribute) > 0


def test_shuffle_rounds_are_the_papers():
    assert G.GraphSpec(26, 16, 8, .57, .19, .19, .05, "paper", 4, 2.0).shuffle_rounds == 9
    for scale, nb in ((10, 4), (12, 8), (10, 2), (16, 4)):
        assert G.GraphSpec(scale, 16, nb, .57, .19, .19, .05, "paper", 4, 2.0).shuffle_rounds == \
            GraphConfig(scale=scale, nb=nb).rounds


def test_mix32_matches_uint32_wrapping():
    import numpy as np

    x = np.random.default_rng(3).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    want = x ^ (x >> np.uint32(16))
    want = want * np.uint32(0x7FEB352D)
    want = want ^ (want >> np.uint32(15))
    want = want * np.uint32(0x846CA68B)
    want = want ^ (want >> np.uint32(16))
    got = G.mix32(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("walkers,length,factor", [(64, 6, 4.0), (100, 5, 1.0), (37, 3, 8.0)])
@pytest.mark.parametrize("variant,permutation", [("paper", "paper"), ("recompute", "feistel")])
def test_walks_match_the_program(walkers, length, factor, variant, permutation):
    cfg = GraphConfig(scale=10, nb=4, seed=2**31 + 3)
    res = generate(cfg, shuffle_variant=variant, device="cpu")
    got = distributed_walks(cfg, res.csr.offv, res.csr.adjv, length=length, seed=2**32 - 7,
                            walkers_per_shard=walkers, capacity_factor=factor)
    offv, adjv = G.global_csr(spec_of(cfg, permutation), CPU)
    want = W.walks(offv, adjv, n=cfg.n, nb=cfg.nb, walkers=walkers, length=length,
                   seed=2**32 - 7, capacity_factor=factor)
    rows = W.as_rows(want)
    assert torch.equal(got[0], rows["hist"])
    assert torch.equal(got[1], rows["valid"]) and torch.equal(got[2], rows["wid"])
    assert int(got[3]) == want["dropped"]
    assert set(walk_loop.compare(got, want)[k]["value"] for k in ("hist", "valid", "wid")) == {0}
    if factor < 2:
        assert want["dropped"] > 0


def test_global_csr_holds_every_kept_edge():
    cfg = GraphConfig(scale=10, nb=4, seed=11)
    s = spec_of(cfg, "paper")
    offv, adjv = G.global_csr(s, CPU)
    assert offv.shape == (cfg.n + 1,) and int(offv[-1]) == adjv.numel() == cfg.m
    assert bool((offv[1:] >= offv[:-1]).all())
