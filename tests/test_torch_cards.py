"""The graph path with its nb shards placed on several cards, on the CPU:
each card is a block of consecutive shards held apart on the CPU device,
so the collectives copy between blocks as they copy between cards.  Every
collective across blocks, and `generate` over 2, 4 and 8 blocks, gives the
bits of the same call on one block.  No jax: the one-block path is held
against the reference in tests/test_torch_pipeline.py."""

import pytest
import torch

from repro_torch.core import trace
from repro_torch.core.pipeline import generate, generate_edges, placement
from repro_torch.core.types import GraphConfig
from repro_torch.distributed import collectives as coll
from repro_torch.launch import mesh

CPU = torch.device("cpu")


def blocks(x: torch.Tensor, cards: coll.Cards):
    return [b.clone() for b in x.split(cards.per_card)]


def cat(x):
    return torch.cat(x) if isinstance(x, list) else x


@pytest.fixture(autouse=True)
def no_recorder_left():
    trace.take_device_spans()
    yield
    trace.take_device_spans()


def test_placement_splits_consecutive_shards():
    cards = placement(8, ["cpu"] * 4)
    assert cards.count == 4 and cards.per_card == 2 and [cards.first(c) for c in range(4)] == \
        [0, 2, 4, 6]
    assert placement(8, "cpu") == coll.Cards((CPU,), 8)
    for nb, d in ((8, 3), (2, 4)):
        with pytest.raises(ValueError):
            placement(nb, ["cpu"] * d)
    m = mesh.make_graph_mesh(8, ["cpu"] * 4)
    assert (m.nb, m.count, m.per_card) == (8, 4, 2)


def _exchange_input(nb, N, seed, empty):
    g = torch.Generator().manual_seed(seed)
    data = torch.randint(0, 1 << 20, (nb, N, 2), generator=g, dtype=torch.int32)
    dest = torch.randint(0, nb, (nb, N), generator=g, dtype=torch.int32)
    if empty:
        dest = torch.where(dest == 1, 0, dest)        # no sender has a record for shard 1
    valid = torch.rand((nb, N), generator=g) < 0.7
    return data, dest, valid


@pytest.mark.parametrize("nb,D", [(8, 1), (8, 2), (8, 4), (8, 8), (4, 4), (2, 2)])
@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_all_to_all_across_blocks_equals_one_block(nb, D, empty, masked):
    """Buckets, validity and drops (capacity below some senders' counts)
    are those of the one-block exchange, the receivers split over the
    blocks; an empty bucket stays empty."""
    data, dest, valid = _exchange_input(nb, 40, nb * 10 + D, empty)
    cap = 6
    want = coll.capacity_all_to_all(data, dest, capacity=cap, valid=valid if masked else None)
    cards = placement(nb, ["cpu"] * D)
    got = coll.capacity_all_to_all(blocks(data, cards), blocks(dest, cards), capacity=cap,
                                   valid=blocks(valid, cards) if masked else None, cards=cards)
    for a, b in zip(got[:2], want[:2]):
        assert len(a) == D and torch.equal(torch.cat(a), b)
    assert got.position is None                        # no return trip crosses cards
    assert int(got.dropped) == int(want.dropped) > 0
    if empty:
        assert not bool(torch.cat(got.valid)[1].any())


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sum_all_gather_and_slice_exchange_across_blocks(D):
    nb, B = 8, 16
    cards = placement(nb, ["cpu"] * D)
    parts = [torch.tensor(c + 1) for c in range(D)]
    assert int(coll.cards_sum(parts)) == D * (D + 1) // 2
    x = torch.arange(nb * B, dtype=torch.int32).reshape(nb, B)
    for whole in coll.all_gather(blocks(x, cards), cards):
        assert torch.equal(whole, x.reshape(-1))
    got = coll.slice_exchange(blocks(x, cards), cards)
    assert torch.equal(torch.cat(got), x.reshape(nb, nb, B // nb).transpose(0, 1).reshape(nb, B))


def test_exchange_spans_and_counts_the_copies_between_blocks():
    """Each block's copies to the others count their bytes under the span
    "cards.exchange"; a copy inside a block counts nothing; each block's
    wait for the copies sent to it is a span "cards.wait"."""
    nb, B, D = 8, 16, 4
    cards = placement(nb, ["cpu"] * D)
    x = torch.arange(nb * B, dtype=torch.int32).reshape(nb, B)
    rec = trace.install_device_spans()
    coll.slice_exchange(blocks(x, cards), cards)
    got = trace.take_device_spans()
    assert rec is not None
    moved = nb * B * 4 * (D - 1) // D                   # each block keeps 1/D of its slices
    assert got["counters"] == {"cards.exchange/bytes": moved,
                               "cards.exchange/copies": D * (D - 1) * (nb // D) ** 2}
    names = [n for n, _, _ in got["spans"]]
    assert names == ["cards.exchange"] * D + ["cards.wait"] * D   # the sends, then the arrivals


def _all_gather(x, cards):
    return coll.all_gather(blocks(x.reshape(cards.nb, -1), cards), cards)


def _slices(x, cards):
    return coll.slice_exchange(blocks(x.reshape(cards.nb, -1), cards), cards)


def _buckets(x, cards):
    x = x.reshape(cards.nb, -1)
    return coll.capacity_all_to_all(blocks(torch.stack([x, x], -1), cards),
                                    blocks(x % cards.nb, cards), capacity=x.shape[1],
                                    cards=cards)


@pytest.mark.parametrize("exchange", [_all_gather, _slices, _buckets])
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_waits_are_spans_of_their_own(exchange, D):
    """Every collective across blocks times its copies under
    "cards.exchange" and each block's wait for them under "cards.wait",
    one of each a block that sends or receives, and no wait is counted;
    one block copies nothing and waits for nothing."""
    nb = 8
    cards = placement(nb, ["cpu"] * D)
    x = torch.arange(nb * 16, dtype=torch.int32)
    trace.install_device_spans()
    exchange(x, cards)
    got = trace.take_device_spans()
    names = [n for n, _, _ in got["spans"]]
    assert names.count("cards.wait") == (D if D > 1 else 0)
    assert names.count("cards.exchange") >= (D if D > 1 else 0)
    assert not any(k.startswith("cards.wait/") for k in got["counters"])
    assert (got["counters"].get("cards.exchange/copies", 0) > 0) == (D > 1)


@pytest.mark.parametrize("sv,cv", [("paper", "sorted"), ("recompute", "sorted"),
                                   ("paper", "scatter")])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_generate_over_blocks_equals_one_block(sv, cv, D):
    cfg = GraphConfig(scale=12, nb=8, csr_variant=cv, seed=0x9E37 + D)
    one = generate(cfg, sv, device="cpu")
    many = generate(cfg, sv, device=["cpu"] * D)
    for name in ("pv", "src", "dst"):
        assert len(getattr(many, name)) == D
        assert torch.equal(cat(getattr(many, name)), getattr(one, name)), name
    for part in ("owned", "csr"):
        for f in getattr(one, part)._fields:
            if f == "dropped":
                continue
            assert torch.equal(cat(getattr(getattr(many, part), f)),
                               getattr(getattr(one, part), f)), (part, f)
    assert int(many.dropped_redistribute) == int(one.dropped_redistribute) == 0
    assert int(many.dropped_relabel) == 0


def test_generate_edges_over_blocks():
    cfg = GraphConfig(scale=10, nb=8)
    src, dst = generate_edges(cfg, "cpu")
    s4, d4 = generate_edges(cfg, ["cpu"] * 4)
    assert torch.equal(torch.cat(s4), src) and torch.equal(torch.cat(d4), dst)


def test_one_card_variants_refuse_several():
    cfg = GraphConfig(scale=8, nb=4, relabel_variant="alltoall")
    with pytest.raises(ValueError):
        generate(cfg, "paper", device=["cpu"] * 2)
    with pytest.raises(ValueError):
        generate(GraphConfig(scale=8, nb=4), "argsort", device=["cpu"] * 2)
