"""The four-card cell on the CPU, each card a block of two shards held
apart there: its loop is correct at a small size and its control is not,
its per-card reference lays out the one-card reference's pieces, a piece
off its card counts whole, and its metrics read the program's spans and
counters, None where there are none.  The `gpu` tests run the cell's loop
over four cards, and skip with fewer."""

import time

import pytest
import torch

from portbench import harness
from portbench.loops import common
from portbench.reference import graph_cards as GC
from repro_torch.core import trace

CELL = "graph500-s28-nb8-x4.generate"
SMALL = {"config": {"graph": {"scale": 12, "nb": 8}}}
NEW = ("cards_exchange_ms", "cards_link_roofline", "cards_spread_ms", "cards_wait_ms")
# the one-card cells' metrics that read the same quantity for one card here:
# card 0's phase times, kernel time summed over the cards against the whole
# graph's work, and ratios of counters summed over the cards
JOINED = ("shuffle_ms", "edges_ms", "relabel_ms", "redistribute_ms", "csr_ms",
          "rmat_edges_roofline", "bucket_hist_roofline.generate", "redistribute_slot_fill",
          "redistribute_merge_kernel_share")


@pytest.fixture(autouse=True)
def no_recorder_left():
    trace.take_device_spans()
    yield
    trace.take_device_spans()


def read(metric, w):
    return harness.load_module(harness.metric_file(metric)).read(w)


def window(calls, sizes, kept="absent"):
    w = harness.Window(calls=calls, seconds=1.0, work={}, memory_peak_bytes=0, setup_s=1.0,
                       sizes=sizes, peaks={}, phase_ms={}, call_ms=[], device=None)
    if kept != "absent":
        from portbench.metrics import _spans as S
        setattr(w, S.KEPT, kept)
    return w


def test_the_cell_is_four_cards_of_two_shards():
    c = harness.load_cell(CELL)
    assert c.entry["chips"] == c.config["placement"]["cards"] == 4
    s = c.loop.sizes(c)
    assert (s["scale"], s["nb"], s["cards"], s["m"]) == (28, 8, 4, 1 << 32)
    assert s["capacity"] == (1 << 27) + 8 and s["shuffle_rounds"] == 10
    assert {m["name"] for m in c.per_layer} == set(NEW) | set(JOINED)


@pytest.mark.parametrize("seed", [2**31 + 77, 3])
def test_sound_run_is_correct_and_control_is_not(seed):
    c = harness.load_cell(CELL, SMALL)
    line, checks = harness.run(c, seed=seed, seconds=0, trace=False, device="cpu",
                               started=time.perf_counter())
    assert line["correct"], checks
    assert line["device"]["count"] == 4 and set(checks) == {
        "pv", "src", "dst", "owned_src", "owned_dst", "owned_valid", "offv", "adjv", "num_edges",
        "dropped"}
    numbers = c.loop.control(harness.Context(c, torch.device("cpu"), seed, trace=False), seed)
    assert any(n["value"] > n["limit"] for n in numbers.values()), numbers


@pytest.mark.parametrize("placement", GC.PLACEMENTS)
@pytest.mark.parametrize("ties", [False, True])
def test_card_pieces_lay_out_the_one_card_reference(placement, ties):
    """Concatenated in card order, the per-card pieces of the consecutive
    placement are the one-card reference's; round robin holds the same
    shards' pieces, on other cards."""
    c = harness.load_cell(CELL, {"config": {"graph": {"scale": 10, "nb": 8},
                                            "program": {"capacity_factor": 1.1}}})
    s = common.spec(c.config, 11, ties_by_dst=ties)
    want = list(common.reference_pieces(s, "cpu"))
    got = list(GC.card_pieces(s, ["cpu"] * 4, placement))
    assert int(want[-1][1]) > 0                          # capacity 1.1 drops edges
    rest = iter(got[12:-1])
    for card in range(4):
        for shard in GC.shards_of(8, 4, card, placement):
            for name, piece in want[3 + 6 * shard:3 + 6 * (shard + 1)]:
                got_card, got_name, got_piece = next(rest)
                assert (got_card, got_name) == (card, name)
                assert torch.equal(got_piece, piece), (shard, name)
    assert torch.equal(got[-1][2], want[-1][1])
    if placement == "consecutive":
        for i, name in enumerate(("pv", "src", "dst")):
            assert torch.equal(torch.cat([p for _, n, p in got[:12] if n == name]), want[i][1])


def test_a_piece_off_its_card_counts_whole():
    loop = harness.load_cell(CELL).loop
    a = torch.arange(6)
    assert loop.compare(iter([(0, "x", torch.empty(6, device="meta"))]),
                        iter([(0, "x", a)])) == {"x": 6}
    assert loop.compare(iter([(0, "x", a)]), iter([(0, "x", a.clone())])) == {"x": 0}


def test_metrics_read_the_programs_spans_and_counters():
    c = harness.load_cell(CELL, SMALL)
    ctx = harness.Context(c, torch.device("cpu"), 2**31 + 9, trace=False)
    state = c.loop.setup(ctx)
    trace.install_device_spans()
    for i in range(2):
        _, _, bad = c.loop.call(ctx, state, i)
        assert not bad
    w = window(2, c.loop.sizes(ctx))
    got = {m: read(m, w) for m in NEW}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["cards_link_roofline"] <= 100
    assert 0 < read("redistribute_slot_fill", w) <= 100
    assert read("redistribute_merge_kernel_share", w) is not None
    counters = trace.take_device_spans() or getattr(w, "program_spans")["counters"]
    assert counters["cards.exchange/copies"] == 2 * 300


def test_metrics_on_planted_spans_and_none_without():
    sizes = {"cards": 2}
    spans = [("generate.card", None, 10.0), ("generate.card", None, 14.0),
             ("cards.exchange", None, 2.0), ("cards.exchange", None, 3.0),
             ("generate.card", None, 11.0), ("generate.card", None, 12.0),
             ("cards.exchange", None, 1.0), ("cards.exchange", None, 2.0),
             ("cards.wait", None, 6.0), ("cards.wait", None, 2.0)]
    kept = {"spans": spans, "counters": {"cards.exchange/bytes": 900_000_000}}
    w = window(2, sizes, kept)
    assert read("cards_exchange_ms", w) == pytest.approx(8.0 / 2 / 2)
    assert read("cards_spread_ms", w) == pytest.approx((4.0 + 1.0) / 2)
    assert read("cards_wait_ms", w) == pytest.approx(8.0 / 2 / 2)
    assert read("cards_link_roofline", w) == pytest.approx(100.0 * 9e8 / 8e-3 / 450e9)
    for metric in NEW:
        assert read(metric, window(2, sizes, None)) is None
        assert read(metric, window(2, sizes, {"spans": [], "counters": {}})) is None
        assert read(metric, window(2, {}, kept)) is None or metric == "cards_link_roofline"


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [16, 20])
def test_traced_run_on_four_cards(four_cards, scale):
    c = harness.load_cell(CELL, {"config": {"graph": {"scale": scale}}})
    line, checks = harness.run(c, seed=2**31 + 43, seconds=0.5, trace=True, device=four_cards,
                               started=time.perf_counter())
    assert line["correct"], checks
    assert set(line["metrics"]) == set(NEW) | set(JOINED)
    assert 0 < line["metrics"]["cards_link_roofline"]["value"] <= 100
    numbers = c.loop.control(harness.Context(c, four_cards, 5, trace=False), 5)
    assert any(n["value"] > n["limit"] for n in numbers.values()), numbers
