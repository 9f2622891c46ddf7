"""The readers of the program's device spans and counters on the CPU: each
reads its closed-form value from a window whose spans and counters are
planted and None where there are none; the two generate cells and the
walks cell at a small size, recorded by the program itself, read the
counters' closed forms; and an idle gap inside a program span is charged
to that span, the innermost host range of a profiled window."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import devtrace, harness
from portbench.metrics import _spans as S
from repro_torch.core import trace

SMALL = {"config": {"graph": {"scale": 10, "nb": 4}},
         "traffic": {"walkers_per_shard": 64, "length": 4}}
SPANS = [("redistribute.sort", None, 2.0), ("redistribute.exchange", None, 3.0),
         ("redistribute.merge", None, 5.0), ("redistribute.sort", None, 2.5),
         ("redistribute.exchange", None, 3.5), ("redistribute.merge", None, 6.0)] + \
    [("walks.exchange", None, 7.0), ("walks.advance", None, 1.0)] * 3
COUNTERS = {"redistribute.exchange/kept": 3, "redistribute.exchange/slots": 8,
            "redistribute.exchange/rows": 4, "redistribute.exchange/live": 4,
            "walks.exchange/live": 24, "walks.exchange/rows": 192}
PLANTED = [("redistribute_sort_ms", 2.25), ("redistribute_exchange_ms", 3.25),
           ("redistribute_merge_ms", 5.5), ("redistribute_slot_fill", 37.5),
           ("walks_exchange_ms", 10.5), ("walks_advance_ms", 1.5),
           ("walks_exchange_live_share", 12.5)]
NEW = [name for name, _ in PLANTED]


@pytest.fixture(autouse=True)
def no_recorder_left():
    trace.take_device_spans()
    yield
    trace.take_device_spans()


def window(calls=2, kept="absent"):
    w = harness.Window(calls=calls, seconds=1.0, work={}, memory_peak_bytes=0, setup_s=1.0,
                       sizes={}, peaks={}, phase_ms={}, call_ms=[], device=None)
    if kept != "absent":
        setattr(w, S.KEPT, kept)
    return w


def read(metric, w):
    return harness.load_module(harness.metric_file(metric)).read(w)


@pytest.mark.parametrize("metric,value", PLANTED)
def test_reader_on_planted_spans_and_counters(metric, value):
    w = window(kept={"spans": SPANS, "counters": COUNTERS})
    assert read(metric, w) == pytest.approx(value)


@pytest.mark.parametrize("metric", NEW)
def test_reader_reads_none_where_nothing_was_recorded(metric):
    assert read(metric, window(kept=None)) is None
    assert read(metric, window(kept={"spans": [], "counters": {}})) is None
    assert read(metric, window()) is None              # the program recorded nothing


def test_the_program_is_asked_once_a_window(monkeypatch):
    asked = []
    monkeypatch.setattr(trace, "take_device_spans",
                        lambda: asked.append(1) or {"spans": SPANS, "counters": COUNTERS})
    w = window()
    assert [read(m, w) for m in NEW] == pytest.approx([v for _, v in PLANTED])
    assert asked == [1]


def test_a_checkout_without_device_spans_reads_none(monkeypatch):
    monkeypatch.delattr(trace, "take_device_spans")
    assert all(read(m, window()) is None for m in NEW)


def cell_window(cell, calls=2):
    """`calls` calls of `cell` at the small size, recorded by the program
    after the set-up, as the traced window records them."""
    c = harness.load_cell(cell, SMALL)
    ctx = harness.Context(c, torch.device("cpu"), 2**31 + 9, trace=False)
    state = c.loop.setup(ctx)
    trace.install_device_spans()
    for i in range(calls):
        _, _, bad = c.loop.call(ctx, state, i)
        assert not bad
    w = window(calls)
    return c, ctx, w


@pytest.mark.parametrize("cell", ["graph500-s26-nb8.generate",
                                  "graph500-s26-nb8-recompute.generate"])
def test_generate_cells_read_their_spans(cell):
    c, ctx, w = cell_window(cell)
    got = {m["name"]: read(m["name"], w) for m in c.per_layer if m["name"] in NEW}
    assert set(got) == {n for n in NEW if n.startswith("redistribute")}
    s = c.loop.sizes(ctx)
    assert got["redistribute_slot_fill"] == pytest.approx(
        100.0 * s["m"] / (s["nb"] * s["nb"] * s["capacity"]))
    assert all(got[f"redistribute_{step}_ms"] > 0 for step in ("sort", "exchange", "merge"))


def test_walks_cell_reads_its_spans():
    c, ctx, w = cell_window("graph500-s26-nb8.walks")
    got = {m["name"]: read(m["name"], w) for m in c.per_layer if m["name"] in NEW}
    assert set(got) == {"walks_exchange_ms", "walks_advance_ms", "walks_exchange_live_share"}
    assert got["walks_exchange_live_share"] == pytest.approx(100.0 / c.traffic["capacity_factor"])
    assert got["walks_exchange_ms"] > 0 and got["walks_advance_ms"] > 0


def test_an_idle_gap_is_charged_to_the_innermost_program_span():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.device_span("walks.exchange", "cpu"):
            torch.ones(8).sum()
            with trace.device_span("walks.advance", "cpu"):
                time.sleep(0.02)
    host = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events()]
    inner = next(h for h in host if h[2] == "walks.advance")
    outer = next(h for h in host if h[2] == "walks.exchange")
    mid = (inner[0] + inner[1]) // 2
    gaps = [(mid - 1000, mid + 1000), (outer[0] - 5000, outer[0] - 1000)]
    got = devtrace.attribute_gaps(gaps, host)
    assert got == pytest.approx({"walks.advance": 2e-6, "host": 4e-6})
    assert [n for n, _, _ in trace.take_device_spans()["spans"]] == \
        ["walks.exchange", "walks.advance"]


def test_the_sizes_closed_forms_at_the_cells_sizes():
    """At scale 26 the slots are 64 x (2^25 + 8): the fill reads just under
    50 %; the walk offers 8 rows a live walker: 12.5 %."""
    c = harness.load_cell("graph500-s26-nb8.generate")
    s = c.loop.sizes(SimpleNamespace(config=c.config, traffic=c.traffic))
    assert s["capacity"] == (1 << 25) + 8
    fill = 100.0 * s["m"] / (s["nb"] ** 2 * s["capacity"])
    assert 49.9 < fill < 50.0
    walks = harness.load_cell("graph500-s26-nb8.walks")
    assert 100.0 / walks.traffic["capacity_factor"] == 12.5
