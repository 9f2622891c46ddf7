"""The device spans and counters of `repro_torch.core.trace` on the CPU, at
scale 10 and nb 4: the spans `redistribute_sorted` and `distributed_walks`
record and their parents, the counters of `capacity_all_to_all` and of
`merge_runs` against their closed forms, a run with no recorder that runs no recorder code and
returns the same bits, a profiled window that records without an install
and holds its own spans only, and each span timed on the clock of the
device its work runs on."""

import time

import pytest
import torch

from repro_torch.core import trace
from repro_torch.core.pipeline import generate
from repro_torch.core.redistribute import default_capacity
from repro_torch.core.types import GraphConfig
from repro_torch.data import walks
from repro_torch.data.walks import distributed_walks
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import capacity_all_to_all
from repro_torch.kernels import merge

SCALE, NB, SEED = 10, 4, 7
W, LENGTH, WALK_SEED = 16, 6, 5
STATE_BYTES = 8            # a walker row crossing the exchange: position and id, int32 each
CFG = GraphConfig(scale=SCALE, edge_factor=16, nb=NB, seed=SEED)
REDISTRIBUTE_SPANS = [("redistribute.sort", None), ("redistribute.exchange", None),
                      ("redistribute.merge", None)]


@pytest.fixture(autouse=True)
def no_recorder_left():
    trace.take_device_spans()
    yield
    trace.take_device_spans()


@pytest.fixture(scope="module")
def graph():
    return generate(CFG, device="cpu")


def leaves(x):
    """Every tensor of a (nested) result tuple, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in leaves(item)]


def walk(res, factor, cfg=CFG):
    return distributed_walks(cfg, res.csr.offv, res.csr.adjv, length=LENGTH, seed=WALK_SEED,
                             walkers_per_shard=W, capacity_factor=factor)


def recorded(fn):
    trace.install_device_spans()
    out = fn()
    return out, trace.take_device_spans()


def test_no_recorder_runs_no_recorder_code_and_returns_the_same_bits(monkeypatch, graph):
    def refuse(*args, **kwargs):
        raise AssertionError("recorder code ran with no recorder installed")

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "Event", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(trace.DeviceSpans, "span", refuse)
        m.setattr(trace.DeviceSpans, "count", refuse)
        m.setattr(collectives, "count", refuse)   # the exchange's counters and their ops
        m.setattr(merge, "count", refuse)         # the merge's
        m.setattr(walks, "count", refuse)         # the walk's row bytes
        plain = (generate(CFG, device="cpu"), walk(graph, 8.0))
    assert trace.take_device_spans() is None
    spanned, got = recorded(lambda: (generate(CFG, device="cpu"), walk(graph, 8.0)))
    assert got["spans"] and got["counters"]
    a, b = leaves(plain), leaves(spanned)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("variant", ["paper", "recompute"])
def test_redistribute_spans_in_order_with_their_parent(variant):
    def run():
        with trace.device_span("outer", "cpu"):
            return generate(CFG, shuffle_variant=variant, device="cpu")

    _, got = recorded(run)
    assert [(name, parent) for name, parent, _ in got["spans"]] == \
        [("outer", None)] + [(name, "outer") for name, _ in REDISTRIBUTE_SPANS]
    ms = {name: t for name, _, t in got["spans"]}
    assert all(t >= 0 for t in ms.values())
    assert sum(ms[name] for name, _ in REDISTRIBUTE_SPANS) <= ms["outer"]


def test_each_hop_is_an_exchange_then_an_advance(graph):
    _, got = recorded(lambda: walk(graph, 8.0))
    assert [(name, parent) for name, parent, _ in got["spans"]] == \
        [("walks.exchange", None), ("walks.advance", None)] * LENGTH


@pytest.mark.parametrize("factor", [2.0, 1.0])
def test_redistribute_counters_closed_forms(factor):
    cfg = GraphConfig(scale=SCALE, edge_factor=16, nb=NB, seed=SEED, capacity_factor=factor)
    res, got = recorded(lambda: generate(cfg, device="cpu"))
    dropped = int(res.dropped_redistribute)
    assert (dropped > 0) == (factor == 1.0)
    c = {k.split("/")[1]: v for k, v in got["counters"].items()
         if k.startswith("redistribute.exchange/")}
    assert c == {"rows": cfg.m, "live": cfg.m, "kept": cfg.m - dropped,
                 "slots": NB * NB * default_capacity(cfg)}
    assert set(got["counters"]) == {f"redistribute.exchange/{k}" for k in c} | \
        {"redistribute.merge/live", "redistribute.merge/kernel"}


@pytest.mark.parametrize("nb,factor", [(1, 2.0), (2, 1.0), (4, 2.0), (4, 1.0)])
def test_merge_counters_live_and_kernel(nb, factor):
    """Under the merge span: the live records merged (every edge kept by the
    exchange) and those the kernel merged, none on the CPU's plain path."""
    cfg = GraphConfig(scale=SCALE, edge_factor=16, nb=nb, seed=SEED, capacity_factor=factor)
    res, got = recorded(lambda: generate(cfg, device="cpu"))
    c = got["counters"]
    assert c["redistribute.merge/live"] == cfg.m - int(res.dropped_redistribute) == \
        int(res.owned.valid.sum()) == c["redistribute.exchange/kept"]
    assert c["redistribute.merge/kernel"] == 0


@pytest.mark.parametrize("factor", [8.0, 1.0])
def test_walk_counters_closed_forms(graph, factor):
    out, got = recorded(lambda: walk(graph, factor))
    dropped = int(out[3])
    cp = -(-int(W * factor) // NB)
    cap = cp * NB
    c = got["counters"]
    assert c["walks.exchange/rows"] == LENGTH * NB * cap
    assert c["walks.exchange/slots"] == LENGTH * NB * NB * cp
    assert c["walks.exchange/kept"] == c["walks.exchange/live"] - dropped
    # only the walker's state crosses the exchange, never its history
    assert c["walks.exchange/row_bytes"] == c["walks.exchange/rows"] * STATE_BYTES
    assert c["walks.exchange/row_bytes"] <= 16 * c["walks.exchange/rows"]
    if factor == 8.0:
        assert dropped == 0 and c["walks.exchange/live"] == LENGTH * NB * W
    else:
        assert 0 < dropped and c["walks.exchange/live"] < LENGTH * NB * W


def test_a_count_outside_any_span_is_not_made():
    """The exchange counts only under a span (the MoE dispatch runs none)."""
    data = torch.arange(2 * 8, dtype=torch.int32).reshape(2, 8)
    dest = (data % 2).to(torch.int64)
    _, got = recorded(lambda: capacity_all_to_all(data, dest, capacity=8))
    assert got == {"spans": [], "counters": {}}
    assert not trace.counting()


def profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_a_profiled_window_records_without_an_install():
    names = profiled(lambda: generate(CFG, device="cpu"))
    assert {name for name, _ in REDISTRIBUTE_SPANS} <= names    # host ranges in the profile
    generate(CFG, device="cpu")                                 # after the window: not recorded
    got = trace.take_device_spans()
    assert [(name, parent) for name, parent, _ in got["spans"]] == REDISTRIBUTE_SPANS
    assert trace.take_device_spans() is None


def test_a_profiled_window_holds_its_own_spans_only(graph):
    profiled(lambda: generate(CFG, device="cpu"))               # never taken
    walk(graph, 8.0)                                            # a site outside every window
    profiled(lambda: walk(graph, 8.0))
    got = trace.take_device_spans()
    assert [(name, parent) for name, parent, _ in got["spans"]] == \
        [("walks.exchange", None), ("walks.advance", None)] * LENGTH
    assert set(got["counters"]) == {f"walks.exchange/{k}" for k in
                                    ("rows", "live", "kept", "slots", "row_bytes")}


class FakeEvent:
    """A timing event of a card that is not there: the host clock at record."""

    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t, self.stream = None, None
        FakeEvent.made.append(self)

    def record(self, stream=None):
        self.t, self.stream = time.perf_counter(), stream

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_span_is_timed_on_the_clock_of_its_device(monkeypatch, device):
    """CPU work is timed by perf_counter even where a card is present; work
    on a card by events on its current stream, resolved after one sync."""
    synced = []
    FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: ("stream", d))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d: synced.append(d))

    def run():
        with trace.device_span("work", device):
            time.sleep(0.01)

    _, got = recorded(run)
    [(name, parent, ms)] = got["spans"]
    assert (name, parent) == ("work", None) and ms >= 10.0
    if device == "cpu":
        assert FakeEvent.made == [] and synced == []
    else:
        cuda = torch.device("cuda")
        assert [e.stream for e in FakeEvent.made] == [("stream", cuda)] * 2
        assert synced == [cuda]
