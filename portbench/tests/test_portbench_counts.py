"""The yardstick's arithmetic on the CPU: the bytes and operations each
roofline and `mfu` share is held to at the three cells' sizes, the readers
on a window whose times are planted, the refusal of a share over 100 %,
and the reduction of a profiler trace (busy time, idle gaps)."""

from types import SimpleNamespace

import pytest

from portbench import devtrace, harness
from portbench.metrics import _counts as C

PEAKS = harness.load_json(harness.HERE / "peaks.json")
N, M, NB, W, L = 1 << 26, 1 << 30, 8, 1 << 23, 80


def sizes_of(cell):
    c = harness.load_cell(cell)
    return c.loop.sizes(SimpleNamespace(config=c.config, traffic=c.traffic))


GEN = sizes_of("graph500-s26-nb8.generate")
WALK = sizes_of("graph500-s26-nb8.walks")
REC = sizes_of("graph500-s26-nb8-recompute.generate")


def test_sizes_of_the_cells():
    for s in (GEN, WALK, REC):
        assert (s["n"], s["m"], s["nb"], s["scale"]) == (N, M, NB, 26)
    assert GEN["permutation"] == "paper" and GEN["shuffle_rounds"] == 9
    assert REC["permutation"] == "feistel" and REC["feistel_rounds"] == 4
    assert (WALK["walkers"], WALK["length"]) == (W, L)


def test_operation_constants():
    assert (C.MIX32, C.UNIFORM, C.RMAT_LEVEL, C.FEISTEL_ROUND) == \
        ((3, 2, 3), (6, 4, 7), (15, 8, 16), (5, 2, 3))
    assert C.RMAT_LEVEL.total == 39 and C.FEISTEL_ENDS.total == 3


@pytest.mark.parametrize("fn,sizes,nbytes,ops", [
    (C.rmat_edges, GEN, 8 * M, (15 * 26 * M, 8 * 26 * M, 16 * 26 * M)),
    (C.relabel_gather, GEN, 2 * (8 * M + 4 * N), (4 * M, 0, 2 * M)),
    (C.feistel_perm, REC, 8 * (N + 2 * M), (21 * (N + 2 * M), 8 * (N + 2 * M), 14 * (N + 2 * M))),
    (C.bucket_hist_generate, GEN, 4 * M + 4 * 64, (M, 0, M)),
    (C.bucket_hist_walks, WALK, 4 * W * L + 4 * 64 * L, (W * L, 0, W * L)),
    (C.generate_returned, GEN, 8 * N + 21 * M + 64, (0, 0, 0)),
    (C.walks_least, WALK, W * (4 * 81 + 5) + W * L * 12, (0, 0, 0)),
])
def test_counts_at_the_cells_sizes(fn, sizes, nbytes, ops):
    assert fn(sizes) == (nbytes, ops)


@pytest.mark.parametrize("ops,clocks", [
    (C.Ops(100, 0, 0), 100),       # all on the ALU pipe
    (C.Ops(0, 100, 0), 100),       # all multiplies
    (C.Ops(0, 0, 100), 50),        # split over both pipes: the issue rate
    (C.Ops(30, 30, 40), 50),
    (C.Ops(60, 10, 10), 60),
])
def test_least_clocks_by_pipe(ops, clocks):
    pipe = PEAKS["int32_ops_per_s_per_pipe"]
    assert C.least_seconds((0, ops), PEAKS) == pytest.approx(clocks / pipe)


def test_least_time_takes_the_larger_bound():
    # R-MAT is bound by the issue rate of both pipes, the gather and the permutation by bytes
    pipe = PEAKS["int32_ops_per_s_per_pipe"]
    assert C.least_seconds(C.rmat_edges(GEN), PEAKS) == pytest.approx(39 / 2 * 26 * M / pipe)
    assert C.least_seconds(C.relabel_gather(GEN), PEAKS) == pytest.approx(
        2 * (8 * M + 4 * N) / 3.35e12)
    assert C.least_seconds(C.feistel_perm(REC), PEAKS) == pytest.approx(8 * (N + 2 * M) / 3.35e12)
    assert pipe == pytest.approx(PEAKS["sms"] * PEAKS["int32_lanes_per_sm"] * PEAKS["sm_clock_hz"])
    assert PEAKS["int32_lanes_per_sm"] == 64


def window(sizes, kernels=None, call_ms=(), calls=1):
    dev = None if kernels is None else devtrace.DeviceTrace(1.0, 1.0, kernels, {})
    return harness.Window(calls=calls, seconds=1.0, work={}, memory_peak_bytes=0,
                          setup_s=1.0, sizes=sizes, peaks=PEAKS, phase_ms={},
                          call_ms=list(call_ms), device=dev)


def read(metric, w):
    return harness.load_module(harness.metric_file(metric)).read(w)


def test_roofline_reader_on_planted_times():
    least = C.least_seconds(C.rmat_edges(GEN), PEAKS)
    w = window(GEN, {"void rmat_edges_kernel<26>(int*, int*)": (4 * least, 8)}, calls=2)
    assert read("rmat_edges_roofline", w) == pytest.approx(50.0)
    assert read("feistel_perm_roofline", w) is None        # nothing to read: no launch
    assert read("rmat_edges_roofline", window(GEN)) is None


def test_mfu_reader_on_planted_times():
    least = C.least_seconds(C.generate_returned(GEN), PEAKS)
    w = window(GEN, call_ms=[1e3 * least * 200, 1e3 * least * 200], calls=2)
    assert read("generate_mfu", w) == pytest.approx(0.5)
    assert read("generate_mfu", window(GEN)) is None


def test_a_share_over_100_percent_is_refused():
    # a planted count above the measured work: the kernel "ran" in half the least time
    least = C.least_seconds(C.relabel_gather(GEN), PEAKS)
    w = window(GEN, {"relabel_gather_kernel<false>": (least / 2, 2)})
    value = read("relabel_gather_roofline", w)
    assert value == pytest.approx(200.0)
    with pytest.raises(ValueError, match="more work counted"):
        harness.checked_share("relabel_gather_roofline", value)
    assert harness.checked_share("relabel_gather_roofline", 99.5) == 99.5
    assert harness.checked_share("relabel_ms", 250.0) == 250.0     # not a share


def test_busy_time_and_idle_gaps():
    assert devtrace.union([(5, 9), (0, 2), (1, 3), (8, 10)]) == [(0, 3), (5, 10)]
    host = [(0, 100, "step"), (10, 40, "aten::sort"), (12, 20, "cudaLaunchKernel"),
            (50, 90, "aten::item"), (60, 80, "cudaStreamSynchronize")]
    gaps = [(14, 16), (30, 36), (45, 47), (70, 74), (120, 130)]
    got = devtrace.attribute_gaps(gaps, host)
    assert got == pytest.approx({"cudaLaunchKernel": 2e-9, "aten::sort": 6e-9, "step": 2e-9,
                                 "cudaStreamSynchronize": 4e-9, "host": 10e-9})


def test_phase_times_from_marks():
    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    marks = [("call", Ev(0)), ("shuffle", Ev(3)), ("edges", Ev(4)), ("end", Ev(6)),
             ("call", Ev(10)), ("shuffle", Ev(12)), ("edges", Ev(15)), ("end", Ev(15))]
    phases, calls = harness.phase_times(marks)
    assert phases == {"shuffle": [3, 2], "edges": [1, 3]}
    assert calls == [6, 5]
