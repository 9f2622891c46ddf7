"""The reader of `redistribute_merge_kernel_share` on the CPU: its closed
form on planted counters, None where the program kept none (a checkout
without the merge's counters), and 0 in both generate cells at a small
size, whose merge runs the plain version on the CPU."""

import pytest

from portbench.tests.test_portbench_spans import cell_window, read, window
from repro_torch.core import trace

METRIC = "redistribute_merge_kernel_share"


@pytest.fixture(autouse=True)
def no_recorder_left():
    trace.take_device_spans()
    yield
    trace.take_device_spans()


@pytest.mark.parametrize("kernel,live,share", [(8, 8, 100.0), (0, 8, 0.0), (3, 12, 25.0)])
def test_reads_kernel_over_live(kernel, live, share):
    counters = {"redistribute.merge/kernel": kernel, "redistribute.merge/live": live,
                "redistribute.exchange/kept": live}
    assert read(METRIC, window(kept={"spans": [], "counters": counters})) == pytest.approx(share)


@pytest.mark.parametrize("counters", [{}, {"redistribute.exchange/kept": 8},
                                      {"redistribute.merge/kernel": 0},
                                      {"redistribute.merge/live": 0, "redistribute.merge/kernel": 0}])
def test_reads_none_without_the_merge_counters(counters):
    assert read(METRIC, window(kept={"spans": [], "counters": counters})) is None
    assert read(METRIC, window(kept=None)) is None


@pytest.mark.parametrize("cell", ["graph500-s26-nb8.generate",
                                  "graph500-s26-nb8-recompute.generate"])
def test_generate_cells_read_the_plain_path_on_the_cpu(cell):
    c, _, w = cell_window(cell)
    assert METRIC in {m["name"] for m in c.per_layer}
    assert read(METRIC, w) == 0.0
