"""The reader of `walks_exchange_row_bytes` on the CPU: its closed form on
planted counters, None where the program kept no "row_bytes" counter (a
checkout whose walk does not count it), and the narrow state's width, a
walker's position and id, from the walks cell's traced walk at a small
size."""

import pytest

from portbench.tests.test_portbench_spans import cell_window, read, window
from repro_torch.core import trace

METRIC = "walks_exchange_row_bytes"
STATE_BYTES = 8          # position and walker id, int32 each


@pytest.fixture(autouse=True)
def no_recorder_left():
    trace.take_device_spans()
    yield
    trace.take_device_spans()


@pytest.mark.parametrize("row_bytes,rows,width", [(1536, 192, 8.0), (336 * 64, 64, 336.0),
                                                  (0, 8, 0.0)])
def test_reads_row_bytes_over_rows(row_bytes, rows, width):
    counters = {"walks.exchange/row_bytes": row_bytes, "walks.exchange/rows": rows,
                "walks.exchange/live": rows // 8}
    assert read(METRIC, window(kept={"spans": [], "counters": counters})) == pytest.approx(width)


@pytest.mark.parametrize("counters", [{}, {"walks.exchange/rows": 192, "walks.exchange/live": 24},
                                      {"walks.exchange/row_bytes": 1536},
                                      {"walks.exchange/row_bytes": 0, "walks.exchange/rows": 0}])
def test_reads_none_without_the_row_bytes_counter(counters):
    assert read(METRIC, window(kept={"spans": [], "counters": counters})) is None
    assert read(METRIC, window(kept=None)) is None


def test_walks_cell_reads_the_narrow_state():
    c, _, w = cell_window("graph500-s26-nb8.walks")
    assert METRIC in {m["name"] for m in c.per_layer}
    assert read(METRIC, w) == STATE_BYTES <= 16
