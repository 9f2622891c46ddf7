"""The harness on the card at a small size: a traced run of each cell is
correct and reads its per-layer metrics, with every share within 100 %,
and the control fails.  Marked `gpu`: they skip where
torch.cuda.is_available() is false.  Run on a machine with a card as

    PYTHONPATH=src python -m pytest -q -m gpu portbench/tests/test_portbench_gpu.py
"""

import time

import pytest
import torch

from portbench import harness

SMALL = {"config": {"graph": {"scale": 16, "nb": 8}},
         "traffic": {"walkers_per_shard": 4096, "length": 8}}
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_the_card(cuda, cell):
    c = harness.load_cell(cell, SMALL)
    line, checks = harness.run(c, seed=2**31 + 41, seconds=0.5, trace=True, device=cuda,
                               started=time.perf_counter())
    assert line["correct"], checks
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert set(line["metrics"]) == {m["name"] for m in c.per_layer}
    for name, m in line["metrics"].items():
        if harness.is_share(name):
            assert 0 < m["value"] <= 100, (name, m)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_is_not_correct(cuda, cell):
    c = harness.load_cell(cell, SMALL)
    numbers = c.loop.control(harness.Context(c, cuda, 5, trace=False), 5)
    assert any(n["value"] > n["limit"] for n in numbers.values()), numbers
