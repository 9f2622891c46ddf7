"""A run of each cell on the CPU at a small size, past the harness's look for
a card: sound, `correct` comes out true; with the timed path broken
underneath it comes out false, once for each fault the cell can have (a
step that returns its state unchanged, half of the work left out, the
exchange between shards left out, an answer altered where it is made);
and the control (the reference in the program's place with one guarantee
broken) fails at least one number."""

import importlib
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from repro_torch.distributed import collectives

# by module path: the packages re-export functions of the same names
pipeline = importlib.import_module("repro_torch.core.pipeline")
redistribute = importlib.import_module("repro_torch.core.redistribute")
walks = importlib.import_module("repro_torch.data.walks")

SMALL = {"config": {"graph": {"scale": 10, "nb": 4}},
         "traffic": {"walkers_per_shard": 64, "length": 6}}
GENERATE = ["graph500-s26-nb8.generate", "graph500-s26-nb8-recompute.generate"]
WALKS = ["graph500-s26-nb8.walks"]


def run_small(cell, seed=2**31 + 101):
    line, checks = harness.run(harness.load_cell(cell, SMALL), seed=seed, seconds=0, trace=False,
                               device="cpu", started=time.perf_counter())
    return line, checks


@pytest.mark.parametrize("cell", GENERATE + WALKS)
def test_sound_run_is_correct(cell):
    line, checks = run_small(cell)
    assert line["correct"] and line["attempted"] == 1 and line["failed"] == 0
    assert set(c["value"] for c in checks.values()) == {0}
    assert list(line)[-1] == "checks"
    names = {m["name"] for m in harness.load_cell(cell).end_to_end}
    assert set(line["metrics"]) == names - {"peak_gib"}        # no device memory on the CPU
    assert line["metrics"]["setup_s"]["value"] > 0


def no_exchange(data, dest, *, capacity, valid=None):
    """capacity_all_to_all with the exchange left out: every sender keeps its
    own buckets."""
    ex = collectives.capacity_all_to_all(data, dest, capacity=capacity, valid=valid)
    return ex._replace(data=ex.data.transpose(0, 1).contiguous(),
                       valid=ex.valid.transpose(0, 1).contiguous())


def plant_generate(monkeypatch, fault):
    if fault == "state_unchanged":          # relabel hands the edges back as they came
        monkeypatch.setattr(pipeline, "relabel_ring", lambda cfg, s, d, pv: (s, d))
        monkeypatch.setattr(pipeline, "relabel_recompute", lambda cfg, s, d: (s, d))
    elif fault == "half_left_out":          # redistribute sees half of each shard's edges
        real = pipeline.redistribute_sorted

        def half(cfg, src, dst, capacity=0):
            n = src.shape[1] // 2
            return real(cfg, src[:, :n].contiguous(), dst[:, :n].contiguous(), capacity)
        monkeypatch.setattr(pipeline, "redistribute_sorted", half)
    elif fault == "no_exchange":
        monkeypatch.setattr(redistribute, "capacity_all_to_all", no_exchange)
    elif fault == "answer_altered":         # one edge's destination changed where made
        real = pipeline.rmat_edge_block

        def altered(cfg, start, count, device="cuda"):
            src, dst = real(cfg, start, count, device)
            if start == 0:
                dst[0] ^= 1
            return src, dst
        monkeypatch.setattr(pipeline, "rmat_edge_block", altered)


def plant_walks(monkeypatch, fault):
    real = walks.distributed_walks
    if fault == "no_exchange":
        monkeypatch.setattr(walks, "capacity_all_to_all", no_exchange)
        return

    def broken(*args, **kw):
        hist, valid, wid, dropped = real(*args, **kw)
        if fault == "state_unchanged":      # no hop moves a walker
            hist[:, 1:] = hist[:, :1]
        elif fault == "half_left_out":      # every other row's walker lost
            valid = valid.clone()
            valid[::2] = False
        elif fault == "answer_altered":     # one hop of one walker changed
            hist[int(valid.nonzero()[0]), 1] += 1
        return hist, valid, wid, dropped
    monkeypatch.setattr(walks, "distributed_walks", broken)


FAULTS = ["state_unchanged", "half_left_out", "no_exchange", "answer_altered"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", GENERATE + WALKS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    (plant_walks if cell in WALKS else plant_generate)(monkeypatch, fault)
    line, checks = run_small(cell)
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("seed", [7, 2**31 + 9, 4_000_000_001])
@pytest.mark.parametrize("cell", GENERATE + WALKS)
def test_the_control_is_not_correct(cell, seed):
    c = harness.load_cell(cell, SMALL)
    ctx = harness.Context(c, torch.device("cpu"), seed, trace=False)
    numbers = c.loop.control(ctx, seed)
    assert any(n["value"] > n["limit"] for n in numbers.values()), numbers


def test_the_control_script_reads_program_and_control():
    from portbench.control import readings

    c = harness.load_cell(GENERATE[0], SMALL)
    out = readings(c, 3, torch.device("cpu"), program=True)
    assert set(out["program"].values()) == {0}
    assert out["control"]["adjv"] > 0 and out["control"]["pv"] == 0


def test_sizes_need_no_device():
    c = harness.load_cell(WALKS[0], SMALL)
    s = c.loop.sizes(SimpleNamespace(config=c.config, traffic=c.traffic))
    assert (s["n"], s["walkers"], s["length"]) == (1 << 10, 256, 6)
