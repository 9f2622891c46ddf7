"""The general driver of the benchmark: one cell, one run.

Everything is found by name.  `BENCHMARK.json` lists the cells and the
metrics; a cell names a configuration (`configs/<config>.json`) and a
traffic mix (`traffic/<traffic>.json`); the traffic mix names the loop that
drives the program (`loops/<loop>.py`); each metric is read by
`metrics/<metric>.py`.  Adding a cell, a configuration, a mix or a metric
adds files and entries and edits none.

A run: the loop's set-up (program state built from the seed, every shape of
the cell warmed up), then a closed loop of calls with one caller until
`seconds` have passed on the host's clock, then the comparison of the last
call's output with the plain reference, then the metrics.  With `trace` the
window runs under `torch.profiler` and the loop's phase marks are timed
with CUDA events; the metrics are then the cell's per-layer ones.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import torch

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")    # whole top-level module names
MASK32 = 0xFFFFFFFF

_MODULES: Dict[Path, ModuleType] = {}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def config_file(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def loop_file(name: str) -> Path:
    return HERE / "loops" / f"{name}.py"


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def load_module(path: Path) -> ModuleType:
    """The module in `path` (names may hold dots, so it is loaded by path)."""
    mod = _MODULES.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no such file: {path}")
        name = "portbench._by_name." + path.stem.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def derive(seed: int, *parts) -> int:
    """A uint32 drawn from (seed, parts): the seeds of graphs and walks."""
    digest = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(digest[:4], "little") & MASK32


def reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric`: the cells its `workloads` lists, or
    every cell where it lists none (an end-to-end metric of all cells)."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    loop: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]


def merged(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for key, value in (over or {}).items():
        out[key] = merged(out[key], value) if isinstance(value, dict) else value
    return out


def load_cell(name: str, overrides: Optional[dict] = None) -> Cell:
    """The cell `name` with its files.  `overrides` ({"config": {...},
    "traffic": {...}}) replaces values of the two files: the tests' small
    sizes; a run of the benchmark passes none."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    over = overrides or {}
    config = merged(load_json(config_file(entry["config"])), over.get("config"))
    traffic = merged(load_json(traffic_file(entry["traffic"])), over.get("traffic"))
    return Cell(name, entry, config, traffic, load_module(loop_file(traffic["loop"])),
                [m for m in bench["end_to_end"] if reports(m, name)],
                [m for m in bench["per_layer"] if reports(m, name)])


class Context:
    """What a loop gets: the cell's files, the device, the run's seed, and
    `mark(label)`, which in a traced run records a CUDA event (a phase's
    end) and otherwise does nothing."""

    def __init__(self, cell: Cell, device: torch.device, seed: int, trace: bool):
        self.cell, self.device, self.seed, self.trace = cell, device, seed, trace
        self.config, self.traffic = cell.config, cell.traffic
        self.marks: List[Tuple[str, object]] = []

    def mark(self, label: str) -> None:
        if self.trace and self.device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((label, event))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Window:
    """What the metric readers read."""

    calls: int
    seconds: float                      # host clock, first call to the last one's end
    work: Dict[str, float]              # totals over the calls, by unit
    memory_peak_bytes: int
    setup_s: float
    sizes: dict
    peaks: dict
    phase_ms: Dict[str, List[float]]    # per phase, one entry per call (traced runs)
    call_ms: List[float]                # CUDA-event time of each call (traced runs)
    device: Optional[object] = None     # devtrace.DeviceTrace (traced runs on the card)


def is_share(name: str) -> bool:
    """A roofline's or a peak's share: it cannot pass 100 %."""
    return name.split(".")[0].endswith("_roofline") or "mfu" in name


def checked_share(name: str, value: float) -> float:
    """`value`, refused where it is a share over 100 %: its work is then
    counted above what the card can do in the time measured, or the time
    leaves part of the work out."""
    if is_share(name) and value > 100.0:
        raise ValueError(f"{name} reads {value:.3f} %: more work counted than the time allows")
    return value


def phase_times(marks) -> Tuple[Dict[str, List[float]], List[float]]:
    """Per-phase and per-call ms from the marks of the window: each call
    opens with "call" and closes with "end"; a mark between them ends the
    phase of its name."""
    phases: Dict[str, List[float]] = {}
    calls: List[float] = []
    opened = prev = None
    for label, event in marks:
        if label == "call":
            opened = prev = event
            continue
        if label == "end":
            calls.append(opened.elapsed_time(event))
        else:
            phases.setdefault(label, []).append(prev.elapsed_time(event))
        prev = event
    return phases, calls


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device, started: float,
        log: Callable[[str], None] = lambda s: None) -> Tuple[dict, Dict[str, dict]]:
    """One run of `cell` on `device`: the result line and the numbers
    compared, each with its limit."""
    from . import devtrace

    dev = torch.device(device)
    ctx = Context(cell, dev, seed, trace)
    loop = cell.loop
    t_setup = time.perf_counter()
    state = loop.setup(ctx)
    ctx.sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - started
    log(f"set-up {setup_s:.3f} s (start to the loop's set-up {t_setup - started:.3f} s)")

    calls, failed, work, ends = 0, 0, {}, []
    profiler = devtrace.start() if trace and dev.type == "cuda" else None
    t0 = time.perf_counter()
    while True:
        result = None                                 # the previous output goes first
        ctx.mark("call")
        result, done, bad = loop.call(ctx, state, calls)
        ctx.mark("end")
        ctx.sync()
        ends.append(time.perf_counter())
        calls += 1
        failed += int(bad)
        for unit, amount in done.items():
            work[unit] = work.get(unit, 0) + amount
        if ends[-1] - t0 >= seconds:
            break
    elapsed = ends[-1] - t0
    dtrace = None
    if profiler is not None:
        dtrace = devtrace.stop(profiler)
        log(f"trace read in {time.perf_counter() - ends[-1]:.3f} s")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    phases, call_ms = phase_times(ctx.marks)
    ctx.marks.clear()
    walls = [b - a for a, b in zip([t0] + ends, ends)]
    log(f"window {elapsed:.3f} s, {calls} calls; host s a call: first {walls[0]:.4f}, "
        f"min {min(walls):.4f}, max {max(walls):.4f}")

    t_check = time.perf_counter()
    checks = loop.check(ctx, state, result)
    del result
    log(f"check {time.perf_counter() - t_check:.3f} s")
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    window = Window(calls, elapsed, work, peak, setup_s, loop.sizes(ctx),
                    load_json(HERE / "peaks.json"), phases, call_ms, dtrace)
    chosen = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in chosen:
        value = load_module(metric_file(m["name"])).read(window)
        if value is not None:
            metrics[m["name"]] = {"value": checked_share(m["name"], value), "unit": m["unit"]}
    line = {"correct": correct, "attempted": calls, "failed": failed, "metrics": metrics,
            "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                       "count": cell.entry["chips"], "memory_peak_bytes": peak}}
    if dtrace is not None:
        line["device"].update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        line["breakdown"] = dtrace.breakdown
    line["checks"] = checks
    return line, checks
