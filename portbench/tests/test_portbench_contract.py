"""`BENCHMARK.json` against the rules the harness is built to: every entry
resolves to its files by name, names and units use the allowed characters,
each metric is reported where its end-to-end metric is, nothing under
`portbench/` imports JAX or the JAX package or reads `benchmarks/`, and a
run without a card exits with an error and prints no result."""

import ast
import json
import re
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
PY_FILES = sorted(p for p in harness.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def one_line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_sizes():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert len(json.dumps(BENCH)) <= 64 << 10
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert BENCH["command"][1].startswith("portbench/")
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its day: 2 + 14 x cells runs of rs + 60 s,
    # 2 x 90 s of compiling a cell, 1200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    assert c.entry["chips"] in (1, 4) and one_line(c.entry["why"])
    assert harness.config_file(c.entry["config"]).is_file()
    assert harness.traffic_file(c.entry["traffic"]).is_file()
    for fn in ("setup", "call", "check", "control", "sizes"):
        assert callable(getattr(c.loop, fn)), fn
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_resolves_to_its_reader(metric):
    mod = harness.load_module(harness.metric_file(metric))
    assert callable(mod.read)


def graph_problems(body: dict, entry: dict) -> list:
    """What a configuration file lacks to state its own graph, its program
    and its control; empty where it is sound.  No number is pinned: any
    R-MAT graph the program can generate is a configuration."""
    problems = []
    if body.get("source") != entry["source"] or body.get("reduced") != entry["reduced"]:
        problems.append("source or reduced differ from BENCHMARK.json")
    g = body.get("graph", {})
    if not all(isinstance(g.get(k), int) and g[k] > 0 for k in ("scale", "edge_factor", "nb")):
        problems.append("scale, edge_factor and nb must be positive integers")
    elif g["nb"] & (g["nb"] - 1) or g["nb"] > 1 << g["scale"]:
        problems.append("nb must be a power of two up to 2**scale")
    abcd = [g.get(k) for k in "abcd"]
    if not all(isinstance(p, float) and 0 < p < 1 for p in abcd):
        problems.append("a, b, c, d must lie in (0, 1)")
    elif abs(sum(abcd) - 1) > 1e-9:
        problems.append("a + b + c + d must be 1")
    if not set(("shuffle_variant", "feistel_rounds", "capacity_factor")) <= set(body.get("program", {})):
        problems.append("program settings missing")
    control = body.get("control", {})
    if not isinstance(control.get("reference"), dict) or not control["reference"] \
            or not one_line(control.get("about")):
        problems.append("control needs its reference fields and an about")
    if not body.get("guarantees"):
        problems.append("no guarantees stated")
    return problems


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves_and_states_its_graph(config):
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    body = harness.load_json(harness.config_file(config["name"]))
    assert one_line(config["source"]) and one_line(config["why"]) and len(config["reduced"]) <= 16
    assert graph_problems(body, config) == []
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


SKEWED = {"graph": {"a": 0.45, "b": 0.15, "c": 0.15, "d": 0.25},
          "control": {"reference": {"a": 0.5, "d": 0.2},
                      "about": "the R-MAT quadrants at A .5 and D .2, not the skew stated"}}


def test_a_new_configuration_is_data_only():
    """A skewed R-MAT graph (Chakrabarti et al., SDM 2004) with a control of
    its own passes the same checks and runs through the same loop, correct,
    with its control failing: a configuration is a file, nothing edited."""
    config = BENCH["configs"][0]
    body = harness.merged(harness.load_json(harness.config_file(config["name"])), SKEWED)
    assert graph_problems(body, config) == []
    assert graph_problems(harness.merged(body, {"graph": {"d": 0.3}}), config)
    small = {"config": harness.merged(SKEWED, {"graph": {"scale": 10, "nb": 4}})}
    cell = harness.load_cell(CELLS[0], small)
    line, checks = harness.run(cell, seed=2**31 + 77, seconds=0, trace=False, device="cpu",
                               started=time.perf_counter())
    assert line["correct"], checks
    numbers = cell.loop.control(harness.Context(cell, torch.device("cpu"), 5, trace=False), 5)
    assert any(n["value"] > n["limit"] for n in numbers.values()), numbers


def test_names_units_and_sources():
    named = BENCH["configs"] + BENCH["workloads"] + METRICS
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        for cell in m.get("workloads", []):
            assert cell in CELLS


def test_end_to_end_bounds():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_entries():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert one_line(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        assert m["workloads"], m["name"]      # a per-layer metric names its cells
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert harness.reports(moved, cell), (m["name"], cell)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_and_no_old_benchmark(path):
    for name in _imports(path):
        assert name.split(".")[0] not in harness.FORBIDDEN, f"{path} imports {name}"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not re.search(r"(^|[/'\"])benchmarks(/|$)", node.value), path


def test_forbidden_names_compare_whole_top_level(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike.core", types.ModuleType("x"))
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert {"repro.core", "jax"} <= set(harness.forbidden_modules())


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the refusal without one")
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", CELLS[0], "--seed",
         str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_derive_is_a_function_of_the_seed():
    big = 2**31 + 12345
    assert harness.derive(big, "graph", 3) == harness.derive(big, "graph", 3)
    assert harness.derive(big, "graph", 3) != harness.derive(big, "graph", 4)
    assert 0 <= harness.derive(2**40, "walk") < 2**32
