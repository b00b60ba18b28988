"""BENCHMARK.json against the contract, every file the harness finds by
name, and the imports of the benchmark's modules."""

from __future__ import annotations

import ast
import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
BENCH = ROOT / "bench"


def test_top_level_keys_and_command(bench_json):
    assert set(bench_json) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench_json["command"] == ["python3", "bench/run.py"]
    assert bench_json["paths"] == ["bench"]
    assert isinstance(bench_json["run_seconds"], int) and 1 <= bench_json["run_seconds"] <= 51


def test_end_to_end_metrics(bench_json):
    e2e = {m["name"]: m for m in bench_json["end_to_end"]}
    assert set(e2e) == {"round_s.lm", "round_s.vision", "peak_mem_gb", "setup_s"}
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]


def test_names_and_entries(bench_json):
    cells = {w["name"] for w in bench_json["workloads"]}
    configs = {c["name"]: c for c in bench_json["configs"]}
    names = [*cells, *configs, *(m["name"] for m in bench_json["end_to_end"] + bench_json["per_layer"])]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for w in bench_json["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["config"] in configs and NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and all(NAME.match(k) for k in c["reduced"])


def test_per_layer_metrics_name_their_cells(bench_json):
    from bench import harness

    cells = {w["name"] for w in bench_json["workloads"]}
    e2e = {m["name"]: m for m in bench_json["end_to_end"]}
    for m in bench_json["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert harness.quantity(m["moves"]) == "round_s" and set(m["workloads"]) <= cells and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))  # each cell reports what it moves
        assert m["unit"] == "%" or not harness.quantity(m["name"]).endswith("_roofline")
    for cell in cells:
        assert any("mfu" in m["name"] and cell in m["workloads"] for m in bench_json["per_layer"])


@pytest.mark.parametrize("cell", ["qwen2-1.5b-m4.probit", "resnet18w64-m100.probit"])
def test_every_cell_loads_by_name(cell):
    from bench import harness

    spec = harness.load_cell(cell, ROOT)
    numbers = harness.system(spec.config["kind"]).NUMBERS
    assert set(spec.limits) == set(numbers) and all(v > 0 for v in spec.limits.values())
    assert {m["name"] for m in spec.end_to_end} == {f"round_s.{spec.config['kind']}", "peak_mem_gb", "setup_s"}


def test_every_config_file_matches_its_entry(bench_json):
    for c in bench_json["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (BENCH / "systems" / f"{cfg['kind']}.py").exists()


def test_every_per_layer_metric_has_a_reader(bench_json):
    from bench import harness

    for m in bench_json["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "contextlib", "math", "numpy", "torch"}, tops
