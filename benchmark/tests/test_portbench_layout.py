"""Every cell, configuration, traffic mix, driver, limit and per-layer
metric of BENCHMARK.json is found by name from its files, and the file
keeps to the contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_and_lines():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))


def test_every_config_is_used_and_its_file_is_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/configs/")
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert conf["source"].startswith("https://")


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_found_by_name(name):
    cell = harness.find_cell(name, SPEC)
    assert cell.chips == 1
    driver = harness.driver_class(cell)
    for method in ("setup", "window", "traced", "release", "check", "control"):
        assert callable(getattr(driver, method))
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in reported
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_every_metric_has_its_cells():
    cells = set(CELLS)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_files_under_paths_are_named_from_name_characters():
    for path in (harness.HERE).rglob("*"):
        if "__pycache__" in path.parts or "traces" in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
