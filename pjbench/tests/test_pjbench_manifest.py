"""BENCHMARK.json against its rules: keys, names, units,
bounds, and every named part present as a file."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "pjbench/run.py"]
    assert BENCH["paths"] == ["pjbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"])
    assert conf["file"].startswith("pjbench/")
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    for key in conf["reduced"]:
        assert NAME.match(key)
    assert (ROOT / "pjbench" / "generators" / f"{data['generator']}.py").is_file()
    for text in (conf["source"], conf["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_workload_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads(
        (ROOT / "pjbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "pjbench" / "entries" / f"{traffic['entry']}.py").is_file()
    assert 1 <= len(cell["why"]) <= 200


def test_cells_distinct_and_four_chip_share():
    cells = BENCH["workloads"]
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    four = sum(c["chips"] == 4 for c in cells)
    assert four <= max(1, len(cells) // 4)
    used = {c["config"] for c in cells}
    assert used == {c["name"] for c in BENCH["configs"]}


def _metrics():
    return ([("end_to_end", m) for m in BENCH["end_to_end"]]
            + [("per_layer", m) for m in BENCH["per_layer"]])


@pytest.mark.parametrize("kind,metric", _metrics(),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_metric_entry(kind, metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert (ROOT / "pjbench" / "metrics" / f"{metric['name']}.py").is_file()
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if kind == "end_to_end":
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def test_required_metrics():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert {"rows_per_s", "setup_s"} <= names
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert units["rows_per_s"] == "rows/s" and units["setup_s"] == "s"
    layers = {m["name"]: m["layer"] for m in BENCH["per_layer"]}
    assert {"fanout_sweep_roofline", "device_idle_pct", "upload_pct",
            "download_pct"} <= set(layers)
    for m in BENCH["per_layer"]:
        assert m["moves"] == "rows_per_s"
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
