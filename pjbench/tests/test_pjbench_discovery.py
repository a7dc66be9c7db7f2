"""A cell is found by name: a configuration, a traffic mix and a metric
added to a copy of the benchmark as new files and entries run without a
change to any file already there; and every cell runs end to end on the
CPU, with and without the trace."""

from __future__ import annotations

import json

import pytest

from conftest import (CELL, CELL_X4, LATTICE, SEED, add_lattice_cell,
                      run_tiny)
from pjbench import manifest

NEW_METRIC = '''
def read(run):
    return float(len(run.requests))
'''


def test_added_files_and_entries_are_found_by_name(tiny_root):
    pkg = tiny_root / "pjbench"
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    conf = dict(LATTICE, name="small-lattice", rows=12, cols=9)
    (pkg / "configs" / "small-lattice.json").write_text(json.dumps(conf))
    traffic = json.loads((pkg / "traffic" / "graph500_kernel3.json").read_text())
    traffic.update(sources_per_request=16, source_pool="all")
    (pkg / "traffic" / "table16.json").write_text(json.dumps(traffic))
    (pkg / "metrics" / "requests_done.py").write_text(NEW_METRIC)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "small-lattice", "source": "test",
                             "file": "pjbench/configs/small-lattice.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "small.table16",
                               "config": "small-lattice",
                               "traffic": "table16", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "requests_done", "unit": "requests",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["small.table16"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.cell(tiny_root, "small.table16")
    assert cell.config["rows"] == 12 and cell.traffic["sources_per_request"] == 16
    out = run_tiny(tiny_root, "small.table16")
    assert out["correct"] is True
    assert out["metrics"]["requests_done"]["value"] >= 1
    assert set(out["metrics"]) == {"rows_per_s", "setup_s", "requests_done"}
    # The old cells do not see the new metric, and no file changed.
    assert "requests_done" not in run_tiny(tiny_root, CELL)["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("workload", [CELL, "lattice.table"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_the_cpu(tiny_root, workload, trace):
    if workload == "lattice.table":
        add_lattice_cell(tiny_root)
    out = run_tiny(tiny_root, workload, trace=trace)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert list(out)[-1] == "check"
    assert all(n["value"] == 0 and n["limit"] == 0
               for n in out["check"].values())
    wanted = {m["name"] for m in (manifest.cell(tiny_root, workload).per_layer
                                  if trace else
                                  manifest.cell(tiny_root, workload).end_to_end)}
    # The CPU has no device trace: those readers find nothing to read.
    device_only = {"fanout_sweep_roofline", "device_idle_pct"}
    assert set(out["metrics"]) == wanted - (device_only if trace else set())
    assert out["metrics"] and all(m["value"] >= 0 for m in out["metrics"].values())
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # Potentials are compared where the graph has negative arcs.
    assert ("potentials_differing" in out["check"]) == (
        workload == "lattice.table")
    assert out["check"]["rows_differing"]["value"] == 0


def test_four_rank_cell_on_cpu_ranks(tiny_root, monkeypatch):
    monkeypatch.setenv("PJ_MESH_DEVICES", "cpu*4")
    out = run_tiny(tiny_root, CELL_X4, trace=True)
    assert out["correct"] is True
    assert out["metrics"]["collective_pct"]["value"] > 0


def test_same_seed_same_work(tiny_root):
    from pjbench import harness

    cell = manifest.cell(tiny_root, CELL)
    a = harness.Run(cell, SEED, 1.0, None)
    b = harness.Run(cell, SEED, 1.0, None)
    a.pool = b.pool = __import__("numpy").arange(5000)
    assert (a.sources(3) == b.sources(3)).all()
    assert len(set(a.sources(3).tolist())) == cell.traffic["sources_per_request"]
    assert not (a.sources(3) == a.sources(4)).all()
