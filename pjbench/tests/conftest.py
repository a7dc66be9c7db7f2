"""Fixtures of the benchmark's tests: a copy of the benchmark whose
configurations and requests are shrunk to what the CPU holds, and the
``card`` marker for tests that need a CUDA card (they skip without
one)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Each configuration's graph at a size the CPU solves in a blink, with
# the published shapes (initiator, edge factor, weights).
TINY_CONFIG = {"graph500-rmat22": {"scale": 11}}
TINY_SOURCES = 64
SEED = 2**31 + 11
CELL = "rmat22.kernel3"
CELL_X4 = "rmat22.kernel3.x4"

# A lattice with negative arcs (the ``lattice`` generator), for the
# harness's phase-1 path: its potentials are checked too.
LATTICE = {
    "name": "test-lattice", "generator": "lattice", "rows": 24, "cols": 24,
    "weights": {"low": 10, "high": 100}, "negative_fraction": 0.2,
    "negative_magnitude": 9, "precision": "f32", "vertices": 576,
    "arcs_drawn": 2208, "reduced": {},
    "check": {"limits": {"rows_differing": 0, "potentials_differing": 0},
              "sample_rows": 48, "block_rows": 48},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def copy_benchmark(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``pjbench/`` (without caches and tests)
    copied under ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "pjbench", dest / "pjbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__",
                                                  "tests"))
    return dest


def edit_json(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data, indent=1))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = copy_benchmark(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        edit_json(root / conf["file"], **TINY_CONFIG[conf["name"]])
    for traffic in (root / "pjbench" / "traffic").glob("*.json"):
        edit_json(traffic, sources_per_request=TINY_SOURCES)
    return root


def add_lattice_cell(root: Path) -> str:
    """Add to the copy at ``root`` a cell on a lattice with negative arcs
    (phase 1 runs, its potentials come to the host and are checked) with
    the phase-1 metric, as new files and entries."""
    pkg = root / "pjbench"
    (pkg / "configs" / "test-lattice.json").write_text(json.dumps(LATTICE))
    traffic = json.loads((pkg / "traffic" / "graph500_kernel3.json").read_text())
    traffic.update(source_pool="all", sources_per_request=TINY_SOURCES)
    (pkg / "traffic" / "lattice_table.json").write_text(json.dumps(traffic))
    path = root / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["configs"].append({"name": "test-lattice", "source": "test",
                             "file": "pjbench/configs/test-lattice.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "lattice.table",
                               "config": "test-lattice",
                               "traffic": "lattice_table", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({
        "name": "potentials_pct", "unit": "%", "better": "lower",
        "source": "program_span", "layer": "phase 1 potentials",
        "moves": "rows_per_s", "workloads": ["lattice.table"]})
    path.write_text(json.dumps(bench))
    return "lattice.table"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def run_tiny(root: Path, workload: str, *, seconds: float = 1.0,
             trace: bool = False, seed: int = SEED) -> dict:
    from pjbench import harness

    return harness.run_cell(root, workload, seed, seconds, trace,
                            device="cpu", log=lambda msg: None)
