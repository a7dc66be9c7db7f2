"""Find a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations and the metrics. Each part lives in a file of its own
under this directory, found by its name: ``configs/<file>`` as the
configuration entry names it, ``traffic/<name>.json``,
``entries/<entry>.py``, ``metrics/<name>.py`` and
``generators/<kind>.py``. A later cell, traffic
mix, configuration or metric is added as files and entries; nothing here
changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    """The manifest at ``root`` (the checkout)."""
    return _load_json(Path(root) / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    listed = metric.get("workloads")
    return listed is None or workload in listed


def cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of the manifest at ``root``, with its
    configuration and traffic files read and the metrics that apply to
    it (those without a ``workloads`` list, or that list it)."""
    root = Path(root)
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    pkg = root / "pjbench"
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=_load_json(root / conf["file"]),
        traffic=_load_json(pkg / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(root: Path, kind: str):
    """``generators/<kind>.py`` of the checkout at ``root``."""
    return _module(Path(root) / "pjbench" / "generators" / f"{kind}.py",
                   f"pjbench_generator_{kind}")


def metric_reader(root: Path, name: str):
    """``metrics/<name>.py`` of the checkout at ``root``: its ``read(run)``
    returns the metric's value, or None where it finds nothing to read."""
    safe = name.replace(".", "_").replace("-", "_")
    return _module(Path(root) / "pjbench" / "metrics" / f"{name}.py",
                   f"pjbench_metric_{safe}")


def entry(root: Path, name: str):
    """``entries/<name>.py`` of the checkout at ``root``: how a traffic
    mix drives the program (its ``warm`` and ``drive``)."""
    return _module(Path(root) / "pjbench" / "entries" / f"{name}.py",
                   f"pjbench_entry_{name}")
