"""The ``GraphLoader`` plugin boundary (SURVEY.md §2 #7, BASELINE.json:5).

A loader is any callable ``spec -> CSRGraph``. Loaders register under a
scheme name; :func:`load_graph` dispatches on ``scheme:rest`` specs or on
file extension. Built-in schemes:

  - ``dimacs:<path>`` / ``*.gr`` / ``*.gr.gz``   — DIMACS shortest-path
  - ``snap:<path>``   / ``*.txt`` / ``*.edges``  — SNAP edge list
  - ``er:n=1000,p=0.01[,neg=0.2][,seed=0]``      — Erdős–Rényi
  - ``dag:n=1000,p=0.01[,neg=0.3][,seed=0]``     — acyclic ER (safe negatives)
  - ``rmat:scale=20[,ef=16][,seed=0]``           — R-MAT
  - ``grid:rows=512,cols=512[,neg=0.2][,seed=0]`` — road-like 2-D lattice
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

from paralleljohnson_tpu_torch.graphs.csr import CSRGraph
from paralleljohnson_tpu_torch.graphs import generators, loaders

GraphLoaderFn = Callable[[str], CSRGraph]

_LOADERS: dict[str, GraphLoaderFn] = {}
_EXTENSIONS: dict[str, str] = {
    ".gr": "dimacs",
    ".edges": "snap",
    ".txt": "snap",
}


def register_loader(scheme: str, fn: GraphLoaderFn) -> None:
    """Register a loader plugin under ``scheme`` (overwrites existing)."""
    _LOADERS[scheme] = fn


def available_loaders() -> list[str]:
    return sorted(_LOADERS)


def _parse_kwargs(rest: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for item in filter(None, rest.split(",")):
        if "=" not in item:
            raise ValueError(f"bad spec item {item!r} (want key=value)")
        k, v = item.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def _er_loader(rest: str) -> CSRGraph:
    kw = _parse_kwargs(rest)
    return generators.erdos_renyi(
        int(kw["n"]), float(kw["p"]),
        negative_fraction=float(kw.get("neg", 0.0)),
        seed=int(kw.get("seed", 0)),
    )


def _dag_loader(rest: str) -> CSRGraph:
    kw = _parse_kwargs(rest)
    return generators.random_dag(
        int(kw["n"]), float(kw["p"]),
        negative_fraction=float(kw.get("neg", 0.3)),
        seed=int(kw.get("seed", 0)),
    )


def _rmat_loader(rest: str) -> CSRGraph:
    kw = _parse_kwargs(rest)
    return generators.rmat(
        int(kw["scale"]), int(kw.get("ef", 16)), seed=int(kw.get("seed", 0)),
    )


def _grid_loader(rest: str) -> CSRGraph:
    kw = _parse_kwargs(rest)
    return generators.grid2d(
        int(kw["rows"]), int(kw["cols"]),
        negative_fraction=float(kw.get("neg", 0.0)),
        seed=int(kw.get("seed", 0)),
    )


register_loader("dimacs", loaders.load_dimacs)
register_loader("snap", loaders.load_snap)
register_loader("er", _er_loader)
register_loader("dag", _dag_loader)
register_loader("rmat", _rmat_loader)
register_loader("grid", _grid_loader)


def load_graph(spec: str | Path) -> CSRGraph:
    """Load a graph from a ``scheme:rest`` spec or a path (by extension)."""
    spec = str(spec)
    if ":" in spec:
        scheme, rest = spec.split(":", 1)
        if scheme in _LOADERS:
            return _LOADERS[scheme](rest)
    path = Path(spec)
    suffix = path.suffix if path.suffix != ".gz" else Path(path.stem).suffix
    if suffix in _EXTENSIONS:
        return _LOADERS[_EXTENSIONS[suffix]](spec)
    raise ValueError(
        f"cannot infer loader for {spec!r}; known schemes: {available_loaders()}"
    )
