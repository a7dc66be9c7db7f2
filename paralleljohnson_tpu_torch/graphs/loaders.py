"""File-format loaders: DIMACS shortest-path (.gr) and SNAP edge lists.

Rebuild of the reference's attested loaders (SURVEY.md §2 #8-#9; attested via
the DIMACS-NY and SNAP ego-Facebook benchmark configs, BASELINE.json:8-9).
Both return :class:`CSRGraph`; parsing is host-side numpy.
"""

from __future__ import annotations

import gzip
import io
from pathlib import Path

import numpy as np

from paralleljohnson_tpu_torch.graphs.csr import CSRGraph


class GraphFormatError(ValueError):
    """Malformed graph-file input (truncated record, out-of-range vertex
    id, non-numeric weight, missing problem line). Always names the file
    and 1-based line number, so a bad byte in a multi-GB road-graph file
    is diagnosable from the message — instead of an index crash deep in
    the CSR build minutes later."""


def _format_error(path, lineno, what, line=None) -> GraphFormatError:
    loc = f"{path}:{lineno}" if lineno else f"{path}"
    detail = f" in {line!r}" if line is not None else ""
    return GraphFormatError(f"{loc}: {what}{detail}")


def _open_text(path: str | Path):
    path = Path(path)
    if path.suffix == ".gz":
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def load_dimacs(path: str | Path, *, dtype=np.float32) -> CSRGraph:
    """Parse the 9th DIMACS Implementation Challenge ``.gr`` format.

    Grammar (one record per line):
      - ``c <comment>``        — ignored
      - ``p sp <V> <E>``       — problem line, exactly one
      - ``a <u> <v> <w>``      — directed arc u->v, 1-indexed, w may be
                                 negative (the DIMACS-NY negative-weight
                                 config is attested, BASELINE.json:8)

    Malformed input (truncated arc line, out-of-range vertex id,
    non-numeric weight, arcs before/without the problem line) raises
    :class:`GraphFormatError` naming file + line number.
    """
    num_nodes = None
    srcs: list[int] = []
    dsts: list[int] = []
    wts: list[float] = []
    with _open_text(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("c"):
                continue
            parts = line.split()
            if parts[0] == "p":
                if len(parts) != 4 or parts[1] != "sp":
                    raise _format_error(path, lineno, "bad problem line", line)
                try:
                    num_nodes = int(parts[2])
                except ValueError:
                    raise _format_error(
                        path, lineno, "non-numeric node count", line
                    ) from None
                if num_nodes < 0:
                    raise _format_error(
                        path, lineno, "negative node count", line
                    )
            elif parts[0] == "a":
                if len(parts) != 4:
                    raise _format_error(
                        path, lineno, "truncated arc line", line
                    )
                if num_nodes is None:
                    raise _format_error(
                        path, lineno, "arc before 'p sp' problem line", line
                    )
                try:
                    u = int(parts[1]) - 1
                    v = int(parts[2]) - 1
                except ValueError:
                    raise _format_error(
                        path, lineno, "non-numeric vertex id", line
                    ) from None
                try:
                    w = float(parts[3])
                except ValueError:
                    raise _format_error(
                        path, lineno, "non-numeric weight", line
                    ) from None
                if not (0 <= u < num_nodes and 0 <= v < num_nodes):
                    raise _format_error(
                        path, lineno,
                        f"vertex id out of range 1..{num_nodes}", line,
                    )
                srcs.append(u)
                dsts.append(v)
                wts.append(w)
            else:
                raise _format_error(
                    path, lineno, f"unknown record {parts[0]!r}", line
                )
    if num_nodes is None:
        raise _format_error(path, None, "missing 'p sp' problem line")
    return CSRGraph.from_edges(srcs, dsts, wts, num_nodes, dtype=dtype)


def load_snap(
    path: str | Path,
    *,
    directed: bool = False,
    default_weight: float = 1.0,
    dtype=np.float32,
) -> CSRGraph:
    """Parse a SNAP plain edge list (``# comment`` lines, then ``u v [w]``).

    SNAP datasets (e.g. ego-Facebook, BASELINE.json:9) are undirected and
    unweighted by default: each line yields both arcs with weight
    ``default_weight`` unless a third column supplies one. Vertex ids are
    remapped to a dense [0, V) in sorted order; the mapping is stored on the
    returned graph as ``node_ids`` (original id of each dense vertex).
    """
    srcs: list[int] = []
    dsts: list[int] = []
    wts: list[float] = []
    with _open_text(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("%"):
                continue
            parts = line.split()
            if len(parts) < 2:
                raise _format_error(path, lineno, "truncated edge line", line)
            try:
                u = int(parts[0])
                v = int(parts[1])
            except ValueError:
                raise _format_error(
                    path, lineno, "non-numeric vertex id", line
                ) from None
            if u < 0 or v < 0:
                raise _format_error(
                    path, lineno, "negative vertex id", line
                )
            try:
                w = float(parts[2]) if len(parts) > 2 else default_weight
            except ValueError:
                raise _format_error(
                    path, lineno, "non-numeric weight", line
                ) from None
            srcs.append(u)
            dsts.append(v)
            wts.append(w)
    src = np.asarray(srcs, np.int64)
    dst = np.asarray(dsts, np.int64)
    w = np.asarray(wts, dtype)
    node_ids = np.unique(np.concatenate([src, dst])) if len(src) else np.array([], np.int64)
    dense = {int(v): i for i, v in enumerate(node_ids)}
    src = np.fromiter((dense[int(v)] for v in src), np.int64, len(src))
    dst = np.fromiter((dense[int(v)] for v in dst), np.int64, len(dst))
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    g = CSRGraph.from_edges(src, dst, w, len(node_ids), dtype=dtype)
    g.__dict__["node_ids"] = node_ids
    return g


def save_dimacs(graph: CSRGraph, path: str | Path, comment: str = "") -> None:
    """Write a graph back out as DIMACS ``.gr`` (round-trip/test helper)."""
    with open(path, "w", encoding="utf-8") as fh:
        if comment:
            fh.write(f"c {comment}\n")
        fh.write(f"p sp {graph.num_nodes} {graph.num_edges}\n")
        for u, v, w in zip(graph.src, graph.indices, graph.weights):
            w = int(w) if float(w).is_integer() else float(w)
            fh.write(f"a {u + 1} {v + 1} {w}\n")
