"""Shortest-path reconstruction from predecessor arrays.

Predecessor convention across the framework: ``pred[b, v]`` is the vertex
preceding ``v`` on a shortest path from ``sources[b]``; ``-1`` means "no
predecessor" (the source itself, or ``v`` unreachable).
"""

from __future__ import annotations

import numpy as np

NO_PRED = -1


def reconstruct_path(pred_row: np.ndarray, source: int, target: int) -> list[int]:
    """Walk ``pred_row`` back from ``target`` to ``source``.

    Returns the vertex sequence ``[source, ..., target]``; an empty list if
    ``target`` is unreachable. Raises ValueError on a malformed array (walk
    longer than |V| — a cycle, which a correct shortest-path tree cannot
    contain).
    """
    if target == source:
        return [source]
    if pred_row[target] == NO_PRED:
        return []
    path = [int(target)]
    v = int(target)
    for _ in range(len(pred_row)):
        v = int(pred_row[v])
        path.append(v)
        if v == source:
            return path[::-1]
        if pred_row[v] == NO_PRED:
            break
    raise ValueError(
        f"predecessor array does not trace back from {target} to {source}"
    )


def _min_weight_edge_map(graph):
    """(sorted int64 keys u*V+v, min weight per key) for O(log E) edge
    lookups; parallel edges resolve to their minimum weight (the only one
    a shortest path can use). An edgeless graph maps to two empty arrays."""
    v = graph.num_nodes
    keys = graph.src.astype(np.int64) * v + graph.indices.astype(np.int64)
    if keys.size == 0:
        return keys, graph.weights[:0]
    order = np.argsort(keys, kind="stable")
    keys, w = keys[order], graph.weights[order]
    first = np.concatenate(([True], keys[1:] != keys[:-1]))
    return keys[first], np.minimum.reduceat(w, np.flatnonzero(first))


def validate_pred_tree(
    graph, dist, pred, sources, *, rtol: float = 1e-4, atol: float = 1e-4
) -> None:
    """Validate predecessor rows against their OWN distance rows — the
    shared invariant checker for every backend's ``--predecessors``
    output (trees need not be identical across backends, only valid).

    Checks, per row b (raises ValueError on the first violation):
      - root convention: ``pred[b, sources[b]] == NO_PRED``;
      - unreachable convention: ``dist[b, v] = +inf  ->  pred = NO_PRED``;
      - coverage: finite non-source v has a predecessor;
      - tightness: ``(pred[v], v)`` is a real edge with
        ``dist[pred[v]] + w == dist[v]`` within rtol/atol (the same
        tolerance family as ``ops.pred``'s extraction rule);
      - acyclicity: every finite vertex walks back to a root within |V|
        hops (pointer doubling — a predecessor cycle never terminates).

    ``dist``/``pred``: [B, V] (or [V] with a scalar source). Host numpy —
    this module stays JAX-free by design.
    """
    dist = np.atleast_2d(np.asarray(dist))
    pred = np.atleast_2d(np.asarray(pred))
    sources = np.atleast_1d(np.asarray(sources, np.int64))
    b, v = dist.shape
    if pred.shape != dist.shape:
        raise ValueError(f"pred shape {pred.shape} != dist shape {dist.shape}")
    keys, wmin = _min_weight_edge_map(graph)
    rows = np.arange(b)
    if not (pred[rows, sources] == NO_PRED).all():
        raise ValueError("pred[source] must be NO_PRED for every row")
    finite = np.isfinite(dist)
    if (pred[~finite] != NO_PRED).any():
        raise ValueError("unreachable vertices must have pred == NO_PRED")
    src_mask = np.zeros((b, v), bool)
    src_mask[rows, sources] = True
    missing = finite & ~src_mask & (pred == NO_PRED)
    if missing.any():
        bi, vi = np.argwhere(missing)[0]
        raise ValueError(
            f"reachable vertex {vi} (row {bi}) has no predecessor"
        )
    has = pred != NO_PRED
    bi, vi = np.nonzero(has)
    ui = pred[bi, vi].astype(np.int64)
    k = ui * v + vi
    pos = np.searchsorted(keys, k)
    edge_ok = (pos < keys.size) & (keys[np.minimum(pos, keys.size - 1)] == k)
    if not edge_ok.all():
        j = np.flatnonzero(~edge_ok)[0]
        raise ValueError(
            f"pred edge ({ui[j]} -> {vi[j]}) (row {bi[j]}) is not in the graph"
        )
    lhs = dist[bi, ui] + wmin[pos]
    rhs = dist[bi, vi]
    bad = ~np.isclose(lhs, rhs, rtol=rtol, atol=atol)
    if bad.any():
        j = np.flatnonzero(bad)[0]
        raise ValueError(
            f"pred edge ({ui[j]} -> {vi[j]}) (row {bi[j]}) is not tight: "
            f"dist[u] + w = {lhs[j]:g} != dist[v] = {rhs[j]:g}"
        )
    # Acyclicity via pointer doubling (NO_PRED absorbing).
    q = pred.astype(np.int64)
    for _ in range(max(1, int(np.ceil(np.log2(max(v, 2)))))):
        hop = np.take_along_axis(q, np.maximum(q, 0), axis=1)
        q = np.where(q >= 0, hop, q)
    if (q != NO_PRED).any():
        bi, vi = np.argwhere(q != NO_PRED)[0]
        raise ValueError(
            f"predecessor cycle reachable from vertex {vi} (row {bi})"
        )


def path_weight(graph, path: list[int]) -> float:
    """Total weight of ``path`` in ``graph`` (CSRGraph); +inf if any hop is
    not an edge. Parallel edges contribute their minimum weight."""
    total = 0.0
    for u, v in zip(path, path[1:]):
        row = slice(graph.indptr[u], graph.indptr[u + 1])
        hits = graph.indices[row] == v
        if not hits.any():
            return float("inf")
        total += float(graph.weights[row][hits].min())
    return total
