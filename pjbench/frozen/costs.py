"""The fan-out sweep's analytic cost, frozen.

A copy of ``sweep_cost`` from ``paralleljohnson_tpu_torch/observe/
costs.py`` as it stood when this benchmark was defined. Per sweep of a
[V, B] distance block over E in-edges: the block read and written once,
the int32 indptr and every edge's int32 source and weight read once, an
add and a min per edge and column.
"""

from __future__ import annotations


def sweep_cost(num_nodes: int, num_edges: int, batch: int, sweeps: int,
               itemsize: int = 4) -> dict:
    """``{"flops", "bytes_accessed"}`` of ``sweeps`` sweeps of a
    [num_nodes, batch] block over ``num_edges`` edges."""
    v, e, b, n = int(num_nodes), int(num_edges), max(int(batch), 1), int(sweeps)
    per_sweep = 2 * itemsize * v * b + 4 * (v + 1) + (4 + itemsize) * e
    return {"flops": 2.0 * e * b * n, "bytes_accessed": float(per_sweep) * n}


def sweep_work(num_nodes: int, num_edges: int, row_sweeps: float,
               sweeps: float, itemsize: int = 4) -> dict:
    """``{"flops", "bytes_accessed"}`` of a set of sweeps whose widths
    differ: ``row_sweeps`` is the sum over the sweeps of their column
    counts, ``sweeps`` their number. :func:`sweep_cost` is linear in the
    width, so this is the sum of its value over the sweeps."""
    one = sweep_cost(num_nodes, num_edges, 1, 1, itemsize)
    two = sweep_cost(num_nodes, num_edges, 2, 1, itemsize)
    out = {}
    for key in ("flops", "bytes_accessed"):
        per_column = two[key] - one[key]
        out[key] = per_column * row_sweeps + (one[key] - per_column) * sweeps
    return out
