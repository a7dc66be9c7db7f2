"""Analytic cost capture: the bytes and operations of every route.

The JAX package prices each route from XLA's ``cost_analysis()`` of the
compiled executable. PyTorch has no such table, so the port prices a
route from an analytic model of the work its kernels do at this solve's
shapes, the same counts the port's kernel bounds use:

- a sweep route (``pallas-vm``, ``vm``, ``vm-blocked``, ``sweep-sm``,
  ``sweep``, ``dia``): per sweep, the [V, B] distances read and written
  once, the CSC indptr and every edge's (source, weight) read once, an
  add and a min per edge and batch column (:func:`sweep_cost`);
- a min-plus product [I, K] x [K, J] (the ``dense-*`` routes, per
  product): both operands read and the result written once, an add and
  a min per candidate (:func:`minplus_cost`);
- blocked Floyd-Warshall (``fw`` / ``fw-tile``): ``ops.fw
  .fw_analytic_cost``, whose MAC count includes the diagonal tiles'
  Kleene closures (2 t^3 operations each);
- the tight-edge pass of a ``+pred`` route (:func:`tight_pred_cost`);
- ``vm-blocked+dw``: ``ops.relax.dw_analytic_cost`` of the edge slots
  the dirty window examined.

Every such record says ``cost_source: "analytic-model"``. A route with
no model gets the explicit ``cost_analysis_unavailable`` marker, never a
zero, so consumers can tell "cheap" from "unmeasured". Capture is on
only when a profile store is configured (``SolverConfig.profile_store``
/ ``PJ_PROFILE_DIR``); the models are a few integer products, so a
record is made per kernel call, not cached per shape as an XLA
compilation is.

Standard library only.
"""

from __future__ import annotations

import os
import threading


def resolve_profile_dir(explicit: str | None = None) -> str | None:
    """Profile-store directory: an explicit ``SolverConfig.profile_store``
    wins, else the ``PJ_PROFILE_DIR`` environment variable; neither set
    disables capture and the store."""
    return explicit or os.environ.get("PJ_PROFILE_DIR") or None


def _pow2_up(n: int) -> int:
    n = int(n)
    if n <= 0:
        return 0
    return 1 << max(0, (n - 1).bit_length())


def shape_bucket(num_nodes: int, num_edges: int,
                 batch: int) -> tuple[int, int, int]:
    """Shape key of profile records: each dimension rounded UP to a power
    of two, so ragged final batches and padded edge lists share their
    canonical bucket."""
    return (_pow2_up(num_nodes), _pow2_up(num_edges), _pow2_up(batch))


def _cost(flops: float, bytes_accessed: float) -> dict:
    return {"flops": float(flops), "bytes_accessed": float(bytes_accessed),
            "transcendentals": 0.0}


def sweep_cost(num_nodes: int, num_edges: int, batch: int, sweeps: int,
               itemsize: int = 4) -> dict:
    """``sweeps`` relaxation sweeps of a [V, B] block over E edges: each
    sweep reads and writes the block once, reads the int32 indptr and
    every edge's int32 source and weight once, and does an add and a min
    per edge and column."""
    v, e, b, n = int(num_nodes), int(num_edges), max(int(batch), 1), int(sweeps)
    per_sweep = 2 * itemsize * v * b + 4 * (v + 1) + (4 + itemsize) * e
    return _cost(2.0 * e * b * n, float(per_sweep) * n)


def minplus_cost(i: int, k: int, j: int, products: int = 1,
                 itemsize: int = 4) -> dict:
    """``products`` min-plus products [I, K] x [K, J]: both operands read
    and the result written once, an add and a min per candidate."""
    n = int(products)
    return _cost(2.0 * i * k * j * n,
                 float(itemsize) * (i * k + k * j + i * j) * n)


def tight_pred_cost(num_nodes: int, num_edges: int, batch: int,
                    itemsize: int = 4) -> dict:
    """One tight-edge pass: the [V, B] distances read, the int32 [V, B]
    tree written, the indptr and every edge's (source, weight) read once;
    two adds, a compare and a min per edge and column."""
    v, e, b = int(num_nodes), int(num_edges), max(int(batch), 1)
    return _cost(4.0 * e * b,
                 float((itemsize + 4) * v * b + 4 * (v + 1)
                       + (4 + itemsize) * e))


def add_costs(*costs: dict) -> dict:
    """The sum of analytic cost dicts."""
    keys = ("flops", "bytes_accessed", "transcendentals")
    return {k: float(sum(c.get(k, 0.0) for c in costs)) for k in keys}


class CostCapture:
    """Per-call analytic cost records of one backend instance.

    ``analytic()`` returns the model-priced record, ``unavailable()`` the
    explicit marker; both return None when capture is disabled, so call
    sites stay one-liners. ``records()`` holds the latest record per
    ``(route, platform, shape bucket)``."""

    def __init__(self, enabled: bool = True, platform: str = "cpu") -> None:
        self.enabled = bool(enabled)
        self.platform = platform
        self._last: dict = {}
        self._lock = threading.Lock()

    def _base(self, route, num_nodes, num_edges, batch):
        bucket = shape_bucket(num_nodes, num_edges, batch)
        return (route, self.platform, bucket), {
            "route": route,
            "platform": self.platform,
            "shape_bucket": list(bucket),
            "nodes": int(num_nodes),
            "edges": int(num_edges),
            "batch": int(batch),
        }

    def _keep(self, key, rec: dict) -> dict:
        with self._lock:
            self._last[key] = rec
        return rec

    def analytic(self, route: str, cost: dict, *, num_nodes: int,
                 num_edges: int, batch: int = 1) -> dict | None:
        """The model-priced record of one kernel call: ``cost``'s
        ``flops`` / ``bytes_accessed`` (+ ``transcendentals``), tagged
        ``cost_source: "analytic-model"``."""
        if not self.enabled:
            return None
        key, rec = self._base(route, num_nodes, num_edges, batch)
        rec["flops"] = float(cost.get("flops", 0.0))
        rec["bytes_accessed"] = float(cost.get("bytes_accessed", 0.0))
        rec["transcendentals"] = float(cost.get("transcendentals", 0.0))
        rec["cost_source"] = "analytic-model"
        return self._keep(key, rec)

    def unavailable(self, route: str, reason: str, *, num_nodes: int,
                    num_edges: int, batch: int = 1) -> dict | None:
        """The explicit marker of a route with no analytic model:
        "unmeasured", stated, never a zero."""
        if not self.enabled:
            return None
        key, rec = self._base(route, num_nodes, num_edges, batch)
        rec["cost_analysis_unavailable"] = reason
        return self._keep(key, rec)

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._last.values())
