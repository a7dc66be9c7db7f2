"""The ``Backend`` plugin boundary.

A backend owns device-resident graph buffers and the two numeric kernels of
Johnson's algorithm: the Bellman-Ford edge-relaxation pass and the N-source
non-negative shortest-path fan-out. The solver orchestrates phases through
this interface, the same seam as in the JAX package.

Kernel results carry a ``negative_cycle`` flag instead of raising; the
solver raises host-side.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any

import numpy as np

from paralleljohnson_tpu_torch.config import SolverConfig
from paralleljohnson_tpu_torch.graphs import CSRGraph


@dataclasses.dataclass
class KernelResult:
    """Output of one backend kernel invocation.

    dist: [V] (single-source) or [B, V] (multi-source) distances, +inf for
      unreachable. Device backends return a tensor on their device, so rows
      can stay resident; host backends return numpy.
    negative_cycle: True iff a negative cycle is reachable (Bellman-Ford
      only). Only claimed when the kernel ran the full |V|-sweep bound — a
      user-capped ``max_iterations`` below |V| yields converged=False
      instead, never a spurious cycle report.
    converged: False iff the kernel hit its iteration cap while distances
      were still improving (the solver raises ConvergenceError host-side).
    iterations: relaxation sweeps (sweep backends) or 0 (heap Dijkstra).
    edges_relaxed: edge relaxations performed. A sweep counts every edge
      it scans per batch row; heap Dijkstra counts edges scanned from
      settled vertices; the dense min-plus regimes count candidate
      min-plus operations.
    route: the kernel route the backend resolved to, in the JAX package's
      vocabulary ("sweep", "pallas-vm", "dense-squaring-pallas", ...).
    trajectory: the decoded per-iteration convergence trajectory
      (``observe.convergence``): float64 ``[n, 3]`` host array, columns
      (frontier_size, relaxations_applied, residual_mass). None unless
      ``SolverConfig(convergence=True)`` and the route records one.
    convergence: the trajectory's summary
      (``observe.convergence.summarize_trajectory``); folds into
      ``SolverStats.convergence``.
    plan: the route decision behind this result (``planner
      .PlanDecision.as_dict``: ``chosen``, ``reason``, ``candidates``,
      the resolved ``params``), or None; folds into ``SolverStats.plan``.
    cost: the analytic cost record of this call (``observe.costs``:
      ``flops`` / ``bytes_accessed`` with ``cost_source:
      "analytic-model"``, or the ``cost_analysis_unavailable`` marker),
      or None when no profile store is configured; folds into
      ``SolverStats.analytic_cost``.
    """

    dist: Any
    negative_cycle: bool = False
    iterations: int = 0
    edges_relaxed: int = 0
    converged: bool = True
    pred: np.ndarray | None = None
    route: str | None = None
    trajectory: Any | None = None
    convergence: dict | None = None
    plan: dict | None = None
    cost: dict | None = None


class Backend(abc.ABC):
    """Execution engine behind the solver. Subclass + register to plug in."""

    name: str = "abstract"
    # Where the backend computes: host backends run on the CPU; the torch
    # backend sets its own device.
    device = "cpu"

    def __init__(self, config: SolverConfig | None = None, device=None) -> None:
        self.config = config or SolverConfig()

    @abc.abstractmethod
    def upload(self, graph: CSRGraph) -> Any:
        """Move CSR buffers to execution memory. Returns an opaque
        device-graph handle accepted by the kernels below."""

    @abc.abstractmethod
    def bellman_ford(self, dgraph: Any, source: int | None) -> KernelResult:
        """SSSP with negative weights from ``source``.

        ``source=None`` runs the virtual-source variant used for Johnson
        potentials: dist starts at 0 for every vertex (a virtual vertex q
        with 0-weight edges to all, without materializing it).
        """

    @abc.abstractmethod
    def multi_source(self, dgraph: Any, sources: np.ndarray) -> KernelResult:
        """N-source shortest paths on a non-negative graph. Returns
        dist[B, V] in the order of ``sources``."""

    # -- optional capabilities ----------------------------------------------

    def bellman_ford_pred(self, dgraph: Any, source: int | None) -> KernelResult:
        """Like :meth:`bellman_ford` but fills ``KernelResult.pred`` with the
        shortest-path tree (-1 at the source / unreached). Optional."""
        raise NotImplementedError(f"{self.name} does not track predecessors")

    def multi_source_pred(self, dgraph: Any, sources: np.ndarray) -> KernelResult:
        """Like :meth:`multi_source` but fills ``KernelResult.pred`` [B, V].
        Optional."""
        raise NotImplementedError(f"{self.name} does not track predecessors")

    def suggested_source_batch(
        self, dgraph: Any, with_pred: bool = False
    ) -> int | None:
        """Largest source batch one fan-out call should take when
        ``config.source_batch_size`` is None; ``None`` = no cap.
        ``with_pred=True`` must also budget the extra int32 [B, V] pred
        block a predecessor solve carries."""
        return None

    def clear_caches(self, dgraph: Any) -> None:
        """Drop rebuildable device-side caches attached to ``dgraph`` so a
        large host download has the memory they held. No-op for host
        backends."""

    def close(self) -> None:
        """Release what outlives a solve (the torch backend's mesh
        process groups). The backend stays usable. No-op for host
        backends."""

    def stage_rows_async(self, *arrays: Any) -> None:
        """Start device-to-host copies of ``arrays`` WITHOUT blocking (a
        scheduling hint, never correctness): the pipelined fan-out calls
        this the moment a batch's rows pass the sanity guard, so the copy
        runs under the next batch's compute. No-op for host backends."""

    def reweight(self, dgraph: Any, potentials) -> Any:
        """Return a device graph with w'(u,v) = w + h(u) - h(v) (>= 0)."""
        graph = self.download_graph(dgraph)
        h = np.asarray(potentials, graph.dtype)
        wp = graph.weights + h[graph.src] - h[graph.indices]
        # Guard tiny negative float residue so the fan-out's non-negativity
        # precondition holds exactly.
        return self.upload(graph.with_weights(np.maximum(wp, 0.0)))

    def batch_apsp(self, batch: dict[str, np.ndarray]) -> KernelResult:
        """Many-small-graphs mode: APSP for a padded batch (see
        ``stack_graphs``), dist[B, V, V]. Backends with a vectorized path
        override this; the solver falls back to one solve per graph."""
        raise NotImplementedError(f"{self.name} has no batch_apsp")

    def download_graph(self, dgraph: Any) -> CSRGraph:
        """Inverse of upload, for host-side composition/debug."""
        raise NotImplementedError(f"{self.name} cannot download graphs")

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} name={self.name!r}>"


_BACKENDS: dict[str, type[Backend]] = {}


def register_backend(name: str, cls: type[Backend]) -> None:
    _BACKENDS[name] = cls


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def get_backend(
    name: str, config: SolverConfig | None = None, device="cuda"
) -> Backend:
    """Instantiate a registered backend. ``device`` places a device
    backend's buffers ("cuda" by default; pass "cpu" to run the plain
    PyTorch versions on the host); host backends ignore it."""
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None
    return cls(config, device=device)
