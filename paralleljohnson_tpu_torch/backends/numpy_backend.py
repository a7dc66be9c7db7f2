"""Trivially-correct host backend: vectorized-numpy Bellman-Ford + scipy
Dijkstra fan-out.

This pins the plugin boundary before any performance work (SURVEY.md §7
step 2) and doubles as the equivalence anchor: every other backend must
match it (which itself is tested against scipy/networkx oracles).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from paralleljohnson_tpu_torch.backends.base import Backend, KernelResult, register_backend
from paralleljohnson_tpu_torch.graphs import CSRGraph


class NumpyBackend(Backend):
    """Host-memory reference backend (no device upload)."""

    name = "numpy"

    def upload(self, graph: CSRGraph) -> CSRGraph:
        return graph.astype(self.config.np_dtype)

    def download_graph(self, dgraph: CSRGraph) -> CSRGraph:
        return dgraph

    def bellman_ford(self, dgraph: CSRGraph, source: int | None) -> KernelResult:
        """Vectorized Bellman-Ford sweep with np.minimum.at scatter-min.

        A full-sweep (Bellman-Ford-Moore) loop: each sweep relaxes every
        edge; fixpoint in <= V-1 sweeps unless a negative cycle is
        reachable, detected by a still-improving V-th sweep.
        """
        g = dgraph
        v, e = g.num_nodes, g.num_edges
        dist = np.zeros(v, g.dtype) if source is None else np.full(v, np.inf, g.dtype)
        if source is not None:
            dist[source] = 0.0
        src, dst, w = g.src, g.indices, g.weights
        max_iter = self.config.max_iterations or v
        iterations = 0
        improving = False
        for _ in range(max_iter + 1):
            cand = dist[src] + w
            new = dist.copy()
            np.minimum.at(new, dst, cand)
            iterations += 1
            if np.array_equal(new, dist):
                improving = False
                break
            dist = new
            improving = True
        # Still improving after the V-sweep Bellman-Ford bound proves a
        # negative cycle; with a user cap below V it only proves non-
        # convergence (the solver raises ConvergenceError, not a cycle).
        return KernelResult(
            dist=dist,
            negative_cycle=improving and max_iter >= v,
            converged=not improving,
            iterations=iterations,
            edges_relaxed=iterations * e,
        )

    def multi_source(self, dgraph: CSRGraph, sources: np.ndarray) -> KernelResult:
        return self._multi_source(dgraph, sources, with_pred=False)

    def multi_source_pred(self, dgraph: CSRGraph, sources: np.ndarray) -> KernelResult:
        return self._multi_source(dgraph, sources, with_pred=True)

    def _multi_source(
        self, dgraph: CSRGraph, sources: np.ndarray, *, with_pred: bool
    ) -> KernelResult:
        g = dgraph
        if g.has_negative_weights:
            raise ValueError("multi_source requires non-negative weights")
        mat = sp.csr_matrix(
            (g.weights, g.indices, g.indptr), shape=(g.num_nodes, g.num_nodes)
        )
        sources = np.asarray(sources, np.int64)
        # Explicitly-stored zeros in a sparse csgraph input are true
        # zero-weight edges (reweighted tree edges are exactly 0).
        pred = None
        if with_pred:
            dist, pred = csgraph.dijkstra(
                mat, directed=True, indices=sources, return_predecessors=True
            )
            # scipy's "no predecessor" sentinel is -9999; normalize to -1.
            pred = np.where(pred < 0, -1, pred).astype(np.int32)
        else:
            dist = csgraph.dijkstra(mat, directed=True, indices=sources)
        # Heap Dijkstra scans each settled vertex's out-edges once: <= E per
        # source (the conventional count for this kernel).
        return KernelResult(
            dist=dist.astype(g.dtype),
            pred=pred,
            edges_relaxed=int(len(sources)) * g.num_edges,
        )

    def bellman_ford_pred(self, dgraph: CSRGraph, source: int | None) -> KernelResult:
        """Predecessor-tracking SSSP via the scipy Bellman-Ford (real
        sources only; the virtual-source variant has no tree to report)."""
        if source is None:
            raise NotImplementedError(
                "virtual-source Bellman-Ford has no predecessor tree"
            )
        g = dgraph
        mat = sp.csr_matrix(
            (g.weights, g.indices, g.indptr), shape=(g.num_nodes, g.num_nodes)
        )
        try:
            dist, pred = csgraph.bellman_ford(
                mat, directed=True, indices=source, return_predecessors=True
            )
        except csgraph.NegativeCycleError:
            return KernelResult(
                dist=np.full(g.num_nodes, np.nan, g.dtype),
                negative_cycle=True, converged=False,
                iterations=g.num_nodes, edges_relaxed=g.num_nodes * g.num_edges,
            )
        pred = np.where(pred < 0, -1, pred).astype(np.int32)
        return KernelResult(
            dist=dist.astype(g.dtype),
            pred=pred,
            iterations=g.num_nodes,
            edges_relaxed=g.num_nodes * g.num_edges,
        )


register_backend("numpy", NumpyBackend)
