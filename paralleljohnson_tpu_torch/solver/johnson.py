"""``ParallelJohnsonSolver`` — the solver orchestration layer of the port.

Johnson's all-pairs shortest paths, phase for phase as in the JAX
package's ``solver/johnson.py``:

  phase 1  Bellman-Ford from a virtual source  ->  potentials h(v)
           (negative-cycle detection lives here; skipped when no weight
           is negative)
  reweight w'(u,v) = w(u,v) + h(u) - h(v)  >=  0
  phase 2  N-source fan-out on w' in source batches
  phase 3  un-reweight d(u,v) = d'(u,v) - h(u) + h(v), per batch

The numeric kernels live in the configured backend. This slice has a
plain batch loop; resilience, checkpointing, pipelining, predecessors and
the condensed route are later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from paralleljohnson_tpu_torch.backends import Backend, get_backend
from paralleljohnson_tpu_torch.config import SolverConfig
from paralleljohnson_tpu_torch.graphs import CSRGraph
from paralleljohnson_tpu_torch.utils.metrics import SolverStats, phase_timer


class NegativeCycleError(ValueError):
    """The graph contains a cycle of negative total weight; shortest paths
    are undefined. Raised host-side from the device-computed flag."""


class ConvergenceError(RuntimeError):
    """A relaxation kernel hit its iteration cap (``max_iterations`` set
    below the graph's convergence depth) while distances were still
    improving. Distinct from a negative cycle: raise the cap and retry."""


class ValidationError(AssertionError):
    """config.validate=True cross-check against the scipy oracle failed."""


def to_numpy(x) -> np.ndarray:
    """Host copy of a tensor (any device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class SolveResult:
    """APSP / fan-out result.

    dist: [N_sources, V] distance rows (+inf unreachable); row i holds the
      distances from ``sources[i]``. A single-batch solve on a device
      backend leaves the rows on the device as a tensor; multi-batch
      solves return a host numpy array (:func:`to_numpy` materializes
      either).
    sources: the source vertex of each row.
    potentials: Johnson potentials h(v) (a device tensor when phase 1 ran,
      numpy zeros when no weight is negative).
    stats: per-phase wall-clock, iteration counts, edges-relaxed totals.
    """

    dist: Any
    sources: np.ndarray
    potentials: Any
    stats: SolverStats
    predecessors: Any | None = None

    @property
    def matrix(self) -> np.ndarray:
        """Host distance matrix ordered by source vertex id (full APSP)."""
        order = np.argsort(self.sources)
        return to_numpy(self.dist)[order]


def _unreweight(rows, h, row_sources):
    """Phase-3 arithmetic d(u,v) = (d'(u,v) - h(u)) + h(v), in the
    namespace where ``rows`` live (host rows get a host h; device rows a
    device h). +inf - h + h stays +inf (h is always finite)."""
    if isinstance(rows, np.ndarray):
        hh = to_numpy(h)
        return rows - hh[row_sources][:, None] + hh[None, :]
    hh = torch.as_tensor(h).to(rows.device, rows.dtype)
    idx = torch.as_tensor(np.asarray(row_sources), dtype=torch.int64)
    return rows - hh[idx.to(rows.device)][:, None] + hh[None, :]


class ParallelJohnsonSolver:
    """Orchestrates Johnson's algorithm over a pluggable backend.

    ``device`` places the torch backend's buffers: ``"cuda"`` (the
    default; raises ``RuntimeError`` without a CUDA device, never falls
    back) or ``"cpu"``.
    """

    def __init__(
        self,
        config: SolverConfig | None = None,
        backend: Backend | None = None,
        *,
        device="cuda",
    ) -> None:
        self.config = config or SolverConfig()
        self.backend = backend or get_backend(
            self.config.backend, self.config, device=device
        )

    def _check_supported(self, predecessors: bool) -> None:
        device = getattr(self.backend, "device", torch.device("cpu"))
        bad = self.config.unsupported(torch.device(device).type)
        if predecessors:
            bad.append("predecessors=True")
        if bad:
            raise NotImplementedError(
                "not ported to paralleljohnson_tpu_torch yet: " + ", ".join(bad)
            )

    def solve(
        self,
        graph: CSRGraph,
        sources: np.ndarray | None = None,
        *,
        predecessors: bool = False,
    ) -> SolveResult:
        """Full Johnson APSP (or the given source subset)."""
        self._check_supported(predecessors)
        stats = SolverStats()
        v = graph.num_nodes
        sources = (
            np.arange(v, dtype=np.int64)
            if sources is None
            else np.asarray(sources, np.int64)
        )
        with phase_timer(stats, "upload"):
            dgraph = self.backend.upload(graph)
        h, dgraph = self._potentials(graph, dgraph, stats)
        with phase_timer(stats, "fanout"):
            dist = self._fanout(dgraph, sources, stats, graph=graph, h=h)
        result = SolveResult(dist=dist, sources=sources, potentials=h,
                             stats=stats)
        if self.config.validate:
            self._validate(graph, result)
        return result

    def _potentials(self, graph: CSRGraph, dgraph: Any, stats: SolverStats):
        """Phase 1 + reweight: returns (h, reweighted dgraph). h stays on
        the backend's device. No negative weights -> h = 0 is already
        valid, skip."""
        if not graph.has_negative_weights:
            return np.zeros(graph.num_nodes, graph.dtype), dgraph
        with phase_timer(stats, "bellman_ford"):
            bf = self.backend.bellman_ford(dgraph, source=None)
        stats.accumulate(bf, phase="bellman_ford")
        if bf.negative_cycle:
            raise NegativeCycleError(
                "negative-weight cycle detected during reweighting"
            )
        if not bf.converged:
            raise ConvergenceError(
                "Bellman-Ford hit max_iterations while still improving; "
                "raise SolverConfig.max_iterations (or leave it None)"
            )
        h = bf.dist
        with phase_timer(stats, "reweight"):
            dgraph = self.backend.reweight(dgraph, h)
        return h, dgraph

    def _fanout(self, dgraph: Any, sources: np.ndarray, stats: SolverStats,
                *, graph: CSRGraph, h) -> Any:
        """Phase 2 in source batches of the backend's suggested size (or
        ``config.source_batch_size``), with phase 3 applied per batch. A
        single batch stays where the backend left it; several batches are
        downloaded one by one, since batching exists because all rows
        together exceed the device budget."""
        bs = self.config.source_batch_size
        if bs is None:
            bs = self.backend.suggested_source_batch(dgraph)
        bs = int(bs or len(sources) or 1)
        stats.final_batch = bs
        unreweight = graph.has_negative_weights
        rows = []
        for lo in range(0, len(sources), bs):
            batch = sources[lo:lo + bs]
            res = self.backend.multi_source(dgraph, batch)
            stats.accumulate(res, phase="fanout")
            if not res.converged:
                raise ConvergenceError(
                    "fan-out hit max_iterations while still improving"
                )
            row = res.dist
            if len(batch) < len(sources):
                row = to_numpy(row)
            if unreweight:
                row = _unreweight(row, h, batch)
            rows.append(row)
        if len(rows) == 1:
            return rows[0]
        return np.concatenate(rows, axis=0)

    def _validate(self, graph: CSRGraph, result: SolveResult) -> None:
        """config.validate: cross-check against the scipy Johnson oracle."""
        import scipy.sparse.csgraph as csgraph

        dense = np.ma.masked_invalid(graph.to_dense().astype(np.float64))
        oracle = csgraph.johnson(dense, directed=True)[result.sources]
        got = to_numpy(result.dist)
        if not np.allclose(got, oracle, rtol=1e-4, atol=1e-4):
            bad = ~np.isclose(got, oracle, rtol=1e-4, atol=1e-4)
            raise ValidationError(
                f"solver disagrees with scipy oracle at {bad.sum()} of "
                f"{bad.size} entries"
            )
