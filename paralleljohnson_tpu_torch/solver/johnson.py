"""``ParallelJohnsonSolver`` — the solver orchestration layer of the port.

Johnson's all-pairs shortest paths, phase for phase as in the JAX
package's ``solver/johnson.py``:

  phase 1  Bellman-Ford from a virtual source  ->  potentials h(v)
           (negative-cycle detection lives here; skipped when no weight
           is negative)
  reweight w'(u,v) = w(u,v) + h(u) - h(v)  >=  0
  phase 2  N-source fan-out on w' in source batches
  phase 3  un-reweight d(u,v) = d'(u,v) - h(u) + h(v), per batch

The solver owns phase structure, batching, checkpoint/resume and the
resilience layer (retries, the watchdog, OOM degradation, the sanity
guard); the numeric kernels live in the configured backend. The fan-out
batches run as a pipeline: batch k's device-to-host copy and checkpoint
write overlap batch k+1's compute. ``predecessors=True`` carries a
shortest-path tree block beside every distance block, through the
batches, the downloads and the checkpoints.

``solve()`` first walks :data:`SOLVER_PLANS` (``planner.select``):
the condensed partitioned route (``solver.partitioned``,
``condensed+fw``) takes the solve only when ``partitioned=True`` forces
it or a priced profile store promotes it (its ``"auto"`` qualification
is TPU-only in the JAX package, and the port's CUDA gate keeps it off);
otherwise the ``standard`` path runs, whose phases walk the backend's
own plan registries. Every completed solve ends in
``observe.finalize_solve``: the roofline on ``stats.roofline`` and, with
a profile store configured, its plan, solve and trajectory records.
With ``SolverConfig.telemetry`` set, every public entry point, phase,
stage attempt, finalize and checkpoint write is a flight-recorder span
(``utils.telemetry``), with the JAX package's span and event names.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import sys
import time
import traceback
import types
import warnings
from typing import Any

import numpy as np
import torch

from paralleljohnson_tpu_torch import observe, planner
from paralleljohnson_tpu_torch.backends import Backend, get_backend
from paralleljohnson_tpu_torch.backends.base import KernelResult
from paralleljohnson_tpu_torch.config import SolverConfig
from paralleljohnson_tpu_torch.graphs import CSRGraph, stack_graphs
from paralleljohnson_tpu_torch.observe.live import resolve_metrics
from paralleljohnson_tpu_torch.observe.trace import trace_attrs as _trace_attrs
from paralleljohnson_tpu_torch.utils import resilience
from paralleljohnson_tpu_torch.utils.metrics import (
    SolverStats,
    Span,
    phase_timer,
    program_span,
)
from paralleljohnson_tpu_torch.utils.reductions import finite_checksum, xp as _xp
from paralleljohnson_tpu_torch.utils.telemetry import resolve as _resolve_telemetry


def _transient_error(e: BaseException) -> bool:
    """Worth a plain (same-resource) retry: an injected stage failure.
    A real CUDA error is not retried: it is sticky (the context stays
    failed), so a retry reproduces it. Deterministic solver errors
    (NegativeCycleError, ConvergenceError, ValueError,
    SolveCorruptionError) are excluded too — re-running them reproduces
    them."""
    return type(e).__name__ == "InjectedFaultError"


class NegativeCycleError(ValueError):
    """The graph contains a cycle of negative total weight; shortest paths
    are undefined. Raised host-side from the device-computed flag."""


class ConvergenceError(RuntimeError):
    """A relaxation kernel hit its iteration cap (``max_iterations`` set
    below the graph's convergence depth) while distances were still
    improving. Distinct from a negative cycle: raise the cap and retry."""


class ValidationError(AssertionError):
    """config.validate=True cross-check against the scipy oracle failed."""


def to_numpy(x, telemetry=None) -> np.ndarray:
    """Host copy of a tensor (any device) or array. A tensor whose copy
    the backend staged (``TorchBackend.stage_rows_async``) yields that
    page-locked copy once it has landed. A tensor's copy is a
    ``pj.host_table`` span (``bytes``, ``staged``)."""
    if isinstance(x, torch.Tensor):
        staged = getattr(x, "staged_copy", None)
        with program_span(Span.HOST_TABLE, telemetry,
                          bytes=x.nbytes, staged=staged is not None):
            if staged is not None:
                return staged.wait()
            return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class SolveResult:
    """APSP / fan-out result.

    dist: [N_sources, V] distance rows (+inf unreachable); row i holds the
      distances from ``sources[i]``. A single-batch solve on a device
      backend leaves the rows on the device as a tensor; multi-batch and
      checkpointed solves return a host numpy array (:func:`to_numpy`
      materializes either).
    sources: the source vertex of each row.
    potentials: Johnson potentials h(v) (a device tensor when phase 1 ran,
      numpy zeros when no weight is negative).
    stats: per-phase wall-clock, iteration counts, edges-relaxed totals.
    predecessors: [N_sources, V] int32 shortest-path-tree rows (-1 =
      source / unreachable) when the solve ran with ``predecessors=True``,
      else None; in the same memory as ``dist``.
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

    def rows_by_source(self) -> dict:
        """Source vertex -> its distance row, in whatever memory ``dist``
        lives (device rows stay on the device — no implicit download)."""
        return {int(s): self.dist[i] for i, s in enumerate(self.sources)}

    def path(self, source: int, target: int) -> list[int]:
        """Vertex sequence of a shortest ``source -> target`` path (empty if
        unreachable). Requires a ``predecessors=True`` solve."""
        if self.predecessors is None:
            raise ValueError("solve was run without predecessors=True")
        from paralleljohnson_tpu_torch.utils.paths import reconstruct_path

        rows = np.flatnonzero(self.sources == source)
        if rows.size == 0:
            raise ValueError(f"vertex {source} was not a solve source")
        return reconstruct_path(
            to_numpy(self.predecessors[rows[0]]), source, target
        )


@dataclasses.dataclass
class ReducedResult:
    """Result of :meth:`ParallelJohnsonSolver.solve_reduced` — per-batch
    reduction values instead of distance rows (streaming mode)."""

    values: list
    sources: np.ndarray
    potentials: Any
    stats: SolverStats


def _reduce_checksum(rows, batch):
    return finite_checksum(rows)


def _reduce_eccentricity(rows, batch):
    xp = _xp(rows)
    return to_numpy(xp.amax(xp.where(xp.isfinite(rows), rows, -xp.inf),
                            axis=1))


def _reduce_reach_count(rows, batch):
    xp = _xp(rows)
    return to_numpy(xp.isfinite(rows).sum(axis=1))


_ROW_REDUCERS = {
    "checksum": _reduce_checksum,
    "eccentricity": _reduce_eccentricity,
    "reach_count": _reduce_reach_count,
}


def _unreweight(rows, h, row_sources):
    """Phase-3 arithmetic d(u,v) = (d'(u,v) - h(u)) + h(v), in the
    namespace where ``rows`` live (host rows get a host h; device rows a
    device h). +inf - h + h stays +inf (h is always finite).
    Single source of truth for solve() and solve_reduced()."""
    if isinstance(rows, np.ndarray):
        hh = to_numpy(h)
        return rows - hh[row_sources][:, None] + hh[None, :]
    hh = torch.as_tensor(h).to(rows.device, rows.dtype)
    idx = torch.as_tensor(np.asarray(row_sources), dtype=torch.int64)
    return rows - hh[idx.to(rows.device)][:, None] + hh[None, :]


def _qual_condensed(ctx) -> tuple[bool, str]:
    """The reference's solver-level qualification of the condensed route.
    ``True`` forces it and ``False`` pins the standard route. ``"auto"``
    engages in the reference only on a TPU with its own backend (the
    dense core pays on the matrix unit there); the port's CUDA gate keeps
    it off on every device (forced on a 64x64 grid on an NVIDIA H100 80GB
    HBM3 at 700 W it took 11-17x the standard solve, PERF.md §6)."""
    if getattr(ctx.solver, "_partitioned_disabled", False):
        return False, (
            "condensed route disabled for this solver instance "
            "(earlier auto-route failure)"
        )
    flag = ctx.config.partitioned
    if flag is False:
        return False, "partitioned=False pins the standard route"
    if flag is True:
        return True, "partitioned=True forces the condensed route"
    return False, ("the port's CUDA gate: auto condensed is TPU-gated in "
                   "the JAX package, off here")


# The solver-level plans: the condensed route against the standard
# Johnson path, walked with ``planner.select`` like every kernel family
# (the JAX package's names, priorities, price routes and tunables).
SOLVER_PLANS = [
    planner.Plan(
        name="condensed+fw", entry="solver", priority=10,
        qualify=_qual_condensed,
        price_routes=("condensed+fw",),
        forced=lambda cfg: getattr(cfg, "partitioned", False) is True,
        force_overrides={"partitioned": True},
        tunables=("fw_tile", "partition_parts"),
    ),
    planner.Plan(
        name="standard", entry="solver", priority=20,
        qualify=lambda ctx: (True, "unconditional standard Johnson path"),
        # The standard path's fan-out route is decided one layer down
        # (the backend's FANOUT_PLANS); the first calibrated tag in the
        # reference's order stands in for it here.
        price_routes=(
            "vm-blocked+dw", "vm-blocked", "gs", "dia", "vm",
            "sweep-sm", "fw",
        ),
        forced=lambda cfg: getattr(cfg, "partitioned", True) is False,
        force_overrides={"partitioned": False},
        tunables=("source_batch", "pipeline_depth"),
    ),
]


# Row blocks at least this large make the solver clear the backend's
# rebuildable device caches before the host download / reduction
# materializes them, so the layout caches and the download never hold
# device memory together at full scale (the JAX package's rule).
_DOWNLOAD_CLEAR_MIN_BYTES = 1 << 30


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
        # The flight-recorder façade every stage is wired through; the
        # falsy NULL_TELEMETRY by default, whose calls are no-ops.
        self._tel = _resolve_telemetry(self.config.telemetry)
        # Live-metrics registry (``observe.live``): the batch loop streams
        # per-batch wall and retry / OOM counts into it.
        self._metrics = resolve_metrics(self.config.metrics)

    def close(self) -> None:
        """Close the backend's meshes (``Backend.close``);
        the solver stays usable. Also on leaving a ``with`` block."""
        self.backend.close()

    def __enter__(self) -> "ParallelJohnsonSolver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_supported(self) -> None:
        device = getattr(self.backend, "device", torch.device("cpu"))
        bad = self.config.unsupported(torch.device(device).type)
        if bad:
            raise NotImplementedError(
                "not ported to paralleljohnson_tpu_torch yet: " + ", ".join(bad)
            )

    # -- public API ---------------------------------------------------------

    def solve(
        self,
        graph: CSRGraph,
        sources: np.ndarray | None = None,
        *,
        predecessors: bool = False,
    ) -> SolveResult:
        """Full Johnson APSP (or the given source subset).

        ``predecessors=True`` also returns shortest-path trees
        (:attr:`SolveResult.predecessors`): one extraction pass per batch
        after the fan-out (the backend's ``multi_source_pred``)."""
        self._check_supported()
        stats = SolverStats()
        v = graph.num_nodes
        sources = (
            np.arange(v, dtype=np.int64)
            if sources is None
            else np.asarray(sources, np.int64)
        )
        tel = self._tel
        tel.progress(op="solve", sources_total=len(sources))
        with program_span(Span.SOLVE, tel, op="solve",
                          n_sources=len(sources), predecessors=predecessors,
                          **_trace_attrs()):
            decision = self._solver_decision(graph, sources)
            if decision.chosen.plan.name == "condensed+fw":
                res = self._try_condensed(graph, sources, stats,
                                          predecessors, decision)
                if res is not None:
                    return res
            else:
                stats.plan = decision.as_dict()
            with phase_timer(stats, "upload", tel):
                dgraph = self.backend.upload(graph)
            h, dgraph = self._potentials(graph, dgraph, stats)
            # Phase 3 rides inside each batch's finalize, so checkpointed
            # rows are FINAL distances keyed by the ORIGINAL graph's
            # digest.
            with phase_timer(stats, "fanout", tel):
                dist, pred = self._fanout(dgraph, sources, stats,
                                          with_pred=predecessors,
                                          graph=graph, h=h)
            result = SolveResult(dist=dist, sources=sources, potentials=h,
                                 stats=stats, predecessors=pred)
            if self.config.validate:
                self._validate(graph, result)
            self._finish_observability(stats, graph, len(sources),
                                       label="solve")
            return result

    def solve_range(
        self,
        graph: CSRGraph,
        start: int,
        stop: int,
        *,
        predecessors: bool = False,
    ) -> SolveResult:
        """Johnson solve restricted to the contiguous source range
        ``[start, stop)`` — a fleet lease's unit of work, with
        checkpointing, resilience and pipelining unchanged."""
        v = graph.num_nodes
        if not 0 <= start < stop <= v:
            raise ValueError(
                f"source range [{start}, {stop}) is not a non-empty "
                f"subrange of [0, {v})"
            )
        return self.solve(
            graph,
            sources=np.arange(start, stop, dtype=np.int64),
            predecessors=predecessors,
        )

    def solve_reduced(
        self,
        graph: CSRGraph,
        sources: np.ndarray | None = None,
        *,
        reduce_rows,
    ) -> ReducedResult:
        """Johnson APSP with per-batch row reduction — the streaming mode
        for graphs whose distance matrix is never stored.

        ``reduce_rows(dist_rows, batch_sources)`` is called once per source
        batch with the UN-REWEIGHTED distance rows exactly as ``solve``
        would return them — still on the backend's device, so reductions
        written with torch run on the card and only their (small) results
        reach the host. Built-in names: ``"checksum"`` (sum of finite
        entries, float), ``"eccentricity"`` ([B] max finite distance per
        source), ``"reach_count"`` ([B] finite entries per row).

        Returns :class:`ReducedResult` with ``values`` = the per-batch
        results in batch order. Checkpointing is not applied (rows are
        never materialized), and ``config.validate`` is rejected: the
        scipy oracle would need the full matrix.
        """
        if self.config.validate:
            raise ValueError(
                "config.validate is incompatible with solve_reduced: "
                "streaming mode never materializes the rows the oracle "
                "check needs"
            )
        self._check_supported()
        if isinstance(reduce_rows, str):
            try:
                reduce_rows = _ROW_REDUCERS[reduce_rows]
            except KeyError:
                raise ValueError(
                    f"unknown reducer {reduce_rows!r}; expected one of "
                    f"{sorted(_ROW_REDUCERS)} or a callable"
                ) from None
        stats = SolverStats()
        v = graph.num_nodes
        sources = (
            np.arange(v, dtype=np.int64)
            if sources is None
            else np.asarray(sources, np.int64)
        )
        tel = self._tel
        tel.progress(op="solve_reduced", sources_total=len(sources))
        with program_span(Span.SOLVE, tel, op="solve_reduced",
                          n_sources=len(sources), **_trace_attrs()):
            return self._solve_reduced_body(graph, sources, stats,
                                            reduce_rows)

    def _solve_reduced_body(self, graph, sources, stats, reduce_rows):
        tel = self._tel
        with phase_timer(stats, "upload", tel):
            dgraph = self.backend.upload(graph)
        h, dgraph = self._potentials(graph, dgraph, stats)
        n_src = len(sources)

        def finalize(batch_idx, batch, res, resumed):
            """Un-reweight + reduce; on the pipeline's worker thread at
            depth > 1, behind the next batch's compute."""
            rows = res.dist
            if self._negative_arcs(graph):
                rows = _unreweight(rows, h, batch)
            # The download path's memory-hygiene gate: a reducer may
            # materialize the rows on the host.
            if (
                len(batch) < n_src
                and int(getattr(rows, "nbytes", 0) or 0)
                >= _DOWNLOAD_CLEAR_MIN_BYTES
            ):
                self.backend.clear_caches(dgraph)
            return reduce_rows(rows, batch)

        values = []
        with phase_timer(stats, "fanout", tel):
            for _, _, value, _ in self._resilient_batches(
                dgraph, sources, stats, finalize=finalize
            ):
                values.append(value)
        self._finish_observability(stats, graph, n_src,
                                   label="solve_reduced")
        return ReducedResult(
            values=values, sources=sources, potentials=h, stats=stats
        )

    def sssp(
        self, graph: CSRGraph, source: int, *, predecessors: bool = False
    ) -> SolveResult:
        """Standalone Bellman-Ford SSSP — negative weights allowed, no
        reweighting."""
        self._check_supported()
        stats = SolverStats()
        tel = self._tel
        tel.progress(op="sssp", source=int(source))
        with program_span(Span.SOLVE, tel, op="sssp", source=int(source),
                          **_trace_attrs()):
            return self._sssp_body(graph, source, predecessors, stats)

    def _sssp_body(self, graph, source, predecessors, stats):
        tel = self._tel
        with phase_timer(stats, "upload", tel):
            dgraph = self.backend.upload(graph)
        with phase_timer(stats, "bellman_ford", tel):
            bf = self._run_bf(dgraph, stats, source=int(source),
                              pred=predecessors)
        if bf.negative_cycle:
            raise NegativeCycleError("negative-weight cycle reachable from source")
        if not bf.converged:
            raise ConvergenceError(
                "Bellman-Ford hit max_iterations while still improving"
            )
        self._finish_observability(stats, graph, 1, label="sssp")
        return SolveResult(
            dist=bf.dist[None, :],
            sources=np.array([source]),
            potentials=np.zeros(graph.num_nodes, graph.dtype),
            stats=stats,
            predecessors=None if bf.pred is None else bf.pred[None, :],
        )

    def multi_source(
        self,
        graph: CSRGraph,
        sources: np.ndarray,
        *,
        predecessors: bool = False,
    ) -> SolveResult:
        """Standalone batched N-source fan-out on a non-negative graph."""
        if self._negative_arcs(graph):
            raise ValueError(
                "multi_source requires non-negative weights; use solve()"
            )
        self._check_supported()
        stats = SolverStats()
        sources = np.asarray(sources, np.int64)
        tel = self._tel
        tel.progress(op="multi_source", sources_total=len(sources))
        with program_span(Span.SOLVE, tel, op="multi_source",
                          n_sources=len(sources), **_trace_attrs()):
            with phase_timer(stats, "upload", tel):
                dgraph = self.backend.upload(graph)
            with phase_timer(stats, "fanout", tel):
                dist, pred = self._fanout(dgraph, sources, stats,
                                          with_pred=predecessors,
                                          graph=graph)
            self._finish_observability(stats, graph, len(sources),
                                       label="multi_source")
        return SolveResult(
            dist=dist,
            sources=sources,
            potentials=np.zeros(graph.num_nodes, graph.dtype),
            stats=stats,
            predecessors=pred,
        )

    def solve_batch(self, graphs: list[CSRGraph]) -> list[SolveResult]:
        """Many-small-graphs mode: APSP for each graph in one vectorized
        run when the backend supports it (the torch backend's
        ``batch_apsp``: one fan-out over the batch's disjoint union, route
        ``batch-vmapped``), else one ``solve`` per graph."""
        self._check_supported()
        stats = SolverStats()
        try:
            with phase_timer(stats, "batch_apsp", self._tel):
                batch = stack_graphs(graphs)
                res = resilience.run_stage(
                    lambda: self.backend.batch_apsp(batch),
                    stage="batch_apsp",
                    policy=self.config.retry_policy(),
                    stats=stats,
                    faults=self.config.fault_plan,
                    retryable=_transient_error,
                    telemetry=self._tel,
                )
        except NotImplementedError:
            return [self.solve(g) for g in graphs]
        stats.accumulate(res, phase="batch_apsp")
        if res.negative_cycle:
            raise NegativeCycleError("negative cycle in at least one batch graph")
        dist = to_numpy(res.dist)
        return [
            SolveResult(
                dist=dist[i, :g.num_nodes, :g.num_nodes],
                sources=np.arange(g.num_nodes),
                potentials=np.zeros(g.num_nodes, g.dtype),
                stats=stats,
            )
            for i, g in enumerate(graphs)
        ]

    # -- internals ----------------------------------------------------------

    def _solver_model(self):
        """The fitted ``CostModel`` of the solver-level walk, or None (the
        declared priority order): cached per records-list identity, as the
        backend's ``_planner_model``."""
        if self.config.planner is False:
            return None
        store_dir = observe.resolve_profile_dir(self.config.profile_store)
        if not store_dir:
            return None
        records = observe.cached_records(store_dir)
        if not records:
            return None
        cached = getattr(self, "_solver_model_cache", None)
        if cached is not None and cached[0] is records:
            return cached[1]
        model = observe.CostModel.fit(records)
        self._solver_model_cache = (records, model)
        return model

    def _platform(self) -> str:
        return observe.current_platform(getattr(self.backend, "device", None))

    def _solver_decision(self, graph: CSRGraph, sources: np.ndarray):
        """The solver-level decision: :data:`SOLVER_PLANS` walked through
        ``planner.select``."""
        ctx = types.SimpleNamespace(solver=self, graph=graph, sources=sources,
                                    config=self.config, params={})
        with program_span(Span.SOLVE_PLAN, self._tel):
            return planner.select(
                SOLVER_PLANS, ctx, model=self._solver_model(),
                platform=self._platform(), num_edges=graph.num_real_edges,
                batch=len(sources), config=self.config)

    def _use_partitioned(self, graph: CSRGraph,
                         sources: np.ndarray) -> tuple[bool, str]:
        """Whether the condensed route takes this solve, and why: a view
        over the :data:`SOLVER_PLANS` walk."""
        decision = self._solver_decision(graph, sources)
        cand = next(c for c in decision.candidates
                    if c.plan.name == "condensed+fw")
        return decision.chosen.plan.name == "condensed+fw", cand.reason

    def _emit_trajectory(self, res, *, stage: str, batch=None) -> None:
        """One ``trajectory`` flight event and heartbeat push per
        instrumented kernel stage: the summary numbers, a downsampled
        frontier-collapse curve, and the live ``iter`` /
        ``frontier_size`` heartbeat fields. No-op when the route carried
        no trajectory or telemetry is off; never fatal."""
        summ = getattr(res, "convergence", None)
        if not summ or not self._tel:
            return
        try:
            attrs = dict(
                stage=stage,
                route=res.route,
                iterations=summ.get("iterations"),
                frontier_half_life=summ.get("frontier_half_life"),
                frontier_peak=summ.get("frontier_peak"),
                frontier_last=summ.get("frontier_last"),
                tail_fraction=round(float(summ.get("tail_fraction", 0.0)), 4),
                jfr_skippable_edge_frac=round(
                    float(summ.get("jfr_skippable_edge_frac", 0.0)), 4),
            )
            if batch is not None:
                attrs["batch"] = batch
            traj = getattr(res, "trajectory", None)
            if traj is not None:
                attrs["frontier_curve"] = observe.frontier_curve(traj)
            self._tel.event("trajectory", **attrs)
            self._tel.note(iter=summ.get("iterations"),
                           frontier_size=summ.get("frontier_last"))
        except Exception:  # noqa: BLE001 — observability is never fatal
            pass

    def _finish_observability(self, stats: SolverStats, graph: CSRGraph,
                              batch: int, *, label: str) -> None:
        """``observe.finalize_solve`` for a completed solve: the roofline
        on ``stats.roofline`` and, with a profile store, the prediction
        and the records. Observability never fails a solve that already
        computed its distances: an error here is reported as a warning.
        The degree bias, which only the store's trajectory records read,
        is computed only where a store is configured."""
        with program_span(Span.SOLVE_OBSERVE, self._tel):
            try:
                store = observe.resolve_profile_dir(self.config.profile_store)
                observe.finalize_solve(
                    stats, config=self.config,
                    device=getattr(self.backend, "device", None),
                    telemetry=self._tel if self._tel else None, label=label,
                    num_nodes=graph.num_nodes,
                    num_edges=graph.num_real_edges, batch=batch,
                    degree_bias=observe.degree_bias_from_degrees(
                        np.diff(graph.indptr)) if store else None)
            except Exception as e:  # noqa: BLE001 — never fatal
                warnings.warn(
                    f"profile records dropped: {type(e).__name__}: {e}",
                    RuntimeWarning, stacklevel=2)

    def _try_condensed(self, graph: CSRGraph, sources: np.ndarray,
                       stats: SolverStats, predecessors: bool,
                       decision) -> SolveResult | None:
        """One condensed solve (``solver.partitioned``) on the backend's
        device. Returns None to hand the solve back to the standard route:
        an auto-route failure (warned once, then disabled for this solver
        instance) or a tree check that rejected the one-pass extraction.
        A forced ``partitioned=True`` propagates errors instead; a
        negative cycle always raises."""
        from paralleljohnson_tpu_torch.solver.partitioned import (
            solve_condensed,
        )

        try:
            with phase_timer(stats, "fanout", self._tel):
                dist, pred, info = solve_condensed(
                    graph, sources, config=self.config,
                    predecessors=predecessors,
                    device=self.backend.device,
                )
        except NegativeCycleError:
            raise
        except Exception:
            if self.config.partitioned is True:
                raise
            if not getattr(self, "_partitioned_disabled", False):
                self._partitioned_disabled = True
                warnings.warn(
                    "condensed partitioned route failed; falling back to "
                    "the standard solve path for this solver instance",
                    RuntimeWarning, stacklevel=2)
                traceback.print_exc(file=sys.stderr)
            return None
        if predecessors and pred is None:
            warnings.warn(
                "condensed route could not extract predecessor trees "
                "(tree check rejected the one-pass rule); re-solving "
                "through the standard route", RuntimeWarning, stacklevel=2)
            return None
        # The dominant dense closures priced as the fw route is (ops.fw's
        # tile model): operations from the exact MAC total, bytes from the
        # model's bytes per MAC at the core's tile.
        from paralleljohnson_tpu_torch.ops import fw as fw_ops

        tile = fw_ops.effective_tile(max(info["core_size"], 1),
                                     info["params"]["fw_tile"])
        capture = getattr(self.backend, "cost_capture", None)
        cost = None if capture is None else capture.analytic(
            info["route"],
            {"flops": 2.0 * info["macs"],
             "bytes_accessed": 4.0 * np.dtype(graph.dtype).itemsize
             * info["macs"] / tile},
            num_nodes=graph.num_nodes, num_edges=graph.num_real_edges,
            batch=len(sources))
        stats.accumulate(
            KernelResult(
                dist=dist,
                converged=True,
                iterations=info["k_steps"],
                edges_relaxed=info["macs"],
                route=info["route"],
                cost=cost,
            ),
            phase="fanout",
        )
        self._tel.event("route", stage="fanout", route=info["route"])
        cand = decision.chosen
        stats.plan = {
            **decision.as_dict(),
            # The qualification's own words first ("... forces ..."), then
            # the walk's.
            "reason": f"{cand.reason}; {decision.reason}",
            **{k: info[k] for k in ("params", "params_source", "num_parts",
                                    "core_size", "seconds")},
        }
        result = SolveResult(
            dist=dist,
            sources=sources,
            potentials=np.zeros(graph.num_nodes, graph.dtype),
            stats=stats,
            predecessors=pred,
        )
        if self.config.validate:
            self._validate(graph, result)
        self._finish_observability(stats, graph, len(sources), label="solve")
        return result

    def _run_bf(self, dgraph: Any, stats: SolverStats, *,
                source: int | None, pred: bool = False):
        """One Bellman-Ford stage through the resilience layer (with the
        shortest-path tree when ``pred``): bounded retries with the
        watchdog deadline; a B=1 sweep has no batch to shrink, so an OOM
        frees the rebuildable device caches and retries with the memory
        they held. Converged non-cycle distances pass the sanity guard
        before anyone consumes them."""

        def kernel():
            if pred:
                return self.backend.bellman_ford_pred(dgraph, source=source)
            return self.backend.bellman_ford(dgraph, source=source)

        def retryable(e):
            if resilience.is_oom_error(e):
                try:
                    self.backend.clear_caches(dgraph)
                except Exception:  # noqa: BLE001 — hygiene only
                    pass
                return True
            return _transient_error(e)

        faults = self.config.fault_plan
        bf = resilience.run_stage(
            kernel,
            stage="bellman_ford",
            policy=self.config.retry_policy(),
            stats=stats,
            faults=faults,
            retryable=retryable,
            telemetry=self._tel,
        )
        stats.accumulate(bf, phase="bellman_ford")
        # Route marker: the stage spans above opened before dispatch
        # resolved a route, so the tag lands as an event.
        self._tel.event("route", stage="bellman_ford", route=bf.route)
        self._emit_trajectory(bf, stage="bellman_ford")
        if faults is not None:
            bf.dist = faults.poison_rows("bellman_ford", bf.dist)
        if bf.converged and not bf.negative_cycle:
            resilience.check_rows_sane(
                bf.dist, None, route=bf.route,
                iteration=bf.iterations, stage="bellman_ford",
            )
        return bf

    def _negative_arcs(self, graph: CSRGraph) -> bool:
        """Whether ``graph`` has a negative arc: a scan of every weight,
        which decides phase 1 and the un-reweight, in a
        ``pj.solve.potentials`` span."""
        with program_span(Span.SOLVE_POTENTIALS, self._tel):
            return graph.has_negative_weights

    def _potentials(self, graph: CSRGraph, dgraph: Any, stats: SolverStats):
        """Phase 1 + reweight: returns (h, reweighted dgraph). h stays on
        the backend's device. No negative weights -> h = 0 is already
        valid, skip."""
        if not self._negative_arcs(graph):
            return np.zeros(graph.num_nodes, graph.dtype), dgraph
        with phase_timer(stats, "bellman_ford", self._tel):
            bf = self._run_bf(dgraph, stats, source=None)
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
        with phase_timer(stats, "reweight", self._tel):
            dgraph = self.backend.reweight(dgraph, h)
        return h, dgraph

    def _pipeline_depth(self, dgraph: Any = None) -> int:
        """The fan-out pipeline depth: the backend's own resolution where
        it has one (the torch backend budgets its memory carry slots from
        the same number, so the window and the budget agree), else
        ``config.pipeline_depth``, else the profile-tuned depth for this
        (platform, shape bucket), else ``DEFAULT_PIPELINE_DEPTH``."""
        resolver = getattr(self.backend, "_pipeline_depth", None)
        if resolver is not None and dgraph is not None:
            return int(resolver(dgraph))
        value, _ = observe.resolve_param(
            "pipeline_depth", self.config.pipeline_depth,
            observe.DEFAULT_PIPELINE_DEPTH, config=self.config,
            platform=self._platform(),
            num_nodes=int(getattr(dgraph, "num_nodes", 0) or 0),
            num_edges=int(getattr(dgraph, "num_real_edges", 0) or 0),
            validate=lambda d: isinstance(d, int) and d >= 1)
        return max(1, int(value))

    def _initial_batch_size(self, sources: np.ndarray, dgraph: Any = None, *,
                            with_pred: bool = False) -> int:
        """Starting fan-out batch size: the explicit config value, else
        the backend's fits-memory heuristic (``with_pred`` budgets the
        int32 [B, V] pred block and the extraction's temporaries too).
        The OOM degrader may shrink it mid-solve (``_resilient_batches``)."""
        bs = self.config.source_batch_size
        if bs is None and dgraph is not None:
            bs = self.backend.suggested_source_batch(dgraph,
                                                     with_pred=with_pred)
            # A profile-tuned batch refines the budget's, which stays a
            # hard cap (a tuned value must not bring back the OOMs the
            # budget prevents).
            tuned, source = observe.resolve_param(
                "source_batch", None, None, config=self.config,
                platform=self._platform(),
                num_nodes=int(getattr(dgraph, "num_nodes", 0) or 0),
                num_edges=int(getattr(dgraph, "num_real_edges", 0) or 0),
                validate=lambda b: isinstance(b, int) and b >= 1)
            if source == "profile-tuned" and bs:
                bs = min(int(tuned), int(bs))
        return int(bs or len(sources) or 1)

    def _resilient_batches(
        self,
        dgraph: Any,
        sources: np.ndarray,
        stats: SolverStats,
        *,
        with_pred: bool = False,
        try_resume=None,
        finalize=None,
        stage_async=None,
    ):
        """Drive the fan-out batch loop through the resilience layer as a
        pipeline (``multi_source_pred`` per batch when ``with_pred``).

        Yields ``(batch_idx, batch, result, resumed)`` per batch, in batch
        order. When a ``finalize`` stage is given (the download /
        checkpoint / streaming-reduce step), ``result`` is its return
        value; otherwise the raw payload — the checkpointer's cached rows
        when ``resumed``, else the backend's KernelResult.

        Pipeline (``pipeline_depth`` = max batches in flight; 1 = the
        strictly serial loop, bitwise-identical results either way):

        - batch k's ``finalize`` runs on a single background worker while
          batch k+1's device compute proceeds on this thread
          (``stage_async`` starts the device-to-host copy before the
          worker even picks the batch up);
        - at most ``pipeline_depth - 1`` finalizes sit in the window, each
          carrying one computed [B, V] block in device memory;
          ``suggested_source_batch`` budgets exactly that carry;
        - ``finalize`` runs under the SAME retry policy / watchdog
          deadline / fault plan as compute (stage ``"download"``);
        - on device OOM the window COLLAPSES to 1 first — the in-flight
          carry is the cheapest memory to give back — and only a repeat
          OOM halves the batch (clear caches, halve, floor
          ``min_source_batch``, resume the failed range);
        - converged rows pass the distance-sanity guard BEFORE any
          finalize can download or commit them; non-OOM background
          failures surface as ``SolveCorruptionError``.
        """
        policy = self.config.retry_policy()
        faults = self.config.fault_plan
        tel = self._tel
        degrader = resilience.OOMDegrader(
            self.backend,
            dgraph,
            self._initial_batch_size(sources, dgraph, with_pred=with_pred),
            min_batch=self.config.min_source_batch,
            with_pred=with_pred,
        )
        depth = self._pipeline_depth(dgraph) if finalize is not None else 1
        stats.final_pipeline_depth = depth
        n = len(sources)
        pos = 0
        batch_idx = 0
        done = 0
        t_solve0 = time.perf_counter()
        tel.progress(
            sources_total=n, sources_done=0, batches_done=0,
            current_batch_size=degrader.batch_size, pipeline_depth=depth,
        )
        # In-flight finalize window: (batch_idx, batch, payload, future).
        pending: collections.deque = collections.deque()
        worker = None
        metrics = self._metrics
        last_done_t = t_solve0
        counted = {"retries": 0, "oom": 0}

        def mark_done() -> None:
            """Heartbeat progress after one batch fully finalizes, the
            live metrics' per-batch wall and retry / OOM count deltas, and
            the completion estimate (``eta_s``)."""
            nonlocal done, last_done_t
            done += 1
            now_t = time.perf_counter()
            metrics.histogram("pjtpu_solver_batch_wall_ms").record(
                (now_t - last_done_t) * 1e3
            )
            last_done_t = now_t
            metrics.counter("pjtpu_solver_batches").add(1)
            if stats.retries > counted["retries"]:
                metrics.counter("pjtpu_solver_retries").add(
                    stats.retries - counted["retries"]
                )
                counted["retries"] = stats.retries
            if stats.oom_degradations > counted["oom"]:
                metrics.counter("pjtpu_solver_oom_degradations").add(
                    stats.oom_degradations - counted["oom"]
                )
                counted["oom"] = stats.oom_degradations
            tel.progress(
                batches_done=done, sources_done=pos,
                current_batch_size=degrader.batch_size,
                retries=stats.retries,
                oom_degradations=stats.oom_degradations,
                pipeline_depth=depth,
            )
            if tel:
                remaining = -(-(n - pos) // max(degrader.batch_size, 1))
                eta = observe.estimate_eta(
                    time.perf_counter() - t_solve0, done, remaining
                )
                if eta is not None:
                    tel.note(eta_s=round(eta, 3))

        def run_finalize(bi, b, payload, resumed, parent=None):
            """One finalize, timed, through the resilience layer (stage
            "download"). Returns (result, duration) so the drain can price
            the overlap. ``parent``: the span to nest under when running
            on the pipeline worker (captured at submit)."""
            if finalize is None:
                return payload, 0.0
            with program_span(Span.FANOUT_FINALIZE, tel, batch=bi,
                              parent=parent, resumed=resumed,
                              **_trace_attrs()):
                if resumed:
                    return finalize(bi, b, payload, True), 0.0
                t0 = time.perf_counter()
                out = resilience.run_stage(
                    lambda: finalize(bi, b, payload, False),
                    stage="download",
                    policy=policy,
                    stats=stats,
                    faults=faults,
                    batch=bi,
                    retryable=_transient_error,
                    telemetry=tel,
                )
                dur = time.perf_counter() - t0
                stats.download_s += dur
                return out, dur

        def collapse_window() -> None:
            """OOM step 0: go serial — give back the in-flight [B, V]
            carry before any batch halving."""
            nonlocal depth
            depth = 1
            stats.final_pipeline_depth = 1
            tel.event("window_collapse")
            tel.progress(pipeline_depth=1)
            try:
                self.backend.clear_caches(dgraph)
            except Exception:  # noqa: BLE001 — hygiene must not mask
                pass

        def drain_one():
            """Wait for the oldest staged finalize; account the blocked
            time (ckpt_wait_s) and the hidden time (overlap_saved_s)."""
            bi, b, payload, fut = pending.popleft()
            t0 = time.perf_counter()
            try:
                out, dur = fut.result()
            except Exception as e:
                stats.ckpt_wait_s += time.perf_counter() - t0
                if resilience.is_oom_error(e):
                    if depth > 1:
                        # The staged materialization itself OOMed: give
                        # back the window and retry THIS finalize
                        # serially before anything harsher.
                        collapse_window()
                        out, _ = run_finalize(bi, b, payload, False)
                        return bi, b, out, False
                    raise
                if isinstance(
                    e,
                    (
                        resilience.StageAbandonedError,
                        resilience.SolveCorruptionError,
                    ),
                ):
                    raise
                raise resilience.SolveCorruptionError(
                    f"pipelined download/checkpoint stage failed for "
                    f"batch {bi}: {type(e).__name__}: {e}"
                ) from e
            wait = time.perf_counter() - t0
            stats.ckpt_wait_s += wait
            stats.overlap_saved_s += max(0.0, dur - wait)
            return bi, b, out, False

        def run_batch(bi, batch):
            """One batch's kernel stage, its checks and its finalize (inline,
            or submitted to the pipeline's worker), in a ``pj.fanout.batch``
            span that closes before the loop yields. Returns (the device OOM
            that stopped it or None, whether the finalize was submitted, the
            inline finalize's result)."""
            nonlocal worker

            def kernel():
                if with_pred:
                    return self.backend.multi_source_pred(dgraph, batch)
                return self.backend.multi_source(dgraph, batch)

            with program_span(Span.FANOUT_BATCH, tel, batch=bi,
                              width=len(batch)):
                try:
                    res = resilience.run_stage(
                        kernel,
                        stage="fanout",
                        policy=policy,
                        stats=stats,
                        faults=faults,
                        batch=bi,
                        retryable=_transient_error,
                        telemetry=tel,
                    )
                except Exception as e:
                    if resilience.is_oom_error(e):
                        return e, False, None
                    raise
                stats.accumulate(res, phase="fanout")
                # Route marker for this batch's stage spans (see _run_bf).
                tel.event("route", stage="fanout", batch=bi, route=res.route)
                self._emit_trajectory(res, stage="fanout", batch=bi)
                if not res.converged:
                    raise ConvergenceError(
                        "fan-out hit max_iterations while still improving"
                    )
                if faults is not None:
                    res.dist = faults.poison_rows("fanout", res.dist, batch=bi)
                resilience.check_rows_sane(
                    res.dist, batch, route=res.route, iteration=res.iterations
                )
                # A batch with nothing to overlap against (the only batch
                # of the solve) stays inline — single-batch device solves
                # keep their rows resident.
                if depth > 1 and (pending or pos + len(batch) < n):
                    if stage_async is not None:
                        stage_async(res)
                    if worker is None:
                        worker = concurrent.futures.ThreadPoolExecutor(
                            max_workers=1, thread_name_prefix="pj-pipeline"
                        )
                    fut = worker.submit(
                        run_finalize, bi, batch, res, False,
                        tel.current_span_id(),
                    )
                    pending.append((bi, batch, res, fut))
                    return None, True, None
                out, _ = run_finalize(bi, batch, res, False)
                return None, False, out

        try:
            while pos < n:
                batch = sources[pos : pos + degrader.batch_size]
                if try_resume is not None:
                    cached = try_resume(batch_idx, batch)
                    if cached is not None:
                        while pending:  # keep yields in batch order
                            drained = drain_one()
                            mark_done()
                            yield drained
                        stats.batches_resumed += 1
                        tel.event("batch_resumed", batch=batch_idx)
                        out, _ = run_finalize(batch_idx, batch, cached, True)
                        pos += len(batch)
                        batch_idx += 1
                        mark_done()
                        yield batch_idx - 1, batch, out, True
                        continue

                oom, staged, out = run_batch(batch_idx, batch)
                if oom is not None:
                    if depth > 1:
                        del oom  # hold no failed batch's memory
                        while pending:  # commit the good in-flight work
                            drained = drain_one()
                            mark_done()
                            yield drained
                        collapse_window()
                        continue  # retry THIS batch serially, same size
                    old_size = degrader.batch_size
                    try:
                        degrader.degrade(oom)  # re-raises at the floor
                    finally:
                        del oom
                    stats.oom_degradations += 1
                    tel.event(
                        "oom_degrade", batch=batch_idx,
                        old_batch=old_size, new_batch=degrader.batch_size,
                    )
                    tel.progress(
                        oom_degradations=stats.oom_degradations,
                        current_batch_size=degrader.batch_size,
                    )
                    continue  # re-split THIS range smaller; pos unchanged
                pos += len(batch)
                batch_idx += 1
                if staged:
                    while len(pending) >= depth:
                        drained = drain_one()
                        mark_done()
                        yield drained
                else:
                    mark_done()
                    yield batch_idx - 1, batch, out, False
            while pending:
                drained = drain_one()
                mark_done()
                yield drained
            stats.final_batch = degrader.batch_size
        finally:
            if worker is not None:
                worker.shutdown(wait=True, cancel_futures=True)

    def _download_rows(self, dgraph: Any, rows, pred=None):
        """Materialize one batch's device rows (and pred rows, or None) on
        the host as (rows, pred), clearing the backend's rebuildable device
        caches first when the blocks are large
        (``_DOWNLOAD_CLEAR_MIN_BYTES``). Rows the pipeline staged already
        have their copy under way; others start theirs here (the same
        page-locked copy, waited for at once)."""
        nbytes = sum(int(getattr(x, "nbytes", 0) or 0) for x in (rows, pred))
        if nbytes >= _DOWNLOAD_CLEAR_MIN_BYTES:
            self.backend.clear_caches(dgraph)
        self.backend.stage_rows_async(rows, pred)
        return (to_numpy(rows, self._tel),
                None if pred is None else to_numpy(pred, self._tel))

    def _fanout(
        self,
        dgraph: Any,
        sources: np.ndarray,
        stats: SolverStats,
        *,
        with_pred: bool = False,
        graph: CSRGraph,
        h=None,
    ):
        """Run phase 2 in source batches; optionally checkpoint each batch
        (the batch is the unit of recovery). Checkpoints are keyed by the
        ORIGINAL graph's content, with the un-reweight (``h``) applied per
        batch BEFORE the save: what lands on disk is final distances (and
        the pred block, which the un-reweight leaves alone: tight edges of
        the reweighted graph are tight in the original). The loop runs
        through the pipelined resilience driver (``_resilient_batches``);
        the solve does not return until the checkpoint writer's flush
        barrier confirms every commit. Returns (distance rows, pred rows or
        None): device rows for a single uncheckpointed batch, else host
        arrays."""
        from paralleljohnson_tpu_torch.utils.checkpoint import (
            AsyncCheckpointWriter,
            BatchCheckpointer,
            checked_save,
        )

        unreweight = h is not None and self._negative_arcs(graph)
        ckpt = None
        try_resume = None
        if self.config.checkpoint_dir:
            ckpt = BatchCheckpointer(self.config.checkpoint_dir, graph_key=graph)

            def try_resume(batch_idx, batch):
                return ckpt.load(batch_idx, batch, with_pred=with_pred)

        depth = self._pipeline_depth(dgraph)
        faults = self.config.fault_plan
        fault_hook = None
        if faults is not None:
            def fault_hook(batch_idx):
                active = faults.fire("ckpt_write", batch=batch_idx)
                if active is not None:
                    active.wrap(lambda: None)()

        writer = None
        if ckpt is not None and depth > 1:
            # Serialization + checksumming on a bounded background writer;
            # flush() below is the commit barrier.
            writer = AsyncCheckpointWriter(
                ckpt, max_pending=depth, fault_hook=fault_hook,
                telemetry=self._tel,
            )

        n_src = len(sources)

        def finalize(batch_idx, batch, payload, resumed):
            if resumed:
                return payload  # (rows, pred) host arrays from the checkpoint
            # A single-batch solve keeps the rows on the device;
            # multi-batch solves stream each batch to the host (batching
            # exists because all rows together exceed the device budget),
            # and a checkpoint needs host rows either way.
            row, pred = payload.dist, payload.pred
            if ckpt is not None or len(batch) < n_src:
                row, pred = self._download_rows(dgraph, row, pred)
                if unreweight:
                    row = _unreweight(row, h, batch)
                if writer is not None:
                    writer.submit(batch_idx, batch, row, pred=pred)
                elif ckpt is not None:
                    with self._tel.span("ckpt_write", batch=batch_idx):
                        checked_save(ckpt, batch_idx, batch, row, pred=pred,
                                     fault_hook=fault_hook)
            elif unreweight:
                row = _unreweight(row, h, batch)
            return row, pred

        def stage_async(res):
            # Start the device-to-host copy the moment the rows pass the
            # sanity guard — it then runs under the next batch's compute.
            self.backend.stage_rows_async(res.dist, res.pred)

        rows: list = []
        preds: list = []
        gen = self._resilient_batches(
            dgraph, sources, stats, with_pred=with_pred,
            try_resume=try_resume, finalize=finalize, stage_async=stage_async,
        )
        try:
            for _, _, (row, pred), _ in gen:
                rows.append(row)
                preds.append(pred)
            if writer is not None:
                # Commit barrier: every batch on disk before success.
                t0 = time.perf_counter()
                writer.flush()
                wait = time.perf_counter() - t0
                stats.ckpt_wait_s += wait
                stats.overlap_saved_s += max(0.0, writer.busy_s - wait)
        finally:
            gen.close()
            if writer is not None:
                # Teardown drains queued commits (completed batches stay
                # resumable even when the solve is dying) without raising
                # over the original error.
                writer.close()
        if len(rows) == 1:
            return rows[0], preds[0]
        return (np.concatenate(rows, axis=0),
                np.concatenate(preds, axis=0) if with_pred else None)

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
