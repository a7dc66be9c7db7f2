"""Instrumentation: per-phase wall-clock, iteration counts and the
edges-relaxed counters, with the JAX package's field names so a stats
dict reads the same from either package."""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from collections import defaultdict


def warn_if_counter_wrapped(rounds: int, inner_cap: int, *,
                            where: str) -> None:
    """Achievable-bound wrap guard for the int32 per-block GS iteration
    counters (``ops.gauss_seidel._gs_engine``): a block's total is
    bounded by 2 x outer_rounds x inner_cap, so the host-side count is
    exact while that bound stays below 2^31."""
    if 2 * int(rounds) * int(inner_cap) >= 1 << 31:
        warnings.warn(
            f"{where}: GS iteration counter may have wrapped "
            f"({int(rounds)} outer rounds x inner_cap {int(inner_cap)}): "
            "edges_relaxed is a lower bound, not exact",
            RuntimeWarning,
            stacklevel=3,
        )


def warn_if_traj_counter_wrapped(batch: int, num_nodes: int, *,
                                 where: str) -> None:
    """Addend wrap guard for the int32 convergence-trajectory counters
    (``observe.convergence``): one iteration's ``relaxations_applied``
    is bounded by batch x V labels, so a row is exact while that bound
    stays below 2^31. Past it the trajectory still records, with a
    warning that its counts are lower bounds."""
    if int(batch) * int(num_nodes) >= 1 << 31:
        warnings.warn(
            f"{where}: trajectory counter addend batch x V = "
            f"{int(batch)} x {int(num_nodes)} >= 2^31: frontier_size / "
            "relaxations_applied may have wrapped — treat the "
            "trajectory as a lower bound, not exact",
            RuntimeWarning,
            stacklevel=3,
        )


@dataclasses.dataclass
class SolverStats:
    """Accumulated per-solve instrumentation.

    phase_seconds: wall-clock per named phase (upload / bellman_ford /
      reweight / fanout). A phase that ends in a device-to-host read of a
      flag (every sweep loop does) includes the device time; one that
      only enqueues work does not.
    edges_relaxed: total edge relaxations across phases (a sweep counts
      every edge it scans x batch rows; the dense min-plus regimes count
      candidate min-plus operations).
    edges_relaxed_by_phase / iterations_by_phase: breakdowns.
    routes_by_phase: the kernel route of each phase, every distinct route
      in order of first appearance joined by "+".
    batches_resumed: source batches skipped via checkpoint resume.
    retries: stage attempts re-run after a transient failure (watchdog
      abandon or retryable error — ``utils.resilience.run_stage``).
    oom_degradations: times the fan-out batch was halved after a device
      OOM (``utils.resilience.OOMDegrader``).
    final_batch: the source-batch size the fan-out ENDED at (None until
      a fan-out runs; equals the starting size when nothing degraded).
    abandoned_stages: "<stage>[#b<batch>]@a<attempt>" tags of every
      attempt the watchdog logged-and-abandoned past its deadline.
    download_s: total wall-clock in the fan-out's download/finalize
      stage (host copy of device rows + checkpoint submit, or the
      streaming reducer). Serial (pipeline_depth=1) it sits on the
      critical path; pipelined it runs behind the next batch's compute.
    ckpt_wait_s: wall-clock the MAIN solve thread spent blocked on the
      pipeline — draining staged downloads and the checkpoint writer's
      flush barrier: the residual serial cost of the off-path work.
    overlap_saved_s: estimated wall-clock the pipeline removed from the
      critical path (background stage busy time minus the time the main
      thread waited on it, floored at 0 per batch); exactly 0 at
      pipeline_depth=1.
    final_pipeline_depth: the in-flight window the fan-out ENDED at
      (None until a fan-out runs): the configured depth, or 1 after an
      OOM collapsed the window (which happens BEFORE any batch halving).
    convergence: per-phase trajectory summaries
      (``observe.convergence.summarize_trajectory``; a multi-batch
      fan-out merges its batches with ``merge_summaries``). None unless
      ``SolverConfig(convergence=True)`` and a phase ran on a route that
      records (``sweep``, ``sweep-sm``, ``vm``, ``vm-blocked``, ``dia``,
      ``gs``, ``bucket``, as in the JAX package).
    trajectories: the decoded per-iteration ``[n, 3]`` arrays behind
      those summaries, by phase (one per kernel call); not in
      ``as_dict``.
    analytic_cost: the analytic bytes and operations of the solve's
      kernel calls (``observe.costs``), summed over every call, with
      ``captures`` (how many were priced), ``cost_sources`` and
      ``unavailable`` (the distinct markers of routes with no model).
      None unless a profile store is configured.
    roofline: the solve's roofline attribution
      (``observe.roofline.attribute_stats``): the bound ("hbm", "mxu",
      "host-io" or "unknown"), the bandwidth and compute floors and the
      reasoning. Set for every completed solve.
    predicted_s: the profile store's prediction for this solve's route
      and shape, made before this run's record landed (None without a
      store or a calibration).
    plan: the solver-level decision of ``solve()`` (``planner
      .PlanDecision.as_dict`` of the ``SOLVER_PLANS`` walk: ``chosen``
      "standard" or "condensed+fw", ``reason``, the ``candidates`` with
      their qualification reasons and prices); on the condensed route
      also its ``params`` and ``params_source``. None for the entry
      points without that walk.
    plans_by_phase: each phase's last kernel-route decision (the
      backend's ``FANOUT_PLANS`` / ``SSSP_PLANS`` walks: chosen plan,
      reason, candidates, resolved ``params``), by phase.
    """

    phase_seconds: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    edges_relaxed: int = 0
    edges_relaxed_by_phase: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int)
    )
    iterations_by_phase: dict = dataclasses.field(
        default_factory=lambda: defaultdict(int)
    )
    routes_by_phase: dict = dataclasses.field(default_factory=dict)
    batches_resumed: int = 0
    retries: int = 0
    oom_degradations: int = 0
    final_batch: int | None = None
    abandoned_stages: list = dataclasses.field(default_factory=list)
    download_s: float = 0.0
    ckpt_wait_s: float = 0.0
    overlap_saved_s: float = 0.0
    final_pipeline_depth: int | None = None
    analytic_cost: dict | None = None
    roofline: dict | None = None
    predicted_s: float | None = None
    convergence: dict | None = None
    trajectories: dict = dataclasses.field(default_factory=dict, repr=False)
    plan: dict | None = None
    plans_by_phase: dict = dataclasses.field(default_factory=dict)

    def accumulate(self, result, phase: str) -> None:
        """Fold one KernelResult into the totals."""
        self.edges_relaxed += int(result.edges_relaxed)
        self.edges_relaxed_by_phase[phase] += int(result.edges_relaxed)
        self.iterations_by_phase[phase] += int(result.iterations)
        self._accumulate_cost(getattr(result, "cost", None))
        self._accumulate_trajectory(result, phase)
        plan = getattr(result, "plan", None)
        if plan:
            self.plans_by_phase[phase] = plan  # the last decision wins
        route = getattr(result, "route", None)
        if route:
            prev = self.routes_by_phase.get(phase)
            if prev is None:
                self.routes_by_phase[phase] = route
            elif route not in prev.split("+"):
                self.routes_by_phase[phase] = prev + "+" + route

    def _accumulate_trajectory(self, result, phase: str) -> None:
        """Fold one KernelResult's trajectory: the curve joins
        ``trajectories[phase]``, the summary merges into
        ``convergence[phase]``."""
        traj = getattr(result, "trajectory", None)
        if traj is not None:
            self.trajectories.setdefault(phase, []).append(traj)
        summ = getattr(result, "convergence", None)
        if summ:
            from paralleljohnson_tpu_torch.observe.convergence import (
                merge_summaries,
            )

            conv = self.convergence if self.convergence is not None else {}
            conv[phase] = merge_summaries(conv.get(phase), summ)
            self.convergence = conv

    def _accumulate_cost(self, cost: dict | None) -> None:
        """Fold one KernelResult's cost record: every priced call adds
        its bytes and operations (a 4-batch fan-out moves its bytes 4
        times); the markers of unpriced routes are kept apart, so "cheap"
        and "unmeasured" are never confused."""
        if not cost:
            return
        acc = self.analytic_cost
        if acc is None:
            acc = self.analytic_cost = {
                "flops": 0.0, "bytes_accessed": 0.0,
                "transcendentals": 0.0, "captures": 0, "unavailable": [],
            }
        reason = cost.get("cost_analysis_unavailable")
        if reason is not None:
            if reason not in acc["unavailable"]:
                acc["unavailable"].append(reason)
            return
        for k in ("flops", "bytes_accessed", "transcendentals"):
            acc[k] += float(cost.get(k, 0.0))
        acc["captures"] += 1
        source = cost.get("cost_source")
        if source and source not in acc.setdefault("cost_sources", []):
            acc["cost_sources"].append(source)

    @property
    def total_seconds(self) -> float:
        return sum(self.phase_seconds.values())

    @property
    def compute_seconds(self) -> float:
        """Wall-clock in the numeric kernel phases."""
        return sum(
            s for k, s in self.phase_seconds.items()
            if k in ("bellman_ford", "fanout")
        )

    def edges_relaxed_per_second(self) -> float:
        compute = self.compute_seconds
        return self.edges_relaxed / compute if compute > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "phase_seconds": dict(self.phase_seconds),
            "edges_relaxed": self.edges_relaxed,
            "edges_relaxed_by_phase": dict(self.edges_relaxed_by_phase),
            "iterations_by_phase": dict(self.iterations_by_phase),
            "routes_by_phase": dict(self.routes_by_phase),
            "batches_resumed": self.batches_resumed,
            "retries": self.retries,
            "oom_degradations": self.oom_degradations,
            "final_batch": self.final_batch,
            "abandoned_stages": list(self.abandoned_stages),
            "download_s": self.download_s,
            "ckpt_wait_s": self.ckpt_wait_s,
            "overlap_saved_s": self.overlap_saved_s,
            "final_pipeline_depth": self.final_pipeline_depth,
            "analytic_cost": self.analytic_cost,
            "roofline": self.roofline,
            "predicted_s": self.predicted_s,
            "convergence": self.convergence,
            "plan": self.plan,
            "plans_by_phase": dict(self.plans_by_phase),
            "total_seconds": self.total_seconds,
            "edges_relaxed_per_sec": self.edges_relaxed_per_second(),
        }


@contextlib.contextmanager
def phase_timer(stats: SolverStats, phase: str, telemetry=None):
    """Times a phase and labels it for ``torch.profiler`` traces
    (``record_function``), so device kernels group under their phase;
    with a telemetry object threaded in (``utils.telemetry``), also a
    ``phase:<name>`` flight-recorder span and a heartbeat stage update.

    The accumulation is in a ``finally``: a phase whose body raises still
    lands its elapsed time in ``phase_seconds``."""
    import torch

    tel_span = contextlib.nullcontext()
    if telemetry:  # NULL_TELEMETRY is falsy: the disabled path skips this
        telemetry.progress(stage=phase)
        # "phase:" prefix: the fanout PHASE must not collide with the
        # per-batch "fanout" stage spans nested inside it.
        tel_span = telemetry.span(f"phase:{phase}", kind="phase")
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(phase), tel_span:
            yield
    finally:
        stats.phase_seconds[phase] += time.perf_counter() - t0
