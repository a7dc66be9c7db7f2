"""Instrumentation: per-phase wall-clock, iteration counts and the
edges-relaxed counters, with the JAX package's field names so a stats
dict reads the same from either package."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict


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
    final_batch: the source-batch size the fan-out ran at.
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
    final_batch: int | None = None

    def accumulate(self, result, phase: str) -> None:
        """Fold one KernelResult into the totals."""
        self.edges_relaxed += int(result.edges_relaxed)
        self.edges_relaxed_by_phase[phase] += int(result.edges_relaxed)
        self.iterations_by_phase[phase] += int(result.iterations)
        route = getattr(result, "route", None)
        if route:
            prev = self.routes_by_phase.get(phase)
            if prev is None:
                self.routes_by_phase[phase] = route
            elif route not in prev.split("+"):
                self.routes_by_phase[phase] = prev + "+" + route

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
            "final_batch": self.final_batch,
            "total_seconds": self.total_seconds,
            "edges_relaxed_per_sec": self.edges_relaxed_per_second(),
        }


@contextlib.contextmanager
def phase_timer(stats: SolverStats, phase: str):
    """Times a phase and labels it for ``torch.profiler`` traces
    (``record_function``), so device kernels group under their phase.

    The accumulation is in a ``finally``: a phase whose body raises still
    lands its elapsed time in ``phase_seconds``."""
    import torch

    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(phase):
            yield
    finally:
        stats.phase_seconds[phase] += time.perf_counter() - t0
