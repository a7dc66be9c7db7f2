"""Deterministic fault injection for the resilience layer.

Every recovery path in ``utils.resilience`` — retry, OOM batch
degradation, watchdog abandon, checkpoint resume, the distance-sanity
guard — must be exercisable in CPU tests without a card or a real OOM.
A :class:`FaultPlan` says exactly which attempt of which stage fails and
how:

    plan = FaultPlan([
        Fault(stage="fanout", kind="oom", attempt=1, batch=1),
        Fault(stage="fanout", kind="timeout", sleep_s=0.5),
        Fault(stage="fanout", kind="nan", batch=0),
    ])
    SolverConfig(..., fault_plan=plan)

Attempt counting is per (stage, batch) key and lives on the plan, so the
schedule is a pure function of the call sequence — replaying the same
solve replays the same failures (no wall-clock randomness anywhere). The
plan, its stage names and its kinds are the JAX package's, so one plan
drives both packages to the same recovery.

Stages with injection points: ``"fanout"`` / ``"bellman_ford"`` /
``"batch_apsp"`` (compute, via ``resilience.run_stage``),
``"download"`` (the staged device-to-host copy of a batch's rows, also
via ``run_stage``) and ``"ckpt_write"`` (fired on the checkpoint writer
thread mid-commit, surfacing as ``SolveCorruptionError``; a killed
commit leaves only an uncommitted ``.tmp.npz``, so resume recomputes
exactly that batch).

Kinds:
- ``"oom"``     raises :class:`InjectedOOMError` (a ``MemoryError``
                subclass — classified by ``resilience.is_oom_error``
                exactly like a real ``torch.OutOfMemoryError``).
- ``"timeout"`` makes the attempt sleep ``sleep_s`` before running, so a
                watchdog deadline shorter than that abandons the stage.
- ``"slow_ms"`` makes the attempt sleep ``slow_ms`` MILLISECONDS before
                running — injected latency, not failure: the attempt
                still succeeds, just late.
- ``"error"``   raises :class:`InjectedFaultError` (a generic runtime
                failure, retried as transient).
- ``"nan"``     leaves the call alone; the call site poisons the result
                rows via :meth:`FaultPlan.poison` so the sanity guard
                has something real to catch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

_KINDS = ("oom", "timeout", "error", "nan", "slow_ms")


class InjectedOOMError(MemoryError):
    """Simulated device out-of-memory (see resilience.is_oom_error)."""


class InjectedFaultError(RuntimeError):
    """Simulated generic stage failure."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """Fail attempt ``attempt`` of stage ``stage`` (optionally only for
    one batch index) with ``kind``. ``times``: how many consecutive
    attempts starting at ``attempt`` fail (so ``times >= max_attempts``
    models a permanent failure)."""

    stage: str
    kind: str
    attempt: int = 1
    batch: int | None = None
    times: int = 1
    sleep_s: float = 30.0
    slow_ms: float = 50.0  # "slow_ms" kind: injected latency per attempt
    rows: int = 1  # "nan" kind: poison the first ``rows`` rows

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if self.attempt < 1 or self.times < 1:
            raise ValueError("attempt and times must be >= 1")
        if self.slow_ms < 0:
            raise ValueError(f"slow_ms must be >= 0, got {self.slow_ms}")


class _ActiveFault:
    """What ``FaultPlan.fire`` hands back to ``resilience.run_stage``:
    wraps the stage callable so the injected failure happens INSIDE the
    attempt (under the watchdog, like the real thing)."""

    def __init__(self, fault: Fault, sleep: Callable[[float], None]):
        self.fault = fault
        self._sleep = sleep

    def wrap(self, fn: Callable) -> Callable:
        fault = self.fault
        if fault.kind == "oom":
            def oom_call():
                raise InjectedOOMError(
                    f"injected out of memory at stage {fault.stage!r}"
                )
            return oom_call
        if fault.kind == "error":
            def err_call():
                raise InjectedFaultError(
                    f"injected failure at stage {fault.stage!r}"
                )
            return err_call
        if fault.kind == "timeout":
            def slow_call():
                self._sleep(fault.sleep_s)
                return fn()
            return slow_call
        if fault.kind == "slow_ms":
            def late_call():
                self._sleep(fault.slow_ms / 1e3)
                return fn()
            return late_call
        return fn  # "nan": poisoning happens at the call site


class FaultPlan:
    """Deterministic schedule of injected faults (see module docstring).

    ``sleep``: injected-timeout sleeper, patchable in tests that want a
    wedge without real wall-clock cost.
    """

    def __init__(
        self, faults: list[Fault] | tuple[Fault, ...] = (),
        *, sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.faults = list(faults)
        self._sleep = sleep
        self._attempts: dict[tuple[str, int | None], int] = {}
        self._active: dict[tuple[str, int | None], _ActiveFault] = {}
        self.fired: list[tuple[str, int | None, int, str]] = []

    def attempts(self, stage: str, batch: int | None = None) -> int:
        """How many attempts of (stage, batch) have started so far."""
        return self._attempts.get((stage, batch), 0)

    def _match(self, stage: str, batch: int | None, attempt: int) -> Fault | None:
        for f in self.faults:
            if f.stage != stage:
                continue
            if f.batch is not None and f.batch != batch:
                continue
            if f.attempt <= attempt < f.attempt + f.times:
                return f
        return None

    def fire(self, stage: str, batch: int | None = None) -> _ActiveFault | None:
        """Record the start of one attempt; return the fault scheduled
        for it (or None). Called once per attempt by
        ``resilience.run_stage`` (or directly by non-retried call sites
        like the checkpoint writer)."""
        key = (stage, batch)
        attempt = self._attempts.get(key, 0) + 1
        self._attempts[key] = attempt
        fault = self._match(stage, batch, attempt)
        if fault is not None:
            self.fired.append((stage, batch, attempt, fault.kind))
            active = _ActiveFault(fault, self._sleep)
            self._active[key] = active
            return active
        self._active.pop(key, None)
        return None

    def poison_rows(self, stage: str, rows, batch: int | None = None):
        """Apply the ``"nan"`` fault (if any) scheduled for the attempt
        of (stage, batch) that just ran — the call-site hook for
        poisoning a stage's OUTPUT after ``fire`` armed the attempt."""
        return self.poison(self._active.get((stage, batch)), rows)

    def poison(self, active: _ActiveFault | None, rows):
        """Apply a pending ``"nan"`` fault to freshly computed distance
        rows (a numpy array, or a tensor on its own device); other kinds /
        no fault return rows unchanged. The poisoned rows are exactly what
        a corrupted kernel would hand the solver — upstream of the sanity
        guard AND of any checkpoint write."""
        if active is None or active.fault.kind != "nan":
            return rows
        k = max(1, int(active.fault.rows))
        if isinstance(rows, np.ndarray):
            rows = rows.copy()
        else:
            rows = rows.clone()
        rows[:k] = float("nan")
        return rows
