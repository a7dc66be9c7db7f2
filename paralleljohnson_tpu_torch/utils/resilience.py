"""Fault-tolerant solve engine: the JAX package's resilience layer, on torch.

Large runs must DEGRADE instead of dying: a fan-out batch can run the
card out of memory, and a device call can hang. The batch is the unit
of recovery, retried with degraded resources. This module supplies the
three mechanisms the solver composes:

- :class:`RetryPolicy` — bounded attempts with exponential backoff +
  deterministic jitter, and a per-attempt wall-clock deadline enforced by
  a watchdog thread. Python cannot kill a wedged device call, so the
  watchdog LOGS-AND-ABANDONS it: the hung call keeps its daemon thread,
  the solve records the abandoned stage and moves on (retry or raise).
- :class:`OOMDegrader` — on a device/host OOM (:func:`is_oom_error`:
  ``torch.OutOfMemoryError``, a ``RuntimeError`` saying "out of memory",
  ``MemoryError``) clears the backend's rebuildable device caches and
  halves the source batch (floor ``SolverConfig.min_source_batch``,
  re-consulting ``suggested_source_batch``) so the failed batch is
  re-solved smaller instead of crashing the run.
- :func:`check_rows_sane` — the distance-sanity guard: after any route
  converges, a NaN / nonzero-at-source reduction that raises a
  diagnosable :class:`SolveCorruptionError` (route tag + iteration)
  instead of silently writing poisoned rows to checkpoints.

Deterministic fault injection (``utils.faults``) threads through
``run_stage`` so every retry / degrade / checkpoint-resume path is
exercised in CPU tests without a card.

The pipelined fan-out composes with all of it: the staged device-to-host
download runs through ``run_stage`` too (stage ``"download"`` — same
retry policy, same watchdog deadline, same fault plan as compute), the
checkpoint writer's failures surface as :class:`SolveCorruptionError`
(``utils.checkpoint.AsyncCheckpointWriter``), and an OOM first collapses
the in-flight window to 1 — giving back the extra [B, V] carry — before
:class:`OOMDegrader` halves the batch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch


class StageAbandonedError(RuntimeError):
    """A stage exceeded its per-attempt wall-clock deadline on every
    allowed attempt; the watchdog abandoned the hung device call(s)."""


class SolveCorruptionError(RuntimeError):
    """A converged route produced NaN rows or a negative/nonzero distance
    at a row's own source — corrupted results must never reach
    checkpoints or callers. Carries the route tag and iteration count so
    the failing kernel is diagnosable from the message alone."""


def is_oom_error(exc: BaseException) -> bool:
    """True iff ``exc`` is a device/host out-of-memory failure.

    Covers ``torch.OutOfMemoryError`` (``torch.cuda.OutOfMemoryError``,
    the caching allocator's failure: its type name is not
    ``RuntimeError``, so it is matched by type), a ``RuntimeError`` whose
    message says out of memory (a failed ``cudaMalloc`` outside the
    allocator), and plain ``MemoryError`` (host allocations, and the
    base class of ``faults.InjectedOOMError``).
    """
    if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
        return True
    if type(exc).__name__ == "RuntimeError":
        msg = str(exc)
        return (
            "Out of memory" in msg
            or "out of memory" in msg
            or "OOM" in msg
        )
    return False


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry schedule for one solve stage.

    max_attempts: total tries per stage (1 = no retry).
    backoff_s: sleep before attempt k is ``backoff_s * factor**(k-2)``
      (no sleep before the first attempt), plus jitter.
    factor: exponential backoff multiplier.
    jitter_frac: +/- fraction of the backoff added deterministically —
      derived from (stage, attempt) via sha256, NOT wall-clock random, so
      a replayed failing run schedules identically (the same property the
      fault-injection harness relies on).
    deadline_s: per-attempt wall-clock cap enforced by the watchdog
      thread; None disables the watchdog and runs calls inline.
    """

    max_attempts: int = 3
    backoff_s: float = 0.05
    factor: float = 2.0
    jitter_frac: float = 0.1
    deadline_s: float | None = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(
                f"deadline_s must be > 0 (or None), got {self.deadline_s}"
            )

    def backoff(self, stage: str, attempt: int) -> float:
        """Seconds to sleep before ``attempt`` (1-based; 0.0 for the
        first). Jitter is a deterministic function of (stage, attempt)."""
        if attempt <= 1:
            return 0.0
        base = self.backoff_s * self.factor ** (attempt - 2)
        digest = hashlib.sha256(f"{stage}#{attempt}".encode()).digest()
        unit = digest[0] / 255.0  # [0, 1]
        return base * (1.0 + self.jitter_frac * (2.0 * unit - 1.0))


def _run_with_watchdog(
    fn: Callable[[], Any], deadline_s: float, stage: str
) -> Any:
    """Run ``fn`` on a watchdog-supervised daemon thread; if it does not
    finish within ``deadline_s``, log and abandon it (the thread keeps
    running — a wedged device call is not interruptible from Python — but
    the solve regains control) and raise :class:`StageAbandonedError`."""
    out: queue.Queue = queue.Queue(maxsize=1)

    def target() -> None:
        try:
            out.put(("ok", fn()))
        except BaseException as e:  # noqa: BLE001 — relayed to caller
            out.put(("err", e))

    worker = threading.Thread(
        target=target, name=f"pj-stage-{stage}", daemon=True
    )
    worker.start()
    try:
        kind, payload = out.get(timeout=deadline_s)
    except queue.Empty:
        warnings.warn(
            f"stage {stage!r} exceeded its {deadline_s:g}s deadline; "
            "abandoning the hung device call (its thread is left to die "
            "with the process)",
            RuntimeWarning,
            stacklevel=3,
        )
        raise StageAbandonedError(
            f"stage {stage!r} still running after {deadline_s:g}s"
        ) from None
    if kind == "err":
        raise payload
    return payload


class OOMDegrader:
    """Drives batch degradation when a fan-out batch OOMs.

    Owns the current source-batch size for one solve. On OOM it clears
    the backend's rebuildable device caches, halves the batch (floor
    ``min_batch``), and re-consults ``suggested_source_batch`` — after
    ``clear_caches`` the budget may admit a different cap. Raises the
    original error when the batch cannot shrink further.
    """

    def __init__(
        self,
        backend: Any,
        dgraph: Any,
        batch_size: int,
        *,
        min_batch: int = 8,
        with_pred: bool = False,
    ) -> None:
        self.backend = backend
        self.dgraph = dgraph
        self.batch_size = max(1, int(batch_size))
        self.min_batch = max(1, int(min_batch))
        self.with_pred = with_pred
        self.degradations = 0

    def degrade(self, exc: BaseException) -> int:
        """Shrink after an OOM; returns the new batch size or re-raises
        ``exc`` when already at the floor (or a single-row batch)."""
        if self.batch_size <= max(self.min_batch, 1):
            raise exc
        try:
            self.backend.clear_caches(self.dgraph)
        except Exception:  # noqa: BLE001 — hygiene must not mask the OOM
            pass
        new = max(self.min_batch, self.batch_size // 2)
        try:
            suggested = self.backend.suggested_source_batch(
                self.dgraph, with_pred=self.with_pred
            )
        except Exception:  # noqa: BLE001
            suggested = None
        if suggested:
            new = min(new, max(self.min_batch, int(suggested)))
        # suggested_source_batch can exceed the failing size (its model
        # missed the real pressure — that is why we are here; on the card
        # ``mem_get_info`` also counts the caching allocator's cached
        # blocks as used); the halved size always wins so the schedule is
        # strictly decreasing.
        new = min(new, self.batch_size // 2)
        new = max(new, self.min_batch)
        self.batch_size = new
        self.degradations += 1
        return new


def run_stage(
    fn: Callable[[], Any],
    *,
    stage: str,
    policy: RetryPolicy,
    stats: Any = None,
    faults: Any = None,
    batch: int | None = None,
    retryable: Callable[[BaseException], bool] | None = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run one solve stage under the retry policy.

    - ``faults``: a ``utils.faults.FaultPlan`` (or None). Fired once per
      attempt; an injected OOM/timeout/error surfaces exactly like the
      real failure it models, and an injected NaN plan poisons the
      result via ``faults.poison_rows`` at the call site (not here).
    - ``retryable``: predicate for transient errors worth a plain retry
      (default: watchdog abandons only). Deterministic solver errors
      (NegativeCycleError, ConvergenceError, ValueError) must never be
      retried — the caller's predicate keeps that contract. OOM is NOT
      retried here unless the predicate opts in: the fan-out's degrader
      owns OOM recovery (shrink the batch) at the call site.

    Every plain retry increments ``stats.retries``; every watchdog
    abandon appends ``"<stage>@a<attempt>"`` (plus ``#b<batch>``) to
    ``stats.abandoned_stages``.
    """
    attempt = 0
    while True:
        attempt += 1
        wait = policy.backoff(stage, attempt)
        if wait > 0:
            sleep(wait)
        injected = faults.fire(stage, batch=batch) if faults is not None else None
        try:
            call = fn
            if injected is not None:
                call = injected.wrap(fn)
            if policy.deadline_s is not None:
                return _run_with_watchdog(call, policy.deadline_s, stage)
            return call()
        except StageAbandonedError as e:
            tag = stage + (f"#b{batch}" if batch is not None else "")
            if stats is not None:
                stats.abandoned_stages.append(f"{tag}@a{attempt}")
            if attempt >= policy.max_attempts:
                raise StageAbandonedError(
                    f"stage {tag!r} abandoned on all "
                    f"{policy.max_attempts} attempts"
                ) from e
            if stats is not None:
                stats.retries += 1
        except Exception as e:  # noqa: BLE001 — classified below
            if retryable is not None and retryable(e) and attempt < policy.max_attempts:
                if stats is not None:
                    stats.retries += 1
                continue
            raise


def check_rows_sane(
    rows: Any,
    batch_sources: Any = None,
    *,
    route: str | None,
    iteration: int,
    stage: str = "fanout",
) -> None:
    """Distance-sanity guard: NaN anywhere, or a nonzero / negative entry
    at a row's own source, means the kernel (or the hardware) corrupted
    the result — raise before it can reach a checkpoint or a caller.
    Runs where ``rows`` live (on the card: two reductions, two scalar
    reads)."""
    if isinstance(rows, torch.Tensor):
        nan = bool(torch.isnan(rows).any())
    else:
        nan = bool(np.isnan(rows).any())
    if nan:
        raise SolveCorruptionError(
            f"NaN distances out of converged stage {stage!r} "
            f"(route={route!r}, iteration={iteration})"
        )
    if batch_sources is not None and getattr(rows, "ndim", 1) == 2:
        b = rows.shape[0]
        cols = np.asarray(batch_sources, np.int64)
        if isinstance(rows, torch.Tensor):
            own = rows[torch.arange(b, device=rows.device),
                       torch.as_tensor(cols, device=rows.device)]
        else:
            own = rows[np.arange(b), cols]
        if bool((own != 0).any()):
            raise SolveCorruptionError(
                f"nonzero distance at a row's own source out of stage "
                f"{stage!r} (route={route!r}, iteration={iteration}): "
                "row i must have dist[i, sources[i]] == 0 on the "
                "non-negative reweighted graph"
            )
