"""Tracing and profiling.

Two mechanisms:
  - :func:`device_trace` — a ``torch.profiler`` trace (host and CUDA
    activity) around any region, exported as a Chrome trace into
    ``log_dir``; each solver phase and step is already labelled with
    ``torch.profiler.record_function`` by ``utils.metrics.program_span``
    (``upload``, ``fanout``, ..., ``pj.upload.copy``, ``pj.fanout.batch``,
    ...), so kernels inside the trace are attributable to them.
    :func:`overlay_traces` lays a flight recorder's Chrome trace of the
    same run over it, on the same clock.
  - structured phase logs — :func:`log_stats` emits one JSON line per
    solve with per-phase wall-clock, iterations-to-fixpoint,
    edges-relaxed and negative-cycle flags, to stderr or a file.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path


@contextlib.contextmanager
def device_trace(log_dir: str | None, telemetry=None):
    """Profile the enclosed region with ``torch.profiler.profile`` when
    ``log_dir`` is set (CUDA activity too when the card is available),
    writing ``<log_dir>/trace.json`` on exit; no-op otherwise, so call
    sites need no branching. Yields the profiler (None when off).

    When a flight-recorder ``telemetry`` is also active, the trace dir is
    recorded as a ``device_trace`` event on it, so the host story (the
    flight file) and the kernel story of one run can be correlated."""
    if not log_dir:
        yield None
        return
    if telemetry is not None:
        try:
            telemetry.event("device_trace", dir=str(log_dir))
        except Exception:  # noqa: BLE001 — telemetry must never block a trace
            pass
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named trace scope for ad-hoc regions (phases and the solve's steps
    already get one): a ``utils.metrics.program_span`` without
    telemetry."""
    from paralleljohnson_tpu_torch.utils.metrics import program_span

    return program_span(name)


# The process the flight recorder's events take in an overlay.
FLIGHT_PID = 0


def overlay_traces(profile_trace: dict, flight_trace: dict) -> dict:
    """One trace-event document of a ``torch.profiler`` trace
    (:func:`device_trace`'s ``trace.json``) with a flight recorder's
    Chrome trace of the same run (``trace-<label>.json``) laid over it,
    for one Perfetto view. Both are on the profiler's host clock: the
    profiler writes microseconds after its ``baseTimeNanoseconds``, the
    flight trace microseconds since the epoch, so the flight events move
    by that base, onto a process of their own (``FLIGHT_PID``, named
    "flight recorder")."""
    base_us = profile_trace.get("baseTimeNanoseconds", 0) / 1e3
    events = [{"name": "process_name", "ph": "M", "pid": FLIGHT_PID,
               "tid": 0, "args": {"name": "flight recorder"}}]
    for ev in flight_trace["traceEvents"]:
        ev = dict(ev, pid=FLIGHT_PID)
        if "ts" in ev:
            ev["ts"] = ev["ts"] - base_us
        events.append(ev)
    return dict(profile_trace,
                traceEvents=list(profile_trace["traceEvents"]) + events)


def log_stats(stats, *, label: str = "solve", stream=None, extra=None) -> dict:
    """Emit one structured JSON log line for a completed solve.

    Returns the payload dict (tests assert on it; callers may ship it to
    any log sink). ``stream=None`` writes to stderr.
    """
    payload = {
        "event": "pjtpu." + label,
        "ts": time.time(),
        **stats.as_dict(),
    }
    # The bound alone is the line a human greps a log stream for; the
    # full roofline / analytic_cost dicts ride in via as_dict.
    roof = getattr(stats, "roofline", None)
    if roof and roof.get("bound"):
        payload.setdefault("roofline_bound", roof["bound"])
    if extra:
        payload.update(extra)
    out = stream if stream is not None else sys.stderr
    print(json.dumps(payload), file=out, flush=True)
    return payload
