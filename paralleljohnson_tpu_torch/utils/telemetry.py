"""Flight-recorder telemetry: see into a solve while it runs, and after
it dies.

Three mechanisms share one façade (:class:`Telemetry`), as in the JAX
package:

- :class:`Tracer` — thread-safe nested ``span(name, **attrs)`` contexts
  (contextvar parent tracking, monotonic host clocks) and ``event()``
  markers. With a ``flight_path`` every record is appended to a JSONL
  **flight recorder** and flushed at once, so a killed worker leaves a
  readable record up to the instant of death (open spans mark where it
  died). ``to_chrome_trace()`` exports Perfetto-loadable trace-event
  JSON with each OS thread (main solve loop, pipeline finalize worker,
  checkpoint writer) on its own track, placed on the profiler's host
  clock (``ns``), so it lines up with a ``torch.profiler`` trace of the
  same run. Spans are host clocks: a span closes where the solve's own
  code returns, and the port adds no device synchronisation for them.
  The solve's spans open through ``utils.metrics.program_span``, which
  also labels the profiler's timeline with them.
- :class:`HeartbeatReporter` — a daemon thread atomically rewriting a
  small progress JSON every ``interval_s``: current stage/batch/attempt,
  batches done, retries, current batch size, pipeline depth, host RSS,
  and the card's ``torch.cuda.memory_stats`` bytes in use, peak and
  limit once CUDA is initialised. Atomic tmp+rename per write — a
  reader never sees a torn file; a stale mtime means the process is
  hung, a fresh one that it is progressing.
- :func:`write_prom_metrics` — Prometheus textfile-collector export of
  a completed solve's
  :class:`~paralleljohnson_tpu_torch.utils.metrics.SolverStats`.

Telemetry is off by default (``SolverConfig.telemetry=None``) and the
disabled path is near-free: every instrumented call site goes through
:data:`NULL_TELEMETRY`, whose ``span`` returns one shared reusable null
context and whose ``event``/``progress`` are empty methods. The record
format is the JAX package's, so either package's trace assembler
(``observe/trace.py``) reads the other's flight files.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Any

# Current span id for the CALLING thread's context. Threads start with
# the default (None), so background workers (pipeline finalize, the
# checkpoint writer) do not silently inherit the main thread's span —
# cross-thread nesting is explicit via ``span(..., parent=<id>)``,
# captured at submit time by the call sites that hop threads.
_CURRENT_SPAN: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "pj_current_span", default=None
)

_EVENT_NAMES_OF_INTEREST = (
    "retry", "abandon", "oom_degrade", "window_collapse", "batch_resumed",
    # Fleet lease lifecycle (the distributed fleet's workers)
    # — a worker's heartbeat carries its last lease transition, so
    # `fleet status` can show what each worker last did even between
    # coordinator log events.
    "lease_claimed", "lease_committed", "lease_requeued",
    "lease_stale_commit",
)


def profiler_ns() -> int:
    """Now on the profiler's host clock: ``torch.profiler`` (kineto)
    stamps its host events in nanoseconds since the epoch, which is
    ``time.time_ns``."""
    return time.time_ns()


def _thread_label() -> tuple[int, str]:
    t = threading.current_thread()
    return t.ident or 0, t.name


class _SpanHandle:
    """Context manager for one span. Close status is ``"ok"`` unless the
    body raised — then ``"error"`` with the exception recorded, so a
    crashed solve's flight record shows WHICH attempt died and why."""

    __slots__ = ("_tracer", "id", "_token")

    def __init__(self, tracer: "Tracer", span_id: int):
        self._tracer = tracer
        self.id = span_id
        self._token = None

    def __enter__(self) -> "_SpanHandle":
        self._token = _CURRENT_SPAN.set(self.id)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _CURRENT_SPAN.reset(self._token)
        if exc is None:
            self._tracer._end_span(self.id, "ok", None)
        else:
            self._tracer._end_span(
                self.id, "error", f"{exc_type.__name__}: {exc}"
            )


class Tracer:
    """Thread-safe span/event recorder with an optional JSONL flight file.

    Records (one JSON object per line / list entry):
      ``{"type": "meta", "pid", "proc", ["label"], "start_ts",
         "t": 0.0, "ns"}``                                        (first)
      ``{"type": "span_begin", "id", "parent", "name", "t", "ns", "tid",
         "thread", "attrs"}``
      ``{"type": "span_end", "id", "t", "ns", "status", ["error"]}``
      ``{"type": "event", "name", "t", "ns", "span", "tid", "thread",
         "attrs"}``

    ``t`` is monotonic seconds since tracer creation (``perf_counter``
    based — wall-clock steps cannot reorder the story); ``start_ts`` in
    the meta line anchors it to the epoch. ``ns`` is the same instant on
    the profiler's host clock (:func:`profiler_ns`), so a span and its
    ``record_function`` twin of ``utils.metrics.program_span`` line up
    in one timeline (:func:`chrome_trace_from_records` places by it).
    ``proc`` is a unique per-tracer id (pid + random suffix): span ids
    are only locally unique, so the cross-process trace assembler
    (``observe/trace.py``) addresses spans by the *global ref*
    ``"<proc>:<span_id>"`` — :meth:`global_ref` — which is what rides
    the serve wire as the downstream hop's ``parent``. Every line
    appended to the flight file is flushed immediately: a killed
    process leaves batches 0..k-1 closed and batch k OPEN, which is
    exactly the diagnosis.
    """

    def __init__(self, flight_path: str | Path | None = None,
                 label: str | None = None) -> None:
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._t0 = time.perf_counter()
        self._records: list[dict] = []
        self._open: dict[int, dict] = {}
        self._file = None
        self.flight_path: Path | None = None
        self.proc = f"{os.getpid():x}-{os.urandom(3).hex()}"
        if flight_path is not None:
            self.flight_path = Path(flight_path)
            self.flight_path.parent.mkdir(parents=True, exist_ok=True)
            self._file = open(self.flight_path, "a", encoding="utf-8")
        meta = {"type": "meta", "pid": os.getpid(), "proc": self.proc,
                "start_ts": time.time(), "t": 0.0, "ns": profiler_ns()}
        if label is not None:
            meta["label"] = label
        self._emit(meta)

    # -- recording --------------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _emit(self, rec: dict) -> None:
        with self._lock:
            self._records.append(rec)
            if self._file is not None:
                self._file.write(json.dumps(rec) + "\n")
                # Flush per record: the flight recorder's whole point is
                # surviving a kill at an arbitrary instant.
                self._file.flush()

    def span(self, name: str, *, parent: int | None = None, **attrs):
        """Open a nested span; use as a context manager. ``parent=None``
        nests under the calling thread's current span (contextvar);
        pass an explicit id when the span logically belongs to work
        submitted from another thread."""
        span_id = next(self._ids)
        if parent is None:
            parent = _CURRENT_SPAN.get()
        tid, tname = _thread_label()
        rec = {
            "type": "span_begin", "id": span_id, "parent": parent,
            "name": name, "t": self._now(), "ns": profiler_ns(), "tid": tid,
            "thread": tname, "attrs": attrs,
        }
        with self._lock:
            self._open[span_id] = rec
        self._emit(rec)
        return _SpanHandle(self, span_id)

    def _end_span(self, span_id: int, status: str, error: str | None) -> None:
        rec = {"type": "span_end", "id": span_id, "t": self._now(),
               "ns": profiler_ns(), "status": status}
        if error is not None:
            rec["error"] = error
        with self._lock:
            self._open.pop(span_id, None)
        self._emit(rec)

    def event(self, name: str, **attrs) -> None:
        """Point-in-time marker (retry / oom_degrade / window_collapse /
        abandon / batch_resumed ...), attached to the current span."""
        tid, tname = _thread_label()
        self._emit({
            "type": "event", "name": name, "t": self._now(),
            "ns": profiler_ns(), "span": _CURRENT_SPAN.get(), "tid": tid,
            "thread": tname, "attrs": attrs,
        })

    def current_span_id(self) -> int | None:
        return _CURRENT_SPAN.get()

    def global_ref(self, span_id: int | None = None) -> str | None:
        """The process-unique address of a span (``"<proc>:<id>"``) —
        what a forwarding hop puts on the wire as the downstream
        process's ``parent``. Defaults to the current span; None when
        there is none."""
        if span_id is None:
            span_id = _CURRENT_SPAN.get()
        if span_id is None:
            return None
        return f"{self.proc}:{span_id}"

    def begin_span(self, name: str, *, parent: int | None = None,
                   **attrs) -> int:
        """Open a span WITHOUT entering it on the calling thread's
        contextvar stack — for work tracked on behalf of another thread
        (the MicroBatcher leader opening one ``convoy_member`` span per
        follower slot). Close with :meth:`finish_span`."""
        span_id = next(self._ids)
        if parent is None:
            parent = _CURRENT_SPAN.get()
        tid, tname = _thread_label()
        rec = {
            "type": "span_begin", "id": span_id, "parent": parent,
            "name": name, "t": self._now(), "ns": profiler_ns(), "tid": tid,
            "thread": tname, "attrs": attrs,
        }
        with self._lock:
            self._open[span_id] = rec
        self._emit(rec)
        return span_id

    def finish_span(self, span_id: int, status: str = "ok",
                    error: str | None = None) -> None:
        """Close a span opened with :meth:`begin_span`."""
        self._end_span(span_id, status, error)

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.flush()
                    self._file.close()
                finally:
                    self._file = None

    # -- exports ----------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """Perfetto/chrome://tracing-loadable trace-event JSON. Host
        spans land on per-OS-thread tracks (main loop vs pipeline
        finalize vs checkpoint writer), events become instants, and
        spans still open (a killed run) are emitted as begin-only
        events so the death point is visible in the viewer."""
        return chrome_trace_from_records(self.records())

    def summary(self) -> dict:
        """Compact roll-up for bench row detail / log lines."""
        spans = 0
        open_spans = 0
        events: dict[str, int] = {}
        by_name: dict[str, float] = {}
        begins: dict[int, dict] = {}
        for r in self.records():
            kind = r.get("type")
            if kind == "span_begin":
                begins[r["id"]] = r
                spans += 1
                open_spans += 1
            elif kind == "span_end":
                open_spans -= 1
                b = begins.get(r["id"])
                if b is not None:
                    name = b["name"]
                    by_name[name] = by_name.get(name, 0.0) + (r["t"] - b["t"])
            elif kind == "event":
                events[r["name"]] = events.get(r["name"], 0) + 1
        out = {
            "spans": spans,
            "open_spans": open_spans,
            "events": events,
            "span_seconds_by_name": {
                k: round(v, 6) for k, v in sorted(by_name.items())
            },
        }
        if self.flight_path is not None:
            out["flight_recorder"] = str(self.flight_path)
        return out


def _ts_us(rec: dict) -> float:
    """A record's trace-event time in microseconds: since the epoch on
    the profiler's clock (``ns``), else since the tracer's creation."""
    ns = rec.get("ns")
    return ns / 1e3 if ns is not None else rec["t"] * 1e6


def chrome_trace_from_records(records: list[dict]) -> dict:
    """Convert flight-recorder records (a :meth:`Tracer.records` list or
    a parsed JSONL) to trace-event JSON. Offline twin of
    :meth:`Tracer.to_chrome_trace` — ``scripts/trace_summary.py --chrome``
    runs it on a dead run's flight file.

    Events are placed by ``ns`` where the records carry it: ``ts`` is
    then microseconds since the epoch on the profiler's clock, the clock
    of a ``torch.profiler`` trace of the same run
    (``utils.profiling.overlay_traces`` lays the two in one file).
    Records without it (older flight files) place by ``t``."""
    pid = None
    tids: dict[int, int] = {}
    names: dict[int, str] = {}
    events: list[dict] = []

    def tid_of(rec) -> int:
        raw = rec.get("tid", 0)
        if raw not in tids:
            tids[raw] = len(tids)
            names[tids[raw]] = rec.get("thread", f"thread-{raw}")
        return tids[raw]

    begins: dict[int, dict] = {}
    ends: dict[int, dict] = {}
    for r in records:
        kind = r.get("type")
        if kind == "meta":
            pid = int(r.get("pid", 0))
        elif kind == "span_begin":
            begins[r["id"]] = r
        elif kind == "span_end":
            ends[r["id"]] = r
    pid = pid if pid is not None else os.getpid()
    for span_id, b in begins.items():
        args = dict(b.get("attrs") or {})
        args["span_id"] = span_id
        if b.get("parent") is not None:
            args["parent_span"] = b["parent"]
        e = ends.get(span_id)
        if e is not None:
            ev = {"name": b["name"], "ph": "X", "pid": pid,
                  "tid": tid_of(b), "ts": _ts_us(b),
                  "dur": max(0.0, _ts_us(e) - _ts_us(b)), "args": args}
            if e.get("status") == "error":
                ev["args"]["error"] = e.get("error", "")
        else:
            # Open at death: begin-only so the viewer shows WHERE it died.
            ev = {"name": b["name"], "ph": "B", "pid": pid,
                  "tid": tid_of(b), "ts": _ts_us(b), "args": args}
        events.append(ev)
    for r in records:
        if r.get("type") == "event":
            events.append({
                "name": r["name"], "ph": "i", "s": "t", "pid": pid,
                "tid": tid_of(r), "ts": _ts_us(r),
                "args": dict(r.get("attrs") or {}),
            })
    events.sort(key=lambda e: e["ts"])
    meta = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": name}}
        for tid, name in sorted(names.items())
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


_PHASES = {"B", "E", "X", "i", "I", "M", "b", "e", "n", "C"}


def validate_chrome_trace(trace: Any) -> None:
    """Raise ``ValueError`` unless ``trace`` conforms to the trace-event
    schema subset this exporter emits (and Perfetto accepts): JSON-object
    format with a ``traceEvents`` list whose entries carry ``ph``/``pid``
    /``tid``/``name``, ``ts`` (+ ``dur`` for "X") numbers, and
    JSON-serializable ``args``. The telemetry tests run every export
    through this before anything is allowed to claim Perfetto-loadable."""
    if not isinstance(trace, dict):
        raise ValueError(f"trace must be a dict, got {type(trace).__name__}")
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        raise ValueError("trace['traceEvents'] must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"traceEvents[{i}]: bad ph {ph!r}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                raise ValueError(f"traceEvents[{i}]: {key} must be an int")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"traceEvents[{i}]: missing name")
        if ph != "M":
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"traceEvents[{i}]: ts must be a number")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"traceEvents[{i}]: X event needs dur")
        if ph == "i" and ev.get("s") not in ("t", "p", "g", None):
            raise ValueError(f"traceEvents[{i}]: bad instant scope {ev.get('s')!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"traceEvents[{i}]: args must be an object")
        try:
            json.dumps(ev)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"traceEvents[{i}] is not JSON-serializable: {e}"
            ) from None


# -- heartbeat ---------------------------------------------------------------


def _host_rss_bytes() -> int | None:
    """Resident set size without psutil: /proc on Linux, ru_maxrss (a
    high-water mark, close enough for a trajectory) elsewhere."""
    try:
        with open("/proc/self/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # noqa: BLE001 — telemetry must never crash a solve
        return None


def _device_memory_stats() -> dict | None:
    """Per-card ``torch.cuda.memory_stats`` bytes (in use / peak /
    limit), keyed by device index, once the process has initialised
    CUDA; None before that or without torch. Never initialises CUDA
    itself: the heartbeat thread must not create a context behind the
    solve's back."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    out = {}
    try:
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            out[str(i)] = {
                "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
                "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
            }
    except Exception:  # noqa: BLE001 — a dead device must not kill telemetry
        return out or None
    return out or None


class HeartbeatReporter:
    """Atomically rewrites a small progress JSON every ``interval_s``.

    ``update(**fields)`` merges progress fields (stage/batch/attempt/
    batches_done/...) into the state from any thread; the writer thread
    serializes state + liveness (seq, ts, uptime, RSS, device memory)
    and publishes via tmp-write + ``os.replace`` so a concurrent reader
    NEVER sees a torn file. Consumers decide hung-vs-progressing from
    the file's freshness (:func:`heartbeat_age_s` or plain mtime — what
    a watcher script uses to extend stage deadlines)."""

    def __init__(self, path: str | Path, interval_s: float = 5.0) -> None:
        if not interval_s > 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.interval_s = float(interval_s)
        self._state: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._seq = 0
        self._t0 = time.perf_counter()
        self._thread: threading.Thread | None = None
        self.write_errors = 0

    def update(self, **fields) -> None:
        with self._lock:
            self._state.update(fields)

    def note(self, **fields) -> None:
        """Merge live-progress fields from the SOLVE thread(s) — the
        convergence observatory's channel for ``iter`` /
        ``frontier_size`` / ``eta_s``. Same lock-protected
        dict merge as :meth:`update` (the writer thread serializes a
        copy under the same lock, so a half-merged batch of fields can
        never be published — the atomicity the telemetry tests pin);
        a distinct name so call sites read as "push a fact", not
        "rewrite the file"."""
        self.update(**fields)

    def payload(self) -> dict:
        with self._lock:
            state = dict(self._state)
            self._seq += 1
            seq = self._seq
        return {
            "ts": time.time(),
            "uptime_s": round(time.perf_counter() - self._t0, 3),
            "seq": seq,
            "pid": os.getpid(),
            "interval_s": self.interval_s,
            "host_rss_bytes": _host_rss_bytes(),
            "device_memory": _device_memory_stats(),
            **state,
        }

    def write_now(self) -> None:
        """One atomic publish (also called by tests for determinism)."""
        try:
            payload = self.payload()
            tmp = self.path.with_name(self.path.name + f".tmp{os.getpid()}")
            tmp.write_text(json.dumps(payload), encoding="utf-8")
            os.replace(tmp, self.path)
        except Exception:  # noqa: BLE001 — heartbeat must never kill a solve
            self.write_errors += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_now()

    def start(self) -> "HeartbeatReporter":
        if self._thread is None:
            self._stop.clear()
            self.write_now()  # liveness visible before the first interval
            self._thread = threading.Thread(
                target=self._loop, name="pj-heartbeat", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, *, final_write: bool = True) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, 2 * self.interval_s))
            self._thread = None
        if final_write:
            self.write_now()


def read_heartbeat(path: str | Path) -> dict | None:
    """Parse a heartbeat file; None when absent. Parse errors are raised:
    atomicity guarantees a reader never legitimately sees a torn file."""
    p = Path(path)
    if not p.exists():
        return None
    return json.loads(p.read_text(encoding="utf-8"))


def heartbeat_age_s(path: str | Path, now: float | None = None) -> float | None:
    """Seconds since the heartbeat's last publish (its ``ts`` field), or
    None when the file is absent. The staleness clock: fresh = the solve
    is progressing (extend its deadline), stale = hung (retry now)."""
    hb = read_heartbeat(path)
    if hb is None:
        return None
    return (time.time() if now is None else now) - float(hb["ts"])


def heartbeat_fresh(
    path: str | Path, stale_s: float, now: float | None = None
) -> bool:
    """Liveness verdict from one heartbeat file: True iff it exists, is
    readable, and its last publish is younger than ``stale_s``. The
    slow-but-alive vs dead distinction the fleet coordinator keys lease
    requeues off — an unreadable or absent beat never
    vouches for anyone."""
    try:
        age = heartbeat_age_s(path, now=now)
    except ValueError:
        return False
    return age is not None and age < stale_s


# -- prometheus textfile export ----------------------------------------------


def _measured_compute_s(s: Any) -> float:
    compute = getattr(s, "compute_seconds", None)
    if compute is not None:
        return float(compute)
    return float(getattr(s, "total_seconds", 0.0) or 0.0)


def _roofline_kind_values(s: Any) -> dict:
    """Per-kind samples of the labeled ``pjtpu_roofline_bound`` gauge:
    1 on the solve's classified bound, 0 on the others; empty (no
    samples emitted) when the solve was never attributed."""
    roof = getattr(s, "roofline", None)
    if not roof:
        return {}
    from paralleljohnson_tpu_torch.observe.roofline import BOUND_KINDS

    bound = roof.get("bound", "unknown")
    return {kind: 1.0 if kind == bound else 0.0 for kind in BOUND_KINDS}


_PROM_METRICS = (
    ("pjtpu_edges_relaxed_total", "counter",
     "Total edge relaxations performed by the solve",
     lambda s: s.edges_relaxed),
    ("pjtpu_solve_seconds", "gauge",
     "Wall-clock seconds across all solve phases",
     lambda s: s.total_seconds),
    ("pjtpu_retries_total", "counter",
     "Stage attempts re-run after a transient failure",
     lambda s: s.retries),
    ("pjtpu_oom_degradations_total", "counter",
     "Times the fan-out source batch was halved after a device OOM",
     lambda s: s.oom_degradations),
    ("pjtpu_ckpt_wait_seconds", "gauge",
     "Seconds the solve thread spent blocked on the checkpoint pipeline",
     lambda s: s.ckpt_wait_s),
    # Cost-observatory gauges: the calibrated prediction vs
    # the measurement it is graded against, and the labeled roofline
    # bound classification.
    ("pjtpu_route_predicted_s", "gauge",
     "Cost-model predicted compute seconds for this solve's route "
     "(0 = no calibration available)",
     lambda s: float(getattr(s, "predicted_s", None) or 0.0)),
    ("pjtpu_route_measured_s", "gauge",
     "Measured compute seconds (bellman_ford + fanout + batch_apsp)",
     _measured_compute_s),
    ("pjtpu_roofline_bound", "gauge",
     "Roofline classification of the solve: 1 on the active bound's "
     "kind label (hbm / mxu / host-io / unknown)",
     _roofline_kind_values, "kind"),
)


def write_prom_metrics(stats: Any, path: str | Path, *,
                       labels: dict | None = None,
                       metrics: tuple | None = None,
                       exemplars: bool = False) -> Path:
    """Write one stats object in Prometheus textfile-collector format
    (atomic tmp+rename — node_exporter may scrape mid-write). ``labels``
    adds constant labels to every sample (e.g. ``{"config": "rmat_apsp"}``).
    ``metrics`` is the ``(name, type, help, getter)`` table to emit —
    default the solve-stats table above; the serving layer passes its own
    (``serve.engine.SERVE_PROM_METRICS``: pjtpu_queries_total,
    pjtpu_query_latency_*, ...) so every subsystem exports through this
    one atomic writer. A 5-tuple entry ``(name, type, help, getter,
    label_name)`` is a LABELED metric: its getter returns
    ``{label_value: sample}`` and one line is emitted per label value
    (e.g. ``pjtpu_roofline_bound{kind="hbm"} 1.0``); an empty dict
    emits no samples (the metric has nothing to report).

    A 4-tuple entry whose type is ``"histogram"`` expects
    its getter to return an ``observe.live.LogHistogram`` (anything
    with ``cumulative_buckets()`` / ``count`` / ``sum``) and emits the
    real Prometheus histogram series: ``<name>_bucket{le="..."}`` lines
    with CUMULATIVE counts and strictly increasing ``le`` edges (one
    per occupied log bucket, closing with ``le="+Inf"``), plus
    ``<name>_sum`` and ``<name>_count`` — so percentile queries work in
    PromQL (``histogram_quantile``) instead of only via the exported
    p50/p99 gauges. Run :func:`validate_prom_text` over the output in
    tests — the cumulative-bucket invariants are checked, not assumed.

    ``exemplars=True`` appends an OpenMetrics-style exemplar
    to each histogram bucket line whose ``LogHistogram`` bucket
    recorded one — ``<bucket sample> # {trace_id="<id>"} <value>`` —
    so a scrape can jump from "the p99 bucket" to a concrete request
    trace. Off by default: plain Prometheus text-format parsers reject
    the suffix; only enable for OpenMetrics-aware collectors.
    """

    def fmt_labels(extra: dict | None = None) -> str:
        merged = dict(labels or {})
        if extra:
            merged.update(extra)
        if not merged:
            return ""
        inner = ",".join(
            f'{k}="{str(v)}"' for k, v in sorted(merged.items())
        )
        return "{" + inner + "}"

    def fmt_le(edge: float) -> str:
        if edge == float("inf"):
            return "+Inf"
        return repr(float(edge))

    label_str = fmt_labels()
    lines = []
    for entry in (metrics or _PROM_METRICS):
        if len(entry) == 5:
            name, mtype, help_text, get, label_name = entry
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            for value, sample in sorted((get(stats) or {}).items()):
                lines.append(
                    f"{name}{fmt_labels({label_name: value})} "
                    f"{float(sample)}"
                )
            continue
        name, mtype, help_text, get = entry
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        if mtype == "histogram":
            hist = get(stats)
            ex_by_edge = {}
            if exemplars and hasattr(hist, "bucket_exemplars"):
                ex_by_edge = hist.bucket_exemplars() or {}
            for edge, cum in hist.cumulative_buckets():
                line = (
                    f"{name}_bucket{fmt_labels({'le': fmt_le(edge)})} "
                    f"{float(cum)}"
                )
                ex = ex_by_edge.get(edge)
                if ex is not None:
                    trace_id, ex_value = ex
                    line += (f' # {{trace_id="{trace_id}"}} '
                             f"{float(ex_value)}")
                lines.append(line)
            lines.append(f"{name}_sum{label_str} {float(hist.sum)}")
            lines.append(f"{name}_count{label_str} {float(hist.count)}")
            continue
        lines.append(f"{name}{label_str} {float(get(stats))}")
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + f".tmp{os.getpid()}")
    tmp.write_text("\n".join(lines) + "\n", encoding="utf-8")
    os.replace(tmp, p)
    return p


_PROM_SAMPLE_RE = None  # compiled lazily (keep import time free of re work)


def validate_prom_text(text: str) -> None:
    """Raise ``ValueError`` unless ``text`` conforms to the Prometheus
    text-exposition subset this writer emits: every sample line parses
    as ``name{labels} value``, every series is preceded by its HELP and
    TYPE lines, and histogram series satisfy the cumulative-bucket
    contract — ``le`` edges strictly increasing, bucket counts
    non-decreasing, a closing ``le="+Inf"`` bucket whose count equals
    ``<name>_count``, and ``_sum``/``_count`` present. An
    OpenMetrics-style exemplar suffix (``# {trace_id="..."} <value>``,
    ) is accepted ONLY on histogram ``_bucket`` lines — one
    anywhere else raises. The telemetry tests run every export through
    this before anything may claim scrape-ready (the
    ``validate_chrome_trace`` pattern)."""
    import re

    global _PROM_SAMPLE_RE
    if _PROM_SAMPLE_RE is None:
        _PROM_SAMPLE_RE = re.compile(
            r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
            r"(?:\{(?P<labels>[^}]*)\})?"
            r" (?P<value>[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|inf|nan))"
            r"(?P<exemplar> # \{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\"\}"
            r" [-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|inf|nan))?$"
        )
    typed: dict[str, str] = {}
    helped: set[str] = set()
    # histogram name -> list of (le, count); plus captured _sum/_count.
    buckets: dict[str, list[tuple[float, float]]] = {}
    sums: dict[str, float] = {}
    counts: dict[str, float] = {}
    for n, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 4 or not parts[3].strip():
                raise ValueError(f"line {n}: HELP without text: {line!r}")
            helped.add(parts[2])
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                "counter", "gauge", "histogram", "summary", "untyped"
            ):
                raise ValueError(f"line {n}: bad TYPE line: {line!r}")
            if parts[2] not in helped:
                raise ValueError(
                    f"line {n}: TYPE for {parts[2]} before its HELP"
                )
            typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            raise ValueError(f"line {n}: unknown comment: {line!r}")
        m = _PROM_SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {n}: unparseable sample: {line!r}")
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed \
                    and typed[name[: -len(suffix)]] == "histogram":
                base = name[: -len(suffix)]
                break
        if base not in typed:
            raise ValueError(
                f"line {n}: sample {name} has no preceding TYPE"
            )
        value = float(m.group("value"))
        if m.group("exemplar") and not (
            typed[base] == "histogram" and name == base + "_bucket"
        ):
            raise ValueError(
                f"line {n}: exemplar on a non-histogram-bucket "
                f"sample: {line!r}"
            )
        if typed[base] == "histogram":
            if name == base + "_bucket":
                labels = m.group("labels") or ""
                le_m = re.search(r'le="([^"]+)"', labels)
                if le_m is None:
                    raise ValueError(
                        f"line {n}: histogram bucket without le label"
                    )
                raw = le_m.group(1)
                le = float("inf") if raw == "+Inf" else float(raw)
                buckets.setdefault(base, []).append((le, value))
            elif name == base + "_sum":
                sums[base] = value
            elif name == base + "_count":
                counts[base] = value
            else:
                raise ValueError(
                    f"line {n}: bare sample {name} for histogram {base}"
                )
    for base, series in buckets.items():
        les = [le for le, _ in series]
        cums = [c for _, c in series]
        if les != sorted(les) or len(set(les)) != len(les):
            raise ValueError(
                f"{base}: bucket le edges not strictly increasing: {les}"
            )
        if cums != sorted(cums):
            raise ValueError(
                f"{base}: bucket counts not cumulative: {cums}"
            )
        if les[-1] != float("inf"):
            raise ValueError(f"{base}: missing le=\"+Inf\" bucket")
        if base not in counts or base not in sums:
            raise ValueError(f"{base}: histogram missing _sum/_count")
        if cums[-1] != counts[base]:
            raise ValueError(
                f"{base}: +Inf bucket {cums[-1]} != _count {counts[base]}"
            )
    for base, mtype in typed.items():
        if mtype == "histogram" and base not in buckets:
            raise ValueError(f"{base}: histogram TYPE with no buckets")


# -- the façade the engine is wired through ----------------------------------


class Telemetry:
    """Bundle of tracer + heartbeat that the solve engine threads through
    (``SolverConfig.telemetry``). Either part is optional; ``close()``
    stops the heartbeat, exports the Chrome trace (when a trace dir was
    given), and closes the flight file."""

    enabled = True

    def __init__(self, tracer: Tracer | None = None,
                 heartbeat: HeartbeatReporter | None = None,
                 trace_dir: str | Path | None = None,
                 label: str = "solve") -> None:
        self.tracer = tracer or Tracer()
        self.heartbeat = heartbeat
        self.trace_dir = Path(trace_dir) if trace_dir else None
        self.label = label
        self._closed = False

    @classmethod
    def create(cls, *, trace_dir: str | Path | None = None,
               heartbeat_file: str | Path | None = None,
               heartbeat_interval_s: float = 5.0,
               label: str = "solve") -> "Telemetry | None":
        """Build from CLI/env knobs; None when nothing was requested (so
        callers pass it straight to ``SolverConfig.telemetry``)."""
        if trace_dir is None and heartbeat_file is None:
            return None
        tracer = Tracer(
            flight_path=(Path(trace_dir) / f"flight-{label}.jsonl")
            if trace_dir else None,
            label=label,
        )
        hb = None
        if heartbeat_file is not None:
            hb = HeartbeatReporter(
                heartbeat_file, interval_s=heartbeat_interval_s
            ).start()
        return cls(tracer=tracer, heartbeat=hb, trace_dir=trace_dir,
                   label=label)

    def span(self, name: str, *, parent: int | None = None, **attrs):
        return self.tracer.span(name, parent=parent, **attrs)

    def event(self, name: str, **attrs) -> None:
        self.tracer.event(name, **attrs)
        if name in _EVENT_NAMES_OF_INTEREST and self.heartbeat is not None:
            self.heartbeat.update(last_event=name)

    def progress(self, **fields) -> None:
        """Merge live-progress fields into the heartbeat (no-op without
        one). Cheap: a dict update under a lock; the writer thread does
        the serialization on its own clock."""
        if self.heartbeat is not None:
            self.heartbeat.update(**fields)

    def note(self, **fields) -> None:
        """The solver-side push channel for convergence facts (``iter``
        / ``frontier_size`` / ``eta_s``): a lock-protected
        merge into the heartbeat state (``HeartbeatReporter.note``),
        safe against the sampler thread. No-op without a heartbeat."""
        if self.heartbeat is not None:
            self.heartbeat.note(**fields)

    def current_span_id(self) -> int | None:
        return self.tracer.current_span_id()

    def global_ref(self, span_id: int | None = None) -> str | None:
        return self.tracer.global_ref(span_id)

    def begin_span(self, name: str, *, parent: int | None = None,
                   **attrs) -> int:
        return self.tracer.begin_span(name, parent=parent, **attrs)

    def finish_span(self, span_id: int, status: str = "ok",
                    error: str | None = None) -> None:
        self.tracer.finish_span(span_id, status, error)

    def summary(self) -> dict:
        return self.tracer.summary()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.trace_dir is not None:
            try:
                trace = self.tracer.to_chrome_trace()
                out = self.trace_dir / f"trace-{self.label}.json"
                out.write_text(json.dumps(trace), encoding="utf-8")
            except Exception:  # noqa: BLE001 — teardown must not mask errors
                pass
        self.tracer.close()


class _NullSpan:
    """Reusable, reentrant, thread-safe no-op context manager (one shared
    instance — the disabled path allocates nothing per span)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


class _NullTelemetry:
    """The disabled path. All call sites are wired unconditionally; this
    object makes ``telemetry=None`` (the default) near-free — no
    allocation, no locking, no IO."""

    __slots__ = ()
    enabled = False

    def __bool__(self) -> bool:
        # Falsy so call sites can gate optional extra work with a plain
        # ``if telemetry:`` while still calling the no-op methods
        # unconditionally where that is simpler.
        return False

    def span(self, name, *, parent=None, **attrs):
        return _NULL_SPAN

    def event(self, name, **attrs):
        return None

    def progress(self, **fields):
        return None

    def note(self, **fields):
        return None

    def current_span_id(self):
        return None

    def global_ref(self, span_id=None):
        return None

    def begin_span(self, name, *, parent=None, **attrs):
        return None

    def finish_span(self, span_id, status="ok", error=None):
        return None

    def summary(self):
        return {}

    def close(self):
        return None


NULL_TELEMETRY = _NullTelemetry()


def resolve(telemetry) -> Any:
    """``config.telemetry`` (or None) -> the object call sites use."""
    return telemetry if telemetry is not None else NULL_TELEMETRY


def traced(name: str, **span_attrs):
    """Decorator giving a function an optional keyword-only ``telemetry``
    argument that wraps the call in a span (used by the sharded entry
    points in ``parallel/mesh.py``). ``telemetry=None`` adds one ``is
    None`` check — the disabled path stays free."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, telemetry=None, **kwargs):
            if telemetry is None:
                return fn(*args, **kwargs)
            with telemetry.span(name, **span_attrs):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def maybe_span(telemetry, name: str, **attrs):
    """Span context that tolerates ``telemetry=None`` (for call sites not
    on the solver's resolved path)."""
    if telemetry is None:
        yield None
        return
    with telemetry.span(name, **attrs) as s:
        yield s
