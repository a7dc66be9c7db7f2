"""Fleet-wide request tracing — end-to-end causality
from socket accept to device kernel, across process boundaries.

The serve tier is a replicated fleet (router -> replica -> MicroBatcher
convoy -> device/host lookup -> scheduled solve -> repair/tuning lease),
but every observability layer before this one was *process-local*: a
flight recorder can say a replica was slow, none of them can answer
"why was THIS p99 request slow" once the request crossed a socket. This
module is the joining layer, three pieces:

- **Wire context** — :class:`TraceContext`: a ``trace_id`` minted at
  first ingress (router or replica) plus the upstream span's *global
  ref* (``"<proc>:<span_id>"``). It rides the ``pjtpu-serve/1`` request
  JSON (and the HTTP ``/query`` body) under the ``"trace"`` key:
  ``{"id": "<hex>", "parent": "<proc>:<span>"}`` (+ ``"sampled": false``
  when head sampling declined the request — downstream processes then
  must NOT re-mint, so one ingress decision governs the whole chain).
  Each process keeps appending to its own flight JSONL exactly as
  before; the ONLY new cross-process state is this one small dict.
- **Head sampling** — :func:`should_sample` is a pure function of the
  trace id (a sha256 fraction), so every process that computes it for
  the same id at the same rate agrees, deterministically. Rate 0 means
  no context is ever minted: the disabled path stays on
  ``NULL_TELEMETRY`` with bitwise-identical answers.
- **The assembler** — :func:`assemble` joins flight dirs from the
  router + N replicas + fleet workers into per-trace span sets: local
  parent chains (the ``Tracer``'s contextvar parenting) propagate the
  trace id downward, ``wire_parent`` attrs stitch processes together,
  and the result renders as one Perfetto timeline per trace
  (:func:`perfetto_trace`) with every span parented. Spans still open
  at a process's death (SIGKILL mid-request) are flagged ``open`` — the
  ingress span of a killed replica is the diagnosis, not a parse error.

Stdlib-only ON PURPOSE (the ``observe.live`` rule): the offline tools
(``scripts/trace_assemble.py``, ``scripts/trace_summary.py --request``)
load this module standalone via ``spec_from_file_location`` on any
log-analysis box — no numpy, no jax, no package imports.
"""

from __future__ import annotations

import contextvars
import hashlib
import json
import os
from pathlib import Path

# The request-JSON key the wire context rides under. Absent = the
# request was never traced upstream (a replica reached directly may
# mint); present with "sampled": false = an upstream ingress declined
# it (do NOT re-mint — the head decision is made exactly once).
WIRE_KEY = "trace"

# The response-document key a traced request's answer carries, so a
# client (or a drill) can jump from an answer to its assembled
# timeline. Never present when tracing is off — the disabled path's
# responses stay bitwise-identical.
RESPONSE_KEY = "trace_id"

TRACE_ID_BYTES = 8


def mint_trace_id() -> str:
    """A fresh 64-bit hex trace id (the ingress mints exactly one)."""
    return os.urandom(TRACE_ID_BYTES).hex()


def should_sample(trace_id: str, rate: float) -> bool:
    """Deterministic head-sampling verdict: a pure function of the
    trace id, so router and replicas computing it independently agree.
    ``rate`` <= 0 never samples, >= 1 always; in between the id's
    sha256 fraction is compared against the rate (stable across
    processes, platforms, and reruns — the sampling-determinism test
    pins this)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = hashlib.sha256(str(trace_id).encode("utf-8")).digest()
    frac = int.from_bytes(h[:8], "big") / float(1 << 64)
    return frac < rate


class TraceContext:
    """One request's trace identity: the minted id, the upstream span's
    global ref (``"<proc>:<span_id>"``, None at first ingress), and the
    head-sampling verdict. Unsampled contexts still travel the wire
    (so downstream never re-mints) but open no spans."""

    __slots__ = ("trace_id", "parent", "sampled")

    def __init__(self, trace_id: str, *, parent: str | None = None,
                 sampled: bool = True) -> None:
        self.trace_id = str(trace_id)
        self.parent = parent
        self.sampled = bool(sampled)

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"TraceContext({self.trace_id!r}, parent={self.parent!r}, "
                f"sampled={self.sampled})")

    def child(self, parent_ref: str | None) -> "TraceContext":
        """The context to forward downstream: same id + verdict, the
        forwarding span's global ref as the new wire parent."""
        return TraceContext(self.trace_id, parent=parent_ref,
                            sampled=self.sampled)

    def to_wire(self) -> dict:
        doc: dict = {"id": self.trace_id}
        if self.parent is not None:
            doc["parent"] = self.parent
        if not self.sampled:
            doc["sampled"] = False
        return doc

    @classmethod
    def from_wire(cls, doc) -> "TraceContext | None":
        """Parse a request's ``"trace"`` value; None on anything
        malformed (a garbage wire context must degrade to untraced,
        never crash the serving path)."""
        if not isinstance(doc, dict):
            return None
        tid = doc.get("id")
        if not isinstance(tid, str) or not tid:
            return None
        parent = doc.get("parent")
        if parent is not None and not isinstance(parent, str):
            parent = None
        return cls(tid, parent=parent,
                   sampled=doc.get("sampled", True) is not False)


def ingress(req: dict, *, rate: float) -> TraceContext | None:
    """The one decision point every ingress shares: honor an upstream
    wire context when the request carries one (its head decision is
    final), else mint at ``rate`` (None when rate <= 0 — tracing off
    means no context exists anywhere, the bitwise-identical path)."""
    wire = req.get(WIRE_KEY)
    if wire is not None:
        ctx = TraceContext.from_wire(wire)
        if ctx is not None:
            return ctx
    if rate <= 0.0:
        return None
    tid = mint_trace_id()
    return TraceContext(tid, sampled=should_sample(tid, rate))


# -- the current-trace contextvar --------------------------------------------
# Mirrors telemetry._CURRENT_SPAN: threads start untraced; cross-thread
# hops (the MicroBatcher convoy, the pipeline finalize worker) carry the
# context explicitly rather than inheriting it silently.

_CURRENT_TRACE: contextvars.ContextVar[TraceContext | None] = (
    contextvars.ContextVar("pj_current_trace", default=None)
)


def current_trace() -> TraceContext | None:
    return _CURRENT_TRACE.get()


def current_trace_id() -> str | None:
    """The sampled current trace's id, or None — what deep call sites
    (the solver's batch spans, repair/tuning lease events) tag their
    records with."""
    ctx = _CURRENT_TRACE.get()
    if ctx is not None and ctx.sampled:
        return ctx.trace_id
    return None


def trace_attrs() -> dict:
    """``{"trace": <id>}`` when a sampled trace is current, else ``{}``
    — splice into ``tel.span(...)``/``tel.event(...)`` kwargs at call
    sites that are only reached with telemetry enabled."""
    tid = current_trace_id()
    return {"trace": tid} if tid else {}


class use_trace:
    """Context manager installing ``ctx`` as the thread's current trace
    (tolerates ``ctx=None`` — the untraced path costs one isinstance of
    nothing)."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: TraceContext | None) -> None:
        self._ctx = ctx
        self._token = None

    def __enter__(self) -> TraceContext | None:
        if self._ctx is not None:
            self._token = _CURRENT_TRACE.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _CURRENT_TRACE.reset(self._token)
            self._token = None


# -- flight-file loading (torn-tail tolerant, the repo-wide convention) ------


def load_flight(path) -> list[dict]:
    """Parse one flight JSONL. A torn LAST line (the process died
    mid-write) is dropped silently; a corrupt line anywhere else raises
    — that is disk damage, not kill damage."""
    p = Path(path)
    lines = p.read_text(encoding="utf-8").splitlines()
    out: list[dict] = []
    for n, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            if n != len(lines) - 1:
                raise ValueError(
                    f"{p}:{n + 1}: corrupt flight line (not the last "
                    "line — this is not kill damage)"
                ) from None
    return out


def flight_files(sources) -> list[Path]:
    """Expand files/dirs into the flight JSONLs to join: a file is
    taken as-is; a dir contributes its ``flight-*.jsonl`` plus those
    one level down (the per-replica trace-dir layout the fleet drill
    writes)."""
    out: list[Path] = []
    for src in sources:
        p = Path(src)
        if p.is_dir():
            out.extend(sorted(p.glob("flight-*.jsonl")))
            out.extend(sorted(p.glob("*/flight-*.jsonl")))
        elif p.exists():
            out.append(p)
    # De-dup while preserving order (a dir and an explicit file may
    # name the same flight).
    seen: set[Path] = set()
    uniq = []
    for p in out:
        rp = p.resolve()
        if rp not in seen:
            seen.add(rp)
            uniq.append(p)
    return uniq


def _label_of(path: Path, meta: dict) -> str:
    label = meta.get("label")
    if label:
        return str(label)
    name = path.name
    if name.startswith("flight-") and name.endswith(".jsonl"):
        return name[len("flight-"):-len(".jsonl")]
    return path.stem


# -- the assembler ------------------------------------------------------------


def _load_processes(path: Path) -> list[dict]:
    """One flight file -> one process record PER SESSION. Flight files
    open in append mode, so a restarted process pointed at the same
    trace dir (same label -> same filename) keeps appending to the
    same JSONL: a fresh ``meta`` record, span ids restarting at 1.
    Every record binds to the most recent ``meta`` above it — keying
    the whole file to the FIRST meta would mis-attribute the second
    session's spans and break every wire join against them."""
    records = load_flight(path)
    segments: list[list[dict]] = []
    cur: list[dict] = []
    for r in records:
        if r.get("type") == "meta" and cur:
            segments.append(cur)
            cur = []
        cur.append(r)
    if cur:
        segments.append(cur)
    return [_load_segment(path, seg) for seg in segments]


def _load_segment(path: Path, records: list[dict]) -> dict:
    """One session's records -> process record: meta + spans + events,
    with global refs and epoch-anchored times."""
    meta = next((r for r in records if r.get("type") == "meta"), {})
    pid = meta.get("pid")
    proc = meta.get("proc") or f"{_label_of(path, meta)}-{pid or '?'}"
    start_ts = float(meta.get("start_ts", 0.0))
    spans: dict[int, dict] = {}
    events: list[dict] = []
    for r in records:
        kind = r.get("type")
        if kind == "span_begin":
            attrs = dict(r.get("attrs") or {})
            spans[r["id"]] = {
                "id": r["id"],
                "ref": f"{proc}:{r['id']}",
                "name": r.get("name", "?"),
                "local_parent": r.get("parent"),
                "t0": float(r.get("t", 0.0)),
                "t1": None,
                "status": None,
                "error": None,
                "thread": r.get("thread", "?"),
                "attrs": attrs,
                "trace": attrs.get("trace"),
                "wire_parent": attrs.get("wire_parent"),
            }
        elif kind == "span_end":
            s = spans.get(r["id"])
            if s is not None:
                s["t1"] = float(r.get("t", 0.0))
                s["status"] = r.get("status")
                s["error"] = r.get("error")
        elif kind == "event":
            attrs = dict(r.get("attrs") or {})
            events.append({
                "name": r.get("name", "?"),
                "t": float(r.get("t", 0.0)),
                "span": r.get("span"),
                "thread": r.get("thread", "?"),
                "attrs": attrs,
                "trace": attrs.get("trace"),
            })
    return {
        "path": str(path),
        "label": _label_of(path, meta),
        "proc": proc,
        "pid": pid,
        "start_ts": start_ts,
        "spans": spans,
        "events": events,
        "n_records": len(records),
    }


def _propagate_traces(process: dict) -> None:
    """Within one process, a span's trace id flows down the LOCAL
    parent chain: only the ingress span (and explicitly tagged deep
    spans) must carry the attr; everything nested under it inherits.
    An explicit tag always wins over inheritance."""
    spans = process["spans"]
    children: dict[int, list[int]] = {}
    for sid, s in spans.items():
        lp = s["local_parent"]
        if lp is not None:
            children.setdefault(lp, []).append(sid)
    # Seed from explicitly tagged spans, walk down; explicit child tags
    # are respected (a convoy batch span may fan into several traces).
    frontier = [sid for sid, s in spans.items() if s["trace"]]
    while frontier:
        nxt: list[int] = []
        for sid in frontier:
            tid = spans[sid]["trace"]
            for cid in children.get(sid, ()):
                c = spans[cid]
                if not c["trace"]:
                    c["trace"] = tid
                    nxt.append(cid)
        frontier = nxt
    # Events inherit their enclosing span's trace when untagged.
    for ev in process["events"]:
        if not ev["trace"] and ev["span"] in spans:
            ev["trace"] = spans[ev["span"]]["trace"]


def assemble(sources) -> dict:
    """Join flight files/dirs into per-trace span sets.

    Returns ``{"processes": [...], "traces": {trace_id: trace}}`` where
    each trace is::

        {"trace_id", "spans": [...], "events": [...], "roots": [refs],
         "open": [refs], "linked": [refs], "unresolved": [wire refs],
         "processes": [...], "single_rooted": bool}

    Every span carries ``ref`` / ``parent_ref`` (the local parent's
    global ref, or the wire parent for a cross-process hop) and
    epoch-anchored ``start``/``end`` (meta ``start_ts`` + monotonic
    ``t`` — the same anchoring the chrome exporter uses). ``open``
    spans (no end record — the process died inside them) are the
    SIGKILL diagnosis and are flagged, never dropped. A span whose
    parent was recorded but belongs to ANOTHER trace is a cross-trace
    link, not a root — the convoy case: a follower's ``convoy_member``
    span is explicitly parented to the LEADER's ``convoy_batch`` span,
    which lives in the leader's trace. Those land in ``linked``. A
    trace is ``single_rooted`` when exactly one span is a true root
    and every wire parent resolved — the "every span parented"
    acceptance verdict (linked spans ARE parented)."""
    files = flight_files(sources)
    processes = [seg for p in files for seg in _load_processes(p)]
    for proc in processes:
        _propagate_traces(proc)
    all_refs: dict[str, dict] = {}
    for proc in processes:
        for s in proc["spans"].values():
            all_refs[s["ref"]] = s
    traces: dict[str, dict] = {}
    for proc in processes:
        spans = proc["spans"]
        for s in spans.values():
            tid = s["trace"]
            if not tid:
                continue
            tr = traces.setdefault(tid, {
                "trace_id": tid, "spans": [], "events": [],
                "roots": [], "open": [], "linked": [],
                "unresolved": [], "processes": [],
            })
            lp = s["local_parent"]
            local_parent_ref = (
                f"{proc['proc']}:{lp}" if lp is not None and lp in spans
                else None
            )
            parent_ref = s["wire_parent"] or local_parent_ref
            start = proc["start_ts"] + s["t0"]
            end = (proc["start_ts"] + s["t1"]
                   if s["t1"] is not None else None)
            tr["spans"].append({
                "ref": s["ref"],
                "name": s["name"],
                "proc": proc["proc"],
                "label": proc["label"],
                "thread": s["thread"],
                "start": start,
                "end": end,
                "open": s["t1"] is None,
                "status": s["status"],
                "error": s["error"],
                "parent_ref": parent_ref,
                "wire_parent": s["wire_parent"],
                "attrs": s["attrs"],
            })
            if proc["label"] not in tr["processes"]:
                tr["processes"].append(proc["label"])
        for ev in proc["events"]:
            tid = ev["trace"]
            if not tid or tid not in traces:
                continue
            traces[tid]["events"].append({
                "name": ev["name"],
                "t": proc["start_ts"] + ev["t"],
                "proc": proc["proc"],
                "label": proc["label"],
                "attrs": ev["attrs"],
            })
    for tr in traces.values():
        in_trace = {s["ref"] for s in tr["spans"]}
        for s in tr["spans"]:
            pr = s["parent_ref"]
            if pr is None:
                tr["roots"].append(s["ref"])
            elif pr not in in_trace:
                if pr in all_refs:
                    # Parented into a recorded span of ANOTHER trace —
                    # the convoy follower->leader link. Parented, so
                    # not a root; kept visible under "linked".
                    tr["linked"].append(s["ref"])
                else:
                    # A wire parent nothing recorded: the upstream's
                    # flight file is missing from the join.
                    tr["unresolved"].append(pr)
                    tr["roots"].append(s["ref"])
            if s["open"]:
                tr["open"].append(s["ref"])
        tr["spans"].sort(key=lambda s: s["start"])
        tr["events"].sort(key=lambda e: e["t"])
        tr["single_rooted"] = (
            len(tr["roots"]) == 1 and not tr["unresolved"]
        )
    return {
        "processes": [
            {k: p[k] for k in ("path", "label", "proc", "pid",
                               "start_ts", "n_records")}
            for p in processes
        ],
        "traces": traces,
    }


# -- exports ------------------------------------------------------------------


def perfetto_trace(trace: dict) -> dict:
    """One assembled trace -> Perfetto/chrome trace-event JSON: one pid
    per PROCESS (router / replica-0 / worker-...), one tid per OS
    thread within it, ts anchored to the trace's first span. Open
    spans emit begin-only "B" events (the killed-replica death point
    stays visible in the viewer — same convention as
    ``chrome_trace_from_records``)."""
    spans = trace["spans"]
    t_base = min((s["start"] for s in spans), default=0.0)
    pids: dict[str, int] = {}
    tids: dict[tuple, int] = {}
    meta: list[dict] = []
    events: list[dict] = []
    for s in spans:
        if s["proc"] not in pids:
            pids[s["proc"]] = len(pids)
            meta.append({"name": "process_name", "ph": "M",
                         "pid": pids[s["proc"]], "tid": 0,
                         "args": {"name": s["label"]}})
        pid = pids[s["proc"]]
        tkey = (s["proc"], s["thread"])
        if tkey not in tids:
            tids[tkey] = len([k for k in tids if k[0] == s["proc"]])
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tids[tkey],
                         "args": {"name": s["thread"]}})
        tid = tids[tkey]
        args = dict(s["attrs"])
        args["span_ref"] = s["ref"]
        if s["parent_ref"] is not None:
            args["parent_ref"] = s["parent_ref"]
        args["trace_id"] = trace["trace_id"]
        if s["error"]:
            args["error"] = s["error"]
        ts = (s["start"] - t_base) * 1e6
        if s["open"]:
            events.append({"name": s["name"], "ph": "B", "pid": pid,
                           "tid": tid, "ts": ts, "args": args})
        else:
            events.append({
                "name": s["name"], "ph": "X", "pid": pid, "tid": tid,
                "ts": ts,
                "dur": max(0.0, (s["end"] - s["start"]) * 1e6),
                "args": args,
            })
    for ev in trace.get("events", ()):
        pid = pids.get(ev["proc"])
        if pid is None:
            continue
        events.append({"name": ev["name"], "ph": "i", "s": "t",
                       "pid": pid, "tid": 0,
                       "ts": (ev["t"] - t_base) * 1e6,
                       "args": dict(ev["attrs"])})
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def _median(values: list[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    if n == 0:
        return 0.0
    mid = n // 2
    return vs[mid] if n % 2 else (vs[mid - 1] + vs[mid]) / 2.0


def hop_summary(assembly: dict) -> dict:
    """Per-hop (span name) aggregates over every assembled trace:
    count, open count, p50 wall seconds, and — for spans carrying the
    convoy's ``queue_wait_ms`` attr — the p50 queue wait. The
    ``kind:"trace"`` regression rows (``observe/regress.py``) are these
    numbers, one row per hop."""
    by_hop: dict[str, dict] = {}
    for tr in assembly["traces"].values():
        for s in tr["spans"]:
            h = by_hop.setdefault(s["name"], {
                "count": 0, "open": 0, "walls": [], "queue_waits": [],
            })
            h["count"] += 1
            if s["open"]:
                h["open"] += 1
            else:
                h["walls"].append(s["end"] - s["start"])
            qw = s["attrs"].get("queue_wait_ms")
            if isinstance(qw, (int, float)):
                h["queue_waits"].append(float(qw))
    out = {}
    for name, h in sorted(by_hop.items()):
        row = {
            "count": h["count"],
            "open": h["open"],
            "wall_p50_s": round(_median(h["walls"]), 6),
        }
        if h["queue_waits"]:
            row["queue_wait_p50_ms"] = round(_median(h["queue_waits"]), 4)
        out[name] = row
    return out


def format_request_tree(trace: dict) -> list[str]:
    """One trace's span tree as printable lines: per-hop wall clock,
    the parent->child start delta (the cross-hop queue/network wait),
    and the convoy's explicit ``queue_wait_ms`` where recorded — the
    ``trace_summary.py --request`` rendering."""
    spans = {s["ref"]: s for s in trace["spans"]}
    linked = set(trace.get("linked") or ())
    children: dict[str | None, list[str]] = {}
    for s in trace["spans"]:
        parent = s["parent_ref"] if s["parent_ref"] in spans else None
        children.setdefault(parent, []).append(s["ref"])
    for refs in children.values():
        refs.sort(key=lambda r: spans[r]["start"])
    lines = [f"trace {trace['trace_id']}  "
             f"({len(trace['spans'])} spans, "
             f"{len(trace['processes'])} processes: "
             f"{', '.join(trace['processes'])})"]
    if trace["unresolved"]:
        lines.append(f"  !! {len(trace['unresolved'])} unresolved wire "
                     f"parent(s): {', '.join(trace['unresolved'])}")

    def walk(ref: str, depth: int, parent_start: float | None) -> None:
        s = spans[ref]
        wall = (f"{(s['end'] - s['start']) * 1e3:9.3f} ms"
                if not s["open"] else "     OPEN   ")
        delta = ("" if parent_start is None else
                 f"  +{(s['start'] - parent_start) * 1e3:.3f} ms")
        qw = s["attrs"].get("queue_wait_ms")
        qtxt = (f"  queue_wait {float(qw):.3f} ms"
                if isinstance(qw, (int, float)) else "")
        err = f"  ERROR: {s['error']}" if s["error"] else ""
        hop = f"[{s['label']}] " if depth <= 1 or s["wire_parent"] else ""
        link = (f"  (linked under {s['parent_ref']})"
                if ref in linked else "")
        lines.append(f"  {'  ' * depth}{wall}  {hop}{s['name']}"
                     f"{delta}{qtxt}{err}{link}")
        for cref in children.get(ref, ()):
            walk(cref, depth + 1, s["start"])

    for root in children.get(None, ()):
        walk(root, 0, None)
    for ref in trace["open"]:
        s = spans[ref]
        lines.append(f"  !! span {s['name']} ({ref}) still OPEN — the "
                     f"process died inside it")
    return lines
