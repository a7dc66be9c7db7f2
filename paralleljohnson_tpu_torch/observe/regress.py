"""Bench-regression detection — a slowdown should arrive pre-attributed.

``BenchHistory`` is an append-only JSONL (``bench_history.jsonl``,
next to the profile store) of normalized measurement rows:

    {"bench": ..., "backend": ..., "platform": ..., "preset": ...,
     "wall_s": ..., "ts": ..., "detail": {...}, "source": ...}

``normalize_record`` turns every measurement format this repo already
produces into such rows: ``pjtpu bench`` JSON lines (BenchRecord), the
committed ``BENCH_r0*.json`` files (both the wrapper and its ``parsed``
payload), and the suite-budget guard's wall-clock. ``detect_regressions``
compares fresh rows against the per-(bench, backend, platform) history
with a noise band, and annotates each flagged row with its roofline
classification (from the row's own detail, or the profile store's
latest matching record) so the flag says *what kind* of slow it is.

Stdlib-only: scripts (``bench_regress.py``, ``check_suite_budget.py``)
load this module standalone, without importing the package (no torch).

Rows carry the backend that measured them: a bench row its own
``backend`` (``torch``, ``cpp``, ``numpy``), a profile or metric record
its ``backend`` key, else :data:`ROW_BACKEND` (the records this package
writes). A torch row and a jax row never share a baseline.
"""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path

HISTORY_FILENAME = "bench_history.jsonl"

# Backend of a profile or metric record that names none: this package's.
ROW_BACKEND = "torch"

# Default noise band: a fresh wall more than 35% over the historical
# median (and more than the absolute floor — micro-benches jitter in
# absolute ms) is a regression. Bench rows on shared CPU containers
# routinely wobble 10-20%; 35% flags real slowdowns without paging on
# scheduler noise.
DEFAULT_BAND = 0.35
DEFAULT_ABS_FLOOR_S = 0.05
DEFAULT_MIN_HISTORY = 2

# Iteration-count band: iterations-to-converge is a property
# of the graph + route, not of scheduler noise, so it gets a TIGHTER
# band than walls — a fresh row iterating >25% (and >2 iterations) over
# its history median converged slower, which is a perf bug even when
# the wall stays inside its noise band (the sweeps just got cheaper or
# the machine faster). Rows ingest iterations from detail.iterations —
# written by bench rows whenever the convergence observatory was on.
DEFAULT_ITER_BAND = 0.25
DEFAULT_ITER_ABS_FLOOR = 2

# Re-route lapse band: how long a killed replica's sources
# stay dark is the serve fleet's graded axis — a slower failover is a
# robustness regression even when the bench wall looks fine. The band
# is WIDE (50%) and the absolute floor generous (0.5 s) because the
# lapse is quantised by heartbeat/refresh clocks, not compute.
DEFAULT_REROUTE_BAND = 0.50
DEFAULT_REROUTE_ABS_FLOOR_S = 0.5

# Tuned-knob band: promoted knob values were measured probes,
# and promotion itself required beating the seed beyond the planner's
# 25% noise band — so a fresh probe of the SAME (knob, value, bucket)
# regressing past that same band means the promotion no longer holds.
# Mirrors observe.tuning.TUNE_NOISE_BAND (kept literal: this module is
# loaded standalone by scripts, without the package).
DEFAULT_TUNE_BAND = 0.25

# Trace-hop band: assembled per-hop request-trace p50s
# (``scripts/trace_assemble.py --regress-out`` rows) grade the serving
# path hop by hop — a silently doubled convoy queue-wait flags with the
# hop NAMED even when the end-to-end bench wall absorbs it. Queue waits
# are quantised by the batch-window clock and walls are ms-scale, so
# the band is wide (50%) with small absolute floors.
DEFAULT_TRACE_BAND = 0.50
DEFAULT_TRACE_ABS_FLOOR_S = 0.01
DEFAULT_TRACE_QUEUE_ABS_FLOOR_MS = 2.0

# Hopset size band: a hopset's edge count is a DETERMINISTIC
# function of (graph, ε, k, β, seed, picker) — same shape bucket, same
# knobs, fatter hopset means the construction changed, not the weather.
# The band exists only to tolerate intentional small re-tunes riding a
# shape bucket; growth past it flags as a size regression.
DEFAULT_SIZE_BAND = 0.10
DEFAULT_SIZE_ABS_FLOOR = 64


def history_key(row: dict) -> tuple:
    return (
        row.get("bench"),
        row.get("backend"),
        row.get("platform"),
        row.get("preset"),
    )


class BenchHistory:
    """Append-only normalized-row history store.

    ``path`` may be a directory (rows live in
    ``<dir>/bench_history.jsonl``) or a file path directly."""

    def __init__(self, path: str | Path) -> None:
        p = Path(path)
        self.path = p if p.suffix == ".jsonl" else p / HISTORY_FILENAME

    def rows(self) -> list[dict]:
        if not self.path.exists():
            return []
        out = []
        lines = self.path.read_text(encoding="utf-8").splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    continue  # torn trailing line: kill damage, tolerated
                raise ValueError(
                    f"{self.path}: corrupt history row at line {i + 1}"
                )
        return out

    @staticmethod
    def _sig(row: dict) -> str:
        """Row identity for ingestion dedup — everything except ``ts``
        (re-ingesting the same BENCH_r0*.json files must be idempotent;
        the committed files carry no timestamps of their own)."""
        return json.dumps(
            {k: v for k, v in row.items() if k != "ts"}, sort_keys=True
        )

    def append(self, row: dict, *, dedup: bool = True) -> bool:
        """Append one row; with ``dedup`` an exact (ts-ignored)
        duplicate of an existing row is skipped. Returns True iff
        written."""
        if dedup:
            sig = self._sig(row)
            if any(self._sig(r) == sig for r in self.rows()):
                return False
        row = dict(row)
        row.setdefault("ts", time.time())
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(row) + "\n")
            f.flush()
        return True


def _driver_metric_rows(obj: dict, source: str | None) -> list[dict]:
    """Rows from ``bench.py``'s metric format: the parsed payload
    ``{"metric": "edges_relaxed_per_sec_per_chip[tag]", "value": ...,
    "detail": {...}}``. The regression axis is the measured wall
    (``detail.dt``, lower = better) — the headline edges/s rate is kept
    in detail; keying strips the platform suffix from the tag so a
    cpu-fallback row and a TPU row land under different platforms, not
    different benches."""
    metric = obj.get("metric", "")
    detail = dict(obj.get("detail") or {})
    dt = detail.get("dt")
    if not isinstance(dt, (int, float)) or dt <= 0:
        return []
    tag = metric.split("[", 1)[1].rstrip("]") if "[" in metric else metric
    # Drop the trailing platform marker ("...,cpu-fallback" / ",cpu" /
    # ",tpu-rung") — platform is its own key axis.
    bench = "driver:" + tag.split(",", 1)[0]
    detail["value"] = obj.get("value")
    detail["metric"] = metric
    return [{
        "bench": bench,
        "backend": obj.get("backend", ROW_BACKEND),
        "platform": detail.get("platform", "unknown"),
        "preset": None,
        "wall_s": float(dt),
        "detail": detail,
        "source": source,
    }]


def _pow2_up(n) -> int:
    n = int(n or 0)
    return 1 << max(0, (n - 1).bit_length()) if n > 0 else 0


def _planner_rows(obj: dict, source: str | None) -> list[dict]:
    """Rows from ``kind: "plan"`` profile records: the
    planner's per-solve decision + measured wall, keyed by the solve's
    pow2 shape bucket. Re-ingesting the same profiles.jsonl is
    idempotent (the ts-ignored dedup in ``BenchHistory.append``), and a
    planner that starts picking a slower route for a shape it used to
    serve faster flags as an ordinary wall regression against that
    bucket's history — with the chosen plan + why-line in the flag's
    detail, so the regression arrives pre-attributed to a dispatch
    decision, not just a slow kernel."""
    measured = obj.get("measured") or {}
    wall = measured.get("wall_s") or measured.get("compute_s")
    if not isinstance(wall, (int, float)) or wall <= 0:
        return []
    bench = (
        f"planner:V{_pow2_up(obj.get('nodes'))}"
        f":E{_pow2_up(obj.get('edges'))}"
        f":B{_pow2_up(obj.get('batch'))}"
    )
    return [{
        "bench": bench,
        "backend": obj.get("backend", ROW_BACKEND),
        "platform": obj.get("platform", "unknown"),
        "preset": obj.get("label"),
        "wall_s": float(wall),
        "detail": {
            "route": obj.get("route"),
            "chosen": obj.get("chosen"),
            "reason": obj.get("reason"),
            "params": obj.get("params") or {},
            "degraded": bool(obj.get("degraded")),
        },
        "source": source,
    }]


def _tune_rows(obj: dict, source: str | None) -> list[dict]:
    """Rows from ``kind: "tune"`` probe records: one budgeted
    probe measurement keyed by (knob, pow2 shape bucket) with the probed
    value as the preset axis — so each candidate value accumulates its
    own history. Censored probes (budget exceeded / probe error) and
    demotion markers (``event``) are not measurements and are skipped.
    A promoted value whose fresh probes regress past the tuning band
    flags as ``kind: "tune"`` and ``bench_regress.py`` auto-demotes it
    back to the seed (an ``event: "demote"`` record the resolver
    honors)."""
    if obj.get("censored") or obj.get("event"):
        return []
    measured = obj.get("measured") or {}
    wall = measured.get("wall_s")
    if not isinstance(wall, (int, float)) or wall <= 0:
        return []
    bench = (
        f"tune:{obj.get('knob')}"
        f":V{_pow2_up(obj.get('nodes'))}"
        f":E{_pow2_up(obj.get('edges'))}"
    )
    return [{
        "bench": bench,
        "backend": obj.get("backend", ROW_BACKEND),
        "platform": obj.get("platform", "unknown"),
        "preset": str(obj.get("value")),
        "wall_s": float(wall),
        "detail": {
            "knob": obj.get("knob"),
            "value": obj.get("value"),
            "plan": obj.get("plan"),
            "rung": obj.get("rung"),
            "nodes": obj.get("nodes"),
            "edges": obj.get("edges"),
        },
        "source": source,
    }]


def _hopset_rows(obj: dict, source: str | None) -> list[dict]:
    """Rows from ``kind: "hopset"`` profile records: one
    construction measurement keyed by the graph's pow2 shape bucket and
    the ε it was built for. The regression axis is the construction
    wall; β and the hopset edge count ride in detail — the edge count
    is ALSO graded (``kind: "size"`` flags) because a fatter hopset
    slows every query downstream even when construction stayed fast.
    Re-ingesting the same profiles.jsonl is idempotent (ts-ignored
    dedup in ``BenchHistory.append``)."""
    wall = obj.get("construction_s")
    if not isinstance(wall, (int, float)) or wall <= 0:
        return []
    bench = (
        f"hopset:V{_pow2_up(obj.get('nodes'))}"
        f":E{_pow2_up(obj.get('edges'))}"
        f":eps{obj.get('epsilon')}"
    )
    return [{
        "bench": bench,
        "backend": obj.get("backend", ROW_BACKEND),
        "platform": obj.get("platform", "unknown"),
        "preset": obj.get("picker"),
        "wall_s": float(wall),
        "detail": {
            "beta": obj.get("beta"),
            "k": obj.get("k"),
            "hopset_edges": obj.get("hopset_edges"),
            "converged": bool(obj.get("converged")),
            "edges_examined": obj.get("edges_examined"),
        },
        "source": source,
    }]


def _trace_hop_rows(obj: dict, source: str | None) -> list[dict]:
    """Rows from ``kind: "trace"`` assembler output: one
    per-hop p50 from ``scripts/trace_assemble.py --regress-out``. The
    row keys as ``trace:<bench>:<hop>`` so every hop (forward /
    serve_request / convoy_member / query / device_megabatch / ...)
    accumulates its own baseline; the graded axes are the hop's p50
    wall and — where the hop records it — the p50 convoy queue wait."""
    hop = obj.get("hop")
    wall = obj.get("wall_s")
    if not hop or not isinstance(wall, (int, float)) or wall < 0:
        return []
    detail: dict = {
        "hop": str(hop),
        "count": obj.get("count"),
        "open": obj.get("open"),
    }
    qw = obj.get("queue_wait_p50_ms")
    if isinstance(qw, (int, float)):
        detail["queue_wait_p50_ms"] = float(qw)
    return [{
        "bench": f"trace:{obj.get('bench')}:{hop}",
        "backend": obj.get("backend", "unknown"),
        "platform": obj.get("platform", "unknown"),
        "preset": obj.get("preset"),
        "wall_s": float(wall),
        "detail": detail,
        "source": source,
    }]


def normalize_record(obj: dict, *, source: str | None = None) -> list[dict]:
    """Normalize ONE parsed measurement object into history rows.

    Accepted shapes: an already-normalized row (has bench + wall_s);
    a ``pjtpu bench`` BenchRecord line (config/backend/preset/wall_s);
    a ``bench.py`` metric payload (metric/value/detail); the committed
    ``BENCH_r0*.json`` wrapper (its ``parsed`` field is the payload);
    a profile store's ``kind: "plan"`` planner-decision record or
    ``kind: "hopset"`` construction record; the trace assembler's
    ``kind: "trace"`` per-hop p50 rows.
    Unrecognized objects yield [] — ingestion skips, never crashes."""
    if not isinstance(obj, dict):
        return []
    if obj.get("kind") == "plan":
        return _planner_rows(obj, source)
    if obj.get("kind") == "tune":
        return _tune_rows(obj, source)
    if obj.get("kind") == "hopset":
        return _hopset_rows(obj, source)
    if obj.get("kind") == "trace":
        return _trace_hop_rows(obj, source)
    if "bench" in obj and "wall_s" in obj:
        row = dict(obj)
        row.setdefault("source", source)
        return [row]
    if "config" in obj and "wall_s" in obj:
        detail = dict(obj.get("detail") or {})
        if "failed" in detail:
            return []  # a partial/failed row is not a measurement
        return [{
            "bench": obj["config"],
            "backend": obj.get("backend", "unknown"),
            "platform": detail.get("platform", "unknown"),
            "preset": obj.get("preset"),
            "wall_s": float(obj["wall_s"]),
            "detail": detail,
            "source": source,
        }]
    if "metric" in obj and "detail" in obj:
        return _driver_metric_rows(obj, source)
    if "parsed" in obj and isinstance(obj["parsed"], dict):
        return normalize_record(obj["parsed"], source=source)
    return []


def load_measurements(path: str | Path) -> list[dict]:
    """Rows from a measurement file: one JSON object (``bench.py``'s format) or
    JSONL (bench rows / normalized rows)."""
    text = Path(path).read_text(encoding="utf-8").strip()
    rows: list[dict] = []
    src = str(path)
    try:
        rows.extend(normalize_record(json.loads(text), source=src))
        return rows
    except json.JSONDecodeError:
        pass
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rows.extend(normalize_record(json.loads(line), source=src))
        except json.JSONDecodeError:
            continue
    return rows


def _roofline_of(row: dict, profile_records: list[dict] | None) -> str:
    """Roofline annotation for a flagged row: the row's own detail
    first, else the profile store's latest record matching the row's
    platform (and route tag, when the row carries one)."""
    detail = row.get("detail") or {}
    if detail.get("roofline_bound"):
        return detail["roofline_bound"]
    roof = detail.get("roofline")
    if isinstance(roof, dict) and roof.get("bound"):
        return roof["bound"]
    if profile_records:
        route = detail.get("route") or ""
        best = None
        for r in profile_records:
            if r.get("platform") != row.get("platform"):
                continue
            r_roof = (r.get("roofline") or {}).get("bound")
            if not r_roof:
                continue
            if route and r.get("route") and r["route"] not in route:
                continue
            if best is None or r.get("ts", 0) >= best.get("ts", 0):
                best = r
        if best is not None:
            return (best.get("roofline") or {}).get("bound", "unknown")
    return "unknown"


def _iterations_of(row: dict):
    """A row's iterations-to-converge, when its measurement carried the
    convergence observatory's count (``detail.iterations``)."""
    it = (row.get("detail") or {}).get("iterations")
    return int(it) if isinstance(it, (int, float)) and it > 0 else None


def _hopset_edges_of(row: dict):
    """A row's hopset edge count (``kind:"hopset"`` ingests)."""
    n = (row.get("detail") or {}).get("hopset_edges")
    return int(n) if isinstance(n, (int, float)) and n > 0 else None


def _reroute_lapse_of(row: dict):
    """A row's kill-to-reroute lapse (``serve_fleet`` rows)."""
    s = (row.get("detail") or {}).get("reroute_lapse_s")
    return float(s) if isinstance(s, (int, float)) and s > 0 else None


def detect_regressions(
    fresh: list[dict],
    history: list[dict],
    *,
    band: float = DEFAULT_BAND,
    abs_floor_s: float = DEFAULT_ABS_FLOOR_S,
    min_history: int = DEFAULT_MIN_HISTORY,
    iter_band: float = DEFAULT_ITER_BAND,
    profile_records: list[dict] | None = None,
) -> list[dict]:
    """Flag fresh rows slower than their history.

    Per (bench, backend, platform, preset) key the baseline is the
    MEDIAN of the history walls (robust to the odd wedged run); a fresh
    wall above ``baseline * (1 + band)`` AND more than ``abs_floor_s``
    over it is flagged (``kind: "wall"``). Keys with fewer than
    ``min_history`` rows are skipped — one prior point is not a trend.
    Each flag carries the baseline, the slowdown factor, and its
    roofline classification.

    Rows whose detail carries ``iterations`` (the convergence
    observatory was on) are ALSO graded on iterations-to-converge
    against the key's iteration history under the tighter ``iter_band``
    (``kind: "iterations"``) — a route converging slower is a perf bug
    even when wall noise hides it. Rows carrying ``hopset_edges``
    (``kind:"hopset"`` ingests) are graded on edge count under the
    tighter size band (``kind: "size"``) — a fatter hopset slows every
    downstream query even when construction stayed fast. ``serve_fleet``
    rows carrying ``detail.reroute_lapse_s`` are graded on the
    kill-to-reroute lapse (``kind: "reroute"``) under a wide band with
    a heartbeat-clock absolute floor — a slower failover flags the gate
    even when the bench wall is quiet. Trace-hop rows (``detail.hop``)
    grade per hop on p50 wall and p50 convoy queue wait
    (``kind: "trace"``, why-line names the hop)."""
    by_key: dict[tuple, list[float]] = {}
    iters_by_key: dict[tuple, list[int]] = {}
    size_by_key: dict[tuple, list[int]] = {}
    reroute_by_key: dict[tuple, list[float]] = {}
    tune_by_key: dict[tuple, list[float]] = {}
    trace_wall_by_key: dict[tuple, list[float]] = {}
    trace_queue_by_key: dict[tuple, list[float]] = {}
    for row in history:
        w = row.get("wall_s")
        if (row.get("detail") or {}).get("hop"):
            if isinstance(w, (int, float)) and w > 0:
                trace_wall_by_key.setdefault(
                    history_key(row), []
                ).append(float(w))
            qw = (row.get("detail") or {}).get("queue_wait_p50_ms")
            if isinstance(qw, (int, float)) and qw > 0:
                trace_queue_by_key.setdefault(
                    history_key(row), []
                ).append(float(qw))
            continue
        if (row.get("detail") or {}).get("knob"):
            if isinstance(w, (int, float)) and w > 0:
                tune_by_key.setdefault(history_key(row), []).append(float(w))
            continue
        if isinstance(w, (int, float)) and w > 0:
            by_key.setdefault(history_key(row), []).append(float(w))
        it = _iterations_of(row)
        if it is not None:
            iters_by_key.setdefault(history_key(row), []).append(it)
        n = _hopset_edges_of(row)
        if n is not None:
            size_by_key.setdefault(history_key(row), []).append(n)
        lapse = _reroute_lapse_of(row)
        if lapse is not None:
            reroute_by_key.setdefault(history_key(row), []).append(lapse)
    flagged = []
    for row in fresh:
        w = row.get("wall_s")
        detail = row.get("detail") or {}
        if detail.get("hop"):
            # Trace-hop rows grade ONLY under the trace band
            # against their own (trace:<bench>:<hop>) history — on the
            # hop's p50 wall AND, where recorded, the convoy's p50
            # queue wait. The flag names the hop so a silently doubled
            # convoy wait arrives pre-attributed to the hop, not just
            # to a slower end-to-end bench.
            hop = detail["hop"]
            key = history_key(row)
            whist = trace_wall_by_key.get(key)
            if (
                isinstance(w, (int, float)) and w > 0
                and whist and len(whist) >= min_history
            ):
                wbase = statistics.median(whist)
                if (
                    w > wbase * (1.0 + DEFAULT_TRACE_BAND)
                    and (w - wbase) > DEFAULT_TRACE_ABS_FLOOR_S
                ):
                    flagged.append({
                        **row,
                        "kind": "trace",
                        "hop": hop,
                        "axis": "wall",
                        "baseline_s": wbase,
                        "slowdown": w / wbase,
                        "band": DEFAULT_TRACE_BAND,
                        "history_n": len(whist),
                        "why": (
                            f"hop '{hop}' p50 wall {w * 1e3:.2f}ms vs "
                            f"median {wbase * 1e3:.2f}ms"
                        ),
                    })
            qw = detail.get("queue_wait_p50_ms")
            qhist = trace_queue_by_key.get(key)
            if (
                isinstance(qw, (int, float)) and qw > 0
                and qhist and len(qhist) >= min_history
            ):
                qbase = statistics.median(qhist)
                if (
                    qw > qbase * (1.0 + DEFAULT_TRACE_BAND)
                    and (qw - qbase) > DEFAULT_TRACE_QUEUE_ABS_FLOOR_MS
                ):
                    flagged.append({
                        **row,
                        "kind": "trace",
                        "hop": hop,
                        "axis": "queue_wait",
                        "queue_wait_p50_ms": float(qw),
                        "baseline_queue_wait_ms": qbase,
                        "slowdown": qw / qbase,
                        "band": DEFAULT_TRACE_BAND,
                        "history_n": len(qhist),
                        "why": (
                            f"hop '{hop}' p50 convoy queue-wait "
                            f"{qw:.2f}ms vs median {qbase:.2f}ms"
                        ),
                    })
            continue
        if not isinstance(w, (int, float)) or w <= 0:
            continue
        if detail.get("knob"):
            # Tuned-knob probe rows grade ONLY under the
            # tuning band against their own (knob, value, bucket)
            # history: a promoted value whose fresh probes regress past
            # the same band that justified its promotion flags — the
            # consumer (bench_regress.py) auto-demotes it to the seed.
            thist = tune_by_key.get(history_key(row))
            if thist and len(thist) >= min_history:
                tbase = statistics.median(thist)
                if (
                    w > tbase * (1.0 + DEFAULT_TUNE_BAND)
                    and (w - tbase) > abs_floor_s
                ):
                    flagged.append({
                        **row,
                        "kind": "tune",
                        "knob": detail["knob"],
                        "value": detail.get("value"),
                        "baseline_s": tbase,
                        "slowdown": w / tbase,
                        "band": DEFAULT_TUNE_BAND,
                        "history_n": len(thist),
                        "roofline_bound": _roofline_of(
                            row, profile_records
                        ),
                    })
            continue
        hist = by_key.get(history_key(row))
        if not hist or len(hist) < min_history:
            continue
        base = statistics.median(hist)
        if w > base * (1.0 + band) and (w - base) > abs_floor_s:
            flagged.append({
                **row,
                "kind": "wall",
                "baseline_s": base,
                "slowdown": w / base,
                "band": band,
                "history_n": len(hist),
                "roofline_bound": _roofline_of(row, profile_records),
            })
        n = _hopset_edges_of(row)
        shist = size_by_key.get(history_key(row))
        if n is not None and shist and len(shist) >= min_history:
            sbase = statistics.median(shist)
            if (
                n > sbase * (1.0 + DEFAULT_SIZE_BAND)
                and (n - sbase) > DEFAULT_SIZE_ABS_FLOOR
            ):
                flagged.append({
                    **row,
                    "kind": "size",
                    "hopset_edges": n,
                    "baseline_edges": sbase,
                    "slowdown": n / sbase,
                    "band": DEFAULT_SIZE_BAND,
                    "history_n": len(shist),
                    "roofline_bound": _roofline_of(row, profile_records),
                })
        lapse = _reroute_lapse_of(row)
        rhist = reroute_by_key.get(history_key(row))
        if lapse is not None and rhist and len(rhist) >= min_history:
            rbase = statistics.median(rhist)
            if (
                lapse > rbase * (1.0 + DEFAULT_REROUTE_BAND)
                and (lapse - rbase) > DEFAULT_REROUTE_ABS_FLOOR_S
            ):
                flagged.append({
                    **row,
                    "kind": "reroute",
                    "reroute_lapse_s": lapse,
                    "baseline_lapse_s": rbase,
                    "slowdown": lapse / rbase,
                    "band": DEFAULT_REROUTE_BAND,
                    "history_n": len(rhist),
                    "roofline_bound": _roofline_of(row, profile_records),
                })
        it = _iterations_of(row)
        ihist = iters_by_key.get(history_key(row))
        if it is None or not ihist or len(ihist) < min_history:
            continue
        ibase = statistics.median(ihist)
        if (
            it > ibase * (1.0 + iter_band)
            and (it - ibase) > DEFAULT_ITER_ABS_FLOOR
        ):
            flagged.append({
                **row,
                "kind": "iterations",
                "iterations": it,
                "baseline_iterations": ibase,
                "slowdown": it / ibase,
                "band": iter_band,
                "history_n": len(ihist),
                "roofline_bound": _roofline_of(row, profile_records),
            })
    return flagged
