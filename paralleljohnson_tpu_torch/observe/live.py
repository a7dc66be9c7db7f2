"""Live SLO observatory — *streaming* operational
metrics, where everything the repo emitted before was post-hoc.

The serve tier is judged as a traffic-bearing service (ROADMAP item 4:
"sustained queries/sec under concurrency with p99 SLOs, not one-shot
latency"), yet ``serve_stats.json`` was written once at close and the
latency percentiles buffered every sample in host RAM. This module is
the streaming substrate, four pieces sharing one snapshot artifact:

- :class:`LogHistogram` — log-bucketed latency histogram: bounded
  memory (one int per occupied bucket), EXACT counts, mergeable across
  processes, and percentile estimates whose error is bounded by one
  bucket width — the bound is computed and reported alongside every
  estimate (the repo's never-an-unflagged-approximation rule applied
  to percentiles).
- :class:`RateCounter` — sliding-window event counter (sparse
  per-second bins): exact totals plus windowed rates (queries/sec over
  the last 60 s), bounded by the window length.
- :class:`SLO` + :class:`SLOTracker` — service objectives
  (availability + latency target) evaluated with MULTI-WINDOW
  BURN-RATE rules (SRE-workbook style: alert only when both a long and
  a short window burn error budget faster than threshold — fast
  detection without flapping on one bad batch). Transitions into
  burning emit an ``slo_burn`` flight-recorder event; the current burn
  rate exports as a labeled ``pjtpu_slo_burn_rate`` gauge.
- :class:`MetricsRegistry` — the shared façade the hot paths are wired
  through (``QueryEngine``, the solver's ``_resilient_batches``, fleet
  workers, the incremental repair engine). A daemon thread atomically
  rewrites a snapshot JSON every ``interval_s`` (the
  ``HeartbeatReporter`` idiom: tmp + ``os.replace``, a reader never
  sees a torn file), so a SIGKILLed process leaves a view fresh to
  within one interval. Each snapshot also appends one compact line to
  a ``*_history.jsonl`` beside it — the burn-rate trajectory
  ``scripts/slo_report.py`` renders offline.

Everything here is stdlib-only (no numpy, no jax): the offline readers
(``scripts/slo_report.py``, ``pjtpu top``'s gatherer) load this module
standalone on any log-analysis box, and the disabled path
(:data:`NULL_METRICS`) is near-free like ``telemetry.NULL_TELEMETRY``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from pathlib import Path

SNAPSHOT_VERSION = 1

# Default log-bucket geometry: buckets grow by 2^(1/4) ≈ 18.9% per
# step from 1e-3 (one microsecond, in ms units) to 1e7 ms (~2.8 h) —
# 134 buckets cover ten decades, so a histogram is a few hundred bytes
# of occupied bins no matter how many samples it absorbs. The relative
# percentile error bound is therefore ≤ 18.9% of the estimate — wide
# enough to be cheap, tight enough that p99 regressions of interest
# (2x, 10x) are unmistakable.
DEFAULT_LO = 1e-3
DEFAULT_HI = 1e7
DEFAULT_GROWTH = 2.0 ** 0.25

# Per-bucket exemplar bound: each occupied bucket keeps the
# LAST K (trace_id, value) pairs recorded into it, so "p99 = 38 ms"
# comes with concrete request traces to assemble — bounded memory no
# matter how many samples flow through (K * occupied buckets entries).
DEFAULT_EXEMPLAR_K = 4


class LogHistogram:
    """Log-bucketed streaming histogram with bounded-error percentiles.

    Bucket ``i`` (1-based) covers ``(lo * growth**(i-1), lo * growth**i]``;
    bucket 0 is the underflow bin ``[0, lo]`` and the last bucket
    collects overflow ``(hi, +inf)``. Counts are EXACT integers; only
    the position of a sample WITHIN its bucket is forgotten, which is
    what bounds every percentile estimate by one bucket width. Exact
    ``count``/``sum``/``min``/``max`` ride along so means and extremes
    stay approximation-free.

    Thread-safe; :meth:`merge` combines histograms with identical
    geometry (fleet-wide unions of per-worker snapshots).
    """

    __slots__ = ("lo", "hi", "growth", "_log_growth", "n_buckets",
                 "_counts", "count", "sum", "min", "max", "_lock",
                 "exemplar_k", "_exemplars")

    def __init__(self, *, lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                 growth: float = DEFAULT_GROWTH) -> None:
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError(
                f"need 0 < lo < hi and growth > 1, got lo={lo} hi={hi} "
                f"growth={growth}"
            )
        self.lo = float(lo)
        self.hi = float(hi)
        self.growth = float(growth)
        self._log_growth = math.log(self.growth)
        # Regular buckets 1..n cover (lo, lo*growth**n] with
        # lo*growth**n >= hi; index 0 underflow, n+1 overflow.
        self.n_buckets = int(
            math.ceil(math.log(self.hi / self.lo) / self._log_growth)
        )
        self._counts: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # bucket index -> last-K [(exemplar_id, value), ...].
        self.exemplar_k = DEFAULT_EXEMPLAR_K
        self._exemplars: dict[int, list] = {}
        self._lock = threading.Lock()

    # -- geometry ----------------------------------------------------------

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.ceil(math.log(v / self.lo) / self._log_growth))
        # Float round-off at an exact edge: nudge so v <= upper(i) holds.
        if self.lo * self.growth ** (i - 1) >= v:
            i -= 1
        return min(max(i, 1), self.n_buckets + 1)

    def bucket_bounds(self, i: int) -> tuple[float, float]:
        """``(lower, upper]`` of bucket ``i`` (underflow lower is 0;
        overflow upper is +inf until a sample narrows it to ``max``)."""
        if i <= 0:
            return 0.0, self.lo
        if i > self.n_buckets:
            return self.lo * self.growth ** self.n_buckets, math.inf
        return (self.lo * self.growth ** (i - 1),
                self.lo * self.growth ** i)

    def same_geometry(self, other: "LogHistogram") -> bool:
        return (self.lo == other.lo and self.hi == other.hi
                and self.growth == other.growth)

    # -- recording ---------------------------------------------------------

    def record(self, v: float, exemplar: str | None = None) -> None:
        """Record one sample; ``exemplar`` (a trace_id) rides into the
        sample's bucket, displacing the oldest of that bucket's last-K
        — how a latency histogram keeps concrete traces per bucket
        without unbounded growth."""
        v = float(v)
        if math.isnan(v):
            return  # a NaN latency is a caller bug, never a bin
        v = max(v, 0.0)
        i = self._index(v)
        with self._lock:
            self._counts[i] = self._counts.get(i, 0) + 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if exemplar is not None:
                ex = self._exemplars.setdefault(i, [])
                ex.append((str(exemplar), v))
                if len(ex) > self.exemplar_k:
                    del ex[0]

    def record_many(self, values) -> None:
        for v in values:
            self.record(v)

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other``'s counts into self (identical geometry only —
        merging mismatched bucketings would silently corrupt counts)."""
        if not self.same_geometry(other):
            raise ValueError(
                "cannot merge histograms with different geometry: "
                f"(lo={self.lo}, hi={self.hi}, growth={self.growth}) vs "
                f"(lo={other.lo}, hi={other.hi}, growth={other.growth})"
            )
        with other._lock:
            counts = dict(other._counts)
            o_count, o_sum = other.count, other.sum
            o_min, o_max = other.min, other.max
            o_ex = {i: list(ex) for i, ex in other._exemplars.items()}
        with self._lock:
            for i, c in counts.items():
                self._counts[i] = self._counts.get(i, 0) + c
            self.count += o_count
            self.sum += o_sum
            self.min = min(self.min, o_min)
            self.max = max(self.max, o_max)
            for i, oex in o_ex.items():
                ex = self._exemplars.setdefault(i, [])
                ex.extend(oex)
                if len(ex) > self.exemplar_k:
                    del ex[: len(ex) - self.exemplar_k]
        return self

    # -- percentiles -------------------------------------------------------

    def percentile(self, p: float) -> dict:
        """Bounded-error percentile estimate.

        Returns ``{"value", "lower", "upper", "max_error"}`` where the
        nearest-rank percentile provably lies in ``(lower, upper]``,
        ``value`` is the bucket's geometric midpoint, and ``max_error``
        = ``max(value - lower, upper - value)`` < one bucket width —
        the flagged bound the estimate always travels with. Zeros when
        the histogram is empty (a server that served nothing)."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        with self._lock:
            count = self.count
            counts = sorted(self._counts.items())
            vmin, vmax = self.min, self.max
        if count == 0:
            return {"value": 0.0, "lower": 0.0, "upper": 0.0,
                    "max_error": 0.0}
        rank = max(1, int(math.ceil(p / 100.0 * count)))
        seen = 0
        idx = counts[-1][0]
        for i, c in counts:
            seen += c
            if seen >= rank:
                idx = i
                break
        lower, upper = self.bucket_bounds(idx)
        # Exact extremes narrow the open-ended bins (and every bin: no
        # estimate may leave the observed range).
        lower = max(lower, 0.0 if vmin is math.inf else min(vmin, upper))
        upper = min(upper, vmax) if vmax > -math.inf else upper
        upper = max(upper, lower)
        if lower <= 0.0:
            value = upper / 2.0
        else:
            value = math.sqrt(lower * upper)
        return {
            "value": value,
            "lower": lower,
            "upper": upper,
            "max_error": max(value - lower, upper - value),
        }

    def percentiles(self, pcts=(50, 99), *, key: str = "p{p}_ms") -> dict:
        """``{"p50_ms": est, "p50_err_ms": bound, ...}`` — the estimate
        never travels without its error bound."""
        out = {}
        for p in pcts:
            r = self.percentile(p)
            label = key.format(p=p)
            out[label] = r["value"]
            out[label.replace("_ms", "_err_ms")
                if label.endswith("_ms") else label + "_err"] = (
                r["max_error"]
            )
        return out

    # -- exports -----------------------------------------------------------

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """Prometheus-convention cumulative buckets: ``(le, cum_count)``
        per occupied prefix (upper edges strictly increasing, counts
        non-decreasing), ending with ``(inf, count)``."""
        with self._lock:
            counts = sorted(self._counts.items())
            total = self.count
        out: list[tuple[float, int]] = []
        cum = 0
        for i, c in counts:
            cum += c
            _, upper = self.bucket_bounds(i)
            if math.isinf(upper):
                break
            out.append((upper, cum))
        out.append((math.inf, total))
        return out

    def bucket_exemplars(self) -> dict:
        """Latest exemplar per occupied bucket, keyed by the bucket's
        Prometheus ``le`` edge (the same edges
        :meth:`cumulative_buckets` emits; the overflow bucket maps to
        the ``+Inf`` edge): ``{le: (exemplar_id, value)}``. Feeds the
        OpenMetrics exemplar suffix in
        ``telemetry.write_prom_metrics(..., exemplars=True)``."""
        with self._lock:
            ex = {i: list(v) for i, v in self._exemplars.items()}
        out = {}
        for i, pairs in ex.items():
            if not pairs:
                continue
            _, upper = self.bucket_bounds(i)
            out[upper] = pairs[-1]
        return out

    def tail_exemplars(self, limit: int = DEFAULT_EXEMPLAR_K) -> list:
        """``[(exemplar_id, value), ...]`` from the slowest occupied
        buckets downward (newest first within a bucket) — the "show me
        the traces behind the p99" accessor ``pjtpu top`` and
        ``slo_report.py`` render."""
        with self._lock:
            ex = sorted(self._exemplars.items(), reverse=True)
        out: list = []
        for _i, pairs in ex:
            for pair in reversed(pairs):
                out.append(tuple(pair))
                if len(out) >= limit:
                    return out
        return out

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "lo": self.lo,
                "hi": self.hi,
                "growth": self.growth,
                "buckets": {str(i): c for i, c in
                            sorted(self._counts.items())},
                "count": self.count,
                "sum": self.sum,
                "min": None if self.min is math.inf else self.min,
                "max": None if self.max == -math.inf else self.max,
                **({"exemplars": {str(i): [[e, v] for e, v in ex]
                                  for i, ex in
                                  sorted(self._exemplars.items())}}
                   if self._exemplars else {}),
            }

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        h = cls(lo=float(d["lo"]), hi=float(d["hi"]),
                growth=float(d["growth"]))
        h._counts = {int(i): int(c) for i, c in (d.get("buckets") or
                                                 {}).items()}
        h.count = int(d.get("count", sum(h._counts.values())))
        h.sum = float(d.get("sum", 0.0))
        h.min = math.inf if d.get("min") is None else float(d["min"])
        h.max = -math.inf if d.get("max") is None else float(d["max"])
        h._exemplars = {
            int(i): [(str(e), float(v)) for e, v in ex][-h.exemplar_k:]
            for i, ex in (d.get("exemplars") or {}).items()
        }
        return h

    def summary(self, pcts=(50, 99)) -> dict:
        """Compact snapshot payload: count/sum/min/max + bounded
        percentiles + the full sparse dict (so snapshots stay mergeable
        offline)."""
        out = {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(self.sum / self.count, 6) if self.count else 0.0,
            "min": None if self.min is math.inf else round(self.min, 6),
            "max": None if self.max == -math.inf else round(self.max, 6),
            **{k: round(v, 6) for k, v in self.percentiles(pcts).items()},
            "hist": self.as_dict(),
        }
        return out


def tail_exemplars_from_dict(hist_dict: dict | None,
                             limit: int = DEFAULT_EXEMPLAR_K) -> list:
    """:meth:`LogHistogram.tail_exemplars` over the serialized
    ``as_dict`` form — what ``pjtpu top`` / ``slo_report.py`` render
    straight from a snapshot JSON without rebuilding the histogram."""
    ex = (hist_dict or {}).get("exemplars") or {}
    out: list = []
    for i in sorted((int(k) for k in ex), reverse=True):
        for pair in reversed(ex[str(i)]):
            out.append((str(pair[0]), float(pair[1])))
            if len(out) >= limit:
                return out
    return out


class RateCounter:
    """Sliding-window event counter: exact monotone ``total`` plus
    windowed rates from sparse per-``resolution_s`` bins (memory bounded
    by ``window_s / resolution_s`` occupied bins). Thread-safe; ``now``
    is injectable everywhere so tests and replayers control the clock."""

    __slots__ = ("window_s", "resolution_s", "_bins", "total", "_lock")

    def __init__(self, *, window_s: float = 3600.0,
                 resolution_s: float = 1.0) -> None:
        if not (window_s > 0 and resolution_s > 0):
            raise ValueError("window_s and resolution_s must be > 0")
        self.window_s = float(window_s)
        self.resolution_s = float(resolution_s)
        self._bins: dict[int, float] = {}
        self.total = 0.0
        self._lock = threading.Lock()

    def _bin(self, now: float) -> int:
        return int(now // self.resolution_s)

    def _prune(self, now: float) -> None:
        horizon = self._bin(now - self.window_s)
        if len(self._bins) > 2 * int(self.window_s / self.resolution_s):
            for b in [b for b in self._bins if b < horizon]:
                del self._bins[b]

    def add(self, n: float = 1.0, *, now: float | None = None) -> None:
        now = time.time() if now is None else now
        b = self._bin(now)
        with self._lock:
            self._bins[b] = self._bins.get(b, 0.0) + n
            self.total += n
            self._prune(now)

    def count_in(self, window_s: float, *, now: float | None = None) -> float:
        """Events in the trailing ``window_s`` (clamped to the counter's
        own window — it cannot answer for longer than it remembers)."""
        now = time.time() if now is None else now
        window_s = min(float(window_s), self.window_s)
        horizon = self._bin(now - window_s)
        with self._lock:
            return sum(c for b, c in self._bins.items()
                       if horizon < b <= self._bin(now))

    def rate(self, window_s: float = 60.0, *,
             now: float | None = None) -> float:
        """Events/second over the trailing window."""
        window_s = min(float(window_s), self.window_s)
        if window_s <= 0:
            return 0.0
        return self.count_in(window_s, now=now) / window_s


# -- SLOs and burn rates ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLO:
    """One service-level objective over a request stream.

    An event is BAD when it errored or exceeded ``latency_ms`` (the
    combined formulation: latency violations spend the same error
    budget as failures, so one burn-rate number covers both targets).
    ``availability`` is the good-fraction target; the error budget is
    ``1 - availability``. ``rules`` are multi-window burn-rate alerts
    ``(long_window_s, short_window_s, burn_threshold)``: the SLO is
    *burning* when ANY rule sees burn-rate >= threshold over BOTH its
    windows (the short window arms fast detection, the long window
    stops one bad batch from flapping the alert). Defaults are the
    SRE-workbook pair scaled to process lifetimes this repo runs
    (minutes-hours, not 30-day pages)."""

    name: str
    latency_ms: float
    latency_pct: float = 99.0
    availability: float = 0.999
    rules: tuple = ((300.0, 60.0, 14.4), (3600.0, 300.0, 6.0))

    def __post_init__(self):
        if not 0.0 < self.availability < 1.0:
            raise ValueError(
                f"availability must be in (0, 1), got {self.availability}"
            )
        if not self.latency_ms > 0:
            raise ValueError(f"latency_ms must be > 0, got {self.latency_ms}")
        for rule in self.rules:
            long_w, short_w, thr = rule
            if not (long_w >= short_w > 0 and thr > 0):
                raise ValueError(f"bad burn rule {rule!r}: need "
                                 "long >= short > 0 and threshold > 0")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.availability

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "latency_ms": self.latency_ms,
            "latency_pct": self.latency_pct,
            "availability": self.availability,
            "rules": [list(r) for r in self.rules],
        }


class SLOTracker:
    """Evaluates one :class:`SLO` against a live stream of observations.

    ``observe(latency_ms, ok)`` files the event good/bad;
    ``evaluate(now)`` computes per-rule burn rates (bad-fraction over
    the window divided by the error budget) and the burning verdict.
    The owning registry emits the ``slo_burn`` telemetry event on the
    not-burning -> burning transition."""

    def __init__(self, slo: SLO, *, histogram: LogHistogram | None = None):
        self.slo = slo
        self.histogram = histogram
        window = max(long_w for long_w, _, _ in slo.rules)
        self.good = RateCounter(window_s=window)
        self.bad = RateCounter(window_s=window)
        self.burning = False

    def observe(self, latency_ms: float | None, *, ok: bool = True,
                now: float | None = None) -> None:
        is_bad = (not ok) or (
            latency_ms is not None and latency_ms > self.slo.latency_ms
        )
        (self.bad if is_bad else self.good).add(1.0, now=now)

    def burn_rate(self, window_s: float, *, now: float | None = None) -> float:
        """Error-budget burn over one window: bad-fraction / budget.
        1.0 = burning exactly at budget (sustainable); >> 1 = the
        budget is being spent that many times too fast; 0 with no
        traffic (an idle service is not failing)."""
        bad = self.bad.count_in(window_s, now=now)
        total = bad + self.good.count_in(window_s, now=now)
        if total <= 0:
            return 0.0
        return (bad / total) / self.slo.error_budget

    def evaluate(self, *, now: float | None = None) -> dict:
        now = time.time() if now is None else now
        rules = []
        burning = False
        worst = 0.0
        for long_w, short_w, threshold in self.slo.rules:
            b_long = self.burn_rate(long_w, now=now)
            b_short = self.burn_rate(short_w, now=now)
            firing = b_long >= threshold and b_short >= threshold
            burning = burning or firing
            worst = max(worst, min(b_long, b_short))
            rules.append({
                "long_window_s": long_w, "short_window_s": short_w,
                "threshold": threshold,
                "burn_long": round(b_long, 4),
                "burn_short": round(b_short, 4),
                "firing": firing,
            })
        out = {
            "objective": self.slo.as_dict(),
            "events_total": self.good.total + self.bad.total,
            "bad_total": self.bad.total,
            "burn_rate": round(worst, 4),
            "burning": burning,
            "rules": rules,
        }
        if self.histogram is not None and self.histogram.count:
            pr = self.histogram.percentile(self.slo.latency_pct)
            out["latency"] = {
                "pct": self.slo.latency_pct,
                "observed_ms": round(pr["value"], 4),
                "max_error_ms": round(pr["max_error"], 4),
                "target_ms": self.slo.latency_ms,
                # The honest tri-state: the bucket bound may straddle
                # the target, in which case the verdict says so rather
                # than picking a side.
                "met": (True if pr["upper"] <= self.slo.latency_ms
                        else False if pr["lower"] > self.slo.latency_ms
                        else "within-error-bound"),
            }
        return out


# -- the registry -------------------------------------------------------------


class MetricsRegistry:
    """Shared live-metrics façade: named histograms, rate counters,
    gauges, and SLO trackers, with periodic atomic snapshots.

    The snapshotter is the ``HeartbeatReporter`` idiom: a daemon thread
    serializes :meth:`snapshot` every ``interval_s`` and publishes via
    tmp-write + ``os.replace`` — a concurrent reader (``pjtpu top``)
    never sees a torn file, and a SIGKILLed process leaves a view
    fresh to within one interval. Every publish also appends one
    compact history line (ts, totals, burn rates) to
    ``<name>_history.jsonl`` beside the snapshot — the burn-rate
    trajectory the offline reader renders."""

    def __init__(self, *, label: str = "metrics", telemetry=None) -> None:
        self.label = label
        self.telemetry = telemetry
        self._hists: dict[str, LogHistogram] = {}
        self._counters: dict[str, RateCounter] = {}
        self._gauges: dict[str, float] = {}
        self._slos: dict[str, SLOTracker] = {}
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._seq = 0
        self.write_errors = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._snapshot_path: Path | None = None
        self._history = True

    enabled = True

    def __bool__(self) -> bool:
        return True

    # -- instruments -------------------------------------------------------

    def histogram(self, name: str, **kwargs) -> LogHistogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LogHistogram(**kwargs)
            return h

    def counter(self, name: str, **kwargs) -> RateCounter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = RateCounter(**kwargs)
            return c

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def slo(self, objective: SLO, *,
            histogram: str | None = None) -> SLOTracker:
        """Register (or fetch) the tracker for ``objective``;
        ``histogram`` names the registry histogram its latency verdict
        reads (usually the one the same events are recorded into)."""
        with self._lock:
            t = self._slos.get(objective.name)
            if t is None:
                hist = self._hists.get(histogram) if histogram else None
                t = self._slos[objective.name] = SLOTracker(
                    objective, histogram=hist
                )
            return t

    def observe_slo(self, name: str, latency_ms: float | None, *,
                    ok: bool = True, now: float | None = None) -> None:
        """File one event against a registered SLO and fire the
        ``slo_burn`` transition event when it tips into burning."""
        t = self._slos.get(name)
        if t is None:
            return
        t.observe(latency_ms, ok=ok, now=now)
        verdict = t.evaluate(now=now)
        if verdict["burning"] and not t.burning:
            t.burning = True
            if self.telemetry is not None:
                self.telemetry.event(
                    "slo_burn", slo=name,
                    burn_rate=verdict["burn_rate"],
                    bad_total=verdict["bad_total"],
                )
        elif not verdict["burning"]:
            t.burning = False

    def slo_burn_gauge(self) -> dict:
        """``{slo_name: worst burn rate}`` — the labeled
        ``pjtpu_slo_burn_rate`` prometheus gauge's samples."""
        with self._lock:
            trackers = dict(self._slos)
        return {name: t.evaluate()["burn_rate"]
                for name, t in trackers.items()}

    # -- snapshots ---------------------------------------------------------

    def snapshot(self, *, now: float | None = None,
                 rate_windows=(60.0, 300.0)) -> dict:
        now = time.time() if now is None else now
        with self._lock:
            hists = dict(self._hists)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            slos = dict(self._slos)
            self._seq += 1
            seq = self._seq
        return {
            "version": SNAPSHOT_VERSION,
            "kind": "live_metrics",
            "label": self.label,
            "ts": now,
            "seq": seq,
            "pid": os.getpid(),
            "uptime_s": round(time.perf_counter() - self._t0, 3),
            "counters": {
                name: {
                    "total": c.total,
                    **{f"rate_{int(w)}s": round(c.rate(w, now=now), 6)
                       for w in rate_windows},
                }
                for name, c in sorted(counters.items())
            },
            "gauges": {k: v for k, v in sorted(gauges.items())},
            "histograms": {
                name: h.summary() for name, h in sorted(hists.items())
            },
            "slos": {
                name: t.evaluate(now=now)
                for name, t in sorted(slos.items())
            },
        }

    def write_snapshot(self, path: str | Path, *,
                       now: float | None = None) -> Path:
        """One atomic publish (+ a compact history append)."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        snap = self.snapshot(now=now)
        tmp = p.with_name(p.name + f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(snap), encoding="utf-8")
        os.replace(tmp, p)
        if self._history:
            try:
                line = {
                    "ts": snap["ts"],
                    "seq": snap["seq"],
                    "label": snap["label"],
                    "counters": {n: c["total"]
                                 for n, c in snap["counters"].items()},
                    "slos": {
                        n: {"burn_rate": s["burn_rate"],
                            "burning": s["burning"],
                            "bad_total": s["bad_total"]}
                        for n, s in snap["slos"].items()
                    },
                }
                hist_path = p.with_name(p.stem + "_history.jsonl")
                with open(hist_path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(line) + "\n")
            except OSError:
                self.write_errors += 1
        return p

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.write_snapshot(self._snapshot_path)
            except Exception:  # noqa: BLE001 — metrics must never kill work
                self.write_errors += 1

    def start_snapshotter(self, path: str | Path,
                          interval_s: float = 5.0, *,
                          history: bool = True) -> "MetricsRegistry":
        """Publish to ``path`` every ``interval_s`` on a daemon thread
        (first write immediately, so liveness is visible before the
        first interval elapses)."""
        if not interval_s > 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if self._thread is None:
            self._snapshot_path = Path(path)
            self._history = history
            self._stop.clear()
            try:
                self.write_snapshot(self._snapshot_path)
            except Exception:  # noqa: BLE001
                self.write_errors += 1
            self._thread = threading.Thread(
                target=self._loop, args=(float(interval_s),),
                name=f"pj-metrics-{self.label}", daemon=True,
            )
            self._thread.start()
        return self

    def stop_snapshotter(self, *, final_write: bool = True) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        if final_write and self._snapshot_path is not None:
            try:
                self.write_snapshot(self._snapshot_path)
            except Exception:  # noqa: BLE001
                self.write_errors += 1


class _NullMetrics:
    """The disabled path: all hot-path call sites are wired
    unconditionally; this object makes ``metrics=None`` near-free (no
    allocation, no locking, no IO) — the ``NULL_TELEMETRY`` pattern."""

    __slots__ = ()
    enabled = False

    def __bool__(self) -> bool:
        return False

    def histogram(self, name, **kwargs):
        return _NULL_HIST

    def counter(self, name, **kwargs):
        return _NULL_COUNTER

    def gauge(self, name, value):
        return None

    def slo(self, objective, *, histogram=None):
        return None

    def observe_slo(self, name, latency_ms, *, ok=True, now=None):
        return None

    def slo_burn_gauge(self):
        return {}

    def snapshot(self, *, now=None, rate_windows=(60.0, 300.0)):
        return {}

    def write_snapshot(self, path, *, now=None):
        return None

    def start_snapshotter(self, path, interval_s=5.0, *, history=True):
        return self

    def stop_snapshotter(self, *, final_write=True):
        return None


class _NullHistogram:
    __slots__ = ()
    count = 0
    sum = 0.0

    def record(self, v, exemplar=None):
        return None

    def record_many(self, values):
        return None

    def bucket_exemplars(self):
        return {}

    def tail_exemplars(self, limit=4):
        return []

    def percentile(self, p):
        return {"value": 0.0, "lower": 0.0, "upper": 0.0, "max_error": 0.0}

    def percentiles(self, pcts=(50, 99), *, key="p{p}_ms"):
        return {}

    def summary(self, pcts=(50, 99)):
        return {}


class _NullCounter:
    __slots__ = ()
    total = 0.0

    def add(self, n=1.0, *, now=None):
        return None

    def count_in(self, window_s, *, now=None):
        return 0.0

    def rate(self, window_s=60.0, *, now=None):
        return 0.0


_NULL_HIST = _NullHistogram()
_NULL_COUNTER = _NullCounter()
NULL_METRICS = _NullMetrics()


def resolve_metrics(metrics) -> "MetricsRegistry | _NullMetrics":
    """``config.metrics`` (or None) -> the object hot paths call."""
    return metrics if metrics is not None else NULL_METRICS


# -- snapshot readers (pjtpu top / slo_report) --------------------------------


def read_snapshot(path: str | Path) -> dict | None:
    """Parse one snapshot file; None when absent or torn (atomic
    publish means torn never legitimately happens — but a reader tool
    must degrade to "no information", not crash)."""
    p = Path(path)
    try:
        data = json.loads(p.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def snapshot_age_s(snap: dict | None, *, now: float | None = None) -> float | None:
    """Seconds since the snapshot's own publish stamp (its ``ts``) —
    the staleness clock ``pjtpu top`` flags dead processes by."""
    if snap is None or "ts" not in snap:
        return None
    return (time.time() if now is None else now) - float(snap["ts"])


def read_history(path: str | Path, *, limit: int | None = None) -> list[dict]:
    """Parse a ``*_history.jsonl`` (torn trailing line tolerated, the
    flight-recorder convention). ``limit`` keeps the newest N lines."""
    p = Path(path)
    try:
        lines = p.read_text(encoding="utf-8").splitlines()
    except OSError:
        return []
    out = []
    for n, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            if n != len(lines) - 1:
                raise ValueError(
                    f"{p}:{n + 1}: corrupt history line (not the last "
                    "line — this is not kill damage)"
                ) from None
    return out[-limit:] if limit else out
