"""Query engine: source-batched lookups over a :class:`TileStore`.

The PyTorch port of the JAX package's ``serve/engine.py``: the engine's
exact-miss solves and its device lookup path run on ``device`` (the
card by default).

The serving front end: point-to-point and one-to-many
queries from many concurrent clients are AGGREGATED — one
:meth:`QueryEngine.query_batch` call resolves each distinct source row
once (hot/warm/cold tier walk), and every source that misses the store
is solved in ONE exact batch through the ordinary resilient solver
(``ParallelJohnsonSolver.solve`` — retries, watchdog deadlines, OOM
batch degradation, and the pipelined fan-out all apply; with a
checkpoint-backed store the new rows also land on disk, growing the
cold tier for the next process). Alternatively (``miss_policy=
"landmark"``) a miss answers immediately from the landmark index with a
certified ``(estimate, max_error)`` — never an unflagged approximation.

The exact-vs-approximate contract every response carries:

- ``exact: true`` — the distance is bitwise the solver's output for
  (graph, source, dst); ``max_error`` is 0.
- ``exact: false`` — ``distance`` is the landmark upper bound and
  ``|distance - d(s, t)| <= max_error`` (``max_error`` may be +inf when
  the landmarks carry no information about the pair — the caller sees
  exactly how much the answer is worth).
- ``stale: true`` (with ``exact: true``) — the distance is bitwise the
  solver's output for the PRE-update graph; ``max_error`` is then the
  landmark interval width for the pair: an honest
  ESTIMATE of how far the served value may drift from the repaired
  graph's answer, shaped exactly like a certified-shed response (+inf
  when no landmark index is attached — the estimate is never silently
  absent, and never silently zero).

Lookup dispatch: each aggregated batch's lookup
work — exact hot hits plus landmark bounds — goes through the priced
planner registry (``planner.LOOKUP_PLANS``). The ``device_lookup`` plan
megabatches the batch into one gather per query class over the store's
device tile (``serve/device_query.py``, torch ops on the engine's
device); ``host_lookup`` is the per-source tier walk. Answers are
bitwise-identical either way (the device path's design invariant), so
forcing either path via the engine's
``device_lookup`` tristate reproduces the other bit for bit; tiny
batches and CPU platforms keep the host path by qualification, and the
per-batch decision (with its why-line) is kept on
``engine.last_lookup_decision``. A fault of the device path raises on a
CUDA engine, ``auto`` included; only a CPU engine's ``auto`` records it
in the why-line and takes the host walk.

Concurrency: the engine is thread-safe — one re-entrant
lock serializes the batch pipeline (tier walk, scheduled solve, counter
updates), so K client threads hammering :meth:`query_batch` get exact
answers, lost-increment-free counters, and still exactly ONE scheduled
solve per aggregated miss batch. Latency samples include lock wait —
queueing delay is real serving latency, not overhead to hide.

Live metrics: per-query latency streams into a log-bucketed
:class:`~paralleljohnson_tpu_torch.observe.live.LogHistogram` (bounded
memory, exact counts, percentile error bounded by one bucket width and
reported beside the estimate) instead of the old unbounded sample
list; hit-tier / stale / error counts feed sliding-window rate
counters; an optional :class:`~paralleljohnson_tpu_torch.observe.live.SLO`
is evaluated with multi-window burn-rate rules (``slo_burn`` flight
events + the ``pjtpu_slo_burn_rate`` gauge). With a checkpoint-backed
store, ``serve_stats.json`` is atomically REWRITTEN every
``stats_interval_s`` while the engine serves (the heartbeat idiom) —
a SIGKILLed serve process leaves usable stats, fresh to within one
interval, plus a final write at :meth:`close`.

Telemetry: every batch is a ``serve_batch`` span, every query a
``query`` span; heartbeat progress carries
``queries_done``; :meth:`write_metrics` exports ``pjtpu_queries_total``
/ ``pjtpu_query_latency_ms`` (a real Prometheus histogram — use
``histogram_quantile`` for percentiles; there are no p50/p99
gauges)
through the same atomic ``write_prom_metrics`` writer the solver
uses.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import weakref
from pathlib import Path

import types

import numpy as np
import torch

from paralleljohnson_tpu_torch import planner as _planner
from paralleljohnson_tpu_torch.observe import current_platform
from paralleljohnson_tpu_torch.observe.live import (
    SLO,
    LogHistogram,
    MetricsRegistry,
)
from paralleljohnson_tpu_torch.serve import device_query as _device_query
from paralleljohnson_tpu_torch.serve.landmarks import (
    finish_estimates,
    widen_bounds,
)
from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from paralleljohnson_tpu_torch.utils.telemetry import resolve as _resolve_telemetry
from paralleljohnson_tpu_torch.utils.telemetry import write_prom_metrics

SERVE_STATS_FILENAME = "serve_stats.json"
SERVE_LIVE_FILENAME = "serve_live.json"

# Default periodic serve_stats.json rewrite interval; 0/None disables.
DEFAULT_STATS_INTERVAL_S = 5.0

# The default serving objective `pjtpu serve` runs under when no SLO is
# configured explicitly: 99.9% of queries good, p99 under 250 ms. The
# CLI overrides via --slo-p99-ms / --slo-availability.
DEFAULT_SLO = SLO(name="serve", latency_ms=250.0, latency_pct=99.0,
                  availability=0.999)


@dataclasses.dataclass
class ServeStats:
    """Per-engine query counters + a streaming latency histogram.

    The histogram absorbs any query volume in bounded memory with exact
    counts; only percentile positions are bucket-rounded, and every
    estimate travels with that bound (``p50_err_ms`` / ``p99_err_ms``).
    """

    queries_total: int = 0
    exact_answers: int = 0
    approx_answers: int = 0
    # Certified approximate tier split: how many of the
    # approximate answers came from the hopset tier (composed hopset +
    # landmark bounds, tighter wins) vs the plain landmark walk.
    hopset_answers: int = 0
    errors: int = 0
    batches_scheduled: int = 0
    solved_sources: int = 0
    stale_answers: int = 0
    # Traffic-front-end counters: maintained by the socket
    # frontend (the engine never sheds or rejects by itself) but kept
    # here so serve_stats.json / pjtpu top / prom all read ONE set of
    # serving counters regardless of which loop drove the engine.
    shed_answers: int = 0
    rejected: int = 0
    deadline_drops: int = 0
    # Per-client fairness: requests rejected at a client's
    # own in-flight cap while the rest of the fleet kept flowing.
    client_limited: int = 0
    open_connections: int = 0
    # Lookup-path accounting: which dispatch served each
    # answered query — the device megabatch or the host tier walk —
    # plus the width distribution of the device megabatches (the whole
    # point of aggregating: widths near 1 mean the batching isn't
    # happening and the launch overhead is pure loss).
    device_lookups: int = 0
    host_lookups: int = 0
    hits_by_tier: dict = dataclasses.field(default_factory=dict)
    hist: LogHistogram = dataclasses.field(default_factory=LogHistogram)
    batch_hist: LogHistogram = dataclasses.field(default_factory=LogHistogram)

    def record_latency(self, ms: float,
                       exemplar: str | None = None) -> None:
        # ``exemplar`` is the request's trace_id: it rides
        # into the latency bucket so "p99 = 38 ms" links to concrete
        # assembled traces (prom exemplars, `pjtpu top`, slo_report).
        self.hist.record(float(ms), exemplar=exemplar)

    def percentiles(self) -> dict:
        """``{"p50_ms", "p50_err_ms", "p99_ms", "p99_err_ms"}`` — the
        streaming estimates with their one-bucket error bounds."""
        if self.hist.count == 0:
            return {"p50_ms": 0.0, "p50_err_ms": 0.0,
                    "p99_ms": 0.0, "p99_err_ms": 0.0}
        return self.hist.percentiles((50, 99))

    def as_dict(self) -> dict:
        return {
            "queries_total": self.queries_total,
            "exact_answers": self.exact_answers,
            "approx_answers": self.approx_answers,
            "hopset_answers": self.hopset_answers,
            "errors": self.errors,
            "batches_scheduled": self.batches_scheduled,
            "solved_sources": self.solved_sources,
            "stale_answers": self.stale_answers,
            "shed_answers": self.shed_answers,
            "rejected": self.rejected,
            "deadline_drops": self.deadline_drops,
            "client_limited": self.client_limited,
            "open_connections": self.open_connections,
            "device_lookups": self.device_lookups,
            "host_lookups": self.host_lookups,
            "hits_by_tier": dict(self.hits_by_tier),
            **{k: round(v, 4) for k, v in self.percentiles().items()},
            **({} if self.batch_hist.count == 0 else {
                k: round(v, 4) for k, v in self.batch_hist.percentiles(
                    (50, 99), key="batch_width_p{p}").items()
            }),
        }


# Prometheus table for :func:`write_prom_metrics` — the getters take the
# ENGINE (stats + store hit-rate live on different objects).
SERVE_PROM_METRICS = (
    ("pjtpu_queries_total", "counter",
     "Queries answered by the serving engine",
     lambda e: e.stats.queries_total),
    ("pjtpu_query_errors_total", "counter",
     "Malformed or out-of-range queries rejected",
     lambda e: e.stats.errors),
    ("pjtpu_query_exact_total", "counter",
     "Queries answered exactly (store row or scheduled solve)",
     lambda e: e.stats.exact_answers),
    ("pjtpu_query_approx_total", "counter",
     "Queries answered from the landmark index (with max_error)",
     lambda e: e.stats.approx_answers),
    # Certified approximate tier: every counted answer is
    # flagged exact: false and carries a certified max_error.
    ("pjtpu_approx_answers_total", "counter",
     "Queries answered by a certified approximate tier (landmark or "
     "hopset) — every one flagged exact: false with a max_error",
     lambda e: e.stats.approx_answers),
    ("pjtpu_hopset_answers_total", "counter",
     "Queries answered by the hopset tier (composed hopset + landmark "
     "bounds, tighter wins)",
     lambda e: e.stats.hopset_answers),
    ("pjtpu_hopset_edges", "gauge",
     "Edges in the attached (1+eps) hopset (0 = no hopset attached)",
     lambda e: 0 if e.hopset is None else e.hopset.num_hopset_edges),
    ("pjtpu_serve_batches_scheduled_total", "counter",
     "Exact solve batches the engine scheduled for store misses",
     lambda e: e.stats.batches_scheduled),
    ("pjtpu_stale_answers_total", "counter",
     "Answers served from a pre-update checkpoint while (or after) an "
     "incremental repair ran — every one carries stale: true",
     lambda e: e.stats.stale_answers),
    # Traffic-front-end counters: certified shedding,
    # admission rejections, deadline drops, live connection gauge.
    ("pjtpu_shed_answers_total", "counter",
     "Exact-miss queries downgraded to flagged landmark answers while "
     "the burn-rate alert fired (every one carries shed: true + a "
     "certified max_error)",
     lambda e: e.stats.shed_answers),
    ("pjtpu_rejected_total", "counter",
     "Connections/requests rejected by admission control (explicit "
     "overloaded + retry_after_ms, never an unbounded queue)",
     lambda e: e.stats.rejected),
    ("pjtpu_deadline_drops_total", "counter",
     "Requests dropped because they could not start before their "
     "deadline_ms (rejected without touching the engine)",
     lambda e: e.stats.deadline_drops),
    ("pjtpu_client_limited_total", "counter",
     "Requests rejected at their client's per-key in-flight cap "
     "(fairness: the hog is limited while other clients keep flowing)",
     lambda e: e.stats.client_limited),
    ("pjtpu_open_connections", "gauge",
     "Client connections currently open on the socket frontend",
     lambda e: e.stats.open_connections),
    ("pjtpu_query_hit_rate", "gauge",
     "Fraction of row lookups served by a store tier (hot/warm/cold)",
     lambda e: e.store.hit_rate()),
    # Lookup-path dispatch: device megabatch vs host walk,
    # plus the device megabatch width distribution.
    ("pjtpu_device_lookups_total", "counter",
     "Queries answered by the device-resident megabatch path (bitwise "
     "identical to the host walk by design)",
     lambda e: e.stats.device_lookups),
    ("pjtpu_host_lookups_total", "counter",
     "Queries answered by the per-source host tier walk",
     lambda e: e.stats.host_lookups),
    ("pjtpu_lookup_batch_width", "histogram",
     "Width (queries per launch) of device lookup megabatches",
     lambda e: e.stats.batch_hist),
    # The real latency distribution: cumulative _bucket /
    # _sum / _count lines so PromQL histogram_quantile works...
    ("pjtpu_query_latency_ms", "histogram",
     "Per-query latency distribution (log-bucketed streaming histogram; "
     "percentile error bounded by one bucket width ~19%)",
     lambda e: e.stats.hist),
    # Percentiles: histogram_quantile(0.99,
    # rate(pjtpu_query_latency_ms_bucket[5m])).
    ("pjtpu_slo_burn_rate", "gauge",
     "Error-budget burn rate per registered SLO (1 = spending exactly "
     "the budget; the multi-window alert fires per the SLO's rules)",
     lambda e: e.metrics.slo_burn_gauge(), "slo"),
)

_MISS_POLICIES = ("solve", "landmark", "hopset")

# Lookup-path tristate: "auto" lets the planner registry
# choose per batch, "on"/"off" pin the device megabatch / host walk
# (both answer bitwise-identically — the pin is for benchmarking and
# for platforms where auto-qualification guesses wrong).
_DEVICE_LOOKUP_MODES = ("auto", "on", "off")

# rows[] sentinel marking a source whose values arrive from the device
# megabatch rather than a host row reference.
_DEVICE_ROW = object()


def _host_values(row, dsts) -> np.ndarray:
    """f64 host values of one store row (a host array, or a tensor on
    the card from a single-batch solve) at ``dsts`` (None: the full
    row). A device row is indexed where it lives and only the picked
    entries are copied."""
    if isinstance(row, torch.Tensor) and dsts is not None:
        row = row.index_select(
            0, torch.as_tensor(np.asarray(dsts, np.int64), device=row.device))
    elif dsts is not None:
        row = row[dsts]
    return np.asarray(to_numpy(row), np.float64)


class QueryError(ValueError):
    """A malformed request (bad JSON shape, out-of-range vertex)."""


class QueryEngine:
    """Answers queries over one graph from a tile store (+ optional
    landmark index). ``config`` is the :class:`SolverConfig` the
    exact-miss solver runs under; its ``checkpoint_dir`` is overridden
    to the store's backing directory so scheduled batches persist into
    the cold tier (or to None for an in-memory store).

    ``metrics``: a shared :class:`MetricsRegistry` (one is created per
    engine when None). ``slo``: the serving objective to evaluate
    (None = :data:`DEFAULT_SLO`). ``stats_interval_s``: period of the
    live ``serve_stats.json`` rewrite for checkpoint-backed stores
    (started lazily with the first served batch; 0 disables).
    ``device``: where the exact-miss solves and the device lookup path
    run (the card unless the caller asks for the CPU; without a card a
    CUDA request raises ``RuntimeError``)."""

    def __init__(self, graph, store, *, landmarks=None, hopset=None,
                 config=None,
                 miss_policy: str = "solve", metrics=None, slo=None,
                 stats_interval_s: float = DEFAULT_STATS_INTERVAL_S,
                 device_lookup: str = "auto", device="cuda") -> None:
        import dataclasses as _dc

        from paralleljohnson_tpu_torch.backends.torch_backend import (
            resolve_device,
        )
        from paralleljohnson_tpu_torch.config import SolverConfig
        from paralleljohnson_tpu_torch.solver import ParallelJohnsonSolver

        if miss_policy not in _MISS_POLICIES:
            raise ValueError(
                f"miss_policy must be one of {_MISS_POLICIES}, "
                f"got {miss_policy!r}"
            )
        if device_lookup not in _DEVICE_LOOKUP_MODES:
            raise ValueError(
                f"device_lookup must be one of {_DEVICE_LOOKUP_MODES}, "
                f"got {device_lookup!r}"
            )
        if miss_policy == "landmark" and landmarks is None:
            raise ValueError(
                "miss_policy='landmark' requires a LandmarkIndex "
                "(build one or switch to miss_policy='solve')"
            )
        if miss_policy == "hopset" and hopset is None:
            raise ValueError(
                "miss_policy='hopset' requires a Hopset (build one with "
                "ops.hopset.build_hopset or switch to miss_policy='solve')"
            )
        if (hopset is not None and getattr(store, "digest", None)
                and getattr(hopset, "digest", None)
                and hopset.digest != store.digest):
            # Same contract as Hopset.load's expect_digest: a hopset
            # built for another graph must never bound this one.
            raise ValueError(
                "hopset graph digest does not match the store's graph "
                f"({hopset.digest[:12]}... != {store.digest[:12]}...)"
            )
        # No card, no engine: a CUDA request raises here rather than
        # serve from the host.
        self.device = resolve_device(device)
        self.graph = graph
        self.store = store
        self.landmarks = landmarks
        self.hopset = hopset
        self.miss_policy = miss_policy
        base = config or SolverConfig()
        self.config = _dc.replace(
            base,
            checkpoint_dir=str(store.root) if store.ckpt is not None else None,
        )
        self.solver = ParallelJohnsonSolver(self.config, device=self.device)
        self._tel = _resolve_telemetry(self.config.telemetry)
        self.metrics = metrics if metrics is not None else MetricsRegistry(
            label="serve", telemetry=self.config.telemetry
        )
        self.slo = slo if slo is not None else DEFAULT_SLO
        # The stats histogram IS the registry's, so snapshots and prom
        # exports read one set of counts (no drift between surfaces).
        self.stats = ServeStats(
            hist=self.metrics.histogram("pjtpu_query_latency_ms"),
            batch_hist=self.metrics.histogram("pjtpu_lookup_batch_width"),
        )
        # Device-resident lookup path on the engine's device, built
        # lazily with the first batch.
        self.device_lookup = device_lookup
        self._device_path = None
        self._device_unavail: str | None = None
        self.last_lookup_decision: dict | None = None
        self.metrics.slo(self.slo, histogram="pjtpu_query_latency_ms")
        # One re-entrant lock serializes the whole batch pipeline: the
        # tier walk + scheduled solve + counters are a critical section
        # (TileStore's own lock protects its dicts, but hit counters and
        # the miss->solve->put sequence span many store calls).
        self._lock = threading.RLock()
        # Closed-engine contract: the frontend's
        # drain path closes the engine while late connections may still
        # hold a reference — queries after close must fail with a
        # diagnosable QueryError, never a racy AttributeError.
        self._closed = False
        self.stats_interval_s = (
            float(stats_interval_s) if stats_interval_s else 0.0
        )
        self._stats_stop = threading.Event()
        self._stats_thread: threading.Thread | None = None
        # A dropped engine must not leave its writer thread spinning.
        self._finalizer = weakref.finalize(self, self._stats_stop.set)

    # -- request parsing -----------------------------------------------------

    def _parse(self, req: dict) -> dict:
        v = self.graph.num_nodes
        if not isinstance(req, dict):
            raise QueryError(f"query must be a JSON object, got {type(req).__name__}")
        if "source" not in req:
            raise QueryError("query is missing 'source'")
        try:
            source = int(req["source"])
        except (TypeError, ValueError):
            raise QueryError(f"bad source {req['source']!r}") from None
        if not 0 <= source < v:
            raise QueryError(f"source {source} out of range [0, {v})")
        dst = req.get("dst")
        if dst is not None:
            many = isinstance(dst, (list, tuple))
            try:
                dsts = np.asarray(
                    dst if many else [dst], np.int64
                )
            except (TypeError, ValueError):
                raise QueryError(f"bad dst {dst!r}") from None
            if dsts.ndim != 1 or (len(dsts) and (
                    dsts.min() < 0 or dsts.max() >= v)):
                raise QueryError(f"dst out of range [0, {v})")
        else:
            many = True
            dsts = None  # full row (all V destinations)
        mode = req.get("mode", self.miss_policy)
        if mode == "exact":
            mode = "solve"
        elif mode == "approx":
            # Generic "any certified tier": landmark when attached
            # (the hopset tier composes it in anyway), else hopset.
            if self.landmarks is not None:
                mode = "landmark"
            elif self.hopset is not None:
                mode = "hopset"
            else:
                raise QueryError(
                    "mode 'approx' needs a certified tier "
                    "(landmark index or hopset)"
                )
        if mode not in _MISS_POLICIES:
            raise QueryError(f"bad mode {req.get('mode')!r}")
        if mode == "landmark" and self.landmarks is None:
            raise QueryError("mode 'approx' needs a landmark index")
        if mode == "hopset" and self.hopset is None:
            raise QueryError("mode 'hopset' needs an attached hopset")
        # Trace passthrough: the wire context rides the
        # request JSON; only a SAMPLED id tags spans/exemplars (an
        # upstream ingress's head decision is final).
        t = req.get("trace")
        trace_id = None
        if isinstance(t, dict):
            if t.get("sampled", True) is not False:
                tid = t.get("id")
                trace_id = tid if isinstance(tid, str) else None
        elif isinstance(t, str):
            trace_id = t
        return {"id": req.get("id"), "source": source, "dsts": dsts,
                "many": many, "mode": mode, "trace": trace_id}

    # -- the serving loop ----------------------------------------------------

    def query(self, source: int, dst=None, *, mode: str | None = None) -> dict:
        """One request (see :meth:`query_batch`). ``dst``: vertex id for
        point-to-point, list for one-to-many, None for the full row."""
        req: dict = {"source": source, "dst": dst}
        if mode is not None:
            req["mode"] = mode
        out = self.query_batch([req])[0]
        if "error" in out:
            raise QueryError(out["error"])
        return out

    def query_batch(self, requests: list[dict]) -> list[dict]:
        """Answer many requests in one pass: each distinct source's row
        is fetched ONCE, every exact-mode miss joins one scheduled solve
        batch, responses come back in request order. Malformed requests
        yield ``{"error": ...}`` responses (the batch survives).
        Thread-safe: concurrent batches serialize on the engine lock
        (each aggregated batch still schedules at most one solve); the
        per-query latency samples include the lock wait — queueing is
        part of what a client experiences."""
        t_batch = time.perf_counter()
        tel = self._tel
        with self._lock:
            if self._closed:
                raise QueryError(
                    "query engine is closed (the serving process drained "
                    "or shut down; open a new engine over the store)"
                )
            self._ensure_stats_writer()
            responses = self._query_batch_locked(requests, t_batch, tel)
        return responses

    def _fire_fault(self, stage: str, batch=None) -> None:
        """Serving-path fault injection: fire the FaultPlan's
        scheduled fault for ``stage`` INSIDE the latency-measured
        section — an injected ``slow_ms`` inflates the very histogram
        the SLO burn rules watch (a realistic store stall), an injected
        ``error`` raises out of :meth:`query_batch` exactly like a real
        solver/store failure (the frontend converts it to per-request
        error responses; a direct caller sees the raw failure)."""
        fp = getattr(self.config, "fault_plan", None)
        if fp is None:
            return
        active = fp.fire(stage, batch=batch)
        if active is not None:
            active.wrap(lambda: None)()

    def _query_batch_locked(self, requests, t_batch, tel) -> list[dict]:
        with tel.span("serve_batch", n_queries=len(requests)):
            self._fire_fault("serve_lookup")
            parsed: list[dict | None] = []
            responses: list[dict | None] = []
            for req in requests:
                try:
                    parsed.append(self._parse(req))
                    responses.append(None)
                except QueryError as e:
                    parsed.append(None)
                    self.stats.errors += 1
                    self.metrics.counter("pjtpu_query_errors").add(1)
                    self.metrics.observe_slo(self.slo.name, None, ok=False)
                    responses.append({
                        "id": req.get("id") if isinstance(req, dict) else None,
                        "error": str(e),
                    })

            # Lookup-path dispatch: the planner registry
            # decides per batch whether lookups megabatch over the
            # device tile or walk the host tiers.
            device_slots = self._plan_lookup(parsed)
            n_valid = sum(1 for p in parsed if p is not None)
            if n_valid:
                # Aggregated lookup width — the quantity micro-batching
                # exists to raise (batch_width_p50/p99 in stats).
                self.stats.batch_hist.record(float(n_valid))

            # One row fetch per distinct source; one solve for ALL
            # exact-mode misses (the aggregation).
            rows: dict[int, tuple] = {}
            seen: set[int] = set()
            device_sources: list[int] = []
            for p in parsed:
                if p is None or p["source"] in seen:
                    continue
                seen.add(p["source"])
                if p["source"] in device_slots:
                    # The values come from the megabatch below; the
                    # sentinel keeps the miss/solve logic unchanged.
                    rows[p["source"]] = (_DEVICE_ROW, "hot")
                    device_sources.append(p["source"])
                    continue
                row, row_tier = self.store.get(p["source"])
                if row is not None:
                    rows[p["source"]] = (row, row_tier)
            if device_sources:
                # Device-path hits must leave the same footprint the
                # host walk would: one hot hit + an LRU refresh each.
                self.store.note_hot_hits(device_sources)
            missing_exact = sorted({
                p["source"] for p in parsed
                if p is not None and p["source"] not in rows
                and p["mode"] == "solve"
            })
            if missing_exact and self.store.refresh_cold_if_changed():
                # Live-fleet awareness: another process —
                # a solve worker or a sibling replica — committed
                # manifest increments since we attached. Re-check the
                # misses against the refreshed cold index before paying
                # for a solve; an in-flight fleet solve's batches turn
                # our misses into cold hits. The check is one stat()
                # per manifest, and only on the (already-expensive)
                # miss path — the hot path never touches the disk.
                still_missing = []
                for s in missing_exact:
                    row, row_tier = self.store.get(s)
                    if row is not None:
                        rows[s] = (row, row_tier)
                    else:
                        still_missing.append(s)
                missing_exact = still_missing
            if missing_exact:
                batch = np.asarray(missing_exact, np.int64)
                # The scheduled solve tagged with the traces it serves
                #: a store miss's solve cost shows up IN the
                # request's assembled timeline, not as anonymous work.
                miss_set = set(missing_exact)
                solve_traces = sorted({
                    p["trace"] for p in parsed
                    if p is not None and p.get("trace")
                    and p["source"] in miss_set
                })
                extra = ({"trace": solve_traces[0],
                          "traces": solve_traces[:8]}
                         if solve_traces else {})
                with tel.span("serve_solve", n_sources=len(batch),
                              **extra):
                    self._fire_fault("serve_solve",
                                     batch=self.stats.batches_scheduled)
                    res = self.solver.solve(self.graph, sources=batch)
                self.stats.batches_scheduled += 1
                self.stats.solved_sources += len(batch)
                self.metrics.counter("pjtpu_serve_batches_scheduled").add(1)
                self.store.put(res.sources, res.dist, tier="hot")
                if self.store.ckpt is not None:
                    self.store.invalidate_cold_index()
                for s, row in res.rows_by_source().items():
                    rows[s] = (row, "solved")

            # The megabatch: every device-eligible lookup in this batch
            # flattens into (at most) one launch per query class.
            pre = self._device_precompute(parsed, rows, device_slots)

            for i, p in enumerate(parsed):
                if p is None:
                    continue
                q_attrs = ({"trace": p["trace"]} if p.get("trace")
                           else {})
                with tel.span("query", source=p["source"],
                              many=p["many"], **q_attrs):
                    responses[i] = self._answer(p, rows, pre.get(i))
                self.stats.queries_total += 1
                latency_ms = (time.perf_counter() - t_batch) * 1e3
                self.stats.record_latency(latency_ms,
                                          exemplar=p.get("trace"))
                self.metrics.counter("pjtpu_queries").add(1)
                self.metrics.observe_slo(self.slo.name, latency_ms, ok=True)
            self.metrics.gauge("pjtpu_query_hit_rate",
                               self.store.hit_rate())
            tel.progress(queries_done=self.stats.queries_total,
                         batches_scheduled=self.stats.batches_scheduled)
        return responses  # type: ignore[return-value]

    # -- lookup-path dispatch -----------------------------

    def _device_path_maybe(self):
        """The lazily built :class:`DeviceQueryPath`, or None with the
        reason cached in ``_device_unavail``."""
        if self.device_lookup == "off":
            self._device_unavail = "disabled (device_lookup='off')"
            return None
        if self._device_path is None:
            self._device_path = _device_query.DeviceQueryPath(
                self.store, self.landmarks, device=self.device
            )
        return self._device_path

    def _plan_lookup(self, parsed) -> dict[int, int]:
        """Run the planner over ``LOOKUP_PLANS`` for this batch. Returns
        the source -> tile-slot map to serve from the device (empty map
        = host walk). The decision (with why-line) lands on
        ``last_lookup_decision``."""
        dpath = self._device_path_maybe()
        slots: dict[int, int] = {}
        platform = current_platform(self.device)
        if dpath is None:
            avail, reason = False, self._device_unavail or "unavailable"
        else:
            try:
                slots = dpath.refresh()
                if slots:
                    avail, reason = True, "device tile resident"
                else:
                    avail = False
                    reason = "empty device tile (nothing hot, or all stale)"
            except Exception as e:  # noqa: BLE001 — auto degrades to the host walk
                if self.device_lookup == "on" or self.device.type == "cuda":
                    # A forced device path, and any fault on the card,
                    # fails loud: the host walk never covers for it.
                    raise
                slots = {}
                avail = False
                reason = f"device path failed: {type(e).__name__}: {e}"
        n_eligible = sum(
            1 for p in parsed if p is not None and p["source"] in slots
        )
        ctx = types.SimpleNamespace(
            platform=platform,
            device_available=avail,
            device_reason=reason,
            n_device_eligible=n_eligible,
            forced_on=self.device_lookup == "on",
        )
        decision = _planner.select(
            _planner.LOOKUP_PLANS, ctx,
            platform=platform, num_edges=self.graph.num_edges,
            batch=max(1, n_eligible),
            config=types.SimpleNamespace(device_lookup=self.device_lookup),
        )
        self.last_lookup_decision = decision.as_dict()
        if decision.chosen.plan.name == "device_lookup":
            if dpath.landmark_device_ok():
                # Torch holds real f64 on the card: the landmark
                # sub-path rides the device too (its f64 probe passed).
                self.last_lookup_decision["reason"] += (
                    "; landmark raw bounds in f64 on the device "
                    f"({dpath.device}, f64 probe true)"
                )
            return slots
        return {}

    def _device_precompute(self, parsed, rows, device_slots) -> dict:
        """Flatten this batch's device-eligible lookups and run the
        megabatch: exact (slot, dst) pairs and full rows gather over the
        tile; landmark misses compute their RAW f64 bounds on-device and
        finish through the SAME host helpers the host path uses (the
        bitwise-parity seam — see ``serve/device_query.py``). Returns
        ``{query_index: ("exact", vals_f64) | ("landmark", est, err)}``."""
        pre: dict[int, tuple] = {}
        if not device_slots:
            return pre
        dpath = self._device_path
        lm_dev = dpath.landmark_device_ok()
        pair_q: list[int] = []
        pair_seg: list[int] = []
        pair_slots: list[int] = []
        pair_dsts: list[int] = []
        row_q: list[int] = []
        row_slots: list[int] = []
        lmp_q: list[int] = []
        lmp_seg: list[int] = []
        lmp_s: list[int] = []
        lmp_t: list[int] = []
        lmr_q: list[int] = []
        lmr_s: list[int] = []
        for i, p in enumerate(parsed):
            if p is None:
                continue
            s, dsts = p["source"], p["dsts"]
            if s in device_slots:
                if dsts is None:
                    row_q.append(i)
                    row_slots.append(device_slots[s])
                else:
                    pair_q.append(i)
                    pair_seg.append(len(dsts))
                    pair_slots.extend([device_slots[s]] * len(dsts))
                    pair_dsts.extend(int(d) for d in dsts)
            elif lm_dev and s not in rows and p["mode"] == "landmark":
                # Store miss answered by landmark bounds: the f64 raw
                # part rides the same launch window (platforms without
                # real f64 — TPU — fail the probe and these stay host).
                if dsts is None:
                    lmr_q.append(i)
                    lmr_s.append(s)
                else:
                    lmp_q.append(i)
                    lmp_seg.append(len(dsts))
                    lmp_s.extend([s] * len(dsts))
                    lmp_t.extend(int(d) for d in dsts)
        nonneg = (self.landmarks.nonnegative
                  if self.landmarks is not None else True)
        if not (pair_q or row_q or lmp_q or lmr_q):
            return pre
        # The megabatch kernel launch as one span: tagged
        # with every trace riding this launch, so an assembled timeline
        # shows WHICH device launch served the request (and how wide it
        # was — convoy width reaching the accelerator).
        tel = self._tel
        mb_attrs = {}
        if tel.enabled:
            mb_traces = sorted({
                parsed[qi]["trace"]
                for qi in (pair_q + row_q + lmp_q + lmr_q)
                if parsed[qi] is not None and parsed[qi].get("trace")
            })
            if mb_traces:
                mb_attrs = {"trace": mb_traces[0],
                            "traces": mb_traces[:8]}
        with tel.span("device_megabatch", pairs=len(pair_slots),
                      rows=len(row_q), lm_pairs=len(lmp_s),
                      lm_rows=len(lmr_q), **mb_attrs):
            if pair_q:
                flat = dpath.exact_pairs(pair_slots, pair_dsts)
                off = 0
                for qi, seg in zip(pair_q, pair_seg):
                    pre[qi] = ("exact",
                               np.asarray(flat[off:off + seg],
                                          np.float64))
                    off += seg
            if row_q:
                out = dpath.exact_rows(row_slots)
                for j, qi in enumerate(row_q):
                    pre[qi] = ("exact", np.asarray(out[j], np.float64))
            if lmp_q:
                lo, up = dpath.landmark_pairs(lmp_s, lmp_t)
                lo, up = widen_bounds(lo, up, nonnegative=nonneg)
                est, err = finish_estimates(lo, up)
                off = 0
                for qi, seg in zip(lmp_q, lmp_seg):
                    pre[qi] = ("landmark", est[off:off + seg],
                               err[off:off + seg])
                    off += seg
            if lmr_q:
                lo, up = dpath.landmark_rows(lmr_s)
                for j, qi in enumerate(lmr_q):
                    wl, wu = widen_bounds(lo[j], up[j],
                                          nonnegative=nonneg)
                    est, err = finish_estimates(wl, wu)
                    pre[qi] = ("landmark", est, err)
        return pre

    def _hopset_estimate(self, s, dsts):
        """The hopset tier's ``(estimates, max_errors)``: the hopset's
        certified interval intersected with the landmark index's (when
        one is attached) — the composition rule: tighter wins PER
        ENTRY, both factors are certified, so the intersection is too.
        Finished through the same inf-aware helper as every certified
        tier (proven-inf -> (inf, 0); unknown -> (inf, inf) — an
        unreachable pair is never silently bounded)."""
        lower, upper = self.hopset.bounds_row(s, dsts)
        if self.landmarks is not None and self.landmarks.k > 0:
            lm_lo, lm_up = self.landmarks.bounds_row(s, dsts)
            lower = np.maximum(lower, lm_lo)
            upper = np.minimum(upper, lm_up)
        return finish_estimates(lower, upper)

    def _stale_error_bound(self, s, dsts, many):
        """Stale honesty: a landmark-derived
        ``max_error`` for a stale (pre-update) answer, shaped like a
        certified-shed response's. The landmark interval width is an
        honest ESTIMATE of how far the served value can drift from the
        repaired graph's answer — not a certificate (the index predates
        the repair too), which is exactly why it rides next to
        ``stale: true`` instead of replacing it. Without an index the
        bound is +inf: present, never silently zero."""
        if self.landmarks is not None and self.landmarks.k > 0:
            _, err = self.landmarks.estimate_row(s, dsts)
        else:
            n = 1 if dsts is not None and not many else (
                len(dsts) if dsts is not None else self.graph.num_nodes
            )
            err = np.full(max(n, 1), np.inf)
        return [float(e) for e in err] if many else float(err[0])

    def _answer(self, p: dict, rows: dict[int, tuple],
                pre: tuple | None = None) -> dict:
        s, dsts, many = p["source"], p["dsts"], p["many"]
        out: dict = {"id": p["id"], "source": s}
        # Staleness contract: while (or after) an incremental
        # repair runs against this store's graph, every answer whose
        # source is in the repair's affected set reflects PRE-update
        # distances — exact for the old graph, flagged here so it is
        # never served as current silently. This applies to every tier
        # AND to freshly scheduled solves / landmark bounds: they all
        # answer for the engine's (pre-update) graph. Absence of the
        # key means the answer is provably current for the updated
        # graph too (the repair dependency argument).
        if self.store.is_stale(s):
            out["stale"] = True
            self.stats.stale_answers += 1
            self.metrics.counter("pjtpu_stale_answers").add(1)
        hit = rows.get(s)
        device = pre is not None
        if device and pre[0] == "exact":
            # Megabatched gather: same f32 bits, same f64 conversion —
            # tier is "hot" exactly as the host walk would report.
            vals = pre[1]
            tier = "hot"
            self.stats.exact_answers += 1
            out.update(exact=True, max_error=0.0, tier="hot")
        elif hit is not None:
            row, tier = hit
            vals = _host_values(row, dsts)
            self.stats.exact_answers += 1
            out.update(exact=True, max_error=0.0, tier=tier)
        elif device and pre[0] == "landmark":
            # Device-raw + host-finished bounds (bitwise the host path).
            est, err = pre[1], pre[2]
            vals = est
            self.stats.approx_answers += 1
            tier = "landmark"
            out.update(
                exact=False, tier="landmark",
                max_error=(
                    [float(e) for e in err] if many else float(err[0])
                ),
            )
        elif p["mode"] == "hopset":
            # Hopset tier: certified interval from the
            # (1+eps) hopset composed with the landmark interval when
            # an index is also attached — tighter wins per entry, and
            # the answer is flagged exactly like a landmark one.
            est, err = self._hopset_estimate(s, dsts)
            vals = est
            self.stats.approx_answers += 1
            self.stats.hopset_answers += 1
            tier = "hopset"
            out.update(
                exact=False, tier="hopset",
                max_error=(
                    [float(e) for e in err] if many else float(err[0])
                ),
            )
        else:
            # Landmark path — approximation, always flagged with its
            # certified error bound.
            est, err = self.landmarks.estimate_row(s, dsts)
            vals = est
            self.stats.approx_answers += 1
            tier = "landmark"
            out.update(
                exact=False, tier="landmark",
                max_error=(
                    [float(e) for e in err] if many else float(err[0])
                ),
            )
        if out.get("stale") and out.get("exact"):
            # Stale honesty: the pre-update answer ships with
            # its drift estimate, never a bare flag.
            out["max_error"] = self._stale_error_bound(s, dsts, many)
        if device:
            self.stats.device_lookups += 1
            self.metrics.counter("pjtpu_device_lookups").add(1)
        else:
            self.stats.host_lookups += 1
            self.metrics.counter("pjtpu_host_lookups").add(1)
        self.stats.hits_by_tier[tier] = (
            self.stats.hits_by_tier.get(tier, 0) + 1
        )
        self.metrics.counter(f"pjtpu_answers_{tier}").add(1)
        if many:
            out["dst"] = None if dsts is None else [int(d) for d in dsts]
            out["distances"] = [float(x) for x in vals]
        else:
            out["dst"] = int(dsts[0])
            out["distance"] = float(vals[0])
        return out

    # -- the front end's hooks ------------------------------------

    def slo_tracker(self):
        """The live :class:`~paralleljohnson_tpu_torch.observe.live.SLOTracker`
        for this engine's objective — the burn-state the frontend's
        shedding decision reads (``tracker.burning`` flips on the same
        multi-window rules that emit ``slo_burn`` events)."""
        return self.metrics.slo(self.slo)

    def note_failed_requests(self, n: int = 1) -> None:
        """File ``n`` requests that died OUTSIDE the batch pipeline (a
        solve/store exception the frontend converted to error responses)
        into the same counters + SLO stream a parse error uses — a
        failure that burned real error budget must never be invisible to
        the burn-rate alert."""
        with self._lock:
            self.stats.errors += n
        self.metrics.counter("pjtpu_query_errors").add(n)
        for _ in range(int(n)):
            self.metrics.observe_slo(self.slo.name, None, ok=False)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- warm-up and ops surface ---------------------------------------------

    def warm(self, sources) -> int:
        """Pre-solve ``sources`` into the store (one scheduled batch for
        whichever of them the store does not already hold). Returns how
        many sources were actually solved."""
        with self._lock:
            if self._closed:
                raise QueryError("query engine is closed")
            missing = [int(s) for s in np.asarray(sources, np.int64)
                       if self.store.get(int(s))[0] is None]
            if not missing:
                return 0
            batch = np.asarray(sorted(set(missing)), np.int64)
            with self._tel.span("serve_warm", n_sources=len(batch)):
                res = self.solver.solve(self.graph, sources=batch)
            self.stats.batches_scheduled += 1
            self.stats.solved_sources += len(batch)
            self.store.put(res.sources, res.dist, tier="hot")
            if self.store.ckpt is not None:
                self.store.invalidate_cold_index()
            return len(batch)

    def query_lines(self, lines) -> tuple[list[dict], int]:
        """Parse JSONL request lines and answer them as one aggregated
        batch. Returns ``(responses_in_order, n_errors)`` — a malformed
        line becomes an ``{"error": ...}`` response, never a crash (the
        request loop must survive any input)."""
        requests: list[dict] = []
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                if not isinstance(obj, dict):
                    raise ValueError("not a JSON object")
                requests.append(obj)
            except ValueError as e:
                requests.append({"_parse_error": f"line {i + 1}: {e}"})
        for r in requests:
            if "_parse_error" in r:
                r.pop("source", None)  # force the engine's error path
        responses = self.query_batch([
            r if "_parse_error" not in r else {"source": None}
            for r in requests
        ])
        for r, resp in zip(requests, responses):
            if "_parse_error" in r and "error" in resp:
                resp["error"] = r["_parse_error"]
        n_errors = sum(1 for r in responses if "error" in r)
        return responses, n_errors

    def write_metrics(self, path, *, labels: dict | None = None) -> Path:
        """Prometheus textfile export (``pjtpu_queries_total``, the
        ``pjtpu_query_latency_ms`` histogram — percentiles via
        ``histogram_quantile`` — hit rate,
        ``pjtpu_slo_burn_rate{slo=...}``, ...)."""
        return write_prom_metrics(self, path, labels=labels,
                                  metrics=SERVE_PROM_METRICS)

    def serve_summary(self) -> dict:
        if self._device_path is not None:
            device_path = self._device_path.describe()
        else:
            device_path = {
                "available": False,
                "reason": self._device_unavail or "not probed yet",
            }
        return {
            "engine": self.stats.as_dict(),
            "store": self.store.stats(),
            "landmarks": 0 if self.landmarks is None else self.landmarks.k,
            # Approximate-tier provenance: what `pjtpu top`
            # and `pjtpu info --serve-store` report about the attached
            # hopset (None = exact + landmark tiers only).
            "hopset": None if self.hopset is None else {
                "epsilon": float(self.hopset.epsilon),
                "beta": int(self.hopset.beta),
                "k": int(self.hopset.k),
                "edges": int(self.hopset.num_hopset_edges),
                "converged": bool(self.hopset.converged),
            },
            "miss_policy": self.miss_policy,
            # Lookup-path dispatch: the tristate, the device
            # path's state, and the last planner decision with its
            # why-line — what `pjtpu top` / bench detail read.
            "lookup": {
                "device_lookup": self.device_lookup,
                "device_path": device_path,
                "decision": self.last_lookup_decision,
            },
            # The live view: windowed rates, histogram with
            # its full mergeable state, and the SLO burn verdicts —
            # what `pjtpu top` and slo_report read.
            "live": self.metrics.snapshot(),
        }

    # -- periodic stats publishing -----------------------

    def _stats_path(self) -> Path | None:
        if self.store.ckpt is None:
            return None
        return self.store.ckpt.dir / SERVE_STATS_FILENAME

    def _write_stats(self) -> None:
        """One atomic serve_stats.json publish (tmp + rename — the
        HeartbeatReporter guarantee: a reader never sees a torn file)."""
        path = self._stats_path()
        if path is None:
            return
        payload = self.serve_summary()
        payload["ts"] = time.time()
        payload["pid"] = os.getpid()
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(payload), encoding="utf-8")
        os.replace(tmp, path)

    def _ensure_stats_writer(self) -> None:
        """Start the periodic rewriter lazily with the first served
        batch (an engine that never serves never spawns a thread)."""
        if (self._stats_thread is not None or not self.stats_interval_s
                or self.store.ckpt is None):
            return

        def loop() -> None:
            while not self._stats_stop.wait(self.stats_interval_s):
                try:
                    self._write_stats()
                except Exception:  # noqa: BLE001 — stats must never kill serving
                    pass

        self._stats_stop.clear()
        self._stats_thread = threading.Thread(
            target=loop, name="pj-serve-stats", daemon=True
        )
        self._stats_thread.start()

    def close(self) -> None:
        """Stop the periodic writer, release the solver's mesh groups
        (``ParallelJohnsonSolver.close``), and persist the final serving
        counters next to the store's batches (atomic) so ``pjtpu info
        --serve-store`` / ``pjtpu top`` can report capacity, landmark
        count, and hit rates after the loop exits. Does NOT close the
        telemetry façade — its owner (the CLI) does.

        Idempotent: the frontend's drain path and
        the CLI's finally block may both call it; the second call is a
        no-op. In-flight batches finish (close waits on the engine
        lock); queries that arrive after raise :class:`QueryError`."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stats_stop.set()
        t = self._stats_thread
        if t is not None:
            t.join(timeout=max(1.0, 2 * self.stats_interval_s))
            self._stats_thread = None
        self.solver.close()  # the misses' mesh groups, if any
        if self.store.ckpt is None:
            return
        try:
            self._write_stats()
        except OSError:
            pass  # a read-only store dir still served every query
