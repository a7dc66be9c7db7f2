"""Traffic front end: socket serving with admission
control, certified load shedding, and a drainable lifecycle, where
overload behavior is DESIGNED rather than emergent.

:class:`ServeFrontend` runs a stdlib-only threaded TCP server:
newline-delimited JSON both ways, one protocol header line per
connection, one worker thread per connection over ONE shared
:class:`~paralleljohnson_tpu_torch.serve.engine.QueryEngine`. What makes it a
traffic front end rather than a socket wrapper:

- **Admission control** — a connection bound (``max_connections``) and
  an in-flight query semaphore (``max_inflight``). Past either bound,
  new work gets an explicit ``{"error": "overloaded",
  "retry_after_ms": ...}`` instead of an unbounded queue; the client
  decides whether to back off or go elsewhere, and the server's memory
  stays bounded by construction.
- **Per-request deadlines** — a query may carry ``deadline_ms`` (its
  total patience, measured from arrival). A request that cannot START
  before its deadline — the in-flight slot never freed in time — is
  dropped without touching the engine (``deadline_drops``): work the
  client has already abandoned must not spend engine time.
- **Burn-rate-triggered certified shedding** — when the engine's
  :class:`SLOTracker` fires its multi-window burn alert, exact-MISS
  queries are downgraded to landmark answers flagged ``{"shed": true,
  "exact": false, "max_error": ...}`` (the repo's honesty rule: never an
  unflagged approximation; hot/warm/cold HITS still answer exactly —
  they cost nothing to serve right). Shedding disengages automatically
  when the burn clears; both transitions emit an ``slo_shed`` flight
  event. ``shed_policy``: ``"landmark"`` (certified degrade, the
  default when an index exists), ``"reject"`` (exact misses get the
  overloaded rejection instead), ``"off"``.
- **Graceful drain** — SIGTERM stops accepting, lets in-flight requests
  finish under ``drain_timeout_s``, force-closes stragglers, flushes
  ``serve_stats.json`` + the live-metrics snapshot, exits 0. SIGKILL
  mid-traffic leaves the atomic snapshots readable (the engine's
  periodic writers — the heartbeat idiom, now tested through the
  socket path).
- **Fault injection** — the serving path is inside the
  :class:`~paralleljohnson_tpu_torch.utils.faults.FaultPlan` schedule:
  ``serve_accept`` fires per accepted connection (here), and the engine
  fires ``serve_lookup`` / ``serve_solve`` per batch / per scheduled
  solve. ``scripts/serve_chaos_drill.py`` drives them to prove that
  store stalls and solver failures produce shed/rejected/error answers
  and burn events — never hung connections, never wrong exact answers.

Protocol (version ``pjtpu-serve/1``): on connect the server sends one
header line ``{"protocol": "pjtpu-serve/1", "graph_digest": ...,
"shed_policy": ...}``. Each request line is a query object (the engine's
JSONL shape: ``id`` / ``source`` / ``dst`` / ``mode``) plus the optional
``deadline_ms``, or ``{"op": "health"}`` for the liveness document
(admission gauges, shedding state, and the solve heartbeat's freshness
via ``read_heartbeat``/``heartbeat_fresh`` — torn files degrade to
``fresh: false``, never a crash). Every request gets exactly one
response line, in order, on the connection that sent it.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import types

from paralleljohnson_tpu_torch import planner as _planner
from paralleljohnson_tpu_torch.observe import trace as _trace
from paralleljohnson_tpu_torch.serve.engine import (
    SERVE_LIVE_FILENAME,
    QueryError,
)

PROTOCOL = "pjtpu-serve/1"

# Shedding tiers (with the hopset tier):
# "landmark" / "hopset" degrade exact misses to that certified tier,
# "priced" orders the two certified tiers by predicted per-query
# serving cost (the priced-shedding clause — reject only when neither
# tier exists), "reject" answers overloaded, "off" disables shedding.
SHED_POLICIES = ("landmark", "hopset", "priced", "reject", "off")

DEFAULT_MAX_CONNECTIONS = 64
DEFAULT_MAX_INFLIGHT = 8
DEFAULT_DRAIN_TIMEOUT_S = 10.0
DEFAULT_RETRY_AFTER_MS = 100

# Micro-batching defaults: at most this many queries combine
# into one engine batch; 0/1 disables combining. The wait window
# defaults to ZERO — batching emerges from convoy combining (followers
# enqueue while the leader executes the previous batch), so an idle
# server never trades latency for width.
DEFAULT_BATCH_WINDOW = 32
DEFAULT_BATCH_WAIT_MS = 0.0

# Shedding tiers as a planner registry: what an
# exact-miss degrades to under overload is the same kind of decision as
# which kernel route serves a solve, so it goes through the same
# ``planner.select`` walk — declared priority unpriced, CostModel-priced
# promotion past the 25% band under ``shed_policy="priced"``, forced
# pins for the explicit policies, and a decision record with the full
# candidate table (including honest disqualification reasons) in
# ``health()``. The "stale" tier is declared but self-disqualifying:
# staleness is an answer PROPERTY of the repair contract,
# not a servable degrade target, and the candidate table says so
# instead of silently omitting it.
SHED_PLANS = [
    _planner.Plan(
        name="hopset", entry="shed", priority=10,
        qualify=lambda ctx: (
            (True, "certified (1+eps) hopset tier attached")
            if getattr(ctx.engine, "hopset", None) is not None
            else (False, "no hopset attached to the engine")
        ),
        price_routes=("hopset+bf",),
        forced=lambda cfg: getattr(cfg, "shed_policy", None) == "hopset",
    ),
    _planner.Plan(
        name="landmark", entry="shed", priority=20,
        qualify=lambda ctx: (
            (True, "landmark index attached (certified bounds)")
            if ctx.engine.landmarks is not None
            else (False, "no landmark index attached to the engine")
        ),
        price_routes=("lookup-host",),
        forced=lambda cfg: getattr(cfg, "shed_policy", None) == "landmark",
    ),
    _planner.Plan(
        name="stale", entry="shed", priority=25,
        qualify=lambda ctx: (
            False,
            "stale pre-update rows are a property the repair staleness "
            "contract stamps on answers, not a tier a shed exact-miss "
            "can degrade to — nothing independent to serve",
        ),
    ),
    _planner.Plan(
        name="reject", entry="shed", priority=90,
        qualify=lambda ctx: (
            True, "unconditional: the overloaded rejection always exists"
        ),
        forced=lambda cfg: getattr(cfg, "shed_policy", None) == "reject",
    ),
]

# Chosen shed plan -> the query mode an exact-miss is rewritten to
# ("reject" short-circuits to the overloaded answer instead).
_SHED_MODES = {"hopset": "hopset", "landmark": "approx", "reject": "reject"}

# The low-traffic guard on the shed decision (the SRE-workbook caveat:
# burn-rate math over a handful of events is dominated by any single
# failure). Shedding engages only when the burning verdict is backed by
# at least this many observations inside the burn rule's long window —
# one rejected connection on a near-idle server must not degrade the
# next answer. The verdict itself (slo_burn events, `pjtpu top`) is
# untouched; only the DEGRADE action is volume-gated, because acting on
# a statistically empty alert has a real cost here.
DEFAULT_SHED_MIN_EVENTS = 20


def parse_listen(spec: str) -> tuple[str, int]:
    """``"HOST:PORT"`` -> ``(host, port)`` (port 0 = ephemeral; the
    bound port is in :attr:`ServeFrontend.address` / the CLI's
    ``listening`` line)."""
    host, sep, port = str(spec).rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"--listen wants HOST:PORT (e.g. 127.0.0.1:7070), got {spec!r}"
        )
    try:
        return host, int(port)
    except ValueError:
        raise ValueError(f"bad --listen port {port!r}") from None


class _BatchSlot:
    """One request's place in a :class:`MicroBatcher` convoy. Captures
    the submitter's trace context and enqueue time at construction —
    the leader executes on ANOTHER thread, so follower→leader span
    linkage must travel with the slot, not a contextvar."""

    __slots__ = ("req", "resp", "exc", "done", "ctx", "t_submit")

    def __init__(self, req: dict, ctx=None) -> None:
        self.req = req
        self.resp: dict | None = None
        self.exc: BaseException | None = None
        self.done = False
        self.ctx = ctx
        self.t_submit = time.perf_counter()


class MicroBatcher:
    """Leader-follower request combining over one shared engine
    (the frontend-side aggregation that gives the device megabatch
    its width).

    Every submitting thread enqueues a slot, then contends for the TURN
    lock. The holder (the leader) drains up to ``max_width`` pending
    slots — its own included — into ONE ``engine.query_batch`` call and
    marks them done; threads whose slot was served by someone else's
    batch find it completed the moment they get the turn and leave
    immediately. The bounded-latency argument: with ``wait_ms=0`` (the
    default) a lone request takes the turn instantly and runs a
    width-1 batch — combining costs an idle server NOTHING; under load,
    width emerges from exactly the time the previous batch was already
    going to take (the convoy): a bounded micro-batching window that
    never adds unbounded latency. A nonzero
    ``wait_ms`` additionally lets the leader sit out one fixed window
    to accumulate followers — still bounded by construction.

    Exceptions from the engine are stored per slot and re-raised in
    each submitter's own thread (a poisoned batch fails its members,
    not the batcher)."""

    def __init__(self, engine, *, max_width: int = DEFAULT_BATCH_WINDOW,
                 wait_ms: float = DEFAULT_BATCH_WAIT_MS) -> None:
        if max_width < 1:
            raise ValueError(f"max_width must be >= 1, got {max_width}")
        if wait_ms < 0:
            raise ValueError(f"wait_ms must be >= 0, got {wait_ms}")
        self.engine = engine
        self.max_width = int(max_width)
        self.wait_s = float(wait_ms) / 1e3
        self._pending: list[_BatchSlot] = []
        self._lock = threading.Lock()   # guards _pending
        self._turn = threading.Lock()   # one leader at a time
        self.batches = 0
        self.combined = 0  # requests that rode a batch of width > 1

    def submit(self, req: dict) -> dict:
        """Answer one request through the combining pipeline. Blocks
        until the request's batch completes; raises whatever the engine
        raised for that batch."""
        slot = _BatchSlot(req, _trace.current_trace())
        with self._lock:
            self._pending.append(slot)
        while not slot.done:
            with self._turn:
                if slot.done:
                    break  # a previous leader's batch served us
                if self.wait_s:
                    time.sleep(self.wait_s)
                with self._lock:
                    batch = self._pending[:self.max_width]
                    del self._pending[:len(batch)]
                if batch:
                    self._execute(batch, leader_slot=slot)
                # FIFO take: our slot is served within ceil(pos/width)
                # turns, every one of which does real work — no
                # spinning, no starvation.
        if slot.exc is not None:
            raise slot.exc
        return slot.resp  # type: ignore[return-value]

    def _execute(self, batch: list[_BatchSlot],
                 leader_slot: "_BatchSlot | None" = None) -> None:
        tel = getattr(self.engine, "_tel", None)
        traced = ([s for s in batch if s.ctx is not None and s.ctx.sampled]
                  if tel else [])
        if not traced:
            self._run_batch(batch)
            return
        # The convoy made visible: one ``convoy_batch`` span
        # on the leader's thread (so the engine's serve_batch nests
        # under it), plus one ``convoy_member`` span per traced slot,
        # explicitly ``parent=``-linked to the batch span — a follower
        # whose request rode someone else's batch still joins its own
        # trace via the ``trace`` attr, and its queue wait (submit ->
        # execution start) stops being invisible.
        t_exec = time.perf_counter()
        with tel.span("convoy_batch", width=len(batch),
                      traced=len(traced)) as bs:
            members = [
                (s, tel.begin_span(
                    "convoy_member", parent=bs.id, trace=s.ctx.trace_id,
                    queue_wait_ms=round((t_exec - s.t_submit) * 1e3, 3),
                    leader=(s is leader_slot),
                ))
                for s in traced
            ]
            try:
                self._run_batch(batch)
            finally:
                for s, sid in members:
                    if s.exc is not None:
                        tel.finish_span(sid, "error", repr(s.exc))
                    else:
                        tel.finish_span(sid)

    def _run_batch(self, batch: list[_BatchSlot]) -> None:
        try:
            responses = self.engine.query_batch([s.req for s in batch])
            for s, resp in zip(batch, responses):
                s.resp = resp
        except BaseException as e:  # noqa: BLE001 — fail the members, not us
            for s in batch:
                s.exc = e
        finally:
            self.batches += 1
            if len(batch) > 1:
                self.combined += len(batch)
            for s in batch:
                s.done = True


class ServeFrontend:
    """Threaded socket front end over one shared engine (module doc).

    The engine's :class:`ServeStats` is the single counter surface:
    ``shed_answers`` / ``rejected`` / ``deadline_drops`` /
    ``open_connections`` land there (and in the live metrics registry),
    so ``serve_stats.json``, the prom export, and ``pjtpu top`` all see
    the frontend's admission behavior without a second bookkeeping
    path."""

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0,
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 shed_policy: str = "landmark",
                 drain_timeout_s: float = DEFAULT_DRAIN_TIMEOUT_S,
                 retry_after_ms: int = DEFAULT_RETRY_AFTER_MS,
                 shed_min_events: int = DEFAULT_SHED_MIN_EVENTS,
                 fault_plan=None, heartbeat_file=None,
                 heartbeat_stale_s: float = 30.0,
                 batch_window: int = DEFAULT_BATCH_WINDOW,
                 batch_wait_ms: float = DEFAULT_BATCH_WAIT_MS,
                 max_inflight_per_client: int | None = None,
                 http: bool = False,
                 fleet_dir=None, replica_id: str | None = None,
                 fleet_heartbeat_s: float = 1.0,
                 tune_dir=None, tune_idle_s: float = 2.0,
                 trace_sample: float | None = None) -> None:
        if shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {SHED_POLICIES}, "
                f"got {shed_policy!r}"
            )
        if shed_policy == "landmark" and engine.landmarks is None:
            raise ValueError(
                "shed_policy='landmark' needs a LandmarkIndex on the "
                "engine (build one, or pick shed_policy='reject'/'off')"
            )
        if shed_policy == "hopset" and getattr(engine, "hopset", None) is None:
            raise ValueError(
                "shed_policy='hopset' needs a Hopset on the engine "
                "(build one, or pick shed_policy='reject'/'off')"
            )
        if (shed_policy == "priced" and engine.landmarks is None
                and getattr(engine, "hopset", None) is None):
            raise ValueError(
                "shed_policy='priced' needs at least one certified tier "
                "on the engine (a LandmarkIndex or a Hopset)"
            )
        if max_connections < 1 or max_inflight < 1:
            raise ValueError("max_connections and max_inflight must be >= 1")
        if max_inflight_per_client is not None and max_inflight_per_client < 1:
            raise ValueError("max_inflight_per_client must be >= 1 (or None)")
        self.engine = engine
        self.host, self.port = host, int(port)
        self.max_connections = int(max_connections)
        self.max_inflight = int(max_inflight)
        self.shed_policy = shed_policy
        self.drain_timeout_s = float(drain_timeout_s)
        self.retry_after_ms = int(retry_after_ms)
        self.shed_min_events = int(shed_min_events)
        self.fault_plan = fault_plan
        self.heartbeat_file = heartbeat_file
        self.heartbeat_stale_s = float(heartbeat_stale_s)
        # Micro-batching: concurrent connections' requests
        # combine into device-width engine batches; 0/1 = the old
        # one-request-one-batch path.
        self.batch_window = int(batch_window)
        self.batch_wait_ms = float(batch_wait_ms)
        self.batcher = (
            MicroBatcher(engine, max_width=self.batch_window,
                         wait_ms=self.batch_wait_ms)
            if self.batch_window > 1 else None
        )
        # Per-client fairness: an optional per-client-key
        # in-flight cap UNDER the global semaphore. None = globally FIFO.
        self.max_inflight_per_client = (
            None if max_inflight_per_client is None
            else int(max_inflight_per_client)
        )
        # HTTP/1.1 adaptation: same listener, same admission
        # path, request bodies are protocol lines.
        self.http = bool(http)
        # Fleet membership: heartbeat-registered replica
        # record in <fleet_dir>/serve/replicas/.
        self.fleet_dir = fleet_dir
        self.replica_id = (
            str(replica_id) if replica_id else f"replica-{os.getpid()}"
        )
        self.fleet_heartbeat_s = float(fleet_heartbeat_s)
        # Idle-capacity tuning: with a tuning-fleet dir
        # attached, a replica that has had no open connections for
        # tune_idle_s claims ONE probe lease at a time from it —
        # serving traffic always preempts the next claim.
        self.tune_dir = tune_dir
        self.tune_idle_s = float(tune_idle_s)
        self._tune_thread: threading.Thread | None = None
        self._registration = None
        self._tel = engine._tel
        # Request tracing: with telemetry wired, this
        # frontend is a trace ingress — it honors an upstream (router)
        # wire context or mints its own, head-sampled at trace_sample
        # (default: everything when a trace dir is configured, nothing
        # otherwise — rate 0 keeps the request/answer bytes identical).
        self.trace_sample = (
            float(trace_sample) if trace_sample is not None
            else (1.0 if self._tel else 0.0)
        )
        self._tracker = engine.slo_tracker()
        self._inflight = threading.Semaphore(self.max_inflight)
        self._client_lock = threading.Lock()
        self._client_slots: dict[str, threading.Semaphore] = {}
        self._stats_lock = threading.Lock()
        self._conn_lock = threading.Lock()
        self._conns: dict[socket.socket, threading.Thread] = {}
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._shutdown_requested = threading.Event()
        self.shed_active = False
        self.address: tuple[str, int] | None = None
        # Priced shedding: the degrade tier's query mode,
        # resolved lazily at the first shed (the cost model fit reads
        # the profile store once) and cached with its why-line.
        self._shed_mode_cached: tuple[str, str] | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServeFrontend":
        if self._listener is not None:
            return self
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.host, self.port))
        ls.listen(128)
        self._listener = ls
        self.address = ls.getsockname()[:2]
        # Pre-register the overload instruments so every snapshot a
        # socket-serving process publishes carries them — a post-mortem
        # must distinguish "zero shedding happened" (counter at 0) from
        # "this was never a traffic front end" (counter absent).
        for name in ("pjtpu_shed_answers", "pjtpu_rejected",
                     "pjtpu_deadline_drops", "pjtpu_slo_shed_transitions",
                     "pjtpu_client_limited"):
            self.engine.metrics.counter(name)
        self._publish_open(0)
        # Store-backed engines publish the live-metrics snapshot beside
        # serve_stats.json (both atomic): a SIGKILLed frontend leaves
        # both readable, fresh to within one interval.
        if self.engine.store.ckpt is not None and self.engine.stats_interval_s:
            self.engine.metrics.start_snapshotter(
                self.engine.store.ckpt.dir / SERVE_LIVE_FILENAME,
                interval_s=self.engine.stats_interval_s,
            )
        # Fleet membership: heartbeat the bound address + live metrics
        # into the fleet dir so routers/top/slo_report see this replica.
        if self.fleet_dir is not None:
            from paralleljohnson_tpu_torch.serve.fleet import ReplicaRegistration

            self._registration = ReplicaRegistration(
                self.fleet_dir, self.replica_id,
                host=self.address[0], port=self.address[1],
                graph_digest=self.engine.store.digest,
                interval_s=self.fleet_heartbeat_s,
                payload_fn=self._fleet_payload,
            ).start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="pj-serve-accept", daemon=True
        )
        self._accept_thread.start()
        if self.tune_dir is not None:
            self._tune_thread = threading.Thread(
                target=self._tune_loop, name="pj-serve-tuner", daemon=True
            )
            self._tune_thread.start()
        self._tel.event("serve_listen", host=self.address[0],
                        port=self.address[1], protocol=PROTOCOL,
                        max_connections=self.max_connections,
                        max_inflight=self.max_inflight,
                        shed_policy=self.shed_policy)
        return self

    def _tune_loop(self) -> None:
        """Idle-capacity farm: while the replica is serving
        nothing, drain one tuning lease at a time from ``tune_dir``.
        One-lease-at-a-time keeps preemption latency at one probe
        budget; probes run in this daemon thread under their own hard
        wall-clock caps, and results only become real when the
        coordinator commit lands (the digest-guarded manifest idiom) —
        a replica killed mid-probe leaks nothing into the store."""
        from paralleljohnson_tpu_torch.tuner import try_tuning_lease

        idle_since: float | None = None
        while not self._draining.is_set():
            with self._conn_lock:
                busy = bool(self._conns)
            if busy:
                idle_since = None
                self._draining.wait(self.tune_idle_s)
                continue
            now = time.monotonic()
            if idle_since is None:
                idle_since = now
            if now - idle_since < self.tune_idle_s:
                self._draining.wait(
                    max(0.05, self.tune_idle_s - (now - idle_since))
                )
                continue
            try:
                res = try_tuning_lease(
                    self.tune_dir, f"serve-{self.replica_id}",
                    device=self.engine.device,
                )
            except Exception:  # noqa: BLE001 — tuning must never kill serving
                res = None
            if res is None:
                self._draining.wait(self.tune_idle_s)
            else:
                self._tel.event(
                    "tuning_lease", replica=self.replica_id,
                    lease=res["lease"], probes=len(res["probes"]),
                )

    def _fleet_payload(self) -> dict:
        """Merged into every membership heartbeat: serve counters + a
        full live-metrics snapshot, so the fleet dir alone feeds the
        top/slo_report fleet view (histograms merge by construction)."""
        return {
            "protocol": PROTOCOL,
            "http": self.http,
            "shed_policy": self.shed_policy,
            "stats": self.engine.stats.as_dict(),
            "live": self.engine.metrics.snapshot(),
        }

    def run_until_shutdown(self, *, install_signal_handlers: bool = True) -> int:
        """Block until SIGTERM/SIGINT (or :meth:`request_shutdown`),
        then drain and return 0 — the CLI's foreground loop. The signal
        handler only sets an event; the drain itself runs here, on the
        main thread, under the drain deadline."""
        import signal

        self.start()
        if install_signal_handlers:
            handler = lambda signum, frame: self._shutdown_requested.set()  # noqa: E731
            signal.signal(signal.SIGTERM, handler)
            signal.signal(signal.SIGINT, handler)
        self._shutdown_requested.wait()
        self.drain()
        return 0

    def request_shutdown(self) -> None:
        self._shutdown_requested.set()

    def drain(self) -> None:
        """SIGTERM semantics: stop accepting, finish in-flight requests
        under the drain deadline, force-close stragglers, flush the
        final stats + metrics snapshots. Idempotent."""
        if self._draining.is_set():
            self._stopped.wait(self.drain_timeout_s + 5.0)
            return
        self._draining.set()
        # Leave the fleet first: removing the membership record stops
        # routers sending NEW traffic here while in-flight work finishes.
        if self._registration is not None:
            self._registration.stop(deregister=True)
        self._tel.event("serve_drain", open_connections=len(self._conns),
                        drain_timeout_s=self.drain_timeout_s)
        ls = self._listener
        if ls is not None:
            # shutdown() before close(): a close alone does not wake a
            # thread blocked in accept() on Linux — the shutdown does,
            # and new connects get an immediate refusal.
            try:
                ls.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                ls.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        # Half-close every connection's read side: the handler finishes
        # the request it is processing (its write side still works),
        # then sees EOF and exits — buffered-but-unread requests are
        # dropped, which is what "stop accepting work" means.
        with self._conn_lock:
            conns = dict(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        deadline = time.monotonic() + self.drain_timeout_s
        for thread in conns.values():
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
        # Past the deadline: force-close whatever is left (a wedged
        # in-flight request must not hold the drain hostage).
        with self._conn_lock:
            stragglers = dict(self._conns)
        for sock, thread in stragglers.items():
            try:
                sock.close()
            except OSError:
                pass
            thread.join(timeout=1.0)
        self.engine.metrics.stop_snapshotter(final_write=True)
        write_final_snapshot(self.engine)  # even if no snapshotter ran
        self.engine.close()  # idempotent; flushes serve_stats.json
        self._stopped.set()

    # -- accept path ---------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._draining.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return  # listener closed: drain started
            try:
                active = (self.fault_plan.fire("serve_accept")
                          if self.fault_plan is not None else None)
                if active is not None:
                    try:
                        active.wrap(lambda: None)()
                    except Exception as e:  # noqa: BLE001 — injected
                        self._send_line(sock, {
                            "error": "unavailable",
                            "detail": f"injected: {type(e).__name__}",
                            "retry_after_ms": self.retry_after_ms,
                        })
                        sock.close()
                        continue
                if self._draining.is_set():
                    sock.close()
                    return
                with self._conn_lock:
                    at_capacity = len(self._conns) >= self.max_connections
                if at_capacity:
                    self._count_rejection()
                    self._send_line(sock, {
                        "error": "overloaded",
                        "reason": "max_connections",
                        "retry_after_ms": self.retry_after_ms,
                    })
                    sock.close()
                    continue
                thread = threading.Thread(
                    target=self._handle_connection, args=(sock,),
                    name=f"pj-serve-conn-{addr[1]}", daemon=True,
                )
                with self._conn_lock:
                    self._conns[sock] = thread
                    n_open = len(self._conns)
                self._publish_open(n_open)
                thread.start()
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass

    def _publish_open(self, n_open: int) -> None:
        self.engine.stats.open_connections = n_open
        self.engine.metrics.gauge("pjtpu_open_connections", n_open)

    # -- per-connection path -------------------------------------------------

    def _send_line(self, sock: socket.socket, obj: dict) -> bool:
        try:
            sock.sendall((json.dumps(obj) + "\n").encode("utf-8"))
            return True
        except OSError:
            return False

    _HTTP_METHODS = (b"GET ", b"POST ", b"HEAD ", b"PUT ", b"DELETE ",
                     b"OPTIONS ", b"PATCH ")

    def _sniff_http(self, sock: socket.socket) -> bool:
        """Classify one accepted connection in ``--http`` mode. HTTP
        clients talk first (a method token within milliseconds);
        ``pjtpu-serve/1`` clients — the fleet router's forwards
        included — wait for the server header line. So: peek briefly,
        and anything that is not an HTTP request line (including
        silence) falls back to the line protocol. An ``--http`` replica
        therefore still serves routed fleet traffic."""
        try:
            sock.settimeout(0.25)
            first = sock.recv(8, socket.MSG_PEEK)
        except (TimeoutError, socket.timeout, OSError):
            return False
        finally:
            try:
                sock.settimeout(None)
            except OSError:
                pass
        return any(first.startswith(m[: len(first)]) and first
                   for m in self._HTTP_METHODS)

    def _handle_connection(self, sock: socket.socket) -> None:
        try:
            try:
                peer = sock.getpeername()[0]
            except OSError:
                peer = None
            if self.http and self._sniff_http(sock):
                self._serve_http(sock, peer)
                return
            self._send_line(sock, {
                "protocol": PROTOCOL,
                "graph_digest": self.engine.store.digest,
                "shed_policy": self.shed_policy,
                "max_inflight": self.max_inflight,
                "replica_id": self.replica_id,
            })
            reader = sock.makefile("r", encoding="utf-8", newline="\n")
            for line in reader:
                if not line.strip():
                    continue
                self._handle_request(sock, line, peer)
        except (OSError, ValueError):
            pass  # client went away / socket force-closed mid-drain
        finally:
            with self._conn_lock:
                self._conns.pop(sock, None)
                n_open = len(self._conns)
            self._publish_open(n_open)
            try:
                sock.close()
            except OSError:
                pass

    def _count_rejection(self, *, deadline: bool = False) -> None:
        with self._stats_lock:
            if deadline:
                self.engine.stats.deadline_drops += 1
            else:
                self.engine.stats.rejected += 1
        name = "pjtpu_deadline_drops" if deadline else "pjtpu_rejected"
        self.engine.metrics.counter(name).add(1)
        # Rejections and deadline drops spend real error budget: they
        # are the availability signal the burn-rate alert (and thus the
        # shedding trigger) keys off under overload.
        self.engine.metrics.observe_slo(self.engine.slo.name, None, ok=False)

    def _shed_now(self) -> bool:
        """Current shedding verdict + transition bookkeeping. The
        tracker's ``burning`` flips inside ``observe_slo`` (every
        answered/rejected request updates it), so this read is cheap."""
        if self.shed_policy == "off":
            return False
        burning = self._tracker.burning
        if burning and self.shed_min_events:
            # Low-traffic guard: the burn verdict must be backed by
            # real volume inside the rule's long window before the
            # front end starts degrading answers over it.
            t = self._tracker
            window = min(long_w for long_w, _, _ in t.slo.rules)
            n = t.good.count_in(window) + t.bad.count_in(window)
            if n < self.shed_min_events:
                burning = False
        if burning != self.shed_active:
            with self._stats_lock:
                flipped = burning != self.shed_active
                if flipped:
                    self.shed_active = burning
            if flipped:
                stats = self.engine.stats
                self._tel.event(
                    "slo_shed", engaged=burning, slo=self.engine.slo.name,
                    policy=self.shed_policy,
                    burn_rate=self._tracker.evaluate()["burn_rate"],
                    shed_answers=stats.shed_answers,
                    rejected=stats.rejected,
                )
                self.engine.metrics.counter("pjtpu_slo_shed_transitions").add(1)
        return self.shed_active

    def _shed_mode(self) -> str:
        """What a shed exact-miss degrades to — the chosen
        :data:`SHED_PLANS` entry's mode (``"hopset"`` / ``"approx"`` /
        ``"reject"``). Every policy goes through the same
        ``planner.select`` walk: explicit policies are forced pins,
        ``"priced"`` fits the profile store's CostModel and promotes
        the cheaper certified tier only when BOTH are priced beyond the
        planner noise band (same gate as kernel dispatch), unpriced
        falls back to declared tier order (hopset first — its composed
        interval is at least as tight as the landmark one by
        construction). Resolved once per process and cached with the
        full decision record (``health()`` reports it)."""
        if self._shed_mode_cached is not None:
            return self._shed_mode_cached[0]
        engine = self.engine
        model = None
        if self.shed_policy == "priced":
            try:
                from paralleljohnson_tpu_torch.observe.costs import (
                    resolve_profile_dir,
                )
                from paralleljohnson_tpu_torch.observe.store import (
                    CostModel,
                    ProfileStore,
                )

                store_dir = resolve_profile_dir(
                    getattr(engine.config, "profile_store", None)
                )
                if store_dir:
                    model = CostModel.fit(ProfileStore(store_dir))
            except Exception:  # noqa: BLE001 — pricing must never block a shed
                model = None
        try:
            from paralleljohnson_tpu_torch.observe import current_platform

            platform = current_platform(engine.device)
        except Exception:  # noqa: BLE001
            platform = "unknown"
        decision = _planner.select(
            SHED_PLANS,
            types.SimpleNamespace(engine=engine, params={}),
            model=model,
            platform=platform,
            num_edges=int(getattr(engine.graph, "num_edges", 0) or 0),
            batch=1,
            config=types.SimpleNamespace(shed_policy=self.shed_policy),
        )
        mode = _SHED_MODES[decision.chosen.plan.name]
        self._shed_mode_cached = (mode, decision.reason, decision.as_dict())
        return mode

    def health(self) -> dict:
        """The liveness document (``{"op": "health"}``): admission
        gauges, shedding state, and — when a solve heartbeat file is
        configured — its freshness verdict. A torn/partial heartbeat
        (mid-rewrite kill) degrades to ``fresh: false`` + an error tag,
        never an exception (the reader-must-degrade rule)."""
        from paralleljohnson_tpu_torch.utils.telemetry import (
            heartbeat_fresh,
            read_heartbeat,
        )

        stats = self.engine.stats
        doc = {
            "ok": not self._draining.is_set(),
            "protocol": PROTOCOL,
            "replica_id": self.replica_id,
            "draining": self._draining.is_set(),
            "shedding": self.shed_active,
            "shed_policy": self.shed_policy,
            "shed_tier": (
                None if self._shed_mode_cached is None
                else {"mode": self._shed_mode_cached[0],
                      "reason": self._shed_mode_cached[1],
                      "plan": self._shed_mode_cached[2]}
            ),
            "open_connections": stats.open_connections,
            "max_connections": self.max_connections,
            "max_inflight": self.max_inflight,
            "batch_window": self.batch_window,
            "batch_wait_ms": self.batch_wait_ms,
            "queries_total": stats.queries_total,
            "shed_answers": stats.shed_answers,
            "rejected": stats.rejected,
            "deadline_drops": stats.deadline_drops,
        }
        if self.heartbeat_file:
            hb: dict = {
                "path": str(self.heartbeat_file),
                "fresh": heartbeat_fresh(self.heartbeat_file,
                                         self.heartbeat_stale_s),
            }
            try:
                beat = read_heartbeat(self.heartbeat_file)
                hb["ts"] = None if beat is None else beat.get("ts")
            except ValueError:
                hb["error"] = "torn or partial heartbeat file"
            doc["heartbeat"] = hb
        return doc

    def _handle_request(self, sock: socket.socket, line: str,
                        peer: str | None = None) -> None:
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("not a JSON object")
        except ValueError as e:
            self.engine.note_failed_requests(1)
            self._send_line(sock, {"error": f"bad request line: {e}"})
            return
        self._send_line(sock, self._process_request(req, peer))

    def _client_key(self, req: dict, peer: str | None) -> str:
        """Fairness identity: the request's ``client_id`` when the
        client declares one, else the peer address — so an undeclared
        hog is still one key, not anonymous."""
        cid = req.get("client_id")
        if cid is not None:
            return f"id:{cid}"
        return f"peer:{peer}" if peer else "peer:?"

    def _client_slot(self, key: str) -> threading.Semaphore:
        with self._client_lock:
            sem = self._client_slots.get(key)
            if sem is None:
                sem = threading.Semaphore(self.max_inflight_per_client)
                self._client_slots[key] = sem
            return sem

    def _count_client_limited(self) -> None:
        with self._stats_lock:
            self.engine.stats.client_limited += 1
        self.engine.metrics.counter("pjtpu_client_limited").add(1)
        # A fairness rejection spends error budget like any other
        # rejection — the hog's requests are still failed requests.
        self.engine.metrics.observe_slo(self.engine.slo.name, None, ok=False)

    def _process_request(self, req: dict, peer: str | None = None) -> dict:
        """Admission + answer for one parsed request object; always
        returns a response document, never raises. Shared by the JSONL
        socket path and the HTTP adaptation — one admission policy,
        two framings.

        Trace ingress: an upstream wire context
        (``req["trace"]``) is honored — its head-sampling decision is
        final — else one is minted at ``trace_sample``. A sampled
        request runs inside a ``serve_request`` span (``wire_parent``
        carries the router's forward-span ref for the assembler) with
        the context installed for downstream hops (convoy, engine,
        scheduled solves), and its response is stamped with
        ``trace_id``. With the rate at 0 and no wire context, this
        method IS the pre-trace code path: nothing minted, responses
        byte-identical."""
        if req.get("op") == "health":
            return {"id": req.get("id"), **self.health()}
        ctx = None
        if self.trace_sample > 0.0 or _trace.WIRE_KEY in req:
            ctx = _trace.ingress(
                req, rate=self.trace_sample if self._tel else 0.0
            )
        if ctx is None or not ctx.sampled:
            return self._admit(req, peer)
        tel = self._tel
        if not tel:
            # Untraced replica behind a traced router: echo the id so
            # the answer still joins its (router-side) timeline.
            resp = self._admit(req, peer)
            if isinstance(resp, dict):
                resp.setdefault(_trace.RESPONSE_KEY, ctx.trace_id)
            return resp
        if req.get(_trace.WIRE_KEY) is None:
            # Minted here: let the engine's per-query spans see the id.
            req[_trace.WIRE_KEY] = {"id": ctx.trace_id}
        attrs = {"trace": ctx.trace_id, "source": req.get("source")}
        if ctx.parent:
            attrs["wire_parent"] = ctx.parent
        with tel.span("serve_request", **attrs), _trace.use_trace(ctx):
            resp = self._admit(req, peer)
            if isinstance(resp, dict):
                if resp.get("error") is not None:
                    tel.event("request_error", error=str(resp["error"]))
                resp.setdefault(_trace.RESPONSE_KEY, ctx.trace_id)
            return resp

    def _admit(self, req: dict, peer: str | None = None) -> dict:
        req_id = req.get("id")
        if self._draining.is_set():
            self._count_rejection()
            return {"id": req_id, "error": "draining",
                    "retry_after_ms": self.retry_after_ms}
        arrival = time.perf_counter()
        deadline_ms = req.pop("deadline_ms", None)
        if deadline_ms is not None:
            try:
                deadline_ms = float(deadline_ms)
            except (TypeError, ValueError):
                self.engine.note_failed_requests(1)
                return {"id": req_id,
                        "error": f"bad deadline_ms {deadline_ms!r}"}

        # Per-client fairness: the hog is rejected at ITS cap with an
        # explicit client_limited flag while other clients' requests
        # keep reaching the global semaphore below — one flooding
        # client can no longer occupy every in-flight slot.
        client_sem = None
        if self.max_inflight_per_client is not None:
            client_sem = self._client_slot(self._client_key(req, peer))
            if not client_sem.acquire(blocking=False):
                self._count_client_limited()
                return {"id": req_id, "error": "overloaded",
                        "reason": "max_inflight_per_client",
                        "client_limited": True,
                        "retry_after_ms": self.retry_after_ms}
        try:
            # Admission: a free in-flight slot or an explicit answer — a
            # deadline-carrying request may wait for a slot up to its own
            # patience (the bounded queue IS the deadline), everyone else
            # is rejected immediately rather than queued.
            acquired = self._inflight.acquire(blocking=False)
            if not acquired and deadline_ms is not None:
                remaining = (deadline_ms / 1e3
                             - (time.perf_counter() - arrival))
                if remaining > 0:
                    acquired = self._inflight.acquire(timeout=remaining)
            if not acquired:
                if deadline_ms is not None:
                    self._count_rejection(deadline=True)
                    return {"id": req_id, "error": "deadline",
                            "deadline_ms": deadline_ms,
                            "waited_ms": round(
                                (time.perf_counter() - arrival) * 1e3, 3)}
                self._count_rejection()
                return {"id": req_id, "error": "overloaded",
                        "reason": "max_inflight",
                        "retry_after_ms": self.retry_after_ms}
            try:
                # The slot may have freed exactly at the deadline:
                # re-check before the engine sees the request.
                if deadline_ms is not None and (
                        (time.perf_counter() - arrival) * 1e3 > deadline_ms):
                    self._count_rejection(deadline=True)
                    return {"id": req_id, "error": "deadline",
                            "deadline_ms": deadline_ms,
                            "waited_ms": round(
                                (time.perf_counter() - arrival) * 1e3, 3)}
                return self._answer_doc(req)
            finally:
                self._inflight.release()
        finally:
            if client_sem is not None:
                client_sem.release()

    def _answer_doc(self, req: dict) -> dict:
        engine = self.engine
        req_id = req.get("id")
        shed = False
        mode = req.get("mode", engine.miss_policy)
        if mode in ("exact", "solve") and self._shed_now():
            src = req.get("source")
            is_hit = False
            try:
                is_hit = int(src) in engine.store
            except (TypeError, ValueError):
                pass  # malformed: the engine's parser owns the error
            if not is_hit:
                shed_to = self._shed_mode()
                tel = self._tel
                tid = _trace.current_trace_id() if tel else None
                if tid:
                    # The shed decision as a first-class span: the chaos drill asserts a shed answer
                    # reconstructs with this decision point visible.
                    tel.finish_span(tel.begin_span(
                        "shed_decision", trace=tid,
                        policy=self.shed_policy, mode=shed_to,
                    ))
                if shed_to == "reject":
                    self._count_rejection()
                    return {"id": req_id, "error": "overloaded",
                            "reason": "shedding", "shed": True,
                            "retry_after_ms": self.retry_after_ms}
                # Certified degrade: the landmark/hopset answer is
                # flagged exact=false AND shed=true, and carries
                # max_error — never an unflagged approximation. The
                # tier is the SHED_PLANS decision's (priced under
                # "priced", forced pin otherwise).
                req = {**req, "mode": shed_to}
                shed = True
        try:
            if self.batcher is not None:
                resp = self.batcher.submit(req)
            else:
                resp = engine.query_batch([req])[0]
        except QueryError as e:
            resp = {"id": req_id, "error": str(e)}
        except Exception as e:  # noqa: BLE001 — a solve/store failure
            # must become an error RESPONSE, not a dead connection.
            engine.note_failed_requests(1)
            resp = {"id": req_id,
                    "error": f"internal: {type(e).__name__}: {e}"}
        if shed and "error" not in resp:
            resp["shed"] = True
            with self._stats_lock:
                engine.stats.shed_answers += 1
            engine.metrics.counter("pjtpu_shed_answers").add(1)
        return resp

    # -- HTTP/1.1 adaptation --------------------------------------

    _HTTP_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                     429: "Too Many Requests",
                     500: "Internal Server Error",
                     503: "Service Unavailable", 504: "Gateway Timeout"}

    @staticmethod
    def _http_status_for(resp: dict) -> int:
        err = resp.get("error")
        if err is None:
            return 200
        if err == "overloaded":
            return 429
        if err == "draining":
            return 503
        if err == "deadline":
            return 504
        if str(err).startswith("internal"):
            return 500
        return 400

    def _send_http(self, sock: socket.socket, status: int, doc: dict,
                   *, extra_headers: tuple = ()) -> None:
        body = (json.dumps(doc) + "\n").encode("utf-8")
        head = [f"HTTP/1.1 {status} {self._HTTP_REASONS.get(status, 'OK')}",
                "Content-Type: application/json",
                f"Content-Length: {len(body)}"]
        head.extend(extra_headers)
        sock.sendall(("\r\n".join(head) + "\r\n\r\n").encode("ascii") + body)

    def _serve_http(self, sock: socket.socket, peer: str | None) -> None:
        """Minimal HTTP/1.1 framing over the same admission path, for
        commodity load balancers: ``POST /query`` carries one protocol
        line as its JSON body and returns the same answer document;
        ``GET /healthz`` maps the health op to 200/503 by the solve
        heartbeat's freshness. Overload answers 429 + ``Retry-After``.
        Stdlib request-line + header parsing; keep-alive until the
        client closes or sends ``Connection: close``."""
        reader = sock.makefile("rb")
        while True:
            reqline = reader.readline(8192)
            if not reqline or not reqline.strip():
                return
            try:
                method, path, _version = (
                    reqline.decode("ascii").split(None, 2))
            except (UnicodeDecodeError, ValueError):
                self._send_http(sock, 400, {"error": "bad request line"})
                return
            headers: dict[str, str] = {}
            while True:
                hline = reader.readline(8192)
                if not hline or hline in (b"\r\n", b"\n"):
                    break
                if b":" in hline:
                    k, v = hline.split(b":", 1)
                    headers[k.strip().lower().decode("latin-1")] = (
                        v.strip().decode("latin-1"))
            try:
                length = int(headers.get("content-length", "0"))
            except ValueError:
                self._send_http(sock, 400, {"error": "bad content-length"})
                return
            body = reader.read(length) if length > 0 else b""
            if len(body) < length:
                return  # truncated body: client went away mid-request
            method = method.upper()
            if method == "GET" and path in ("/healthz", "/health"):
                doc = self.health()
                hb = doc.get("heartbeat")
                ok = doc["ok"] and (hb is None or hb.get("fresh", False))
                self._send_http(sock, 200 if ok else 503, doc)
            elif method == "POST" and path == "/query":
                try:
                    req = json.loads(body.decode("utf-8"))
                    if not isinstance(req, dict):
                        raise ValueError("body must be a JSON object")
                except (UnicodeDecodeError, ValueError) as e:
                    self.engine.note_failed_requests(1)
                    self._send_http(sock, 400,
                                    {"error": f"bad request line: {e}"})
                else:
                    resp = self._process_request(req, peer)
                    status = self._http_status_for(resp)
                    extra = []
                    retry_ms = resp.get("retry_after_ms")
                    if status in (429, 503) and retry_ms is not None:
                        secs = max(1, (int(retry_ms) + 999) // 1000)
                        extra.append(f"Retry-After: {secs}")
                    self._send_http(sock, status, resp,
                                    extra_headers=tuple(extra))
            else:
                self._send_http(sock, 404,
                                {"error": f"no route {method} {path}"})
            if headers.get("connection", "").lower() == "close":
                return


def write_final_snapshot(engine) -> None:
    """One last atomic serve_live.json beside the store (used by the
    CLI after a drain when the periodic snapshotter never started —
    e.g. an in-memory store that grew a checkpoint mid-serve)."""
    if engine.store.ckpt is None:
        return
    try:
        engine.metrics.write_snapshot(
            engine.store.ckpt.dir / SERVE_LIVE_FILENAME
        )
    except OSError:
        pass
