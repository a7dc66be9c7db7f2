"""Thin stdlib router for a replicated serve fleet (``pjtpu serve --route``).

Forwards ``pjtpu-serve/1`` lines to the replica that owns each request's
source under the published consistent-hash table (:mod:`.fleet`). Replies
are forwarded **verbatim** — the router never rewrites an answer document,
so exactness/staleness flags survive byte-for-byte.

Failure handling is the whole point: on connection-refused / broken-pipe /
EOF from a replica (a SIGKILLed process presents all three) the router
ejects the corpse, re-publishes ``routing.json`` minus it (epoch bumped),
and retries the request on the new owner — bounded attempts, then an
explicit ``{"error": "unavailable", "retry_after_ms": ...}``. Replicas
whose heartbeat goes stale-by-age are ejected by the background refresh
even with no traffic aimed at them. Because any replica can serve any
source, failover can only make an answer colder, never wrong.

Request tracing: when constructed with ``telemetry`` the
router is the fleet's first ingress — it mints a ``trace_id`` per
request (head-sampled at ``trace_sample``), wraps routing in a
``route_request`` span and each upstream attempt in a ``forward`` span,
and injects the wire context (``{"trace": {"id", "parent"}}``) into the
forwarded line with the *forward span's* global ref as the replica's
parent — so a failover retry shows up in the assembled timeline as two
``forward`` hops (the first status=error) under one ``route_request``.
Replies remain verbatim: the REPLICA stamps ``trace_id`` into the
answer document, the router never rewrites it.
"""

from __future__ import annotations

import json
import signal
import socket
import threading
import time

from paralleljohnson_tpu_torch.observe import trace as _trace
from paralleljohnson_tpu_torch.serve import fleet as _fleet
from paralleljohnson_tpu_torch.utils import telemetry as _telemetry

PROTOCOL = "pjtpu-serve/1"  # same wire protocol as serve.frontend

DEFAULT_RETRY_AFTER_MS = 100
DEFAULT_MAX_ATTEMPTS = 4
DEFAULT_REFRESH_INTERVAL_S = 0.5
DEFAULT_CONNECT_TIMEOUT_S = 2.0
DEFAULT_IO_TIMEOUT_S = 30.0


class _ReplicaDown(Exception):
    """One upstream replica refused/closed — eject and re-route."""


class FleetRouter:
    def __init__(
        self,
        fleet_dir,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        stale_after_s: float = _fleet.DEFAULT_REPLICA_STALE_S,
        vnodes: int = _fleet.DEFAULT_VNODES,
        retry_after_ms: int = DEFAULT_RETRY_AFTER_MS,
        max_attempts: int = DEFAULT_MAX_ATTEMPTS,
        connect_timeout_s: float = DEFAULT_CONNECT_TIMEOUT_S,
        io_timeout_s: float = DEFAULT_IO_TIMEOUT_S,
        refresh_interval_s: float = DEFAULT_REFRESH_INTERVAL_S,
        telemetry=None,
        trace_sample: float | None = None,
    ) -> None:
        self.fleet_dir = fleet_dir
        self._tel = _telemetry.resolve(telemetry)
        # Default sample rate: trace everything when telemetry is wired
        # (a trace dir was configured), nothing otherwise. The untraced
        # path never parses/mints anything.
        self.trace_sample = (
            float(trace_sample) if trace_sample is not None
            else (1.0 if self._tel else 0.0)
        )
        self.host = host
        self.port = int(port)
        self.stale_after_s = float(stale_after_s)
        self.vnodes = int(vnodes)
        self.retry_after_ms = int(retry_after_ms)
        self.max_attempts = max(1, int(max_attempts))
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self.refresh_interval_s = max(0.05, float(refresh_interval_s))
        self.graph_digest: str | None = None
        self.stats = {
            "connections": 0,
            "forwarded": 0,
            "retries": 0,
            "ejected": 0,
            "republished": 0,
            "unavailable": 0,
        }
        self._lock = threading.Lock()
        self._members: dict[str, dict] = {}
        # rid -> wall-clock of our forced eject; a record must heartbeat
        # AFTER this to be re-admitted (a fresh-looking corpse stays out).
        self._dead: dict[str, float] = {}
        self._table: _fleet.RoutingTable | None = None
        self._last_refresh = 0.0
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._refresh_thread: threading.Thread | None = None
        self._draining = threading.Event()
        self._stopped = threading.Event()

    # -- membership / table -------------------------------------------------

    def _refresh(self, *, force: bool = False) -> None:
        now = time.time()
        with self._lock:
            if not force and now - self._last_refresh < self.refresh_interval_s:
                return
            self._last_refresh = now
            dead = dict(self._dead)
        live = _fleet.live_replicas(
            self.fleet_dir, stale_after_s=self.stale_after_s, now=now
        )
        members: dict[str, dict] = {}
        for rec in live:
            rid = rec["replica_id"]
            died_at = dead.get(rid)
            if died_at is not None and not (
                isinstance(rec.get("ts"), (int, float)) and rec["ts"] > died_at
            ):
                continue  # ejected corpse with a not-yet-stale record
            members[rid] = {"host": rec.get("host"), "port": rec.get("port")}
            if self.graph_digest is None and rec.get("graph_digest"):
                self.graph_digest = rec["graph_digest"]
        with self._lock:
            for rid in members:
                self._dead.pop(rid, None)
            if set(members) != set(self._members) or self._table is None:
                self._members = members
                self._table = _fleet.publish_routing(
                    self.fleet_dir, members, vnodes=self.vnodes
                )
                self.stats["republished"] += 1

    def _eject(self, replica_id: str) -> None:
        with self._lock:
            self._dead[replica_id] = time.time()
            if replica_id not in self._members:
                return
            del self._members[replica_id]
            self.stats["ejected"] += 1
            self._table = _fleet.publish_routing(
                self.fleet_dir, self._members, vnodes=self.vnodes
            )
            self.stats["republished"] += 1

    def _refresh_loop(self) -> None:
        while not self._stopped.wait(self.refresh_interval_s):
            try:
                self._refresh(force=True)
            except OSError:
                pass

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FleetRouter":
        self._refresh(force=True)
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.host, self.port))
        listener.listen(128)
        self.host, self.port = listener.getsockname()[:2]
        self._listener = listener
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-router-accept", daemon=True
        )
        self._accept_thread.start()
        self._refresh_thread = threading.Thread(
            target=self._refresh_loop, name="fleet-router-refresh", daemon=True
        )
        self._refresh_thread.start()
        return self

    def address(self) -> tuple[str, int]:
        return self.host, self.port

    @property
    def table(self) -> "_fleet.RoutingTable | None":
        with self._lock:
            return self._table

    def drain(self) -> None:
        if self._stopped.is_set():
            return
        self._draining.set()
        self._stopped.set()
        if self._listener is not None:
            # close() alone does not wake a thread blocked in accept()
            # on Linux — poke the listener so the accept loop observes
            # the drain flag instead of riding out the join timeout.
            try:
                poke_host = ("127.0.0.1" if self.host in ("", "0.0.0.0")
                             else self.host)
                with socket.create_connection(
                    (poke_host, self.port), timeout=0.5
                ):
                    pass
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        for t in (self._accept_thread, self._refresh_thread):
            if t is not None:
                t.join(timeout=2.0)

    def run_until_shutdown(self) -> None:
        def _sig(_signum, _frame):
            threading.Thread(target=self.drain, daemon=True).start()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _sig)
            except ValueError:
                pass  # not the main thread
        self._stopped.wait()
        self.drain()

    # -- serving ------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._draining.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                break
            with self._lock:
                self.stats["connections"] += 1
            threading.Thread(
                target=self._handle_connection, args=(sock,), daemon=True
            ).start()

    def health(self) -> dict:
        now = time.time()
        recs = _fleet.read_replicas(
            self.fleet_dir, stale_after_s=self.stale_after_s, now=now
        )
        with self._lock:
            epoch = self._table.epoch if self._table is not None else None
            live = len(self._members)
            stats = dict(self.stats)
        return {
            "ok": live > 0,
            "router": True,
            "listening": f"{self.host}:{self.port}",
            "epoch": epoch,
            "replicas_live": live,
            "replicas": {
                r["replica_id"]: {
                    "host": r.get("host"),
                    "port": r.get("port"),
                    "age_s": r.get("age_s"),
                    "stale": r.get("stale"),
                }
                for r in recs
            },
            "stats": stats,
        }

    def _header(self) -> dict:
        with self._lock:
            epoch = self._table.epoch if self._table is not None else None
            live = len(self._members)
        return {
            "protocol": PROTOCOL,
            "router": True,
            "graph_digest": self.graph_digest,
            "epoch": epoch,
            "replicas": live,
        }

    def _handle_connection(self, sock: socket.socket) -> None:
        upstreams: dict[str, tuple[socket.socket, object]] = {}
        try:
            sock.sendall((json.dumps(self._header()) + "\n").encode("utf-8"))
            reader = sock.makefile("r", encoding="utf-8", newline="\n")
            for line in reader:
                line = line.strip()
                if not line:
                    continue
                out = self._route_line(upstreams, line)
                if isinstance(out, dict):
                    out = json.dumps(out) + "\n"
                elif not out.endswith("\n"):
                    out += "\n"
                sock.sendall(out.encode("utf-8"))
        except OSError:
            pass
        finally:
            for up_sock, _rfile in upstreams.values():
                try:
                    up_sock.close()
                except OSError:
                    pass
            try:
                sock.close()
            except OSError:
                pass

    def _route_line(self, upstreams, line: str):
        """One request line -> forwarded reply string or local error doc."""
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as exc:
            return {"error": f"bad request line: {exc}"}
        if req.get("op") == "health":
            return self.health()
        tel = self._tel
        ctx = None
        if tel and self.trace_sample > 0.0:
            ctx = _trace.ingress(req, rate=self.trace_sample)
        if ctx is None:
            # Tracing off at this router: forward the line untouched (a
            # client-supplied wire context, if any, rides through to the
            # replica — bitwise-identical requests, the PR-5 guarantee).
            return self._forward(upstreams, req, line, None, None)
        if not ctx.sampled:
            # Head sampling declined this trace: downstream must not
            # re-mint, so the verdict still travels the wire — but no
            # spans open anywhere.
            if req.get(_trace.WIRE_KEY) is None:
                line = json.dumps({**req, _trace.WIRE_KEY: ctx.to_wire()})
            return self._forward(upstreams, req, line, None, None)
        span_attrs = {"trace": ctx.trace_id, "source": str(req.get("source"))}
        if ctx.parent:
            span_attrs["wire_parent"] = ctx.parent
        with tel.span("route_request", **span_attrs):
            return self._forward(upstreams, req, line, ctx, tel)

    def _forward(self, upstreams, req: dict, line: str, ctx, tel):
        """The bounded attempt loop. With a sampled ``ctx``, every
        attempt gets its own ``forward`` span whose global ref becomes
        the replica-side parent — the retry hop after a replica death
        is a first-class span (status=error), not a lost counter."""
        source_key = str(req.get("source"))
        for attempt in range(1, self.max_attempts + 1):
            self._refresh()
            with self._lock:
                table = self._table
            rid = table.owner(source_key) if table is not None else None
            if rid is None:
                break
            if ctx is not None:
                span_id = tel.begin_span(
                    "forward", replica=rid, attempt=attempt,
                    trace=ctx.trace_id,
                )
                wire = ctx.child(tel.global_ref(span_id)).to_wire()
                line_out = json.dumps({**req, _trace.WIRE_KEY: wire})
            else:
                span_id = None
                line_out = line
            try:
                reply = self._roundtrip(upstreams, table, rid, line_out)
            except _ReplicaDown:
                if span_id is not None:
                    tel.finish_span(span_id, "error", "replica_down")
                    tel.event("route_retry", trace=ctx.trace_id,
                              replica=rid, attempt=attempt)
                self._eject(rid)
                with self._lock:
                    self.stats["retries"] += 1
                continue
            if span_id is not None:
                tel.finish_span(span_id)
            with self._lock:
                self.stats["forwarded"] += 1
            return reply
        if ctx is not None:
            tel.event("route_unavailable", trace=ctx.trace_id)
        with self._lock:
            self.stats["unavailable"] += 1
        return {"error": "unavailable", "retry_after_ms": self.retry_after_ms}

    def _roundtrip(self, upstreams, table, rid: str, line: str) -> str:
        conn = upstreams.get(rid)
        if conn is None:
            addr = table.address(rid)
            if addr is None:
                raise _ReplicaDown(rid)
            try:
                up = socket.create_connection(addr, timeout=self.connect_timeout_s)
                up.settimeout(self.io_timeout_s)
                rfile = up.makefile("r", encoding="utf-8", newline="\n")
                if not rfile.readline():  # replica header; EOF = dead
                    raise OSError("no header from replica")
            except OSError as exc:
                raise _ReplicaDown(rid) from exc
            conn = (up, rfile)
            upstreams[rid] = conn
        up, rfile = conn
        try:
            up.sendall((line + "\n").encode("utf-8"))
            reply = rfile.readline()
        except OSError as exc:
            self._drop_upstream(upstreams, rid)
            raise _ReplicaDown(rid) from exc
        if not reply:
            self._drop_upstream(upstreams, rid)
            raise _ReplicaDown(rid)
        return reply

    @staticmethod
    def _drop_upstream(upstreams, rid: str) -> None:
        conn = upstreams.pop(rid, None)
        if conn is not None:
            try:
                conn[0].close()
            except OSError:
                pass
