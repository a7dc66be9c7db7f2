"""Fleet coordinator — lease-based source sharding over a shared dir.

The coordination substrate is a plain directory (local disk in tests,
a filesystem the hosts share in production): no RPC server to keep alive,
so a killed coordinator PROCESS loses nothing — the state machine lives
in two files and any process that can see the directory can resume it.

  fleet.json    the immutable plan: graph spec + digest, the lease
                table (contiguous source ranges), deadlines, worker
                solver-config overrides. Written once at plan time.
  leases.jsonl  append-only transition log: ``claimed`` / ``committed``
                / ``requeued`` / ``extended`` events. Current state =
                replay(plan, log); a torn trailing line (a process
                killed mid-append) is tolerated exactly like the
                flight recorder's.

Every mutation is read-modify-append under an ``flock`` on
``<dir>/.lock``, so concurrent workers claiming over the same
filesystem serialize without a server process.

The two files keep the JAX package's format, so either package's
:meth:`Coordinator.status` reads a directory the other wrote.

The lease state machine::

    pending --claim--> leased --commit--> committed
       ^                 |
       +---requeue-------+   (deadline lapsed + heartbeat stale,
                              worker released it on error, or the
                              owner restarted)

Deadline lapse alone does NOT requeue: a fresh heartbeat file (the
worker's :class:`~paralleljohnson_tpu_torch.utils.telemetry.HeartbeatReporter`
writes it on its own daemon thread) proves the owner process is alive,
and the lease deadline is extended instead — slow-but-alive is not
dead. A stale or absent heartbeat at lapse requeues the range to the
survivors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from pathlib import Path

FLEET_SPEC = "fleet.json"
LEASE_LOG = "leases.jsonl"
LOCK_FILE = ".lock"

PENDING = "pending"
LEASED = "leased"
COMMITTED = "committed"


class CoordinatorError(ValueError):
    """Malformed or inconsistent coordinator state (diagnosable: names
    the file and, for log corruption, the line)."""


class StaleLeaseError(RuntimeError):
    """A commit/release from a worker that no longer owns the lease —
    its deadline lapsed and the range was re-queued (and possibly
    re-solved) while it worked. The worker's rows stay on disk but are
    orphaned: the manifest union only references committing owners."""


@dataclasses.dataclass
class Lease:
    """One contiguous source range ``[start, stop)`` and its state."""

    lease_id: int
    start: int
    stop: int
    state: str = PENDING
    owner: str | None = None
    deadline: float | None = None
    committed_by: str | None = None
    requeues: int = 0
    extensions: int = 0

    @property
    def sources(self) -> range:
        return range(self.start, self.stop)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Coordinator:
    """Filesystem-backed lease coordinator (see module docstring).

    One instance per process; many processes may hold instances on the
    same directory — every mutation re-reads the log under the lock, so
    instances never cache state across calls.
    """

    def __init__(self, directory: str | Path) -> None:
        self.dir = Path(directory)
        spec_path = self.dir / FLEET_SPEC
        if not spec_path.exists():
            raise CoordinatorError(
                f"{spec_path}: no fleet plan here — create one with "
                "Coordinator.create (or distributed.plan_fleet)"
            )
        try:
            self.spec = json.loads(spec_path.read_text(encoding="utf-8"))
        except ValueError as e:
            raise CoordinatorError(f"{spec_path}: unreadable plan: {e}") from e
        for key in ("graph_spec", "graph_digest", "leases",
                    "lease_deadline_s", "heartbeat_stale_s"):
            if key not in self.spec:
                raise CoordinatorError(f"{spec_path}: plan missing {key!r}")

    # -- construction --------------------------------------------------------

    @classmethod
    def create(
        cls,
        directory: str | Path,
        *,
        graph_spec: str,
        graph_digest: str,
        num_sources: int,
        lease_sources: int,
        lease_deadline_s: float = 30.0,
        heartbeat_stale_s: float | None = None,
        heartbeat_interval_s: float | None = None,
        backend: str = "torch",
        config: dict | None = None,
        start: int = 0,
    ) -> "Coordinator":
        """Write the immutable fleet plan: the source space
        ``[start, start + num_sources)`` cut into ``lease_sources``-wide
        contiguous leases. Refuses a directory that already holds a plan
        (resume via :class:`Coordinator` / ``open`` instead — a second
        plan over live shards would orphan them silently). ``backend``
        must be registered in this package (``available_backends()``):
        every worker builds its solver from it."""
        from paralleljohnson_tpu_torch.backends import available_backends

        directory = Path(directory)
        if backend not in available_backends():
            raise CoordinatorError(
                f"backend {backend!r} is not registered in "
                f"paralleljohnson_tpu_torch (have {available_backends()})"
            )
        if (directory / FLEET_SPEC).exists():
            raise CoordinatorError(
                f"{directory / FLEET_SPEC}: plan already exists — open the "
                "coordinator to resume, or point at a fresh directory"
            )
        if num_sources < 1:
            raise CoordinatorError(f"num_sources must be >= 1, got {num_sources}")
        if lease_sources < 1:
            raise CoordinatorError(
                f"lease_sources must be >= 1, got {lease_sources}"
            )
        if not lease_deadline_s > 0:
            raise CoordinatorError(
                f"lease_deadline_s must be > 0, got {lease_deadline_s}"
            )
        directory.mkdir(parents=True, exist_ok=True)
        leases = []
        lo = start
        i = 0
        while lo < start + num_sources:
            hi = min(lo + lease_sources, start + num_sources)
            leases.append([i, lo, hi])
            lo = hi
            i += 1
        spec = {
            "version": 1,
            "graph_spec": graph_spec,
            "graph_digest": graph_digest,
            "backend": backend,
            "num_sources": int(num_sources),
            "start": int(start),
            "lease_sources": int(lease_sources),
            "lease_deadline_s": float(lease_deadline_s),
            # Stale threshold defaults to 2x the deadline: one full
            # missed deadline's worth of silence past the last beat.
            "heartbeat_stale_s": float(
                heartbeat_stale_s if heartbeat_stale_s is not None
                else 2.0 * lease_deadline_s
            ),
            "heartbeat_interval_s": float(
                heartbeat_interval_s if heartbeat_interval_s is not None
                else max(0.2, min(5.0, lease_deadline_s / 5.0))
            ),
            "config": dict(config or {}),
            "leases": leases,
            "created_ts": time.time(),
        }
        tmp = directory / (FLEET_SPEC + f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(spec, indent=2), encoding="utf-8")
        os.replace(tmp, directory / FLEET_SPEC)
        (directory / LEASE_LOG).touch()
        for sub in ("heartbeats", "shards", "telemetry", "workers", "logs",
                    "metrics"):
            (directory / sub).mkdir(exist_ok=True)
        return cls(directory)

    # -- paths ---------------------------------------------------------------

    def heartbeat_path(self, worker: str) -> Path:
        return self.dir / "heartbeats" / f"{worker}.json"

    def shard_dir(self, worker: str) -> Path:
        """The worker's checkpoint shard root (the ordinary solver
        ``checkpoint_dir`` — ``BatchCheckpointer`` adds its per-graph
        subdirectory underneath)."""
        return self.dir / "shards" / worker

    def telemetry_dir(self, worker: str) -> Path:
        return self.dir / "telemetry" / worker

    def worker_summary_path(self, worker: str) -> Path:
        return self.dir / "workers" / f"{worker}.summary.json"

    def metrics_path(self, worker: str) -> Path:
        """The worker's live-metrics snapshot: lease claim-to-commit
        latency histogram, solver batch walls, retry/OOM rates —
        atomically rewritten every heartbeat interval by the worker's
        ``MetricsRegistry`` snapshotter, joined fleet-wide by the
        fleet's ``top`` view."""
        return self.dir / "metrics" / f"{worker}.json"

    # -- log machinery -------------------------------------------------------

    @contextlib.contextmanager
    def _locked(self):
        import fcntl

        fd = os.open(self.dir / LOCK_FILE, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _append(self, event: dict) -> None:
        event.setdefault("ts", time.time())
        with open(self.dir / LEASE_LOG, "a", encoding="utf-8") as f:
            f.write(json.dumps(event) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def _replay(self) -> dict[int, Lease]:
        leases = {
            int(i): Lease(lease_id=int(i), start=int(lo), stop=int(hi))
            for i, lo, hi in self.spec["leases"]
        }
        log = self.dir / LEASE_LOG
        if not log.exists():
            return leases
        lines = log.read_text(encoding="utf-8").splitlines()
        for n, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                if n == len(lines) - 1:
                    continue  # torn trailing line: killed mid-append
                raise CoordinatorError(
                    f"{log}:{n + 1}: corrupt lease event (not the last "
                    "line — this is not kill damage)"
                ) from None
            lease = leases.get(int(ev.get("lease", -1)))
            if lease is None:
                raise CoordinatorError(
                    f"{log}:{n + 1}: event for unknown lease "
                    f"{ev.get('lease')!r}"
                )
            kind = ev.get("ev")
            if kind == "claimed" and lease.state == PENDING:
                lease.state = LEASED
                lease.owner = ev["worker"]
                lease.deadline = float(ev["deadline"])
            elif kind == "committed" and lease.state == LEASED \
                    and lease.owner == ev.get("worker"):
                lease.state = COMMITTED
                lease.committed_by = ev["worker"]
            elif kind == "requeued" and lease.state == LEASED:
                lease.state = PENDING
                lease.owner = None
                lease.deadline = None
                lease.requeues += 1
            elif kind == "extended" and lease.state == LEASED \
                    and lease.owner == ev.get("worker"):
                lease.deadline = float(ev["deadline"])
                lease.extensions += 1
            else:
                raise CoordinatorError(
                    f"{log}:{n + 1}: invalid transition {kind!r} on lease "
                    f"{lease.lease_id} in state {lease.state!r} "
                    f"(owner {lease.owner!r}, event worker "
                    f"{ev.get('worker')!r})"
                )
        return leases

    # -- heartbeat liveness --------------------------------------------------

    def _owner_alive(self, worker: str, now: float) -> bool:
        """True when the worker's heartbeat file is fresher than the
        plan's stale threshold — process-liveness, not progress (a
        worker hung inside a device call is bounded by its own stage
        watchdog, which either errors the stage or kills the process)."""
        from paralleljohnson_tpu_torch.utils.telemetry import heartbeat_fresh

        return heartbeat_fresh(
            self.heartbeat_path(worker),
            self.spec["heartbeat_stale_s"],
            now=now,
        )

    def _reap_locked(self, leases: dict[int, Lease], now: float) -> list[dict]:
        """Deadline-lapse scan (call under the lock): stale owner ->
        requeue, fresh owner -> extend. Returns the appended events."""
        events = []
        for lease in leases.values():
            if lease.state != LEASED or lease.deadline is None:
                continue
            if now < lease.deadline:
                continue
            if self._owner_alive(lease.owner, now):
                new_deadline = now + self.spec["lease_deadline_s"]
                ev = {"ev": "extended", "lease": lease.lease_id,
                      "worker": lease.owner, "deadline": new_deadline,
                      "ts": now}
                lease.deadline = new_deadline
                lease.extensions += 1
            else:
                ev = {"ev": "requeued", "lease": lease.lease_id,
                      "worker": lease.owner, "reason": "deadline", "ts": now}
                lease.state = PENDING
                lease.owner = None
                lease.deadline = None
                lease.requeues += 1
            self._append(ev)
            events.append(ev)
        return events

    # -- the worker-facing API ----------------------------------------------

    def claim(self, worker: str, *, now: float | None = None) -> Lease | None:
        """Claim the lowest-id pending lease (after a reap pass, so an
        expired dead owner's range is claimable immediately). None when
        nothing is pending — the caller polls; outstanding leases may
        still be re-queued by a later reap."""
        now = time.time() if now is None else now
        with self._locked():
            leases = self._replay()
            self._reap_locked(leases, now)
            for lease in sorted(leases.values(), key=lambda l: l.lease_id):
                if lease.state == PENDING:
                    deadline = now + self.spec["lease_deadline_s"]
                    self._append({
                        "ev": "claimed", "lease": lease.lease_id,
                        "worker": worker, "deadline": deadline, "ts": now,
                    })
                    lease.state = LEASED
                    lease.owner = worker
                    lease.deadline = deadline
                    return lease
        return None

    def commit(self, lease_id: int, worker: str,
               *, now: float | None = None) -> Lease:
        """Mark a leased range solved-and-checkpointed. Raises
        :class:`StaleLeaseError` when ``worker`` no longer owns it (the
        deadline lapsed and the range was re-queued mid-solve) — the
        caller drops the lease and moves on; its rows stay orphaned."""
        now = time.time() if now is None else now
        with self._locked():
            leases = self._replay()
            lease = self._lease_or_die(leases, lease_id)
            if lease.state != LEASED or lease.owner != worker:
                raise StaleLeaseError(
                    f"lease {lease_id} is {lease.state} "
                    f"(owner {lease.owner!r}), not leased by {worker!r} — "
                    "its deadline lapsed and the range was re-queued"
                )
            self._append({"ev": "committed", "lease": lease_id,
                          "worker": worker, "ts": now})
            lease.state = COMMITTED
            lease.committed_by = worker
            return lease

    def release(self, lease_id: int, worker: str, *, reason: str,
                now: float | None = None) -> None:
        """Voluntarily requeue a lease the worker cannot finish (solve
        error, shutdown). Stale releases raise like stale commits."""
        now = time.time() if now is None else now
        with self._locked():
            leases = self._replay()
            lease = self._lease_or_die(leases, lease_id)
            if lease.state != LEASED or lease.owner != worker:
                raise StaleLeaseError(
                    f"lease {lease_id} is {lease.state} "
                    f"(owner {lease.owner!r}), not leased by {worker!r}"
                )
            self._append({"ev": "requeued", "lease": lease_id,
                          "worker": worker, "reason": reason, "ts": now})

    def recover_worker(self, worker: str, *, now: float | None = None) -> list[int]:
        """Requeue every lease ``worker`` holds — run at WORKER STARTUP.
        A restarted worker reusing its id would otherwise vouch (via its
        fresh heartbeat) for leases its previous incarnation died
        holding, extending them forever."""
        now = time.time() if now is None else now
        requeued = []
        with self._locked():
            leases = self._replay()
            for lease in leases.values():
                if lease.state == LEASED and lease.owner == worker:
                    self._append({
                        "ev": "requeued", "lease": lease.lease_id,
                        "worker": worker, "reason": "owner-restart",
                        "ts": now,
                    })
                    requeued.append(lease.lease_id)
        return requeued

    def reap(self, *, now: float | None = None) -> list[dict]:
        """One deadline-lapse scan (the launcher's monitor loop calls
        this; workers get the same scan for free inside :meth:`claim`).
        Returns the requeue/extend events appended."""
        now = time.time() if now is None else now
        with self._locked():
            return self._reap_locked(self._replay(), now)

    @staticmethod
    def _lease_or_die(leases: dict[int, Lease], lease_id: int) -> Lease:
        lease = leases.get(int(lease_id))
        if lease is None:
            raise CoordinatorError(f"unknown lease id {lease_id}")
        return lease

    # -- introspection -------------------------------------------------------

    def leases(self) -> list[Lease]:
        with self._locked():
            state = self._replay()
        return [state[i] for i in sorted(state)]

    def done(self) -> bool:
        return all(l.state == COMMITTED for l in self.leases())

    def status(self, *, now: float | None = None) -> dict:
        """One machine-readable snapshot (the CLI's ``fleet status``):
        lease counts by state, total requeues/extensions, per-worker
        committed-lease counts, heartbeat ages, and the outstanding
        leases with owner + seconds-to-deadline."""
        now = time.time() if now is None else now
        leases = self.leases()
        by_state: dict[str, int] = {PENDING: 0, LEASED: 0, COMMITTED: 0}
        committed_by: dict[str, int] = {}
        outstanding = []
        for lease in leases:
            by_state[lease.state] += 1
            if lease.committed_by:
                committed_by[lease.committed_by] = (
                    committed_by.get(lease.committed_by, 0) + 1
                )
            if lease.state == LEASED:
                outstanding.append({
                    "lease": lease.lease_id,
                    "range": [lease.start, lease.stop],
                    "owner": lease.owner,
                    "deadline_in_s": round(lease.deadline - now, 3),
                })
        heartbeats = {}
        hb_dir = self.dir / "heartbeats"
        if hb_dir.is_dir():
            for p in sorted(hb_dir.glob("*.json")):
                worker = p.stem
                try:
                    from paralleljohnson_tpu_torch.utils.telemetry import (
                        read_heartbeat,
                    )

                    hb = read_heartbeat(p)
                    age = None if hb is None else round(
                        now - float(hb.get("ts", 0.0)), 3
                    )
                except ValueError:
                    age = "unreadable"
                heartbeats[worker] = {
                    "age_s": age,
                    "alive": self._owner_alive(worker, now),
                }
        return {
            "dir": str(self.dir),
            "graph_spec": self.spec["graph_spec"],
            "graph_digest": self.spec["graph_digest"],
            "num_sources": self.spec["num_sources"],
            "leases_total": len(leases),
            "leases": by_state,
            "requeues": sum(l.requeues for l in leases),
            "extensions": sum(l.extensions for l in leases),
            "committed_by": committed_by,
            "outstanding": outstanding,
            "heartbeats": heartbeats,
            "done": by_state[COMMITTED] == len(leases),
        }
