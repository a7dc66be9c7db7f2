"""Serve-fleet membership and consistent-hash routing (stdlib-only).

Replicas are ordinary :class:`~paralleljohnson_tpu_torch.serve.frontend.ServeFrontend`
processes; there is no fleet server. Membership reuses the fleet
coordinator idiom: each replica atomically rewrites a heartbeat record at
``<fleet>/serve/replicas/<id>.json`` on the heartbeat clock, and readers
eject records stale by age. The routing table (``<fleet>/serve/routing.json``)
consistent-hashes sources to replicas with virtual nodes and is published
atomically with a monotonic epoch counter, so hot tiers partition across
the fleet instead of duplicating.

Ownership is a cache-locality hint, never a correctness boundary: any
replica can answer any source (a misrouted query is only colder). Torn or
absent files degrade readers (``None`` / flagged records) — they never
raise out of this module.

This module deliberately imports nothing from the package so that
standalone tools (``scripts/slo_report.py`` loads ``observe/live.py`` the
same way) can ``importlib``-load it without torch/numpy present.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Callable

REPLICAS_DIRNAME = "serve/replicas"
ROUTING_FILENAME = "serve/routing.json"

DEFAULT_VNODES = 64
DEFAULT_HEARTBEAT_INTERVAL_S = 1.0
#: A replica whose record is older than this is ejected from the live set.
#: Chosen as several heartbeat intervals so one slow beat does not flap.
DEFAULT_REPLICA_STALE_S = 5.0


def replicas_dir(fleet_dir: str | os.PathLike) -> Path:
    return Path(fleet_dir) / REPLICAS_DIRNAME


def routing_path(fleet_dir: str | os.PathLike) -> Path:
    return Path(fleet_dir) / ROUTING_FILENAME


def _atomic_write_json(path: Path, payload: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    tmp.write_text(json.dumps(payload, sort_keys=True), encoding="utf-8")
    os.replace(tmp, path)


def _read_json(path: Path) -> dict | None:
    """Tolerant read: absent/torn/non-dict files are ``None``, never an error."""
    try:
        doc = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def _hash64(key: str) -> int:
    """Stable 64-bit hash. Python's ``hash()`` is salted per process and
    must never decide ring placement — two processes would disagree."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


# ---------------------------------------------------------------------------
# membership


class ReplicaRegistration:
    """Heartbeated membership record for one serve replica.

    Atomically rewrites ``<fleet>/serve/replicas/<id>.json`` every
    ``interval_s`` seconds from a daemon thread. ``payload_fn`` (if given)
    is called on every beat and its dict is merged into the record — the
    frontend uses it to embed live metrics + serve counters so the fleet
    dir is a self-contained observability surface. A failing payload_fn
    degrades to a bare liveness record; it never kills the heartbeat.
    """

    def __init__(
        self,
        fleet_dir: str | os.PathLike,
        replica_id: str,
        *,
        host: str,
        port: int,
        graph_digest: str | None = None,
        interval_s: float = DEFAULT_HEARTBEAT_INTERVAL_S,
        payload_fn: Callable[[], dict] | None = None,
    ) -> None:
        self.fleet_dir = Path(fleet_dir)
        self.replica_id = str(replica_id)
        self.host = host
        self.port = int(port)
        self.graph_digest = graph_digest
        self.interval_s = max(0.05, float(interval_s))
        self.payload_fn = payload_fn
        self.path = replicas_dir(self.fleet_dir) / f"{self.replica_id}.json"
        self.started_ts: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def record(self) -> dict:
        rec = {
            "kind": "serve_replica",
            "replica_id": self.replica_id,
            "host": self.host,
            "port": self.port,
            "pid": os.getpid(),
            "graph_digest": self.graph_digest,
            "started_ts": self.started_ts,
            "heartbeat_interval_s": self.interval_s,
            "ts": time.time(),
        }
        if self.payload_fn is not None:
            try:
                extra = self.payload_fn()
                if isinstance(extra, dict):
                    rec.update(extra)
            except Exception:
                pass  # liveness beats must outlive a broken payload
        return rec

    def beat(self) -> None:
        _atomic_write_json(self.path, self.record())

    def start(self) -> "ReplicaRegistration":
        if self._thread is not None:
            return self
        self.started_ts = time.time()
        self.beat()
        self._thread = threading.Thread(
            target=self._loop, name=f"replica-heartbeat-{self.replica_id}", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.beat()
            except OSError:
                pass  # fleet dir unwritable this beat; stale-by-age handles it

    def stop(self, *, deregister: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if deregister:
            try:
                self.path.unlink()
            except OSError:
                pass


def read_replicas(
    fleet_dir: str | os.PathLike,
    *,
    stale_after_s: float = DEFAULT_REPLICA_STALE_S,
    now: float | None = None,
) -> list[dict]:
    """All membership records, each age-stamped and ``stale``-flagged.

    Torn records come back as ``{"replica_id": <stem>, "torn": True,
    "stale": True}`` so surfaces can show the corpse instead of crashing.
    """
    if now is None:
        now = time.time()
    out: list[dict] = []
    rdir = replicas_dir(fleet_dir)
    try:
        paths = sorted(p for p in rdir.iterdir() if p.suffix == ".json")
    except OSError:
        return out
    for path in paths:
        rec = _read_json(path)
        if rec is None:
            out.append({"replica_id": path.stem, "torn": True, "ts": None,
                        "age_s": None, "stale": True})
            continue
        rec.setdefault("replica_id", path.stem)
        ts = rec.get("ts")
        age = (now - ts) if isinstance(ts, (int, float)) else None
        rec["age_s"] = round(age, 3) if age is not None else None
        rec["stale"] = age is None or age > stale_after_s
        out.append(rec)
    return out


def live_replicas(
    fleet_dir: str | os.PathLike,
    *,
    stale_after_s: float = DEFAULT_REPLICA_STALE_S,
    now: float | None = None,
) -> list[dict]:
    """Fresh, addressable membership records only (stale-by-age ejected)."""
    return [
        r
        for r in read_replicas(fleet_dir, stale_after_s=stale_after_s, now=now)
        if not r["stale"] and isinstance(r.get("port"), int)
    ]


# ---------------------------------------------------------------------------
# routing


class RoutingTable:
    """Consistent-hash ring: sources -> replica ids, with virtual nodes.

    Each replica contributes ``vnodes`` points at
    ``_hash64(f"{rid}#{i}")``; a source lands on the first ring point at or
    after ``_hash64(str(source))``. Removing one of N replicas therefore
    re-homes only the sources whose successor point belonged to it
    (~1/N of them) — everything else keeps its owner.
    """

    def __init__(
        self,
        replicas: dict[str, dict],
        *,
        vnodes: int = DEFAULT_VNODES,
        epoch: int = 0,
    ) -> None:
        self.replicas = {str(k): dict(v) for k, v in replicas.items()}
        self.vnodes = int(vnodes)
        self.epoch = int(epoch)
        points: list[tuple[int, str]] = []
        for rid in self.replicas:
            for i in range(self.vnodes):
                points.append((_hash64(f"{rid}#{i}"), rid))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [r for _, r in points]

    def owner(self, source: object) -> str | None:
        if not self._points:
            return None
        h = _hash64(str(source))
        idx = bisect.bisect_right(self._points, h)
        if idx == len(self._points):
            idx = 0  # wrap around the ring
        return self._owners[idx]

    def address(self, replica_id: str) -> tuple[str, int] | None:
        rec = self.replicas.get(replica_id)
        if rec is None:
            return None
        host, port = rec.get("host"), rec.get("port")
        if not isinstance(port, int):
            return None
        return str(host), port

    def as_dict(self) -> dict:
        return {
            "kind": "serve_routing",
            "epoch": self.epoch,
            "vnodes": self.vnodes,
            "ts": time.time(),
            "replicas": self.replicas,
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "RoutingTable":
        return cls(
            doc.get("replicas") or {},
            vnodes=int(doc.get("vnodes") or DEFAULT_VNODES),
            epoch=int(doc.get("epoch") or 0),
        )


def read_routing(fleet_dir: str | os.PathLike) -> RoutingTable | None:
    """Read the published table; absent/torn files are ``None``, never raise."""
    doc = _read_json(routing_path(fleet_dir))
    if doc is None:
        return None
    try:
        return RoutingTable.from_dict(doc)
    except (TypeError, ValueError):
        return None


def publish_routing(
    fleet_dir: str | os.PathLike,
    replicas: dict[str, dict] | list[dict],
    *,
    vnodes: int = DEFAULT_VNODES,
    min_epoch: int = 0,
) -> RoutingTable:
    """Atomically publish a new table with a strictly increasing epoch.

    ``replicas`` may be membership records (as from :func:`live_replicas`)
    or an ``id -> {host, port}`` mapping. The epoch is read-increment over
    the current file; pass ``min_epoch`` to stay ahead of a table observed
    elsewhere.
    """
    if isinstance(replicas, list):
        replicas = {
            r["replica_id"]: {"host": r.get("host"), "port": r.get("port")}
            for r in replicas
            if r.get("replica_id")
        }
    prev = read_routing(fleet_dir)
    epoch = max((prev.epoch if prev is not None else 0) + 1, int(min_epoch))
    table = RoutingTable(replicas, vnodes=vnodes, epoch=epoch)
    _atomic_write_json(routing_path(fleet_dir), table.as_dict())
    return table
