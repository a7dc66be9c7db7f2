"""The repair-status marker — the stale-but-servable contract's wire.

The repair engine atomically rewrites ``repair_status.json`` inside the
OLD graph's checkpoint subdirectory (``graph_<old_digest>/``) while it
runs. The serving layer (``serve.store.TileStore``) reads it (mtime-
cached) and flags every answer whose source is in the affected set as
``stale: true`` — the old rows are still EXACT for the pre-update
graph, and every source OUTSIDE the affected set is provably bitwise
identical on the post-update graph too (the dependency argument in
``incremental.repair``), so only genuinely outdated answers carry the
flag.

Lifecycle: ``repairing`` (repair in flight; ``remaining`` shrinks as
parts land in the new digest's subdirectory — the per-part atomic
swap) -> ``done`` (the affected set stays stale forever in the OLD
directory: those rows can never become current there; serve the new
graph digest instead) or ``failed`` (e.g. the update created a
negative cycle: the new graph has no servable distances, the old
answers stay flagged).

``affected`` is ``"all"`` or a sorted source list; lists longer than
``_AFFECTED_LIST_CAP`` collapse to ``"all"`` (a JSON status file must
stay cheap to rewrite per repaired part).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

REPAIR_STATUS_FILENAME = "repair_status.json"

_AFFECTED_LIST_CAP = 200_000


def _encode_sources(sources) -> "str | list[int]":
    if isinstance(sources, str):
        return "all"
    sources = sorted(int(s) for s in sources)
    if len(sources) > _AFFECTED_LIST_CAP:
        return "all"
    return sources


def write_repair_status(
    graph_dir: str | Path,
    *,
    status: str,
    new_digest: str,
    affected,
    total_sources: int,
    remaining=None,
    dirty_parts: int = 0,
    parts_total: int = 0,
    reason: str | None = None,
) -> Path:
    """Atomically (tmp + rename) publish one repair-status snapshot."""
    if status not in ("repairing", "done", "failed"):
        raise ValueError(f"bad repair status {status!r}")
    payload = {
        "version": 1,
        "status": status,
        "new_digest": new_digest,
        "affected": _encode_sources(affected),
        "remaining": (
            _encode_sources(remaining) if remaining is not None
            else _encode_sources(affected)
        ),
        "total_sources": int(total_sources),
        "dirty_parts": int(dirty_parts),
        "parts_total": int(parts_total),
        "ts": time.time(),
    }
    if reason is not None:
        payload["reason"] = reason
    p = Path(graph_dir) / REPAIR_STATUS_FILENAME
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + f".tmp{os.getpid()}")
    tmp.write_text(json.dumps(payload), encoding="utf-8")
    os.replace(tmp, p)
    return p


def read_repair_status(graph_dir: str | Path) -> dict | None:
    """The current status dict, or None when no repair ever touched this
    directory (or the marker is torn — a torn marker must read as
    "no information", never crash the serving loop)."""
    p = Path(graph_dir) / REPAIR_STATUS_FILENAME
    try:
        data = json.loads(p.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict) or "status" not in data:
        return None
    return data


def stale_sources(status: dict | None) -> "set[int] | str | None":
    """The set of sources a server must flag stale given a status dict:
    ``None`` (nothing stale), ``"all"``, or a set of ints. The AFFECTED
    set — not ``remaining`` — drives staleness: a repaired part's rows
    land in the NEW digest's directory, so in the old directory they
    stay outdated forever."""
    if status is None:
        return None
    affected = status.get("affected", "all")
    if affected == "all":
        return "all"
    return {int(s) for s in affected}
