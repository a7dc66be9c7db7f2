"""Shard-manifest union — one global source -> batch-file map per fleet.

Each worker checkpoints through the ordinary ``BatchCheckpointer`` into
its own shard dir, so after a fleet run the rows of one graph are spread
over ``<coord>/shards/<worker>/graph_<digest>/`` directories, each with
its own per-shard ``manifest.json``. This module unions them into a
single ``fleet_manifest.json`` at the coordinator root, and adapts it
back to the ``BatchCheckpointer`` read protocol so downstream consumers
(``serve.store.TileStore``, ``fleet_rows``) work unchanged.

The union is **lease-aware**: only batches belonging to a COMMITTED
lease, read from the shard of the worker that committed it, are
referenced. A worker that died (or went stale) mid-lease may have left
perfectly valid batches behind — those are *orphaned*, counted but
never served, because the re-queued range was re-solved and committed
by another worker and serving both would double-claim sources. Within
the referenced set, any source claimed twice is a loud
:class:`~paralleljohnson_tpu_torch.utils.checkpoint.ManifestOverlapError`
(it would mean the lease table itself overlapped — corruption, not a
race), and a committed lease whose shard does not fully cover its range
fails loudly too: a committed-but-unreadable range must never
silently become a serving miss.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from paralleljohnson_tpu_torch.utils.checkpoint import (
    MANIFEST_NAME,
    BatchCheckpointer,
    ManifestOverlapError,
    read_manifest_file,
)

FLEET_MANIFEST = "fleet_manifest.json"


def build_fleet_manifest(coordinator, *, write: bool = True) -> dict:
    """Union the committed leases' shard manifests into the global map.

    Returns (and, with ``write=True``, atomically persists to
    ``<coord>/fleet_manifest.json``) a dict::

        {"version": 1, "graph_digest": ..., "num_sources": ...,
         "files": {"shards/w0/graph_<d>/rows_...npz":
                      {"batch": 3, "sources": [...], "worker": "w0",
                       "lease": 7}, ...},
         "leases_committed": N, "orphaned_files": [...]}

    Raises :class:`ManifestOverlapError` on a double-claimed source and
    ``ValueError`` when a committed lease's range is not fully covered
    by its committing shard.
    """
    digest = coordinator.spec["graph_digest"]
    leases = coordinator.leases()
    files: dict[str, dict] = {}
    claimed: dict[int, str] = {}  # source -> relpath that claimed it
    referenced: set[Path] = set()
    for lease in leases:
        if lease.state != "committed":
            continue
        worker = lease.committed_by
        shard_graph_dir = coordinator.shard_dir(worker) / f"graph_{digest}"
        manifest = read_manifest_file(shard_graph_dir)
        if manifest is None:
            raise ValueError(
                f"{shard_graph_dir / MANIFEST_NAME}: lease "
                f"{lease.lease_id} [{lease.start}, {lease.stop}) is "
                f"committed by {worker!r} but its shard has no readable "
                "manifest"
            )
        covered: set[int] = set()
        for filename in sorted(manifest["files"]):
            entry = manifest["files"][filename]
            srcs = [int(s) for s in entry["sources"]]
            inside = [s for s in srcs if lease.start <= s < lease.stop]
            if not inside:
                continue  # another lease's batch in the same shard
            if len(inside) != len(srcs):
                raise ValueError(
                    f"{shard_graph_dir / filename}: batch straddles lease "
                    f"{lease.lease_id} [{lease.start}, {lease.stop}) — "
                    f"sources {srcs[:8]}... are not all inside the range"
                )
            relpath = (
                shard_graph_dir.relative_to(coordinator.dir) / filename
            ).as_posix()
            for s in srcs:
                if s in claimed:
                    raise ManifestOverlapError(
                        f"source {s} claimed by both {claimed[s]} and "
                        f"{relpath} (under {coordinator.dir}) — committed "
                        "leases must cover disjoint ranges"
                    )
                claimed[s] = relpath
            covered.update(srcs)
            referenced.add(shard_graph_dir / filename)
            files[relpath] = {
                "batch": int(entry["batch"]),
                "sources": srcs,
                "worker": worker,
                "lease": lease.lease_id,
            }
        missing = set(range(lease.start, lease.stop)) - covered
        if missing:
            raise ValueError(
                f"{shard_graph_dir / MANIFEST_NAME}: committed lease "
                f"{lease.lease_id} [{lease.start}, {lease.stop}) is "
                f"missing {len(missing)} source row(s) (e.g. "
                f"{sorted(missing)[:8]}) — the shard's manifest does not "
                "cover the range it committed"
            )
    orphaned = []
    shards_root = coordinator.dir / "shards"
    if shards_root.is_dir():
        for p in sorted(shards_root.glob(f"*/graph_{digest}/rows_*.npz")):
            if p not in referenced and not p.name.endswith(".tmp.npz"):
                orphaned.append(p.relative_to(coordinator.dir).as_posix())
    out = {
        "version": 1,
        "graph_digest": digest,
        "num_sources": coordinator.spec["num_sources"],
        "files": files,
        "leases_committed": sum(
            1 for l in leases if l.state == "committed"
        ),
        "leases_total": len(leases),
        "orphaned_files": orphaned,
    }
    if write:
        path = coordinator.dir / FLEET_MANIFEST
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(out), encoding="utf-8")
        os.replace(tmp, path)
    return out


class ShardedCheckpointer:
    """``BatchCheckpointer`` read protocol over a fleet manifest.

    Presents the union of all shards as if it were one checkpoint
    directory: ``manifest()`` / ``batch_sources()`` / ``load()`` are
    what ``serve.store.TileStore`` calls, so a tile store attaches to a
    fleet dir exactly like to a single solve's ``--checkpoint-dir``
    (``TileStore`` detects ``fleet_manifest.json`` itself). Loads
    delegate to a per-shard ``BatchCheckpointer`` so the corruption
    checks (sources match, sha-256) are exactly the single-host ones.

    A local **growth tier** rides on top: scheduled exact-miss solves
    (the serving engine's ``checkpoint_dir = store root``) write
    ordinary batches into ``<root>/graph_<digest>/``; those entries
    overlay the fleet map on every ``manifest()`` re-read, so a fleet
    store keeps growing exactly like a single-shard one.

    ``graph_key``: the expected graph (digest string or CSRGraph). A
    manifest recorded for a DIFFERENT graph yields an empty map — rows
    of another graph are invisible, never served (the same semantics as
    the checkpointer's per-graph subdirectories).
    """

    def __init__(self, root: str | Path, *, graph_key=None) -> None:
        from paralleljohnson_tpu_torch.utils.checkpoint import graph_digest

        self.root = Path(root)
        self.manifest_path = self.root / FLEET_MANIFEST
        digest = None
        if graph_key is not None:
            digest = (
                graph_key if isinstance(graph_key, str)
                else graph_digest(graph_key)
            )
        fleet = self._read_fleet()
        self.digest = digest or (fleet or {}).get("graph_digest")
        # The growth tier: ordinary checkpointer at the fleet root —
        # scheduled solves from the serving layer land here.
        self._growth = (
            BatchCheckpointer(self.root, graph_key=self.digest)
            if self.digest else None
        )
        # .dir is what consumers use as "where this store persists
        # things" (landmark indexes, serve stats) — the growth dir.
        self.dir = self._growth.dir if self._growth else self.root

    def _read_fleet(self) -> dict | None:
        try:
            data = json.loads(self.manifest_path.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            return None
        if not isinstance(data, dict) or "files" not in data:
            return None
        return data

    def _entries(self) -> dict[str, dict]:
        """relpath -> entry, fleet map first, growth overlay last (a
        source re-solved locally wins — identical rows either way,
        checkpoints are keyed by graph content)."""
        out: dict[str, dict] = {}
        fleet = self._read_fleet()
        if fleet is not None and fleet.get("graph_digest") == self.digest:
            out.update(fleet["files"])
        if self._growth is not None:
            growth_rel = self._growth.dir.relative_to(self.root).as_posix()
            data = read_manifest_file(self._growth.dir)
            if data is not None:
                for filename in sorted(data["files"]):
                    e = data["files"][filename]
                    out[f"{growth_rel}/{filename}"] = {
                        "batch": int(e["batch"]),
                        "sources": [int(s) for s in e["sources"]],
                    }
        return out

    # -- the BatchCheckpointer read protocol ---------------------------------

    def manifest(self) -> dict[int, tuple[int, str]]:
        # A manifest() call re-reads (TileStore re-indexes the cold tier
        # through it after invalidate_cold_index); batch_sources/load
        # then serve from the same snapshot so one lookup sequence sees
        # one consistent view.
        self._entries_snapshot = self._entries()
        out: dict[int, tuple[int, str]] = {}
        for relpath in sorted(self._entries_snapshot):
            entry = self._entries_snapshot[relpath]
            for s in entry["sources"]:
                out[int(s)] = (int(entry["batch"]), relpath)
        return out

    def batch_sources(self, relpath: str) -> np.ndarray | None:
        entry = self._entries_cache.get(relpath)
        if entry is None:
            return None
        return np.asarray(entry["sources"], np.int64)

    def load(
        self, batch_idx: int, sources: np.ndarray, *, with_pred: bool = False
    ) -> tuple[np.ndarray, np.ndarray | None] | None:
        """Find the shard file for (batch_idx, sources) and load it
        through a per-shard ``BatchCheckpointer`` (same corruption
        checks as resume). None when absent or corrupt."""
        sources = np.asarray(sources, np.int64)
        for relpath, entry in self._entries_cache.items():
            if int(entry["batch"]) != int(batch_idx):
                continue
            if not np.array_equal(
                np.asarray(entry["sources"], np.int64), sources
            ):
                continue
            shard_dir = (self.root / relpath).parent
            ckpt = BatchCheckpointer(shard_dir)
            return ckpt.load(batch_idx, sources, with_pred=with_pred)
        return None

    @property
    def _entries_cache(self) -> dict[str, dict]:
        cache = getattr(self, "_entries_snapshot", None)
        if cache is None:
            cache = self._entries()
            self._entries_snapshot = cache
        return cache


def fleet_rows(
    coordinator_dir: str | Path, *, with_pred: bool = False
) -> dict[int, np.ndarray]:
    """Source vertex -> distance row for every source the fleet
    manifest references (each batch file decoded once, corruption-
    checked). The bitwise-equivalence checks in the bench/dryrun/tests
    read fleet results through exactly this path."""
    root = Path(coordinator_dir)
    sc = ShardedCheckpointer(root)
    rows: dict[int, np.ndarray] = {}
    for relpath, entry in sc._entries_cache.items():
        sources = np.asarray(entry["sources"], np.int64)
        loaded = sc.load(int(entry["batch"]), sources, with_pred=with_pred)
        if loaded is None:
            raise ValueError(
                f"{root / relpath}: manifest-listed batch is missing or "
                "corrupt"
            )
        batch_rows = loaded[0]
        for i, s in enumerate(sources):
            rows[int(s)] = batch_rows[i]
    return rows
