"""Tiered distance-tile store: the serving tier's row cache.

The artifact of a solve is distance ROWS: ``dist[source] -> [V]``. The
store keeps them in three tiers, hottest first, and every lookup walks
them in order:

- **hot** — rows exactly as the backend returned them, which for device
  backends means device-resident (HBM) arrays that were never forced to
  host; for host backends the tiers differ only in capacity. Newly
  solved batches land here.
- **warm** — a host-RAM LRU of materialized numpy rows. Hot evictions
  demote here (one ``to_numpy`` per row — the device-to-host copy
  happens at demotion, off the solve path); warm evictions are dropped (the cold
  tier still has them when the store is checkpoint-backed).
- **cold** — checkpoint-backed batch files loaded through
  :meth:`BatchCheckpointer.load` (same corruption checks as resume),
  indexed O(1) by the persisted manifest (source -> batch file). A cold
  hit promotes the WHOLE loaded batch into warm — the ``.npz`` decode
  was the expensive part, and query locality across a batch's sources
  is the common case.

The store is keyed by graph content digest (``checkpoint.graph_digest``)
through the checkpointer's per-graph subdirectory, so it can attach to
any finished or in-progress solve directory: rows of a different or
modified graph are invisible by construction, and a solver writing new
batches into the same directory (the engine's exact-miss path) just
grows the cold tier — call :meth:`invalidate_cold_index` after a
scheduled solve so the manifest is re-read.

**Staleness.** When the incremental repair engine runs
against this store's graph, it publishes ``repair_status.json`` into
the per-graph subdirectory; :meth:`is_stale` reads it (mtime-cached)
and reports whether a source's row reflects pre-update distances. The
query engine flags every such answer ``stale: true`` — rows outside
the affected set are PROVABLY bitwise identical on the updated graph
(the repair engine's dependency argument), so they stay unflagged.
``mark_stale`` exists for in-memory stores and tests.
"""

from __future__ import annotations

import collections
import threading
from pathlib import Path

import numpy as np

from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from paralleljohnson_tpu_torch.utils.checkpoint import (
    MANIFEST_NAME,
    BatchCheckpointer,
    graph_digest,
)

# Tier capacities (rows). Hot is device memory — keep it a small working
# set; warm is host RAM (a [V] f32 row at V=2^20 is 4 MB, so the default
# warm tier tops out around 16 GB at that scale — size down via the CLI
# flags for bigger graphs).
DEFAULT_HOT_ROWS = 128
DEFAULT_WARM_ROWS = 4096


class TileStore:
    """Tiered distance-row cache over an optional checkpoint directory.

    ``directory=None`` runs hot+warm only (pure in-memory serving).
    Thread-safe for the in-process request loop (one lock — lookups are
    dict operations plus, on a cold hit, one npz load).
    """

    def __init__(
        self,
        directory: str | Path | None,
        graph,
        *,
        hot_rows: int = DEFAULT_HOT_ROWS,
        warm_rows: int = DEFAULT_WARM_ROWS,
    ) -> None:
        if hot_rows < 0 or warm_rows < 0:
            raise ValueError("tier capacities must be >= 0")
        self.graph = graph
        self.digest = graph_digest(graph)
        self.root = Path(directory) if directory is not None else None
        if directory is None:
            self.ckpt = None
        elif (Path(directory) / "fleet_manifest.json").exists():
            # A distributed-fleet dir: the cold tier reads
            # through the merged shard manifest — rows solved by any
            # worker of the fleet — via the same checkpointer read
            # protocol; scheduled exact-miss solves still persist into
            # this root and overlay the fleet map on re-index.
            from paralleljohnson_tpu_torch.distributed.manifest import (
                ShardedCheckpointer,
            )

            self.ckpt = ShardedCheckpointer(directory, graph_key=self.digest)
        else:
            self.ckpt = BatchCheckpointer(directory, graph_key=self.digest)
        self.hot_rows = int(hot_rows)
        self.warm_rows = int(warm_rows)
        self._hot: collections.OrderedDict = collections.OrderedDict()
        self._warm: collections.OrderedDict = collections.OrderedDict()
        self._cold_index: dict[int, tuple[int, str]] | None = None
        self._lock = threading.Lock()
        # Mutation counter for the device-tile view: bumped
        # whenever hot-tier MEMBERSHIP or staleness can change, so a
        # cached [B, V] device tile can validate itself with one integer
        # compare instead of re-reading the tier.
        self._version = 0
        self.hits_hot = 0
        self.hits_warm = 0
        self.hits_cold = 0
        self.misses = 0
        self.demotions = 0
        self.evictions = 0
        self.cold_loads = 0
        # Staleness: manual marking (in-memory stores / tests) plus the
        # repair-status marker cache: (mtime_ns, size) -> parsed set.
        self._manual_stale: "set[int] | str | None" = None
        self._stale_cache_key = None
        self._stale_cached: "set[int] | str | None" = None
        # Live-fleet manifest watch: (path, mtime_ns, size)
        # per backing manifest, captured at attach.
        # refresh_cold_if_changed() compares against it with one stat()
        # per manifest — called from the miss path only, so the hot
        # path never touches the disk.
        self._manifest_watch_key = self._manifest_key()

    # -- lookup --------------------------------------------------------------

    def get(self, source: int):
        """``(row, tier)`` for one source's distance row, or
        ``(None, None)`` on a full miss. ``tier`` is ``"hot"`` /
        ``"warm"`` / ``"cold"``; the row is host numpy for warm/cold and
        whatever the backend returned (possibly device-resident) for hot.
        Counts exactly one hit or miss per call."""
        source = int(source)
        with self._lock:
            if source in self._hot:
                self._hot.move_to_end(source)
                self.hits_hot += 1
                return self._hot[source], "hot"
            if source in self._warm:
                self._warm.move_to_end(source)
                self.hits_warm += 1
                return self._warm[source], "warm"
            row = self._cold_lookup(source)
            if row is not None:
                self.hits_cold += 1
                return row, "cold"
            self.misses += 1
            return None, None

    def __contains__(self, source: int) -> bool:
        s = int(source)
        with self._lock:
            return (
                s in self._hot
                or s in self._warm
                or s in self._cold_sources()
            )

    # -- insertion -----------------------------------------------------------

    def put(self, sources: np.ndarray, rows, *, tier: str = "hot") -> None:
        """Insert one solved batch's rows (``rows[i]`` is the distance
        row of ``sources[i]``). ``tier="hot"`` keeps rows as given
        (device-resident for device backends); ``tier="warm"``
        materializes to host numpy. Capacity overflow demotes
        hot -> warm (materializing) and drops from warm (LRU order)."""
        if tier not in ("hot", "warm"):
            raise ValueError(f"tier must be hot/warm, got {tier!r}")
        sources = np.asarray(sources, np.int64)
        with self._lock:
            self._version += 1
            for i, s in enumerate(sources):
                s = int(s)
                row = rows[i]
                if tier == "hot" and self.hot_rows > 0:
                    self._hot.pop(s, None)
                    self._hot[s] = row
                else:
                    self._warm.pop(s, None)
                    self._warm[s] = to_numpy(row)
                self._evict()

    def _evict(self) -> None:
        while len(self._hot) > self.hot_rows:
            s, row = self._hot.popitem(last=False)
            self.demotions += 1
            if self.warm_rows > 0:
                self._warm.pop(s, None)
                self._warm[s] = to_numpy(row)  # the D2H happens here
        while len(self._warm) > self.warm_rows:
            self._warm.popitem(last=False)
            self.evictions += 1

    # -- cold tier -----------------------------------------------------------

    def _cold_sources(self) -> dict[int, tuple[int, str]]:
        if self.ckpt is None:
            return {}
        if self._cold_index is None:
            self._cold_index = self.ckpt.manifest()
        return self._cold_index

    def _cold_lookup(self, source: int):
        entry = self._cold_sources().get(source)
        if entry is None:
            return None
        batch_idx, filename = entry
        batch_sources = self.ckpt.batch_sources(filename)
        if batch_sources is None:
            return None
        self.cold_loads += 1
        loaded = self.ckpt.load(batch_idx, batch_sources)
        if loaded is None:  # corrupt/absent batch: a miss, never garbage
            return None
        rows, _ = loaded
        # Promote the whole decoded batch: the npz decode dominated, and
        # neighbors in a batch are the likeliest next queries.
        for i, s in enumerate(batch_sources):
            s = int(s)
            if s not in self._hot and self.warm_rows > 0:
                self._warm.pop(s, None)
                self._warm[s] = rows[i]
        self._evict()
        pos = int(np.flatnonzero(batch_sources == source)[0])
        return rows[pos]

    def invalidate_cold_index(self) -> None:
        """Re-read the manifest on next cold lookup — call after a solver
        appended new batches to the backing directory."""
        key = self._manifest_key()
        with self._lock:
            self._cold_index = None
            # Our own commit is not "news": fold it into the watch key
            # so the next refresh_cold_if_changed() only fires on a
            # manifest some OTHER process has grown since.
            self._manifest_watch_key = key

    def _manifest_key(self):
        """(path, mtime_ns, size) per backing manifest — the fleet
        manifest AND the growth dir's batch manifest for sharded dirs,
        just the batch manifest for plain checkpoint dirs."""
        if self.ckpt is None:
            return None
        paths = {Path(self.ckpt.dir) / MANIFEST_NAME}
        fleet_manifest = getattr(self.ckpt, "manifest_path", None)
        if fleet_manifest is not None:
            paths.add(Path(fleet_manifest))
        key = []
        for p in sorted(paths):
            try:
                st = p.stat()
                key.append((str(p), st.st_mtime_ns, st.st_size))
            except OSError:
                key.append((str(p), None, None))
        return tuple(key)

    def refresh_cold_if_changed(self) -> bool:
        """Live-fleet awareness: re-scan the backing
        directory's manifests and drop the cold index iff some OTHER
        process committed batches since attach (or since our own last
        invalidate). One ``stat`` per manifest file — call from the
        miss path, where a changed manifest can turn a scheduled solve
        into a cold hit. Returns whether the cold tier GAINED sources —
        a stat change alone is not news (the first cold lookup lazily
        creates an empty manifest, and our own commits fold into the
        watch key via :meth:`invalidate_cold_index`)."""
        if self.ckpt is None:
            return False
        key = self._manifest_key()
        with self._lock:
            if key == self._manifest_watch_key:
                return False
            self._manifest_watch_key = key
            old = set(self._cold_sources())
            self._cold_index = None
            new = set(self._cold_sources())
            return bool(new - old)

    # -- device-tile view (the device-resident query path) ---------

    def hot_token(self):
        """Opaque freshness token for :meth:`hot_view` snapshots: changes
        whenever hot membership OR staleness may have changed (covers
        both manual marks and the on-disk repair marker's mtime key).
        Compare tokens with ``==`` only."""
        with self._lock:
            self._repair_stale()  # refresh the marker's mtime cache key
            return (self._version, self._stale_cache_key)

    def hot_view(self):
        """``(token, [(source, row), ...])`` — a snapshot of the hot
        tier EXCLUDING stale sources, in LRU order (coldest first), with
        rows exactly as the backend returned them (device-resident for
        device backends). The token is :meth:`hot_token` at snapshot
        time: a device tile stacked from this view is valid while the
        store keeps returning the same token. Stale rows are excluded by
        construction — a megabatched kernel must never gather a row the
        host path would have flagged (the host path still serves them,
        with ``stale: true``)."""
        with self._lock:
            stale = self.stale_info()
            token = (self._version, self._stale_cache_key)
            if stale == "all":
                return token, []
            if stale is None:
                items = list(self._hot.items())
            else:
                items = [(s, r) for s, r in self._hot.items()
                         if s not in stale]
            return token, items

    def note_hot_hits(self, sources) -> int:
        """Account device-path lookups that bypassed :meth:`get`: counts
        one hot hit and refreshes LRU position per source still in the
        hot tier (so hit counters and eviction order are identical
        whichever lookup path served the batch). Returns how many
        sources were actually hot."""
        n = 0
        with self._lock:
            for s in sources:
                s = int(s)
                if s in self._hot:
                    self._hot.move_to_end(s)
                    self.hits_hot += 1
                    n += 1
        return n

    # -- staleness (stale-but-servable during repair) --------------

    def mark_stale(self, sources) -> None:
        """Manually flag sources (or ``"all"``) stale — the in-memory
        twin of the repair-status marker; union'd with it."""
        if isinstance(sources, str):
            if sources != "all":
                raise ValueError(f"mark_stale takes source ids or 'all', "
                                 f"got {sources!r}")
            self._manual_stale = "all"
        elif self._manual_stale != "all":
            fresh = {int(s) for s in sources}
            self._manual_stale = (
                fresh if self._manual_stale is None
                else self._manual_stale | fresh
            )
        with self._lock:
            self._version += 1

    def clear_stale(self) -> None:
        """Drop the MANUAL stale marks (the repair-status marker, if
        present on disk, still applies — it records durable fact)."""
        self._manual_stale = None
        with self._lock:
            self._version += 1

    def _repair_stale(self) -> "set[int] | str | None":
        """The repair-status marker's affected set, mtime-cached so the
        hot path pays one ``stat`` per lookup batch, not a JSON parse."""
        if self.ckpt is None:
            return None
        from paralleljohnson_tpu_torch.incremental.status import (
            REPAIR_STATUS_FILENAME,
            read_repair_status,
            stale_sources,
        )

        marker = Path(self.ckpt.dir) / REPAIR_STATUS_FILENAME
        try:
            st = marker.stat()
            key = (st.st_mtime_ns, st.st_size)
        except OSError:
            self._stale_cache_key = None
            self._stale_cached = None
            return None
        if key != self._stale_cache_key:
            self._stale_cached = stale_sources(
                read_repair_status(self.ckpt.dir)
            )
            self._stale_cache_key = key
        return self._stale_cached

    def stale_info(self) -> "set[int] | str | None":
        """``None`` (nothing stale), ``"all"``, or the set of stale
        sources — manual marks union'd with the repair marker."""
        repair = self._repair_stale()
        manual = self._manual_stale
        if repair == "all" or manual == "all":
            return "all"
        if repair is None and manual is None:
            return None
        return (repair or set()) | (manual or set())

    def is_stale(self, source: int) -> bool:
        """Whether this source's row reflects pre-update distances (a
        repair ran or is running and this source is in its affected
        set). Sources outside the affected set are provably current."""
        info = self.stale_info()
        if info is None:
            return False
        return True if info == "all" else int(source) in info

    # -- introspection -------------------------------------------------------

    @property
    def hits(self) -> int:
        return self.hits_hot + self.hits_warm + self.hits_cold

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        with self._lock:
            return {
                "digest": self.digest,
                "hot_rows": len(self._hot),
                "warm_rows": len(self._warm),
                "cold_rows": len(self._cold_sources()),
                "hot_capacity": self.hot_rows,
                "warm_capacity": self.warm_rows,
                "hits_hot": self.hits_hot,
                "hits_warm": self.hits_warm,
                "hits_cold": self.hits_cold,
                "misses": self.misses,
                "hit_rate": round(self.hit_rate(), 6),
                "demotions": self.demotions,
                "evictions": self.evictions,
                "cold_loads": self.cold_loads,
            }

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"TileStore(digest={self.digest}, hot={len(self._hot)}/"
            f"{self.hot_rows}, warm={len(self._warm)}/{self.warm_rows}, "
            f"cold={'on' if self.ckpt else 'off'})"
        )
