"""Checkpoint / resume for the N-source fan-out.

The unit of recovery is the source batch: each completed batch of distance
rows is written as an ``.npz`` keyed by batch index plus a hash of the
sources it covers; resuming skips batches whose file exists and matches.
Survives preemption mid-APSP.

The on-disk format is the JAX package's, byte for byte in everything a
reader checks: the ``graph_<digest>`` directory (``graphs.csr.graph_digest``,
the same hash), the ``rows_<batch:06d>_<sources digest>.npz`` names, the
``sources`` / ``rows`` / ``rows_sha`` (and ``pred`` / ``pred_sha``) keys and
``manifest.json``. A directory written by either package resumes in the
other, and the JAX package's ``serve.store.TileStore`` reads the port's.

:class:`AsyncCheckpointWriter` (the pipelined fan-out) moves the
serialization + checksumming + fsync of each commit onto a bounded
background writer thread so the solve's critical path only pays an
enqueue; the ``flush()`` barrier preserves resume semantics (the solve
does not return success until every commit landed), and a writer failure
surfaces as ``SolveCorruptionError`` on the next ``submit``/``flush`` —
never silent loss. Atomicity is unchanged: a write that dies mid-file
leaves only a ``.tmp.npz`` that ``load``/``completed_batches`` ignore.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
from pathlib import Path

import numpy as np

from paralleljohnson_tpu_torch.graphs.csr import graph_digest
from paralleljohnson_tpu_torch.utils.resilience import SolveCorruptionError

MANIFEST_NAME = "manifest.json"


class ManifestOverlapError(ValueError):
    """Two shard manifests claim the same source vertex — merging them
    would make the global source -> batch-file map ambiguous. Raised
    loudly (naming both claiming files) rather than resolved silently:
    overlapping shards mean the fleet's lease table was violated."""


def read_manifest_file(directory: str | Path) -> dict | None:
    """The persisted per-shard ``manifest.json`` of one checkpoint
    (graph-level) directory, or None when absent/torn/not-a-manifest —
    the same tolerance as the checkpointer's own reader (callers fall
    back to a scan or fail loud, their choice)."""
    p = Path(directory) / MANIFEST_NAME
    if not p.exists():
        return None
    try:
        data = json.loads(p.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None
    if not isinstance(data, dict) or "files" not in data:
        return None
    return data


def union_manifests(
    directories: "list[str | Path]",
) -> dict[int, tuple[int, str]]:
    """Merge per-shard ``manifest.json`` files into ONE global map
    ``source -> (batch_idx, "<dir>/<filename>")`` — the multi-shard
    twin of :meth:`BatchCheckpointer.manifest`.

    Unlike the single-dir manifest (where a re-listed source is the
    same rows by construction), a source claimed by TWO DIFFERENT
    shards is rejected loudly with a :class:`ManifestOverlapError`
    naming both claiming batch files: shards are supposed to cover
    disjoint lease ranges, so an overlap is corruption (or a violated
    lease table), never something to resolve by pick-the-newest. A
    directory with no readable manifest raises ``ValueError`` with the
    path — a silent skip would turn a torn shard into serving misses.
    """
    out: dict[int, tuple[int, str]] = {}
    claimed_dir: dict[int, tuple[str, str]] = {}  # source -> (dir, file)
    for directory in directories:
        directory = Path(directory)
        data = read_manifest_file(directory)
        if data is None:
            raise ValueError(
                f"{directory / MANIFEST_NAME}: missing or unreadable shard "
                "manifest (is this a checkpoint graph directory?)"
            )
        dir_key = directory.as_posix()
        for filename in sorted(data["files"]):
            entry = data["files"][filename]
            ref = (directory / filename).as_posix()
            for s in entry["sources"]:
                s = int(s)
                prev = claimed_dir.get(s)
                if prev is not None and prev[0] != dir_key:
                    raise ManifestOverlapError(
                        f"source {s} claimed by both {prev[1]} and "
                        f"{ref} — shard manifests must cover disjoint "
                        "source ranges"
                    )
                # Within ONE shard a re-listed source is the same rows
                # by construction (checkpoints are keyed by graph
                # content) — newest listing wins, like manifest().
                claimed_dir[s] = (dir_key, ref)
                out[s] = (int(entry["batch"]), ref)
    return out


def _sources_digest(sources: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(sources, np.int64)).tobytes()
    ).hexdigest()[:16]


class BatchCheckpointer:
    def __init__(self, directory: str | Path, *, graph_key=None) -> None:
        """``graph_key``: the CSRGraph (or a precomputed digest string) the
        rows belong to; rows are stored under a per-graph subdirectory."""
        self.dir = Path(directory)
        if graph_key is not None:
            digest = graph_key if isinstance(graph_key, str) else graph_digest(graph_key)
            self.dir = self.dir / f"graph_{digest}"
        self.dir.mkdir(parents=True, exist_ok=True)
        self._manifest_lock = threading.Lock()

    def _path(self, batch_idx: int, sources: np.ndarray) -> Path:
        return self.dir / f"rows_{batch_idx:06d}_{_sources_digest(sources)}.npz"

    @staticmethod
    def _sha(arr: np.ndarray) -> np.ndarray:
        return np.frombuffer(
            hashlib.sha256(np.ascontiguousarray(arr).tobytes()).digest(),
            np.uint8,
        )

    def save(
        self,
        batch_idx: int,
        sources: np.ndarray,
        rows: np.ndarray,
        *,
        pred: np.ndarray | None = None,
    ) -> Path:
        path = self._path(batch_idx, sources)
        tmp = path.with_suffix(".tmp.npz")
        payload = dict(
            sources=np.asarray(sources, np.int64),
            rows=rows,
            rows_sha=self._sha(rows),
        )
        if pred is not None:
            payload.update(pred=pred, pred_sha=self._sha(pred))
        np.savez_compressed(tmp, **payload)
        tmp.rename(path)  # atomic publish: partial writes never count as done
        # Manifest AFTER the row file is published: a crash between the
        # two leaves a valid-but-unlisted batch, which resume recomputes
        # and re-lists — never a listed-but-missing one.
        self._manifest_add(path.name, batch_idx, sources)
        return path

    # -- manifest (O(1) cold-tile lookup for the serving layer) --------------

    def _manifest_path(self) -> Path:
        return self.dir / MANIFEST_NAME

    def _read_manifest_file(self) -> dict | None:
        p = self._manifest_path()
        if not p.exists():
            return None
        try:
            data = json.loads(p.read_text(encoding="utf-8"))
        except (OSError, ValueError):
            return None  # torn/corrupt manifest -> callers fall back to scan
        if not isinstance(data, dict) or "files" not in data:
            return None
        return data

    def _write_manifest_file(self, data: dict) -> None:
        p = self._manifest_path()
        tmp = p.with_name(p.name + f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(data), encoding="utf-8")
        os.replace(tmp, p)  # atomic: a reader never sees a torn manifest

    def _manifest_add(self, filename: str, batch_idx: int,
                      sources: np.ndarray) -> None:
        with self._manifest_lock:
            data = self._read_manifest_file() or {"version": 1, "files": {}}
            data["files"][filename] = {
                "batch": int(batch_idx),
                "sources": np.asarray(sources, np.int64).tolist(),
            }
            self._write_manifest_file(data)

    def _scan_files(self) -> list[Path]:
        # a crashed save leaves rows_*.tmp.npz — never published, not done
        return sorted(
            p for p in self.dir.glob("rows_*.npz")
            if not p.name.endswith(".tmp.npz")
        )

    def _rebuild_manifest(self) -> dict:
        """Pre-manifest directory: rescan every published batch file once,
        then persist the result so the next open is O(1) again."""
        data: dict = {"version": 1, "files": {}}
        for p in self._scan_files():
            try:
                with np.load(p) as npz:
                    sources = np.asarray(npz["sources"], np.int64)
            except Exception:  # noqa: BLE001 — corrupt batch: not listable
                continue
            data["files"][p.name] = {
                "batch": int(p.name.split("_")[1]),
                "sources": sources.tolist(),
            }
        try:
            self._write_manifest_file(data)
        except OSError:
            pass  # read-only store dir: serve from the in-memory rebuild
        return data

    def manifest(self) -> dict[int, tuple[int, str]]:
        """Source vertex -> ``(batch_idx, batch_filename)`` for every batch
        this directory holds — the O(1) cold-tile index the serving layer
        keys row lookups off (``serve.store.TileStore``). Served from the
        persisted ``manifest.json`` (written once per :meth:`save`);
        pre-manifest directories are rescanned once and the rebuilt
        manifest persisted. A source solved by several batches maps to
        the newest listing (identical rows either way: checkpoints are
        keyed by graph content)."""
        with self._manifest_lock:
            data = self._read_manifest_file()
            if data is None:
                data = self._rebuild_manifest()
        out: dict[int, tuple[int, str]] = {}
        for filename in sorted(data["files"]):
            entry = data["files"][filename]
            for s in entry["sources"]:
                out[int(s)] = (int(entry["batch"]), filename)
        return out

    def batch_sources(self, filename: str) -> np.ndarray | None:
        """The exact sources array a manifest-listed batch file covers
        (what :meth:`load` needs to re-derive the file's digest path)."""
        with self._manifest_lock:
            data = self._read_manifest_file()
        if data is None or filename not in data["files"]:
            return None
        return np.asarray(data["files"][filename]["sources"], np.int64)

    def load(
        self, batch_idx: int, sources: np.ndarray, *, with_pred: bool = False
    ) -> tuple[np.ndarray, np.ndarray | None] | None:
        """(rows, pred-or-None) for this batch, or None if absent or
        CORRUPT (recompute — fault detection: a
        bit-flipped or truncated batch result must be caught, not
        propagated into the APSP matrix). The unkeyed sha-256 detects
        accidental corruption only — anyone who can modify rows can
        recompute the digest, so deliberate tampering is out of scope.
        ``with_pred=True`` additionally requires a valid predecessor
        array — a rows-only checkpoint is treated as missing."""
        path = self._path(batch_idx, sources)
        if not path.exists():
            return None
        try:
            with np.load(path) as data:
                if not np.array_equal(data["sources"], np.asarray(sources, np.int64)):
                    return None
                rows = data["rows"]
                if "rows_sha" in data.files and not np.array_equal(
                    self._sha(rows), data["rows_sha"]
                ):
                    return None
                if not with_pred:
                    return rows, None
                if "pred" not in data.files:
                    return None
                pred = data["pred"]
                if not np.array_equal(self._sha(pred), data["pred_sha"]):
                    return None
                return rows, pred
        except Exception:
            pass
        return None

    def completed_batches(self) -> list[int]:
        """Batch indices with a published row file, via the persisted
        manifest (O(#batches), no directory re-hash per call); falls back
        to the glob scan for pre-manifest directories. Entries whose file
        has since been deleted are dropped — the manifest lists, the
        filesystem decides."""
        with self._manifest_lock:
            data = self._read_manifest_file()
        if data is None:
            return sorted(int(p.name.split("_")[1]) for p in self._scan_files())
        return sorted(
            int(e["batch"]) for f, e in data["files"].items()
            if (self.dir / f).exists()
        )


def checked_save(
    ckpt: BatchCheckpointer,
    batch_idx: int,
    sources: np.ndarray,
    rows: np.ndarray,
    *,
    pred: np.ndarray | None = None,
    fault_hook=None,
) -> None:
    """One checkpoint commit with the ``"ckpt_write"`` fault-injection
    point in front of it; ANY failure (injected or real — disk full,
    permission, serialization) surfaces as :class:`SolveCorruptionError`
    so a lost commit is always diagnosable, never silent. Shared by the
    serial (pipeline_depth=1) inline path and the background writer so
    both depths exercise identical failure semantics."""
    try:
        if fault_hook is not None:
            fault_hook(batch_idx)
        ckpt.save(batch_idx, sources, rows, pred=pred)
    except BaseException as e:  # noqa: BLE001 — re-raised, classified
        raise SolveCorruptionError(
            f"checkpoint write failed for batch {batch_idx}: "
            f"{type(e).__name__}: {e} (the batch is NOT committed; "
            "resume will recompute it)"
        ) from e


class AsyncCheckpointWriter:
    """Bounded background checkpoint writer (the pipelined fan-out).

    ``submit`` enqueues one batch commit and returns immediately (it
    blocks only when ``max_pending`` commits are already queued — the
    backpressure that bounds host-memory carry); a single daemon worker
    drains the queue FIFO through :func:`checked_save`. ``flush`` is the
    barrier callers run before declaring the solve complete: it waits
    for the queue to drain and re-raises the first worker failure. A
    failure also re-raises on the next ``submit`` so a dead writer can
    never silently swallow later batches. ``close`` stops the worker
    after draining what is already queued (good rows still commit even
    when the solve is dying of an unrelated error — completed work stays
    resumable) and never raises.

    ``fault_hook(batch_idx)``: optional ``"ckpt_write"`` fault-injection
    point, fired on the WRITER thread so an injected death happens
    mid-commit exactly like a real one. ``busy_s`` accumulates worker
    busy time for the solver's overlap accounting.
    """

    def __init__(
        self,
        ckpt: BatchCheckpointer,
        *,
        max_pending: int = 2,
        fault_hook=None,
    ) -> None:
        self.ckpt = ckpt
        self.fault_hook = fault_hook
        self.busy_s = 0.0
        self.saved = 0
        self._exc: BaseException | None = None
        self._closed = False
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(max_pending)))
        self._worker = threading.Thread(
            target=self._loop, name="pj-ckpt-writer", daemon=True
        )
        self._worker.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                batch_idx, sources, rows, pred = item
                t0 = time.perf_counter()
                try:
                    checked_save(
                        self.ckpt, batch_idx, sources, rows, pred=pred,
                        fault_hook=self.fault_hook,
                    )
                    self.saved += 1
                except BaseException as e:  # noqa: BLE001 — relayed
                    if self._exc is None:
                        self._exc = e
                finally:
                    self.busy_s += time.perf_counter() - t0
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        e = self._exc
        if isinstance(e, SolveCorruptionError):
            raise e
        raise SolveCorruptionError(
            f"background checkpoint writer failed: {type(e).__name__}: {e}"
        ) from e

    def submit(
        self,
        batch_idx: int,
        sources: np.ndarray,
        rows: np.ndarray,
        *,
        pred: np.ndarray | None = None,
    ) -> None:
        """Enqueue one commit (blocks on backpressure; raises the stored
        writer failure instead of queueing onto a dead writer)."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        while True:
            if self._exc is not None:
                self._raise_pending()
            try:
                self._q.put(
                    (batch_idx, sources, rows, pred), timeout=0.05
                )
                return
            except queue.Full:
                continue

    def flush(self) -> None:
        """Barrier: every submitted commit is on disk (or the first
        failure re-raises). Run before a checkpointed solve returns.
        After ``close`` this is a no-op — the close already drained the
        queue, and a failure it held was either surfaced on an earlier
        submit/flush or deliberately swallowed by the teardown path;
        re-raising it from a later flush would mask the original error
        (or raise out of a ``finally``)."""
        if self._closed:
            return
        self._q.join()
        if self._exc is not None:
            self._raise_pending()

    def close(self) -> None:
        """Drain what is queued, stop the worker, never raise (teardown
        path: an unrelated solve error must not be masked, and completed
        rows should still commit so resume can use them). Idempotent:
        double-close and close-after-dead-worker are no-ops."""
        if self._closed:
            return
        self._closed = True
        while True:
            try:
                self._q.put(None, timeout=0.1)
                break
            except queue.Full:
                if not self._worker.is_alive():
                    return
        self._worker.join(timeout=60.0)
