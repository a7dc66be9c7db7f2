"""Dependency-tracked partition state — the incremental substrate.

The condensed partitioned route (``solver.partitioned``) already proves
the decomposition this subsystem repairs along: every shortest path is
within-part runs joined at boundary vertices, so full APSP factors into
per-part local closures, one boundary-core closure, and per-part
min-plus expansions. :class:`IncrementalState` persists exactly those
factors next to a checkpoint, with a digest HIERARCHY over them::

    graph digest  ->  per-part digests (each part's internal edges)
                  ->  boundary-core digest (boundary set + cross edges)

so a batch of edge updates maps to a minimal dirty set by digest-level
reasoning: an update inside part P invalidates P's digest (P's closure
must be re-run), a cross-part update invalidates the core digest, and
everything else is PROVABLY reusable — a part's local closure depends
only on its internal edges, never on the rest of the graph.

Closures run through the ORDINARY resilient solver
(``ParallelJohnsonSolver.solve`` on the part's relabeled subgraph), not
a private kernel: retries, watchdog deadlines, OOM degradation,
pipelining, fault injection, and telemetry spans all apply to repair
work exactly as they do to any solve, and negative cycles are detected
by the same Bellman-Ford machinery (a cycle inside a part surfaces
closing that part; a cycle across parts surfaces closing the core).

Persisted as ``incremental/state.npz`` inside the checkpoint's
per-graph subdirectory, digest-guarded like ``landmarks.npz``: a state
written for a different graph is invisible, never silently reused.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from pathlib import Path

import numpy as np

from paralleljohnson_tpu_torch.graphs import CSRGraph

STATE_DIRNAME = "incremental"
STATE_FILENAME = "state.npz"


def _digest_arrays(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def closure_config(config=None):
    """The SolverConfig repair closures run under: the caller's knobs
    (retries, deadlines, fault plan, telemetry) with the layers that
    must not recurse or double-write stripped — no nested
    checkpointing, no oracle validation, no partitioned re-dispatch
    (the repair IS the partitioned machinery), no per-closure profile
    records (the repair appends ONE record for the whole operation).
    The source batch is pinned to the closure V-bucket quantum, as in
    the JAX package, so every closure runs its fan-out in [128, Vp]
    batches (see :func:`close_subgraph`)."""
    from paralleljohnson_tpu_torch.config import SolverConfig

    base = config if config is not None else SolverConfig()
    return dataclasses.replace(
        base,
        checkpoint_dir=None,
        validate=False,
        partitioned=False,
        profile_store=None,
        source_batch_size=_CLOSURE_V_BUCKET,
    )


def closure_solver(config=None, *, device="cuda"):
    """One resilient solver on ``device`` for a whole build/repair
    operation: part closures share its backend (and its device layouts'
    caches) instead of building a solver per part."""
    from paralleljohnson_tpu_torch.solver import ParallelJohnsonSolver

    return ParallelJohnsonSolver(closure_config(config), device=device)


# Closure subgraphs pad V up to this multiple with isolated vertices
# (no edges: distance rows inf off their 0 diagonal, affecting nothing).
# The JAX package pads so that parts of similar size share one compiled
# shape bucket; nothing here compiles per shape, but the port keeps the
# padding so that each closure takes the same route, runs the same
# counters and yields the same rows as the JAX package's.
_CLOSURE_V_BUCKET = 128


def close_subgraph(sub: CSRGraph, config=None, *, solver=None,
                   device="cuda"):
    """All-pairs closure of one (small) subgraph through the ordinary
    resilient solver. Returns the dense ``[n, n]`` distance matrix
    ordered by vertex id; raises ``NegativeCycleError`` exactly where a
    blocked-FW closure would read a negative diagonal. The subgraph is
    padded to the shared V bucket (isolated pad vertices — provably
    inert) before solving. Without ``solver`` one is built on
    ``device``."""
    n = sub.num_nodes
    if n == 0:
        return np.zeros((0, 0), sub.dtype)
    vp = _CLOSURE_V_BUCKET * (-(-n // _CLOSURE_V_BUCKET))
    if vp > n:
        indptr = np.concatenate([
            sub.indptr,
            np.full(vp - n, sub.indptr[-1], np.int32),
        ])
        sub = CSRGraph(indptr=indptr, indices=sub.indices,
                       weights=sub.weights)
    if solver is None:
        with closure_solver(config, device=device) as own:
            res = own.solve(sub)
    else:
        res = solver.solve(sub)
    # ``matrix`` is a host copy, whichever device the rows were on.
    return np.asarray(res.matrix, dtype=sub.dtype)[:n, :n]


def close_dense_seed(seed: np.ndarray, config=None, *, solver=None,
                     device="cuda"):
    """Closure of a dense seed matrix (the boundary core): finite
    off-diagonal entries become edges of a graph on the core vertices,
    closed through the same resilient solver path."""
    nc = seed.shape[0]
    if nc == 0:
        return seed.copy()
    r, c = np.nonzero(np.isfinite(seed) & ~np.eye(nc, dtype=bool))
    sub = CSRGraph.from_edges(r, c, seed[r, c], nc, dtype=seed.dtype)
    return close_subgraph(sub, config, solver=solver, device=device)


def _within_selector(labels, src, dst, p):
    return (labels[src] == p) & (labels[dst] == p)


@dataclasses.dataclass
class IncrementalState:
    """The persisted repair substrate for ONE graph (see module
    docstring). ``parts``/``locals_closed``/``part_digests`` are
    aligned with ``part_ids``; ``boundary`` is sorted."""

    graph_digest: str
    seed: int
    labels: np.ndarray            # int64[V]
    part_ids: np.ndarray          # int64[k]
    part_digests: list
    core_digest: str
    boundary: np.ndarray          # int64, sorted
    locals_closed: list
    core_closed: np.ndarray

    # -- derived indices -----------------------------------------------------

    @property
    def num_parts(self) -> int:
        return len(self.part_ids)

    def indices(self):
        """``(parts, lids, blocal, bcore)``: per-part vertex arrays,
        global->local id map, and each part's boundary vertices as
        (local ids, core ids) — recomputed on demand (cheap) instead of
        persisted."""
        cached = self.__dict__.get("_indices")
        if cached is not None:
            return cached
        v = len(self.labels)
        parts = [np.flatnonzero(self.labels == p) for p in self.part_ids]
        lids = np.full(v, -1, np.int64)
        for verts in parts:
            lids[verts] = np.arange(verts.size)
        boundary_mask = np.zeros(v, bool)
        boundary_mask[self.boundary] = True
        core_idx = np.full(v, -1, np.int64)
        core_idx[self.boundary] = np.arange(self.boundary.size)
        blocal = []
        bcore = []
        for verts in parts:
            bv = verts[boundary_mask[verts]]
            blocal.append(lids[bv])
            bcore.append(core_idx[bv])
        self.__dict__["_indices"] = (parts, lids, blocal, bcore)
        return self.__dict__["_indices"]

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        graph: CSRGraph,
        *,
        num_parts: int | None = None,
        seed: int = 0,
        config=None,
        device="cuda",
    ) -> "IncrementalState":
        """Partition + close everything once — the amortized cost of
        attaching the incremental subsystem to an existing checkpoint.
        Partition labels come from the same seeded pivot draw the
        condensed route uses, so quality trade-offs are shared; every
        closure runs through the resilient solver on ``device`` (see
        module docstring)."""
        from paralleljohnson_tpu_torch.solver.partitioned import (
            auto_num_parts,
            partition_by_pivots,
        )
        from paralleljohnson_tpu_torch.utils.checkpoint import graph_digest

        v = graph.num_nodes
        k = int(
            num_parts
            or getattr(config, "partition_parts", None)
            or auto_num_parts(v)
        )
        labels = partition_by_pivots(graph, k, seed=seed)
        part_ids = np.unique(labels)
        e = graph.num_real_edges
        src, dst, w = graph.src[:e], graph.indices[:e], graph.weights[:e]
        cross = labels[src] != labels[dst]
        boundary_mask = np.zeros(v, bool)
        boundary_mask[src[cross]] = True
        boundary_mask[dst[cross]] = True
        boundary = np.flatnonzero(boundary_mask)

        state = cls(
            graph_digest=graph_digest(graph),
            seed=int(seed),
            labels=labels,
            part_ids=part_ids,
            part_digests=[],
            core_digest=compute_core_digest(boundary, src, dst, w, cross),
            boundary=boundary,
            locals_closed=[],
            core_closed=np.zeros((0, 0), graph.dtype),
        )
        parts, lids, blocal, bcore = state.indices()
        with closure_solver(config, device=device) as solver:
            for p, verts in zip(part_ids, parts):
                sel = _within_selector(labels, src, dst, p)
                state.part_digests.append(
                    compute_part_digest(verts, lids, src, dst, w, sel)
                )
                state.locals_closed.append(
                    close_part(graph, verts, lids, sel, config=config,
                               solver=solver)
                )
            state.core_closed = close_core(state, graph, config=config,
                                           solver=solver)
        return state

    # -- persistence ---------------------------------------------------------

    def save(self, graph_dir: str | Path) -> Path:
        """Atomic write of ``incremental/state.npz`` under the
        checkpoint's per-graph subdirectory."""
        d = Path(graph_dir) / STATE_DIRNAME
        d.mkdir(parents=True, exist_ok=True)
        path = d / STATE_FILENAME
        payload = {
            "graph_digest": np.array(self.graph_digest),
            "seed": np.array(self.seed, np.int64),
            "labels": self.labels,
            "part_ids": self.part_ids,
            "part_digests": np.array(self.part_digests),
            "core_digest": np.array(self.core_digest),
            "boundary": self.boundary,
            "core_closed": self.core_closed,
        }
        for i, local in enumerate(self.locals_closed):
            payload[f"local_{i:04d}"] = local
        tmp = path.with_name(path.name + f".tmp{os.getpid()}")
        # Write through a file handle: np.savez would append ".npz" to
        # a bare tmp path and the atomic rename would miss it.
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **payload)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(
        cls, graph_dir: str | Path, *, expect_digest: str
    ) -> "IncrementalState | None":
        """Digest-guarded load: None when absent, unreadable, or written
        for a different graph — a stale state must never be repaired
        from (the same contract as ``LandmarkIndex.load``)."""
        path = Path(graph_dir) / STATE_DIRNAME / STATE_FILENAME
        if not path.exists():
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["graph_digest"]) != expect_digest:
                    return None
                part_ids = np.asarray(z["part_ids"], np.int64)
                return cls(
                    graph_digest=str(z["graph_digest"]),
                    seed=int(z["seed"]),
                    labels=np.asarray(z["labels"], np.int64),
                    part_ids=part_ids,
                    part_digests=[str(s) for s in z["part_digests"]],
                    core_digest=str(z["core_digest"]),
                    boundary=np.asarray(z["boundary"], np.int64),
                    locals_closed=[
                        np.asarray(z[f"local_{i:04d}"])
                        for i in range(len(part_ids))
                    ],
                    core_closed=np.asarray(z["core_closed"]),
                )
        except Exception:  # noqa: BLE001 — torn/corrupt state: rebuild
            return None


# -- the digest hierarchy ----------------------------------------------------


def compute_part_digest(verts, lids, src, dst, w, sel) -> str:
    """Content digest of one part: its vertex set + internal edges in
    LOCAL ids (so the digest is invariant to everything outside the
    part — exactly the dependency set of its closure)."""
    idx = np.flatnonzero(sel)
    return _digest_arrays(
        verts, lids[src[idx]], lids[dst[idx]], w[idx]
    )


def compute_core_digest(boundary, src, dst, w, cross) -> str:
    """Content digest of the boundary core's OWN inputs: the boundary
    vertex set + the cross edges. (Core seeds also take each part's
    boundary-to-boundary closure — that dependency is tracked through
    the part digests, not duplicated here.)"""
    idx = np.flatnonzero(cross)
    return _digest_arrays(boundary, src[idx], dst[idx], w[idx])


# -- closure helpers (shared by build and repair) ----------------------------


def close_part(graph: CSRGraph, verts, lids, sel, *, config=None,
               solver=None, device="cuda"):
    """Closure of one part: relabel its internal edges to local ids and
    solve the subgraph through the resilient solver."""
    idx = np.flatnonzero(sel)
    sub = CSRGraph.from_edges(
        lids[graph.src[idx]], lids[graph.indices[idx]], graph.weights[idx],
        int(verts.size), dtype=graph.dtype,
    )
    from paralleljohnson_tpu_torch.solver.johnson import NegativeCycleError

    try:
        return close_subgraph(sub, config, solver=solver, device=device)
    except NegativeCycleError as e:
        raise NegativeCycleError(
            "negative-weight cycle inside a partition "
            f"(part of {verts.size} vertices): {e}"
        ) from e


def close_core(state: IncrementalState, graph: CSRGraph, *, config=None,
               solver=None, device="cuda"):
    """Seed + close the boundary core from the state's CURRENT local
    closures and the graph's cross edges (the condensed route's exact
    construction: per-part boundary-to-boundary closures min'd with raw
    cross edges, then closed)."""
    from paralleljohnson_tpu_torch.solver.johnson import NegativeCycleError

    parts, lids, blocal, bcore = state.indices()
    nc = state.boundary.size
    core = np.full((nc, nc), np.inf, dtype=graph.dtype)
    if nc == 0:
        return core
    np.fill_diagonal(core, 0.0)
    for closed, bl, bc in zip(state.locals_closed, blocal, bcore):
        if bl.size:
            core[np.ix_(bc, bc)] = np.minimum(
                core[np.ix_(bc, bc)], closed[np.ix_(bl, bl)]
            )
    e = graph.num_real_edges
    src, dst, w = graph.src[:e], graph.indices[:e], graph.weights[:e]
    cross = state.labels[src] != state.labels[dst]
    core_idx = np.full(len(state.labels), -1, np.int64)
    core_idx[state.boundary] = np.arange(nc)
    np.minimum.at(
        core, (core_idx[src[cross]], core_idx[dst[cross]]), w[cross]
    )
    try:
        return close_dense_seed(core, config, solver=solver, device=device)
    except NegativeCycleError as e:
        raise NegativeCycleError(
            f"negative-weight cycle across partitions (core of {nc} "
            f"boundary vertices): {e}"
        ) from e
