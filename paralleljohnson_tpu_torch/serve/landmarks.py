"""Landmark (pivot-source) distance approximation with error bounds.

The fast path for queries on sources nobody solved yet (PAPERS.md
"Faster Parallel Algorithm for Approximate Shortest Path", arXiv:
1911.01626 — the hopset idea of answering through a small set of
well-connected intermediate vertices). At store build, k pivot sources
are solved EXACTLY, twice: forward rows ``fwd[L] = d(L, ·)`` on the
graph and reverse rows ``rev[L] = d(·, L)`` on the edge-reversed graph
(``CSRGraph.reverse``). A query (s, t) then gets directed
triangle-inequality bounds:

  upper = min_L  d(s, L) + d(L, t)             (a real path through L)
  lower = max_L  max(d(L, t) - d(L, s),  d(s, L) - d(t, L))
          (each from one application of d(x, z) <= d(x, y) + d(y, z);
           vacuous terms — subtrahend +inf — are skipped)

so ``lower <= d(s, t) <= upper`` always holds, with IEEE inf arithmetic
carrying unreachability: a finite ``d(L, s)`` with infinite ``d(L, t)``
PROVES ``d(s, t) = +inf`` (lower = +inf). The estimate returned is the
upper bound and ``max_error = upper - lower`` — an approximation is
never unflagged: callers get the bound, not a guess.

Non-negative graphs additionally clamp ``lower >= 0`` (and the engine
answers s == t as exactly 0 — the empty path; negative-cycle-free
graphs cannot beat it).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from paralleljohnson_tpu_torch.utils.checkpoint import graph_digest

LANDMARKS_FILENAME = "landmarks.npz"

# Pivot pickers for :meth:`LandmarkIndex.build` ("boundary" is the
# partitioned route's ready-made high-coverage set).
PIVOT_PICKERS = ("uniform", "coverage", "boundary")


def widen_bounds(lower, upper, *, nonnegative: bool):
    """The f32-slack widening + non-negative clamp, split out of
    :meth:`LandmarkIndex.bounds_row` so the device-resident query path
    (``serve/device_query.py``) can compute the RAW min/max/add/sub
    bounds on-device and finish them through this exact host code —
    bitwise identity between the lookup paths is then a consequence of
    running the same instructions, not a numerical accident.

    The triangle inequality is exact for TRUE distances, but the
    solver's rows are f32 path sums — two independently rounded sums can
    violate it by a few ULP. Widen both bounds by a small relative
    tolerance (the ops/pred.py tight-edge idiom) so ``lower <= exact <=
    upper`` is a contract, not a coin flip; the widening is ~1e-5
    relative — invisible next to any real approximation gap. The clamp
    at 0 (non-negative graphs) and +inf values stay exact: no slack
    applies to them."""
    tol = 32 * float(np.finfo(np.float32).eps)
    with np.errstate(invalid="ignore"):  # inf-inf in discarded branches
        finite_lo = np.isfinite(lower)
        lower = np.where(
            finite_lo, lower - tol * (1.0 + np.abs(lower)), lower
        )
        finite_up = np.isfinite(upper)
        upper = np.where(
            finite_up, upper + tol * (1.0 + np.abs(upper)), upper
        )
    if nonnegative:
        lower = np.maximum(lower, 0.0)
    return lower, upper


def finish_estimates(lower, upper):
    """``(estimates, max_errors)`` from WIDENED bounds — the serving
    contract per entry: proven-inf pairs report ``(inf, 0)``, unknown
    ones ``(inf, inf)``, everything else ``(upper, upper - lower)``.
    Shared by the host and device lookup paths (same rationale as
    :func:`widen_bounds`)."""
    proven_inf = np.isinf(lower) & (lower > 0)
    est = np.where(proven_inf, np.inf, upper)
    with np.errstate(invalid="ignore"):
        gap = upper - lower
    err = np.where(proven_inf, 0.0,
                   np.where(np.isfinite(gap), gap, np.inf))
    return est, err


def boundary_vertices(graph, *, labels=None, seed: int = 0) -> np.ndarray:
    """The partitioned route's boundary-vertex set: endpoints of edges
    whose two ends carry different partition labels. ``labels`` is an
    ``int[V]`` partition labeling (``solver.partitioned``'s attach-time
    labels when the caller has them); None computes a fresh seeded
    ``partition_by_pivots`` labeling — deterministic for (graph, seed).
    Empty when the graph condenses to one part (no cross edges)."""
    from paralleljohnson_tpu_torch.solver.partitioned import (
        auto_num_parts,
        partition_by_pivots,
    )

    v = graph.num_nodes
    if labels is None:
        labels = partition_by_pivots(graph, auto_num_parts(v), seed=seed)
    labels = np.asarray(labels)
    if labels.shape != (v,):
        raise ValueError(
            f"labels must be shape ({v},), got {labels.shape}"
        )
    e = graph.num_real_edges
    src = graph.src[:e]
    dst = graph.indices[:e]
    cross = labels[src] != labels[dst]
    mask = np.zeros(v, bool)
    mask[src[cross]] = True
    mask[dst[cross]] = True
    return np.flatnonzero(mask).astype(np.int64)


def pick_pivots(graph, k: int, *, seed: int = 0,
                picker: str = "uniform", labels=None) -> np.ndarray:
    """Seeded pivot draw. ``"uniform"`` (the default, unchanged) draws
    without replacement from all vertices; ``"coverage"`` weights the
    draw by total degree (in + out + 1) — on power-law graphs the
    high-degree hubs sit on far more shortest paths, so a pivot set
    biased toward them tightens the triangle-inequality interval for
    the same k (the partitioned route's boundary-vertex observation).
    ``"boundary"`` draws from that
    observation's LITERAL set — the partitioned route's boundary
    vertices (:func:`boundary_vertices`, using the caller's partition
    ``labels`` when given, else a fresh seeded labeling): every
    cross-part shortest path passes through one, so they cover pairs a
    degree heuristic can miss on low-degree road-like graphs; when the
    boundary set is smaller than k (a one-part graph has none) the draw
    falls back to ``coverage``. All three are deterministic for a given
    (graph, k, seed[, labels])."""
    if picker not in PIVOT_PICKERS:
        raise ValueError(
            f"picker must be one of {PIVOT_PICKERS}, got {picker!r}"
        )
    v = graph.num_nodes
    k = max(0, min(int(k), v))
    if k == 0:
        return np.zeros(0, np.int64)
    rng = np.random.default_rng(seed)
    if picker == "boundary":
        try:
            boundary = boundary_vertices(graph, labels=labels, seed=seed)
        except ValueError:
            raise
        except Exception:  # noqa: BLE001 — labeling failure degrades, never crashes
            boundary = np.zeros(0, np.int64)
        if len(boundary) >= k:
            return np.sort(rng.choice(boundary, size=k, replace=False))
        picker = "coverage"
    if picker == "coverage":
        indptr = np.asarray(graph.indptr, np.int64)
        out_deg = np.diff(indptr)
        # Only CSR-owned edges count — the pad tail (indices past
        # indptr[-1]) belongs to no row and must not skew vertex 0.
        in_deg = np.bincount(
            np.asarray(graph.indices[:indptr[-1]], np.int64),
            minlength=v,
        )[:v]
        w = (out_deg + in_deg + 1).astype(np.float64)
        return np.sort(rng.choice(v, size=k, replace=False, p=w / w.sum()))
    return np.sort(rng.choice(v, size=k, replace=False))


@dataclasses.dataclass
class Bounds:
    """One query's certified interval. ``estimate`` is the value a caller
    should serve (the upper bound — a realizable path length, or +inf
    when no landmark connects the pair); ``max_error`` bounds
    ``|estimate - exact|`` (0 when the interval pins the answer, +inf
    when the landmarks carry no information about the pair)."""

    lower: float
    upper: float

    @property
    def estimate(self) -> float:
        # Both bounds infinite: d(s,t) is PROVEN +inf (lower <= exact).
        if np.isinf(self.lower) and self.lower > 0:
            return float("inf")
        return self.upper

    @property
    def max_error(self) -> float:
        if np.isinf(self.lower) and self.lower > 0:
            return 0.0  # proven unreachable: the estimate is exact
        err = self.upper - self.lower
        return float(err) if np.isfinite(err) else float("inf")


class LandmarkIndex:
    """k exact pivot solves answering any pair with a certified interval.

    ``fwd``/``rev`` are host ``[k, V]`` arrays (k is small — the index
    costs 2k exact SSSP rows, solved once through the ordinary resilient
    solver at build). Pivots are a deterministic seeded uniform draw:
    good enough for bound quality at this stage, and reproducible so a
    persisted index can be validated against a rebuild.
    """

    def __init__(self, sources: np.ndarray, fwd: np.ndarray,
                 rev: np.ndarray, *, nonnegative: bool,
                 digest: str | None = None) -> None:
        self.sources = np.asarray(sources, np.int64)
        # f64 working copies: the bound arithmetic must not add rounding
        # of its own on top of the solver's (k is small; 2 x k x V f64
        # is cheap next to the store's row tiers).
        self.fwd = np.asarray(fwd, np.float64)
        self.rev = np.asarray(rev, np.float64)
        self.nonnegative = bool(nonnegative)
        self.digest = digest
        if self.fwd.shape != self.rev.shape or len(self.fwd) != len(self.sources):
            raise ValueError(
                f"inconsistent landmark shapes: sources {self.sources.shape}, "
                f"fwd {self.fwd.shape}, rev {self.rev.shape}"
            )

    @property
    def k(self) -> int:
        return len(self.sources)

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, graph, k: int, *, config=None, seed: int = 0,
              solver=None, picker: str = "uniform",
              labels=None, device="cuda") -> "LandmarkIndex":
        """Solve ``k`` seeded pivots exactly (forward + reverse graph)
        through the resilient solver — retries, OOM degradation, and the
        pipeline all apply, exactly like any other solve. ``picker``
        selects the pivot draw (:func:`pick_pivots`): ``"uniform"``
        (default, unchanged), ``"coverage"`` (degree-weighted, for
        power-law graphs), or ``"boundary"`` (the partitioned route's
        boundary-vertex set; ``labels`` optionally supplies attach-time
        partition labels). The pivot solves run on ``device`` (the card
        unless the caller asks for the CPU) when no ``solver`` is given."""
        from paralleljohnson_tpu_torch.solver import ParallelJohnsonSolver
        from paralleljohnson_tpu_torch.solver.johnson import to_numpy

        v = graph.num_nodes
        pivots = pick_pivots(graph, k, seed=seed, picker=picker,
                             labels=labels)
        k = len(pivots)
        if solver is None:
            solver = ParallelJohnsonSolver(config, device=device)
        if k == 0:
            empty = np.zeros((0, v), graph.dtype)
            return cls(pivots, empty, empty,
                       nonnegative=not graph.has_negative_weights,
                       digest=graph_digest(graph))
        fwd = to_numpy(solver.solve(graph, sources=pivots).dist)
        rev = to_numpy(solver.solve(graph.reverse(), sources=pivots).dist)
        return cls(pivots, fwd, rev,
                   nonnegative=not graph.has_negative_weights,
                   digest=graph_digest(graph))

    # -- bounds --------------------------------------------------------------

    def bounds(self, s: int, t: int) -> Bounds:
        row = self.bounds_row(s, np.array([t], np.int64))
        return Bounds(lower=float(row[0][0]), upper=float(row[1][0]))

    def raw_bounds_row(self, s: int, dsts: np.ndarray | None = None):
        """The pure add/sub/min/max triangle-inequality bounds, BEFORE
        the f32-slack widening and non-negative clamp (those live in
        :func:`widen_bounds`). This split is the device-parity seam: the
        raw part is elementwise adds/subs plus order-independent min/max
        reductions over values that are never NaN, so a device kernel
        computing it in f64 is bitwise identical to this numpy code —
        the finishing always runs on host through the shared helpers."""
        d_s_L = self.rev[:, s]          # [k]  d(s, L)
        d_L_s = self.fwd[:, s]          # [k]  d(L, s)
        fwd_t = self.fwd if dsts is None else self.fwd[:, dsts]  # [k, D]
        rev_t = self.rev if dsts is None else self.rev[:, dsts]  # [k, D]
        n_dst = fwd_t.shape[1]
        if self.k == 0:
            return np.full(n_dst, -np.inf), np.full(n_dst, np.inf)
        with np.errstate(invalid="ignore"):
            upper_c = d_s_L[:, None] + fwd_t        # path s -> L -> t
            # inf + inf = inf is fine; (+inf) + (-anything) never occurs
            # (distances are never -inf on negative-cycle-free graphs).
            upper = np.min(upper_c, axis=0)
            # d(L,t) - d(L,s) valid iff d(L,s) finite; vacuous -> -inf.
            a = np.where(np.isfinite(d_L_s)[:, None], fwd_t - d_L_s[:, None],
                         -np.inf)
            # d(s,L) - d(t,L) valid iff d(t,L) finite; vacuous -> -inf.
            b = np.where(np.isfinite(rev_t), d_s_L[:, None] - rev_t, -np.inf)
        lower = np.maximum(np.max(a, axis=0), np.max(b, axis=0))
        return lower, upper

    def bounds_row(self, s: int, dsts: np.ndarray | None = None):
        """Vectorized one-to-many bounds from source ``s``: returns
        ``(lower[len(dsts)], upper[len(dsts)])`` (all V destinations when
        ``dsts`` is None)."""
        if self.k == 0:
            n_dst = self.fwd.shape[1] if dsts is None else len(dsts)
            lower = np.zeros(n_dst) if self.nonnegative else np.full(
                n_dst, -np.inf)
            return lower, np.full(n_dst, np.inf)
        lower, upper = self.raw_bounds_row(s, dsts)
        return widen_bounds(lower, upper, nonnegative=self.nonnegative)

    def estimate(self, s: int, t: int) -> tuple[float, float]:
        """``(estimate, max_error)`` for one pair — the serving contract:
        ``|estimate - d(s, t)| <= max_error`` (inf-aware: a proven-inf
        pair reports ``(inf, 0)``; an unknown one ``(inf, inf)``)."""
        b = self.bounds(s, t)
        return b.estimate, b.max_error

    def estimate_row(self, s: int, dsts: np.ndarray | None = None):
        """Vectorized :meth:`estimate` — ``(estimates, max_errors)``
        arrays for a one-to-many query, same per-entry semantics."""
        lower, upper = self.bounds_row(s, dsts)
        return finish_estimates(lower, upper)

    # -- persistence ---------------------------------------------------------

    def save(self, directory: str | Path) -> Path:
        """Persist next to the tile store's batches (one npz: pivots +
        both row blocks + the graph digest that keys validity)."""
        path = Path(directory) / LANDMARKS_FILENAME
        tmp = path.with_suffix(".tmp.npz")
        np.savez_compressed(
            tmp, sources=self.sources, fwd=self.fwd, rev=self.rev,
            nonnegative=np.array(self.nonnegative),
            digest=np.array(self.digest or ""),
        )
        tmp.rename(path)
        return path

    @classmethod
    def load(cls, directory: str | Path, *,
             expect_digest: str | None = None) -> "LandmarkIndex | None":
        """Load a persisted index; None when absent, unreadable, or built
        for a different graph (digest mismatch — a stale index must
        rebuild, never silently bound the wrong graph)."""
        path = Path(directory) / LANDMARKS_FILENAME
        if not path.exists():
            return None
        try:
            with np.load(path) as data:
                digest = str(data["digest"]) if "digest" in data.files else ""
                if expect_digest is not None and digest != expect_digest:
                    return None
                return cls(
                    data["sources"], data["fwd"], data["rev"],
                    nonnegative=bool(data["nonnegative"]),
                    digest=digest or None,
                )
        except Exception:  # noqa: BLE001 — a torn index is a rebuild, not a crash
            return None
