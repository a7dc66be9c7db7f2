"""Certified (1+ε) hopset construction on the batched-relaxation substrate
(PAPERS.md "Faster Parallel Algorithm for Approximate
Shortest Path", arXiv:1911.01626).

The exact routes top out near s22; this module opens the next order of
magnitude by SHORTCUTTING the graph instead of sweeping it to the
diameter. k pivot vertices are sampled (the ``serve.landmarks`` seeded
draw — uniform / coverage / boundary), and β-hop-bounded Bellman-Ford
(the fan-out sweep of ``ops.fanout_sweep``, capped at β sweeps; the hand
kernel on the card) is run from the pivot batch twice: forward over
the graph and over the edge-reversed graph. Round r of the sweep
kernel computes exactly the min over ≤ r-hop paths, so every finite entry of the pivot rows is a REAL path
length — an upper bound on the true distance, and the exact distance
when the sweep reached its fixpoint before the hop cap (the
``converged`` flag). The hopset H is then the star of weighted
shortcut edges ``p -> v`` (weight = β-hop d(p, v)) and ``v -> p``
(weight = β-hop d(v, p)): adding H to G never shortens any distance
below the truth (every H edge is realizable in G), while a query-time
β-hop sweep over ``G ∪ H`` reaches any vertex through its best pivot
in 2 hops — hop-bounded answers on graphs whose diameter the exact
sweeps cannot afford.

The certificate (the repo's honesty rule — never an unflagged
approximation):

  - query rows U from the bounded sweep over ``G ∪ H`` are upper
    bounds ALWAYS (real path lengths), and exact when that sweep hit
    its fixpoint (hopset edges preserve distances, so the fixpoint
    over ``G ∪ H`` is the fixpoint over G);
  - lower bounds come from the pivot rows through the SAME
    triangle-inequality machinery as the landmark index — valid only
    when construction converged (the rows are then exact pivot
    distances); an unconverged hopset on a non-negative graph still
    certifies ``d ∈ [0, U]``;
  - the served bound is the tighter of the hopset interval and the
    landmark index's interval (composition happens in
    ``solver.approx`` / the query engine), and a pair neither proves
    reachable nor unreachable reports ``(inf, inf)`` — unreachable is
    never silently bounded.

Work accounting: each sweep examines B x E candidate slots, counted
exactly in Python ints (the reference decodes the same total from split
int32 words).
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path

import numpy as np
import torch

from paralleljohnson_tpu_torch.backends.torch_backend import resolve_device
from paralleljohnson_tpu_torch.ops.fanout_sweep import fanout_fixpoint_chunks
from paralleljohnson_tpu_torch.ops.relax import multi_source_init
from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from paralleljohnson_tpu_torch.utils.checkpoint import graph_digest
from paralleljohnson_tpu_torch.utils.telemetry import NULL_TELEMETRY

HOPSET_FILENAME = "hopset.npz"

# Hop-budget clamp: β below 4 cannot even relay through one pivot with
# slack; β above 256 is the diameter regime where the exact routes
# already win.
BETA_MIN, BETA_MAX = 4, 256


def auto_beta(num_nodes: int, epsilon: float) -> int:
    """Hop budget β(V, ε) ~ ceil(log2 V / ε), clamped to
    [BETA_MIN, BETA_MAX]. The paper's hopset guarantee trades hop count
    against stretch as β ~ polylog(V)/ε; the log2 V / ε shape keeps the
    measured CPU sweet spot (β ≈ 24 at V=4096, ε=0.5 vs a grid diameter
    of ~128 sweeps) while tightening construction as ε shrinks. The
    certificate never depends on this choice — β only moves where the
    interval lands."""
    v = max(2, int(num_nodes))
    return int(min(BETA_MAX, max(BETA_MIN, math.ceil(
        math.log2(v) / max(float(epsilon), 1e-6)))))


def auto_num_pivots(num_nodes: int) -> int:
    """~sqrt(V) pivots clamped to [1, 256] — the landmark-index scale:
    construction costs 2k bounded-hop rows and the hopset carries
    O(k·V) shortcut edges, so k ~ sqrt(V) keeps both subquadratic."""
    return int(min(256, max(1, round(max(1, int(num_nodes)) ** 0.5))))


def hop_chunks(graph, *, edge_chunk: int = 1 << 20, device="cuda"):
    """The in-edge layouts of ``graph``'s β-hop sweep on ``device`` (the
    card unless the caller asks for the CPU): the
    real edges sorted by destination (stable, so the order is
    deterministic), cut into the reference's chunks of ``min(edge_chunk,
    E)`` consecutive edges, one ``(indptr_in, src_in, w_in, items)``
    layout each (``items`` None; the card's fixpoint builds them). A
    vertex whose in-edges straddle two chunks has its part in each
    chunk's ``indptr_in``. :func:`fanout_fixpoint_chunks` over these is
    the reference's chunk-level Gauss-Seidel sweep: one launch per
    chunk, chained through the carry."""
    device = resolve_device(device)
    v = graph.num_nodes
    e = graph.num_real_edges
    dst = torch.as_tensor(np.asarray(graph.indices[:e], np.int64)).to(device)
    order = torch.argsort(dst, stable=True)
    src_in = torch.as_tensor(np.asarray(graph.src[:e], np.int32)).to(
        device)[order].contiguous()
    w_in = torch.as_tensor(np.asarray(graph.weights[:e])).to(
        device)[order].contiguous()
    indptr = torch.zeros(v + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(dst, minlength=v), 0, out=indptr[1:])
    chunk = max(1, min(int(edge_chunk), e))
    chunks = []
    for lo in range(0, e, chunk):
        hi = min(lo + chunk, e)
        ip = (indptr - lo).clamp_(0, hi - lo).to(torch.int32)
        chunks.append((ip, src_in[lo:hi], w_in[lo:hi], None))
    return chunks


def hop_init(sources, num_nodes: int, *, dtype, device, seed_rows=None):
    """The β-hop sweep's vertex-major start ``[V, B]``: +inf with 0 at
    each row's source, min'd entrywise with ``seed_rows`` ``[B, V]``
    (cast to ``dtype``) when given."""
    src = torch.as_tensor(np.asarray(sources, np.int64), device=device)
    dist0 = multi_source_init(src, num_nodes, dtype=dtype)
    if seed_rows is not None:
        dist0 = torch.minimum(dist0, torch.as_tensor(
            np.asarray(seed_rows)).to(device=device, dtype=dtype))
    return dist0.T.contiguous()


def bounded_hop_rows(graph, sources: np.ndarray, *, beta: int,
                     seed_rows: np.ndarray | None = None,
                     edge_chunk: int = 1 << 20, device="cuda"):
    """β-hop-bounded Bellman-Ford rows from ``sources`` over ``graph``,
    on ``device`` (the card unless the caller asks for the CPU: the
    hand sweep ``fanout_sweep``, one launch per edge chunk per sweep).

    Returns ``(rows, iterations, converged, examined)``: ``rows`` is a
    host ``[B, V]`` array where entry (r, v) = min over ≤ iterations-hop
    paths from sources[r] to v — a real path length wherever finite and
    an upper bound on the true distance; ``converged`` is True iff the
    sweep hit its fixpoint before the β cap (rows are then EXACT);
    ``examined`` is the exact candidate-slot count (iterations × B × E).
    All four are bitwise the reference's at every ``edge_chunk``: the
    sweep keeps its chunk-level Gauss-Seidel order (:func:`hop_chunks`).

    ``seed_rows`` (optional ``[B, V]``) initializes each row at the
    entrywise min of the plain source init and the seed — the query-time
    relay trick: a seed whose every finite entry is a real path length
    from its row's source (e.g. the hopset pivot relay ``min_p
    d(s,p) + d(p,v)``) keeps the real-path invariant, and a stable
    fixpoint from an everywhere-upper-bound seed is still exactly d
    (first-divergence argument along a shortest path), so ``converged``
    keeps its EXACT meaning.

    Row r's value after i sweeps depends only on (graph, sources[r], i,
    seed_rows[r]) — never on the other rows in the batch — and extra
    sweeps past a row's fixpoint are no-ops, so any batch partition of
    a source set produces BITWISE-identical rows (the fleet-sharding
    invariant the fleet coordinator leans on).
    """
    device = resolve_device(device)
    sources = np.asarray(sources, np.int64)
    v = graph.num_nodes
    e = graph.num_real_edges
    if len(sources) == 0:
        return np.zeros((0, v), graph.dtype), 0, True, 0
    if e == 0:
        rows = np.full((len(sources), v), np.inf, graph.dtype)
        rows[np.arange(len(sources)), sources] = 0.0
        if seed_rows is not None:
            rows = np.minimum(rows, np.asarray(seed_rows, graph.dtype))
        return rows, 0, True, 0
    chunks = hop_chunks(graph, edge_chunk=edge_chunk, device=device)
    dist0 = hop_init(sources, v, dtype=chunks[0][2].dtype, device=device,
                     seed_rows=seed_rows)
    dist, iters, improving = fanout_fixpoint_chunks(
        dist0, chunks, max_iter=int(beta))
    # Each sweep examines B x E candidate slots (the reference counts
    # them in split int32 words; Python ints are exact as they are).
    examined = int(iters) * len(sources) * e
    return to_numpy(dist.T), int(iters), not improving, examined


@dataclasses.dataclass
class Hopset:
    """A built hopset: k pivots, their β-hop-bounded forward/reverse
    rows (f64 working copies, exactly as the landmark index holds its
    rows), and the provenance that keys validity (graph digest, ε, β,
    convergence). ``fwd[i]`` bounds d(pivots[i], ·); ``rev[i]`` bounds
    d(·, pivots[i]) (computed on the reversed graph)."""

    epsilon: float
    beta: int
    pivots: np.ndarray          # int64 [k]
    fwd: np.ndarray             # f64 [k, V]
    rev: np.ndarray             # f64 [k, V]
    converged: bool             # both pivot sweeps reached fixpoint
    nonnegative: bool
    digest: str | None = None
    picker: str = "uniform"
    seed: int = 0
    edges_examined: int = 0     # exact construction candidate slots
    construction_s: float = 0.0

    def __post_init__(self) -> None:
        self.pivots = np.asarray(self.pivots, np.int64)
        self.fwd = np.asarray(self.fwd, np.float64)
        self.rev = np.asarray(self.rev, np.float64)
        self._closure: np.ndarray | None = None
        if self.fwd.shape != self.rev.shape or len(self.fwd) != len(self.pivots):
            raise ValueError(
                f"inconsistent hopset shapes: pivots {self.pivots.shape}, "
                f"fwd {self.fwd.shape}, rev {self.rev.shape}"
            )

    @property
    def k(self) -> int:
        return len(self.pivots)

    @property
    def num_nodes(self) -> int:
        return self.fwd.shape[1] if self.fwd.ndim == 2 else 0

    # -- the shortcut edges --------------------------------------------------

    def edges(self):
        """The hopset COO edge lists ``(src, dst, w)``: ``p -> v`` with
        weight fwd[p, v] and ``v -> p`` with weight rev[p, v], finite
        entries only, self-loops dropped. Weights are emitted in f32
        (the values ARE f32 sweep outputs held in f64 — the cast back
        is exact), so the union graph relaxes the same bits the
        construction computed."""
        v = self.num_nodes
        srcs, dsts, ws = [], [], []
        for i, p in enumerate(self.pivots):
            fin = np.isfinite(self.fwd[i])
            fin[p] = False
            idx = np.flatnonzero(fin)
            srcs.append(np.full(len(idx), p, np.int64))
            dsts.append(idx.astype(np.int64))
            ws.append(self.fwd[i, idx])
            fin = np.isfinite(self.rev[i])
            fin[p] = False
            idx = np.flatnonzero(fin)
            srcs.append(idx.astype(np.int64))
            dsts.append(np.full(len(idx), p, np.int64))
            ws.append(self.rev[i, idx])
        if not srcs:
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, np.float32)
        return (
            np.concatenate(srcs), np.concatenate(dsts),
            np.concatenate(ws).astype(np.float32),
        )

    def pivot_closure(self) -> np.ndarray:
        """f32 ``[k, k]`` all-pairs closure of the β-hop pivot-pivot
        bounds (Floyd-Warshall on the pivot graph — k ≤ 256, host
        work). Entry (i, j) is a real ``p_i → p_j`` path length in G
        (each closure step concatenates two real paths), which is what
        lets the relay bridge pairs no single pivot ball covers: on a
        high-diameter graph a source's β-ball sees only nearby pivots,
        but the pivot graph chains them across the whole component.
        Cached — construction-deterministic, so the fleet merge and a
        single-worker build agree bitwise here too."""
        if self._closure is None:
            pp = np.minimum(
                self.fwd[:, self.pivots], self.rev[:, self.pivots].T
            ).astype(np.float32)
            np.fill_diagonal(pp, 0.0)
            for m in range(self.k):
                np.minimum(
                    pp, pp[:, m][:, None] + pp[m, :][None, :], out=pp
                )
            self._closure = pp
        return self._closure

    def relayed_pivot_row(self, sources: np.ndarray) -> np.ndarray:
        """f32 ``[B, k]`` chained source-to-pivot bounds: ``min_i
        d_β(s, p_i) + closure(p_i, p_j)`` — the rev leg extended over
        the pivot graph. Every finite entry is a real path length."""
        sources = np.asarray(sources, np.int64)
        rev32 = self.rev[:, sources].astype(np.float32).T   # [B, k]
        cl = self.pivot_closure()
        out = np.full_like(rev32, np.inf)
        for i in range(self.k):
            np.minimum(out, rev32[:, i][:, None] + cl[i][None, :], out=out)
        return out

    def relay_rows(self, sources: np.ndarray) -> np.ndarray:
        """The pivot relay rows ``min_{i,j} d(s,p_i) + d(p_i..p_j) +
        d(p_j,v)`` for the source batch, in f32. Every finite entry is
        a real path length in G (every leg is), so seeding a G-only
        sweep with them (``bounded_hop_rows(seed_rows=...)``) computes
        the ``G ∪ H`` union sweep with the 2·k·V shortcut relaxations
        hoisted out of every round — E edges per round instead of
        E + 2·k·V. Accumulated pivot-by-pivot to keep the working set
        at [B, V], not [B, k, V]."""
        sources = np.asarray(sources, np.int64)
        out = np.full((len(sources), self.num_nodes), np.inf, np.float32)
        if self.k == 0:
            return out
        through = self.relayed_pivot_row(sources)           # [B, k]
        for j in range(self.k):
            fwd32 = self.fwd[j].astype(np.float32)          # [V]
            np.minimum(out, through[:, j][:, None] + fwd32[None, :],
                       out=out)
        return out

    @property
    def num_hopset_edges(self) -> int:
        v = self.num_nodes
        if self.k == 0 or v == 0:
            return 0
        on_pivot_f = np.isfinite(
            self.fwd[np.arange(self.k), self.pivots]
        ).sum()
        on_pivot_r = np.isfinite(
            self.rev[np.arange(self.k), self.pivots]
        ).sum()
        return int(
            np.isfinite(self.fwd).sum() + np.isfinite(self.rev).sum()
            - on_pivot_f - on_pivot_r
        )

    def union_graph(self, graph):
        """``G ∪ H`` as a CSRGraph (dedupe keeps the min-weight parallel
        edge — the shortest-path-relevant one). Cached per graph digest:
        the query loop unions once, not per batch."""
        from paralleljohnson_tpu_torch.graphs.csr import CSRGraph

        key = self.digest or graph_digest(graph)
        cached = self.__dict__.get("_union")
        if cached is not None and cached[0] == key:
            return cached[1]
        e = graph.num_real_edges
        hs, hd, hw = self.edges()
        union = CSRGraph.from_edges(
            np.concatenate([graph.src[:e].astype(np.int64), hs]),
            np.concatenate([graph.indices[:e].astype(np.int64), hd]),
            np.concatenate([
                graph.weights[:e].astype(np.float32), hw
            ]),
            num_nodes=graph.num_nodes,
        )
        self.__dict__["_union"] = (key, union)
        return union

    # -- certified bounds ----------------------------------------------------

    def lower_index(self):
        """The pivot rows as a ``LandmarkIndex`` — the triangle-
        inequality lower/upper machinery applies verbatim, but ONLY
        when construction converged (the rows are then exact pivot
        distances; unconverged rows are upper bounds, from which the
        subtraction lower bounds would be unsound). None otherwise."""
        if not self.converged:
            return None
        from paralleljohnson_tpu_torch.serve.landmarks import LandmarkIndex

        return LandmarkIndex(
            self.pivots, self.fwd, self.rev,
            nonnegative=self.nonnegative, digest=self.digest,
        )

    def bounds_row(self, s: int, dsts: np.ndarray | None = None):
        """Certified ``(lower, upper)`` interval rows for source ``s``
        (widened + clamped through the shared landmark helpers).
        Converged hopsets get the full landmark interval from the exact
        pivot rows; unconverged ones keep the pivot-relay upper bound
        (the closure-chained ``d(s, p·..·p_j) + fwd[p_j, t]`` — a
        concatenation of real path lengths is a real path length) over
        a vacuous lower (0 on non-negative graphs)."""
        from paralleljohnson_tpu_torch.serve import landmarks as lm

        idx = self.lower_index()
        if idx is not None:
            return idx.bounds_row(s, dsts)
        n_dst = self.num_nodes if dsts is None else len(dsts)
        lower = np.zeros(n_dst) if self.nonnegative else np.full(
            n_dst, -np.inf)
        if self.k == 0:
            return lower, np.full(n_dst, np.inf)
        d_s_p = self.relayed_pivot_row(np.array([s]))[0]         # [k]
        fwd_t = self.fwd if dsts is None else self.fwd[:, dsts]  # [k, D]
        with np.errstate(invalid="ignore"):
            upper = np.min(d_s_p[:, None] + fwd_t, axis=0)
        lower2, upper = lm.widen_bounds(
            np.full(n_dst, -np.inf), upper, nonnegative=self.nonnegative
        )
        return np.maximum(lower, lower2), upper

    def estimate_row(self, s: int, dsts: np.ndarray | None = None):
        """``(estimates, max_errors)`` — the serving contract per entry
        (proven-inf → (inf, 0); unknown → (inf, inf))."""
        from paralleljohnson_tpu_torch.serve import landmarks as lm

        return lm.finish_estimates(*self.bounds_row(s, dsts))

    def estimate(self, s: int, t: int) -> tuple[float, float]:
        est, err = self.estimate_row(s, np.array([t], np.int64))
        return float(est[0]), float(err[0])

    # -- persistence ---------------------------------------------------------

    def save(self, directory: str | Path) -> Path:
        """Persist next to ``landmarks.npz`` — one digest-guarded npz,
        written tmp-then-rename so a torn write is a rebuild, never a
        wrong-graph hopset."""
        path = Path(directory) / HOPSET_FILENAME
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp.npz")
        np.savez_compressed(
            tmp, epsilon=np.array(float(self.epsilon)),
            beta=np.array(int(self.beta)), pivots=self.pivots,
            fwd=self.fwd, rev=self.rev,
            converged=np.array(bool(self.converged)),
            nonnegative=np.array(bool(self.nonnegative)),
            digest=np.array(self.digest or ""),
            picker=np.array(self.picker), seed=np.array(int(self.seed)),
            edges_examined=np.array(int(self.edges_examined), np.int64),
            construction_s=np.array(float(self.construction_s)),
        )
        tmp.rename(path)
        return path

    @classmethod
    def load(cls, directory: str | Path, *,
             expect_digest: str | None = None) -> "Hopset | None":
        """Load a persisted hopset; None when absent, unreadable, or
        built for a different graph (digest mismatch — same contract as
        the landmark index: stale means rebuild, never silently serve
        the wrong graph's shortcuts)."""
        path = Path(directory) / HOPSET_FILENAME
        if not path.exists():
            return None
        try:
            with np.load(path) as data:
                digest = str(data["digest"]) if "digest" in data.files else ""
                if expect_digest is not None and digest != expect_digest:
                    return None
                return cls(
                    epsilon=float(data["epsilon"]),
                    beta=int(data["beta"]), pivots=data["pivots"],
                    fwd=data["fwd"], rev=data["rev"],
                    converged=bool(data["converged"]),
                    nonnegative=bool(data["nonnegative"]),
                    digest=digest or None,
                    picker=str(data["picker"]) if "picker" in data.files
                    else "uniform",
                    seed=int(data["seed"]) if "seed" in data.files else 0,
                    edges_examined=int(data["edges_examined"])
                    if "edges_examined" in data.files else 0,
                    construction_s=float(data["construction_s"])
                    if "construction_s" in data.files else 0.0,
                )
        except Exception:  # noqa: BLE001 — a torn hopset is a rebuild, not a crash
            return None


def build_pivot_rows(graph, pivots: np.ndarray, *, beta: int,
                     reverse_graph=None, edge_chunk: int = 1 << 20,
                     telemetry=None, device="cuda"):
    """The shard-unit construction step: forward + reverse β-hop rows
    for ``pivots`` (any subset of the full pivot draw) on ``device``. Returns
    ``(fwd, rev, converged, examined)``. Bitwise-deterministic in the
    pivot subset (see :func:`bounded_hop_rows`), which is what lets the
    fleet shard construction over pivot ranges and merge."""
    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    rg = reverse_graph if reverse_graph is not None else graph.reverse()
    with tel.span("hopset_fwd", op="hopset", n_pivots=len(pivots),
                  beta=int(beta)):
        fwd, _, conv_f, ex_f = bounded_hop_rows(
            graph, pivots, beta=beta, edge_chunk=edge_chunk, device=device
        )
    with tel.span("hopset_rev", op="hopset", n_pivots=len(pivots),
                  beta=int(beta)):
        rev, _, conv_r, ex_r = bounded_hop_rows(
            rg, pivots, beta=beta, edge_chunk=edge_chunk, device=device
        )
    return fwd, rev, bool(conv_f and conv_r), int(ex_f + ex_r)


def build_hopset(graph, *, epsilon: float = 0.1, k: int | None = None,
                 beta: int | None = None, seed: int = 0,
                 picker: str = "uniform", labels=None,
                 edge_chunk: int = 1 << 20, telemetry=None,
                 device="cuda") -> Hopset:
    """Build the full hopset in one process on ``device``: seeded pivot
    draw, then one batched forward + one batched reverse bounded-hop
    sweep. The
    fleet-sharded path (``solver.approx.fleet_build_hopset``) produces
    the bitwise-identical result from per-range lease artifacts."""
    from paralleljohnson_tpu_torch.serve.landmarks import pick_pivots

    tel = telemetry if telemetry is not None else NULL_TELEMETRY
    t0 = time.perf_counter()
    v = graph.num_nodes
    k = auto_num_pivots(v) if k is None else max(0, min(int(k), v))
    beta = auto_beta(v, epsilon) if beta is None else int(beta)
    pivots = pick_pivots(graph, k, seed=seed, picker=picker, labels=labels)
    with tel.span("hopset_build", op="hopset", n_pivots=len(pivots),
                  beta=beta, epsilon=float(epsilon)):
        fwd, rev, converged, examined = build_pivot_rows(
            graph, pivots, beta=beta, edge_chunk=edge_chunk, telemetry=tel,
            device=device,
        )
    return Hopset(
        epsilon=float(epsilon), beta=beta, pivots=pivots,
        fwd=fwd, rev=rev, converged=converged,
        nonnegative=not graph.has_negative_weights,
        digest=graph_digest(graph), picker=picker, seed=int(seed),
        edges_examined=examined,
        construction_s=time.perf_counter() - t0,
    )
