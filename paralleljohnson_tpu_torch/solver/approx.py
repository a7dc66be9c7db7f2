"""The certified (1+ε) approximate APSP route ``hopset+bf``.

``approx_apsp`` answers source batches with β-hop-bounded Bellman-Ford
over ``G ∪ H`` (H = ``ops.hopset`` shortcut edges) and attaches a
CERTIFIED per-entry bound to every row: the estimate is always a real
path length (or +inf), and ``max_error`` is the width of the tightest
interval provable from (a) the query sweep's own fixpoint flag — a
converged sweep over ``G ∪ H`` IS exact, error 0; (b) the hopset pivot
rows' triangle-inequality interval; (c) the landmark index's directed
interval when the caller holds one. Tighter wins per entry, the repo's
composition rule — and an unreachable pair is reported unreachable
(``inf``), never silently bounded: a pair no certificate pins reports
``(inf, inf)``.

``solve_with_budget`` is the arbitration point: a ``planner.Plan`` pair
(``hopset+bf`` vs ``exact``) walked through the ordinary ``select()``
machinery. The hopset plan qualifies ONLY under a positive
``error_budget`` on a negative-free graph (zero budget always solves
exactly — asserted in tests), the CostModel prices the two against
``kind:"plan"``/analytic records when a profile store is fitted, and
the build walk degrades exactly like the backend dispatch sites: a
failed hopset build falls through to the exact plan, never crashes the
solve.

Fleet sharding (``fleet_build_hopset``): construction fans out over
pivot ranges through the fleet coordinator — each lease builds its
range's forward/reverse bounded-hop rows and commits them as a
digest-guarded npz artifact in its shard dir; the merge is a
start-ordered concatenation. Bitwise determinism vs a single-worker
build is a THEOREM of the sweep kernel (each row depends only on its
own source and the sweep count past its fixpoint is a no-op — see
``ops.hopset.bounded_hop_rows``), and the fleet test asserts it.
"""

from __future__ import annotations

import dataclasses
import time
import types
from pathlib import Path

import numpy as np

from paralleljohnson_tpu_torch import planner as _planner
from paralleljohnson_tpu_torch.backends.torch_backend import resolve_device
from paralleljohnson_tpu_torch.config import SolverConfig
from paralleljohnson_tpu_torch.observe import current_platform
from paralleljohnson_tpu_torch.ops import hopset as hs
from paralleljohnson_tpu_torch.utils.checkpoint import graph_digest
from paralleljohnson_tpu_torch.utils.telemetry import NULL_TELEMETRY

# The same f32-slack widening the landmark bounds use: the query rows
# are f32 path sums, so the served estimate is nudged up by this
# relative tolerance before the interval is finished — ``lower <=
# exact <= estimate`` must be a contract, not a rounding coin flip.
_F32_TOL = 32 * float(np.finfo(np.float32).eps)


@dataclasses.dataclass
class ApproxResult:
    """A ``hopset+bf`` solve: estimates + per-entry certified bounds.

    ``dist[i, v]`` estimates d(sources[i], v); ``max_error[i, v]``
    certifies ``|dist - exact| <= max_error`` (f32-rounding slack where
    the answer is proven exact by a converged sweep, exactly 0 for a
    proven-unreachable pair; +inf where no certificate pins the pair,
    which is also the only case an estimate of +inf is NOT a proven
    unreachability)."""

    dist: np.ndarray
    sources: np.ndarray
    max_error: np.ndarray
    hopset: hs.Hopset
    route: str = "hopset+bf"
    converged: bool = False
    stats: dict = dataclasses.field(default_factory=dict)
    plan: dict | None = None

    @property
    def exact(self) -> bool:
        """True when every entry is certified exact to f32 rounding
        (the sweep over ``G ∪ H`` reached its fixpoint in every
        batch)."""
        return bool(self.converged)

    @property
    def matrix(self) -> np.ndarray:
        order = np.argsort(self.sources)
        return np.asarray(self.dist)[order]


def _widen_up(rows: np.ndarray) -> np.ndarray:
    finite = np.isfinite(rows)
    return np.where(finite, rows + _F32_TOL * (1.0 + np.abs(rows)), rows)


def _compose_bounds(u_row, hop_lower, hop_upper, landmarks, s):
    """One row's certified interval: the query upper ``u_row`` (widened
    for f32 slack) min'd with the hopset interval's upper and, when a
    landmark index is attached, the landmark interval — lower is the
    max of the lowers, upper the min of the uppers (tighter wins; both
    sides stay certified because each input interval is)."""
    from paralleljohnson_tpu_torch.serve import landmarks as lm

    lower, upper = hop_lower, np.minimum(hop_upper, _widen_up(u_row))
    if landmarks is not None and landmarks.k > 0:
        lm_lower, lm_upper = landmarks.bounds_row(s)
        lower = np.maximum(lower, lm_lower)
        upper = np.minimum(upper, lm_upper)
    return lm.finish_estimates(lower, upper)


def hopset_record(hopset: hs.Hopset, graph, *, platform: str) -> dict:
    """The ``kind: "hopset"`` profile-store record — what
    ``observe.regress`` buckets by shape so a hopset that got slower or
    fatter flags like any other regression."""
    return {
        "ts": time.time(),
        "kind": "hopset",
        "platform": platform,
        "nodes": int(graph.num_nodes),
        "edges": int(graph.num_real_edges),
        "epsilon": float(hopset.epsilon),
        "beta": int(hopset.beta),
        "k": int(hopset.k),
        "hopset_edges": int(hopset.num_hopset_edges),
        "converged": bool(hopset.converged),
        "picker": hopset.picker,
        "construction_s": float(hopset.construction_s),
        "edges_examined": int(hopset.edges_examined),
    }


def _profile_store(config):
    import os

    root = config.profile_store or os.environ.get("PJ_PROFILE_DIR")
    if not root:
        return None
    from paralleljohnson_tpu_torch.observe.store import ProfileStore

    return ProfileStore(root)


def _planner_model(config):
    if config.planner is False:
        return None
    store = _profile_store(config)
    if store is None:
        return None
    try:
        from paralleljohnson_tpu_torch.observe.store import CostModel

        return CostModel.fit(store)
    except Exception:  # noqa: BLE001 — an unreadable store means unpriced, not broken
        return None


def approx_apsp(
    graph,
    sources: np.ndarray | None = None,
    *,
    config: SolverConfig | None = None,
    epsilon: float | None = None,
    hopset: hs.Hopset | None = None,
    landmarks=None,
    telemetry=None,
    device="cuda",
) -> ApproxResult:
    """Certified approximate APSP over ``graph`` (see module docstring),
    its construction and query sweeps on ``device`` (the card unless the
    caller asks for the CPU).

    ``hopset=None`` builds one (ε/β/k from the config's approx knobs);
    a prebuilt/persisted hopset is digest-checked against the graph.
    ``landmarks`` optionally composes the landmark index's interval
    into every bound (tighter wins per entry). Requires a negative-free
    graph — the hopset certificates assume ``d >= 0`` and the Johnson
    reweighting phases are exact-route machinery."""
    config = config or SolverConfig()
    device = resolve_device(device)
    tel = telemetry if telemetry is not None else (
        config.telemetry if config.telemetry is not None else NULL_TELEMETRY
    )
    if graph.has_negative_weights:
        raise ValueError(
            "hopset+bf requires non-negative weights (the certificates "
            "clamp lower bounds at 0); use the exact routes for "
            "negative-edge graphs"
        )
    epsilon = float(
        config.approx_epsilon if epsilon is None else epsilon
    )
    v = graph.num_nodes
    sources = (
        np.arange(v, dtype=np.int64) if sources is None
        else np.asarray(sources, np.int64)
    )
    digest = graph_digest(graph)
    stats: dict = {"epsilon": epsilon}
    if hopset is None:
        hopset = hs.build_hopset(
            graph, epsilon=epsilon, beta=config.approx_beta,
            telemetry=tel, device=device,
        )
        store = _profile_store(config)
        if store is not None:
            store.append(hopset_record(
                hopset, graph, platform=current_platform(device)))
    elif hopset.digest is not None and hopset.digest != digest:
        raise ValueError(
            "hopset was built for a different graph (digest mismatch) — "
            "rebuild it; a wrong-graph shortcut set cannot certify"
        )
    stats.update(
        beta=int(hopset.beta), k=int(hopset.k),
        hopset_edges=int(hopset.num_hopset_edges),
        construction_s=float(hopset.construction_s),
        hopset_converged=bool(hopset.converged),
    )

    t0 = time.perf_counter()
    batch = config.source_batch_size or max(16, min(1024, v))
    dist = np.empty((len(sources), v), np.float64)
    max_error = np.empty((len(sources), v), np.float64)
    all_converged = True
    examined = 0
    with tel.span("approx_query", op="hopset+bf", n_sources=len(sources),
                  beta=int(hopset.beta)):
        for lo in range(0, len(sources), batch):
            batch_sources = sources[lo:lo + batch]
            # The union sweep, reorganized: the star edges can only
            # ever contribute through the 2-hop relay s -> p -> v, so
            # the relay rows are hoisted into the seed and the β-hop
            # sweep runs over G alone — E edges per round, not
            # E + 2·k·V (see Hopset.relay_rows for the bit-match
            # argument; the seeded fixpoint stays EXACT).
            seed = (
                hopset.relay_rows(batch_sources)
                if hopset.k > 0 else None
            )
            rows, _, conv, ex = hs.bounded_hop_rows(
                graph, batch_sources, beta=hopset.beta, seed_rows=seed,
                device=device,
            )
            examined += ex
            rows = np.asarray(rows, np.float64)
            if conv:
                # Fixpoint over G ∪ H == fixpoint over G (hopset edges
                # are realizable): these rows are exact up to f32
                # rounding, +inf included. The certificate carries the
                # rounding slack — two f32 routes summing the same path
                # in different orders disagree at ulp level, and the
                # bound must hold against ANY exact route's output.
                dist[lo:lo + len(batch_sources)] = rows
                max_error[lo:lo + len(batch_sources)] = np.where(
                    np.isfinite(rows),
                    _F32_TOL * (1.0 + np.abs(rows)), 0.0,
                )
                continue
            all_converged = False
            for i, s in enumerate(batch_sources):
                hop_lower, hop_upper = hopset.bounds_row(int(s))
                est, err = _compose_bounds(
                    rows[i], hop_lower, hop_upper, landmarks, int(s)
                )
                dist[lo + i] = est
                max_error[lo + i] = err
    query_s = time.perf_counter() - t0
    stats.update(
        query_s=query_s, edges_examined=int(examined),
        query_converged=bool(all_converged),
        batches=-(-len(sources) // batch),
    )
    return ApproxResult(
        dist=dist, sources=sources, max_error=max_error, hopset=hopset,
        converged=all_converged, stats=stats,
    )


# -- budget arbitration: the planner picks exact vs approximate --------------


def _qual_hopset(ctx) -> tuple[bool, str]:
    if ctx.config.hopset is False:
        return False, "hopset disabled by config"
    if not ctx.error_budget > 0:
        return False, "error budget is 0 — exact is the only honest answer"
    if ctx.graph.has_negative_weights:
        return False, "negative weights: hopset certificates need d >= 0"
    return True, (
        f"budget {ctx.error_budget:g} admits a certified "
        f"(1+{ctx.config.approx_epsilon:g}) tier"
    )


def _contract_hopset(ctx) -> None:
    if ctx.config.hopset is True and not ctx.error_budget > 0:
        raise ValueError(
            "hopset=True forces the approximate plan but error_budget is "
            "0 — forcing an unflagged approximation is a contract "
            "violation; set a positive budget or drop the force"
        )


def _build_hopset_plan(ctx):
    return approx_apsp(
        ctx.graph, ctx.sources, config=ctx.config, hopset=ctx.hopset,
        landmarks=ctx.landmarks, telemetry=ctx.telemetry, device=ctx.device,
    )


def _fail_hopset(_owner, ctx) -> None:
    # Called INSIDE the ranking walk's active except: a bare raise
    # propagates the original failure. A forced approximate plan must
    # fail loud (the backend dispatch convention); an auto one degrades
    # to the exact plan below it.
    if ctx.config.hopset is True:
        raise


def _build_exact_plan(ctx):
    from paralleljohnson_tpu_torch.solver import ParallelJohnsonSolver

    return ParallelJohnsonSolver(ctx.config, device=ctx.device).solve(
        ctx.graph, ctx.sources)


APPROX_PLANS = [
    _planner.Plan(
        name="hopset+bf", entry="apsp", priority=10,
        qualify=_qual_hopset, contract=_contract_hopset,
        build=_build_hopset_plan, failure=_fail_hopset,
        price_routes=("hopset+bf",),
        forced=lambda cfg: getattr(cfg, "hopset", "auto") is True,
        force_overrides={"hopset": True},
        tunables=("approx_beta",),
    ),
    _planner.Plan(
        name="exact", entry="apsp", priority=20,
        qualify=lambda ctx: (True, "exact solve always qualifies"),
        build=_build_exact_plan,
        # The port's exact sparse route is the hand sweep (``pallas-vm``);
        # priced first, so a store measured on the card prices the exact
        # plan by the route that serves it.
        price_routes=("pallas-vm", "vm-blocked", "vm", "gs", "sweep"),
        forced=lambda cfg: getattr(cfg, "hopset", "auto") is False,
        force_overrides={"hopset": False},
    ),
]


def solve_with_budget(
    graph,
    sources: np.ndarray | None = None,
    *,
    config: SolverConfig | None = None,
    error_budget: float | None = None,
    hopset: hs.Hopset | None = None,
    landmarks=None,
    telemetry=None,
    device="cuda",
):
    """Solve ``graph`` under a relative error budget on ``device`` (the
    card unless the caller asks for the CPU): the planner walks
    ``APPROX_PLANS`` (priced by the CostModel when a store is fitted;
    declared priority otherwise — the approximate tier leads exactly
    when a positive budget qualifies it, and a zero budget pins exact).
    Returns ``(result, decision)`` — result is an :class:`ApproxResult`
    or an exact ``SolveResult``; both carry ``.plan`` (the decision
    record, also appended to the profile store as ``kind:"plan"``)."""
    config = config or SolverConfig()
    budget = float(
        config.error_budget if error_budget is None else error_budget
    )
    if budget < 0:
        raise ValueError(f"error_budget must be >= 0, got {budget!r}")
    device = resolve_device(device)
    ctx = types.SimpleNamespace(
        graph=graph, sources=sources, config=config,
        error_budget=budget, hopset=hopset, landmarks=landmarks,
        telemetry=telemetry, params={}, device=device,
    )
    t0 = time.perf_counter()
    decision = _planner.select(
        APPROX_PLANS, ctx, model=_planner_model(config),
        platform=current_platform(device), num_edges=graph.num_real_edges,
        batch=graph.num_nodes if sources is None else len(sources),
        config=config,
    )
    result = None
    for cand in decision.ranking:
        try:
            result = cand.plan.build(ctx)
        except Exception:
            if cand.plan.failure is None:
                raise
            cand.plan.failure(None, ctx)
            continue
        if result is None:
            continue
        decision.params.update(ctx.params)
        result.plan = decision.as_dict(built=cand.plan.name)
        break
    if result is None:
        raise RuntimeError(
            "planner: every qualified apsp plan failed "
            f"(ranking: {[c.plan.name for c in decision.ranking]})"
        )
    store = _profile_store(config)
    if store is not None:
        store.append(_planner.plan_record(
            result.plan, label="solve_with_budget",
            platform=current_platform(device), num_nodes=graph.num_nodes,
            num_edges=graph.num_real_edges,
            batch=graph.num_nodes if sources is None else len(sources),
            wall_s=time.perf_counter() - t0,
        ))
    return result, decision


# -- fleet-sharded construction ---------------------------------------------

_SHARD_PREFIX = "hopset_"


def _shard_path(shard_dir: Path, start: int, stop: int) -> Path:
    return shard_dir / f"{_SHARD_PREFIX}{start:08d}_{stop:08d}.npz"


def build_hopset_shard(
    coord, worker: str, lease, graph, pivots: np.ndarray, *,
    beta: int, digest: str, reverse_graph=None, telemetry=None,
    device="cuda",
) -> Path:
    """One lease's unit of hopset construction: bounded-hop rows for
    ``pivots[lease.start:lease.stop]``, committed as an ordinary
    digest-guarded npz artifact in the worker's shard dir (tmp +
    rename, the checkpoint discipline)."""
    sub = pivots[lease.start:lease.stop]
    fwd, rev, converged, examined = hs.build_pivot_rows(
        graph, sub, beta=beta, reverse_graph=reverse_graph,
        telemetry=telemetry, device=device,
    )
    shard_dir = coord.shard_dir(worker)
    shard_dir.mkdir(parents=True, exist_ok=True)
    path = _shard_path(shard_dir, lease.start, lease.stop)
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(
        tmp, start=np.array(lease.start), stop=np.array(lease.stop),
        pivots=np.asarray(sub, np.int64), fwd=fwd, rev=rev,
        converged=np.array(bool(converged)),
        examined=np.array(int(examined), np.int64),
        digest=np.array(digest), beta=np.array(int(beta)),
    )
    tmp.rename(path)
    return path


def merge_hopset_shards(
    directory: str | Path, graph, *, epsilon: float, seed: int = 0,
    picker: str = "uniform", expect_k: int | None = None,
) -> hs.Hopset:
    """Union the committed shard artifacts under ``directory`` (a
    coordinator dir) into one :class:`~ops.hopset.Hopset` — shards are
    ordered by their pivot-range start, digest-checked against
    ``graph``, and must tile ``[0, k)`` exactly (a gap means an
    uncommitted lease: fail loud, never serve a partial hopset)."""
    directory = Path(directory)
    digest = graph_digest(graph)
    shards = []
    for path in sorted(directory.glob(f"shards/*/{_SHARD_PREFIX}*.npz")):
        with np.load(path) as data:
            if str(data["digest"]) != digest:
                raise ValueError(
                    f"{path}: hopset shard built for a different graph "
                    "(digest mismatch)"
                )
            shards.append((
                int(data["start"]), int(data["stop"]),
                data["pivots"], data["fwd"], data["rev"],
                bool(data["converged"]), int(data["examined"]),
                int(data["beta"]),
            ))
    shards.sort(key=lambda s: s[0])
    expected = 0
    for start, stop, *_ in shards:
        if start != expected:
            raise ValueError(
                f"hopset shards do not tile the pivot range: expected "
                f"start {expected}, found {start}"
            )
        expected = stop
    if expect_k is not None and expected != expect_k:
        raise ValueError(
            f"hopset shards cover {expected} of {expect_k} pivots — "
            "uncommitted lease(s) outstanding"
        )
    if not shards:
        raise ValueError(f"{directory}: no committed hopset shards")
    beta = shards[0][7]
    return hs.Hopset(
        epsilon=float(epsilon), beta=beta,
        pivots=np.concatenate([s[2] for s in shards]),
        fwd=np.vstack([s[3] for s in shards]),
        rev=np.vstack([s[4] for s in shards]),
        converged=all(s[5] for s in shards),
        nonnegative=not graph.has_negative_weights,
        digest=digest, picker=picker, seed=int(seed),
        edges_examined=sum(s[6] for s in shards),
    )


def fleet_build_hopset(
    directory: str | Path, graph, *, n_workers: int = 2,
    epsilon: float = 0.1, k: int | None = None, beta: int | None = None,
    seed: int = 0, picker: str = "uniform", telemetry=None,
    device="cuda",
) -> hs.Hopset:
    """Fleet-sharded hopset construction, in-process (the fleet
    smoke idiom: same coordinator machinery — lease claims over the
    flock'd log, per-worker shard artifacts, commit records — minus
    subprocess spawn). The merged hopset is bitwise-identical to
    ``ops.hopset.build_hopset`` with the same (graph, ε, k, β, seed,
    picker) — asserted in the fleet tests."""
    from paralleljohnson_tpu_torch.distributed.coordinator import Coordinator
    from paralleljohnson_tpu_torch.serve.landmarks import pick_pivots

    t0 = time.perf_counter()
    v = graph.num_nodes
    k = hs.auto_num_pivots(v) if k is None else max(0, min(int(k), v))
    beta = hs.auto_beta(v, epsilon) if beta is None else int(beta)
    pivots = pick_pivots(graph, k, seed=seed, picker=picker)
    digest = graph_digest(graph)
    n_workers = max(1, int(n_workers))
    coord = Coordinator.create(
        directory, graph_spec=f"hopset:{digest[:12]}",
        graph_digest=digest, num_sources=len(pivots),
        lease_sources=max(1, -(-len(pivots) // n_workers)),
    )
    rg = graph.reverse()
    workers = [f"hopset-w{i}" for i in range(n_workers)]
    progress = True
    while progress:
        progress = False
        for w in workers:
            lease = coord.claim(w)
            if lease is None:
                continue
            build_hopset_shard(
                coord, w, lease, graph, pivots, beta=beta,
                digest=digest, reverse_graph=rg, telemetry=telemetry,
                device=device,
            )
            coord.commit(lease.lease_id, w)
            progress = True
    merged = merge_hopset_shards(
        coord.dir, graph, epsilon=epsilon, seed=seed, picker=picker,
        expect_k=len(pivots),
    )
    merged.construction_s = time.perf_counter() - t0
    return merged
