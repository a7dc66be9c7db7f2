"""Dirty-part repair: make a batch of edge updates cheap.

Given a solved ``--checkpoint-dir`` and a batch of edge updates, this
engine produces the POST-update checkpoint without a full re-solve, by
repairing along the condensed decomposition the persisted
:class:`~paralleljohnson_tpu_torch.incremental.state.IncrementalState`
tracks:

1. **Diagnose** — map each changed edge through the partition labels:
   a within-part change dirties that part's closure, a cross-part
   change dirties the boundary core. Everything else is clean by the
   digest-dependency argument (a part's closure depends only on its
   internal edges).
2. **Re-close** ONLY dirty parts (through the ordinary resilient
   solver — retries / watchdog / OOM degradation / fault injection all
   apply) and, when anything that feeds it changed, the boundary core.
3. **Re-expand only affected source ranges.** The affected set is
   computed from BITWISE comparisons of the recomputed factors against
   the cached ones, so "dirty" work that turned out not to change any
   distance (a reweighted edge that was never tight) shrinks the
   affected set to nothing:

   - sources in a part whose local closure changed, or whose boundary
     rows of the core changed, need FULL row re-expansion (their
     source-to-core distances moved);
   - sources in clean parts need only COLUMN patches at target parts
     whose outsider-visible block (``local[boundary_rows, :]``)
     changed — their source-to-core distances are bitwise unchanged,
     so every other column is provably identical;
   - if the boundary SET itself changed (cross edges appeared or
     vanished), everything re-expands — correct and rare.

4. **Commit** each repaired batch through the existing
   corruption-checked checkpoint writer (``checked_save``) into the NEW
   graph digest's subdirectory — batch files appear atomically
   (tmp+rename), so the repaired checkpoint swaps in per part while the
   old directory keeps serving stale-but-flagged answers
   (``incremental.status``).

**Exactness.** Repaired rows are the condensed decomposition's values;
copied rows are the old solver's values, kept only when the
decomposition proves them unchanged. On integer (exactly-representable)
weights every route agrees bitwise, so the repaired checkpoint is
bitwise-identical to a fresh full solve of the updated graph — asserted
by the property tests and the ``incremental_update`` bench. On general
f32 weights the repair agrees to the same ULP-level reassociation as
the condensed route itself. Negative-cycle detection is complete: a
new cycle must contain a changed edge, so it surfaces either closing
that edge's part or closing the recomputed core (if every recomputed
closure is bitwise unchanged and no cross edge changed, no cycle can
have appeared). Predecessor arrays are NOT repaired — a pred-bearing
checkpoint repairs distances only (re-solve with ``--predecessors``
for fresh trees).

**Devices.** Closures run on ``device`` (the card by default) through
one ordinary solver per operation: part closures take the sparse fan-out
(the ``fanout_sweep`` kernel on the card), the boundary core's dense
closure takes ``fw-tile`` where it is large enough. The expansion below
stays host numpy, as in the JAX package: its inputs are the cached host
closures, and its min over the same sums is the same on any device.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np

from paralleljohnson_tpu_torch.graphs import CSRGraph
from paralleljohnson_tpu_torch.incremental import status as repair_status
from paralleljohnson_tpu_torch.incremental.state import (
    IncrementalState,
    close_core,
    close_part,
    closure_solver,
    compute_core_digest,
    compute_part_digest,
    _within_selector,
)
from paralleljohnson_tpu_torch.utils.checkpoint import (
    BatchCheckpointer,
    checked_save,
    graph_digest,
)
from paralleljohnson_tpu_torch.observe.live import resolve_metrics as _resolve_metrics
from paralleljohnson_tpu_torch.observe.trace import trace_attrs as _trace_attrs
from paralleljohnson_tpu_torch.utils.telemetry import resolve as _resolve_telemetry

ROUTE_TAG = "incremental-repair"


def _np_minplus(d: np.ndarray, a: np.ndarray, *, b_block: int = 128,
                k_block: int = 128, n_block: int = 512) -> np.ndarray:
    """Blocked host-side min-plus product ``out[i, j] = min_k d[i, k] +
    a[k, j]`` — the repair expansion kernel. Host numpy, as in the JAX
    package, not the card's min-plus kernel: repair's inputs (cached
    closures) already live on the host, the row workload is one-shot per
    update batch, and the result is bitwise-identical anyway — the min
    ranges over the exact same multiset of f32 sums regardless of
    blocking or device (a card route would be a speed change). Blocks bound the broadcast temp to
    ``b_block x k_block x n_block`` floats."""
    out = np.full((d.shape[0], a.shape[1]), np.inf,
                  dtype=np.result_type(d, a))
    for b0 in range(0, d.shape[0], b_block):
        db = d[b0:b0 + b_block]
        for n0 in range(0, a.shape[1], n_block):
            ab = a[:, n0:n0 + n_block]
            acc = out[b0:b0 + b_block, n0:n0 + n_block]
            for k0 in range(0, d.shape[1], k_block):
                cand = (
                    db[:, k0:k0 + k_block, None]
                    + ab[None, k0:k0 + k_block, :]
                )
                np.minimum(acc, cand.min(axis=1), out=acc)
    return out


def _np_minplus_macs(b: int, k: int, n: int) -> int:
    """Exact candidate ops of one host min-plus product (unpadded — the
    host kernel performs no pad no-ops, so none are counted)."""
    return int(b) * int(k) * int(n)


@dataclasses.dataclass
class DirtySet:
    """The diagnosis: which closures a batch of changed edges
    invalidates (digest-level reasoning over the partition — no solve
    work; what the CLI's ``update --dry-run`` and ``info`` print)."""

    num_parts: int
    dirty_parts: list
    within_changed: dict
    cross_changed: int
    core_dirty: bool

    def as_dict(self) -> dict:
        return {
            "num_parts": self.num_parts,
            "dirty_parts": [int(p) for p in self.dirty_parts],
            "within_changed": {
                str(k): int(v) for k, v in sorted(self.within_changed.items())
            },
            "cross_changed": self.cross_changed,
            "core_dirty": self.core_dirty,
        }


def diagnose(state: IncrementalState, changed_edges) -> DirtySet:
    """Map changed edges to the minimal dirty set through the
    partition labels (see class docstring)."""
    labels = state.labels
    within: dict[int, int] = {}
    cross = 0
    for (u, v, _old, _new) in changed_edges:
        if labels[u] == labels[v]:
            p = int(labels[u])
            within[p] = within.get(p, 0) + 1
        else:
            cross += 1
    return DirtySet(
        num_parts=state.num_parts,
        dirty_parts=sorted(within),
        within_changed=within,
        cross_changed=cross,
        core_dirty=cross > 0,
    )


@dataclasses.dataclass
class RepairResult:
    """What one repair did (``as_dict`` is the CLI/bench surface)."""

    old_digest: str
    new_digest: str
    trivial: bool
    parts_total: int
    dirty_parts_closed: int
    core_recomputed: bool
    boundary_changed: bool
    full_row_parts: list
    col_parts: list
    affected_rows: int
    rows_recomputed: int
    rows_patched: int
    rows_copied: int
    batches_rewritten: int
    expand_macs: int
    closures_s: float
    expand_s: float
    io_s: float
    wall_s: float
    diag: DirtySet | None = None
    plan: dict | None = None

    def as_dict(self) -> dict:
        out = {
            k: getattr(self, k)
            for k in (
                "old_digest", "new_digest", "trivial", "parts_total",
                "dirty_parts_closed", "core_recomputed", "boundary_changed",
                "affected_rows", "rows_recomputed", "rows_patched",
                "rows_copied", "batches_rewritten", "expand_macs",
            )
        }
        out["full_row_parts"] = [int(p) for p in self.full_row_parts]
        out["col_parts"] = [int(p) for p in self.col_parts]
        for k in ("closures_s", "expand_s", "io_s", "wall_s"):
            out[k] = round(float(getattr(self, k)), 6)
        if self.diag is not None:
            out["dirty_set"] = self.diag.as_dict()
        if self.plan is not None:
            out["plan"] = self.plan
        return out


# -- repair-vs-resolve plan registry ------------------------------------------
#
# Whether an update batch is cheaper to REPAIR (dirty-part closures +
# affected-row re-expansion) or to RE-SOLVE outright is the same priced
# ``select()`` walk as every dispatch decision, with each
# side priced at its HONEST work unit via ``Plan.price_batch``: repair
# at the estimated affected-row count (from the digest-level diagnosis
# — no closure work is paid before the decision), resolve at B=V. The
# ``kind:"repair"`` records every repair lands (route
# ``incremental-repair``) are the calibration that makes the repair
# side priceable. Unpriced, priority order keeps the old behavior:
# repair first, always.


REPAIR_PLANS = [
    # Imported lazily below to keep module import order stable; filled
    # at first use via _repair_plans().
]


def _repair_plans():
    if REPAIR_PLANS:
        return REPAIR_PLANS
    from paralleljohnson_tpu_torch import planner as _planner

    REPAIR_PLANS.extend([
        _planner.Plan(
            name="repair", entry="repair", priority=10,
            qualify=lambda ctx: (
                True, "dirty-part repair is the incremental default"
            ),
            price_routes=("incremental-repair",),
            forced=lambda cfg: getattr(
                cfg, "repair_strategy", "auto") == "repair",
            force_overrides={"repair_strategy": "repair"},
            price_batch=lambda ctx: max(1, int(ctx.affected_rows)),
            tunables=("partition_parts",),
        ),
        _planner.Plan(
            name="resolve", entry="repair", priority=20,
            qualify=lambda ctx: (True, "full re-solve always qualifies"),
            price_routes=(
                "vm-blocked+dw", "vm-blocked", "gs", "dia", "vm",
                "sweep-sm",
            ),
            forced=lambda cfg: getattr(
                cfg, "repair_strategy", "auto") == "resolve",
            force_overrides={"repair_strategy": "resolve"},
            price_batch=lambda ctx: int(ctx.num_nodes),
        ),
    ])
    return REPAIR_PLANS


def estimate_affected_rows(state, diag, num_nodes: int) -> int:
    """Digest-level UPPER BOUND on the rows a repair would re-expand,
    before any closure runs: rows in dirty parts re-expand fully; a
    dirty core (cross-part change) conservatively touches everything
    (the bitwise affected-set refinement needs the closures we are
    deciding whether to pay for). No state → no decomposition to
    repair along → everything."""
    if state is None or diag is None:
        return int(num_nodes)
    if diag.core_dirty:
        return int(num_nodes)
    parts, _lids, _bl, _bc = state.indices()
    part_pos = {int(p): i for i, p in enumerate(state.part_ids)}
    rows = sum(
        int(parts[part_pos[int(p)]].size)
        for p in diag.dirty_parts if int(p) in part_pos
    )
    return min(int(num_nodes), rows)


def decide_repair_strategy(
    checkpoint_dir,
    graph: CSRGraph,
    report,
    *,
    config=None,
    state: IncrementalState | None = None,
    strategy: str = "auto",
    device="cuda",
):
    """Walk :data:`REPAIR_PLANS` for one update batch. ``report`` is
    the ``apply_edge_updates`` report (old/new digests + changed
    edges). Returns the ``PlanDecision``; unpriced it always chooses
    ``repair`` (asserted by the parity test). ``strategy`` pins a side
    ("repair"/"resolve") through the ordinary forced-plan mechanism.
    Prices are read for ``device``'s platform."""
    import types as _types

    from paralleljohnson_tpu_torch import planner as _planner
    from paralleljohnson_tpu_torch.config import SolverConfig
    from paralleljohnson_tpu_torch.observe import current_platform

    cfg = config if config is not None else SolverConfig()
    if strategy not in ("auto", "repair", "resolve"):
        raise ValueError(
            f"repair strategy must be auto/repair/resolve, got {strategy!r}"
        )
    if state is None:
        old_ckpt = BatchCheckpointer(
            checkpoint_dir, graph_key=report.old_digest
        )
        try:
            state = IncrementalState.load(
                old_ckpt.dir, expect_digest=report.old_digest
            )
        except Exception:  # noqa: BLE001 — unreadable state = no state
            state = None
    diag = (
        diagnose(state, report.changed_edges) if state is not None else None
    )
    v = graph.num_nodes
    affected = estimate_affected_rows(state, diag, v)
    ctx = _types.SimpleNamespace(
        state=state, diag=diag, affected_rows=affected, num_nodes=v,
        config=cfg, params={},
    )
    model = None
    if getattr(cfg, "planner", True) is not False:
        from paralleljohnson_tpu_torch.observe.costs import resolve_profile_dir
        from paralleljohnson_tpu_torch.observe.tuning import cached_records

        store_dir = resolve_profile_dir(
            getattr(cfg, "profile_store", None)
        )
        records = cached_records(store_dir) if store_dir else []
        if records:
            from paralleljohnson_tpu_torch.observe.store import CostModel

            try:
                model = CostModel.fit(records)
            except Exception:  # noqa: BLE001 — unreadable = unpriced
                model = None
    decision = _planner.select(
        _repair_plans(), ctx, model=model, platform=current_platform(device),
        num_edges=graph.num_real_edges, batch=max(1, affected),
        config=_types.SimpleNamespace(repair_strategy=strategy),
    )
    decision.params.update(
        affected_rows_estimate=int(affected),
        dirty_parts=len(diag.dirty_parts) if diag is not None else None,
    )
    return decision


class RepairPlan:
    """Everything between diagnosis and batch rewriting: the recomputed
    factors, the affected-set classification, and the per-row repair
    primitives the serial engine AND the repair fleet share."""

    def __init__(self, *, checkpoint_root, old_graph, new_graph, report,
                 state_old, config, telemetry, device="cuda") -> None:
        self.checkpoint_root = Path(checkpoint_root)
        self.old_graph = old_graph
        self.new_graph = new_graph
        self.report = report
        self.state_old = state_old
        self.state_new: IncrementalState | None = None
        self.config = config
        self.tel = telemetry
        self.device = device
        self.diag: DirtySet | None = None
        self.trivial = report.num_changed == 0
        self.boundary_changed = False
        self.core_recomputed = False
        self.full_row_parts: set[int] = set()   # positions into part_ids
        self.col_parts: set[int] = set()        # positions into part_ids
        self.full_mask = np.zeros(old_graph.num_nodes, bool)
        self.closures_s = 0.0
        self.expand_s = 0.0
        self.expand_macs = 0
        digest = report.old_digest
        self.old_ckpt = BatchCheckpointer(checkpoint_root, graph_key=digest)
        self.new_ckpt: BatchCheckpointer | None = None

    # -- affected-set surface ------------------------------------------------

    @property
    def patch_all(self) -> bool:
        """True when every non-full row still needs column patches."""
        return bool(self.col_parts)

    def affected_sources(self):
        """``"all"`` or the sorted array of sources whose rows may
        change — the staleness set the serve layer flags."""
        if self.trivial:
            return np.array([], np.int64)
        if self.patch_all or self.full_mask.all():
            return "all"
        return np.flatnonzero(self.full_mask).astype(np.int64)

    def row_action(self, source: int) -> str:
        """``"recompute"`` / ``"patch"`` / ``"copy"`` for one row."""
        if self.full_mask[int(source)]:
            return "recompute"
        return "patch" if self.patch_all else "copy"

    # -- row repair primitives ----------------------------------------------

    def recompute_rows(self, sources) -> np.ndarray:
        """Full expansion of the given sources' rows from the NEW
        state's factors — arithmetic-identical to the condensed route's
        expansion stage (same candidate-path enumeration; the host
        min-plus takes the min over the identical sum multiset), so
        integer-weight rows land bitwise where a fresh solve would."""
        _mp, _mp_macs = _np_minplus, _np_minplus_macs
        st = self.state_new
        parts, lids, blocal, bcore = st.indices()
        sources = np.asarray(sources, np.int64)
        v = len(st.labels)
        nc = st.boundary.size
        t0 = time.perf_counter()
        dist = np.full((sources.size, v), np.inf,
                       dtype=self.new_graph.dtype)
        part_pos = {int(p): i for i, p in enumerate(st.part_ids)}
        by_part: dict[int, list[int]] = {}
        for i, s in enumerate(sources):
            by_part.setdefault(int(st.labels[s]), []).append(i)
        for p, rows in sorted(by_part.items()):
            pi = part_pos[p]
            rows = np.asarray(rows, np.int64)
            verts = parts[pi]
            ls = lids[sources[rows]]
            local_p = st.locals_closed[pi]
            dist[np.ix_(rows, verts)] = local_p[ls]
            if nc == 0 or blocal[pi].size == 0:
                continue  # no way out of this part: local rows are final
            s2core = _mp(
                local_p[np.ix_(ls, blocal[pi])], st.core_closed[bcore[pi]]
            )
            self.expand_macs += _mp_macs(rows.size, blocal[pi].size, nc)
            for qi, verts_q in enumerate(parts):
                if blocal[qi].size == 0:
                    continue  # no way into q from outside
                upd = _mp(
                    s2core[:, bcore[qi]], st.locals_closed[qi][blocal[qi]]
                )
                self.expand_macs += _mp_macs(
                    rows.size, blocal[qi].size, verts_q.size
                )
                dist[np.ix_(rows, verts_q)] = np.minimum(
                    dist[np.ix_(rows, verts_q)], upd
                )
        self.expand_s += time.perf_counter() - t0
        return dist

    def patch_rows(self, sources, rows: np.ndarray) -> np.ndarray:
        """Column patches (in place) for CLEAN-part rows: replace the
        columns of every part whose outsider-visible block changed.
        These sources' source-to-core distances are bitwise unchanged
        (that is what kept them out of the full set), so the patched
        columns are the complete decomposition value — a replace, not a
        min against stale data — and every other column is provably
        identical to the old row."""
        _mp, _mp_macs = _np_minplus, _np_minplus_macs
        if not self.col_parts:
            return rows
        st = self.state_new
        parts, lids, blocal, bcore = st.indices()
        sources = np.asarray(sources, np.int64)
        t0 = time.perf_counter()
        part_pos = {int(p): i for i, p in enumerate(st.part_ids)}
        by_part: dict[int, list[int]] = {}
        for i, s in enumerate(sources):
            if not self.full_mask[int(s)]:
                by_part.setdefault(int(st.labels[s]), []).append(i)
        for p, ridx in sorted(by_part.items()):
            qi = part_pos[p]
            if blocal[qi].size == 0:
                continue  # no escape from this part: cross columns stay inf
            ridx = np.asarray(ridx, np.int64)
            ls = lids[sources[ridx]]
            s2core = _mp(
                st.locals_closed[qi][np.ix_(ls, blocal[qi])],
                st.core_closed[bcore[qi]],
            )
            self.expand_macs += _mp_macs(
                ridx.size, blocal[qi].size, st.boundary.size
            )
            for pi in sorted(self.col_parts):
                if blocal[pi].size == 0:
                    continue
                upd = _mp(
                    s2core[:, bcore[pi]], st.locals_closed[pi][blocal[pi]]
                )
                self.expand_macs += _mp_macs(
                    ridx.size, blocal[pi].size, parts[pi].size
                )
                rows[np.ix_(ridx, parts[pi])] = upd
        self.expand_s += time.perf_counter() - t0
        return rows

    def repair_batch_rows(self, sources, old_rows: np.ndarray | None):
        """One batch's repaired rows + (recomputed, patched, copied)
        counts. ``old_rows=None`` (corrupt/unreadable old batch) falls
        back to recomputing every row — degraded, never wrong."""
        sources = np.asarray(sources, np.int64)
        if old_rows is None:
            rows = self.recompute_rows(sources)
            return rows, (sources.size, 0, 0)
        rows = np.array(old_rows, copy=True)
        full_sel = self.full_mask[sources]
        patched = 0
        if self.patch_all and (~full_sel).any():
            rows = self.patch_rows(sources, rows)
            patched = int((~full_sel).sum())
        if full_sel.any():
            rows[full_sel] = self.recompute_rows(sources[full_sel])
        n_full = int(full_sel.sum())
        copied = sources.size - n_full - patched
        return rows, (n_full, patched, copied)


def prepare_repair(
    checkpoint_dir,
    graph: CSRGraph,
    updates,
    *,
    config=None,
    state: IncrementalState | None = None,
    num_parts: int | None = None,
    seed: int = 0,
    device="cuda",
) -> RepairPlan:
    """Diagnose + re-close (steps 1-3 of the module docstring) on
    ``device``. Returns the plan whose row primitives the serial engine
    or a repair fleet then drives; the repair status marker is live
    (``repairing``) from the moment closures start."""
    from paralleljohnson_tpu_torch.config import SolverConfig
    from paralleljohnson_tpu_torch.solver.johnson import NegativeCycleError

    cfg = config if config is not None else SolverConfig()
    tel = _resolve_telemetry(getattr(cfg, "telemetry", None))
    old_digest = graph_digest(graph)
    new_graph, report = graph.apply_edge_updates(updates)
    plan = RepairPlan(
        checkpoint_root=checkpoint_dir, old_graph=graph,
        new_graph=new_graph, report=report, state_old=None,
        config=cfg, telemetry=tel, device=device,
    )
    if not plan.old_ckpt.manifest():
        raise ValueError(
            f"{plan.old_ckpt.dir}: no completed batches for this graph "
            "(digest mismatch, or the solve never checkpointed here) — "
            "nothing to repair"
        )
    if plan.trivial:
        plan.state_new = state
        return plan

    v = graph.num_nodes
    with tel.span("repair_prepare", changed=report.num_changed,
                  **_trace_attrs()):
        # Conservative staleness from the first moment repair work runs;
        # refined to the exact affected set once closures land.
        repair_status.write_repair_status(
            plan.old_ckpt.dir, status="repairing",
            new_digest=report.new_digest, affected="all", total_sources=v,
        )
        if state is None:
            state = IncrementalState.load(
                plan.old_ckpt.dir, expect_digest=old_digest
            )
        if state is None:
            with tel.span("incremental_build"):
                state = IncrementalState.build(
                    graph, num_parts=num_parts, seed=seed, config=cfg,
                    device=device,
                )
                state.save(plan.old_ckpt.dir)
        elif state.graph_digest != old_digest:
            raise ValueError(
                f"incremental state digest {state.graph_digest} does not "
                f"match the graph being updated ({old_digest})"
            )
        plan.state_old = state
        plan.diag = diagnose(state, report.changed_edges)
        tel.event("dirty_set", **plan.diag.as_dict())
        tel.progress(op="repair", parts_total=state.num_parts,
                     dirty_parts=len(plan.diag.dirty_parts))

        parts, lids, blocal, bcore = state.indices()
        e2 = new_graph.num_real_edges
        src2 = new_graph.src[:e2]
        dst2 = new_graph.indices[:e2]
        w2 = new_graph.weights[:e2]
        labels = state.labels
        part_pos = {int(p): i for i, p in enumerate(state.part_ids)}

        t0 = time.perf_counter()
        new_locals = list(state.locals_closed)
        new_digests = list(state.part_digests)
        changed_local: dict[int, bool] = {}
        sub_solver = closure_solver(cfg, device=device)
        try:
            for p in plan.diag.dirty_parts:
                pi = part_pos[int(p)]
                sel = _within_selector(labels, src2, dst2, p)
                with tel.span("repair_close_part", part=int(p),
                              vertices=int(parts[pi].size)):
                    new_local = close_part(
                        new_graph, parts[pi], lids, sel, config=cfg,
                        solver=sub_solver,
                    )
                changed_local[pi] = not np.array_equal(
                    state.locals_closed[pi], new_local
                )
                new_locals[pi] = new_local
                new_digests[pi] = compute_part_digest(
                    parts[pi], lids, src2, dst2, w2, sel
                )

            cross2 = labels[src2] != labels[dst2]
            boundary_mask = np.zeros(v, bool)
            boundary_mask[src2[cross2]] = True
            boundary_mask[dst2[cross2]] = True
            boundary2 = np.flatnonzero(boundary_mask)
            plan.boundary_changed = not np.array_equal(
                boundary2, state.boundary
            )

            state_new = IncrementalState(
                graph_digest=report.new_digest,
                seed=state.seed,
                labels=labels,
                part_ids=state.part_ids,
                part_digests=new_digests,
                core_digest=compute_core_digest(
                    boundary2, src2, dst2, w2, cross2
                ),
                boundary=boundary2,
                locals_closed=new_locals,
                core_closed=state.core_closed,
            )
            need_core = (
                plan.diag.cross_changed > 0
                or any(changed_local.values())
                or plan.boundary_changed
            )
            if need_core:
                with tel.span("repair_close_core",
                              boundary=int(boundary2.size)):
                    state_new.core_closed = close_core(
                        state_new, new_graph, config=cfg,
                        solver=sub_solver,
                    )
                plan.core_recomputed = True
        except NegativeCycleError:
            repair_status.write_repair_status(
                plan.old_ckpt.dir, status="failed",
                new_digest=report.new_digest, affected="all",
                total_sources=v, reason="negative cycle created by update",
            )
            raise
        plan.closures_s = time.perf_counter() - t0
        plan.state_new = state_new

        # -- affected-set classification (bitwise, see module docstring)
        k = state.num_parts
        if plan.boundary_changed:
            plan.full_row_parts = set(range(k))
            plan.col_parts = set()
        else:
            core_rows_changed = [False] * k
            if plan.core_recomputed:
                for qi in range(k):
                    rows = bcore[qi]
                    core_rows_changed[qi] = not np.array_equal(
                        state.core_closed[rows],
                        state_new.core_closed[rows],
                    )
            plan.full_row_parts = {
                pi for pi, ch in changed_local.items() if ch
            } | {qi for qi in range(k) if core_rows_changed[qi]}
            plan.col_parts = {
                pi for pi, ch in changed_local.items()
                if ch and not np.array_equal(
                    state.locals_closed[pi][blocal[pi]],
                    new_locals[pi][blocal[pi]],
                )
            }
        for pi in plan.full_row_parts:
            plan.full_mask[parts[pi]] = True

        repair_status.write_repair_status(
            plan.old_ckpt.dir, status="repairing",
            new_digest=report.new_digest,
            affected=plan.affected_sources(), total_sources=v,
            dirty_parts=len(plan.diag.dirty_parts),
            parts_total=k,
        )
    plan.new_ckpt = BatchCheckpointer(
        plan.checkpoint_root, graph_key=report.new_digest
    )
    return plan


def finish_repair(plan: RepairPlan) -> None:
    """Publish the terminal artifacts: the NEW graph's incremental
    state (so the next update chains without a rebuild) and the
    ``done`` status on the old directory (its affected rows stay
    flagged forever — they can never become current there)."""
    if plan.state_new is not None and plan.new_ckpt is not None:
        plan.state_new.save(plan.new_ckpt.dir)
    repair_status.write_repair_status(
        plan.old_ckpt.dir, status="done",
        new_digest=plan.report.new_digest,
        affected=plan.affected_sources(), remaining=[],
        total_sources=plan.old_graph.num_nodes,
        dirty_parts=len(plan.diag.dirty_parts) if plan.diag else 0,
        parts_total=plan.state_old.num_parts if plan.state_old else 0,
    )


def execute_repair(plan: RepairPlan) -> RepairResult:
    """Serial batch loop over the old checkpoint's manifest: repair
    each batch's rows and commit through ``checked_save`` into the new
    digest's subdirectory (atomic per batch — the per-part swap)."""
    t_start = time.perf_counter()
    tel = plan.tel
    if plan.trivial:
        return RepairResult(
            old_digest=plan.report.old_digest,
            new_digest=plan.report.new_digest,
            trivial=True,
            parts_total=(
                plan.state_new.num_parts if plan.state_new is not None else 0
            ),
            dirty_parts_closed=0, core_recomputed=False,
            boundary_changed=False, full_row_parts=[], col_parts=[],
            affected_rows=0, rows_recomputed=0, rows_patched=0,
            rows_copied=0, batches_rewritten=0, expand_macs=0,
            closures_s=0.0, expand_s=0.0, io_s=0.0,
            wall_s=time.perf_counter() - t_start, diag=plan.diag,
        )
    live = _resolve_metrics(getattr(plan.config, "metrics", None))
    manifest = plan.old_ckpt.manifest()
    files: dict[str, int] = {}
    for _s, (batch_idx, filename) in manifest.items():
        files[filename] = int(batch_idx)
    affected = plan.affected_sources()
    remaining = (
        set() if isinstance(affected, str)
        else {int(s) for s in affected}
    )
    n_re = n_patch = n_copy = 0
    io_s = 0.0
    v = plan.old_graph.num_nodes
    with tel.span("repair_expand", batches=len(files)):
        for i, filename in enumerate(sorted(files)):
            batch_idx = files[filename]
            sources = plan.old_ckpt.batch_sources(filename)
            if sources is None:
                continue  # manifest entry vanished under us: nothing to do
            loaded = plan.old_ckpt.load(batch_idx, sources)
            old_rows = None if loaded is None else loaded[0]
            with tel.span("repair_batch", batch=batch_idx,
                          n_sources=int(sources.size)):
                rows, (re_, pa, co) = plan.repair_batch_rows(
                    sources, old_rows
                )
                t0 = time.perf_counter()
                checked_save(plan.new_ckpt, batch_idx, sources, rows)
                io_s += time.perf_counter() - t0
            n_re += re_
            n_patch += pa
            n_copy += co
            if remaining:
                remaining -= {int(s) for s in sources}
                repair_status.write_repair_status(
                    plan.old_ckpt.dir, status="repairing",
                    new_digest=plan.report.new_digest,
                    affected=affected, remaining=sorted(remaining),
                    total_sources=v,
                    dirty_parts=len(plan.diag.dirty_parts),
                    parts_total=plan.state_old.num_parts,
                )
            tel.progress(op="repair", batches_done=i + 1,
                         batches_total=len(files))
    finish_repair(plan)
    affected_rows = (
        int(plan.full_mask.sum()) if not plan.patch_all
        else v
    )
    result = RepairResult(
        old_digest=plan.report.old_digest,
        new_digest=plan.report.new_digest,
        trivial=False,
        parts_total=plan.state_new.num_parts,
        dirty_parts_closed=len(plan.diag.dirty_parts),
        core_recomputed=plan.core_recomputed,
        boundary_changed=plan.boundary_changed,
        full_row_parts=sorted(
            int(plan.state_new.part_ids[pi]) for pi in plan.full_row_parts
        ),
        col_parts=sorted(
            int(plan.state_new.part_ids[pi]) for pi in plan.col_parts
        ),
        affected_rows=affected_rows,
        rows_recomputed=n_re, rows_patched=n_patch, rows_copied=n_copy,
        batches_rewritten=len(files),
        expand_macs=int(plan.expand_macs),
        closures_s=plan.closures_s, expand_s=plan.expand_s, io_s=io_s,
        wall_s=time.perf_counter() - t_start,
        diag=plan.diag,
    )
    # Live metrics: repair wall into the streaming histogram and the
    # exact dirty-part accounting as gauges, so the top view (and a
    # fleet worker's snapshot, when repairs run under one) shows repair
    # health alongside serve/solve health.
    live.histogram("pjtpu_repair_wall_ms").record(result.wall_s * 1e3)
    live.counter("pjtpu_repairs").add(1)
    live.counter("pjtpu_repair_rows_recomputed").add(result.rows_recomputed)
    live.gauge("pjtpu_repair_dirty_parts", result.dirty_parts_closed)
    live.gauge("pjtpu_repair_parts_total", result.parts_total)
    _append_profile_record(plan, result)
    return result


def repair_checkpoint(
    checkpoint_dir,
    graph: CSRGraph,
    updates,
    *,
    config=None,
    state: IncrementalState | None = None,
    num_parts: int | None = None,
    seed: int = 0,
    strategy: str = "auto",
    device="cuda",
) -> RepairResult:
    """Prepare + execute one repair (the CLI's ``update`` entry), its
    closures (or the re-solve) on ``device``.

    ``strategy``: ``"auto"`` prices repair-vs-resolve through
    :data:`REPAIR_PLANS` from the learned ``kind:"repair"`` records
    BEFORE any closure work is paid — a cheaper full re-solve skips the
    repair machinery entirely; ``"repair"``/``"resolve"`` pin a side.
    Unpriced auto always repairs."""
    from paralleljohnson_tpu_torch.config import SolverConfig

    cfg = config if config is not None else SolverConfig()
    decision = None
    if strategy != "repair":
        # Pre-compute the update report once for the decision; the
        # repair path re-derives it inside prepare_repair (host-side
        # CSR rebuild — linear, and correctness-critical to keep in
        # one place there).
        _, report = graph.apply_edge_updates(updates)
        if report.num_changed:
            decision = decide_repair_strategy(
                checkpoint_dir, graph, report, config=cfg, state=state,
                strategy=strategy, device=device,
            )
    if decision is not None and decision.chosen.plan.name == "resolve":
        return _resolve_checkpoint(
            checkpoint_dir, graph, updates, config=cfg, decision=decision,
            device=device,
        )
    plan = prepare_repair(
        checkpoint_dir, graph, updates, config=cfg, state=state,
        num_parts=num_parts, seed=seed, device=device,
    )
    # A repair driven on behalf of a traced update request joins that
    # request's timeline; {} on every untraced/offline path.
    with plan.tel.span("repair", changed=plan.report.num_changed,
                       **_trace_attrs()):
        result = execute_repair(plan)
    if decision is not None:
        result.plan = decision.as_dict(built="repair")
    return result


def _resolve_checkpoint(
    checkpoint_dir,
    graph: CSRGraph,
    updates,
    *,
    config,
    decision,
    device="cuda",
) -> RepairResult:
    """The priced re-solve side of the repair-vs-resolve walk: solve
    the updated graph through the ordinary solver straight into the
    NEW digest's checkpoint subtree (same layout a repair commits to),
    then finish like a repair — status ``done``, stale rows cleared.
    The solve itself lands the usual ``kind:"solve"`` records, so the
    decision keeps calibrating from real walls on both sides."""
    t_start = time.perf_counter()
    from paralleljohnson_tpu_torch.solver.johnson import ParallelJohnsonSolver

    new_graph, report = graph.apply_edge_updates(updates)
    v = new_graph.num_nodes
    old_ckpt = BatchCheckpointer(checkpoint_dir, graph_key=report.old_digest)
    repair_status.write_repair_status(
        old_ckpt.dir, status="repairing", new_digest=report.new_digest,
        affected="all", total_sources=v,
    )
    cfg = dataclasses.replace(config, checkpoint_dir=str(checkpoint_dir))
    t0 = time.perf_counter()
    ParallelJohnsonSolver(cfg, device=device).solve(new_graph)
    solve_s = time.perf_counter() - t0
    new_ckpt = BatchCheckpointer(checkpoint_dir, graph_key=report.new_digest)
    repair_status.write_repair_status(
        old_ckpt.dir, status="done", new_digest=report.new_digest,
        affected="all", remaining=[], total_sources=v,
    )
    result = RepairResult(
        old_digest=report.old_digest, new_digest=report.new_digest,
        trivial=False, parts_total=0, dirty_parts_closed=0,
        core_recomputed=False, boundary_changed=False,
        full_row_parts=[], col_parts=[], affected_rows=v,
        rows_recomputed=v, rows_patched=0, rows_copied=0,
        batches_rewritten=len(new_ckpt.manifest()), expand_macs=0,
        closures_s=0.0, expand_s=solve_s, io_s=0.0,
        wall_s=time.perf_counter() - t_start,
        plan=decision.as_dict(built="resolve"),
    )
    return result


def _append_profile_record(plan: RepairPlan, result: RepairResult) -> None:
    """One ``kind: "repair"`` profile-store record per repair, so the
    cost model learns repair-vs-resolve pricing (``CostModel.fit``
    accepts the kind; route ``incremental-repair`` sits in the same
    priced table as every solve route). Observability must never fail a
    repair that already committed correct rows."""
    try:
        from paralleljohnson_tpu_torch.observe import current_platform
        from paralleljohnson_tpu_torch.observe.costs import resolve_profile_dir
        from paralleljohnson_tpu_torch.observe.store import ProfileStore

        store_dir = resolve_profile_dir(
            getattr(plan.config, "profile_store", None)
        )
        if not store_dir:
            return
        ProfileStore(store_dir).append({
            "ts": time.time(),
            "kind": "repair",
            "label": "repair",
            "route": ROUTE_TAG,
            "platform": current_platform(plan.device),
            "nodes": int(plan.new_graph.num_nodes),
            "edges": int(plan.new_graph.num_real_edges),
            "batch": max(1, int(result.affected_rows)),
            "measured": {
                "wall_s": float(result.wall_s),
                "compute_s": float(result.closures_s + result.expand_s),
                "phase_seconds": {
                    "close": float(result.closures_s),
                    "expand": float(result.expand_s),
                    "io": float(result.io_s),
                },
            },
            "edges_relaxed": int(result.expand_macs),
            "repair": result.as_dict(),
            "cost": {
                "cost_analysis_unavailable":
                    "repair composes cached closures; no single compiled "
                    "executable to harvest"
            },
        })
    except Exception:  # noqa: BLE001 — observability is never fatal
        pass
