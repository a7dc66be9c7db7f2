"""Repair sharding through the fleet's lease coordinator.

A repair's row regeneration is embarrassingly parallel once the plan's
closures are in hand, so it shards exactly like any other solve: the
work list (every source whose row needs recomputation or patching, in
sorted order) is cut into contiguous LEASES of a
:class:`~paralleljohnson_tpu_torch.distributed.coordinator.Coordinator` plan
(``graph_spec = "repair:<new digest>"``), workers claim leases through
the same flock'd transition log — deadline lapse, heartbeat liveness,
requeue-to-survivors, and the CLI's ``fleet status`` introspection all
apply unchanged — and each committed lease's rows land as one
atomically-published batch file in the NEW digest's checkpoint
subdirectory. Unaffected rows are copied by the caller (no compute to
shard), and ``finish_repair`` publishes the terminal state exactly as
the serial engine does.

``run_in_process_repair_fleet`` drives N workers sequentially in this
process — the tier-1 twin of a real multi-process repair fleet, same
machinery minus subprocess spawn (mirroring
``distributed.launch.run_in_process_fleet``).
"""

from __future__ import annotations

import numpy as np

from paralleljohnson_tpu_torch.incremental.repair import (
    RepairPlan,
    RepairResult,
    execute_repair,
    finish_repair,
    prepare_repair,
)
from paralleljohnson_tpu_torch.utils.checkpoint import checked_save

# Lease-written batch files use indices in this range so they can never
# shadow a copied original batch index in diagnostics (filenames are
# unique either way — the sources digest is in the name).
REPAIR_LEASE_BATCH_BASE = 100_000


def _work_sources(plan: RepairPlan) -> tuple[np.ndarray, np.ndarray]:
    """``(work, copy)``: manifest-covered sources that need compute
    (recompute or patch) vs bitwise copies, both sorted."""
    manifest_sources = np.array(sorted(plan.old_ckpt.manifest()), np.int64)
    if manifest_sources.size == 0:
        return manifest_sources, manifest_sources
    needs = np.array(
        [plan.row_action(int(s)) != "copy" for s in manifest_sources], bool
    )
    return manifest_sources[needs], manifest_sources[~needs]


def _rows_for(plan: RepairPlan, sources: np.ndarray) -> np.ndarray:
    """Repaired rows for an arbitrary source subset: old rows fetched
    batch-wise through the manifest (corruption-checked), then repaired
    through the plan's primitives. A source whose old batch is corrupt
    falls back to full recomputation."""
    manifest = plan.old_ckpt.manifest()
    v = plan.old_graph.num_nodes
    old_rows = np.full((sources.size, v), np.nan, plan.new_graph.dtype)
    missing = np.ones(sources.size, bool)
    by_file: dict[str, list[int]] = {}
    for i, s in enumerate(sources):
        entry = manifest.get(int(s))
        if entry is not None:
            by_file.setdefault(entry[1], []).append(i)
    for filename, idxs in by_file.items():
        batch_sources = plan.old_ckpt.batch_sources(filename)
        if batch_sources is None:
            continue
        loaded = plan.old_ckpt.load(
            int(manifest[int(sources[idxs[0]])][0]), batch_sources
        )
        if loaded is None:
            continue
        rows, _ = loaded
        pos = {int(s): j for j, s in enumerate(batch_sources)}
        for i in idxs:
            old_rows[i] = rows[pos[int(sources[i])]]
            missing[i] = False
    out = np.array(old_rows, copy=True)
    if (~missing).any():
        sel = ~missing
        patched = plan.patch_rows(sources[sel], out[sel])
        out[sel] = patched
    full_sel = plan.full_mask[sources] | missing
    if full_sel.any():
        out[full_sel] = plan.recompute_rows(sources[full_sel])
    return out


def run_in_process_repair_fleet(
    checkpoint_dir,
    graph,
    updates,
    *,
    coordinator_dir,
    workers: int = 2,
    lease_rows: int | None = None,
    config=None,
    state=None,
    num_parts: int | None = None,
    seed: int = 0,
    device="cuda",
) -> RepairResult:
    """Shard one repair across ``workers`` in-process claim loops (see
    module docstring). Returns the same :class:`RepairResult` surface
    as the serial engine (closures on ``device``); the coordinator
    directory remains inspectable (``Coordinator(dir).status()``)
    afterwards."""
    import time

    from paralleljohnson_tpu_torch.distributed import Coordinator

    t0 = time.perf_counter()
    plan = prepare_repair(
        checkpoint_dir, graph, updates, config=config, state=state,
        num_parts=num_parts, seed=seed, device=device,
    )
    if plan.trivial:
        return execute_repair(plan)
    work, copy = _work_sources(plan)
    manifest = plan.old_ckpt.manifest()
    files: dict[str, int] = {}
    for _s, (batch_idx, filename) in manifest.items():
        files[filename] = int(batch_idx)

    n_re = n_patch = 0
    batches_written = 0
    if work.size:
        coord = Coordinator.create(
            coordinator_dir,
            graph_spec=f"repair:{plan.report.new_digest}",
            graph_digest=plan.report.new_digest,
            num_sources=int(work.size),
            lease_sources=int(
                lease_rows
                or max(1, -(-int(work.size) // max(1, workers * 2)))
            ),
            lease_deadline_s=300.0,
        )
        # Round-robin claim loop: one lease per worker per round, so the
        # in-process twin exercises the same interleaved claim pattern a
        # real multi-process fleet produces.
        active = True
        while active:
            active = False
            for w in range(max(1, int(workers))):
                worker_id = f"rw{w}"
                lease = coord.claim(worker_id)
                if lease is None:
                    continue
                active = True
                sl = work[lease.start:lease.stop]
                rows = _rows_for(plan, sl)
                checked_save(
                    plan.new_ckpt,
                    REPAIR_LEASE_BATCH_BASE + lease.lease_id, sl, rows,
                )
                coord.commit(lease.lease_id, worker_id)
                batches_written += 1
                full = int(plan.full_mask[sl].sum())
                n_re += full
                n_patch += sl.size - full
        if not coord.done():
            raise RuntimeError(
                f"repair fleet incomplete: {coord.status()['leases']}"
            )

    # The caller copies the bitwise-unchanged remainder of each old batch.
    n_copy = 0
    copy_set = {int(s) for s in copy}
    for filename in sorted(files):
        batch_idx = files[filename]
        sources = plan.old_ckpt.batch_sources(filename)
        if sources is None:
            continue
        keep = np.array([int(s) in copy_set for s in sources], bool)
        if not keep.any():
            continue
        loaded = plan.old_ckpt.load(batch_idx, sources)
        if loaded is None:
            # Corrupt old batch: its "copy" rows must be recomputed too.
            sub = np.asarray(sources, np.int64)[keep]
            checked_save(
                plan.new_ckpt, batch_idx, sub, plan.recompute_rows(sub)
            )
            n_re += int(keep.sum())
        else:
            rows, _ = loaded
            checked_save(
                plan.new_ckpt, batch_idx,
                np.asarray(sources, np.int64)[keep], rows[keep],
            )
            n_copy += int(keep.sum())
        batches_written += 1
    finish_repair(plan)
    affected = plan.affected_sources()
    return RepairResult(
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
        affected_rows=(
            plan.old_graph.num_nodes if plan.patch_all
            else int(plan.full_mask.sum())
        ),
        rows_recomputed=n_re, rows_patched=n_patch, rows_copied=n_copy,
        batches_rewritten=batches_written,
        expand_macs=int(plan.expand_macs),
        closures_s=plan.closures_s, expand_s=plan.expand_s, io_s=0.0,
        wall_s=time.perf_counter() - t0,
        diag=plan.diag,
    )
