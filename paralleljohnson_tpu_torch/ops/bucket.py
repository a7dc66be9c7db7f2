"""Bucketed (delta-stepping-style) Bellman-Ford — the B=1 route
``bucket`` for irregular high-diameter graphs whose labeling is not
diagonal; the PyTorch port of the JAX package's ``ops/bucket.py``.

Vertices are processed in near-priority order by binning tentative
distances into buckets of width ``delta`` and settling the lowest
nonempty bucket before later ones, so each vertex settles about once
instead of being re-improved along every arriving path.

Formulation (the reference's, step for step):

  - dist plus two masks: ``active`` (improved since last processed) and
    ``pending`` (processed this bucket, heavy out-edges still owed).
    Bucket ids are ``floor(dist / delta)``, re-derived every step.
  - LIGHT step: compact the active vertices of the minimum bucket into a
    ``capacity`` buffer, relax their light out-edges (w <= delta), move
    them to ``pending`` and (re)activate every strictly improved
    destination.
  - HEAVY step: once no active vertex is at or below the pending bucket,
    relax the heavy out-edges (w > delta) of the pending vertices once.
  - A bucket larger than ``capacity`` is processed in capacity-sized
    bites (only processed ids are deactivated, so correctness never
    depends on the buffer size); more than a quarter of the graph in one
    step (e.g. the all-zeros virtual-source start) runs one full sweep
    that resets both masks.

Empty masks certify the global fixpoint. The bucket schedule does NOT
subsume Jacobi rounds, so exhausting ``max_steps`` is not a negative-cycle
certificate: the caller finishes on the full-sweep fixpoint from the
returned distances (``TorchBackend._sssp_build_bucket``, route
``bucket+sweep``).

The distances and masks live in [V+1] buffers whose last slot takes the
sentinel id ``V`` of empty tile rows and compaction fill (the reference's
dropped scatter index); every reduction reads the first V entries. One
host read per step (the busy flag and the branch together), counted in
``bellman_ford_bucketed.host_reads``.
"""

from __future__ import annotations

import numpy as np
import torch

from paralleljohnson_tpu_torch.ops import bump, relax
from paralleljohnson_tpu_torch.ops.relax import FRONTIER_ADDEND_MAX, INF

# Bucket id of inactive / unreached vertices (int32 max — larger than any
# clipped real bucket id, so min-reductions skip them).
NO_BUCKET = int(np.iinfo(np.int32).max)
# |floor(dist / delta)| is clipped here before the int32 cast; 2^30 keeps
# every clipped id strictly below NO_BUCKET.
_BUCKET_CLIP = 2.0 ** 30


def auto_delta(mean_weight: float, num_nodes: int, num_edges: int) -> float:
    """Bucket width heuristic: mean |edge weight| x twice the average
    out-degree, the factor clamped to [1, 8] (the JAX package's rule,
    tuned there on a scrambled road grid: widths near mean x 8 minimized
    the sequential steps while keeping examined near 3 x E). A pure perf
    knob — any delta > 0 is correct (SolverConfig.delta overrides)."""
    avg_deg = num_edges / max(num_nodes, 1)
    return float(max(mean_weight, 1e-6) * min(8.0, max(1.0, 2.0 * avg_deg)))


def auto_capacity(num_nodes: int, max_degree: int) -> int:
    """Static frontier-id buffer size for the bucket route. SMALL is
    the point: overflow is truncation (correctness never depends on the
    buffer), and the per-step tile ``capacity x max_degree`` is what a
    step's cost scales with. The JAX package's rule: floor 1024, grows
    gently with V, capped at 8192; clamped so ``capacity x max_degree``
    respects the split examined counter's addend bound (same contract
    as ``bellman_ford_frontier``)."""
    cap = int(min(num_nodes, min(8192, max(1024, num_nodes // 256))))
    if max_degree > 0:
        cap = max(1, min(cap, (FRONTIER_ADDEND_MAX - 1) // max_degree))
    return cap


def step_model_seconds(
    steps: int, examined: int, *, c_step: float, c_gather: float = 12.5e-9
) -> float:
    """Priced time of a bucketed solve: t = steps x C_step + examined x
    C_gather (a per-step fixed cost plus a per-candidate gather cost).
    The default ``c_gather`` is the JAX package's figure for its TPU's
    XLA row gather, not a number of the card: pass measured constants to
    price the port."""
    return steps * c_step + examined * c_gather


def bellman_ford_bucketed(dist0, src, dst, w, indptr, delta, *,
                          max_steps: int, capacity: int, max_degree: int,
                          num_real_edges: int, edge_chunk: int = 1 << 20,
                          traj_cap: int | None = None):
    """Fixpoint bucketed relaxation (B=1); see the module docstring.

    ``src``/``dst``/``w`` are in CSR (src-sorted) order with ``indptr``
    ([V+1], host or device) describing the real edges; the padded tail
    edges are (0, 0, +inf) no-ops only the full sweep touches. ``delta``
    is the bucket width (> 0).

    Returns (dist, steps, still_busy, examined): ``still_busy`` means the
    step budget ran out with the masks nonempty — the distances are then
    a valid upper bound the caller hands to the full-sweep fixpoint
    (this is NOT a negative-cycle flag); ``examined`` is the int64
    device count of candidate relaxations (``relax.examined_exact``).
    ``traj_cap`` appends the per-step trajectory buffers ``(counts,
    resid)`` (``observe.convergence``); None records nothing."""
    if num_real_edges >= FRONTIER_ADDEND_MAX:
        raise ValueError(
            "bellman_ford_bucketed: E="
            f"{num_real_edges} >= 2^31 - 2^20 breaks the examined "
            "counter's full-sweep addend bound the reference enforces; "
            "use the sweep routes"
        )
    v = dist0.shape[0]
    dev = dist0.device
    capacity = int(min(capacity, v))
    if max_degree > 0:
        capacity = max(1, min(capacity, (FRONTIER_ADDEND_MAX - 1) // max_degree))
    indptr = torch.as_tensor(indptr).to(dev, torch.int64)
    indptr_ext = torch.cat([indptr, indptr[-1:]])
    delta = torch.as_tensor(delta, dtype=w.dtype, device=dev)
    vertex_ids = torch.arange(v, device=dev)
    d = torch.cat([dist0, torch.full((1,), INF, dtype=dist0.dtype,
                                     device=dev)])
    active = torch.zeros(v + 1, dtype=torch.bool, device=dev)
    active[:v] = torch.isfinite(dist0)
    pending = torch.zeros(v + 1, dtype=torch.bool, device=dev)
    examined = torch.zeros((), dtype=torch.int64, device=dev)
    no_bucket = torch.full((), NO_BUCKET, dtype=torch.int32, device=dev)
    inf = torch.full((), INF, dtype=w.dtype, device=dev)

    def bucket_ids(dv):
        b = torch.clamp(torch.floor(dv / delta), -_BUCKET_CLIP, _BUCKET_CLIP)
        return torch.where(torch.isfinite(dv), b.to(torch.int32), no_bucket)

    def tile(ids):
        """The out-edge tile of the compacted ids (fill id V: empty row)
        and the ids' distances."""
        t, wt, valid = relax.out_edge_tile(indptr_ext, dst, w, ids,
                                           max_degree, v)
        return t, wt, d[ids], valid

    def relax_tile(t, cand, valid):
        """Scatter-min ``cand`` into ``d`` in place and (re)activate every
        strictly improved destination."""
        t = t.reshape(-1)
        cand = cand.reshape(-1)
        old = d[t]
        d.scatter_reduce_(0, t, cand, "amin")
        winner = (cand < old) & (cand == d[t])
        active[torch.where(winner, t, v)] = True
        return valid.sum()

    def light_step(bk, cur):
        ids = compact_ids(active[:v] & (bk == cur))
        t, wt, dv, valid = tile(ids)
        cand = torch.where(wt <= delta, dv[:, None] + wt, inf)
        # Deactivate BEFORE the winner scatter: a processed vertex that
        # another in-tile edge improves this very step must end active.
        active[ids] = False
        ex = relax_tile(t, cand, valid)
        # Processed vertices owe one heavy pass from their settled value.
        pending[ids] = True
        return ex

    def heavy_step(bk, cur):
        ids = compact_ids(pending[:v])
        t, wt, dv, valid = tile(ids)
        cand = torch.where(wt > delta, dv[:, None] + wt, inf)
        # Only the processed ids' heavy obligation is discharged; a
        # pending vertex improved since its light pass stays active.
        ex = relax_tile(t, cand, valid)
        pending[ids] = False
        return ex

    def full_step(bk, cur):
        nd = relax.relax_sweep(d[:v], src, dst, w, edge_chunk=edge_chunk)
        active[:v] = nd < d[:v]
        pending.zero_()
        d[:v] = nd
        return num_real_edges

    def compact_ids(mask):
        return relax.compact(mask, vertex_ids, capacity, v)

    if traj_cap is not None:
        from paralleljohnson_tpu_torch.observe.convergence import (
            traj_init,
            traj_record,
        )

        counts, resid = traj_init(traj_cap, dev)
    steps = (light_step, heavy_step, full_step)
    i = 0
    while True:
        bk = bucket_ids(d[:v])
        act, pend = active[:v], pending[:v]
        min_a = torch.where(act, bk, no_bucket).min()
        min_p = torch.where(pend, bk, no_bucket).min()
        # Settle the lowest active bucket first (light steps); flush the
        # owed heavy edges once nothing active remains at or below it.
        do_light = min_a <= min_p
        count = torch.where(do_light, (act & (bk == min_a)).sum(),
                            pend.sum())
        branch = torch.where(count > max(capacity, v // 4), 2,
                             torch.where(do_light, 0, 1))
        busy, branch = torch.stack([act.any() | pend.any(), branch]).tolist()
        bump(bellman_ford_bucketed, "host_reads")
        if not busy or i >= max_steps:
            break
        before = d[:v].clone() if traj_cap is not None else None
        examined += steps[branch](bk, min_a)
        if traj_cap is not None:
            traj_record(counts, resid, i, before, d[:v])
        i += 1
    out = (d[:v], i, bool(busy), examined)
    return out if traj_cap is None else (*out, counts, resid)


bellman_ford_bucketed.host_reads = 0
