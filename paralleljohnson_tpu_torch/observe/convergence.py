"""Convergence observatory: per-iteration counters of the relaxation
loops, the PyTorch port of the JAX package's ``observe/convergence.py``.

Each instrumented loop iteration accumulates three numbers into device
tensors —

  frontier_size        vertices whose distance label strictly decreased
                       this iteration (any batch row counts the vertex
                       once);
  relaxations_applied  distance LABELS improved this iteration (rows x
                       vertices; equals frontier_size at B=1);
  residual_mass        sum of finite distance decreases (an inf -> finite
                       first-reach contributes 0; the mass decays to 0 at
                       fixpoint).

The counters stay on the device until the loop ends and cross to the
host once (:func:`decode_trajectory`). Iterations past the buffer cap
accumulate into the last row (totals stay exact; per-iteration
resolution truncates — ``summarize_trajectory`` flags it). Counts are
int32, as in the reference: one iteration's addend is bounded by batch x
V, and callers run ``utils.metrics.warn_if_traj_counter_wrapped``.
``residual_mass`` is f32 and advisory (its summation order is the
device's).

The loops that do not record run exactly as before: the backend calls
:func:`instrumented_fixpoint` (or passes ``traj_cap``) only under
``SolverConfig(convergence=True)``, or ``"auto"`` with a profile store
configured (the store's ``kind: "trajectory"`` records are what
:func:`dw_decision` reads).

The host half (summaries, records, the dirty-window decision) is the
reference's, stdlib + numpy.
"""

from __future__ import annotations

from typing import Callable

from paralleljohnson_tpu_torch.observe.costs import shape_bucket

# Rows of the device trajectory buffer. Iterations beyond the cap
# accumulate into the last row — totals stay exact, per-iteration
# resolution truncates (summarize_trajectory sets "truncated").
DEFAULT_TRAJ_CAP = 2048

# Frontier below this fraction of V marks a "tail" iteration — the
# iterations frontier compaction would collapse.
TAIL_FRONTIER_FRAC = 0.01


# -- device side (torch) ------------------------------------------------------


def traj_init(cap: int, device=None):
    """Fresh trajectory buffers on ``device``: (counts int32 [cap, 2],
    resid f32 [cap]) — columns of ``counts`` are (frontier_size,
    relaxations_applied)."""
    import torch

    return (
        torch.zeros((int(cap), 2), dtype=torch.int32, device=device),
        torch.zeros((int(cap),), dtype=torch.float32, device=device),
    )


def traj_record(counts, resid, i: int, d, nd, *,
                batch_axis: int | None = None) -> None:
    """Accumulate one iteration's (frontier, relaxations, residual mass)
    into row ``min(i, cap - 1)`` of the buffers, in place and on their
    device (no host read).

    ``d``/``nd`` are the distances before/after the iteration;
    ``batch_axis`` is the batch dimension of ``d`` (None for B=1 [V]
    vectors, 0 for [B, V], 1 for vertex-major [V, B]) — a vertex counts
    toward the frontier once no matter how many batch rows improved
    it."""
    import torch

    improved = nd < d
    vert_changed = (improved if batch_axis is None
                    else improved.any(dim=batch_axis))
    row = min(int(i), counts.shape[0] - 1)
    counts[row] += torch.stack([vert_changed.sum(), improved.sum()]).to(
        counts.dtype)
    # First-reach improvements come from d = +inf: their decrease is not
    # a finite number, so they contribute 0 mass.
    gain = torch.where(improved & torch.isfinite(d), d - nd,
                       torch.zeros((), dtype=d.dtype, device=d.device))
    resid[row] += gain.sum().to(resid.dtype)


def instrumented_fixpoint(
    step_fn: Callable,
    dist0,
    *,
    max_iter: int,
    cap: int,
    batch_axis: int | None = None,
):
    """Iterate ``step_fn(d) -> nd`` to fixpoint with trajectory recording
    — the instrumented twin of the plain ``(dist, i, improving)``
    fixpoints in ``ops.relax`` / ``ops.dia`` (same loop, one host read
    of the improving flag per iteration, as there).

    Returns ``(dist, iterations, still_improving, counts, resid)``;
    decode host-side with :func:`decode_trajectory`."""
    import torch

    counts, resid = traj_init(cap, dist0.device)
    d = dist0
    improving = bool(torch.isfinite(dist0).any())
    i = 0
    while improving and i < max_iter:
        nd = step_fn(d)
        traj_record(counts, resid, i, d, nd, batch_axis=batch_axis)
        improving = bool((nd < d).any())
        d = nd
        i += 1
    return d, i, improving, counts, resid


# -- host side (stdlib + numpy only) -----------------------------------------

def decode_trajectory(counts, resid, iterations: int):
    """Device buffers -> the ``[n, 3]`` float64 host trajectory
    (columns: frontier_size, relaxations_applied, residual_mass), where
    ``n = min(iterations, cap)`` — THE one D2H of the whole mechanism.
    Counts decode through int64 so the exact int32 device values never
    round through f32."""
    import numpy as np

    counts, resid = (x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
                     for x in (counts, resid))
    n = max(0, min(int(iterations), counts.shape[0]))
    out = np.empty((n, 3), np.float64)
    out[:, :2] = counts[:n].astype(np.int64)
    out[:, 2] = resid[:n]
    return out


def summarize_trajectory(
    traj,
    *,
    num_nodes: int,
    batch: int = 1,
    num_edges: int | None = None,
    iterations: int | None = None,
    degree_bias: float | None = None,
) -> dict:
    """The ``SolverStats.convergence`` summary of one decoded trajectory.

    iterations           total loop iterations (>= rows when truncated)
    frontier_peak/last   max / final frontier size
    frontier_half_life   first iteration index whose frontier is <= half
                         the peak and never recovers above it — the
                         collapse speed the JFR evidence quantifies
    tail_iterations /    iterations (count / fraction) whose frontier is
      tail_fraction      below ``TAIL_FRONTIER_FRAC`` of V — full sweeps
                         there relax E edges to improve < 1% of vertices
    jfr_skippable_edge_frac
                         estimated fraction of full-sweep examined edges
                         a frontier-compacted schedule would skip. With
                         ``degree_bias`` (the size-biased mean
                         out-degree E[d^2]/E[d], from the caller's
                         degree array): 1 - sum(min(E, frontier_i x
                         degree_bias)) / (iterations x E) — frontier
                         membership correlates with degree on power-law
                         graphs (hubs are reached early and re-improved
                         often), so pricing frontier mass at the
                         UNIFORM mean degree overweighted hub collapse:
                         the JAX package measured rmat_s12 at 60.0%
                         skippable vs 81.6% uniform-estimated.
                         Without ``degree_bias`` the uniform estimate
                         1 - sum(frontier_i) / (iterations x V) stands
                         (identical when degrees are uniform; exact
                         counters from the real frontier/bucket/dw
                         kernels remain the ground truth)
    relaxations_total /  exact totals (Python ints / float)
      residual_mass_total
    truncated            True when iterations > buffer rows (the last
                         row then holds the whole tail's accumulation
                         and per-iteration resolution stops there)
    """
    import numpy as np

    traj = np.asarray(traj, np.float64)
    rows = int(traj.shape[0])
    iters = int(iterations) if iterations is not None else rows
    out: dict = {
        "iterations": iters,
        "rows": rows,
        "batch": int(batch),
        "num_nodes": int(num_nodes),
        "truncated": iters > rows,
    }
    if rows == 0:
        out.update(
            frontier_peak=0, frontier_last=0, frontier_half_life=0,
            tail_iterations=0, tail_fraction=0.0,
            jfr_skippable_edge_frac=0.0, relaxations_total=0,
            residual_mass_total=0.0,
        )
        return out
    frontier = traj[:, 0]
    peak = float(frontier.max())
    out["frontier_peak"] = int(peak)
    out["frontier_last"] = int(frontier[-1])
    # Half-life: first index from which the frontier STAYS at or below
    # half the peak (a one-iteration dip that recovers is not collapse).
    half = peak / 2.0
    above = np.flatnonzero(frontier > half)
    out["frontier_half_life"] = int(above[-1]) + 1 if above.size else 0
    tail_mask = frontier < TAIL_FRONTIER_FRAC * max(int(num_nodes), 1)
    out["tail_iterations"] = int(tail_mask.sum())
    out["tail_fraction"] = float(tail_mask.sum() / rows)
    # JFR-win estimate over full sweeps. The truncated tail accumulates
    # into the last row, so sum(frontier) stays the exact total
    # frontier-visit count even past the cap. With a degree_bias the
    # frontier mass is priced at the size-biased mean degree (capped at
    # E per iteration — a sweep cannot examine more); without one, the
    # uniform-degree estimate (bias = mean degree) stands.
    if degree_bias is not None and num_edges:
        per_iter = np.minimum(
            float(num_edges), frontier * float(degree_bias)
        )
        out["jfr_skippable_edge_frac"] = float(
            max(0.0, 1.0 - per_iter.sum() / (float(iters) * num_edges))
        )
        out["degree_bias"] = float(degree_bias)
    else:
        denom = float(iters) * max(int(num_nodes), 1)
        out["jfr_skippable_edge_frac"] = float(
            max(0.0, 1.0 - frontier.sum() / denom)
        )
    if num_edges:
        out["num_edges"] = int(num_edges)
    out["relaxations_total"] = int(traj[:, 1].sum())
    out["residual_mass_total"] = float(traj[:, 2].sum())
    return out


def merge_summaries(prev: dict | None, summ: dict) -> dict:
    """Fold one more kernel call's summary into a phase entry
    (multi-batch fan-outs land one trajectory per batch): the entry
    keeps the LATEST batch's shape fields and accumulates ``batches`` /
    ``iterations_total`` / ``relaxations_total`` across calls."""
    entry = dict(summ)
    if prev is None:
        entry["batches"] = 1
        entry["iterations_total"] = summ.get("iterations", 0)
    else:
        entry["batches"] = int(prev.get("batches", 1)) + 1
        entry["iterations_total"] = int(
            prev.get("iterations_total", 0)
        ) + int(summ.get("iterations", 0))
        entry["relaxations_total"] = int(
            prev.get("relaxations_total", 0)
        ) + int(summ.get("relaxations_total", 0))
    return entry


def frontier_curve(traj, max_points: int = 64) -> list:
    """Downsampled frontier-size curve (head-biased stride) for flight-
    recorder event attrs — enough shape to render a collapse curve from
    a dead run's JSONL without dragging the full buffer through every
    event line."""
    import numpy as np

    traj = np.asarray(traj)
    if traj.shape[0] <= max_points:
        return [int(x) for x in traj[:, 0]]
    idx = np.unique(
        np.linspace(0, traj.shape[0] - 1, max_points).astype(np.int64)
    )
    return [int(traj[i, 0]) for i in idx]


def estimate_eta(
    elapsed_s: float, done: int, remaining: int
) -> float | None:
    """Remaining-wall estimate from completed work units (batches):
    ``remaining x (elapsed / done)``. None until one unit completes —
    an ETA with no evidence is noise, not telemetry."""
    if done <= 0 or elapsed_s < 0:
        return None
    return float(remaining) * (float(elapsed_s) / float(done))


# -- dirty-window dispatch decision -----------------------------------------
#
# Route selection from MEASURED trajectory evidence instead of a static
# heuristic (the JAX package's ``_use_dw`` reads it from its profile
# store; the port has no store yet, so nothing calls this). Thresholds: the dw schedule's overhead (bitmap
# maintenance, compaction, tile padding) was measured to eat roughly a
# quarter of the skippable fraction at block granularity, so it pays
# when the recorded collapse leaves a comfortable margin.

# Minimum recorded jfr_skippable_edge_frac for dw to engage: the
# scrambled road grid measures 0.963 (engages), rmat_s12 measures 0.600
# (declines) — 0.75 splits the measured workloads with margin both ways.
DW_MIN_SKIPPABLE_FRAC = 0.75

# Below this many iterations a solve has no tail to collect — the fixed
# per-round costs dominate whatever the bitmap skips.
DW_MIN_ITERATIONS = 8


def degree_bias_from_degrees(degrees) -> float | None:
    """Size-biased mean out-degree E[d^2]/E[d] — the expected degree of
    a vertex sampled proportionally to its degree, which is what
    frontier membership approximates on skewed graphs. None for
    edgeless graphs. Uniform-degree graphs return the plain mean, so
    the corrected estimator reduces to the uniform one there."""
    import numpy as np

    d = np.asarray(degrees, np.float64)
    total = d.sum()
    if total <= 0:
        return None
    return float((d * d).sum() / total)


def dw_decision(
    records,
    *,
    num_nodes: int,
    num_edges: int,
    platform: str | None = None,
) -> dict:
    """Should the dirty-window route serve a (num_nodes, num_edges)
    graph? Scans ``kind: "trajectory"`` profile-store records for the
    graph's pow2 shape bucket (the ``observe.costs.shape_bucket``
    keying) and applies the collapse thresholds. Platform-matching
    records are preferred but any-platform evidence counts — frontier
    collapse is a property of the graph and schedule, not the chip.

    Returns ``{"engage": bool, "reason": str, "summary": dict | None}``
    — never engages without evidence (the acceptance contract: a graph
    with no recorded collapse, or a flat trajectory, routes to plain
    vm / vm-blocked)."""
    want = shape_bucket(num_nodes, num_edges, 1)[:2]
    best = None
    best_rank = -1
    for r in records:
        if r.get("kind") != "trajectory":
            continue
        nodes = r.get("nodes") or 0
        edges = r.get("edges") or 0
        if shape_bucket(nodes, edges, 1)[:2] != want:
            continue
        summ = r.get("summary") or {}
        if not summ:
            continue
        # Prefer same-platform, then recency (records are appended in
        # time order, so the last qualifying one wins its rank tier).
        rank = 1 if (platform and r.get("platform") == platform) else 0
        if rank >= best_rank:
            best, best_rank = r, rank
    if best is None:
        return {
            "engage": False,
            "reason": (
                "no trajectory record for shape bucket "
                f"(V~2^{max(want[0], 1).bit_length() - 1}, "
                f"E~2^{max(want[1], 1).bit_length() - 1})"
            ),
            "summary": None,
        }
    summ = best.get("summary") or {}
    iters = int(summ.get("iterations", 0) or 0)
    skippable = float(summ.get("jfr_skippable_edge_frac", 0.0) or 0.0)
    half_life = summ.get("frontier_half_life")
    if iters < DW_MIN_ITERATIONS:
        return {
            "engage": False,
            "reason": f"recorded solve converges in {iters} iterations "
                      f"(< {DW_MIN_ITERATIONS}) — no tail to collect",
            "summary": summ,
        }
    if skippable < DW_MIN_SKIPPABLE_FRAC:
        return {
            "engage": False,
            "reason": (
                f"recorded jfr_skippable_edge_frac {skippable:.3f} < "
                f"{DW_MIN_SKIPPABLE_FRAC} (flat trajectory — the "
                "schedule overhead would eat the skip)"
            ),
            "summary": summ,
        }
    return {
        "engage": True,
        "reason": (
            f"trajectory records {skippable:.1%} skippable over "
            f"{iters} iterations (half-life {half_life})"
        ),
        "summary": summ,
    }


def trajectory_record(
    traj,
    *,
    label: str,
    phase: str,
    index: int,
    route: str | None,
    platform: str,
    num_nodes: int,
    num_edges: int,
    batch: int,
    summary: dict | None = None,
    degree_bias: float | None = None,
) -> dict:
    """The per-solve-stage profile-store record (``kind:
    "trajectory"``): the full per-iteration curve plus its summary,
    keyed like solve records so ``scripts/convergence_report.py`` and
    the cost model join on (route, platform). ``degree_bias`` feeds the
    skew-corrected JFR estimator (see :func:`summarize_trajectory`) —
    the number the dirty-window dispatch decision reads."""
    import time

    import numpy as np

    traj = np.asarray(traj, np.float64)
    return {
        "ts": time.time(),
        "kind": "trajectory",
        "label": label,
        "phase": phase,
        "batch_index": int(index),
        "route": route,
        "platform": platform,
        "nodes": int(num_nodes),
        "edges": int(num_edges),
        "batch": int(batch),
        "summary": summary or summarize_trajectory(
            traj, num_nodes=num_nodes, batch=batch, num_edges=num_edges,
            degree_bias=degree_bias,
        ),
        # Columns: frontier_size, relaxations_applied, residual_mass.
        "trajectory": [
            [int(r[0]), int(r[1]), float(r[2])] for r in traj
        ],
    }
