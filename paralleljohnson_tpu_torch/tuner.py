"""Self-proposing planner: a budgeted probe tuner over the dispatch knobs.

The planner promotes a challenger only when the profile store already
holds measured evidence for it. This module closes the loop: it
*proposes* candidate values for every tunable knob a
:class:`~paralleljohnson_tpu_torch.planner.Plan` declares
(``Plan.tunables``), *measures* them with budgeted probe solves, and
lands the measurements as ordinary ``kind:"plan"`` profile records plus a
``kind:"tune"`` audit record per probe. Promotion stays where it always
was: the observatory's single calibrated-challenger rule
(:data:`observe.tuning.TUNE_NOISE_BAND`) decides whether a probed value
dislodges the seed.

Three invariants, as in the JAX package:

* **Budget is a wall, not a suggestion.**  Every probe runs under a hard
  wall-clock cap (``budget_s``).  A probe that outlives the cap is
  abandoned, its profile records are *discarded* (they never reach the
  store, so a censored value is structurally unpromotable), and a
  ``censored: true`` tune record documents the attempt.  On the card an
  abandoned probe's thread keeps launching kernels until its solve
  ends, so the next probe's wall can include that work: the cap still
  holds, and the overlap can only censor or slow a later probe, never
  promote a censored value.
* **Zero budget is a no-op.**  ``tune_bucket(..., bucket_budget_s=0)``
  returns without touching the store; dispatch with a zero tuning budget
  is bitwise-identical to dispatch without the tuner.
* **Proposals are deterministic.**  Candidate generation is a pure
  function of the shape bucket, the config seed, and the (sorted) set of
  values already measured in that bucket.

Idle-capacity farm: :func:`plan_tuning_fleet` writes a fleet
coordinator plan whose leases are (knob x candidate-chunk) jobs, chunk
sizes priced from the CostModel; :func:`run_tuning_worker` and the
one-shot :func:`try_tuning_lease` (the hook fleet workers call when
idle) claim leases, probe into per-worker shard stores, and commit under
the coordinator's digest guard; :func:`harvest_tuning` merges committed
shards into the real store. The plan and the shards keep the JAX
package's format.

Every function that solves or reads the platform takes ``device`` (the
card by default, ``"cpu"`` for the plain versions) and passes it on.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np

from paralleljohnson_tpu_torch import planner as _planner
from paralleljohnson_tpu_torch.config import SolverConfig
from paralleljohnson_tpu_torch.observe import current_platform
from paralleljohnson_tpu_torch.observe.costs import shape_bucket
from paralleljohnson_tpu_torch.observe.store import CostModel, ProfileStore
from paralleljohnson_tpu_torch.observe.tuning import (
    DEFAULT_FW_TILE,
    DEFAULT_PIPELINE_DEPTH,
    TUNABLE_PARAMS,
    cached_records,
    param_provenance,
    tuned_value,
)

__all__ = [
    "KnobSpec",
    "KNOB_SPECS",
    "ProbeResult",
    "declared_tunables",
    "propose_candidates",
    "run_probe",
    "tune_bucket",
    "plan_tuning_fleet",
    "run_tuning_worker",
    "try_tuning_lease",
    "harvest_tuning",
    "provenance_table",
]

TUNE_SPEC_PREFIX = "tune:"
HARVESTED_FILE = "harvested.json"

# Floor under the per-probe cap when pricing lease sizes: even a probe the
# model predicts as instant pays Python and launch overhead.
MIN_PRICED_PROBE_S = 0.05

# ---------------------------------------------------------------------------
# Knob registry


def _pad128(v: int) -> int:
    return 128 * max(1, math.ceil(max(1, int(v)) / 128))


def _cand_fw_tile(v: int, e: int, seed: Any) -> list[int]:
    pad = _pad128(v)
    tiles = {128, 256, 384, 512, pad}
    if isinstance(seed, int) and seed >= 128:
        tiles.add(min(seed, pad))
    return sorted(t for t in tiles if 128 <= t <= pad)


def _cand_partition_parts(v: int, e: int, seed: Any) -> list[int]:
    vals = {p for p in (2, 4, 8, 16, 32) if 2 * p <= max(4, v)}
    if isinstance(seed, int) and seed >= 2:
        vals.add(seed)
    return sorted(vals)


def _cand_delta(v: int, e: int, seed: Any) -> list[float]:
    base = float(seed) if seed else 1.0
    return sorted({round(base * m, 9) for m in (0.25, 0.5, 1.0, 2.0, 4.0)})


def _cand_source_batch(v: int, e: int, seed: Any) -> list[int]:
    out, b = [], 8
    while b <= max(8, v) and len(out) < 6:
        out.append(b)
        b *= 2
    if isinstance(seed, int) and seed >= 1:
        out.append(min(seed, max(8, v)))
    return sorted(set(out))


def _cand_pipeline_depth(v: int, e: int, seed: Any) -> list[int]:
    vals = {1, 2, 3, 4}
    if isinstance(seed, int) and seed >= 1:
        vals.add(seed)
    return sorted(vals)


def _cand_approx_beta(v: int, e: int, seed: Any) -> list[int]:
    b = int(seed) if seed else 6
    return sorted({max(2, b // 2), max(2, b), max(2, 2 * b)})


def _seed_fw_tile(config: SolverConfig, v: int, e: int) -> int:
    return int(config.fw_tile) if config.fw_tile else DEFAULT_FW_TILE


def _seed_partition_parts(config: SolverConfig, v: int, e: int) -> int:
    if config.partition_parts:
        return int(config.partition_parts)
    return max(2, min(32, int(math.isqrt(max(4, v))) // 2 or 2))


def _seed_delta(config: SolverConfig, v: int, e: int) -> float:
    return float(config.delta) if config.delta else 1.0


def _seed_source_batch(config: SolverConfig, v: int, e: int) -> int:
    if config.source_batch_size:
        return int(config.source_batch_size)
    return max(8, min(64, v))


def _seed_pipeline_depth(config: SolverConfig, v: int, e: int) -> int:
    if config.pipeline_depth:
        return int(config.pipeline_depth)
    return DEFAULT_PIPELINE_DEPTH


def _seed_approx_beta(config: SolverConfig, v: int, e: int) -> int:
    if config.approx_beta:
        return int(config.approx_beta)
    from paralleljohnson_tpu_torch.ops.hopset import auto_beta

    return auto_beta(v, float(config.approx_epsilon))


def _probe_solve(graph, sources, config: SolverConfig, device="cuda") -> None:
    from paralleljohnson_tpu_torch.solver.johnson import ParallelJohnsonSolver

    ParallelJohnsonSolver(config, device=device).solve(graph, sources)


def _probe_approx(graph, sources, config: SolverConfig, device="cuda") -> None:
    from paralleljohnson_tpu_torch.solver.approx import solve_with_budget

    solve_with_budget(
        graph, sources, config=config,
        error_budget=float(config.approx_epsilon), device=device,
    )


@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """How to probe one tunable knob: which config field carries a
    candidate value, which route overrides pin the plan that consumes it,
    how many sources a representative probe solves, and the deterministic
    candidate/seed generators.  ``validate`` mirrors the resolve-time
    filter in ``observe.tuning`` so the tuner never probes a value
    dispatch would refuse to trust."""

    name: str
    config_field: str
    plan: str                       # plan whose tunables declare this knob
    overrides: dict[str, Any]       # force the consuming route during probes
    candidates: Callable[[int, int, Any], list]
    seed: Callable[[SolverConfig, int, int], Any]
    probe: Callable[..., None] = _probe_solve
    probe_batch: Callable[[int], int] = lambda v: v
    validate: Callable[[Any], bool] | None = None


KNOB_SPECS: dict[str, KnobSpec] = {
    "fw_tile": KnobSpec(
        name="fw_tile", config_field="fw_tile", plan="fw",
        overrides={"fw": True, "mesh_shape": (1,)},
        candidates=_cand_fw_tile, seed=_seed_fw_tile,
        validate=lambda x: isinstance(x, int) and x >= 128 and x % 128 == 0,
    ),
    "partition_parts": KnobSpec(
        name="partition_parts", config_field="partition_parts",
        plan="condensed+fw", overrides={"partitioned": True},
        candidates=_cand_partition_parts, seed=_seed_partition_parts,
        validate=lambda x: isinstance(x, int) and x >= 2,
    ),
    "delta": KnobSpec(
        name="delta", config_field="delta", plan="bucket",
        overrides={"bucket": True},
        candidates=_cand_delta, seed=_seed_delta,
        probe_batch=lambda v: 1,
        validate=lambda x: isinstance(x, (int, float)) and x > 0,
    ),
    "source_batch": KnobSpec(
        name="source_batch", config_field="source_batch_size",
        plan="standard", overrides={"partitioned": False},
        candidates=_cand_source_batch, seed=_seed_source_batch,
        validate=lambda x: isinstance(x, int) and x >= 1,
    ),
    "pipeline_depth": KnobSpec(
        name="pipeline_depth", config_field="pipeline_depth",
        plan="standard", overrides={"partitioned": False},
        candidates=_cand_pipeline_depth, seed=_seed_pipeline_depth,
        validate=lambda x: isinstance(x, int) and x >= 1,
    ),
    "approx_beta": KnobSpec(
        name="approx_beta", config_field="approx_beta",
        plan="hopset+bf", overrides={"hopset": True},
        candidates=_cand_approx_beta, seed=_seed_approx_beta,
        probe=_probe_approx, probe_batch=lambda v: min(8, v),
        validate=lambda x: isinstance(x, int) and x >= 2,
    ),
}

assert set(KNOB_SPECS) == set(TUNABLE_PARAMS)


def declared_tunables() -> list[tuple[str, str]]:
    """Every ``(plan_name, knob)`` pair declared by a registered Plan, in
    registry order — the tuner's work list is *derived* from the same
    plan registries dispatch walks, so a plan that stops declaring a knob
    silently drops out of tuning."""
    from paralleljohnson_tpu_torch.backends.torch_backend import (
        FANOUT_PLANS, SSSP_PLANS,
    )
    from paralleljohnson_tpu_torch.incremental.repair import _repair_plans
    from paralleljohnson_tpu_torch.solver.approx import APPROX_PLANS
    from paralleljohnson_tpu_torch.solver.johnson import SOLVER_PLANS

    out: list[tuple[str, str]] = []
    for registry in (SOLVER_PLANS, FANOUT_PLANS, SSSP_PLANS, APPROX_PLANS,
                     _repair_plans()):
        for plan in registry:
            for knob in plan.tunables:
                if (plan.name, knob) not in out:
                    out.append((plan.name, knob))
    return out


def tunable_knobs() -> list[str]:
    """Knob names declared by at least one plan, first-declaration order."""
    out: list[str] = []
    for _plan, knob in declared_tunables():
        if knob not in out and knob in KNOB_SPECS:
            out.append(knob)
    return out


# ---------------------------------------------------------------------------
# Deterministic proposals


def propose_candidates(
    knob: str,
    *,
    num_nodes: int,
    num_edges: int,
    config: SolverConfig | None = None,
    records: Sequence[dict] | None = None,
    platform: str | None = None,
    device="cuda",
) -> list:
    """Ordered candidate list for ``knob`` in the (num_nodes, num_edges)
    bucket: the config seed first (its measured wall is the promotion
    fallback), then never-measured values, then already-measured ones —
    each group sorted.  Pure in (bucket, seed, measured-set): two callers
    see the same list. ``platform`` defaults to ``device``'s."""
    spec = KNOB_SPECS[knob]
    config = config or SolverConfig()
    seed = spec.seed(config, num_nodes, num_edges)
    cands = [c for c in spec.candidates(num_nodes, num_edges, seed)
             if spec.validate is None or spec.validate(c)]
    measured: set = set()
    if records:
        platform = platform or current_platform(device)
        bucket = shape_bucket(int(num_nodes), int(num_edges), 1)[:2]
        for rec in records:
            if rec.get("kind") not in ("plan", "tune"):
                continue
            if rec.get("platform") != platform:
                continue
            rb = shape_bucket(int(rec.get("nodes") or 0),
                              int(rec.get("edges") or 0), 1)[:2]
            if rb != bucket:
                continue
            if rec.get("kind") == "tune":
                if rec.get("knob") == knob and rec.get("value") is not None:
                    measured.add(rec["value"])
            else:
                params = rec.get("params") or {}
                if knob in params and params[knob] is not None:
                    measured.add(params[knob])
    untried = [c for c in cands if c != seed and c not in measured]
    tried = [c for c in cands if c != seed and c in measured]
    ordered = untried + tried
    if seed in cands or (spec.validate is None or spec.validate(seed)):
        ordered = [seed] + ordered
    return ordered


# ---------------------------------------------------------------------------
# Budgeted probes


@dataclasses.dataclass
class ProbeResult:
    knob: str
    value: Any
    wall_s: float | None
    censored: bool
    reason: str | None = None
    records_landed: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def run_probe(
    graph,
    *,
    knob: str,
    value: Any,
    store: ProfileStore,
    budget_s: float,
    config: SolverConfig | None = None,
    rung: int = 0,
    label: str = "tuner",
    solve_fn: Callable[[Any, np.ndarray, SolverConfig], None] | None = None,
    device="cuda",
) -> ProbeResult:
    """One budgeted probe: solve ``graph`` with ``knob`` pinned to
    ``value`` (route forced via the knob's overrides) into a throwaway
    profile store, under a hard ``budget_s`` wall-clock cap.

    On success the probe's own ``kind:"plan"``/``kind:"solve"`` records
    are copied into ``store`` (ordinary calibration evidence — exactly
    what a forced bench run would have landed) plus one ``kind:"tune"``
    record.  A probe that exceeds the cap, or raises, lands *only* a
    ``censored: true`` tune record: its measurements are discarded, so a
    censored value can never be promoted. The probe solves on ``device``
    unless ``solve_fn`` replaces it."""
    spec = KNOB_SPECS[knob]
    if spec.validate is not None and not spec.validate(value):
        raise ValueError(f"invalid candidate for {knob}: {value!r}")
    config = config or SolverConfig()
    v = int(graph.num_nodes)
    e = int(graph.num_real_edges)
    batch = max(1, min(v, int(spec.probe_batch(v))))
    sources = np.arange(batch, dtype=np.int64)
    tmp = tempfile.mkdtemp(prefix="pj-probe-")
    probe_cfg = dataclasses.replace(
        config,
        **{spec.config_field: value},
        **spec.overrides,
        profile_store=tmp,
        checkpoint_dir=None,
    )
    fn = solve_fn or functools.partial(spec.probe, device=device)
    box: dict[str, Any] = {}

    def _run() -> None:
        t0 = time.perf_counter()
        try:
            fn(graph, sources, probe_cfg)
            box["wall"] = time.perf_counter() - t0
        except BaseException as exc:  # noqa: BLE001 — probe sandbox
            box["error"] = f"{type(exc).__name__}: {exc}"

    worker = threading.Thread(
        target=_run, daemon=True, name=f"pj-probe-{knob}",
    )
    worker.start()
    worker.join(float(budget_s))
    platform = current_platform(device)
    common = dict(
        knob=knob, value=value, platform=platform,
        num_nodes=v, num_edges=e, batch=batch,
        plan=spec.plan, budget_s=float(budget_s), rung=rung, label=label,
    )
    try:
        if worker.is_alive():
            # Hard cap breached: abandon the daemon thread, discard its
            # (possibly half-written) records.
            store.append(_planner.tune_record(
                censored=True, reason="wall-clock budget exceeded", **common,
            ))
            return ProbeResult(knob, value, None, True,
                               "wall-clock budget exceeded")
        if "error" in box:
            store.append(_planner.tune_record(
                censored=True, reason=box["error"], **common,
            ))
            return ProbeResult(knob, value, None, True, box["error"])
        wall = float(box.get("wall", 0.0))
        if wall > float(budget_s):
            # Finished between join() timeout slices but over the cap:
            # still censored — the cap is the contract.
            store.append(_planner.tune_record(
                censored=True, wall_s=wall,
                reason="wall-clock budget exceeded", **common,
            ))
            return ProbeResult(knob, value, wall, True,
                               "wall-clock budget exceeded")
        landed = 0
        for rec in ProfileStore(tmp).records():
            store.append(rec)
            landed += 1
        store.append(_planner.tune_record(wall_s=wall, **common))
        return ProbeResult(knob, value, wall, False, None, landed)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Local tuning loop: coordinate descent + successive halving


def tune_bucket(
    graph,
    *,
    store_dir: str | Path,
    config: SolverConfig | None = None,
    knobs: Sequence[str] | None = None,
    candidates: dict[str, Sequence] | None = None,
    probe_budget_s: float = 30.0,
    bucket_budget_s: float = 120.0,
    max_rungs: int = 2,
    label: str = "tuner",
    solve_fn: Callable | None = None,
    device="cuda",
) -> dict:
    """Tune ``graph``'s shape bucket: coordinate descent over the
    declared knobs (each knob probed with every earlier knob pinned at
    its current winner), successive halving within a knob (all
    candidates probed at rung 0, the faster half re-probed per rung up
    to ``max_rungs``), everything under a per-probe cap
    (``probe_budget_s``) and a total cap (``bucket_budget_s``).

    ``bucket_budget_s <= 0`` returns immediately without opening the
    store: zero tuning budget leaves dispatch bitwise-identical.
    """
    if bucket_budget_s is not None and float(bucket_budget_s) <= 0:
        return {"probes": 0, "censored": 0, "knobs": {},
                "skipped": "zero tuning budget", "wall_s": 0.0}
    t_start = time.perf_counter()

    def remaining() -> float:
        if bucket_budget_s is None:
            return float("inf")
        return float(bucket_budget_s) - (time.perf_counter() - t_start)

    config = config or SolverConfig()
    store = ProfileStore(store_dir)
    platform = current_platform(device)
    v = int(graph.num_nodes)
    e = int(graph.num_real_edges)
    knob_list = list(knobs) if knobs is not None else tunable_knobs()
    summary: dict = {"probes": 0, "censored": 0, "knobs": {},
                     "skipped": None}
    base_cfg = config
    for knob in knob_list:
        if knob not in KNOB_SPECS:
            raise ValueError(f"unknown knob {knob!r}; known: "
                             f"{sorted(KNOB_SPECS)}")
        spec = KNOB_SPECS[knob]
        if remaining() <= 0:
            summary["skipped"] = f"bucket budget exhausted before {knob}"
            break
        if candidates and knob in candidates:
            cands = [c for c in candidates[knob]
                     if spec.validate is None or spec.validate(c)]
        else:
            cands = propose_candidates(
                knob, num_nodes=v, num_edges=e, config=base_cfg,
                records=store.records(), platform=platform, device=device,
            )
        seed_value = spec.seed(base_cfg, v, e)
        survivors = list(cands)
        walls: dict[Any, float] = {}
        rung = 0
        while survivors and rung <= max_rungs:
            rung_walls: dict[Any, float] = {}
            for cand in survivors:
                if remaining() <= 0:
                    summary["skipped"] = (
                        f"bucket budget exhausted during {knob} rung {rung}"
                    )
                    break
                per_probe = min(float(probe_budget_s), max(0.0, remaining()))
                res = run_probe(
                    graph, knob=knob, value=cand, store=store,
                    budget_s=per_probe, config=base_cfg, rung=rung,
                    label=label, solve_fn=solve_fn, device=device,
                )
                summary["probes"] += 1
                if res.censored:
                    summary["censored"] += 1
                else:
                    rung_walls[cand] = res.wall_s
                    walls[cand] = min(walls.get(cand, float("inf")),
                                      res.wall_s)
            if len(rung_walls) <= 1:
                break
            ranked = sorted(rung_walls, key=lambda c: rung_walls[c])
            survivors = ranked[: max(1, math.ceil(len(ranked) / 2))]
            rung += 1
        winner = tuned_value(
            knob, store_dir=str(store_dir), platform=platform,
            num_nodes=v, num_edges=e, fallback=seed_value,
        )
        summary["knobs"][knob] = {
            "seed": seed_value,
            "candidates": cands,
            "measured": {repr(k): w for k, w in sorted(
                walls.items(), key=lambda kv: kv[1])},
            "winner": winner,
            "promoted": winner is not None and winner != seed_value,
        }
        # Coordinate descent: later knobs are probed with this knob held
        # at its promoted value (or the seed when nothing beat the band).
        pinned = winner if winner is not None else seed_value
        if spec.validate is None or spec.validate(pinned):
            base_cfg = dataclasses.replace(
                base_cfg, **{spec.config_field: pinned},
            )
    summary["wall_s"] = time.perf_counter() - t_start
    return summary


# ---------------------------------------------------------------------------
# Idle-capacity farm over the fleet coordinator


def _chunk(values: Sequence, size: int) -> list[list]:
    size = max(1, int(size))
    return [list(values[i:i + size]) for i in range(0, len(values), size)]


def _priced_chunk_size(
    store_dir: str | Path | None,
    spec: KnobSpec,
    *,
    num_edges: int,
    batch: int,
    probe_budget_s: float,
    target_lease_s: float,
    platform: str,
) -> int:
    """Candidates per lease, priced from the CostModel: a lease should
    cost ~``target_lease_s`` of probe time.  With no model (cold store)
    each probe is priced at its worst case — the full budget cap."""
    per_probe = float(probe_budget_s)
    if store_dir:
        try:
            model = CostModel.fit(cached_records(store_dir))
            routes = (spec.plan,) if spec.plan else ()
            preds = [
                model.predict(route, num_edges=num_edges, batch=batch,
                              platform=platform)
                for route in routes
            ]
            preds = [p["predicted_s"] for p in preds
                     if p and p.get("predicted_s")]
            if preds:
                per_probe = min(per_probe,
                                max(MIN_PRICED_PROBE_S, 2.0 * min(preds)))
        except Exception:
            pass
    return max(1, int(float(target_lease_s) // max(per_probe, 1e-9)))


def plan_tuning_fleet(
    directory: str | Path,
    *,
    graph_spec: str,
    graph,
    knobs: Sequence[str] | None = None,
    candidates: dict[str, Sequence] | None = None,
    config: SolverConfig | None = None,
    store_dir: str | Path | None = None,
    probe_budget_s: float = 30.0,
    target_lease_s: float | None = None,
    lease_deadline_s: float = 60.0,
    device="cuda",
):
    """Write a coordinator plan whose leases are tuning jobs: one lease =
    one (knob x candidate-chunk) probe assignment on one shape bucket.
    Chunk sizes come from :func:`_priced_chunk_size` — the cost model
    prices how many probes fit in ``target_lease_s`` (default: 4 probe
    caps).  Workers attach with :func:`run_tuning_worker` (or steal
    single leases with :func:`try_tuning_lease` when idle) and the
    caller merges results with :func:`harvest_tuning`. Candidates and
    lease sizes are priced for ``device``'s platform."""
    from paralleljohnson_tpu_torch.distributed.coordinator import Coordinator
    from paralleljohnson_tpu_torch.utils.checkpoint import graph_digest

    config = config or SolverConfig()
    v = int(graph.num_nodes)
    e = int(graph.num_real_edges)
    platform = current_platform(device)
    if target_lease_s is None:
        target_lease_s = 4.0 * float(probe_budget_s)
    records = list(cached_records(store_dir)) if store_dir else []
    jobs: list[dict] = []
    for knob in (list(knobs) if knobs is not None else tunable_knobs()):
        spec = KNOB_SPECS[knob]
        if candidates and knob in candidates:
            values = [c for c in candidates[knob]
                      if spec.validate is None or spec.validate(c)]
        else:
            values = propose_candidates(
                knob, num_nodes=v, num_edges=e, config=config,
                records=records, platform=platform,
            )
        if not values:
            continue
        batch = max(1, min(v, int(spec.probe_batch(v))))
        size = _priced_chunk_size(
            store_dir, spec, num_edges=e, batch=batch,
            probe_budget_s=probe_budget_s, target_lease_s=target_lease_s,
            platform=platform,
        )
        for chunk in _chunk(values, size):
            jobs.append({"knob": knob, "values": chunk,
                         "probe_budget_s": float(probe_budget_s)})
    if not jobs:
        raise ValueError("no tuning jobs: no declared knobs or candidates")
    coord = Coordinator.create(
        directory,
        graph_spec=TUNE_SPEC_PREFIX + graph_spec,
        graph_digest=graph_digest(graph),
        num_sources=len(jobs),
        lease_sources=1,
        lease_deadline_s=lease_deadline_s,
        config={"tuning": {
            "jobs": jobs,
            "graph_spec": graph_spec,
            "num_nodes": v,
            "num_edges": e,
        }},
    )
    return coord


def _tuning_spec(coord) -> dict:
    spec = coord.spec
    gspec = spec.get("graph_spec", "")
    if not str(gspec).startswith(TUNE_SPEC_PREFIX):
        from paralleljohnson_tpu_torch.distributed.coordinator import (
            CoordinatorError,
        )
        raise CoordinatorError(
            f"{coord.dir}: not a tuning fleet (graph_spec={gspec!r}; "
            f"expected {TUNE_SPEC_PREFIX!r} prefix)"
        )
    tuning = (spec.get("config") or {}).get("tuning")
    if not tuning or "jobs" not in tuning:
        from paralleljohnson_tpu_torch.distributed.coordinator import (
            CoordinatorError,
        )
        raise CoordinatorError(
            f"{coord.dir}: tuning fleet spec has no jobs manifest"
        )
    return spec


# Loaded probe graphs, keyed by (spec, digest): the idle hooks poll every
# few hundred ms and must not re-parse the graph per tick.
_TUNING_GRAPH_CACHE: dict[tuple[str, str], Any] = {}


def _load_tuning_graph(spec: dict, graph=None):
    from paralleljohnson_tpu_torch.distributed.coordinator import CoordinatorError
    from paralleljohnson_tpu_torch.utils.checkpoint import graph_digest

    if graph is None:
        key = (str(spec["config"]["tuning"]["graph_spec"]),
               str(spec["graph_digest"]))
        graph = _TUNING_GRAPH_CACHE.get(key)
        if graph is None:
            from paralleljohnson_tpu_torch.graphs import load_graph

            graph = load_graph(spec["config"]["tuning"]["graph_spec"])
            _TUNING_GRAPH_CACHE[key] = graph
    digest = graph_digest(graph)
    if digest != spec["graph_digest"]:
        raise CoordinatorError(
            f"graph digest mismatch: fleet planned for "
            f"{spec['graph_digest']} but probe graph hashes to {digest} — "
            "refusing to land measurements from a different graph"
        )
    return graph


def _run_tuning_lease(
    coord, lease, spec: dict, graph, worker: str,
    *,
    config: SolverConfig | None = None,
    solve_fn: Callable | None = None,
    device="cuda",
) -> dict:
    """Execute one claimed tuning lease: probe its job's candidates into
    a per-lease shard store, then commit.  The shard is only harvested
    after the commit lands (manifest idiom: results from a lease that
    was requeued to another worker are ignored)."""
    jobs = spec["config"]["tuning"]["jobs"]
    shard_root = coord.shard_dir(worker)
    shard_root.mkdir(parents=True, exist_ok=True)
    shard = ProfileStore(shard_root / f"tune-lease{lease.lease_id}")
    probes = []
    for job_idx in range(lease.start, lease.stop):
        job = jobs[job_idx]
        for value in job["values"]:
            res = run_probe(
                graph, knob=job["knob"], value=value, store=shard,
                budget_s=float(job["probe_budget_s"]), config=config,
                label=f"tuner:{worker}", solve_fn=solve_fn, device=device,
            )
            probes.append(res.as_dict())
    coord.commit(lease.lease_id, worker)
    return {"lease": lease.lease_id, "probes": probes,
            "shard": str(shard.path)}


def try_tuning_lease(
    fleet_dir: str | Path,
    worker: str,
    *,
    graph=None,
    config: SolverConfig | None = None,
    solve_fn: Callable | None = None,
    device="cuda",
) -> dict | None:
    """The idle hook: claim and run at most ONE tuning lease, then
    return (``None`` when nothing is pending or the directory is not a
    tuning fleet).  Fleet workers call this between solve leases; serve
    replicas call it from their idle loop — idle capacity becomes
    calibration throughput without a dedicated tuner process. Probes
    solve on ``device``."""
    from paralleljohnson_tpu_torch.distributed.coordinator import (
        Coordinator, CoordinatorError, StaleLeaseError,
    )

    try:
        coord = Coordinator(fleet_dir)
        spec = _tuning_spec(coord)
        graph = _load_tuning_graph(spec, graph)
    except (CoordinatorError, FileNotFoundError, KeyError, ValueError):
        return None
    lease = coord.claim(worker)
    if lease is None:
        return None
    try:
        return _run_tuning_lease(
            coord, lease, spec, graph, worker,
            config=config, solve_fn=solve_fn, device=device,
        )
    except StaleLeaseError:
        return None
    except BaseException:
        try:
            coord.release(lease.lease_id, worker, reason="probe error")
        except Exception:
            pass
        raise


def run_tuning_worker(
    fleet_dir: str | Path,
    worker: str,
    *,
    graph=None,
    config: SolverConfig | None = None,
    solve_fn: Callable | None = None,
    max_leases: int | None = None,
    poll_s: float = 0.25,
    idle_timeout_s: float = 30.0,
    device="cuda",
) -> dict:
    """Drain tuning leases until the fleet is done (or ``max_leases``):
    the dedicated-worker counterpart of :func:`try_tuning_lease`.
    Crash-safe the same way solve workers are: leases lapse at the
    coordinator deadline and requeue; ``recover_worker`` requeues our
    own stragglers at startup."""
    from paralleljohnson_tpu_torch.distributed.coordinator import (
        Coordinator, StaleLeaseError,
    )

    coord = Coordinator(fleet_dir)
    spec = _tuning_spec(coord)
    graph = _load_tuning_graph(spec, graph)
    coord.recover_worker(worker)
    done: list[dict] = []
    stale = 0
    idle_since: float | None = None
    while True:
        if max_leases is not None and len(done) >= max_leases:
            break
        lease = coord.claim(worker)
        if lease is None:
            if coord.done():
                break
            now = time.monotonic()
            if idle_since is None:
                idle_since = now
            elif now - idle_since > idle_timeout_s:
                break
            time.sleep(poll_s)
            continue
        idle_since = None
        try:
            done.append(_run_tuning_lease(
                coord, lease, spec, graph, worker,
                config=config, solve_fn=solve_fn, device=device,
            ))
        except StaleLeaseError:
            stale += 1
        except BaseException:
            try:
                coord.release(lease.lease_id, worker, reason="probe error")
            except Exception:
                pass
            raise
    return {"worker": worker, "leases": done, "stale_commits": stale,
            "fleet_done": coord.done()}


def harvest_tuning(
    fleet_dir: str | Path,
    store_dir: str | Path,
) -> dict:
    """Merge every *committed* lease's shard store into the real profile
    store, exactly once (a ``harvested.json`` ledger in the fleet dir
    records merged lease ids).  Uncommitted / requeued leases are
    skipped: the commit is the only thing that makes a shard real."""
    from paralleljohnson_tpu_torch.distributed.coordinator import Coordinator

    coord = Coordinator(fleet_dir)
    _tuning_spec(coord)
    ledger_path = Path(fleet_dir) / HARVESTED_FILE
    harvested: set[int] = set()
    if ledger_path.exists():
        harvested = set(json.loads(ledger_path.read_text(encoding="utf-8")))
    store = ProfileStore(store_dir)
    merged = 0
    records = 0
    for lease in coord.leases():
        if lease.state != "committed" or lease.lease_id in harvested:
            continue
        shard_dir = (coord.shard_dir(lease.committed_by)
                     / f"tune-lease{lease.lease_id}")
        for rec in ProfileStore(shard_dir).records():
            store.append(rec)
            records += 1
        harvested.add(lease.lease_id)
        merged += 1
    tmp = ledger_path.with_suffix(".tmp")
    tmp.write_text(json.dumps(sorted(harvested)), encoding="utf-8")
    tmp.replace(ledger_path)
    return {"leases_harvested": merged, "records": records,
            "total_harvested": len(harvested),
            "fleet_done": coord.done()}


def provenance_table(
    *,
    store_dir: str | Path | None,
    platform: str | None = None,
    num_nodes: int,
    num_edges: int,
    config: SolverConfig | None = None,
    device="cuda",
) -> list[dict]:
    """Per-knob provenance rows for ``pjtpu info``: where each tunable's
    effective value comes from (``seed`` / ``cpu-calibrated`` /
    ``tuner-promoted``) with the backing profile-record line when one
    exists. ``platform`` defaults to ``device``'s."""
    config = config or SolverConfig()
    platform = platform or current_platform(device)
    v, e = int(num_nodes), int(num_edges)
    rows = []
    for knob in tunable_knobs():
        spec = KNOB_SPECS[knob]
        seed = spec.seed(config, v, e)
        prov = param_provenance(
            knob, store_dir=str(store_dir) if store_dir else None,
            platform=platform, num_nodes=v, num_edges=e, fallback=seed,
        )
        rows.append({"knob": knob, "plan": spec.plan, "seed": seed, **prov})
    return rows
