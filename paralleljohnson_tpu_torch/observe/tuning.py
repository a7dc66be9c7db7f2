"""Profile-calibrated auto-tuning of the dispatch free parameters.

Five knobs used to be hand-tuned constants buried in five different
modules:

====================  =========================  =======================
parameter             hand-tuned fallback        consumed by
====================  =========================  =======================
``fw_tile``           512 (roofline-picked)      ``ops.fw`` closure,
                                                 ``solver.partitioned``
``partition_parts``   ~sqrt(V)/8, clamp [2,32]   ``solver.partitioned``
``delta``             mean|w| x degree heuristic ``ops.bucket`` route
``source_batch``      device-memory budget       solver fan-out batching
``pipeline_depth``    2 (double buffering)       solver pipeline window
====================  =========================  =======================

This module converts them into one calibration loop: every solve whose
dispatch went through the planner registry lands a ``kind: "plan"``
profile record carrying the RESOLVED parameter values plus the
measured wall (``planner.plan_record``). :func:`tuned_value` reads
those records back per ``(platform, shape bucket)`` and picks the
parameter value whose best recorded wall is lowest — so an explicit
``--fw-tile 256`` run that measures faster than the 512 default
becomes the auto default for that platform/shape from then on.

Honesty rules:

- **empty store → hand-tuned constant**, always (the acceptance
  contract): with no records, or records for only ONE observed value,
  there is nothing to compare and the fallback stands — a single
  sample proves nothing about the alternatives;
- values are only compared WITHIN a (platform, V-bucket, E-bucket)
  key — a tile that wins on a dense 2^11 closure says nothing about a
  2^14 one;
- an explicit config value always wins over the tuner (set the knob,
  get the knob), and the resolution source ("config" /
  "profile-tuned" / "default") rides on every plan record and
  why-line so a surprising value is attributable.

Stdlib-only (the ``observe`` discipline).
"""

from __future__ import annotations

import os
from pathlib import Path

# The hand-tuned constants the tuner falls back to (single source of
# truth — config.py and the resolution sites import from here).
DEFAULT_FW_TILE = 512
DEFAULT_PIPELINE_DEPTH = 2

# The tunable-parameter vocabulary plan records carry. ``approx_beta``
# is there too: the hopset relay cap is a per-shape schedule like
# any other knob (PAPERS.md: approximate-shortest-path parameter
# schedules are regime-dependent).
TUNABLE_PARAMS = (
    "fw_tile", "partition_parts", "delta", "source_batch",
    "pipeline_depth", "approx_beta",
)

# A profile-tuned value must beat a MEASURED fallback (seed) wall by
# more than this fraction to displace it — the same calibrated-
# challenger rule the planner applies to routes
# (``planner.PLANNER_NOISE_BAND``); kept numerically in lock-step by
# test_planner. An unmeasured fallback has nothing to defend with, so
# the min-of-best-walls rule stands.
TUNE_NOISE_BAND = 0.25

# A value needs at least this many distinct observed alternatives in
# the key before the tuner overrides the hand-tuned constant: one
# observed value has nothing to beat.
MIN_DISTINCT_VALUES = 2

# records cache keyed by (path, mtime_ns, size) — the store is
# append-only and finalize_solve appends AFTER a solve completes, so
# one solve's many batches re-read the file at most once.
_CACHE: dict = {}


def cached_records(store_dir: str | Path | None) -> list[dict]:
    if store_dir is None:
        return []
    from paralleljohnson_tpu_torch.observe.store import PROFILE_FILENAME

    path = Path(store_dir) / PROFILE_FILENAME
    try:
        st = path.stat()
    except OSError:
        return []
    key = (str(path), st.st_mtime_ns, st.st_size)
    hit = _CACHE.get(str(path))
    if hit is not None and hit[0] == key:
        return hit[1]
    from paralleljohnson_tpu_torch.observe.store import ProfileStore

    try:
        records = ProfileStore(store_dir).records()
    except ValueError:
        # A corrupt store must not crash dispatch; the solve record
        # writer will surface the corruption on its own append path.
        records = []
    _CACHE.clear()  # one store per process in practice; stay bounded
    _CACHE[str(path)] = (key, records)
    return records


def _bucket(num_nodes: int, num_edges: int) -> tuple[int, int]:
    from paralleljohnson_tpu_torch.observe.costs import shape_bucket

    return shape_bucket(num_nodes, num_edges, 1)[:2]


def _best_walls(
    name: str,
    records: list,
    *,
    platform: str,
    want: tuple,
    validate=None,
) -> dict:
    """Per-value best recorded walls for one knob in one (platform,
    shape-bucket) key: ``{value: {"wall", "record", "kind",
    "tune_record"}}`` where ``record`` is the backing line index in
    ``profiles.jsonl`` and ``tune_record`` is the index of a
    non-censored ``kind:"tune"`` probe for the value (None when only
    plan records back it — i.e. a human-driven run, not the tuner).

    Two honesty rules beyond the plan-record path:

    - a **censored probe never counts** — a probe killed at its
      wall-clock cap proves the value is SLOWER than the cap, not how
      fast it is; promoting from a censored wall would reward the
      kill, so censored tune records are skipped entirely;
    - a **demotion erases history**: a ``kind:"tune", event:"demote"``
      record (written by ``bench_regress`` when a promoted value
      regresses past the noise band) invalidates every record of that
      value with ``ts`` at or before the demotion — newer probes can
      re-promote, stale wins cannot."""
    demoted: dict = {}
    for r in records:
        if r.get("kind") != "tune" or r.get("event") != "demote":
            continue
        if r.get("knob") != name or r.get("platform") != platform:
            continue
        if _bucket(r.get("nodes") or 0, r.get("edges") or 0) != want:
            continue
        v = r.get("value")
        ts = r.get("ts") or 0
        if v is not None and ts >= demoted.get(v, 0):
            demoted[v] = ts
    best: dict = {}
    for idx, r in enumerate(records):
        kind = r.get("kind")
        if kind == "plan":
            value = (r.get("params") or {}).get(name)
        elif kind == "tune":
            if r.get("event") == "demote" or r.get("censored"):
                continue
            if r.get("knob") != name:
                continue
            value = r.get("value")
        else:
            continue
        if value is None:
            continue
        if r.get("platform") != platform:
            continue
        if _bucket(r.get("nodes") or 0, r.get("edges") or 0) != want:
            continue
        if validate is not None and not validate(value):
            continue
        measured = r.get("measured") or {}
        wall = measured.get("compute_s") or measured.get("wall_s")
        if not isinstance(wall, (int, float)) or wall <= 0:
            continue
        if value in demoted and (r.get("ts") or 0) <= demoted[value]:
            continue
        # Min-of-samples per value: timing noise only inflates (the
        # CostModel rationale), so the best recorded wall is the
        # steady-state cost of running with that value.
        entry = best.get(value)
        if entry is None:
            entry = best[value] = {
                "wall": wall, "record": idx, "kind": kind,
                "tune_record": None,
            }
        elif wall < entry["wall"]:
            entry.update(wall=wall, record=idx, kind=kind)
        if kind == "tune" and entry["tune_record"] is None:
            entry["tune_record"] = idx
    return best


def _winner(best: dict, fallback, band: float):
    """The promotion rule shared by :func:`tuned_value` and
    :func:`param_provenance` (see module docstring)."""
    if len(best) < MIN_DISTINCT_VALUES:
        return None
    winner = min(best, key=lambda v: best[v]["wall"])
    if (
        fallback is not None
        and winner != fallback
        and fallback in best
        and not best[winner]["wall"] < best[fallback]["wall"] * (1.0 - band)
    ):
        # The seed defended itself: the challenger's measured edge is
        # inside the noise band, so the hand-tuned value stands.
        return None
    return winner


def tuned_value(
    name: str,
    *,
    records=None,
    store_dir: str | Path | None = None,
    platform: str,
    num_nodes: int,
    num_edges: int,
    validate=None,
    fallback=None,
    band: float = TUNE_NOISE_BAND,
):
    """The profile-tuned value of ``name`` for this (platform, shape
    bucket), or None when the store holds nothing decisive (see module
    docstring). ``validate`` filters candidate values (e.g. fw tiles
    must be 128-multiples). When ``fallback`` (the hand-tuned seed) has
    a measured wall in the same key, a different winner must beat it by
    more than ``band`` — the planner's calibrated-challenger rule
    applied to parameter values."""
    if name not in TUNABLE_PARAMS:
        raise ValueError(
            f"unknown tunable parameter {name!r}; expected one of "
            f"{TUNABLE_PARAMS}"
        )
    if records is None:
        records = cached_records(store_dir)
    if not records:
        return None
    best = _best_walls(
        name, records, platform=platform,
        want=_bucket(num_nodes, num_edges), validate=validate,
    )
    return _winner(best, fallback, band)


def param_provenance(
    name: str,
    *,
    records=None,
    store_dir: str | Path | None = None,
    platform: str,
    num_nodes: int,
    num_edges: int,
    validate=None,
    fallback=None,
    band: float = TUNE_NOISE_BAND,
) -> dict:
    """Where one knob's effective value comes from, for ``pjtpu info``:
    ``{"value", "source", "record", "wall_s",
    "values_seen"}`` with source one of

    - ``"seed"`` — the hand-tuned constant stands (nothing decisive
      measured, or the challenger lost to the measured seed);
    - ``"cpu-calibrated"`` — a human-driven run (explicit config value)
      measured faster and the store promoted it;
    - ``"tuner-promoted"`` — the winning value is backed by a
      ``kind:"tune"`` probe record, i.e. the self-proposing tuner
      discovered it.

    ``record`` is the backing line index into ``profiles.jsonl`` (the
    record whose wall won), None for seed."""
    if records is None:
        records = cached_records(store_dir)
    best = _best_walls(
        name, records or [], platform=platform,
        want=_bucket(num_nodes, num_edges), validate=validate,
    )
    winner = _winner(best, fallback, band)
    if winner is None:
        return {
            "value": fallback, "source": "seed", "record": None,
            "wall_s": (
                best[fallback]["wall"] if fallback in best else None
            ),
            "values_seen": len(best),
        }
    entry = best[winner]
    tuned = entry["tune_record"] is not None
    return {
        "value": winner,
        "source": "tuner-promoted" if tuned else "cpu-calibrated",
        "record": entry["record"],
        "wall_s": entry["wall"],
        "values_seen": len(best),
    }


def resolve_param(
    name: str,
    explicit,
    fallback,
    *,
    config=None,
    store_dir: str | Path | None = None,
    platform: str,
    num_nodes: int,
    num_edges: int,
    validate=None,
) -> tuple:
    """Resolve one tunable parameter to ``(value, source)`` where
    source is ``"config"`` (explicit value set), ``"profile-tuned"``
    (the store's calibration picked it), or ``"default"`` (the
    hand-tuned constant). ``store_dir`` defaults to the config's
    profile store (+ ``PJ_PROFILE_DIR``)."""
    if explicit is not None:
        return explicit, "config"
    if store_dir is None and config is not None:
        from paralleljohnson_tpu_torch.observe.costs import resolve_profile_dir

        store_dir = resolve_profile_dir(
            getattr(config, "profile_store", None)
        )
    if store_dir is not None and os.environ.get("PJ_NO_TUNE") != "1":
        tuned = tuned_value(
            name, store_dir=store_dir, platform=platform,
            num_nodes=num_nodes, num_edges=num_edges, validate=validate,
            fallback=fallback,
        )
        if tuned is not None:
            return tuned, "profile-tuned"
    return fallback, "default"
