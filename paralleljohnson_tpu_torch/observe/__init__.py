"""Observability of the PyTorch port: why a solve costs what it costs.

- :mod:`~paralleljohnson_tpu_torch.observe.convergence`: the
  per-iteration trajectory counters of the relaxation loops and the
  dirty-window decision that reads them;
- :mod:`~paralleljohnson_tpu_torch.observe.costs`: the analytic bytes and
  operations of every route (``cost_source: "analytic-model"``);
- :mod:`~paralleljohnson_tpu_torch.observe.store`: the append-only
  profile store (``profiles.jsonl``, the JAX package's schema) and the
  :class:`~paralleljohnson_tpu_torch.observe.store.CostModel` the planner
  prices routes with;
- :mod:`~paralleljohnson_tpu_torch.observe.roofline`: bandwidth, compute
  or host-IO bound, from the analytic costs and the measured phases;
- :mod:`~paralleljohnson_tpu_torch.observe.tuning`: the profile-tuned
  values of the dispatch's free parameters.

:func:`finalize_solve` ties them together after every solve. Everything
here is standard library (plus numpy in the trajectory decode), so
offline readers import it without torch.
"""

from __future__ import annotations

import subprocess
import sys

from paralleljohnson_tpu_torch.observe.convergence import (  # noqa: F401
    DEFAULT_TRAJ_CAP,
    degree_bias_from_degrees,
    dw_decision,
    estimate_eta,
    frontier_curve,
    summarize_trajectory,
    trajectory_record,
)
from paralleljohnson_tpu_torch.observe.costs import (  # noqa: F401
    CostCapture,
    resolve_profile_dir,
    shape_bucket,
)
from paralleljohnson_tpu_torch.observe.roofline import (  # noqa: F401
    PLATFORM_PEAKS,
    attribute_stats,
    classify,
)
from paralleljohnson_tpu_torch.observe.store import (  # noqa: F401
    PROFILE_FILENAME,
    CostModel,
    ProfileStore,
    solve_record,
)
from paralleljohnson_tpu_torch.observe.tuning import (  # noqa: F401
    DEFAULT_FW_TILE,
    DEFAULT_PIPELINE_DEPTH,
    TUNABLE_PARAMS,
    TUNE_NOISE_BAND,
    cached_records,
    param_provenance,
    resolve_param,
    tuned_value,
)

# nvidia-smi's name and power limit per card index, read once per process.
_CARD_INFO: dict = {}


def current_platform(device=None) -> str:
    """The platform profile records are keyed by: ``"cuda"`` when
    ``device`` (a ``torch.device`` or its string) is a card, else
    ``"cpu"``. Imports nothing."""
    kind = getattr(device, "type", None) or str(device or "cpu")
    return "cuda" if kind.split(":")[0] == "cuda" else "cpu"


def card_info(device) -> dict:
    """The card's name (``torch.cuda.get_device_name``) and its power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` reports it
    (``"unknown"`` where nvidia-smi cannot say): what a ``cuda`` record
    carries beside its times, since a card set below its maximum power
    runs slower under load."""
    torch = sys.modules.get("torch")
    index = getattr(device, "index", None) or 0
    info = _CARD_INFO.get(index)
    if info is None:
        name = torch.cuda.get_device_name(index) if torch else "unknown"
        try:
            line = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader", f"--id={index}"],
                capture_output=True, text=True, check=True, timeout=30,
            ).stdout.strip().splitlines()[0]
            power = line.split(",")[-1].strip()
        except (OSError, subprocess.SubprocessError, IndexError):
            power = "unknown"
        info = _CARD_INFO[index] = {"name": name, "power_limit": power}
    return dict(info)


def primary_route(stats) -> str | None:
    """The route tag a solve's profile record is calibrated under: the
    fan-out's (the dominant phase), else the B=1 / batch route."""
    routes = getattr(stats, "routes_by_phase", None) or {}
    for phase in ("fanout", "bellman_ford", "batch_apsp"):
        if routes.get(phase):
            return routes[phase]
    return None


def finalize_solve(
    stats,
    *,
    config,
    device=None,
    telemetry=None,
    label: str = "solve",
    num_nodes: int = 0,
    num_edges: int = 0,
    batch: int = 1,
    degree_bias: float | None = None,
) -> dict | None:
    """Post-solve hook (the solver calls it for every completed solve):
    roofline-attribute ``stats``, publish the bound to the heartbeat of
    ``telemetry`` (when given) and, when a profile store is configured,
    predict this solve from the store's calibration and append its
    ``plan``, ``solve`` and ``trajectory`` records. Returns the roofline
    dict (also left on ``stats.roofline``)."""
    platform = current_platform(device)
    roof = attribute_stats(stats, platform=platform,
                           precision=getattr(config, "precision", "f32"))
    stats.roofline = roof
    if telemetry is not None and roof:
        telemetry.progress(roofline_bound=roof.get("bound"))
    store_dir = resolve_profile_dir(getattr(config, "profile_store", None))
    if not store_dir:
        return roof
    extra = {"device": card_info(device)} if platform == "cuda" else {}
    store = ProfileStore(store_dir)
    route = primary_route(stats)
    if route is not None:
        # Predicted from the calibration BEFORE this run's record lands,
        # so prediction against measurement stays out of sample.
        pred = CostModel.fit(store).predict(
            route, num_edges=num_edges, batch=batch, platform=platform
        )
        if pred is not None:
            stats.predicted_s = pred["predicted_s"]
    # One ``kind: "plan"`` record per solve whose dispatch went through
    # the registry: the dominant phase's decision (as the JAX package's
    # record holds its last walk), else the solver-level one, with the
    # resolved tuned parameters, beside the measured wall.
    phase_plans = getattr(stats, "plans_by_phase", None) or {}
    decision = next((phase_plans[p] for p in ("fanout", "bellman_ford",
                                              "batch_apsp")
                     if phase_plans.get(p)), None) or getattr(
                         stats, "plan", None)
    phase_seconds = dict(getattr(stats, "phase_seconds", {}) or {})
    if decision:
        from paralleljohnson_tpu_torch.planner import plan_record

        decision = dict(decision)
        params = dict(decision.get("params") or {})
        if getattr(stats, "final_batch", None):
            params.setdefault("source_batch", int(stats.final_batch))
        if getattr(stats, "final_pipeline_depth", None):
            params.setdefault(
                "pipeline_depth", int(stats.final_pipeline_depth)
            )
        decision["params"] = params
        store.append({
            **plan_record(
                decision,
                label=label,
                platform=platform,
                num_nodes=num_nodes,
                num_edges=num_edges,
                batch=batch,
                wall_s=float(sum(phase_seconds.values())),
                compute_s=float(
                    sum(
                        s for k, s in phase_seconds.items()
                        if k in ("bellman_ford", "fanout", "batch_apsp")
                    )
                ),
            ),
            **extra,
        })
    store.append({
        **solve_record(
            stats,
            label=label,
            platform=platform,
            route=route,
            num_nodes=num_nodes,
            num_edges=num_edges,
            batch=batch,
        ),
        **extra,
    })
    # One ``kind: "trajectory"`` record per instrumented kernel call (a
    # multi-batch fan-out lands one per batch), keyed by the phase's
    # route.
    routes = getattr(stats, "routes_by_phase", None) or {}
    for phase, trajs in (getattr(stats, "trajectories", None) or {}).items():
        for idx, traj in enumerate(trajs):
            store.append({
                **trajectory_record(
                    traj,
                    label=label,
                    phase=phase,
                    index=idx,
                    route=routes.get(phase) or route,
                    platform=platform,
                    num_nodes=num_nodes,
                    num_edges=num_edges,
                    batch=batch,
                    degree_bias=degree_bias,
                ),
                **extra,
            })
    return roof
