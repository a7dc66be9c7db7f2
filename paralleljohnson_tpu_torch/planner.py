"""Priced planner registry: the port's route dispatch as data.

The JAX package's ``planner.py``, copied for the PyTorch port (it is
standard library only). Every dispatch site of the port
(``backends.torch_backend``'s fan-out and B=1 walks, the solver's
condensed-or-standard choice) declares its routes as :class:`Plan`
entries with

- a **contract** hook: the loud ``NotImplementedError`` checks a forced
  flag carries, run for every dispatch whichever plan serves it;
- a **qualification predicate**: the graph / config preconditions under
  which the plan may serve a solve, returned as (ok, reason);
- a **cost hook**: the route tags the profile store's
  :class:`~paralleljohnson_tpu_torch.observe.store.CostModel` prices the
  plan by (evidence gates such as the dirty-window ``dw_decision`` stay
  inside the plan's own qualification: pricing refines ordering,
  evidence gates entry);
- a **build function**: the kernel invocation, returning a
  ``KernelResult`` (or ``None`` when a required layout is unavailable,
  which hands the solve to the next plan in the ranking);
- a **failure policy**: warn once and disable for this backend
  instance on an auto route, propagate on a forced one.

:func:`select` turns the registry into a decision: contracts first,
then qualification in declared priority order, then, when the profile
store prices both the priority incumbent and a cheaper challenger, a
priced promotion. The promotion is conservative:

- an **unpriced route reads as unpriced, not free**: a challenger is
  promoted above an incumbent only when BOTH carry predictions;
- a **forced flag pins its plan**;
- the challenger must beat the incumbent by more than
  :data:`PLANNER_NOISE_BAND`: the cost model is fitted from min-of-
  samples walls that still wobble run to run, and re-routing inside the
  noise band would flap between bitwise-different (but equally correct)
  kernels per batch.

With no profile store, or an empty one, every selection is the declared
priority order: the routes, and so the distances, are those of the
plain ordered walk.

Standard library only, so offline readers consult the registry without
importing torch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

# Priced-promotion noise band: a challenger must predict more than this
# fraction BELOW the incumbent to displace it. The calibration's
# per-unit seconds are min-of-samples (steady state) but the walls they
# were fitted from wobble 10-20% on shared hosts (the bench_regress
# DEFAULT_BAND rationale); 25% promotes real regime differences (the
# measured route gaps are 2-10x) without flapping inside timing noise.
PLANNER_NOISE_BAND = 0.25

# Every route tag the registry's plans can resolve to (plus the
# solver-level and repair families that share the priced table). The
# ``cli info`` priced-route table walks this list so a route with no
# profile samples appears with an explicit ``unpriced`` marker instead
# of being silently omitted.
KNOWN_ROUTES = (
    "sweep", "sweep-sm", "vm", "vm-blocked", "vm-blocked+dw",
    "pallas-vm", "gs", "gs+dw", "dia", "bucket", "bucket+sweep",
    "frontier", "fw", "fw-tile", "dense-squaring", "dense-iterate",
    "condensed+fw", "incremental-repair", "lookup-host", "lookup-device",
    "hopset+bf",
)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One kernel family's dispatch declaration (see module docstring).

    ``entry`` scopes the plan to a dispatch site: ``"fanout"`` (the
    batched multi-source loop — the registry-driven site), ``"sssp"``
    (the B=1 Bellman-Ford families), ``"solver"`` (solver-level routes
    like the condensed partitioned solve). ``priority`` is the ladder
    position (lower = earlier); with no pricing the ranking IS this
    order. ``price_routes`` are tried in order against the CostModel —
    the first priced tag wins (a family whose route tag varies, e.g.
    ``fw``/``fw-tile``, lists both). ``force_overrides`` is the config
    patch that pins dispatch to this plan — what the bench harness uses
    to measure every qualified plan on one graph. ``tunables`` names
    the knobs (``observe.tuning.TUNABLE_PARAMS`` vocabulary) whose
    value shapes this plan's wall — what the self-proposing tuner
    (the JAX package's ``tuner.py``) enumerates candidates for. ``price_batch``
    overrides the dispatch-level ``batch`` for THIS plan's pricing
    (e.g. an incremental repair is priced at its affected-row count
    while the full re-solve prices at B=V — one ``select()`` call, two
    honest work units)."""

    name: str
    entry: str
    priority: int
    qualify: Callable[[Any], tuple[bool, str]]
    build: Callable[[Any], Any] | None = None
    contract: Callable[[Any], None] | None = None
    price_routes: tuple[str, ...] = ()
    forced: Callable[[Any], bool] = lambda config: False
    failure: Callable[[Any, Any], None] | None = None
    force_overrides: dict = dataclasses.field(default_factory=dict)
    tunables: tuple[str, ...] = ()
    price_batch: Callable[[Any], int] | None = None


@dataclasses.dataclass
class PlanCandidate:
    """One plan's evaluation inside a :class:`PlanDecision`."""

    plan: Plan
    qualified: bool
    reason: str
    predicted_s: float | None = None
    priced_route: str | None = None
    forced: bool = False

    def as_dict(self) -> dict:
        out = {
            "plan": self.plan.name,
            "qualified": bool(self.qualified),
            "reason": self.reason,
        }
        if self.forced:
            out["forced"] = True
        if self.predicted_s is not None:
            out["predicted_s"] = float(self.predicted_s)
            out["priced_route"] = self.priced_route
        elif self.qualified:
            # The explicit marker: a candidate with no calibration is
            # UNPRICED, never silently omitted or treated as free.
            out["unpriced"] = True
        return out


@dataclasses.dataclass
class PlanDecision:
    """The outcome of one :func:`select` call: the chosen plan, the
    degrade-don't-crash ranking behind it, and the why-line."""

    chosen: PlanCandidate
    ranking: list[PlanCandidate]
    candidates: list[PlanCandidate]
    reason: str
    params: dict = dataclasses.field(default_factory=dict)

    def as_dict(self, *, built: str | None = None) -> dict:
        out = {
            "chosen": self.chosen.plan.name,
            "reason": self.reason,
            "candidates": [c.as_dict() for c in self.candidates],
        }
        if built is not None and built != self.chosen.plan.name:
            # The chosen plan's build degraded (layout unavailable /
            # auto-route failure) and a lower-ranked plan served the
            # solve — the decision record must say what actually ran.
            out["built"] = built
            out["degraded"] = True
        if self.params:
            out["params"] = dict(self.params)
        return out


def select(
    plans: list[Plan],
    ctx: Any,
    *,
    model=None,
    platform: str | None = None,
    num_edges: int | None = None,
    batch: int = 1,
    config=None,
    band: float = PLANNER_NOISE_BAND,
) -> PlanDecision:
    """Pick the cheapest qualified plan (see module docstring for the
    promotion rules). ``model`` is a fitted ``CostModel`` or None (no
    pricing — pure declared priority, i.e. the ladder). Contract hooks
    run FIRST, for every plan, in priority order: a forced-flag
    violation must raise before any route is built, exactly as the
    ladder's top-of-function checks did."""
    ordered = sorted(plans, key=lambda p: p.priority)
    for plan in ordered:
        if plan.contract is not None:
            plan.contract(ctx)
    candidates: list[PlanCandidate] = []
    for plan in ordered:
        ok, reason = plan.qualify(ctx)
        candidates.append(
            PlanCandidate(
                plan=plan,
                qualified=bool(ok),
                reason=reason,
                forced=bool(plan.forced(config)) if config is not None
                else False,
            )
        )
    qualified = [c for c in candidates if c.qualified]
    if not qualified:
        raise RuntimeError(
            "planner: no qualified plan for this dispatch (the registry "
            "must always include an unconditional fallback)"
        )
    if model is not None and num_edges:
        for cand in qualified:
            plan_batch = (
                int(cand.plan.price_batch(ctx))
                if cand.plan.price_batch is not None else batch
            )
            for route in cand.plan.price_routes:
                pred = model.predict(
                    route, num_edges=num_edges, batch=plan_batch,
                    platform=platform,
                )
                if pred is not None:
                    cand.predicted_s = float(pred["predicted_s"])
                    cand.priced_route = route
                    break
    forced = [c for c in qualified if c.forced]
    incumbent = qualified[0]
    chosen = incumbent
    if forced:
        chosen = forced[0]
        reason = (
            f"forced by config ({chosen.plan.name}): qualification "
            "override pins the plan regardless of price"
        )
    elif incumbent.predicted_s is not None:
        challengers = [
            c for c in qualified[1:]
            if c.predicted_s is not None
            and c.predicted_s < incumbent.predicted_s * (1.0 - band)
        ]
        if challengers:
            chosen = min(challengers, key=lambda c: c.predicted_s)
            reason = (
                f"priced: {chosen.plan.name} predicts "
                f"{chosen.predicted_s:.4g}s < incumbent "
                f"{incumbent.plan.name} {incumbent.predicted_s:.4g}s "
                f"(> {band:.0%} apart)"
            )
        else:
            reason = (
                f"priority: incumbent {incumbent.plan.name} "
                f"({incumbent.predicted_s:.4g}s predicted) has no "
                f"challenger beyond the {band:.0%} noise band"
            )
    else:
        reason = (
            f"priority: {incumbent.plan.name} is the first qualified "
            "plan and is unpriced (no calibration for this shape — "
            "priced promotion needs both routes priced)"
        )
    ranking = [chosen] + [c for c in qualified if c is not chosen]
    return PlanDecision(
        chosen=chosen, ranking=ranking, candidates=candidates,
        reason=reason,
    )


# -- the serving-tier lookup family ------------------------------------------
#
# The query engine dispatches each aggregated batch's LOOKUP work (exact
# hot hits + landmark bounds) through this registry exactly like the
# backend dispatches a fan-out: ``device_lookup`` megabatches the batch
# into one kernel launch over the store's device tile, ``host_lookup``
# is the per-source tier walk the engine always had. Both produce
# bitwise-identical answers (the device path's design invariant — see
# ``serve/device_query.py``), so the choice is pure economics: tiny
# batches and CPU platforms keep the host path by qualification, a
# priced calibration or a forced ``device_lookup="on"``/``"off"`` pin
# overrides. The ``ctx`` is the engine's per-batch lookup context
# (``platform`` / ``device_available`` / ``device_reason`` /
# ``n_device_eligible`` / ``forced_on``); ``config`` carries the
# engine's ``device_lookup`` tristate.

# Below this many device-eligible lookups in a batch the kernel-launch
# overhead dwarfs the per-query saving — the host walk keeps them.
MIN_DEVICE_LOOKUP_BATCH = 4


def _qual_device_lookup(ctx):
    if not getattr(ctx, "device_available", False):
        return False, getattr(ctx, "device_reason",
                              "device query path unavailable")
    if getattr(ctx, "forced_on", False):
        return True, "device megabatch (pinned by device_lookup='on')"
    n = int(getattr(ctx, "n_device_eligible", 0))
    if n < MIN_DEVICE_LOOKUP_BATCH:
        return False, (
            f"tiny batch ({n} device-eligible lookups < "
            f"{MIN_DEVICE_LOOKUP_BATCH}): host walk keeps it"
        )
    if getattr(ctx, "platform", "cpu") == "cpu":
        return False, (
            "cpu platform: host tier walk is the measured default; "
            "promotable when priced cheaper or forced"
        )
    return True, (
        f"device backend with {n} device-eligible lookups: one "
        "megabatched launch beats per-query host round-trips"
    )


LOOKUP_PLANS = [
    Plan(
        name="device_lookup", entry="serve", priority=10,
        qualify=_qual_device_lookup,
        price_routes=("lookup-device",),
        forced=lambda cfg: getattr(cfg, "device_lookup", "auto") == "on",
        force_overrides={"device_lookup": "on"},
    ),
    Plan(
        name="host_lookup", entry="serve", priority=20,
        qualify=lambda ctx: (True, "unconditional host tier-walk fallback"),
        price_routes=("lookup-host",),
        forced=lambda cfg: getattr(cfg, "device_lookup", "auto") == "off",
        force_overrides={"device_lookup": "off"},
    ),
]


def tune_record(
    *,
    knob: str,
    value,
    platform: str,
    num_nodes: int,
    num_edges: int,
    batch: int = 1,
    plan: str | None = None,
    wall_s: float | None = None,
    compute_s: float | None = None,
    censored: bool = False,
    budget_s: float | None = None,
    rung: int | None = None,
    label: str = "tuner",
    event: str | None = None,
    reason: str | None = None,
) -> dict:
    """The ``kind: "tune"`` profile-store record: one per
    tuner probe (``event=None``) or per demotion (``event="demote"``,
    written by ``bench_regress`` when a promoted value regresses past
    the noise band). Probe records are what marks a value
    "tuner-promoted" in provenance; a CENSORED probe (killed at its
    wall-clock cap) carries no measured wall and can never promote —
    ``observe.tuning`` skips it by construction. The CostModel's fit
    ignores the kind entirely, so probes never distort route pricing;
    the ordinary ``kind:"plan"``/``"solve"`` records the probe solve
    itself lands are the calibration."""
    out = {
        "ts": time.time(),
        "kind": "tune",
        "label": label,
        "platform": platform,
        "nodes": int(num_nodes),
        "edges": int(num_edges),
        "batch": int(batch),
        "knob": knob,
        "value": value,
    }
    if event is not None:
        out["event"] = event
    if plan is not None:
        out["plan"] = plan
    if censored:
        out["censored"] = True
    if budget_s is not None:
        out["budget_s"] = float(budget_s)
    if rung is not None:
        out["rung"] = int(rung)
    if reason is not None:
        out["reason"] = reason
    measured = {}
    if wall_s is not None:
        measured["wall_s"] = float(wall_s)
    if compute_s is not None:
        measured["compute_s"] = float(compute_s)
    if measured:
        out["measured"] = measured
    return out


def plan_record(
    decision: dict,
    *,
    label: str,
    platform: str,
    num_nodes: int,
    num_edges: int,
    batch: int,
    wall_s: float | None = None,
    compute_s: float | None = None,
) -> dict:
    """The ``kind: "plan"`` profile-store record: one per solve whose
    dispatch went through the registry — what ``bench_regress.py``
    ingests (a planner that starts picking slower routes flags as a
    wall regression against its shape bucket's history) and what the
    auto-tuner reads parameter outcomes from (``observe.tuning``)."""
    out = {
        "ts": time.time(),
        "kind": "plan",
        "label": label,
        "platform": platform,
        "nodes": int(num_nodes),
        "edges": int(num_edges),
        "batch": int(batch),
        "route": decision.get("built") or decision.get("chosen"),
        "chosen": decision.get("chosen"),
        "reason": decision.get("reason"),
        "candidates": decision.get("candidates"),
        "params": decision.get("params") or {},
    }
    if decision.get("degraded"):
        out["degraded"] = True
    measured = {}
    if wall_s is not None:
        measured["wall_s"] = float(wall_s)
    if compute_s is not None:
        measured["compute_s"] = float(compute_s)
    if measured:
        out["measured"] = measured
    return out
