"""PyTorch port: the priced planner (``planner.py``) and the plan
registries of the backend and the solver, on the CPU against the JAX
package.

``select`` must give the same decision (chosen plan, ranking, reason,
candidates) in both packages on the same plans and the same profile
records. The registries declare the reference's plans (names,
priorities, price routes, forced flags, force overrides, tunables). With
no profile store every walk is unpriced and takes the route the plain
ordered walk took before the registries: the table below pins it."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu import planner as ref_planner
from paralleljohnson_tpu.backends import jax_backend
from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import erdos_renyi, grid2d, permute_labels, rmat
from paralleljohnson_tpu.observe.store import CostModel as RefCostModel
from paralleljohnson_tpu.solver import johnson as ref_johnson

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop, planner
from paralleljohnson_tpu_torch.backends import torch_backend
from paralleljohnson_tpu_torch.observe import ProfileStore
from paralleljohnson_tpu_torch.observe.store import CostModel
from paralleljohnson_tpu_torch.solver import johnson as port_johnson
from paralleljohnson_tpu_torch.solver.johnson import to_numpy



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several pytest
    workers on the CPU, and torch's thread pool oversubscribed by them
    slows the small ops of these loops by orders of magnitude (one
    dirty-window fixpoint on the 48x48 grid: 22 s against 0.03 s with
    eight busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def test_planner_constants_equal_reference():
    assert planner.PLANNER_NOISE_BAND == ref_planner.PLANNER_NOISE_BAND
    assert planner.KNOWN_ROUTES == ref_planner.KNOWN_ROUTES
    assert planner.MIN_DEVICE_LOOKUP_BATCH == \
        ref_planner.MIN_DEVICE_LOOKUP_BATCH
    fields = ("name", "entry", "priority", "price_routes", "force_overrides")
    assert [tuple(getattr(p, f) for f in fields) for p in planner.LOOKUP_PLANS] \
        == [tuple(getattr(p, f) for f in fields)
            for p in ref_planner.LOOKUP_PLANS]


# -- select() on the same plans and records ----------------------------------

# (name, priority, qualifies, price routes, forced by cfg.pin == name)
SPEC = [
    ("a", 10, True, ("ra",)),
    ("b", 20, False, ("rb",)),
    ("c", 30, True, ("rc", "rc2")),
    ("d", 40, True, ("rd",)),
    ("e", 50, True, ()),
]


def _plans(mod):
    return [
        mod.Plan(name=n, entry="fanout", priority=p,
                 qualify=(lambda ctx, ok=ok, n=n: (ok, f"{n} says {ok}")),
                 price_routes=routes,
                 forced=(lambda cfg, n=n: getattr(cfg, "pin", None) == n))
        for n, p, ok, routes in SPEC
    ]


def _rec(route, compute_s, *, edges=1000, batch=8, platform="cpu"):
    return {"kind": "solve", "label": "t", "route": route,
            "platform": platform, "nodes": 100, "edges": edges,
            "batch": batch, "measured": {"wall_s": compute_s,
                                         "compute_s": compute_s},
            "edges_relaxed": 1, "iterations": 0, "cost": {}}


SCENARIOS = {
    "unpriced": ([], None),
    "promotion": ([_rec("ra", 1.0), _rec("rc2", 0.5), _rec("rd", 0.6)], None),
    "inside-noise-band": ([_rec("ra", 1.0), _rec("rc", 0.8)], None),
    "incumbent-unpriced": ([_rec("rc", 0.01), _rec("rd", 0.02)], None),
    "other-platform": ([_rec("ra", 1.0), _rec("rc", 0.1, platform="cuda")],
                       None),
    "forced": ([_rec("ra", 1.0), _rec("rc", 0.1)], "d"),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_select_gives_the_reference_decision(scenario):
    records, pin = SCENARIOS[scenario]
    cfg = types.SimpleNamespace(pin=pin)
    ctx = types.SimpleNamespace()
    got = planner.select(
        _plans(planner), ctx,
        model=CostModel.fit(records) if records else None, platform="cpu",
        num_edges=1000, batch=8, config=cfg)
    want = ref_planner.select(
        _plans(ref_planner), ctx,
        model=RefCostModel.fit(records) if records else None,
        platform="cpu", num_edges=1000, batch=8, config=cfg)
    assert got.as_dict() == want.as_dict()
    assert [c.plan.name for c in got.ranking] == \
        [c.plan.name for c in want.ranking]
    assert got.reason == want.reason


def test_select_without_a_qualified_plan_raises_in_both():
    plans = [p for p in _plans(planner) if p.name == "b"]
    ref_plans = [p for p in _plans(ref_planner) if p.name == "b"]
    for mod, ps in ((planner, plans), (ref_planner, ref_plans)):
        with pytest.raises(RuntimeError, match="no qualified plan"):
            mod.select(ps, types.SimpleNamespace())


def test_plan_and_tune_records_equal_reference():
    decision = {"chosen": "fw", "built": "dense", "degraded": True,
                "reason": "why", "candidates": [{"plan": "fw"}],
                "params": {"fw_tile": 256}}
    kw = dict(label="solve", platform="cpu", num_nodes=300, num_edges=9000,
              batch=300, wall_s=1.5, compute_s=1.25)
    strip = lambda r: {k: v for k, v in r.items() if k != "ts"}  # noqa: E731
    assert strip(planner.plan_record(decision, **kw)) == strip(
        ref_planner.plan_record(decision, **kw))
    tune = dict(knob="fw_tile", value=256, platform="cpu", num_nodes=300,
                num_edges=9000, batch=300, plan="fw", wall_s=0.5,
                censored=False, budget_s=2.0, rung=1, event=None,
                reason="probe")
    assert strip(planner.tune_record(**tune)) == strip(
        ref_planner.tune_record(**tune))


# -- the registries ----------------------------------------------------------

CONFIGS = [{}, {"dia": True}, {"gauss_seidel": True}, {"fw": True},
           {"dirty_window": True}, {"bucket": True}, {"frontier": True},
           {"partitioned": True}, {"partitioned": False},
           {"edge_shard": True}, {"fw": False, "dirty_window": False}]


@pytest.mark.parametrize("which", ["FANOUT_PLANS", "SSSP_PLANS",
                                   "SOLVER_PLANS"])
def test_registries_declare_the_reference_plans(which):
    if which == "SOLVER_PLANS":
        port, ref = port_johnson.SOLVER_PLANS, ref_johnson.SOLVER_PLANS
    else:
        port, ref = (getattr(torch_backend, which),
                     getattr(jax_backend, which))
    fields = ("name", "entry", "priority", "price_routes", "force_overrides",
              "tunables")
    assert [tuple(getattr(p, f) for f in fields) for p in port] == \
        [tuple(getattr(p, f) for f in fields) for p in ref]
    for kw in CONFIGS:
        cfg = RefConfig(**kw)
        assert [p.forced(cfg) for p in port] == [p.forced(cfg) for p in ref]


# -- the unpriced walk takes the route of the plain ordered walk --------------

GRAPHS = {
    "rmat8": lambda: rmat(8, 8, seed=3),
    "grid24": lambda: permute_labels(grid2d(24, 24, seed=7), seed=11),
    "grid24-neg": lambda: grid2d(24, 24, negative_fraction=0.2, seed=1),
    "er300": lambda: erdos_renyi(300, 0.2, seed=7),
    "er64": lambda: erdos_renyi(64, 0.15, seed=5),
}

# (graph, config, sources (None = all), phase -> route)
WALKS = [
    ("rmat8", {}, 8, {"fanout": "pallas-vm"}),
    ("rmat8", {"use_pallas": False}, 8, {"fanout": "vm"}),
    ("rmat8", {"fanout_layout": "source_major"}, 8, {"fanout": "sweep-sm"}),
    ("rmat8", {"use_pallas": False, "fanout_layout": "source_major"}, 8,
     {"fanout": "sweep-sm"}),
    ("grid24-neg", {}, 8, {"bellman_ford": "frontier", "fanout": "pallas-vm"}),
    ("grid24-neg", {"frontier": False}, 8,
     {"bellman_ford": "sweep", "fanout": "pallas-vm"}),
    ("grid24-neg", {"dia": True}, 8, {"bellman_ford": "dia", "fanout": "dia"}),
    ("grid24-neg", {"gauss_seidel": True}, 8,
     {"bellman_ford": "gs", "fanout": "gs"}),
    ("grid24-neg", {"bucket": True}, 8,
     {"bellman_ford": "bucket", "fanout": "pallas-vm"}),
    ("grid24", {"dirty_window": True}, 8, {"fanout": "vm-blocked+dw"}),
    ("er300", {}, None, {"fanout": "fw"}),
    ("er300", {"fw": False}, None, {"fanout": "dense-squaring-pallas"}),
    ("er64", {}, 8, {"fanout": "dense-iterate-pallas"}),
    ("er64", {"use_pallas": False}, 8, {"fanout": "dense-iterate"}),
]


@pytest.mark.parametrize("name,kw,b,routes", WALKS,
                         ids=[f"{w[0]}-{i}" for i, w in enumerate(WALKS)])
def test_unpriced_walk_takes_the_ordered_walks_route(name, kw, b, routes):
    """No profile store: each phase takes the pinned route, its decision
    says it is the first qualified plan (or the forced one), and the
    candidates are the reference's plans in the reference's order."""
    g = _port(GRAPHS[name]())
    sources = None if b is None else np.arange(b)
    res = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**kw),
                                    device="cpu").solve(g, sources)
    assert dict(res.stats.routes_by_phase) == routes
    assert res.stats.plan["chosen"] == "standard"
    for phase, decision in res.stats.plans_by_phase.items():
        plans = (jax_backend.FANOUT_PLANS if phase == "fanout"
                 else jax_backend.SSSP_PLANS)
        assert [c["plan"] for c in decision["candidates"]] == [
            p.name for p in plans]
        assert decision["reason"].startswith(("priority: ",
                                              "forced by config"))
        assert "built" not in decision
        unpriced = [c for c in decision["candidates"] if c["qualified"]]
        assert unpriced and all(c.get("unpriced") for c in unpriced)


def test_priced_walk_promotes_and_planner_false_keeps_the_order(tmp_path):
    """A store that prices ``vm`` 100x below ``pallas-vm`` at this shape
    promotes it past the noise band (rows bitwise equal); ``planner=False``
    keeps the declared order with the same store."""
    g = _port(GRAPHS["rmat8"]())
    b = 8
    store = ProfileStore(tmp_path)
    for route, secs in (("pallas-vm", 1.0), ("vm", 0.01)):
        store.append(_rec(route, secs, edges=g.num_real_edges, batch=b))
    be = pjt.get_backend("torch", pjt.SolverConfig(profile_store=str(
        tmp_path)), device="cpu")
    preview = be.plan_preview(be.upload(g), b)
    assert preview["chosen"] == "vm" and preview["params"]["fw_tile"] == 512
    srcs = np.arange(b)
    priced = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(profile_store=str(tmp_path)),
        device="cpu").multi_source(g, srcs)
    assert priced.stats.routes_by_phase["fanout"] == "vm"
    decision = priced.stats.plans_by_phase["fanout"]
    assert decision["chosen"] == "vm"
    assert decision["reason"].startswith("priced: vm predicts")
    off = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(profile_store=str(tmp_path), planner=False),
        device="cpu").multi_source(g, srcs)
    assert off.stats.routes_by_phase["fanout"] == "pallas-vm"
    np.testing.assert_array_equal(to_numpy(priced.dist), to_numpy(off.dist))


def test_solver_plans_view_and_condensed_qualification():
    """``_use_partitioned`` is a view over the ``SOLVER_PLANS`` walk: the
    decision's candidates are the reference's, and ``partitioned=True``
    forces the condensed plan."""
    g = _port(GRAPHS["grid24"]())
    for flag, taken in (("auto", False), (False, False), (True, True)):
        solver = pjt.ParallelJohnsonSolver(
            pjt.SolverConfig(partitioned=flag), device="cpu")
        assert solver._use_partitioned(g, np.arange(576))[0] is taken
        decision = solver._solver_decision(g, np.arange(576))
        assert [c.plan.name for c in decision.candidates] == [
            "condensed+fw", "standard"]
