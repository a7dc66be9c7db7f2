"""PyTorch port: the dirty-window routes (``vm-blocked+dw``, ``gs+dw``) and
their evidence gate, on the CPU against the JAX package.

The layout builders must give equal arrays; ``bellman_ford_sweeps_dw``
must give bitwise rows, the same rounds, the same exact examined-slot
count, the same overflow (full-sweep) rounds and the same trajectory.
Forced solves take the reference's route tags with bitwise rows (integer
weights); ``dirty_window="auto"`` engages only on a profile store's
trajectory records, in both packages with the same reason."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import grid2d, permute_labels, rmat
from paralleljohnson_tpu.observe import convergence as ref_conv
from paralleljohnson_tpu.ops import relax as ref_relax
from paralleljohnson_tpu.solver import ParallelJohnsonSolver as RefSolver

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.observe import ProfileStore
from paralleljohnson_tpu_torch.observe import convergence as port_conv
from paralleljohnson_tpu_torch.ops import relax as port_relax
from paralleljohnson_tpu_torch.solver.johnson import to_numpy

ONE = dict(mesh_shape=(1,), fw=False, frontier=False, dia=False,
           gauss_seidel=False, bucket=False)



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


def _grid(rows, *, neg=0.0):
    g = grid2d(rows, rows, negative_fraction=neg, seed=7)
    return permute_labels(g, seed=11)


def _int(g):
    return g.with_weights(np.round(g.weights))


GRAPHS = {
    "grid24": lambda: _grid(24),
    "grid48": lambda: _grid(48),
    "grid24-neg": lambda: _int(_grid(24, neg=0.2)),
    "rmat8": lambda: rmat(8, 8, seed=3),
    "rmat10": lambda: rmat(10, 8, seed=3),
}


def _sources(g, b, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(g.num_nodes, size=b, replace=False))


def _solvers(**kw):
    ref_cfg = RefConfig(**{**ONE, **kw})
    cfg = interop.config_from_dict(dataclasses.asdict(ref_cfg))
    return RefSolver(ref_cfg), pjt.ParallelJohnsonSolver(cfg, device="cpu")


# -- the layout and the fixpoint ---------------------------------------------


@pytest.mark.parametrize("name", ["grid24", "rmat8"])
@pytest.mark.parametrize("vb", [1, 4, 7])
def test_dw_layout_and_capacity_equal_reference(name, vb):
    g = GRAPHS[name]()
    v = g.num_nodes
    ref = ref_relax.build_dw_layout(g.indptr, g.indices, v, vb=vb)
    got = port_relax.build_dw_layout(g.indptr, g.indices, v, vb=vb)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
    for cap in (1, 8, 64, 1 << 20):
        for b in (1, 8, 16, 4096):
            assert port_relax.dw_capacity_clamp(cap, got["nb"], got["em"], b) \
                == ref_relax.dw_capacity_clamp(cap, ref["nb"], ref["em"], b)


def _dw_inputs(g, b, vb):
    """The reference's and the port's arguments of one dw fixpoint from
    ``b`` seeded sources: the tiles with the graph's weights gathered, the
    destination-sorted padded COO and the [V, B] start."""
    v, e = g.num_nodes, g.num_real_edges
    lay = port_relax.build_dw_layout(g.indptr, g.indices, v, vb=vb)
    w = g.weights[:e].astype(np.float32)
    eo = lay["edge_order"]
    w_tile = np.where(eo >= 0, w[np.maximum(eo, 0)], np.inf).astype(np.float32)
    gp = g.pad_edges(512)
    order = np.argsort(gp.indices, kind="stable")
    coo = (gp.src.astype(np.int32)[order], gp.indices.astype(np.int32)[order],
           gp.weights.astype(np.float32)[order])
    d0 = np.full((v, b), np.inf, np.float32)
    d0[_sources(g, b), np.arange(b)] = 0.0
    tiles = (lay["e_src"], lay["e_dst"], w_tile, lay["blk_of_v"])
    return lay, d0, tiles, coo


@pytest.mark.parametrize("name,b", [("grid24", 8), ("grid48", 16),
                                    ("rmat10", 16)])
@pytest.mark.parametrize("vb,cap", [(1, 64), (1, 1 << 20), (4, 16)])
def test_dw_fixpoint_bitwise_counters_and_trajectory(name, b, vb, cap):
    """Rows bitwise, rounds, the exact examined slots, the overflow rounds
    and the trajectory (with its dirty-block curve) all equal the
    reference's; the rows also equal plain ``vm``'s fixpoint."""
    g = GRAPHS[name]()
    lay, d0, tiles, coo = _dw_inputs(g, b, vb)
    v, e = g.num_nodes, g.num_real_edges
    capc = port_relax.dw_capacity_clamp(cap, lay["nb"], lay["em"], b)
    kw = dict(vb=lay["vb"], capacity=capc, max_iter=v, num_real_edges=e,
              edge_chunk=1 << 12, traj_cap=64)
    ref = ref_relax.bellman_ford_sweeps_dw(
        jnp.asarray(d0), *map(jnp.asarray, tiles), *map(jnp.asarray, coo),
        **kw)
    got = port_relax.bellman_ford_sweeps_dw(
        torch.as_tensor(d0), *map(torch.as_tensor, tiles),
        *map(torch.as_tensor, coo), **kw)
    dist, rounds, improving, examined, fulls, counts, resid, dirty = got
    np.testing.assert_array_equal(dist.numpy(), np.asarray(ref[0]))
    assert rounds == int(ref[1]) and improving == bool(ref[2]) is False
    assert port_relax.examined_exact(examined) == ref_relax.examined_exact(
        ref[3], ref[4])
    assert fulls == int(ref[5])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref[6]))
    np.testing.assert_array_equal(dirty, np.asarray(ref[8]))
    # Without the trajectory the loop takes the same steps.
    plain_kw = {**kw, "traj_cap": None}
    again = port_relax.bellman_ford_sweeps_dw(
        torch.as_tensor(d0), *map(torch.as_tensor, tiles),
        *map(torch.as_tensor, coo), **plain_kw)
    assert torch.equal(again[0], dist) and again[1:3] == (rounds, improving)
    vm, _, _ = port_relax.bellman_ford_sweeps_vm(
        torch.as_tensor(d0), *map(torch.as_tensor, coo), max_iter=v,
        edge_chunk=1 << 12)
    assert torch.equal(vm, dist)


def test_dw_analytic_cost_equals_reference():
    for slots, b, item in ((0, 1, 4), (12345, 16, 4), (7, 3, 8)):
        assert port_relax.dw_analytic_cost(slots, b, item) == \
            ref_relax.dw_analytic_cost(slots, b, item)


# -- forced solves -----------------------------------------------------------


@pytest.mark.parametrize("kw,route", [
    ({"dirty_window": True}, "vm-blocked+dw"),
    ({"dirty_window": True, "gauss_seidel": True}, "gs+dw"),
    ({"dirty_window": True, "dw_block": 4}, "vm-blocked+dw"),
])
@pytest.mark.parametrize("name", ["grid24-neg", "grid48"])
def test_forced_dirty_window_solves_match_reference(kw, route, name):
    """A forced dirty-window solve takes the reference's route tag and its
    rows bitwise (integer weights) and sweep counts, with phase 1 (when a
    weight is negative) on the same B=1 route."""
    g = _int(GRAPHS[name]())
    srcs = _sources(g, 8)
    ref_s, port_s = _solvers(**kw)
    ref = ref_s.solve(g, srcs)
    port = port_s.solve(_port(g), srcs)
    assert port.stats.routes_by_phase["fanout"] == route
    assert port.stats.routes_by_phase == ref.stats.routes_by_phase
    assert dict(port.stats.iterations_by_phase) == dict(
        ref.stats.iterations_by_phase)
    np.testing.assert_array_equal(to_numpy(port.dist), np.asarray(ref.dist))
    if route == "vm-blocked+dw":
        assert port.stats.edges_relaxed_by_phase["fanout"] == \
            ref.stats.edges_relaxed_by_phase["fanout"]
    decision = port.stats.plans_by_phase["fanout"]
    assert decision["chosen"] == ("gs" if route == "gs+dw" else
                                  "vm-blocked+dw")
    assert decision["reason"].startswith("forced by config")


def test_forced_dirty_window_with_predecessors():
    g = _int(GRAPHS["grid24-neg"]())
    srcs = _sources(g, 8)
    ref_s, port_s = _solvers(dirty_window=True)
    ref = ref_s.solve(g, srcs, predecessors=True)
    port = port_s.solve(_port(g), srcs, predecessors=True)
    assert port.stats.routes_by_phase["fanout"] == "vm-blocked+dw+pred"
    assert port.stats.routes_by_phase == ref.stats.routes_by_phase
    np.testing.assert_array_equal(to_numpy(port.dist), np.asarray(ref.dist))
    np.testing.assert_array_equal(to_numpy(port.predecessors),
                                  np.asarray(ref.predecessors))


# -- the evidence gate --------------------------------------------------------

# Sources of the instrumented solves. The recorded skippable fraction falls
# as the batch's frontiers overlap (the scrambled 48x48 grid: 0.98 at B=1,
# 0.84 at B=8, 0.72 at B=16, under the 0.75 threshold), so the evidence
# solves run narrow, as the reference's dirty-window bench does.
EVIDENCE_B = 8


def _instrumented_records(g, srcs, store_dir, package):
    """An instrumented solve (``use_pallas=False``, a profile store set:
    the trajectory records, as the reference's dirty-window bench writes
    them) in ``package``; returns the store's records."""
    ref_s, port_s = _solvers(use_pallas=False, dirty_window=False,
                             profile_store=str(store_dir))
    if package == "ref":
        ref_s.multi_source(g, srcs)
        from paralleljohnson_tpu.observe.store import ProfileStore as RefStore
        return RefStore(store_dir).records()
    port_s.multi_source(_port(g), srcs)
    return ProfileStore(store_dir).records()


@pytest.mark.parametrize("name,engage", [("grid48", True), ("rmat10", False)])
def test_dw_decision_from_instrumented_records(tmp_path, name, engage):
    """Both packages' instrumented solves write trajectory records on which
    ``dw_decision`` engages for the grid and declines for R-MAT, with the
    same reason; each package decides the same on the other's records."""
    g = GRAPHS[name]()
    srcs = _sources(g, EVIDENCE_B)
    recs = {pkg: _instrumented_records(g, srcs, tmp_path / pkg, pkg)
            for pkg in ("ref", "port")}
    for pkg, records in recs.items():
        trajs = [r for r in records if r["kind"] == "trajectory"]
        assert trajs and {r["route"] for r in trajs} == {"vm"}
        assert {r["platform"] for r in trajs} == {"cpu"}
    shape = dict(num_nodes=g.num_nodes, num_edges=g.num_real_edges,
                 platform="cpu")
    decisions = [mod.dw_decision(recs[pkg], **shape)
                 for mod in (ref_conv, port_conv) for pkg in ("ref", "port")]
    for d in decisions:
        assert d["engage"] is engage
        assert (d["reason"], d["summary"]["iterations"]) == (
            decisions[0]["reason"], decisions[0]["summary"]["iterations"])


def test_auto_dirty_window_engages_on_evidence(tmp_path):
    """``dirty_window="auto"`` with the grid's trajectory records in the
    store: both packages walk to ``vm-blocked+dw`` with rows bitwise
    equal to the plain route's, the decision's reason the evidence's. With
    no store the walk stays off it."""
    g = GRAPHS["grid48"]()
    srcs = _sources(g, EVIDENCE_B)
    store = tmp_path / "port"
    _instrumented_records(g, srcs, store, "port")
    _instrumented_records(g, srcs, tmp_path / "ref", "ref")
    ref_s, _ = _solvers(profile_store=str(tmp_path / "ref"))
    ref = ref_s.multi_source(g, srcs)
    port = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(profile_store=str(store)), device="cpu",
    ).multi_source(_port(g), srcs)
    assert port.stats.routes_by_phase["fanout"] == "vm-blocked+dw"
    assert ref.stats.routes_by_phase["fanout"] == "vm-blocked+dw"
    np.testing.assert_array_equal(to_numpy(port.dist), np.asarray(ref.dist))
    decision = port.stats.plans_by_phase["fanout"]
    assert decision["chosen"] == "vm-blocked+dw"
    assert decision["reason"].startswith("priority: vm-blocked+dw")
    dw = next(c for c in decision["candidates"]
              if c["plan"] == "vm-blocked+dw")
    assert dw["qualified"] and "skippable" in dw["reason"]
    plain = pjt.ParallelJohnsonSolver(device="cpu").multi_source(
        _port(g), srcs)
    assert plain.stats.routes_by_phase["fanout"] == "pallas-vm"
    np.testing.assert_array_equal(to_numpy(plain.dist), to_numpy(port.dist))


def _solve_rec(g, b, route, compute_s):
    return {"kind": "solve", "label": "t", "route": route, "platform": "cpu",
            "nodes": g.num_nodes, "edges": g.num_real_edges, "batch": b,
            "measured": {"wall_s": compute_s, "compute_s": compute_s},
            "edges_relaxed": 1, "iterations": 0, "cost": {}}


@pytest.mark.parametrize("use_pallas,priced,engage", [
    ("auto", "pallas-vm", False),   # the hand sweep priced cheaper: veto
    (False, "pallas-vm", True),     # ... but it cannot serve: no veto
    (False, "vm", False),           # the reference's own veto
])
def test_priced_veto_compares_the_route_that_would_serve(
        tmp_path, use_pallas, priced, engage):
    """The translated veto: with trajectory evidence to engage, a store
    that prices ``vm-blocked+dw`` dearer than the route that would
    otherwise serve vetoes it; on the port that route is ``pallas-vm``
    unless ``use_pallas=False``."""
    g = GRAPHS["grid48"]()
    srcs = _sources(g, EVIDENCE_B)
    store = tmp_path / "s"
    records = [r for r in _instrumented_records(g, srcs, store, "port")
               if r["kind"] == "trajectory"]
    (store / "profiles.jsonl").unlink()
    for r in records + [_solve_rec(g, EVIDENCE_B, "vm-blocked+dw", 100.0),
                        _solve_rec(g, EVIDENCE_B, priced, 0.001)]:
        ProfileStore(store).append(r)
    backend = pjt.get_backend("torch", pjt.SolverConfig(
        profile_store=str(store), use_pallas=use_pallas), device="cpu")
    decision = backend._dw_decision(backend.upload(_port(g)), EVIDENCE_B)
    assert decision["engage"] is engage
    if not engage:
        assert f"vs {priced}" in decision["reason"]
