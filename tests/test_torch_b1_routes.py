"""PyTorch port: the B=1 road-graph routes (``frontier``, ``dia``, ``gs``,
``bucket``) and the convergence trajectory counters, on the CPU against
the JAX package on the same forced configs.

With integer weights every path sum is exact, so distances are bitwise
equal; the negative-cycle and converged flags, the iteration counts and
``edges_relaxed`` are equal too (none of these routes' counts depends on
the edge chunking). The grids have at least 512 vertices, so ``frontier``
is also the default route of both packages there; a scrambled labeling
makes ``dia`` decline."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from paralleljohnson_tpu.backends import get_backend as ref_backend
from paralleljohnson_tpu.backends import jax_backend
from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import CSRGraph as RefCSRGraph
from paralleljohnson_tpu.graphs import grid2d, permute_labels
from paralleljohnson_tpu.observe import convergence as ref_conv
from paralleljohnson_tpu.ops import bucket as ref_bucket
from paralleljohnson_tpu.ops import dia as ref_dia
from paralleljohnson_tpu.ops import gauss_seidel as ref_gs
from paralleljohnson_tpu.ops import relax as ref_relax
from paralleljohnson_tpu.solver import (
    NegativeCycleError as RefNegativeCycleError,
    ParallelJohnsonSolver as RefSolver,
)

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.backends import torch_backend
from paralleljohnson_tpu_torch.observe import convergence as port_conv
from paralleljohnson_tpu_torch.ops import bucket as port_bucket
from paralleljohnson_tpu_torch.ops import dia as port_dia
from paralleljohnson_tpu_torch.ops import gauss_seidel as port_gs
from paralleljohnson_tpu_torch.ops import relax as port_relax
from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

# Every other route flag off, so the forced route is the one that runs.
B1 = dict(mesh_shape=(1,), use_pallas=True, fw=False, frontier=False,
          dia=False, gauss_seidel=False, bucket=False, dirty_window=False)


def _int_grid(rows, cols, seed):
    """A grid with negative arcs and integer weights in [-2, 30]."""
    g = grid2d(rows, cols, negative_fraction=0.2, seed=seed)
    return g.with_weights(np.round(g.weights * 3))


GRAPHS = {
    "grid": lambda: _int_grid(24, 24, 1),
    "grid-scrambled": lambda: permute_labels(_int_grid(24, 24, 1), seed=3),
    "grid-rect": lambda: _int_grid(16, 40, 4),
    "neg-cycle": lambda: RefCSRGraph.from_edges(
        [0, 1, 2, 3], [1, 2, 3, 1], [1.0, 2.0, -4.0, 1.0], 4),
    "edgeless": lambda: RefCSRGraph.from_edges([], [], [], 600),
}

ROUTES = {  # case -> (route flags, the route tag it must take)
    "frontier": (dict(frontier=True), "frontier"),
    "frontier-overflow": (dict(frontier=True, frontier_capacity=8),
                          "frontier"),
    "dia": (dict(dia=True), "dia"),
    "gs": (dict(gauss_seidel=True, gs_block_size=64), "gs"),
    "gs-one-block": (dict(gauss_seidel=True), "gs"),
    "bucket": (dict(bucket=True), "bucket"),
    "bucket-small-delta": (dict(bucket=True, delta=0.5), "bucket"),
    "sweep": ({}, "sweep"),
}


def _port_graph(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _backends(**overrides):
    ref_cfg = RefConfig(**{**B1, **overrides})
    cfg = interop.config_from_dict(dataclasses.asdict(ref_cfg))
    return (ref_backend("jax", ref_cfg),
            pjt.get_backend("torch", cfg, device="cpu"))


def _bf_both(g, source, **overrides):
    ref, port = _backends(**overrides)
    want = ref.bellman_ford(ref.upload(g), source)
    got = port.bellman_ford(port.upload(_port_graph(g)), source)
    return want, got


def _assert_same(want, got):
    assert got.route == want.route
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))
    assert (got.negative_cycle, got.converged) == (want.negative_cycle,
                                                   want.converged)
    assert got.iterations == want.iterations
    assert got.edges_relaxed == want.edges_relaxed


@pytest.mark.parametrize("source", [None, 5])
@pytest.mark.parametrize("graph", ["grid", "grid-scrambled", "grid-rect"])
@pytest.mark.parametrize("case", sorted(ROUTES))
def test_b1_route_matches_reference(case, graph, source):
    """Each route on each grid, from a source and as phase 1's
    virtual-source pass: distances bitwise, flags, iterations and
    edges_relaxed equal. ``dia`` declines the scrambled labeling and
    falls through to the default ``frontier`` in both packages."""
    flags, route = ROUTES[case]
    if case == "dia" and graph == "grid-scrambled":
        flags, route = {**flags, "frontier": "auto"}, "frontier"
    want, got = _bf_both(GRAPHS[graph](), source, **flags)
    assert got.route == route
    _assert_same(want, got)


@pytest.mark.parametrize("graph", ["neg-cycle", "edgeless"])
@pytest.mark.parametrize("case", sorted(ROUTES))
def test_b1_route_negative_cycle_and_edgeless(case, graph):
    """The 4-edge negative cycle (certified on every route; ``bucket``
    runs out of steps and certifies on ``bucket+sweep``) and an edgeless
    graph with 600 vertices (``dia`` has no layout there and falls
    through)."""
    want, got = _bf_both(GRAPHS[graph](), 0, **ROUTES[case][0])
    _assert_same(want, got)
    assert got.negative_cycle == (graph == "neg-cycle")


@pytest.mark.parametrize("case", ["frontier", "dia", "gs", "bucket"])
def test_forced_route_negative_cycle_raises_in_both(case):
    g = GRAPHS["neg-cycle"]()
    flags = ROUTES[case][0]
    with pytest.raises(RefNegativeCycleError):
        RefSolver(RefConfig(**{**B1, **flags})).sssp(g, 0)
    cfg = pjt.SolverConfig(**{**B1, **flags})
    with pytest.raises(pjt.NegativeCycleError):
        pjt.ParallelJohnsonSolver(cfg, device="cpu").sssp(_port_graph(g), 0)


@pytest.mark.parametrize("case", ["dia", "gs", "gs-one-block"])
def test_fanout_route_matches_reference(case):
    """``dia`` and ``gs`` also serve the fan-out, ahead of the hand
    route: rows bitwise, sweeps and edges_relaxed equal."""
    flags, route = ROUTES[case]
    g = GRAPHS["grid"]()
    g = g.with_weights(np.abs(g.weights))
    ref, port = _backends(**flags)
    sources = np.array([0, 7, 300, 575, 12])
    want = ref.multi_source(ref.upload(g), sources)
    got = port.multi_source(port.upload(_port_graph(g)), sources)
    assert got.route == route
    _assert_same(want, got)


@pytest.mark.parametrize("case", ["frontier", "dia", "gs", "bucket"])
def test_solve_on_forced_route_matches_reference(case):
    """``solve()`` with phase 1 on the forced route (and the fan-out on
    ``dia`` / ``gs`` where forced): routes, rows and counters equal."""
    flags, route = ROUTES[case]
    g = GRAPHS["grid-rect"]()
    ref_cfg = RefConfig(**{**B1, **flags})
    sources = np.array([0, 100, 639])
    want = RefSolver(ref_cfg).solve(g, sources)
    got = pjt.ParallelJohnsonSolver(
        interop.config_from_dict(dataclasses.asdict(ref_cfg)),
        device="cpu").solve(_port_graph(g), sources)
    assert got.stats.routes_by_phase["bellman_ford"] == route
    assert got.stats.routes_by_phase == want.stats.routes_by_phase
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))
    assert dict(got.stats.iterations_by_phase) == dict(
        want.stats.iterations_by_phase)
    assert got.stats.edges_relaxed == want.stats.edges_relaxed


def test_default_config_takes_frontier_in_both():
    """At default config both packages send the B=1 pass of a negative
    grid with V >= 512 to ``frontier``: phase 1 of ``solve()`` and
    ``sssp``. Rows bitwise, flags equal. (The fan-out routes differ by
    platform: the reference's XLA route off its TPU, the port's hand
    route.)"""
    g = GRAPHS["grid"]()
    sources = np.array([3, 200, 571])
    want = RefSolver(RefConfig()).solve(g, sources)
    port = pjt.ParallelJohnsonSolver(device="cpu")
    got = port.solve(_port_graph(g), sources)
    assert want.stats.routes_by_phase["bellman_ford"] == "frontier"
    assert got.stats.routes_by_phase["bellman_ford"] == "frontier"
    np.testing.assert_array_equal(got.matrix, np.asarray(want.matrix))
    np.testing.assert_array_equal(to_numpy(got.potentials),
                                  np.asarray(want.potentials))
    assert (got.stats.iterations_by_phase["bellman_ford"]
            == want.stats.iterations_by_phase["bellman_ford"])
    want = RefSolver(RefConfig()).sssp(g, 17)
    got = port.sssp(_port_graph(g), 17)
    assert want.stats.routes_by_phase["bellman_ford"] == "frontier"
    assert got.stats.routes_by_phase["bellman_ford"] == "frontier"
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))


@pytest.mark.parametrize("case", ["frontier", "dia", "gs", "bucket"])
def test_pred_on_b1_routes(case):
    """``sssp(predecessors=True)`` runs the route, then one tight-edge
    pass: route ``<route>+pred``, the reference's tag, a valid tree."""
    flags, route = ROUTES[case]
    g = GRAPHS["grid"]()
    ref_cfg = RefConfig(**{**B1, **flags})
    want = RefSolver(ref_cfg).sssp(g, 9, predecessors=True)
    got = pjt.ParallelJohnsonSolver(
        interop.config_from_dict(dataclasses.asdict(ref_cfg)),
        device="cpu").sssp(_port_graph(g), 9, predecessors=True)
    assert got.stats.routes_by_phase["bellman_ford"] == f"{route}+pred"
    assert got.stats.routes_by_phase == want.stats.routes_by_phase
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))
    validate_pred_tree(_port_graph(g), to_numpy(got.dist),
                       to_numpy(got.predecessors), got.sources)


# -- the ops against the reference's ----------------------------------------


def _csr_arrays(g, pad=512):
    """The uploaded (padded) COO in CSR order, as numpy."""
    gp = g.pad_edges(pad)
    return (gp.src.astype(np.int32), gp.indices.astype(np.int32),
            gp.weights.astype(np.float32))


@pytest.mark.parametrize("capacity", [4, 64, 4096])
@pytest.mark.parametrize("source", [None, 0])
def test_bellman_ford_frontier_op(capacity, source):
    """Small capacities force the full-sweep rounds (and the compaction's
    truncation); the examined count is the reference's split counter's
    integer."""
    g = GRAPHS["grid-rect"]()
    src, dst, w = _csr_arrays(g)
    v = g.num_nodes
    dist0 = np.zeros(v, np.float32) if source is None else np.full(
        v, np.inf, np.float32)
    if source is not None:
        dist0[source] = 0.0
    kw = dict(max_iter=v, capacity=capacity, max_degree=4,
              num_real_edges=g.num_real_edges, edge_chunk=1000)
    rd, ri, rimp, hi, lo = ref_relax.bellman_ford_frontier(
        jnp.asarray(dist0), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(w), jnp.asarray(g.indptr), **kw)
    pd, pi, pimp, ex = port_relax.bellman_ford_frontier(
        torch.as_tensor(dist0), torch.as_tensor(src), torch.as_tensor(dst),
        torch.as_tensor(w), g.indptr, **kw)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    assert (pi, pimp) == (int(ri), bool(rimp))
    assert port_relax.examined_exact(ex) == ref_relax.examined_exact(hi, lo)


def test_frontier_rejects_edge_counts_past_the_addend_bound():
    g = GRAPHS["grid"]()
    src, dst, w = (torch.as_tensor(a) for a in _csr_arrays(g))
    with pytest.raises(ValueError, match="2\\^31"):
        port_relax.bellman_ford_frontier(
            torch.zeros(g.num_nodes), src, dst, w, g.indptr, max_iter=4,
            capacity=8, max_degree=4,
            num_real_edges=port_relax.FRONTIER_ADDEND_MAX)


@pytest.mark.parametrize("batch", [None, 3])
def test_dia_sweep_op(batch):
    g = GRAPHS["grid-rect"]()
    lay = port_dia.build_dia_layout(g.indptr, g.indices, g.num_nodes)
    ref_lay = ref_dia.build_dia_layout(g.indptr, g.indices, g.num_nodes)
    assert lay["offsets"] == ref_lay["offsets"]
    np.testing.assert_array_equal(lay["diag_edge"], ref_lay["diag_edge"])
    w_diag = np.where(lay["diag_edge"] >= 0,
                      g.weights[np.maximum(lay["diag_edge"], 0)], np.inf)
    w_diag = w_diag.astype(np.float32)
    rng = np.random.default_rng(0)
    shape = (g.num_nodes,) if batch is None else (batch, g.num_nodes)
    d = np.where(rng.random(shape) < 0.3, np.inf,
                 rng.integers(-20, 200, shape)).astype(np.float32)
    want = ref_dia.dia_sweep(jnp.asarray(d), jnp.asarray(w_diag),
                             offsets=lay["offsets"])
    got = port_dia.dia_sweep(torch.as_tensor(d), torch.as_tensor(w_diag),
                             offsets=lay["offsets"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rd, ri, rimp = ref_dia.dia_fixpoint(jnp.asarray(d), jnp.asarray(w_diag),
                                        offsets=lay["offsets"], max_iter=640)
    pd, pi, pimp = port_dia.dia_fixpoint(
        torch.as_tensor(d), torch.as_tensor(w_diag), offsets=lay["offsets"],
        max_iter=640)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    assert (pi, pimp) == (int(ri), bool(rimp))


@pytest.mark.parametrize("use_in_adj", [False, True])
@pytest.mark.parametrize("batch", [None, 4])
def test_gs_engine_op(batch, use_in_adj):
    """``_gs_engine`` with the halo window and with the exact block
    in-adjacency: distances, rounds and per-block inner iterations."""
    g = GRAPHS["grid-scrambled"]()
    lay = ref_gs.build_gs_layout(g.indptr, g.indices, g.weights,
                                 g.num_nodes, vb=48, pad_multiple=32)
    port_lay = port_gs.build_gs_layout(g.indptr, g.indices, g.weights,
                                       g.num_nodes, vb=48, pad_multiple=32)
    for key in ("perm", "rank", "src_blk", "dstl_blk", "edge_order",
                "w_blk", "in_adj"):
        np.testing.assert_array_equal(port_lay[key], lay[key])
    assert port_lay["halo"] == lay["halo"]
    shape = (lay["v_pad"],) if batch is None else (lay["v_pad"], batch)
    dist0 = np.full(shape, np.inf, np.float32)
    starts = lay["rank"][[0, 50, 300, 575]]
    if batch is None:
        dist0[starts[0]] = 0.0
    else:
        dist0[starts, np.arange(4)] = 0.0
    kw = dict(vb=lay["vb"], halo=lay["halo"], max_outer=576, inner_cap=3)
    in_adj = lay["in_adj"] if use_in_adj else None
    rd, rr, rimp, riters = ref_gs._gs_engine(
        jnp.asarray(dist0), *(jnp.asarray(lay[k]) for k in (
            "src_blk", "dstl_blk", "w_blk")),
        in_adj=None if in_adj is None else jnp.asarray(in_adj), **kw)
    pd, pr, pimp, piters = port_gs._gs_engine(
        torch.as_tensor(dist0), *(torch.as_tensor(lay[k]) for k in (
            "src_blk", "dstl_blk", "w_blk")), in_adj=in_adj, **kw)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    assert (pr, pimp) == (int(rr), bool(rimp))
    np.testing.assert_array_equal(piters, np.asarray(riters))


@pytest.mark.parametrize("max_steps", [5, 10_000])
def test_bellman_ford_bucketed_op(max_steps):
    """A budget of 5 steps runs out (the hand-off to ``bucket+sweep``);
    the full budget converges. Distances, steps, the busy flag and the
    examined count."""
    g = GRAPHS["grid-scrambled"]()
    src, dst, w = _csr_arrays(g)
    dist0 = np.full(g.num_nodes, np.inf, np.float32)
    dist0[11] = 0.0
    kw = dict(max_steps=max_steps, capacity=16, max_degree=4,
              num_real_edges=g.num_real_edges, edge_chunk=1000)
    rd, rs, rbusy, hi, lo = ref_bucket.bellman_ford_bucketed(
        jnp.asarray(dist0), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(w), jnp.asarray(g.indptr), jnp.float32(4.0), **kw)
    pd, ps, pbusy, ex = port_bucket.bellman_ford_bucketed(
        torch.as_tensor(dist0), torch.as_tensor(src), torch.as_tensor(dst),
        torch.as_tensor(w), g.indptr, 4.0, **kw)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    assert (ps, pbusy) == (int(rs), bool(rbusy))
    assert pbusy == (max_steps == 5)
    assert port_relax.examined_exact(ex) == ref_relax.examined_exact(hi, lo)


def test_bucket_step_budget_hands_off_to_sweep():
    """A step budget (2 x max_iterations + 64) that runs out hands the
    distances to the full sweep: route ``bucket+sweep`` in both packages,
    equal counters."""
    want, got = _bf_both(GRAPHS["grid-scrambled"](), 3, bucket=True,
                         max_iterations=20, delta=0.25)
    assert got.route == "bucket+sweep"
    _assert_same(want, got)


# -- the convergence trajectory ----------------------------------------------

TRAJ = {  # route -> (config flags, entry, graph)
    "sweep": ({}, "bf", "grid"),
    "dia": (dict(dia=True), "bf", "grid"),
    "gs": (dict(gauss_seidel=True, gs_block_size=64), "bf", "grid"),
    "bucket": (dict(bucket=True), "bf", "grid-scrambled"),
    "dia-fanout": (dict(dia=True), "fanout", "grid"),
    "gs-fanout": (dict(gauss_seidel=True, gs_block_size=64), "fanout",
                  "grid"),
    "vm-blocked": (dict(use_pallas=False), "fanout", "grid-scrambled"),
    "vm": (dict(use_pallas=False), "fanout", "grid-scrambled"),
    "sweep-sm": (dict(fanout_layout="source_major"), "fanout", "grid"),
}


@pytest.mark.parametrize("case", sorted(TRAJ))
def test_trajectory_matches_reference(case, monkeypatch):
    """``convergence=True``: ``decode_trajectory`` and
    ``summarize_trajectory`` equal to the reference's on each route the
    reference instruments (integer weights: the f32 residual mass is
    exact). ``vm-blocked`` is reached by lowering ``VM_BLOCK`` in both
    packages."""
    flags, entry, graph = TRAJ[case]
    vb = 128 if case == "vm-blocked" else 1 << 16
    monkeypatch.setattr(jax_backend, "VM_BLOCK", vb)
    monkeypatch.setattr(torch_backend, "VM_BLOCK", vb)
    g = GRAPHS[graph]()
    ref, port = _backends(convergence=True, **flags)
    if entry == "bf":
        want = ref.bellman_ford(ref.upload(g), 21)
        got = port.bellman_ford(port.upload(_port_graph(g)), 21)
    else:
        g = g.with_weights(np.abs(g.weights))
        sources = np.array([1, 2, 99, 400])
        want = ref.multi_source(ref.upload(g), sources)
        got = port.multi_source(port.upload(_port_graph(g)), sources)
    assert got.route == want.route == case.split("-fanout")[0]
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))
    np.testing.assert_array_equal(got.trajectory, want.trajectory)
    assert got.convergence == want.convergence
    assert got.convergence["iterations"] == got.iterations > 0


@pytest.mark.parametrize("flag", [False, "auto"])
def test_trajectory_off_records_nothing(flag):
    for case in ("sweep", "dia", "gs", "bucket"):
        flags = TRAJ[case][0]
        port = pjt.get_backend(
            "torch", pjt.SolverConfig(convergence=flag, **{**B1, **flags}),
            device="cpu")
        res = port.bellman_ford(port.upload(_port_graph(GRAPHS["grid"]())), 0)
        assert res.trajectory is None and res.convergence is None
    solve = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(convergence=flag), device="cpu").solve(
            _port_graph(GRAPHS["grid"]()), [0, 1])
    assert solve.stats.convergence is None


def test_solver_stats_convergence_by_phase():
    """A ``use_pallas=False`` solve: phase 1 on ``frontier`` records
    nothing (as in the reference), the fan-out on ``vm`` records; a
    two-batch fan-out merges its batches."""
    g = GRAPHS["grid-scrambled"]()
    cfg = dict(use_pallas=False, convergence=True, source_batch_size=2,
               mesh_shape=(1,))
    want = RefSolver(RefConfig(**cfg)).solve(g, [0, 5, 9, 40])
    got = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**cfg),
                                    device="cpu").solve(
        _port_graph(g), [0, 5, 9, 40])
    assert set(got.stats.convergence) == {"fanout"}
    assert got.stats.convergence == want.stats.convergence
    assert got.stats.convergence["fanout"]["batches"] == 2
    assert got.stats.as_dict()["convergence"] == got.stats.convergence
    assert len(got.stats.trajectories["fanout"]) == 2


def test_convergence_host_half_matches_reference():
    """The copied host half: summaries (with and without a degree bias),
    merging, the frontier curve, the ETA and the dirty-window decision."""
    rng = np.random.default_rng(4)
    traj = np.column_stack([rng.integers(0, 500, 3000),
                            rng.integers(0, 900, 3000),
                            rng.random(3000)]).astype(np.float64)
    for kw in (dict(num_nodes=600), dict(num_nodes=600, num_edges=2000,
                                          degree_bias=3.5, iterations=4000)):
        assert (port_conv.summarize_trajectory(traj, **kw)
                == ref_conv.summarize_trajectory(traj, **kw))
    s = ref_conv.summarize_trajectory(traj, num_nodes=600)
    assert (port_conv.merge_summaries(s, s)
            == ref_conv.merge_summaries(s, s))
    assert port_conv.frontier_curve(traj) == ref_conv.frontier_curve(traj)
    assert port_conv.estimate_eta(3.0, 2, 5) == ref_conv.estimate_eta(3.0, 2, 5)
    deg = rng.integers(0, 9, 100)
    assert (port_conv.degree_bias_from_degrees(deg)
            == ref_conv.degree_bias_from_degrees(deg))
    rec = ref_conv.trajectory_record(
        traj[:50], label="x", phase="fanout", index=0, route="vm",
        platform="cpu", num_nodes=600, num_edges=2000, batch=4)
    for num_nodes in (600, 5000):
        kw = dict(num_nodes=num_nodes, num_edges=2000, platform="cpu")
        assert (port_conv.dw_decision([rec], **kw)
                == ref_conv.dw_decision([rec], **kw))
