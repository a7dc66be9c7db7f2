"""PyTorch port: edge-sharded Bellman-Ford and the 2-D ("sources",
"edges") mesh (``parallel.mesh``) against the JAX package's, on the CPU.

Each case of ``tests/test_edge_sharding.py`` runs through both packages:
the reference on its harness's eight simulated devices, the port on eight
CPU ranks (``PJ_MESH_DEVICES=cpu*8``), one MIN all-reduce per sweep over
each "edges" group. Rows are bitwise equal on integer weights, the flags
and sweep counts equal, predecessor trees pass ``validate_pred_tree``.
Every collective is bounded by ``parallel.mesh.DEFAULT_TIMEOUT_S`` = 30 s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paralleljohnson_tpu.graphs as G
from paralleljohnson_tpu import ParallelJohnsonSolver as RefSolver
from paralleljohnson_tpu import SolverConfig as RefConfig
from paralleljohnson_tpu.backends import get_backend as ref_get_backend
from paralleljohnson_tpu.graphs import erdos_renyi, grid2d, random_dag
from paralleljohnson_tpu.parallel import (
    edge_sharded_bellman_ford as ref_edge_bf,
    make_edge_mesh as ref_make_edge_mesh,
    make_mesh_2d as ref_make_mesh_2d,
    sharded_fanout_2d as ref_fanout_2d,
)

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.backends import get_backend
from paralleljohnson_tpu_torch.parallel import (
    edge_sharded_bellman_ford,
    make_edge_mesh,
    make_mesh_2d,
    sharded_fanout_2d,
)
from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

from conftest import oracle_sssp

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the reference's 8-device mesh"
)


@pytest.fixture(autouse=True)
def _eight_cpu_ranks(monkeypatch):
    monkeypatch.setenv("PJ_MESH_DEVICES", "cpu*8")
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 30.0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int(g):
    return g.with_weights(np.round(g.weights * 8))


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _dev(g):
    return (jnp.asarray(g.src, jnp.int32), jnp.asarray(g.indices, jnp.int32),
            jnp.asarray(g.weights, jnp.float32))


def _tdev(g):
    return (torch.as_tensor(g.src, dtype=torch.int32),
            torch.as_tensor(g.indices, dtype=torch.int32),
            torch.as_tensor(g.weights, dtype=torch.float32))


def _both_bf(g, d0, max_iter):
    ref = ref_edge_bf(ref_make_edge_mesh(), jnp.asarray(d0), *_dev(g),
                      max_iter=max_iter)
    port = edge_sharded_bellman_ford(make_edge_mesh(), torch.as_tensor(d0),
                                     *_tdev(g), max_iter=max_iter)
    assert port[1] == int(ref[1]) and port[2] == bool(ref[2])
    return ref, port


def test_edge_sharded_sssp_matches_oracle():
    g = _int(erdos_renyi(120, 0.06, seed=9))
    d0 = np.full(g.num_nodes, np.inf, np.float32)
    d0[0] = 0.0
    ref, (dist, iters, improving) = _both_bf(g, d0, g.num_nodes)
    assert not improving
    np.testing.assert_array_equal(dist.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(dist.numpy(), oracle_sssp(g, 0), rtol=1e-5,
                               atol=1e-5)


def test_edge_sharded_negative_weights_and_cycle_flag():
    g = _int(random_dag(60, 0.08, negative_fraction=0.4, seed=4))
    d0 = np.full(g.num_nodes, np.inf, np.float32)
    d0[0] = 0.0
    ref, (dist, _, improving) = _both_bf(g, d0, g.num_nodes)
    assert not improving
    np.testing.assert_array_equal(dist.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(dist.numpy(), oracle_sssp(g, 0), rtol=1e-4,
                               atol=1e-4)
    # A negative self-loop: still improving after |V| rounds = cycle.
    gc = G.CSRGraph.from_edges([0, 1], [0, 2], [-1.0, 2.0], 3)
    _, (_, _, improving) = _both_bf(gc, np.zeros(3, np.float32), 3)
    assert improving


def test_edge_sharded_multi_source_rows():
    g = grid2d(12, 12, negative_fraction=0.0, seed=2)
    b = 5
    d0 = np.full((b, g.num_nodes), np.inf, np.float32)
    d0[np.arange(b), np.arange(b)] = 0.0
    ref, (dist, _, improving) = _both_bf(g, d0, g.num_nodes)
    assert not improving
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref[0]), rtol=1e-6)
    for i in range(b):
        np.testing.assert_allclose(dist.numpy()[i], oracle_sssp(g, i),
                                   rtol=1e-5, atol=1e-5)


def test_edge_pad_off_multiple():
    # E not a multiple of the 8 ranks: the pad edges must be no-ops.
    gc = G.CSRGraph.from_edges([0, 1, 2], [1, 2, 3], [1.0, 2.0, 3.0], 4)
    d0 = np.full(4, np.inf, np.float32)
    d0[0] = 0.0
    _, (dist, _, improving) = _both_bf(gc, d0, 4)
    assert not improving
    np.testing.assert_array_equal(dist.numpy(), [0.0, 1.0, 3.0, 6.0])


def test_backend_routes_bellman_ford_through_edge_shard():
    """On a mesh of more than one rank the backend's B=1 Bellman-Ford is
    edge-sharded under "auto" (off the frontier family), as in the
    reference, and matches the single-device route."""
    g = _int(erdos_renyi(100, 0.07, seed=12))  # max_degree > 32
    ref_be = ref_get_backend("jax", RefConfig())
    be_auto = get_backend("torch", pjt.SolverConfig(), device="cpu")
    be_off = get_backend("torch", pjt.SolverConfig(edge_shard=False),
                         device="cpu")
    pg = _port(g)
    assert be_auto._use_edge_shard(be_auto.upload(pg)) is True
    assert ref_be._use_edge_shard(ref_be.upload(g)) is True
    assert be_off._use_edge_shard(be_off.upload(pg)) is False
    r_auto = be_auto.bellman_ford(be_auto.upload(pg), 0)
    r_off = be_off.bellman_ford(be_off.upload(pg), 0)
    r_ref = ref_be.bellman_ford(ref_be.upload(g), 0)
    assert (r_auto.route, r_off.route) == ("edge-sharded", "sweep")
    assert r_auto.route == r_ref.route
    np.testing.assert_array_equal(r_auto.dist.numpy(), r_off.dist.numpy())
    np.testing.assert_array_equal(r_auto.dist.numpy(), np.asarray(r_ref.dist))
    np.testing.assert_allclose(r_auto.dist.numpy(), oracle_sssp(g, 0),
                               rtol=1e-5, atol=1e-5)
    # The same Jacobi-round count and edges-relaxed convention.
    assert r_auto.iterations == r_ref.iterations
    assert r_auto.edges_relaxed == r_auto.iterations * g.num_real_edges


@pytest.mark.parametrize("layout", ["source_major", "vertex_major"])
def test_2d_mesh_fanout_matches_oracle(layout):
    """A 4 x 2 sources x edges mesh: rows and edge slices sharded at once,
    the exact row-sweep accounting of the reference."""
    g = _int(erdos_renyi(90, 0.08, seed=21))
    b = 11  # off-multiple of the 4-wide sources axis
    sources = np.arange(b)
    if layout == "vertex_major":
        order = np.argsort(g.indices, kind="stable")
        src, dst, w = (g.src[order], g.indices[order], g.weights[order])
    else:
        src, dst, w = g.src, g.indices, g.weights
    ref = ref_fanout_2d(
        ref_make_mesh_2d((4, 2)), jnp.asarray(sources, jnp.int32),
        jnp.asarray(src, jnp.int32), jnp.asarray(dst, jnp.int32),
        jnp.asarray(w, jnp.float32), num_nodes=g.num_nodes,
        max_iter=g.num_nodes, layout=layout, with_row_sweeps=True)
    dist, iters, improving, row_sweeps = sharded_fanout_2d(
        make_mesh_2d((4, 2)), sources, torch.as_tensor(src, dtype=torch.int32),
        torch.as_tensor(dst, dtype=torch.int32),
        torch.as_tensor(w, dtype=torch.float32), num_nodes=g.num_nodes,
        max_iter=g.num_nodes, layout=layout, with_row_sweeps=True)
    assert not improving and not bool(ref[2])
    assert dist.shape == (b, g.num_nodes)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(ref[0]))
    for i in range(b):
        np.testing.assert_allclose(dist.numpy()[i], oracle_sssp(g, i),
                                   rtol=1e-5, atol=1e-5)
    assert iters == int(ref[1]) and row_sweeps == int(ref[3])
    assert b <= row_sweeps <= iters * b


def test_backend_2d_mesh_end_to_end():
    """mesh_shape=(4, 2): the solver's fan-out runs on the 2-D mesh and
    matches the reference's, Johnson with negative weights included."""
    g = _int(random_dag(70, 0.08, negative_fraction=0.35, seed=6))
    ref = RefSolver(RefConfig(backend="jax", mesh_shape=(4, 2))).solve(g)
    res = pjt.ParallelJohnsonSolver(pjt.SolverConfig(mesh_shape=(4, 2)),
                                    device="cpu").solve(_port(g))
    assert res.stats.routes_by_phase == ref.stats.routes_by_phase == {
        "bellman_ford": "edge-sharded", "fanout": "sharded-2d"}
    np.testing.assert_array_equal(res.matrix, ref.matrix)
    assert res.stats.edges_relaxed == ref.stats.edges_relaxed > 0
    cand = {c["plan"]: c for c in
            res.stats.plans_by_phase["fanout"]["candidates"]}
    assert cand["sharded-2d"]["reason"].startswith(
        "4x2 sources x edges mesh on cpu x8 (gloo")


def test_2d_mesh_vertex_major_layout():
    """The 2-D path honours fanout_layout: vertex-major (each rank's slice
    of the dst-sorted edges, the hand sweep's plain version) equals
    source-major, the reference and the oracle."""
    g = _int(erdos_renyi(70, 0.09, seed=8))
    srcs = np.arange(13)
    rows = {}
    for layout in ("vertex_major", "source_major"):
        cfg = dict(mesh_shape=(4, 2), fanout_layout=layout)
        res = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**cfg),
                                        device="cpu").multi_source(_port(g),
                                                                   srcs)
        ref = RefSolver(RefConfig(backend="jax", **cfg)).multi_source(g, srcs)
        rows[layout] = np.asarray(res.dist)
        np.testing.assert_array_equal(rows[layout], np.asarray(ref.dist))
    np.testing.assert_array_equal(rows["vertex_major"], rows["source_major"])
    for i, s in enumerate(srcs):
        np.testing.assert_allclose(rows["vertex_major"][i],
                                   oracle_sssp(g, int(s)), rtol=1e-5,
                                   atol=1e-5)


def test_2d_mesh_predecessors_fall_back_to_sources_mesh():
    """predecessors=True on a 2-D mesh: the tight-edge pass on each
    source group's rows (``sharded-2d+pred``), and the argmin sweep on a
    1-D sources mesh over the same ranks (``pred-sweep``); both trees
    valid and the rows the reference's."""
    g = _int(random_dag(50, 0.1, negative_fraction=0.3, seed=3))
    want = RefSolver(RefConfig(backend="jax", mesh_shape=(4, 2))).solve(
        g, predecessors=True)
    for extraction, route in ((True, "sharded-2d+pred"),
                              (False, "pred-sweep")):
        res = pjt.ParallelJohnsonSolver(
            pjt.SolverConfig(mesh_shape=(4, 2), pred_extraction=extraction),
            device="cpu").solve(_port(g), predecessors=True)
        assert res.stats.routes_by_phase["fanout"] == route
        np.testing.assert_array_equal(res.matrix, want.matrix)
        pred = np.asarray(res.predecessors)
        validate_pred_tree(_port(g), res.matrix, pred, np.arange(50))
        d = res.matrix
        finite = np.flatnonzero(np.isfinite(d[0]) & (np.arange(50) != 0))
        if finite.size:
            path = res.path(0, int(finite[0]))
            assert path[0] == 0 and path[-1] == int(finite[0])
