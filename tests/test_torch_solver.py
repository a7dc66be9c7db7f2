"""PyTorch port: ``ParallelJohnsonSolver.solve()`` on the CPU against the
JAX solver on the same routes, carried across by ``interop``.

The reference is pinned to the Pallas routes (``use_pallas=True``, one
device, the auto-only routes off). With integer-valued weights every path
sum is exact, so the distances must be bitwise equal; otherwise the
tolerance is rtol=1e-6, room for an f32 path sum that rounds differently
when a different sweep order makes a different path win."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse.csgraph as csgraph

torch = pytest.importorskip("torch")

from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import erdos_renyi, load_graph, random_dag
from paralleljohnson_tpu.solver import (
    ConvergenceError as RefConvergenceError,
    NegativeCycleError as RefNegativeCycleError,
    ParallelJohnsonSolver as RefSolver,
)

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.solver.johnson import to_numpy

REPO = Path(__file__).resolve().parent.parent

PINNED = dict(use_pallas=True, mesh_shape=(1,), fw=False, frontier=False,
              dia=False, gauss_seidel=False, bucket=False)


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _solve_both(g, sources=None, **overrides):
    ref_cfg = RefConfig(**{**PINNED, **overrides})
    ref = RefSolver(ref_cfg).solve(g, sources)
    cfg = interop.config_from_dict(dataclasses.asdict(ref_cfg))
    port = pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(_port(g), sources)
    return ref, port


def _integer_weights(g):
    return g.with_weights(np.round(g.weights))


def _oracle(g, sources=None):
    dense = np.ma.masked_invalid(g.to_dense().astype(np.float64))
    full = csgraph.johnson(dense, directed=True)
    return full if sources is None else full[sources]


GRAPHS = {
    "dag-neg-int": lambda: _integer_weights(
        random_dag(90, 0.08, negative_fraction=0.4, seed=3)),
    "dag-neg": lambda: random_dag(90, 0.08, negative_fraction=0.4, seed=5),
    "er-dense-int": lambda: _integer_weights(erdos_renyi(48, 0.12, seed=5)),
    "er-dense-neg-dag": lambda: _integer_weights(
        random_dag(40, 0.3, negative_fraction=0.3, seed=8)),
    "grid-neg": lambda: load_graph("grid:rows=9,cols=11,neg=0.2,seed=1"),
    "rmat-int": lambda: _integer_weights(load_graph("rmat:scale=8,ef=8,seed=2")),
}


def test_tiny_graph_bitwise(tiny_graph):
    ref, port = _solve_both(tiny_graph)
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    np.testing.assert_array_equal(to_numpy(port.potentials),
                                  np.asarray(ref.potentials))
    assert port.stats.routes_by_phase == ref.stats.routes_by_phase
    assert port.stats.routes_by_phase["fanout"] == "dense-squaring-pallas"


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_solve_matches_reference_solver(name):
    g = GRAPHS[name]()
    ref, port = _solve_both(g)
    assert port.stats.routes_by_phase == ref.stats.routes_by_phase
    if name.endswith("-int"):
        np.testing.assert_array_equal(port.matrix, ref.matrix)
    else:
        np.testing.assert_allclose(port.matrix, ref.matrix, rtol=1e-6)
    np.testing.assert_allclose(port.matrix, _oracle(g), rtol=1e-5, atol=1e-4)
    assert (port.stats.iterations_by_phase.get("bellman_ford")
            == ref.stats.iterations_by_phase.get("bellman_ford"))


def test_routes_cover_both_kernels():
    """The pinned graphs reach both hand-kernel routes."""
    routes = {pjt.ParallelJohnsonSolver(pjt.SolverConfig(**PINNED),
                                        device="cpu")
              .solve(_port(GRAPHS[n]()), np.arange(4))
              .stats.routes_by_phase["fanout"]
              for n in ("dag-neg-int", "er-dense-int")}
    assert routes == {"pallas-vm", "dense-iterate-pallas"}


def test_source_subset_and_batches_bitwise():
    """Source subsets (dense iterate regime too) match the reference; a
    multi-batch solve equals the single-batch one bitwise."""
    g = GRAPHS["er-dense-int"]()
    sources = np.array([3, 0, 17, 40, 41])
    ref, port = _solve_both(g, sources)
    assert port.stats.routes_by_phase["fanout"] == "dense-iterate-pallas"
    np.testing.assert_array_equal(to_numpy(port.dist), np.asarray(ref.dist))

    g = GRAPHS["dag-neg-int"]()
    one = pjt.ParallelJohnsonSolver(pjt.SolverConfig(), device="cpu").solve(
        _port(g))
    many = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(source_batch_size=7), device="cpu"
    ).solve(_port(g))
    assert isinstance(many.dist, np.ndarray)
    assert isinstance(one.dist, torch.Tensor)
    np.testing.assert_array_equal(many.dist, one.dist.numpy())
    assert many.stats.final_batch == 7


def test_negative_cycle_raises_in_both(neg_cycle_graph):
    with pytest.raises(RefNegativeCycleError):
        RefSolver(RefConfig(**PINNED)).solve(neg_cycle_graph)
    with pytest.raises(pjt.NegativeCycleError):
        pjt.ParallelJohnsonSolver(pjt.SolverConfig(**PINNED),
                                  device="cpu").solve(_port(neg_cycle_graph))


@pytest.mark.parametrize("name", ["dag-neg", "rmat-int"])
def test_convergence_cap_raises_in_both(name):
    g = GRAPHS[name]()
    with pytest.raises(RefConvergenceError):
        RefSolver(RefConfig(max_iterations=2, **PINNED)).solve(g)
    with pytest.raises(pjt.ConvergenceError):
        pjt.ParallelJohnsonSolver(
            pjt.SolverConfig(max_iterations=2, **PINNED), device="cpu"
        ).solve(_port(g))


def test_er1k_matches_default_reference_and_scipy():
    """ER-1k (sparse: route pallas-vm in the port) against the reference
    on its default route and against scipy Dijkstra."""
    g = load_graph("er:n=1000,p=0.01,seed=0")
    ref = RefSolver(RefConfig(mesh_shape=(1,))).solve(g)
    port = pjt.ParallelJohnsonSolver(pjt.SolverConfig(),
                                     device="cpu").solve(_port(g))
    assert port.stats.routes_by_phase["fanout"] == "pallas-vm"
    np.testing.assert_allclose(port.matrix, ref.matrix, rtol=1e-6)
    oracle = csgraph.dijkstra(g.to_scipy().astype(np.float64), directed=True)
    np.testing.assert_allclose(port.matrix, oracle, rtol=1e-5)


def test_numpy_backend_and_validate():
    g = _port(GRAPHS["dag-neg"]())
    res = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(backend="numpy", validate=True)
    ).solve(g)
    np.testing.assert_allclose(res.matrix, _oracle(g), rtol=1e-5, atol=1e-4)
    pjt.ParallelJohnsonSolver(pjt.SolverConfig(validate=True),
                              device="cpu").solve(g)


@pytest.mark.parametrize("kw", [
    {"dirty_window": True},
    {"edge_shard": True}, {"mesh_shape": (2,)},
    {"profile_store": "ps"},
    {"telemetry": object()}, {"metrics": object()},
])
def test_unported_routes_raise_naming_the_field(kw):
    name = next(iter(kw))
    with pytest.raises(NotImplementedError, match=name):
        pjt.ParallelJohnsonSolver(pjt.SolverConfig(**kw),
                                  device="cpu").solve(_port(GRAPHS["dag-neg"]()))


@pytest.mark.parametrize("kw,name,route", [
    ({"fw": True}, "dag-neg-int", "fw"),
    ({"fw": True, "fw_tile": 128}, "rmat-int", "fw-tile"),
    ({"partitioned": True}, "dag-neg-int", "condensed+fw"),
])
def test_forced_dense_apsp_routes_run_them(kw, name, route):
    """Forcing ``fw`` or ``partitioned`` runs the route (they raised
    before the dense APSP slice): the graph takes the route's tag in
    both packages, and the matrix is bitwise the reference's on the same
    forced route (integer weights) and the scipy oracle's."""
    g = GRAPHS[name]()
    ref, port = _solve_both(g, **kw)
    assert port.stats.routes_by_phase["fanout"] == route
    assert port.stats.routes_by_phase == ref.stats.routes_by_phase
    np.testing.assert_array_equal(port.matrix, np.asarray(ref.matrix))
    np.testing.assert_array_equal(port.matrix, _oracle(g))


@pytest.mark.parametrize("kw,route", [
    ({"frontier": True}, "frontier"), ({"dia": True}, "dia"),
    ({"gauss_seidel": True}, "gs"), ({"bucket": True}, "bucket"),
])
def test_forced_b1_routes_run_them(kw, route):
    """Forcing a B=1 route runs it: ``sssp`` on an integer-weight grid
    with negative arcs takes the route's tag, and its row is bitwise the
    reference's on the same forced route."""
    g = load_graph("grid:rows=20,cols=30,neg=0.2,seed=4")
    g = _integer_weights(g.with_weights(g.weights * 3))
    ref = RefSolver(RefConfig(**{**PINNED, **kw})).sssp(g, 7)
    port = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**{**PINNED, **kw}),
                                     device="cpu").sssp(_port(g), 7)
    assert port.stats.routes_by_phase["bellman_ford"] == route
    assert ref.stats.routes_by_phase["bellman_ford"] == route
    np.testing.assert_array_equal(to_numpy(port.dist), np.asarray(ref.dist))


def test_predecessors_raise():
    """The virtual-source pass computes potentials, not paths: asking it
    for a tree raises, as in the reference."""
    backend = pjt.get_backend("torch", pjt.SolverConfig(), device="cpu")
    dgraph = backend.upload(_port(GRAPHS["dag-neg"]()))
    with pytest.raises(NotImplementedError, match="predecessor tree"):
        backend.bellman_ford_pred(dgraph, None)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pjt.ParallelJohnsonSolver()
    with pytest.raises(RuntimeError, match="cuda"):
        pjt.get_backend("torch", pjt.SolverConfig())


def test_port_imports_no_jax_and_no_reference(tmp_path):
    """In a fresh interpreter with ``jax`` blocked, every module of the
    port imports, and ``solve`` (checkpointed, then resumed; forced
    ``fw``), ``solve_reduced``, ``solve_batch`` and ``sssp`` run; no
    module of the JAX package gets loaded, lazy imports inside the
    solver included."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        import paralleljohnson_tpu_torch as pjt
        mods = [m.name for m in pkgutil.walk_packages(
            pjt.__path__, pjt.__name__ + ".")]
        for name in mods:
            importlib.import_module(name)
        g = pjt.load_graph("dag:n=30,p=0.2,neg=0.4,seed=1")
        cfg = pjt.SolverConfig(source_batch_size=8,
                               checkpoint_dir={str(tmp_path)!r})
        res = pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(g)
        assert res.matrix.shape == (30, 30)
        again = pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(g)
        assert again.stats.batches_resumed == 4
        solver = pjt.ParallelJohnsonSolver(device="cpu")
        red = solver.solve_reduced(g, reduce_rows="reach_count")
        assert red.values[0].shape == (30,)
        assert solver.sssp(g, 0).dist.shape == (1, 30)
        fw = pjt.ParallelJohnsonSolver(pjt.SolverConfig(fw=True),
                                       device="cpu").solve(g)
        assert fw.stats.routes_by_phase["fanout"] == "fw"
        assert (fw.matrix == res.matrix).all()
        batch = solver.solve_batch([g, pjt.load_graph("er:n=20,p=0.2,seed=2")])
        assert batch[0].stats.routes_by_phase == {{"batch_apsp": "batch-vmapped"}}
        assert batch[0].dist.shape == (30, 30)
        grid = pjt.load_graph("grid:rows=24,cols=24,neg=0.2,seed=1")
        for kw in ({{}}, {{"dia": True}}, {{"gauss_seidel": True}},
                   {{"bucket": True}}, {{"convergence": True}}):
            res = pjt.ParallelJohnsonSolver(
                pjt.SolverConfig(**kw), device="cpu").sssp(grid, 3)
            assert res.dist.shape == (1, 576)
        bad = [m for m in sys.modules
               if m == "paralleljohnson_tpu" or m.startswith("paralleljohnson_tpu.")]
        assert not bad, bad
        print("isolated-ok", len(mods))
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "isolated-ok" in out.stdout
    assert int(out.stdout.split()[-1]) >= 25  # every module was walked
