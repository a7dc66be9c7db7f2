"""PyTorch port: the C++/OpenMP ``cpp`` backend (``native/pj_native.cpp``
through ctypes) against the JAX package's ``cpp`` backend and the numpy
oracle backend: bitwise on f64, to float tolerance on f32. The library
is built by ``g++`` at first use into the port's own build directory."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu.backends import get_backend as ref_get_backend
from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import (
    erdos_renyi,
    random_dag,
    random_graph_batch,
    rmat,
)
from tests.conftest import oracle_apsp, oracle_sssp

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop, native
from paralleljohnson_tpu_torch.backends import available_backends, get_backend
from paralleljohnson_tpu_torch.graphs import CSRGraph, stack_graphs

GRAPHS = {
    "er": lambda: erdos_renyi(200, 0.05, seed=3, weight_range=(0.1, 9.0)),
    "dag-neg": lambda: random_dag(120, 0.06, negative_fraction=0.4, seed=5),
    "rmat": lambda: rmat(9, 8, seed=2),
}


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _backends(precision):
    return (get_backend("cpp", pjt.SolverConfig(backend="cpp",
                                                precision=precision)),
            ref_get_backend("cpp", RefConfig(backend="cpp",
                                             precision=precision)),
            get_backend("numpy", pjt.SolverConfig(backend="numpy",
                                                  precision=precision)))


def _agree(precision, *arrays):
    first = np.asarray(arrays[0])
    for other in arrays[1:]:
        if precision == "f64":
            np.testing.assert_array_equal(first, np.asarray(other))
        else:
            np.testing.assert_allclose(first, np.asarray(other), rtol=1e-5,
                                       atol=1e-5)


def test_registered_and_built_into_the_port(tmp_path):
    assert "cpp" in available_backends()
    lib = native.load_library()
    assert lib.pj_version() == 1 and lib.pj_num_threads() >= 1
    assert native.library_path().parent.parts[-3:] == (
        "paralleljohnson_tpu_torch", "_build", "native")


def test_failed_build_raises_with_compiler_stderr(monkeypatch):
    monkeypatch.setenv("PJ_NATIVE_FLAGS", "-fno-such-flag-for-the-test")
    with pytest.raises(RuntimeError, match="no-such-flag-for-the-test"):
        native.library_path()


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("source", [0, None])
def test_bellman_ford_equals_reference_and_oracle(precision, name, source):
    g = GRAPHS[name]()
    cpp, ref, oracle = _backends(precision)
    ours = cpp.bellman_ford(cpp.upload(_port(g)), source=source)
    theirs = ref.bellman_ford(ref.upload(g), source=source)
    numpy_res = oracle.bellman_ford(oracle.upload(_port(g)), source=source)
    _agree(precision, ours.dist, theirs.dist, numpy_res.dist)
    assert (ours.negative_cycle, ours.converged) == (
        theirs.negative_cycle, theirs.converged)
    assert ours.dist.dtype == np.dtype(np.float64 if precision == "f64"
                                       else np.float32)
    if source is not None:
        np.testing.assert_allclose(ours.dist, oracle_sssp(g, source),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("pred", [False, True])
def test_fanout_equals_reference_and_oracle(precision, pred):
    g = GRAPHS["er"]()
    sources = np.arange(0, g.num_nodes, 7)
    cpp, ref, oracle = _backends(precision)
    call = "multi_source_pred" if pred else "multi_source"
    ours = getattr(cpp, call)(cpp.upload(_port(g)), sources)
    theirs = getattr(ref, call)(ref.upload(g), sources)
    numpy_res = oracle.multi_source(oracle.upload(_port(g)), sources)
    _agree(precision, ours.dist, theirs.dist, numpy_res.dist)
    assert ours.edges_relaxed == theirs.edges_relaxed
    if pred:
        np.testing.assert_array_equal(ours.pred, theirs.pred)


def test_negative_cycle_and_sssp_pred(tiny_graph, neg_cycle_graph):
    cpp, ref, _ = _backends("f64")
    res = cpp.bellman_ford(cpp.upload(_port(neg_cycle_graph)), source=0)
    assert res.negative_cycle
    with pytest.raises(pjt.NegativeCycleError):
        pjt.ParallelJohnsonSolver(pjt.SolverConfig(backend="cpp")).solve(
            _port(neg_cycle_graph))
    ours = cpp.bellman_ford_pred(cpp.upload(_port(tiny_graph)), source=0)
    theirs = ref.bellman_ford_pred(ref.upload(tiny_graph), source=0)
    np.testing.assert_array_equal(ours.dist, theirs.dist)
    np.testing.assert_array_equal(ours.pred, theirs.pred)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_johnson_solve_equals_oracle(precision):
    g = GRAPHS["dag-neg"]()
    res = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(backend="cpp", precision=precision)).solve(_port(g))
    numpy_res = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(backend="numpy", precision=precision)).solve(_port(g))
    _agree(precision, res.matrix, numpy_res.matrix)
    np.testing.assert_allclose(res.matrix, oracle_apsp(g), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_batch_apsp_equals_reference(precision):
    graphs = random_graph_batch(6, 20, 0.2, seed=5) + [
        random_dag(18, 0.2, negative_fraction=0.4, seed=2)]
    cpp, ref, _ = _backends(precision)
    from paralleljohnson_tpu.graphs import stack_graphs as ref_stack

    ours = cpp.batch_apsp(stack_graphs([_port(g) for g in graphs]))
    theirs = ref.batch_apsp(ref_stack(graphs))
    _agree(precision, ours.dist, theirs.dist)
    assert ours.edges_relaxed == theirs.edges_relaxed
    results = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(backend="cpp", precision=precision)).solve_batch(
            [_port(g) for g in graphs])
    for g, r in zip(graphs, results):
        np.testing.assert_allclose(r.matrix, oracle_apsp(g), rtol=1e-4,
                                   atol=1e-4)


def test_batch_negative_cycle_rows_are_inf():
    s, d, w = zip(*[(0, 1, 1.0), (1, 2, -3.0), (2, 0, 1.0)])
    bad = CSRGraph.from_edges(s, d, w, 3)
    good = _port(erdos_renyi(8, 0.3, seed=0))
    res = get_backend("cpp", pjt.SolverConfig(backend="cpp")).batch_apsp(
        stack_graphs([good, bad]))
    assert res.negative_cycle and np.isinf(res.dist[1]).all()
    with pytest.raises(pjt.NegativeCycleError):
        pjt.ParallelJohnsonSolver(pjt.SolverConfig(backend="cpp")).solve_batch(
            [good, bad])
