"""PyTorch port: the solver's orchestration layer on the CPU against the
JAX package — the entry points (``sssp``, ``multi_source``,
``solve_range``, ``solve_reduced``, ``solve_batch``), the pipelined batch
driver, checkpoint/resume across both packages, and the fault paths.

Both solvers get the same graph and sources; the reference is pinned to
its Pallas routes as in ``test_torch_solver.py``. Distances are compared
bitwise on integer weights (every path sum is exact) and to rtol 1e-6 on
float weights."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import load_graph, random_dag
from paralleljohnson_tpu.solver import ParallelJohnsonSolver as RefSolver
from paralleljohnson_tpu.utils import faults as ref_faults
from paralleljohnson_tpu.utils import resilience as ref_resilience

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.solver import johnson as port_johnson
from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from paralleljohnson_tpu_torch.utils import faults as port_faults
from paralleljohnson_tpu_torch.utils import resilience as port_resilience
from paralleljohnson_tpu_torch.utils.checkpoint import BatchCheckpointer

PINNED = dict(use_pallas=True, mesh_shape=(1,), fw=False, frontier=False,
              dia=False, gauss_seidel=False, bucket=False)


def _int(g):
    return g.with_weights(np.round(g.weights))


GRAPHS = {
    "dag-neg-int": lambda: _int(random_dag(90, 0.08, negative_fraction=0.4,
                                           seed=3)),
    "grid-neg": lambda: load_graph("grid:rows=9,cols=11,neg=0.2,seed=1"),
    "rmat-int": lambda: _int(load_graph("rmat:scale=7,ef=8,seed=2")),
    "er-int": lambda: _int(load_graph("er:n=200,p=0.03,seed=4")),
}
# One source batch size for every multi-batch case, and source sets that
# are multiples of it: each (graph, batch width) compiles once in the JAX
# package.
B = 16


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _solvers(ref_faults_plan=None, port_faults_plan=None, **overrides):
    ref_cfg = RefConfig(**{**PINNED, **overrides})
    cfg = interop.config_from_dict(dataclasses.asdict(ref_cfg))
    ref_cfg.fault_plan = ref_faults_plan
    cfg.fault_plan = port_faults_plan
    return RefSolver(ref_cfg), pjt.ParallelJohnsonSolver(cfg, device="cpu")


def _assert_rows(name, got, want):
    got, want = to_numpy(got), np.asarray(want)
    if name.endswith("-int"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name,source", [("dag-neg-int", 0),
                                         ("dag-neg-int", 17),
                                         ("grid-neg", 5), ("rmat-int", 3)])
def test_sssp_matches_reference(name, source):
    g = GRAPHS[name]()
    ref, port = _solvers()
    want = ref.sssp(g, source)
    got = port.sssp(_port(g), source)
    assert to_numpy(got.dist).shape == (1, g.num_nodes)
    _assert_rows(name, got.dist, want.dist)
    assert got.stats.routes_by_phase == want.stats.routes_by_phase


def test_sssp_negative_cycle_raises(neg_cycle_graph):
    _, port = _solvers()
    with pytest.raises(pjt.NegativeCycleError):
        port.sssp(_port(neg_cycle_graph), 0)


@pytest.mark.parametrize("name,batch,n", [("rmat-int", B, 3 * B),
                                          ("er-int", None, B)])
def test_multi_source_matches_reference(name, batch, n):
    g = GRAPHS[name]()
    sources = np.random.default_rng(5).choice(g.num_nodes, n, replace=False)
    ref, port = _solvers(source_batch_size=batch)
    want = ref.multi_source(g, sources)
    got = port.multi_source(_port(g), sources)
    _assert_rows(name, got.dist, want.dist)
    np.testing.assert_array_equal(got.sources, want.sources)
    assert got.stats.final_batch == want.stats.final_batch


def test_multi_source_rejects_negative_weights():
    _, port = _solvers()
    with pytest.raises(ValueError, match="non-negative"):
        port.multi_source(_port(GRAPHS["dag-neg-int"]()), [0, 1])


@pytest.mark.parametrize("name,start,stop", [("dag-neg-int", 10, 42),
                                             ("grid-neg", 3, 99),
                                             ("rmat-int", 80, 128)])
def test_solve_range_matches_reference(name, start, stop):
    g = GRAPHS[name]()
    ref, port = _solvers(source_batch_size=B)
    want = ref.solve_range(g, start, stop)
    got = port.solve_range(_port(g), start, stop)
    np.testing.assert_array_equal(got.sources, np.arange(start, stop))
    _assert_rows(name, got.dist, want.dist)


def test_solve_range_rejects_bad_ranges():
    _, port = _solvers()
    g = _port(GRAPHS["rmat-int"]())
    for start, stop in ((5, 5), (-1, 3), (0, g.num_nodes + 1)):
        with pytest.raises(ValueError, match="subrange"):
            port.solve_range(g, start, stop)


def _first_cols(rows, batch):
    return np.asarray(rows)[:, :7].copy()


@pytest.mark.parametrize("reducer", ["checksum", "eccentricity",
                                     "reach_count", _first_cols])
@pytest.mark.parametrize("name", ["dag-neg-int", "grid-neg"])
def test_solve_reduced_matches_reference(name, reducer):
    g = GRAPHS[name]()
    sources = np.arange(3 * B) * (g.num_nodes // (3 * B))
    ref, port = _solvers(source_batch_size=B)
    want = ref.solve_reduced(g, sources, reduce_rows=reducer)
    got = port.solve_reduced(_port(g), sources, reduce_rows=reducer)
    assert len(got.values) == len(want.values) == 3
    full = port.solve(_port(g), sources).dist
    for k, (a, b) in enumerate(zip(got.values, want.values)):
        if reducer == "checksum":
            assert isinstance(a, float)
            np.testing.assert_allclose(a, b, rtol=1e-6)
            continue
        if reducer == "reach_count" or name.endswith("-int"):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6)
        # The port's reduction equals the same reduction of its solve rows.
        rows = full[B * k:B * (k + 1)]
        fn = (port_johnson._ROW_REDUCERS[reducer]
              if isinstance(reducer, str) else reducer)
        np.testing.assert_array_equal(np.asarray(a), fn(rows, None))


def test_solve_reduced_rejects_validate_and_unknown_reducer():
    g = _port(GRAPHS["rmat-int"]())
    with pytest.raises(ValueError, match="validate"):
        pjt.ParallelJohnsonSolver(pjt.SolverConfig(validate=True),
                                  device="cpu").solve_reduced(
            g, reduce_rows="checksum")
    _, port = _solvers()
    with pytest.raises(ValueError, match="unknown reducer"):
        port.solve_reduced(g, reduce_rows="median")


def test_solve_batch_matches_per_graph_solve_and_reference():
    graphs = [_int(load_graph(f"er:n={n},p=0.1,seed={s}"))
              for n, s in ((40, 1), (48, 2), (33, 3), (48, 4))]
    ref, port = _solvers()
    want = ref.solve_batch(graphs)
    got = port.solve_batch([_port(g) for g in graphs])
    assert len(got) == len(graphs)
    for g, a, b in zip(graphs, got, want):
        single = port.solve(_port(g))
        np.testing.assert_array_equal(to_numpy(a.dist), to_numpy(single.dist))
        np.testing.assert_array_equal(to_numpy(a.dist), np.asarray(b.dist))
        assert a.stats.routes_by_phase == {"batch_apsp": "batch-vmapped"}


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("name", ["dag-neg-int", "rmat-int"])
def test_pipeline_depths_bitwise(name, depth, monkeypatch):
    """Multi-batch solves at depths 1-3 equal the single-batch solve
    bitwise; the download clear fires on every batch (threshold 0)."""
    monkeypatch.setattr(port_johnson, "_DOWNLOAD_CLEAR_MIN_BYTES", 0)
    g = _port(GRAPHS[name]())
    one = pjt.ParallelJohnsonSolver(device="cpu").solve(g)
    res = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(source_batch_size=23, pipeline_depth=depth),
        device="cpu").solve(g)
    assert isinstance(res.dist, np.ndarray)
    np.testing.assert_array_equal(res.dist, to_numpy(one.dist))
    assert res.stats.final_pipeline_depth == depth
    assert res.stats.final_batch == 23
    assert res.stats.iterations_by_phase["fanout"] > 0
    if depth == 1:
        assert res.stats.overlap_saved_s == 0.0


@pytest.mark.parametrize("depth", [1, 2])
def test_checkpoint_run_twice_resumes_every_batch(tmp_path, depth):
    g = _port(GRAPHS["dag-neg-int"]())
    cfg = pjt.SolverConfig(source_batch_size=25, pipeline_depth=depth,
                           checkpoint_dir=str(tmp_path))
    first = pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(g)
    assert first.stats.batches_resumed == 0
    second = pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(g)
    assert second.stats.batches_resumed == 4  # ceil(90 / 25)
    np.testing.assert_array_equal(second.dist, first.dist)
    ckpt = BatchCheckpointer(tmp_path, graph_key=g)
    assert ckpt.completed_batches() == [0, 1, 2, 3]
    manifest = json.loads((ckpt.dir / "manifest.json").read_text())
    assert sorted(int(s) for e in manifest["files"].values()
                  for s in e["sources"]) == list(range(90))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    """A directory written by one package's ``solve`` resumes every batch
    in the other with the same rows, bitwise."""
    g = GRAPHS["dag-neg-int"]()
    sources = np.arange(5 * B)
    ref, port = _solvers(source_batch_size=B, checkpoint_dir=str(tmp_path))
    if writer == "jax":
        first = ref.solve(g, sources)
        second = port.solve(_port(g), sources)
    else:
        first = port.solve(_port(g), sources)
        second = ref.solve(g, sources)
    assert first.stats.batches_resumed == 0
    assert second.stats.batches_resumed == 5
    np.testing.assert_array_equal(np.asarray(second.dist),
                                  np.asarray(first.dist))
    names = sorted(p.name for p in tmp_path.glob("graph_*/rows_*.npz"))
    assert len(names) == 5 and names[0].startswith("rows_000000_")


OOM_PLANS = {
    # depth 2: the window collapses, the batch reruns at the same size.
    "collapse": (2, [dict(stage="fanout", kind="oom", batch=1)]),
    # depth 2, a second OOM: collapse, then halve.
    "collapse-halve": (2, [dict(stage="fanout", kind="oom", batch=1,
                                times=2)]),
    # serial: halve at once, twice.
    "halve-twice": (1, [dict(stage="fanout", kind="oom", batch=0, times=2)]),
}


@pytest.mark.parametrize("plan", sorted(OOM_PLANS))
def test_oom_plan_matches_reference(plan):
    depth, faults = OOM_PLANS[plan]
    g = GRAPHS["dag-neg-int"]()
    ref, port = _solvers(
        ref_faults.FaultPlan([ref_faults.Fault(**f) for f in faults]),
        port_faults.FaultPlan([port_faults.Fault(**f) for f in faults]),
        source_batch_size=B, pipeline_depth=depth, min_source_batch=4,
    )
    sources = np.arange(5 * B)
    want = ref.solve(g, sources)
    got = port.solve(_port(g), sources)
    for field in ("oom_degradations", "final_batch", "final_pipeline_depth",
                  "retries"):
        assert getattr(got.stats, field) == getattr(want.stats, field), field
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))
    clean = pjt.ParallelJohnsonSolver(device="cpu").solve(_port(g), sources)
    np.testing.assert_array_equal(to_numpy(got.dist), to_numpy(clean.dist))


def test_oom_at_the_floor_raises():
    plan = port_faults.FaultPlan([port_faults.Fault(
        stage="fanout", kind="oom", batch=0, times=99)])
    cfg = pjt.SolverConfig(source_batch_size=8, min_source_batch=8,
                           pipeline_depth=1, fault_plan=plan)
    with pytest.raises(port_faults.InjectedOOMError):
        pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(
            _port(GRAPHS["rmat-int"]()))


@pytest.mark.parametrize("stage", ["fanout", "download", "bellman_ford"])
def test_transient_fault_bumps_retries(stage):
    fault = dict(stage=stage, kind="error",
                 batch=None if stage == "bellman_ford" else 1)
    g = GRAPHS["dag-neg-int"]()
    ref, port = _solvers(
        ref_faults.FaultPlan([ref_faults.Fault(**fault)]),
        port_faults.FaultPlan([port_faults.Fault(**fault)]),
        source_batch_size=B, retry_backoff_s=0.0,
    )
    sources = np.arange(5 * B)
    got = port.solve(_port(g), sources)
    want = ref.solve(g, sources)
    assert got.stats.retries == want.stats.retries == 1
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))


@pytest.mark.parametrize("stage,depth", [("fanout", 1), ("fanout", 2),
                                         ("bellman_ford", 2)])
def test_nan_rows_raise_solve_corruption(stage, depth):
    fault = dict(stage=stage, kind="nan",
                 batch=None if stage == "bellman_ford" else 1)
    plan = port_faults.FaultPlan([port_faults.Fault(**fault)])
    cfg = pjt.SolverConfig(source_batch_size=32, pipeline_depth=depth,
                           fault_plan=plan)
    with pytest.raises(pjt.SolveCorruptionError, match=stage):
        pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(
            _port(GRAPHS["dag-neg-int"]()))


@pytest.mark.parametrize("depth", [1, 2])
def test_killed_ckpt_write_resumes_exactly(tmp_path, depth):
    """A checkpoint write that dies surfaces as SolveCorruptionError; the
    rerun resumes every committed batch and recomputes the rest."""
    g = _port(GRAPHS["dag-neg-int"]())
    plan = port_faults.FaultPlan([port_faults.Fault(
        stage="ckpt_write", kind="error", batch=1, times=99)])
    kw = dict(source_batch_size=25, pipeline_depth=depth,
              checkpoint_dir=str(tmp_path))
    with pytest.raises(pjt.SolveCorruptionError, match="batch 1"):
        pjt.ParallelJohnsonSolver(pjt.SolverConfig(fault_plan=plan, **kw),
                                  device="cpu").solve(g)
    done = BatchCheckpointer(tmp_path, graph_key=g).completed_batches()
    assert 0 in done and 1 not in done
    again = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**kw),
                                      device="cpu").solve(g)
    assert again.stats.batches_resumed == len(done)
    clean = pjt.ParallelJohnsonSolver(device="cpu").solve(g)
    np.testing.assert_array_equal(again.dist, to_numpy(clean.dist))


@pytest.mark.parametrize("exc,oom", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     True),
    (RuntimeError("CUDA error: out of memory"), True),
    (port_faults.InjectedOOMError("injected"), True),
    (MemoryError(), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (port_faults.InjectedFaultError("injected"), False),
    (ValueError("out of memory"), False),
])
def test_is_oom_error(exc, oom):
    assert port_resilience.is_oom_error(exc) is oom
    # The reference agrees wherever it can see the failure (a CUDA OOM's
    # type name is not one it matches, which is why the port's differs).
    if not isinstance(exc, torch.OutOfMemoryError):
        assert ref_resilience.is_oom_error(exc) is oom


def test_port_transient_errors_are_injected_only():
    assert port_johnson._transient_error(port_faults.InjectedFaultError("x"))
    assert not port_johnson._transient_error(
        RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not port_johnson._transient_error(pjt.NegativeCycleError("x"))


def test_rows_by_source_and_path():
    g = _port(GRAPHS["dag-neg-int"]())
    res = pjt.ParallelJohnsonSolver(device="cpu").solve(g, [4, 9])
    rows = res.rows_by_source()
    assert sorted(rows) == [4, 9]
    np.testing.assert_array_equal(to_numpy(rows[9]), to_numpy(res.dist)[1])
    with pytest.raises(ValueError, match="predecessors"):
        res.path(4, 9)


@pytest.mark.parametrize("call", ["solve", "solve_range", "sssp",
                                  "multi_source"])
def test_predecessors_raise_on_every_entry_point(call):
    """A zero-weight tight cycle defeats the one-pass extraction; with
    ``pred_extraction=True`` forced, every entry point raises naming the
    field instead of falling back to the argmin sweep."""
    g = pjt.CSRGraph.from_edges([0, 3, 1, 2], [3, 1, 2, 1],
                                [1.0, 0.0, 0.0, 0.0], 4)
    solver = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(pred_extraction=True), device="cpu")
    args = {"solve": (g, [0]), "solve_range": (g, 0, 1), "sssp": (g, 0),
            "multi_source": (g, [0])}[call]
    with pytest.raises(RuntimeError, match="pred_extraction=True"):
        getattr(solver, call)(*args, predecessors=True)


def test_suggested_batch_budgets_pipeline_carry():
    """One [B, V] block more per in-flight slot beyond the first (V large
    enough that the 4 GB CPU budget, not the 2^16 cap, sets B)."""
    g = pjt.load_graph("rmat:scale=12,ef=4,seed=1")

    def suggested(depth, with_pred=False):
        backend = pjt.get_backend(
            "torch", pjt.SolverConfig(pipeline_depth=depth), device="cpu")
        return backend.suggested_source_batch(backend.upload(g),
                                              with_pred=with_pred)

    assert suggested(1) > suggested(2) > suggested(3)
    assert suggested(1, with_pred=True) < suggested(1)
