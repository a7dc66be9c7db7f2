"""PyTorch port: predecessor trees on the CPU against the JAX package.

``ops.pred`` (the tight-edge pass on COO and on the CSC, the pointer-doubling
root check, the checked extraction) and the argmin sweep are held to the
reference's functions on the same distances: the int32 trees and the
``ok`` flags must be equal, and the sweep's distances bitwise. The solver's
``predecessors=True`` solves are held to the reference's on its pinned
routes: distances bitwise on integer weights, trees equal, and every tree
valid (``validate_pred_tree``) against its distances, which agree with
scipy."""

import dataclasses
import warnings

import numpy as np
import pytest
import scipy.sparse.csgraph as csgraph

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import (
    CSRGraph as RefGraph,
    erdos_renyi,
    load_graph,
    random_dag,
)
from paralleljohnson_tpu.ops import pred as ref_pred
from paralleljohnson_tpu.ops import relax as ref_relax
from paralleljohnson_tpu.solver import ParallelJohnsonSolver as RefSolver

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
from paralleljohnson_tpu_torch.ops import pred as port_pred
from paralleljohnson_tpu_torch.ops import relax as port_relax
from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

PINNED = dict(use_pallas=True, mesh_shape=(1,), fw=False, frontier=False,
              dia=False, gauss_seidel=False, bucket=False)


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _int(g):
    return g.with_weights(np.round(g.weights))


def _zero_cycle_graph():
    """0 -> 3 (w=1) -> 1 <-> 2 (both w=0): a tight zero-weight cycle on
    shortest paths, which the one-pass rule cannot resolve (the
    reference's ``tests/test_pred_extraction.py`` graph)."""
    return RefGraph.from_edges([0, 3, 1, 2], [3, 1, 2, 1],
                               [1.0, 0.0, 0.0, 0.0], 4)


def _plus_one(g):
    """``g`` with integer weights >= 1: no zero-weight cycle."""
    return g.with_weights(np.floor(g.weights) + 1)


def _ties(g):
    """``g`` with integer weights, a third of them 0: many tight ties."""
    w = np.floor(g.weights)
    w[np.random.default_rng(0).random(w.shape[0]) < 0.33] = 0.0
    return g.with_weights(w.astype(np.float32))


def _rmat_hub():
    """R-MAT-10 whose hub rows the tests cut into pieces of ITEM_L edges."""
    return _ties(load_graph("rmat:scale=10,ef=8,seed=2"))


ITEM_L = 8  # work-item size that splits R-MAT-10's hubs into pieces

GRAPHS = {
    "tiny": lambda: RefGraph.from_edges([0, 0, 1, 2, 3, 2], [1, 2, 3, 3, 0, 1],
                                        [1.0, 4.0, 2.0, 1.0, 0.0, 0.0], 4),
    "dag-neg-int": lambda: _int(random_dag(60, 0.1, negative_fraction=0.4,
                                           seed=3)),
    "dag-neg-int-b": lambda: _int(random_dag(80, 0.08, negative_fraction=0.3,
                                             seed=9)),
    "er48": lambda: _ties(erdos_renyi(48, 0.12, seed=5)),
    "er48-int": lambda: _int(erdos_renyi(48, 0.12, seed=5)),
    "er256": lambda: _ties(erdos_renyi(256, 0.03, seed=6)),
    "grid": lambda: _ties(load_graph("grid:rows=9,cols=11,seed=1")),
    "grid-int": lambda: _plus_one(load_graph("grid:rows=9,cols=11,seed=1")),
    "rmat10-hub": _rmat_hub,
}


def _fixpoint(g, sources):
    """Converged [B, V] distances of ``g`` (reweighted to non-negative
    with the port's own potentials when it has negative weights) and the
    graph they are a fixpoint of, by the port's plain sweep."""
    port = pjt.get_backend("torch", pjt.SolverConfig(), device="cpu")
    dg = port.upload(_port(g))
    if g.has_negative_weights:
        h = port.bellman_ford(dg, None).dist
        dg = port.reweight(dg, h)
    res = port.multi_source(dg, sources)
    e = dg.num_real_edges
    rew = g.with_weights(dg.weights[:e].numpy())
    return res.dist, rew


def _sources(g, n=7):
    return np.unique(np.random.default_rng(g.num_nodes).integers(
        0, g.num_nodes, n))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tight_pass_and_extraction_match_reference(name):
    """On the same converged distances: the COO pass, the checked
    extraction and the root check equal the reference's; the CSC entry
    point (the kernel's wrapper, on the CPU its plain version over the
    CSC's edges) equals the COO pass, hubs split into pieces of ITEM_L."""
    g = GRAPHS[name]()
    sources = _sources(g)
    dist, rew = _fixpoint(g, sources)
    src, dst, w = (torch.as_tensor(x) for x in (rew.src, rew.indices,
                                                rew.weights))
    want = np.asarray(ref_pred.tight_pred_pass(
        jnp.asarray(dist.numpy()), jnp.asarray(rew.src),
        jnp.asarray(rew.indices), jnp.asarray(rew.weights), edge_chunk=37))
    got = port_pred.tight_pred_pass_plain(dist, src, dst, w, edge_chunk=53)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any()

    lay = fs.build_in_edge_layout(src, dst, g.num_nodes)
    items = fs.build_work_items(lay["indptr_in"], ITEM_L)
    if name == "rmat10-hub":
        assert items.n_split > 0
    got_vm = port_pred.tight_pred_pass(
        dist.t().contiguous(), lay["indptr_in"], lay["src_in"],
        w[lay["order"]].contiguous(), items=items)
    np.testing.assert_array_equal(got_vm.t().numpy(), want)

    ref_p, ref_ok = ref_pred.extract_pred(
        jnp.asarray(dist.numpy()), jnp.asarray(sources, jnp.int32),
        jnp.asarray(rew.src), jnp.asarray(rew.indices),
        jnp.asarray(rew.weights))
    p, ok = port_pred.extract_pred(dist, sources, src, dst, w)
    np.testing.assert_array_equal(p.numpy(), np.asarray(ref_p))
    assert bool(ok) == bool(ref_ok)
    np.testing.assert_array_equal(
        port_pred.pred_reaches_root(p).numpy(),
        np.asarray(ref_pred.pred_reaches_root(ref_p)))


def _certified(dist, rew, sources):
    """The backend's path on the CPU: the CSC pass with ``sources`` (the
    kernel's wrapper, here its plain version and ``tree_flags_plain``),
    then ``certify_pred`` on its flags. Returns (pred, ok, flags)."""
    src, dst, w = (torch.as_tensor(x) for x in (rew.src, rew.indices,
                                                rew.weights))
    lay = fs.build_in_edge_layout(src, dst, rew.num_nodes)
    pred_vm, flags = port_pred.tight_pred_pass(
        dist.t().contiguous(), lay["indptr_in"], lay["src_in"],
        w[lay["order"]].contiguous(), sources=sources)
    pred, ok = port_pred.certify_pred(pred_vm.t().contiguous(), dist,
                                      sources, flags=flags)
    return pred, ok, flags


def _check_certificate(dist, rew, sources):
    """The flags' certificate gives the reference's ``extract_pred``
    tree and ``ok`` on the same distances; returns the flags."""
    pred, ok, flags = _certified(dist, rew, sources)
    ref_p, ref_ok = ref_pred.extract_pred(
        jnp.asarray(dist.numpy()), jnp.asarray(sources, jnp.int32),
        jnp.asarray(rew.src), jnp.asarray(rew.indices),
        jnp.asarray(rew.weights))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(ref_p))
    assert bool(ok) == bool(ref_ok)
    assert flags.dtype == torch.int32 and flags.shape == (2,)
    return flags


@pytest.mark.parametrize("name", sorted(GRAPHS) + ["zero-cycle"])
def test_certificate_with_flags_matches_reference(name):
    """``certify_pred`` with the pass's flags (one host read, the walk
    only on ties) gives the reference's ``pred`` and ``ok``; the flags
    and source mask equal ``tree_flags_plain`` on the plain COO pass."""
    g = _zero_cycle_graph() if name == "zero-cycle" else GRAPHS[name]()
    sources = np.array([0]) if name == "zero-cycle" else _sources(g)
    dist, rew = _fixpoint(g, sources)
    flags = _check_certificate(dist, rew, sources)
    plain = port_pred.tight_pred_pass_plain(
        dist, *(torch.as_tensor(x) for x in (rew.src, rew.indices,
                                             rew.weights)))
    want_pred, want_flags = port_pred.tree_flags_plain(plain, dist, sources)
    assert torch.equal(flags, want_flags)
    assert torch.equal(_certified(dist, rew, sources)[0], want_pred)
    if name == "zero-cycle":
        assert flags.tolist() == [0, 1]


def test_certificate_with_flags_on_hypothesis_graphs():
    """The same on the reference's hypothesis graphs, weights rounded to
    integers (negative ones on a DAG order, reweighted by the port's
    potentials)."""
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings

    from tests.test_properties import graphs

    @settings(max_examples=20, deadline=None)
    @given(graphs(max_nodes=18, negative=True))
    def run(g):
        g = _int(g)
        sources = np.arange(min(6, g.num_nodes))
        dist, rew = _fixpoint(g, sources)
        _check_certificate(dist, rew, sources)

    run()
    assert hypothesis is not None


def test_tree_flags_plain_cases():
    """Uncovered: a finite non-source entry without predecessor (never an
    unreachable or source entry); nondescending: a predecessor not
    strictly closer (-0.0 against +0.0 included); sources masked."""
    dist = torch.tensor([[0.0, 1.0, 1.0, float("inf")],
                         [-0.0, 0.0, 2.0, 3.0]])
    pred = torch.tensor([[1, 0, 0, -1], [-1, 0, 1, 2]], dtype=torch.int32)
    got, flags = port_pred.tree_flags_plain(pred, dist, [0, 0])
    assert got.tolist() == [[-1, 0, 0, -1], [-1, 0, 1, 2]]
    assert flags.tolist() == [0, 1]  # row 1: dist[0] = -0.0 == dist[1]
    assert pred[0, 0] == 1  # the input is not masked in place
    _, flags = port_pred.tree_flags_plain(
        torch.tensor([[-1, 0, -1, -1]], dtype=torch.int32),
        torch.tensor([[0.0, 1.0, 2.0, float("inf")]]), [0])
    assert flags.tolist() == [1, 0]
    _, flags = port_pred.tree_flags_plain(
        torch.tensor([[-1, 0, 1, -1]], dtype=torch.int32),
        torch.tensor([[0.0, 1.0, 2.0, float("inf")]]), [0])
    assert flags.tolist() == [0, 0]


@pytest.mark.parametrize("name,walks", [("grid-int", 0), ("rmat-int", 0),
                                        ("grid", 1)])
def test_pred_solve_walks_only_on_ties(name, walks):
    """Through the backend: a multi-source pred solve on strictly
    positive weights certifies its trees with no pointer-doubling walk;
    on the zero-tie grid the walk runs (and finds a zero-weight tight
    cycle there, so both packages fall back to the argmin sweep); routes
    and trees are the reference's."""
    g = (_int(load_graph("rmat:scale=8,ef=8,seed=5")) if name == "rmat-int"
         else GRAPHS[name]())
    assert walks or (g.weights >= 1).all()
    ref, port = _solvers()
    sources = _sources(g, 12)
    before = port_pred.pred_reaches_root.walks
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = port.multi_source(_port(g), sources, predecessors=True)
        want = ref.multi_source(g, sources, predecessors=True)
    ran = port_pred.pred_reaches_root.walks - before
    assert ran == 0 if walks == 0 else ran >= walks
    assert got.stats.routes_by_phase == want.stats.routes_by_phase
    assert walks or got.stats.routes_by_phase["fanout"].endswith("+pred")
    np.testing.assert_array_equal(to_numpy(got.predecessors),
                                  np.asarray(want.predecessors))


def test_pred_reaches_root_gathers_int32_indices():
    """The doubling gathers on the int32 ``pred`` itself, with no int64
    copy, and counts one walk per call."""
    before = port_pred.pred_reaches_root.walks
    chain = torch.tensor([[-1] + list(range(0, 99))], dtype=torch.int32)
    assert bool(port_pred.pred_reaches_root(chain).all())
    assert port_pred.pred_reaches_root.walks == before + 1


def test_tight_pred_pass_lexicographic_tiebreak():
    """The reference's example: both in-edges of 1 are tight and the
    strictly closer predecessor 0 beats the zero edge from 2."""
    src = torch.tensor([0, 0, 2], dtype=torch.int32)
    dst = torch.tensor([1, 2, 1], dtype=torch.int32)
    w = torch.tensor([1.0, 1.0, 0.0])
    dist = torch.tensor([[0.0, 1.0, 1.0]])
    pred, ok = port_pred.extract_pred(dist, [0], src, dst, w)
    assert bool(ok) and pred.tolist() == [[-1, 0, 0]]


@pytest.mark.parametrize("form", ["coo", "vm"])
def test_negative_zero_ties_with_positive_zero(form):
    """du = -0.0 and du = +0.0 tie (the reference compares floats), so the
    smaller id wins whichever zero it carries: here vertex 2 (+0.0) over 3
    (-0.0) into 4, and 1 (-0.0) over 2 (+0.0) into 5."""
    src = torch.tensor([2, 3, 2, 1], dtype=torch.int32)
    dst = torch.tensor([4, 4, 5, 5], dtype=torch.int32)
    w = torch.tensor([1.0, 1.0, 2.0, 2.0])
    dist = torch.tensor([[0.0, -0.0, 0.0, -0.0, 1.0, 2.0]])
    want = np.asarray(ref_pred.tight_pred_pass(
        jnp.asarray(dist.numpy()), jnp.asarray(src.numpy()),
        jnp.asarray(dst.numpy()), jnp.asarray(w.numpy())))
    assert want.tolist() == [[-1, -1, -1, -1, 2, 1]]
    if form == "coo":
        got = port_pred.tight_pred_pass_plain(dist, src, dst, w)
    else:
        lay = fs.build_in_edge_layout(src, dst, 6)
        got = port_pred.tight_pred_pass(
            dist.t().contiguous(), lay["indptr_in"], lay["src_in"],
            w[lay["order"]].contiguous(),
            items=fs.build_work_items(lay["indptr_in"], 1)).t()
    np.testing.assert_array_equal(got.numpy(), want)


def test_csc_pass_on_cpu_counts_no_launch_and_takes_edgeless_layouts():
    """A CPU tensor runs the plain pass and counts nothing; a CSC with no
    edges gives ``NO_PRED`` everywhere, in both dtypes."""
    empty = torch.zeros(0, dtype=torch.int32)
    lay = fs.build_in_edge_layout(empty, empty, 3)
    before = port_pred.tight_pred_pass.launches
    for dtype in (torch.float32, torch.float64):
        dist = torch.tensor([[0.0, 1.0], [2.0, 0.0], [5.0, 3.0]], dtype=dtype)
        got = port_pred.tight_pred_pass(dist, lay["indptr_in"], lay["src_in"],
                                        torch.zeros(0, dtype=dtype))
        assert got.dtype == torch.int32 and got.shape == (3, 2)
        assert (got == -1).all()
    assert port_pred.tight_pred_pass.launches == before


def test_pred_reaches_root_detects_cycle():
    tree = torch.tensor([[-1, 0, 1, 1]], dtype=torch.int32)
    assert bool(port_pred.pred_reaches_root(tree).all())
    cycle = torch.tensor([[-1, 2, 1, 1]], dtype=torch.int32)
    np.testing.assert_array_equal(
        port_pred.pred_reaches_root(cycle).numpy(),
        np.asarray(ref_pred.pred_reaches_root(jnp.asarray(cycle.numpy()))))


@pytest.mark.parametrize("name", ["tiny", "dag-neg-int", "grid", "er48"])
@pytest.mark.parametrize("batch", [1, 5])
def test_argmin_sweep_matches_reference(name, batch):
    """``bellman_ford_sweeps_pred`` (route pred-sweep) on the graph's own
    weights, negative ones included, with an edge chunk that cuts the
    list: distances bitwise, trees equal, sweep counts equal."""
    g = GRAPHS[name]()
    sources = _sources(g, batch)[:batch]
    dg = _port(g).pad_edges(64)
    d0 = port_relax.multi_source_init(torch.as_tensor(sources), g.num_nodes)
    args = [torch.as_tensor(x) for x in (dg.src, dg.indices, dg.weights)]
    d, p, it, imp = port_relax.bellman_ford_sweeps_pred(
        d0, *args, max_iter=g.num_nodes, edge_chunk=29)
    rd, rp, rit, rimp = ref_relax.bellman_ford_sweeps_pred(
        jnp.asarray(d0.numpy()), *(jnp.asarray(a.numpy()) for a in args),
        max_iter=g.num_nodes, edge_chunk=29)
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(p.numpy(), np.asarray(rp))
    assert (it, imp) == (int(rit), bool(rimp))


def _solvers(**overrides):
    ref_cfg = RefConfig(**{**PINNED, **overrides})
    cfg = interop.config_from_dict(dataclasses.asdict(ref_cfg))
    return RefSolver(ref_cfg), pjt.ParallelJohnsonSolver(cfg, device="cpu")


def _check_tree(g, res):
    """The port's tree is valid against its own rows, which agree with
    scipy's Johnson."""
    dist, pred = to_numpy(res.dist), to_numpy(res.predecessors)
    validate_pred_tree(_port(g), dist, pred, res.sources)
    dense = np.ma.masked_invalid(g.to_dense().astype(np.float64))
    oracle = csgraph.johnson(dense, directed=True)[res.sources]
    np.testing.assert_allclose(dist, oracle, rtol=1e-5, atol=1e-4)


ENTRY = {
    "solve": lambda s, g: s.solve(g, np.arange(0, g.num_nodes, 3),
                                  predecessors=True),
    "solve_range": lambda s, g: s.solve_range(g, 5, 37, predecessors=True),
    "sssp": lambda s, g: s.sssp(g, 4, predecessors=True),
    "multi_source": lambda s, g: s.multi_source(g, [0, 7, 3, 20, 11],
                                                predecessors=True),
}


@pytest.mark.parametrize("name", ["dag-neg-int", "er48-int", "grid-int",
                                  "rmat6"])
@pytest.mark.parametrize("entry", sorted(ENTRY))
def test_pred_solves_match_reference(entry, name):
    if name == "rmat6":
        g = _int(load_graph("rmat:scale=6,ef=8,seed=3"))
    else:
        g = GRAPHS[name]()
    if entry == "multi_source" and g.has_negative_weights:
        g = g.with_weights(np.abs(g.weights))
    ref, port = _solvers()
    want = ENTRY[entry](ref, g)
    got = ENTRY[entry](port, _port(g))
    assert got.stats.routes_by_phase == want.stats.routes_by_phase
    assert all(r.endswith("+pred")
               for r in got.stats.routes_by_phase.values()
               if r != "sweep")  # phase 1 takes no tree
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))
    np.testing.assert_array_equal(to_numpy(got.predecessors),
                                  np.asarray(want.predecessors))
    assert got.stats.edges_relaxed == want.stats.edges_relaxed
    _check_tree(g, got)
    s, t = int(got.sources[-1]), int(np.argmax(
        np.where(np.isfinite(to_numpy(got.dist)[-1]), to_numpy(got.dist)[-1],
                 -np.inf)))
    path = got.path(s, t)
    assert path[0] == s and path[-1] == t


@pytest.mark.parametrize("depth", [1, 2])
def test_multi_batch_pred_solve_matches_single_batch_and_reference(depth):
    g = GRAPHS["dag-neg-int-b"]()
    ref, port = _solvers(source_batch_size=16, pipeline_depth=depth)
    got = port.solve(_port(g), predecessors=True)
    want = ref.solve(g, predecessors=True)
    one = pjt.ParallelJohnsonSolver(device="cpu").solve(_port(g),
                                                        predecessors=True)
    assert isinstance(got.predecessors, np.ndarray)
    assert got.predecessors.dtype == np.int32
    assert got.stats.final_pipeline_depth == depth
    np.testing.assert_array_equal(got.dist, to_numpy(one.dist))
    np.testing.assert_array_equal(got.predecessors,
                                  to_numpy(one.predecessors))
    np.testing.assert_array_equal(got.predecessors,
                                  np.asarray(want.predecessors))
    _check_tree(g, got)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpointed_pred_solve_resumes_across_packages(tmp_path, writer):
    """A pred solve checkpointed by one package resumes in the other:
    every batch read back, rows and trees equal."""
    g = GRAPHS["dag-neg-int"]()
    ref, port = _solvers(source_batch_size=16,
                         checkpoint_dir=str(tmp_path))
    first, second = (port, ref) if writer == "port" else (ref, port)
    gw = _port(g) if writer == "port" else g
    gr = g if writer == "port" else _port(g)
    a = first.solve(gw, predecessors=True)
    b = second.solve(gr, predecessors=True)
    n = -(-g.num_nodes // 16)
    assert a.stats.batches_resumed == 0 and b.stats.batches_resumed == n
    np.testing.assert_array_equal(to_numpy(b.dist), to_numpy(a.dist))
    np.testing.assert_array_equal(to_numpy(b.predecessors),
                                  to_numpy(a.predecessors))


def test_zero_weight_tight_cycle_falls_back_with_a_warning():
    g = _zero_cycle_graph()
    ref, port = _solvers()
    for call in (lambda s, gg: s.multi_source(gg, [0], predecessors=True),
                 lambda s, gg: s.sssp(gg, 0, predecessors=True)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = call(port, _port(g))
        assert any("fell back" in str(r.message) for r in rec)
        assert set(got.stats.routes_by_phase.values()) == {"pred-sweep"}
        want = call(ref, g)
        np.testing.assert_array_equal(to_numpy(got.predecessors),
                                      np.asarray(want.predecessors))
        validate_pred_tree(_port(g), to_numpy(got.dist),
                           to_numpy(got.predecessors), got.sources)
        for t in range(4):
            got.path(0, t)


def test_zero_weight_tight_cycle_forced_extraction_raises():
    _, port = _solvers(pred_extraction=True)
    with pytest.raises(RuntimeError, match="pred_extraction=True"):
        port.multi_source(_port(_zero_cycle_graph()), [0], predecessors=True)


def test_pred_extraction_false_takes_the_argmin_sweep():
    g = GRAPHS["er48"]()
    ref, port = _solvers(pred_extraction=False)
    got = port.multi_source(_port(g), np.arange(8), predecessors=True)
    want = ref.multi_source(g, np.arange(8), predecessors=True)
    assert got.stats.routes_by_phase["fanout"] == "pred-sweep"
    assert got.stats.edges_relaxed == want.stats.edges_relaxed
    np.testing.assert_array_equal(to_numpy(got.predecessors),
                                  np.asarray(want.predecessors))
    _check_tree(g, got)


def test_pred_fanout_adds_one_pass_of_edges():
    """The pred solve takes the plain solve's route plus ``+pred`` and
    relaxes exactly B x E more edges: one extraction pass."""
    g = _port(_int(load_graph("rmat:scale=8,ef=8,seed=5")))
    solver = pjt.ParallelJohnsonSolver(device="cpu")
    sources = np.arange(32)
    plain = solver.multi_source(g, sources)
    pred = solver.multi_source(g, sources, predecessors=True)
    assert (pred.stats.routes_by_phase["fanout"]
            == plain.stats.routes_by_phase["fanout"] + "+pred")
    assert (pred.stats.edges_relaxed
            == plain.stats.edges_relaxed + len(sources) * g.num_real_edges)
    np.testing.assert_array_equal(to_numpy(pred.dist), to_numpy(plain.dist))


def test_f64_pred_solve_equals_f32_on_integer_weights():
    """precision="f64" (CPU only) extracts with the reference's pass in
    f64; on integer weights its trees equal the f32 solve's."""
    g = _port(GRAPHS["dag-neg-int"]())
    f32 = pjt.ParallelJohnsonSolver(device="cpu").solve(g, predecessors=True)
    f64 = pjt.ParallelJohnsonSolver(pjt.SolverConfig(precision="f64"),
                                    device="cpu").solve(g, predecessors=True)
    assert to_numpy(f64.dist).dtype == np.float64
    np.testing.assert_array_equal(to_numpy(f64.predecessors),
                                  to_numpy(f32.predecessors))
    validate_pred_tree(g, to_numpy(f64.dist), to_numpy(f64.predecessors),
                       f64.sources)


def test_edgeless_graph_validates():
    """The graph hypothesis shrinks the reference's failing test to: no
    edges at all. The port's validator accepts its tree."""
    g = pjt.CSRGraph.from_edges([], [], [], 2)
    res = pjt.ParallelJohnsonSolver(device="cpu").solve(g, predecessors=True)
    pred = to_numpy(res.predecessors)
    assert (pred == -1).all()
    validate_pred_tree(g, to_numpy(res.dist), pred, res.sources)


def test_pred_trees_valid_on_hypothesis_graphs():
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import example, given, settings

    from tests.test_properties import graphs

    @settings(max_examples=20, deadline=None)
    @given(graphs(max_nodes=18, negative=True))
    @example(RefGraph.from_edges([], [], [], 2))
    def run(g):
        res = pjt.ParallelJohnsonSolver(device="cpu").solve(
            _port(g), sources=np.arange(min(6, g.num_nodes)),
            predecessors=True)
        _check_tree(g, res)

    run()
    assert hypothesis is not None
