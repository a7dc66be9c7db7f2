"""PyTorch port on the card: each hand CUDA kernel against its plain
PyTorch version, and ``solve()`` on the card (predecessor trees and the
plain-torch XLA routes included) against ``solve()`` on the CPU, the
B=1 routes' ``sssp`` against ``sweep``'s, an in-process fleet and a
checkpoint repair against the card's ``solve()``, and the serving tier's
device lookups and the hopset's chunked sweeps against their host and
plain versions, and the command line (``python -m
paralleljohnson_tpu_torch``) on the card against the in-process solve.
Every test needs a CUDA device and skips without one,
except the one that checks the engine refuses to start without it.

This file imports nothing of JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX for
the reference's tests.)"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch.backends import torch_backend
from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
from paralleljohnson_tpu_torch.ops import minplus as mp_mod
from paralleljohnson_tpu_torch.ops import pred as pred_mod
from paralleljohnson_tpu_torch.ops import relax
from paralleljohnson_tpu_torch.ops.minplus import (
    minplus_fixpoint,
    minplus_kernel,
    minplus_plain,
)
from paralleljohnson_tpu_torch.solver import johnson
from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree
from paralleljohnson_tpu_torch.utils.resilience import is_oom_error


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only on the card")
    return torch.device("cuda")


def _layout(g, device):
    e = g.num_real_edges
    src = torch.as_tensor(g.src[:e]).to(device)
    dst = torch.as_tensor(g.indices[:e]).to(device)
    lay = fs.build_in_edge_layout(src, dst, g.num_nodes)
    w_in = torch.as_tensor(g.weights[:e]).to(device)[lay["order"]].contiguous()
    return lay["indptr_in"], lay["src_in"], w_in


def _dist0(sources, rows, b, device):
    d = torch.full((rows, b), float("inf"), device=device)
    d[torch.as_tensor(sources, device=device),
      torch.arange(b, device=device)] = 0.0
    return d


def _operands(rng, i, k, j, inf_frac=0.3):
    d = rng.random((i, k)).astype(np.float32)
    a = rng.random((k, j)).astype(np.float32)
    d[rng.random((i, k)) < inf_frac] = np.inf
    a[rng.random((k, j)) < inf_frac] = np.inf
    return d, a


def hub_graph(g, l, *, inf_frac=0.0, seed=11):
    """``g`` with a hub (vertex 0) of 5 l + 3 in-edges, rows of exactly l
    and l + 1 in-edges (vertices 1, 2) and an empty row (vertex 3), the
    new in-edges from distinct other vertices with integer weights 1..9;
    then a fraction ``inf_frac`` of all weights set to +inf. Takes and
    returns either package's ``CSRGraph`` (``chip_smoke.py`` uses it too)."""
    degrees = {0: 5 * l + 3, 1: l, 2: l + 1, 3: 0}
    rng = np.random.default_rng(seed)
    e = g.num_real_edges
    keep = ~np.isin(g.indices[:e], list(degrees))
    src, dst, w = [g.src[:e][keep]], [g.indices[:e][keep]], [g.weights[:e][keep]]
    for v, n in degrees.items():
        others = np.setdiff1d(np.arange(g.num_nodes), [v])
        src.append(rng.choice(others, n, replace=False))
        dst.append(np.full(n, v))
        w.append(rng.integers(1, 10, n).astype(np.float32))
    w = np.concatenate(w)
    w[rng.random(w.shape[0]) < inf_frac] = np.inf
    return type(g).from_edges(np.concatenate(src), np.concatenate(dst), w,
                              g.num_nodes)


def _hub_graph():
    """The hub graph at L = ``fs.ITEM_EDGES`` with 30% +inf weights."""
    l = fs.ITEM_EDGES
    g = pjt.load_graph(f"rmat:scale={max(12, (5 * l + 8).bit_length())},"
                       f"ef=8,seed=2")
    return hub_graph(g, l, inf_frac=0.3)


SWEEP_GRAPHS = {
    "rmat12": lambda: pjt.load_graph("rmat:scale=12,ef=16,seed=3"),
    "hub": _hub_graph,
    "tiny": lambda: pjt.load_graph("rmat:scale=4,ef=4,seed=1"),  # V < 32
}


@pytest.mark.parametrize("graph", sorted(SWEEP_GRAPHS))
@pytest.mark.parametrize("b", [1, 5, 128, 200, 512, 700])
def test_fanout_sweep_kernel_equals_plain(cuda, b, graph):
    """B=1/5 take the scalar lane path, 128/200/512/700 the float4 path
    (B % 4 == 0); 200 has a ragged pass, 700 a second 512-column pass
    inside the warp. The hub graph splits its hub and the L + 1 row into
    pieces, so the partial-minimum pass and the combine run against the
    plain version."""
    g = SWEEP_GRAPHS[graph]()
    layout = _layout(g, cuda)
    items = fs.build_work_items(layout[0])
    if graph == "hub":
        assert items.n_split >= 5 + 2
    sources = np.random.default_rng(b).integers(0, g.num_nodes, b)
    d = _dist0(sources, g.num_nodes, b, cuda)
    for _ in range(3):  # a block with finite values to fold
        d, _ = fs.fanout_sweep_plain(d, *layout)
    before = fs.fanout_sweep.launches
    got, flag = fs.fanout_sweep(d, *layout, items=items)
    want, imp = fs.fanout_sweep_plain(d, *layout)
    torch.cuda.synchronize()
    assert fs.fanout_sweep.launches == before + 1
    assert torch.equal(got, want)
    assert bool(flag.item()) == bool(imp)


def test_fanout_sweep_skipped_writes_nothing(cuda):
    g = _hub_graph()
    layout = _layout(g, cuda)
    d = _dist0([0, 5, 9], g.num_nodes, 3, cuda)
    out = torch.full_like(d, 7.0)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    fs.fanout_sweep(d, *layout, out=out, improved=flag,
                    prev=torch.zeros(1, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and int(flag.item()) == 0


def test_fanout_fixpoint_on_card_equals_cpu(cuda):
    g = pjt.load_graph("grid:rows=30,cols=40,seed=7")
    sources = np.arange(0, g.num_nodes, 97)
    b = len(sources)
    want, it_w, imp_w = fs.fanout_fixpoint(
        _dist0(sources, g.num_nodes, b, "cpu"), *_layout(g, "cpu"),
        max_iter=g.num_nodes,
    )
    got, it, imp = fs.fanout_fixpoint(
        _dist0(sources, g.num_nodes, b, cuda), *_layout(g, cuda),
        max_iter=g.num_nodes,
    )
    assert torch.equal(got.cpu(), want)
    assert (it, imp) == (it_w, imp_w)


@pytest.mark.parametrize("k", [3, 16])
@pytest.mark.parametrize("graph,max_iter", [("grid", None), ("grid", 5),
                                            ("hub", None)])
def test_grouped_fixpoint_on_card_equals_cpu(cuda, monkeypatch, k, graph,
                                             max_iter):
    """K sweeps launched per host read on the card, against the CPU
    fixpoint: dist, iterations, flag; host reads <= ceil(it / K) + 1."""
    monkeypatch.setattr(fs, "SWEEPS_PER_SYNC", k)
    g = (pjt.load_graph("grid:rows=30,cols=40,seed=7") if graph == "grid"
         else _hub_graph())
    cap = max_iter or g.num_nodes
    sources = np.arange(0, g.num_nodes, 97)
    b = len(sources)
    want, it_w, imp_w = fs.fanout_fixpoint(
        _dist0(sources, g.num_nodes, b, "cpu"), *_layout(g, "cpu"),
        max_iter=cap,
    )
    before = fs.fanout_fixpoint.host_reads
    got, it, imp = fs.fanout_fixpoint(
        _dist0(sources, g.num_nodes, b, cuda), *_layout(g, cuda),
        max_iter=cap,
    )
    assert torch.equal(got.cpu(), want)
    assert (it, imp) == (it_w, imp_w)
    assert fs.fanout_fixpoint.host_reads - before <= math.ceil(it / k) + 1


def test_fanout_sweep_occupancy(cuda):
    """The items kernel keeps at least 2 blocks resident per SM at every
    pass width, on the float4 and the scalar lane path."""
    for b in (128, 256, 512):
        for vec in (True, False):
            assert fs.occupancy(b, vec=vec)["blocks_per_sm"] >= 2, (b, vec)


def test_fanout_sweep_rejects_bad_inputs(cuda):
    g = pjt.load_graph("rmat:scale=6,ef=4,seed=0")
    indptr_in, src_in, w_in = _layout(g, cuda)
    d = torch.zeros((g.num_nodes, 4), device=cuda)
    with pytest.raises(TypeError):
        fs.fanout_sweep(d.double(), indptr_in, src_in, w_in)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fanout_sweep(torch.zeros((4, g.num_nodes), device=cuda).t(),
                        indptr_in, src_in, w_in)
    with pytest.raises(ValueError, match="is on cpu"):
        fs.fanout_sweep(d, indptr_in.cpu(), src_in, w_in)


# Every branch of minplus_plan: tiles of 16, 32 and 128 rows, one split
# or several, 16-byte and 4-byte copies of a (J % 4), ragged edges.
MINPLUS_SHAPES = [(5, 7, 9), (8, 128, 128), (100, 300, 50), (1, 1, 1),
                  (64, 33, 65), (3, 129, 2), (1000, 777, 513),
                  (1, 1024, 1024), (16, 1024, 1024), (30, 1024, 1024),
                  (64, 1024, 1024), (100, 1024, 1024), (128, 1024, 1024),
                  (511, 1024, 1024), (1024, 1024, 1024), (300, 400, 200)]


@pytest.mark.parametrize("shape", MINPLUS_SHAPES)
def test_minplus_kernel_equals_plain(cuda, shape):
    """Bitwise, with +inf and negative finite entries."""
    i, k, j = shape
    rng = np.random.default_rng(sum(shape))
    d, a = _operands(rng, i, k, j)
    d[(rng.random((i, k)) < 0.2) & np.isfinite(d)] *= -3
    d, a = torch.as_tensor(d).to(cuda), torch.as_tensor(a).to(cuda)
    before = minplus_kernel.launches
    got = minplus_kernel(d, a)
    torch.cuda.synchronize()
    assert minplus_kernel.launches == before + 1
    assert torch.equal(got, minplus_plain(d, a))


def test_minplus_all_inf_rows(cuda):
    d = torch.full((70, 90), float("inf"), device=cuda)
    d[5, 3] = 2.0
    a = torch.rand((90, 130), device=cuda)
    got = minplus_kernel(d, a)
    assert torch.equal(got, minplus_plain(d, a))
    assert torch.isinf(got[torch.arange(70, device=cuda) != 5]).all()


@pytest.mark.parametrize("v", [300, 1024])
def test_minplus_kernel_squaring_aliased(cuda, v):
    """``d is a``, as in min-plus squaring."""
    d, _ = _operands(np.random.default_rng(v), v, v, 1)
    np.fill_diagonal(d, 0.0)
    d = torch.as_tensor(d).to(cuda)
    assert torch.equal(minplus_kernel(d, d), minplus_plain(d, d))


@pytest.mark.parametrize("shape", [(40, 40, 40), (128, 1024, 1024),
                                   (16, 1000, 1000)])
def test_minplus_kernel_flags_on_card(cuda, shape):
    """The improved flag (epilogue at one split, the fold at several)
    equals (out < d).any(), both where entries drop and at a fixpoint;
    a product whose prev flag holds 0 writes nothing."""
    i, k, j = shape
    d, a = _operands(np.random.default_rng(i + k), i, k, j)
    np.fill_diagonal(a, 0.0)
    d, a = torch.as_tensor(d).to(cuda), torch.as_tensor(a).to(cuda)
    eye = torch.full((k, k), float("inf"), device=cuda).fill_diagonal_(0.0)
    for x, y, drops in ((d, a, True), (d, eye, False)):
        flag = torch.zeros(1, dtype=torch.int32, device=cuda)
        got = minplus_kernel(x, y, improved=flag)
        want = minplus_plain(x, y)
        assert torch.equal(got, want)
        assert int(flag.item()) == int(bool((want < x).any())) == int(drops)
    out = torch.full_like(d, 7.0)
    flag = torch.zeros(1, dtype=torch.int32, device=cuda)
    minplus_kernel(d, a, out=out, improved=flag,
                   prev=torch.zeros(1, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and int(flag.item()) == 0


@pytest.mark.parametrize("group", [1, 3, 16])
@pytest.mark.parametrize("cap", [None, 5])
def test_minplus_fixpoint_on_card_equals_cpu(cuda, monkeypatch, group, cap):
    """The grouped fixpoint on the card against the CPU loop of
    ``dense_fanout`` (iterate regime): dist, iterations, flag; host reads
    <= ceil(it / group) + 1."""
    monkeypatch.setattr(mp_mod, "PRODUCTS_PER_SYNC", group)
    g = pjt.load_graph("er:n=600,p=0.01,seed=4")
    sources = np.arange(0, g.num_nodes, 5)  # 120 < V / 2: iterate
    max_iter = cap or g.num_nodes

    def run(device, fixpoint):
        a = relax.dense_adjacency(
            torch.as_tensor(g.src).to(device),
            torch.as_tensor(g.indices).to(device),
            torch.as_tensor(g.weights).to(device), g.num_nodes)
        return relax.dense_fanout(a, torch.as_tensor(sources).to(device),
                                  max_iter=max_iter, mp=minplus_kernel,
                                  fixpoint=fixpoint)

    want, it_w, imp_w = run("cpu", None)
    before = minplus_fixpoint.host_reads
    got, it, imp = run(cuda, minplus_fixpoint)
    assert torch.equal(got.cpu(), want)
    assert (it, imp) == (it_w, imp_w)
    assert minplus_fixpoint.host_reads - before <= -(-it // group) + 1
    assert imp == (cap is not None)


def test_minplus_occupancy(cuda):
    """Each tile kernel keeps the resident blocks per SM that
    ``minplus_plan`` counts on."""
    for rows, blocks in mp_mod.RESIDENT.items():
        assert mp_mod.occupancy(rows) >= blocks, rows


def test_minplus_rejects_bad_inputs(cuda):
    d = torch.zeros((4, 5), device=cuda)
    with pytest.raises(ValueError, match="disagree"):
        minplus_kernel(d, torch.zeros((6, 3), device=cuda))
    with pytest.raises(TypeError):
        minplus_kernel(d.double(), torch.zeros((5, 3), device=cuda).double())
    with pytest.raises(ValueError, match="contiguous"):
        minplus_kernel(torch.zeros((5, 4), device=cuda).t(),
                       torch.zeros((5, 3), device=cuda))


SPECS = ["dag:n=90,p=0.08,neg=0.4,seed=3", "er:n=48,p=0.12,seed=5",
         "grid:rows=9,cols=11,neg=0.2,seed=1", "rmat:scale=8,ef=8,seed=2"]


@pytest.mark.parametrize("spec", SPECS)
def test_solve_on_card_equals_cpu(cuda, spec):
    g = pjt.load_graph(spec)
    want = pjt.ParallelJohnsonSolver(device="cpu").solve(g)
    got = pjt.ParallelJohnsonSolver(device=cuda).solve(g)
    assert got.stats.routes_by_phase == want.stats.routes_by_phase
    np.testing.assert_array_equal(got.matrix, want.matrix)


def _converged(g, b, layout, items):
    """(d, sources): the fan-out fixpoint of ``g`` from ``b`` seeded
    sources over its in-edge ``layout``, column 3 (when B > 3) all
    unreachable, and the zeros of every other row made -0.0 (they tie
    with +0.0)."""
    device = layout[0].device
    sources = np.random.default_rng(b).choice(
        np.flatnonzero(np.diff(g.indptr)), b)  # each with an out-edge
    d0 = _dist0(sources, g.num_nodes, b, device)
    if b > 3:
        d0[:, 3] = float("inf")
    d, _, _ = fs.fanout_fixpoint(d0, *layout, max_iter=g.num_nodes,
                                 items=items)
    odd = torch.arange(g.num_nodes, device=device).unsqueeze(1) % 2 == 1
    d[(d == 0) & odd] = -0.0
    return d, torch.as_tensor(sources, device=device)


def _zero_ties(g):
    w = np.floor(g.weights)
    w[np.random.default_rng(1).random(w.shape[0]) < 0.3] = 0.0
    return g.with_weights(w.astype(np.float32))


PRED_GRAPHS = {
    "hub": lambda: _zero_ties(_hub_graph()),
    "rmat12": lambda: _zero_ties(SWEEP_GRAPHS["rmat12"]()),
    "grid": lambda: _zero_ties(pjt.load_graph("grid:rows=30,cols=40,seed=7")),
}


def _coo(g, device):
    e = g.num_real_edges
    return [torch.as_tensor(x[:e]).to(device)
            for x in (g.src, g.indices, g.weights)]


@pytest.mark.parametrize("graph", sorted(PRED_GRAPHS))
@pytest.mark.parametrize("b", [1, 5, 128, 200, 256, 512, 700, 1024])
def test_tight_pred_kernel_equals_plain(cuda, b, graph):
    """The tight_pred kernel against the plain COO pass on converged
    distances with zero-weight ties, -0.0 against +0.0, an unreachable
    column; B = 1 / 5 take the scalar lane path, 128 one pass of one
    float4 per lane, 200 / 256 one pass of two (200 ragged), 512, 700
    and 1024 two to four 256-column passes; the hub graph splits rows
    into pieces."""
    g = PRED_GRAPHS[graph]()
    layout = _layout(g, cuda)
    items = fs.build_work_items(layout[0])
    if graph == "hub":
        assert items.n_split >= 5 + 2
    d, _ = _converged(g, b, layout, items)
    before = pred_mod.tight_pred_pass.launches
    got = pred_mod.tight_pred_pass(d, *layout, items=items)
    torch.cuda.synchronize()
    assert pred_mod.tight_pred_pass.launches == before + 1
    want = pred_mod.tight_pred_pass_plain(d.t().contiguous(),
                                          *_coo(g, cuda)).t()
    assert torch.equal(got, want)
    assert bool((got >= 0).any())


@pytest.mark.parametrize("graph", sorted(PRED_GRAPHS) + ["hub-pos",
                                                         "rmat12-pos"])
@pytest.mark.parametrize("b", [5, 128, 256, 700, 1024])
def test_tight_pred_flags_equal_plain(cuda, b, graph):
    """With ``sources``, the kernel's source mask and its two flags equal
    ``tree_flags_plain`` on the plain pass. The zero-tie graphs raise
    nondescending; weights in [1, 10) (``-pos``) raise neither flag; the
    unreachable column 3 raises no uncovered."""
    g = (PRED_GRAPHS[graph]() if graph in PRED_GRAPHS
         else _hub_graph() if graph == "hub-pos"
         else SWEEP_GRAPHS["rmat12"]())
    layout = _layout(g, cuda)
    items = fs.build_work_items(layout[0])
    d, sources = _converged(g, b, layout, items)
    before = pred_mod.tight_pred_pass.launches
    got, flags = pred_mod.tight_pred_pass(d, *layout, items=items,
                                          sources=sources)
    torch.cuda.synchronize()
    assert pred_mod.tight_pred_pass.launches == before + 1
    dt = d.t().contiguous()
    want, want_flags = pred_mod.tree_flags_plain(
        pred_mod.tight_pred_pass_plain(dt, *_coo(g, cuda)), dt, sources)
    assert torch.equal(got.t(), want)
    assert flags.tolist() == want_flags.tolist()
    assert flags.tolist() == ([0, 0] if graph.endswith("-pos") else [0, 1])
    pred, ok = pred_mod.certify_pred(got.t().contiguous(), dt, sources,
                                     flags=flags)
    ref_pred, ref_ok = pred_mod.certify_pred(
        pred_mod.tight_pred_pass_plain(dt, *_coo(g, cuda)), dt, sources)
    assert torch.equal(pred, ref_pred) and bool(ok) == bool(ref_ok)


def test_tight_pred_rejects_bad_inputs(cuda):
    g = pjt.load_graph("rmat:scale=6,ef=4,seed=0")
    layout = _layout(g, cuda)
    d = torch.zeros((g.num_nodes, 4), device=cuda)
    with pytest.raises(TypeError):
        pred_mod.tight_pred_pass(d.double(), *layout)
    with pytest.raises(ValueError, match="contiguous"):
        pred_mod.tight_pred_pass(
            torch.zeros((4, g.num_nodes), device=cuda).t(), *layout)
    with pytest.raises(ValueError, match="layout does not fit"):
        pred_mod.tight_pred_pass(d[:-1], *layout)


@pytest.mark.parametrize("spec", ["rmat:scale=14,ef=8,seed=3",
                                  "grid:rows=60,cols=70,neg=0.2,seed=2"])
def test_pred_solve_on_card_equals_cpu(cuda, spec):
    """``solve(predecessors=True)`` on pallas-vm: the card's rows and
    trees equal the CPU's bitwise (the kernel against the plain pass
    inside the solver)."""
    g = pjt.load_graph(spec)
    sources = np.arange(0, g.num_nodes, g.num_nodes // 96)[:96]
    want = pjt.ParallelJohnsonSolver(device="cpu").solve(
        g, sources, predecessors=True)
    before = pred_mod.tight_pred_pass.launches
    got = pjt.ParallelJohnsonSolver(device=cuda).solve(
        g, sources, predecessors=True)
    assert pred_mod.tight_pred_pass.launches > before
    assert got.stats.routes_by_phase["fanout"] == "pallas-vm+pred"
    assert got.stats.routes_by_phase == want.stats.routes_by_phase
    np.testing.assert_array_equal(johnson.to_numpy(got.dist),
                                  johnson.to_numpy(want.dist))
    np.testing.assert_array_equal(johnson.to_numpy(got.predecessors),
                                  johnson.to_numpy(want.predecessors))
    validate_pred_tree(g, johnson.to_numpy(got.dist),
                       johnson.to_numpy(got.predecessors), sources)


def test_vm_blocked_on_card_equals_pallas_vm(cuda, monkeypatch):
    """use_pallas=False on a graph above VM_BLOCK (lowered here) runs
    vm-blocked in plain torch ops on the card: rows bitwise equal to the
    hand sweep's, trees equal to pallas-vm+pred's."""
    monkeypatch.setattr(torch_backend, "VM_BLOCK", 1024)
    g = pjt.load_graph("grid:rows=60,cols=70,neg=0.2,seed=2")
    sources = np.arange(0, g.num_nodes, 53)
    hand = pjt.ParallelJohnsonSolver(device=cuda).solve(
        g, sources, predecessors=True)
    xla = pjt.ParallelJohnsonSolver(pjt.SolverConfig(use_pallas=False),
                                    device=cuda).solve(
        g, sources, predecessors=True)
    assert xla.stats.routes_by_phase["fanout"] == "vm-blocked+pred"
    np.testing.assert_array_equal(johnson.to_numpy(xla.dist),
                                  johnson.to_numpy(hand.dist))
    np.testing.assert_array_equal(johnson.to_numpy(xla.predecessors),
                                  johnson.to_numpy(hand.predecessors))


@pytest.mark.parametrize("spec,kw,route", [
    (SPECS[3], {"use_pallas": False}, "vm"),
    (SPECS[3], {"fanout_layout": "source_major"}, "sweep-sm"),
    (SPECS[1], {"use_pallas": False}, "dense-squaring"),
])
def test_xla_routes_on_card_equal_cpu(cuda, spec, kw, route):
    g = pjt.load_graph(spec)
    cfg = pjt.SolverConfig(**kw)
    want = pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(g)
    got = pjt.ParallelJohnsonSolver(cfg, device=cuda).solve(g)
    assert got.stats.routes_by_phase["fanout"] == route
    assert got.stats.iterations_by_phase == want.stats.iterations_by_phase
    np.testing.assert_array_equal(got.matrix, want.matrix)


B1_ROUTES = {"frontier": {"frontier": True}, "dia": {"dia": True},
             "gs": {"gauss_seidel": True}, "bucket": {"bucket": True}}


@pytest.mark.parametrize("spec", ["rmat:scale=16,ef=8,seed=2",
                                  "grid:rows=128,cols=128,neg=0.2,seed=5"])
@pytest.mark.parametrize("route", sorted(B1_ROUTES))
def test_b1_route_on_card_equals_sweep(cuda, spec, route):
    """Each forced B=1 route's ``sssp`` on the card: the row bitwise
    equal to ``sweep``'s on the card, and the route's counters equal to
    its own run on the CPU. R-MAT's labeling is not diagonal, so ``dia``
    falls through to ``sweep`` there."""
    g = pjt.load_graph(spec)
    sweep = pjt.ParallelJohnsonSolver(pjt.SolverConfig(frontier=False),
                                      device=cuda).sssp(g, 0)
    cfg = pjt.SolverConfig(**B1_ROUTES[route])
    got = pjt.ParallelJohnsonSolver(cfg, device=cuda).sssp(g, 0)
    cpu = pjt.ParallelJohnsonSolver(cfg, device="cpu").sssp(g, 0)
    want = "sweep" if route == "dia" and spec.startswith("rmat") else route
    assert got.stats.routes_by_phase["bellman_ford"] == want
    np.testing.assert_array_equal(johnson.to_numpy(got.dist),
                                  johnson.to_numpy(sweep.dist))
    assert got.stats.iterations_by_phase == cpu.stats.iterations_by_phase
    assert got.stats.edges_relaxed == cpu.stats.edges_relaxed


def test_staged_download_equals_blocking_copy(cuda):
    """``stage_rows_async`` then ``_download_rows`` gives the rows
    ``.cpu()`` gives, also when the tensor is dropped and its block asked
    for again before the copy is collected (``record_stream``)."""
    backend = pjt.get_backend("torch", pjt.SolverConfig(), device=cuda)
    solver = pjt.ParallelJohnsonSolver(backend=backend)
    dgraph = backend.upload(pjt.load_graph(SPECS[1]))
    x = torch.rand((256, 40000), device=cuda)
    x[::7, ::3] = float("inf")
    want = x.cpu().numpy()
    backend.stage_rows_async(x)
    staged = x.staged_copy
    assert staged.host.is_pinned()
    got, no_pred = solver._download_rows(dgraph, x)
    np.testing.assert_array_equal(got, want)
    assert no_pred is None
    y = x * 2
    want_y = y.cpu().numpy()
    backend.stage_rows_async(y)
    staged = y.staged_copy
    del y
    torch.full((256, 40000), 7.0, device=cuda)  # may reuse y's block
    np.testing.assert_array_equal(staged.wait(), want_y)
    backend.stage_rows_async(x)  # already staged: a no-op
    assert x.staged_copy is not None


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("spec", ["rmat:scale=14,ef=8,seed=3",
                                  "grid:rows=60,cols=70,neg=0.2,seed=2"])
def test_pipelined_solve_on_card_equals_serial(cuda, monkeypatch, spec, depth):
    """A 3-batch solve at depth 2 and 3 equals the serial one and the
    single-batch one bitwise, with the layout cleared before every
    download (threshold 0), so each batch rebuilds it."""
    monkeypatch.setattr(johnson, "_DOWNLOAD_CLEAR_MIN_BYTES", 0)
    g = pjt.load_graph(spec)
    sources = np.arange(0, g.num_nodes, g.num_nodes // 384)[:384]

    def run(**kw):
        return pjt.ParallelJohnsonSolver(pjt.SolverConfig(**kw),
                                         device=cuda).solve(g, sources)

    one = run()
    serial = run(source_batch_size=128, pipeline_depth=1)
    piped = run(source_batch_size=128, pipeline_depth=depth)
    assert isinstance(piped.dist, np.ndarray)
    np.testing.assert_array_equal(piped.dist, serial.dist)
    np.testing.assert_array_equal(piped.dist, johnson.to_numpy(one.dist))
    assert piped.stats.final_pipeline_depth == depth


def test_pipelined_pred_solve_on_card_equals_serial(cuda, monkeypatch):
    """Pred blocks ride the pipeline: staged beside the rows, the trees
    of a 3-batch solve at depth 2 equal the serial and single-batch
    ones."""
    monkeypatch.setattr(johnson, "_DOWNLOAD_CLEAR_MIN_BYTES", 0)
    g = pjt.load_graph("grid:rows=60,cols=70,neg=0.2,seed=2")
    sources = np.arange(0, g.num_nodes, 11)[:384]

    def run(**kw):
        return pjt.ParallelJohnsonSolver(pjt.SolverConfig(**kw),
                                         device=cuda).solve(
            g, sources, predecessors=True)

    one = run()
    serial = run(source_batch_size=128, pipeline_depth=1)
    piped = run(source_batch_size=128, pipeline_depth=2)
    for name in ("dist", "predecessors"):
        np.testing.assert_array_equal(getattr(piped, name),
                                      getattr(serial, name))
        np.testing.assert_array_equal(getattr(piped, name),
                                      johnson.to_numpy(getattr(one, name)))


def test_checkpointed_solve_on_card_resumes(cuda, tmp_path):
    g = pjt.load_graph(SPECS[2])
    cfg = pjt.SolverConfig(source_batch_size=32, checkpoint_dir=str(tmp_path))
    first = pjt.ParallelJohnsonSolver(cfg, device=cuda).solve(g)
    again = pjt.ParallelJohnsonSolver(cfg, device=cuda).solve(g)
    assert again.stats.batches_resumed == -(-g.num_nodes // 32)
    np.testing.assert_array_equal(again.dist, first.dist)
    want = pjt.ParallelJohnsonSolver(device="cpu").solve(g)
    np.testing.assert_array_equal(first.dist, johnson.to_numpy(want.dist))


def test_real_cuda_oom_is_classified(cuda):
    total = torch.cuda.get_device_properties(cuda).total_memory
    with pytest.raises(torch.OutOfMemoryError) as info:
        torch.empty(2 * total, dtype=torch.uint8, device=cuda)
    assert is_oom_error(info.value)


# -- dense APSP: blocked Floyd-Warshall, condensed, batch_apsp -----------------


def fw_tile_matrix(t, seed, *, negative_diagonal=False):
    """f32 [t, t], +inf holes, 0 diagonal, w + p(i) - p(j) (negative
    entries, no negative cycle); or a negative 2-cycle on the last two
    vertices on top (a negative diagonal in the last two steps, no
    overflow)."""
    rng = np.random.default_rng(seed)
    p = rng.random(t) * 4
    m = (rng.random((t, t)) * 10 + p[:, None] - p[None, :]).astype(np.float32)
    m[rng.random((t, t)) < 0.8] = np.inf
    np.fill_diagonal(m, 0.0)
    if negative_diagonal:
        m[t - 2, t - 1], m[t - 1, t - 2] = np.float32(-1.5), np.float32(0.25)
    return m


@pytest.mark.parametrize("negative_diagonal", [False, True])
@pytest.mark.parametrize("t", [128, 200, 256, 384, 512, 1024])
def test_fw_kleene_on_card_equals_plain(cuda, t, negative_diagonal):
    """Bitwise against ``tile_kleene`` on the variant ``kleene_plan``
    names (one cluster launch up to t = 512, 200 with a ragged last
    warp; the step kernel at 1024), one launch count per closure; also
    in place on a diagonal tile of a larger matrix (row stride)."""
    from paralleljohnson_tpu_torch.ops import fw

    assert fw.kleene_plan(t).variant == ("cluster" if t <= 512 else "step")
    m = torch.as_tensor(fw_tile_matrix(t, t, negative_diagonal=negative_diagonal))
    want = fw.tile_kleene(m)
    before = fw.fw_kleene.launches
    got = fw.fw_kleene(m.to(cuda))
    torch.cuda.synchronize()
    assert fw.fw_kleene.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert bool((torch.diagonal(want) < 0).any()) == negative_diagonal
    big = torch.full((t + 64, t + 64), 7.0, device=cuda)
    tile = big[32:32 + t, 16:16 + t]
    tile.copy_(m)
    fw.fw_kleene(tile, out=tile)
    torch.cuda.synchronize()
    assert fw.fw_kleene.launches == before + 2
    assert torch.equal(tile.cpu(), want)
    rest = big.clone()
    rest[32:32 + t, 16:16 + t] = 7.0
    assert bool((rest == 7.0).all())


@pytest.mark.parametrize("n,tile", [(256, 128), (384, 128), (700, 512)])
def test_fw_apsp_blocked_on_card_equals_cpu(cuda, n, tile):
    from paralleljohnson_tpu_torch.ops import fw

    a = fw.pad_dense(torch.as_tensor(fw_tile_matrix(n, n)), tile)
    want, want_neg = fw.fw_closure(a, tile=tile)
    got, neg = fw.fw_closure(a.to(cuda), tile=tile)
    assert neg == want_neg is False
    assert torch.equal(got.cpu(), want)


def test_fw_route_on_card_equals_cpu(cuda):
    """The default config takes ``fw-tile`` on a dense ER (three 512
    tiles) on both devices, bitwise, with the Kleene and min-plus kernels
    launched; predecessors ride it."""
    from paralleljohnson_tpu_torch.ops import fw

    g = pjt.load_graph("er:n=1100,p=0.1,seed=3")
    want = pjt.ParallelJohnsonSolver(device="cpu").solve(g)
    before = (fw.fw_kleene.launches, minplus_kernel.launches)
    got = pjt.ParallelJohnsonSolver(device=cuda).solve(g, predecessors=True)
    assert got.stats.routes_by_phase["fanout"] == "fw-tile+pred"
    assert want.stats.routes_by_phase["fanout"] == "fw-tile"
    assert fw.fw_kleene.launches - before[0] == 3
    assert minplus_kernel.launches > before[1]
    np.testing.assert_array_equal(got.matrix, want.matrix)
    validate_pred_tree(g, johnson.to_numpy(got.dist),
                       johnson.to_numpy(got.predecessors), got.sources)


def test_condensed_on_card_equals_cpu(cuda):
    g = pjt.load_graph("grid:rows=24,cols=24,neg=0.2,seed=3")
    cfg = pjt.SolverConfig(partitioned=True)
    want = pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(g)
    got = pjt.ParallelJohnsonSolver(cfg, device=cuda).solve(g)
    assert got.stats.routes_by_phase["fanout"] == "condensed+fw"
    np.testing.assert_array_equal(got.matrix, want.matrix)


@pytest.mark.parametrize("negative", [False, True])
def test_batch_apsp_on_card_equals_cpu(cuda, negative):
    """32 graphs through the hand sweep over their disjoint union against
    the plain union on the CPU: bitwise, same sweep count."""
    graphs = [pjt.load_graph(f"er:n={24 + i},p=0.15,seed={i}")
              for i in range(32)]
    if negative:
        graphs[5] = pjt.load_graph("dag:n=40,p=0.2,neg=0.4,seed=5")
    want = pjt.ParallelJohnsonSolver(device="cpu").solve_batch(graphs)
    before = fs.fanout_sweep.launches
    got = pjt.ParallelJohnsonSolver(device=cuda).solve_batch(graphs)
    assert fs.fanout_sweep.launches > before
    assert got[0].stats.routes_by_phase == {"batch_apsp": "batch-vmapped"}
    assert (got[0].stats.iterations_by_phase
            == want[0].stats.iterations_by_phase)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(johnson.to_numpy(a.dist),
                                      johnson.to_numpy(b.dist))


def _scrambled_grid(rows):
    from paralleljohnson_tpu_torch.graphs import grid2d, permute_labels

    return permute_labels(grid2d(rows, rows, negative_fraction=0.0, seed=7),
                          seed=11)


def test_forced_dirty_window_on_card_equals_pallas_vm(cuda):
    """The dirty-window fan-out (plain torch on the card) against the hand
    sweep on the 48-row scrambled grid: rows bitwise, exact route tags."""
    g = _scrambled_grid(48)
    sources = np.sort(np.random.default_rng(0).choice(g.num_nodes, 16,
                                                      replace=False))
    dw = pjt.ParallelJohnsonSolver(pjt.SolverConfig(dirty_window=True),
                                   device=cuda).solve(g, sources)
    before = fs.fanout_sweep.launches
    hand = pjt.ParallelJohnsonSolver(device=cuda).solve(g, sources)
    assert fs.fanout_sweep.launches > before
    assert dw.stats.routes_by_phase == {"fanout": "vm-blocked+dw"}
    assert hand.stats.routes_by_phase == {"fanout": "pallas-vm"}
    np.testing.assert_array_equal(johnson.to_numpy(dw.dist),
                                  johnson.to_numpy(hand.dist))


def test_solve_with_profile_store_on_card_writes_cuda_records(cuda, tmp_path):
    """A solve with a profile store on the card: plan, solve and (the
    instrumented ``vm`` route) trajectory records, each with platform
    ``cuda`` and the card's name; the sweep priced by the analytic model."""
    from paralleljohnson_tpu_torch.observe import ProfileStore

    g = _scrambled_grid(48)
    cfg = pjt.SolverConfig(profile_store=str(tmp_path), use_pallas=False)
    res = pjt.ParallelJohnsonSolver(cfg, device=cuda).solve(g, np.arange(8))
    assert res.stats.routes_by_phase == {"fanout": "vm"}
    records = ProfileStore(tmp_path).records()
    assert [r["kind"] for r in records] == ["plan", "solve", "trajectory"]
    for rec in records:
        assert rec["platform"] == "cuda"
        assert rec["device"]["name"] == torch.cuda.get_device_name(0)
    assert records[1]["cost"]["cost_sources"] == ["analytic-model"]
    assert res.stats.roofline["platform"] == "cuda"


def test_cpp_backend_rows_equal_torch_backend_on_card(cuda):
    """The C++/OpenMP baseline and the card's backend solve R-MAT-12 to
    the same rows, bitwise on integer weights (every path sum exact in
    f32)."""
    g = pjt.load_graph("rmat:scale=12,ef=16,seed=4")
    rng = np.random.default_rng(4)
    g = g.with_weights(rng.integers(1, 10, g.num_real_edges).astype(np.float32))
    sources = np.sort(rng.choice(g.num_nodes, 64, replace=False))
    card = pjt.ParallelJohnsonSolver(device=cuda).solve(g, sources)
    cpp = pjt.ParallelJohnsonSolver(pjt.SolverConfig(backend="cpp")).solve(
        g, sources)
    assert card.stats.routes_by_phase == {"fanout": "pallas-vm"}
    np.testing.assert_array_equal(johnson.to_numpy(card.dist), cpp.dist)


@pytest.mark.parametrize("config", [
    "er1k_apsp", "dimacs_ny_bf", "dimacs_ny_scrambled",
    "dimacs_ny_scrambled_pred", "ego_fb_nsource", "rmat_apsp",
    "rmat_apsp_pipelined", "batch_small", "dense_apsp_fw", "dirty_window",
    "planner_dispatch", "planner_tuning", "distributed_fleet",
    "incremental_update", "serve_queries", "approx_apsp",
])
def test_bench_config_smoke_on_card(cuda, config, tmp_path):
    """Every config of the port's bench harness at the smoke preset on the
    card: no ``failed`` (the harness's own bitwise and planner checks), a
    ``cuda`` row with the card's name, and a flight file whose Chrome
    trace validates."""
    import json

    from paralleljohnson_tpu_torch import benchmarks
    from paralleljohnson_tpu_torch.utils.telemetry import validate_chrome_trace

    (rec,) = benchmarks.run([config], preset="smoke", device=cuda,
                            telemetry_dir=str(tmp_path))
    assert "failed" not in rec.detail, rec.detail
    assert rec.detail["platform"] == "cuda"
    assert rec.detail["device"]["name"] == torch.cuda.get_device_name(0)
    validate_chrome_trace(json.loads(
        (tmp_path / f"trace-{config}.json").read_text()))


def test_heartbeat_device_memory_only_once_cuda_is_initialised(cuda, tmp_path):
    """In a fresh process the heartbeat carries no ``device_memory`` (and
    does not initialise CUDA itself); once the process holds a tensor on
    the card it reports bytes in use, peak and limit."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    script = (
        "import json, torch\n"
        "from paralleljohnson_tpu_torch.utils.telemetry import "
        "HeartbeatReporter\n"
        f"hb = HeartbeatReporter({str(tmp_path / 'hb.json')!r})\n"
        "before = hb.payload()['device_memory']\n"
        "inited = torch.cuda.is_initialized()\n"
        "x = torch.ones(1 << 20, device='cuda')\n"
        "after = hb.payload()['device_memory']\n"
        "print(json.dumps([before, inited, after]))\n"
    )
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    before, inited, after = json.loads(out.stdout.strip().splitlines()[-1])
    assert before is None and inited is False
    stats = after["0"]
    assert stats["bytes_in_use"] >= 4 << 20
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory


def test_in_process_fleet_on_card_equals_solve(cuda, tmp_path):
    """Two in-process fleet workers on the card: every lease committed
    through the sparse fan-out kernel, merged rows bitwise equal to one
    ``solve()`` on the card."""
    from paralleljohnson_tpu_torch import distributed
    from paralleljohnson_tpu_torch.distributed.launch import (
        run_in_process_fleet,
    )

    spec = "er:n=1024,p=0.004,seed=13"
    coord = distributed.plan_fleet(tmp_path / "coord", spec, n_workers=2,
                                   config={"source_batch_size": 64})
    before = fs.fanout_sweep.launches
    report = run_in_process_fleet(coord, 2, device=cuda)
    assert report.ok and set(report.worker_rcs.values()) == {0}
    assert fs.fanout_sweep.launches > before
    g = pjt.load_graph(spec)
    mat = pjt.ParallelJohnsonSolver(pjt.SolverConfig(source_batch_size=64),
                                    device=cuda).solve(g).matrix
    rows = distributed.fleet_rows(coord.dir)
    assert sorted(rows) == list(range(g.num_nodes))
    for s, row in rows.items():
        np.testing.assert_array_equal(row, mat[s], err_msg=f"row {s}")


def test_repair_on_card_equals_fresh_solve(cuda, tmp_path):
    """A checkpoint of an integer-weight lattice repaired on the card
    after a 4-edge update inside one part: closures through the card's
    kernels, repaired rows bitwise equal to a fresh ``solve()`` of the
    updated graph on the card, fewer dirty parts than parts."""
    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.incremental import (
        IncrementalState, repair_checkpoint,
    )
    from paralleljohnson_tpu_torch.utils.checkpoint import (
        BatchCheckpointer, graph_digest,
    )

    g = grid2d(24, 24, seed=17)
    g = g.with_weights(np.maximum(1.0, np.rint(g.weights)).astype(np.float32))
    cfg = pjt.SolverConfig(checkpoint_dir=str(tmp_path), source_batch_size=64)
    pjt.ParallelJohnsonSolver(cfg, device=cuda).solve(g)
    state = IncrementalState.build(g, config=cfg, device=cuda)
    state.save(BatchCheckpointer(tmp_path, graph_key=graph_digest(g)).dir)
    target = int(np.bincount(state.labels).argmax())
    e = g.num_real_edges
    within = np.flatnonzero((state.labels[g.src[:e]] == target)
                            & (state.labels[g.indices[:e]] == target))
    idx = np.random.default_rng(5).choice(within, 4, replace=False)
    updates = [(int(g.src[i]), int(g.indices[i]),
                1.0 if j % 2 == 0 else float(g.weights[i]) + 3.0)
               for j, i in enumerate(idx)]
    before = fs.fanout_sweep.launches
    result = repair_checkpoint(tmp_path, g, updates, config=cfg,
                               state=state, device=cuda)
    assert fs.fanout_sweep.launches > before
    assert result.dirty_parts_closed < result.parts_total
    new_g, _ = g.apply_edge_updates(updates)
    fresh = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(source_batch_size=64), device=cuda).solve(new_g)
    mat = fresh.matrix
    ck = BatchCheckpointer(tmp_path, graph_key=graph_digest(new_g))
    man = ck.manifest()
    assert len(man) == g.num_nodes
    for fn in sorted({f for _b, f in man.values()}):
        srcs = ck.batch_sources(fn)
        rows, _ = ck.load(int(man[int(srcs[0])][0]), srcs)
        for i, s in enumerate(srcs):
            np.testing.assert_array_equal(rows[i], mat[int(s)])


# -- the serving tier and the approximate tier -------------------------------


def _lookup_world(rng, v=300, k=4):
    """A landmark index with +inf rows and negative finite entries (a
    graph with a sink component and negative DAG weights), and a host
    tile of f32 rows with +inf entries."""
    from paralleljohnson_tpu_torch.graphs import random_dag
    from paralleljohnson_tpu_torch.serve import LandmarkIndex

    g = random_dag(v, 0.02, negative_fraction=0.3, seed=int(rng.integers(99)))
    lm = LandmarkIndex.build(g, k, device="cpu", seed=1)
    assert np.isinf(lm.fwd).any() and (lm.fwd[np.isfinite(lm.fwd)] < 0).any()
    tile = rng.random((16, v)).astype(np.float32) * 50 - 10
    tile[rng.random((16, v)) < 0.3] = np.inf
    return g, lm, tile


def test_device_query_functions_on_card_equal_host(cuda):
    """``DeviceQueryPath``'s four functions on the card, byte for byte
    against the numpy host path: tile gathers (pairs and rows) and the raw
    f64 landmark bounds (pairs and full rows)."""
    from paralleljohnson_tpu_torch.serve import TileStore, device_query

    rng = np.random.default_rng(3)
    g, lm, tile = _lookup_world(rng)
    v = g.num_nodes
    store = TileStore(None, g, hot_rows=16)
    store.put(np.arange(16), torch.as_tensor(tile).to(cuda))
    path = device_query.DeviceQueryPath(store, lm, device=cuda)
    slots = path.refresh()
    assert path.f64_supported() and path.landmark_device_ok()
    s = rng.integers(0, 16, 500)
    t = rng.integers(0, v, 500)
    pairs = path.exact_pairs([slots[int(x)] for x in s], t)
    assert pairs.tobytes() == tile[s, t].tobytes()
    rows = path.exact_rows([slots[int(x)] for x in s[:9]])
    assert rows.tobytes() == tile[s[:9]].tobytes()
    lo, up = path.landmark_pairs(s * 7 % v, t)
    for i, (a, b) in enumerate(zip(s * 7 % v, t)):
        lo_h, up_h = lm.raw_bounds_row(int(a), np.asarray([int(b)]))
        assert lo[i].tobytes() == lo_h[0].tobytes()
        assert up[i].tobytes() == up_h[0].tobytes()
    src = rng.integers(0, v, 11)
    lo_r, up_r = path.landmark_rows(src)
    for i, a in enumerate(src):
        lo_h, up_h = lm.raw_bounds_row(int(a), None)
        assert lo_r[i].tobytes() == lo_h.tobytes()
        assert up_r[i].tobytes() == up_h.tobytes()


def test_query_engine_on_card_answers_as_on_cpu(cuda, tmp_path):
    """One engine on the card and one on the CPU over the same integer
    graph and mix: exact and landmark answers equal, host-forced and
    device-forced alike; the device path ran on the card."""
    import json

    from paralleljohnson_tpu_torch.graphs import erdos_renyi
    from paralleljohnson_tpu_torch.serve import (
        LandmarkIndex, QueryEngine, TileStore,
    )

    g = erdos_renyi(400, 0.02, seed=5)
    g = g.with_weights(np.maximum(1.0, np.rint(g.weights)).astype(np.float32))
    rng = np.random.default_rng(8)
    reqs = []
    for i in range(64):
        s = int(rng.integers(0, 400))
        reqs.append({"id": i, "source": s,
                     "dst": [int(d) for d in rng.integers(0, 400, 4)],
                     "mode": "exact" if s < 200 else "approx"})
    outs = []
    for dev in ("cpu", cuda):
        lm = LandmarkIndex.build(g, 6, device=dev, seed=2)
        for mode in ("off", "on"):
            engine = QueryEngine(g, TileStore(tmp_path / f"{dev}{mode}", g,
                                              hot_rows=256),
                                 landmarks=lm, device=dev,
                                 device_lookup=mode, stats_interval_s=0)
            engine.warm(range(200))
            outs.append(json.dumps(engine.query_batch(reqs), sort_keys=True))
            if mode == "on" and dev != "cpu":
                assert engine.stats.device_lookups == 64
                assert "f64 on the device" in \
                    engine.last_lookup_decision["reason"]
            engine.close()
    assert len(set(outs)) == 1


def test_query_engine_auto_raises_a_card_fault(cuda, tmp_path, monkeypatch):
    """On the card, ``device_lookup="auto"`` (the default) re-raises a
    fault of the device path: the host walk never answers in its
    place."""
    from paralleljohnson_tpu_torch.graphs import erdos_renyi
    from paralleljohnson_tpu_torch.serve import (
        QueryEngine, TileStore, device_query,
    )

    def boom(self):
        raise RuntimeError("injected device fault")

    g = erdos_renyi(64, 0.1, seed=3)
    engine = QueryEngine(g, TileStore(tmp_path, g, hot_rows=64),
                         device=cuda, stats_interval_s=0)
    engine.warm(range(16))
    monkeypatch.setattr(device_query.DeviceQueryPath, "refresh", boom)
    with pytest.raises(RuntimeError, match="injected device fault"):
        engine.query_batch([{"source": 1, "dst": 2}])
    engine.close()


@pytest.mark.parametrize("edge_chunk", [1 << 20, 4096])
def test_bounded_hop_rows_on_card_equal_plain(cuda, edge_chunk):
    """A multi-chunk ``bounded_hop_rows`` on the card (one hand-sweep
    launch per chunk, chained) against the plain chunk-level Gauss-Seidel
    sweep in torch ops on the card (``relax.bellman_ford_sweeps_vm`` over
    the edges in stable destination order), and against the CPU."""
    from paralleljohnson_tpu_torch.ops import hopset as hs

    g = pjt.load_graph("rmat:scale=12,ef=8,seed=4")
    sources = np.array([0, 7, 100, 2000])
    before = fs.fanout_sweep.launches
    rows, iters, conv, ex = hs.bounded_hop_rows(
        g, sources, beta=6, edge_chunk=edge_chunk, device=cuda)
    e = g.num_real_edges
    assert fs.fanout_sweep.launches - before >= iters * -(-e // edge_chunk)
    order = np.argsort(g.indices[:e], kind="stable")
    src, dst, w = (torch.as_tensor(np.asarray(a[:e])[order]).to(cuda)
                   for a in (g.src, g.indices, g.weights))
    d0 = torch.full((g.num_nodes, len(sources)), np.inf, device=cuda)
    d0[torch.as_tensor(sources, device=cuda),
       torch.arange(len(sources), device=cuda)] = 0.0
    plain, p_iters, p_imp = relax.bellman_ford_sweeps_vm(
        d0, src, dst, w, max_iter=6, edge_chunk=edge_chunk)
    assert rows.tobytes() == johnson.to_numpy(plain.T).tobytes()
    assert (iters, conv) == (p_iters, not p_imp)
    cpu = hs.bounded_hop_rows(g, sources, beta=6, edge_chunk=edge_chunk,
                              device="cpu")
    assert rows.tobytes() == cpu[0].tobytes()
    assert (iters, conv, ex) == cpu[1:]


def test_approx_apsp_on_card_equals_cpu(cuda):
    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.solver import approx

    g = grid2d(256, 8, seed=23)
    src = np.arange(0, 2048, 97)
    card = approx.approx_apsp(g, src, epsilon=0.5, device=cuda)
    cpu = approx.approx_apsp(g, src, epsilon=0.5, device="cpu")
    assert card.dist.tobytes() == cpu.dist.tobytes()
    assert card.max_error.tobytes() == cpu.max_error.tobytes()


def test_query_engine_default_raises_without_card(monkeypatch, tmp_path):
    """``QueryEngine(device="cuda")``, the default, raises
    ``RuntimeError`` where there is no card: it never serves from the
    host in its place. (Runs with or without a card.)"""
    from paralleljohnson_tpu_torch.graphs import erdos_renyi
    from paralleljohnson_tpu_torch.serve import QueryEngine, TileStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = erdos_renyi(16, 0.2, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        QueryEngine(g, TileStore(tmp_path, g))


# -- the command line on the card ----------------------------------------------


def _cli(*args, **kw):
    """``python -m paralleljohnson_tpu_torch *args`` from the repository
    root, no ``--device`` flag: the card is the default."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(root), env.get("PYTHONPATH")) if p)
    return subprocess.Popen([sys.executable, "-m", "paralleljohnson_tpu_torch",
                             *args], cwd=root, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            **kw)


def test_cli_solve_on_card_equals_solve(cuda, tmp_path):
    """A ``solve --output`` process on the card gives the in-process
    ``solve()``'s matrix bitwise, and its ``--log-stats`` line shows the
    process launched a hand kernel."""
    import json

    spec = "er:n=256,p=0.1,seed=0"
    p = _cli("solve", spec, "--output", str(tmp_path / "d.npz"), "--json",
             "--log-stats")
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0, err
    stats = json.loads(err.strip().splitlines()[-1])
    assert sum(stats["kernel_launches"].values()) > 0
    res = pjt.ParallelJohnsonSolver().solve(pjt.load_graph(spec))
    assert json.loads(out)["routes_by_phase"] == res.stats.routes_by_phase
    with np.load(tmp_path / "d.npz") as z:
        assert z["dist"].tobytes() == johnson.to_numpy(res.dist).tobytes()


def test_cli_info_lists_the_card(cuda):
    import json

    p = _cli("info", "--json")
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err
    info = json.loads(out)
    assert info["cuda_available"] is True
    assert info["default_backend_platform"] == "cuda"
    assert info["devices"][0]["device"] == "cuda:0"
    assert info["devices"][0]["name"] == torch.cuda.get_device_name(0)
    assert info["devices"][0]["power_limit"].endswith("W")


def test_cli_serve_listen_answers_and_drains(cuda, tmp_path):
    """``serve --listen`` on the card answers one query with ``solve()``'s
    distance and drains on SIGTERM with exit 0 (the engine closed on the
    way out, else its stats thread would hold the process)."""
    import json
    import signal
    import socket

    spec = "grid:rows=32,cols=32"
    p = _cli("serve", spec, "--listen", "127.0.0.1:0", "--store-dir",
             str(tmp_path / "store"), "--shed-policy", "reject",
             "--stats-interval", "0.2")
    try:
        ann = json.loads(p.stdout.readline())
        with socket.create_connection((ann["host"], ann["port"]),
                                      timeout=120) as s:
            f = s.makefile("rw", encoding="utf-8", newline="\n")
            json.loads(f.readline())
            f.write(json.dumps({"id": 0, "source": 7, "dst": 900}) + "\n")
            f.flush()
            answer = json.loads(f.readline())
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    want = pjt.ParallelJohnsonSolver().solve(pjt.load_graph(spec), [7])
    assert float(answer["distance"]) == float(want.matrix[0, 900])
    assert rc == 0
    assert list((tmp_path / "store").glob("graph_*/serve_stats.json"))


# -- the mesh (parallel.mesh) on the card ------------------------------------


@pytest.fixture
def two_ranks(cuda, monkeypatch):
    """Two mesh ranks sharing the card (gloo, staged through page-locked
    host buffers), every collective bounded by 60 s."""
    monkeypatch.setenv("PJ_MESH_DEVICES", "cuda:0*2")
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 60.0)
    return cuda


def _counts():
    from paralleljohnson_tpu_torch.ops import kernel_launches

    return kernel_launches()


@pytest.mark.parametrize("mesh_shape,route", [((2,), "sharded-1d"),
                                              ((1, 2), "sharded-2d")])
@pytest.mark.parametrize("layout", ["auto", "source_major"])
def test_mesh_fanout_on_card_equals_cpu(two_ranks, mesh_shape, route,
                                        layout):
    """``sharded-1d`` (each rank's hand sweep to its fixpoint) and
    ``sharded-2d`` (one hand sweep launch per rank per sweep on its edge
    slice, a MIN all-reduce after it) on two ranks sharing the card: the
    rows bitwise the single-device CPU solve's."""
    g = pjt.load_graph("rmat:scale=12,ef=8,seed=4")
    sources = np.arange(0, g.num_nodes, 61)[:40]
    want = pjt.ParallelJohnsonSolver(pjt.SolverConfig(fanout_layout=layout),
                                     device="cpu").solve(g, sources)
    before = _counts()["fanout_sweep"]
    got = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(mesh_shape=mesh_shape, fanout_layout=layout),
        device=two_ranks).solve(g, sources)
    assert got.stats.routes_by_phase["fanout"] == route
    if layout == "auto":  # the hand sweep on every rank
        assert _counts()["fanout_sweep"] > before
    np.testing.assert_array_equal(johnson.to_numpy(got.dist),
                                  johnson.to_numpy(want.dist))


def test_mesh_edge_sharded_and_pred_on_card(two_ranks):
    """Phase 1 ``edge-sharded`` and the fan-out ``sharded-1d+pred`` (the
    ``tight_pred`` kernel on each rank) on the negative grid: rows bitwise
    the CPU solve's, trees valid."""
    g = pjt.load_graph("grid:rows=48,cols=40,neg=0.2,seed=6")
    sources = np.arange(0, g.num_nodes, 37)[:32]
    want = pjt.ParallelJohnsonSolver(device="cpu").solve(
        g, sources, predecessors=True)
    before = _counts()
    got = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(mesh_shape=(2,), edge_shard=True),
        device=two_ranks).solve(g, sources, predecessors=True)
    after = _counts()
    assert got.stats.routes_by_phase == {"bellman_ford": "edge-sharded",
                                         "fanout": "sharded-1d+pred"}
    assert after["fanout_sweep"] > before["fanout_sweep"]
    assert after["tight_pred"] == before["tight_pred"] + 2  # one per rank
    dist = johnson.to_numpy(got.dist)
    np.testing.assert_array_equal(dist, johnson.to_numpy(want.dist))
    validate_pred_tree(g, dist, johnson.to_numpy(got.predecessors), sources)


def test_mesh_replicate_and_failure_on_card(two_ranks):
    """``sharded_fanout(replicate=True)``: each rank holds the whole
    matrix on the card; a rank that raises releases the other, the error
    reaches the caller, and the next run on the same mesh works."""
    from paralleljohnson_tpu_torch.parallel import make_mesh, sharded_fanout

    g = pjt.load_graph("rmat:scale=12,ef=8,seed=4")
    be = pjt.get_backend("torch", pjt.SolverConfig(), device=two_ranks)
    dg = be.upload(g)
    (indptr_in, src_in, w_in), items = dg.fanout_layout()
    mesh = make_mesh(device=two_ranks)
    assert "gloo: ranks share a card" in mesh.describe()

    def run():
        return sharded_fanout(
            mesh, np.arange(7), dg.src, dg.dst, dg.weights,
            num_nodes=g.num_nodes, max_iter=g.num_nodes,
            layout="vertex_major", replicate=True,
            in_edges=(indptr_in, src_in, w_in, items))

    dist, _, improving = run()
    assert not improving and dist.is_cuda and dist.shape == (7, g.num_nodes)
    assert len(dist.replicas) == 2
    for copy in dist.replicas:
        assert copy.is_cuda and torch.equal(copy, dist)
    want = pjt.ParallelJohnsonSolver(device="cpu").solve(g, np.arange(7))
    np.testing.assert_array_equal(dist.cpu().numpy(),
                                  johnson.to_numpy(want.dist))

    def body(comm):
        x = torch.ones(4, device=comm.device)
        comm.all_reduce_min_(x)
        if comm.rank == 1:
            raise KeyError("rank 1")
        comm.all_reduce_min_(x)
        return x

    with pytest.raises(KeyError, match="rank 1"):
        mesh.run(body)
    again, _, _ = run()
    assert torch.equal(again, dist)


def test_mesh_nccl_on_distinct_cards(cuda, monkeypatch):
    """With a card per rank the groups are NCCL: ``sharded-1d``, the
    edge-sharded phase 1 and the all-gather, rows bitwise one card's."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"NCCL needs two cards per mesh; {n} visible")
    monkeypatch.delenv("PJ_MESH_DEVICES", raising=False)
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 120.0)
    from paralleljohnson_tpu_torch.parallel import make_mesh, sharded_fanout

    ranks = min(n, 4)
    mesh = make_mesh((ranks,), device=cuda)
    assert mesh.backends() == ["nccl"]
    g = pjt.load_graph("grid:rows=48,cols=40,neg=0.2,seed=6")
    sources = np.arange(0, g.num_nodes, 37)[:32]
    want = pjt.ParallelJohnsonSolver(pjt.SolverConfig(mesh_shape=(1,)),
                                     device=cuda).solve(g, sources)
    solver = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(mesh_shape=(ranks,), edge_shard=True), device=cuda)
    with solver:
        got = solver.solve(g, sources)
    assert got.stats.routes_by_phase == {"bellman_ford": "edge-sharded",
                                         "fanout": "sharded-1d"}
    np.testing.assert_array_equal(johnson.to_numpy(got.dist),
                                  johnson.to_numpy(want.dist))
    g2 = pjt.load_graph("rmat:scale=12,ef=8,seed=4")
    dev_graph = pjt.get_backend("torch", pjt.SolverConfig(),
                                device=cuda).upload(g2)
    dist, _, _ = sharded_fanout(
        mesh, np.arange(9), dev_graph.src, dev_graph.dst, dev_graph.weights,
        num_nodes=g2.num_nodes, max_iter=g2.num_nodes, replicate=True)
    mesh.close()
    assert [c.device.index for c in dist.replicas] == list(range(ranks))
    one = pjt.ParallelJohnsonSolver(pjt.SolverConfig(mesh_shape=(1,)),
                                    device=cuda).solve(g2, np.arange(9))
    np.testing.assert_array_equal(dist.cpu().numpy(),
                                  johnson.to_numpy(one.dist))
