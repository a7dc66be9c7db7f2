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
def cuda(monkeypatch):
    """The card, as one mesh rank whatever the host has (a default config
    takes every card: the single-card tests hold one card's routes; the
    mesh tests set their own ranks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only on the card")
    monkeypatch.setenv("PJ_MESH_DEVICES", "cuda:0")
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
@pytest.mark.parametrize("b", [1, 5, 128, 200, 301, 512, 700])
def test_fanout_sweep_kernel_equals_plain(cuda, b, graph):
    """B=1/5 take the scalar lane path, 128/200/512/700 the float4 path
    (B % 4 == 0); 200 has a ragged pass, 700 a second 512-column pass
    inside the warp; 301 the scalar path at four groups a lane. The hub graph splits its hub and the L + 1 row into
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
    with pytest.raises(TypeError):  # one value type per call
        minplus_kernel(d.double(), torch.zeros((5, 3), device=cuda))
    with pytest.raises(TypeError):  # f32 or f64 only
        minplus_kernel(d.half(), torch.zeros((5, 3), device=cuda).half())
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


# -- precision="f64": each hand kernel's f64 version against its plain f64
# version, and f64 solves on the card against the CPU ---------------------


@pytest.mark.parametrize("graph", sorted(SWEEP_GRAPHS))
@pytest.mark.parametrize("b", [1, 5, 64, 128, 200, 256, 301, 512, 700])
def test_fanout_sweep_f64_kernel_equals_plain(cuda, b, graph):
    """The f64 sweep (double2 lanes: 64, 128 or 256 columns a pass) on
    the f32 test's graphs and widths and the f64 pass edges (64, 256):
    bitwise the plain f64 sweep, the same flag, one launch."""
    g = SWEEP_GRAPHS[graph]()
    layout = _layout(g, cuda)
    layout = (layout[0], layout[1], layout[2].double())
    items = fs.build_work_items(layout[0])
    sources = np.random.default_rng(b).integers(0, g.num_nodes, b)
    d = _dist0(sources, g.num_nodes, b, cuda).double()
    for _ in range(3):
        d, _ = fs.fanout_sweep_plain(d, *layout)
    before = fs.fanout_sweep.launches
    got, flag = fs.fanout_sweep(d, *layout, items=items)
    want, imp = fs.fanout_sweep_plain(d, *layout)
    torch.cuda.synchronize()
    assert fs.fanout_sweep.launches == before + 1
    assert got.dtype == torch.float64
    assert torch.equal(got, want)
    assert bool(flag.item()) == bool(imp)


def _hub_set(kind, src_in, v, b):
    """Per-edge hub flags for the f64 sweep: none (null), every flag 0,
    the top quarter of the sources by out-degree, every source."""
    e = src_in.shape[0]
    if kind == "none":
        return None
    if kind in ("zeros", "all"):
        return torch.full((e,), int(kind == "all"), dtype=torch.uint8,
                          device=src_in.device)
    deg = torch.bincount(src_in.long(), minlength=v)
    row_bytes = fs.hub_row_bytes(b)
    hubs = fs.hub_sources(deg, row_bytes, budget=row_bytes * max(1, v // 4),
                          min_degree=1)
    assert 0 < hubs.numel() < v
    return torch.isin(src_in.long(), hubs).to(torch.uint8)


@pytest.mark.parametrize("hubs", ["none", "zeros", "partial", "all"])
@pytest.mark.parametrize("b", [128, 301, 512])
@pytest.mark.parametrize("graph", sorted(SWEEP_GRAPHS))
def test_fanout_sweep_f64_hub_sets_equal_plain(cuda, graph, b, hubs):
    """The f64 sweep's L2 policies (hub gathers kept, the rest streamed)
    and its column passes on the grid change no bit: with a hub set that
    is empty, partial or every source, over the hub graph's split rows,
    at B = 301 (scalar lanes, two passes) and 512 (two double2 passes),
    the rows and the flag are the plain f64 sweep's."""
    g = SWEEP_GRAPHS[graph]()
    ip, s, w = _layout(g, cuda)
    layout = (ip, s, w.double())
    items = fs.build_work_items(ip)
    flags = _hub_set(hubs, s, g.num_nodes, b)
    sources = np.random.default_rng(b + 1).integers(0, g.num_nodes, b)
    d = _dist0(sources, g.num_nodes, b, cuda).double()
    for _ in range(2):
        d, _ = fs.fanout_sweep_plain(d, *layout)
    want, imp = fs.fanout_sweep_plain(d, *layout)
    got, flag = fs.fanout_sweep(d, *layout, items=items, hubs=flags)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool(flag.item()) == bool(imp)
    # And inside the fixpoint, sweep after sweep.
    want_fix = fs.fanout_fixpoint(d.clone(), *layout, max_iter=8,
                                  hubs=None if flags is None else
                                  torch.zeros_like(flags))
    got_fix = fs.fanout_fixpoint(d.clone(), *layout, max_iter=8,
                                 items=items, hubs=flags)
    assert torch.equal(got_fix[0], want_fix[0])
    assert got_fix[1:] == want_fix[1:]


def test_fanout_sweep_hub_flags_are_f64_only(cuda):
    g = pjt.load_graph("rmat:scale=10,ef=8,seed=0")
    ip, s, w = _layout(g, cuda)
    d = _dist0([0, 1], g.num_nodes, 2, cuda)
    flags = torch.ones(s.shape[0], dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="f64"):
        fs.fanout_sweep(d, ip, s, w, hubs=flags)
    with pytest.raises(ValueError, match="hubs must be"):
        fs.fanout_sweep(d.double(), ip, s, w.double(), hubs=flags[1:])
    with pytest.raises(TypeError):
        fs.fanout_sweep(d.double(), ip, s, w.double(), hubs=flags.int())


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_hub_flags_cached_with_the_work_items(cuda, precision):
    """The device graph builds the hub flags once per pass width, at f64
    only; an R-MAT graph has hubs, and the pallas-vm solve launches the
    sweep with them."""
    g = pjt.load_graph("rmat:scale=14,ef=16,seed=0")
    dg = torch_backend.TorchBackend(pjt.SolverConfig(precision=precision),
                                    device=cuda).upload(g)
    flags = dg.hub_flags(512)
    if precision == "f32":
        assert flags is None
        return
    assert flags.dtype == torch.uint8 and bool(flags.any())
    # One pass of 128 columns (1 KB of a hub's row) from B = 128 up.
    assert dg.hub_flags(300) is flags and dg.hub_flags(128) is flags
    assert dg.hub_flags(64) is not flags
    src = dg.by_dst()[1]
    assert torch.equal(flags, fs.hub_flags(src, g.num_nodes, 512,
                                           torch.float64))


def test_fanout_fixpoint_f64_on_card_equals_cpu(cuda):
    g = pjt.load_graph("grid:rows=30,cols=40,seed=7")
    sources = np.arange(0, g.num_nodes, 97)
    b = len(sources)

    def run(dev):
        ip, s, w = _layout(g, dev)
        return fs.fanout_fixpoint(_dist0(sources, g.num_nodes, b, dev).double(),
                                  ip, s, w.double(), max_iter=g.num_nodes)

    want, it_w, imp_w = run("cpu")
    got, it, imp = run(cuda)
    assert torch.equal(got.cpu(), want)
    assert (it, imp) == (it_w, imp_w)


@pytest.mark.parametrize("shape", MINPLUS_SHAPES)
def test_minplus_f64_kernel_equals_plain(cuda, shape):
    """The f64 product (4x8 double micro-tiles) on every shape of the f32
    test: bitwise, with +inf and negative finite entries."""
    i, k, j = shape
    rng = np.random.default_rng(sum(shape))
    d, a = _operands(rng, i, k, j)
    d[(rng.random((i, k)) < 0.2) & np.isfinite(d)] *= -3
    d = torch.as_tensor(d.astype(np.float64) + rng.random((i, k)) * 1e-9)
    a = torch.as_tensor(a).double()
    d, a = d.to(cuda), a.to(cuda)
    before = minplus_kernel.launches
    got = minplus_kernel(d, a)
    torch.cuda.synchronize()
    assert minplus_kernel.launches == before + 1
    assert got.dtype == torch.float64
    assert torch.equal(got, minplus_plain(d, a))


def _split_plan(k, rows, splits):
    k_split = 16 * max(1, math.ceil(math.ceil(k / splits) / 16))
    return mp_mod.MinplusPlan(rows, max(1, -(-k // k_split)), k_split)


def _minplus_f64_under(plan, d, a, *, out=None, improved=None, prev=None):
    """The f64 product under ``plan`` (any tile and split, not only
    ``minplus_plan``'s), through the kernel's C entry point."""
    from paralleljohnson_tpu_torch.ops import _cuda

    (i, k), j = d.shape, a.shape[1]
    if out is None:
        out = torch.empty((i, j), dtype=torch.float64, device=d.device)
    scratch = (torch.empty((plan.splits, i, j), dtype=torch.float64,
                           device=d.device) if plan.splits > 1 else None)
    _cuda.launch(
        "minplus", d.data_ptr(), a.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), i, k, j, plan.rows,
        plan.splits, plan.k_split, None if prev is None else prev.data_ptr(),
        None if improved is None else improved.data_ptr(), device=d.device,
        entry="pj_minplus_f64")
    return out


F64_MP_CASES = [((100, 300, 50), ""), ((65, 129, 257), ""),
                ((1000, 777, 513), "negative"), ((70, 90, 130), "inf_rows"),
                ((300, 300, 300), "d_is_a")]


@pytest.mark.parametrize("shape,case", F64_MP_CASES)
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("rows", mp_mod.TILE_ROWS_F64)
def test_minplus_f64_every_tile_and_split(cuda, rows, splits, shape, case):
    """Every f64 tile under one split or several, on ragged I / J / K,
    all-+inf rows, negative entries and the aliased squaring ``d is a``:
    bitwise the plain f64 product."""
    i, k, j = shape
    rng = np.random.default_rng(i + k + j + splits)
    d, a = _operands(rng, i, k, j)
    d = d.astype(np.float64) + rng.random((i, k)) * 1e-9
    if case == "negative":
        d[(rng.random((i, k)) < 0.3) & np.isfinite(d)] *= -3
    if case == "inf_rows":
        d[::3] = np.inf
    d = torch.as_tensor(d).to(cuda)
    a = torch.as_tensor(a).double().to(cuda)
    if case == "d_is_a":
        d.fill_diagonal_(0.0)
        a = d
    got = _minplus_f64_under(_split_plan(k, rows, splits), d, a)
    torch.cuda.synchronize()
    assert torch.equal(got, minplus_plain(d, a))


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("rows", mp_mod.TILE_ROWS_F64)
def test_minplus_f64_flags_every_tile(cuda, rows, splits):
    """The fixpoint's flags under every f64 tile: ``improved`` set where
    an entry dropped (in the epilogue, or in the fold when K is split),
    left at 0 at the fixpoint; ``prev`` 0 skips the product, which
    writes nothing."""
    v = 300
    rng = np.random.default_rng(rows + splits)
    d, _ = _operands(rng, v, v, 1)
    d = torch.as_tensor(d).double().to(cuda)
    d.fill_diagonal_(0.0)
    plan = _split_plan(v, rows, splits)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    improved = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = torch.empty_like(d)
    _minplus_f64_under(plan, d, d, out=out, prev=one, improved=improved)
    want = minplus_plain(d, d)
    assert torch.equal(out, want)
    assert improved.item() == int(bool((want < d).any())) == 1
    fix = d.clone()
    for _ in range(12):
        fix = minplus_plain(fix, fix)
    improved.zero_()
    _minplus_f64_under(plan, fix, fix, out=out, prev=one, improved=improved)
    assert torch.equal(out, fix) and improved.item() == 0
    out.fill_(7.0)
    improved.zero_()
    _minplus_f64_under(plan, d, d, out=out, prev=torch.zeros_like(one),
                       improved=improved)
    torch.cuda.synchronize()
    assert improved.item() == 0 and bool((out == 7.0).all())


def test_minplus_f64_has_only_its_tiles(cuda):
    """The f64 kernel has the 16- and 32-row tiles and refuses others
    (the f32 128-row tile among them) without launching."""
    d = torch.zeros((40, 40), dtype=torch.float64, device=cuda)
    for rows in (64, 128):
        with pytest.raises(RuntimeError, match="failed to launch"):
            _minplus_f64_under(_split_plan(40, rows, 1), d, d)
    assert set(mp_mod.TILE_ROWS_F64) == {16, 32}


@pytest.mark.parametrize("v", [300, 1024])
def test_minplus_f64_squaring_and_fixpoint(cuda, v):
    """``d is a`` (squaring) and the grouped iterate fixpoint at f64,
    against the plain versions."""
    rng = np.random.default_rng(v)
    d, _ = _operands(rng, v, v, 1)
    d = torch.as_tensor(d).double().to(cuda)
    d.fill_diagonal_(0.0)
    assert torch.equal(minplus_kernel(d, d), minplus_plain(d, d))
    src = torch.as_tensor(rng.choice(v, 16, replace=False)).to(cuda)
    d0 = relax.multi_source_init(src, v, torch.float64)
    want, it_w, imp_w = relax.dense_fanout(d.cpu(), src.cpu(), max_iter=v)
    got, it, imp = minplus_fixpoint(d0, d, max_iter=v)
    assert torch.equal(got.cpu(), want) and (it, imp) == (it_w, imp_w)


def test_minplus_f64_occupancy(cuda):
    """Each f64 tile kernel keeps the resident blocks per SM that
    ``minplus_plan`` counts on at f64."""
    for rows, blocks in mp_mod.RESIDENT_F64.items():
        assert mp_mod.occupancy(rows, torch.float64) >= blocks, rows


def test_fanout_sweep_f64_occupancy(cuda):
    for b in (64, 128, 256, 512):
        for vec in (True, False):
            for hubs in (True, False):
                o = fs.occupancy(b, vec=vec, dtype=torch.float64, hubs=hubs)
                assert o["blocks_per_sm"] >= 2, (b, vec, hubs)


@pytest.mark.parametrize("hubs", ["none", "zeros", "partial", "all"])
@pytest.mark.parametrize("graph", sorted(PRED_GRAPHS))
@pytest.mark.parametrize("b", [1, 5, 7, 64, 128, 200, 256, 512])
def test_tight_pred_f64_kernel_equals_plain(cuda, b, graph, hubs):
    """The f64 pass (pairs compared in registers, split rows' partials as
    du and u) on converged f64 distances with zero-weight ties and -0.0:
    trees bitwise the plain f64 pass; with the sources, the mask and the
    flags equal ``tree_flags_plain``'s. With hub flags (none, all 0, the
    top quarter of the sources, every source) the L2 kernel's passes on
    the grid, its hinted loads and the flag in bit 31 of the source id
    change no bit: at B = 1, 5, 7 (scalar lanes), 64 (one pass), 128,
    200, 256, 512 (two to four 128-column passes), over the hub graph's
    split rows."""
    g = PRED_GRAPHS[graph]()
    ip, s, w = _layout(g, cuda)
    layout = (ip, s, w.double())
    items = fs.build_work_items(ip)
    flags_in = _hub_set(hubs, s, g.num_nodes, b)
    d, sources = _converged(g, b, (ip, s, w), items)
    d = d.double()
    d, _, _ = fs.fanout_fixpoint(d, *layout, max_iter=g.num_nodes,
                                 items=items)
    odd = torch.arange(g.num_nodes, device=cuda).unsqueeze(1) % 2 == 1
    d[(d == 0) & odd] = -0.0
    before = pred_mod.tight_pred_pass.launches
    got = pred_mod.tight_pred_pass(d, *layout, items=items, hubs=flags_in)
    got_s, flags = pred_mod.tight_pred_pass(d, *layout, items=items,
                                            sources=sources, hubs=flags_in)
    torch.cuda.synchronize()
    assert pred_mod.tight_pred_pass.launches == before + 2
    dt = d.t().contiguous()
    coo = _coo(g, cuda)
    plain = pred_mod.tight_pred_pass_plain(dt, coo[0], coo[1],
                                           coo[2].double())
    assert torch.equal(got, plain.t())
    want_s, want_flags = pred_mod.tree_flags_plain(plain, dt, sources)
    assert torch.equal(got_s.t(), want_s)
    assert flags.tolist() == want_flags.tolist()


@pytest.mark.parametrize("case", ["plain", "negative_diagonal", "minus_inf"])
@pytest.mark.parametrize("t", [40, 41, 128, 200, 256, 384, 500, 509, 512,
                               1024])
def test_fw_kleene_f64_on_card_equals_plain(cuda, t, case):
    """The f64 Kleene closure (the cluster in rounds of KLEENE_STEPS_F64
    steps per hand-over up to t = 512, at RR = 8, 16, 24 and 32 rows a
    thread, with +inf padding at t = 40, 41, 200, 500 and 509, and a last
    round that runs past t into it at 41 and 509, which no multiple of
    the round is; the step variant at 1024) bitwise ``tile_kleene`` at
    f64, also in place on a
    strided diagonal tile. With -inf entries a candidate is NaN (inf +
    -inf), which the kernel's min drops and ``torch.minimum`` keeps: the
    closures agree wherever the plain one has no NaN, as at f32."""
    from paralleljohnson_tpu_torch.ops import fw

    plan = fw.kleene_plan(t, 8)
    assert plan.variant == (
        "cluster" if t <= fw.KLEENE_CLUSTER_MAX_T else "step")
    assert plan.steps == (fw.KLEENE_STEPS_F64 if plan.variant == "cluster"
                          else 1)
    m = torch.as_tensor(fw_tile_matrix(
        t, t, negative_diagonal=case == "negative_diagonal")).double()
    m[torch.isfinite(m)] += 1e-9  # not representable in f32
    if case == "minus_inf":
        m[1, 2] = m[t - 3, 0] = -float("inf")
    want = fw.tile_kleene(m)
    ok = ~torch.isnan(want)
    assert bool(ok.all()) == (case != "minus_inf")
    before = fw.fw_kleene.launches
    got = fw.fw_kleene(m.to(cuda))
    torch.cuda.synchronize()
    assert fw.fw_kleene.launches == before + 1
    assert got.dtype == torch.float64
    assert torch.equal(got.cpu()[ok], want[ok])
    assert not bool(got.isnan().any())
    big = torch.full((t + 64, t + 64), 7.0, dtype=torch.float64, device=cuda)
    tile = big[32:32 + t, 16:16 + t]
    tile.copy_(m)
    fw.fw_kleene(tile, out=tile)
    torch.cuda.synchronize()
    assert torch.equal(tile.cpu()[ok], want[ok])
    rest = big.clone()
    rest[32:32 + t, 16:16 + t] = 7.0
    assert bool((rest == 7.0).all())


def test_fw_kleene_f64_plans_launch_on_card(cuda):
    """Every f64 cluster plan launches (the card holds its cluster), and
    the f64 entry point refuses a plan whose shared memory is sized for
    one step per hand-over (the f32 plan's), not for its rounds."""
    from paralleljohnson_tpu_torch.ops import _cuda, fw

    for t in (128, 256, 384, 512):
        plan = fw.kleene_plan(t, 8)
        assert fw.cluster_occupancy(plan, torch.cuda.current_device()) >= 1
    plan = fw.kleene_plan(512, 8)
    one_step = 16 + 8 * (2 * plan.cols + 3 * plan.rows)
    assert one_step < plan.smem_bytes
    m = torch.zeros((512, 512), dtype=torch.float64, device=cuda)
    fn = _cuda.lib("fw_kleene").pj_fw_kleene_f64
    stream = torch.cuda.current_stream().cuda_stream
    assert fn(m.data_ptr(), 512, m.data_ptr(), 512, 512, plan.rows,
              plan.cols, plan.threads, one_step, stream) != 0
    assert fn(m.data_ptr(), 512, m.data_ptr(), 512, 512, plan.rows,
              plan.cols, plan.threads, plan.smem_bytes, stream) == 0
    torch.cuda.synchronize()


def _tie_graph(hub_low):
    """R-MAT-12 with zero-weight ties, and a gadget: a new source S with
    edges of weight 1 to a hub h (one of the 8 sources with the most
    out-edges) and to a vertex n with at most two out-edges, and both to
    a new vertex Z with weight 1, so that Z has two tight in-edges with
    equal du. ``hub_low``: h's id is the lower of the two (else n's).
    Returns (graph, S, Z, h, n)."""
    g = _zero_ties(SWEEP_GRAPHS["rmat12"]())
    v, e = g.num_nodes, g.num_real_edges
    deg = np.bincount(g.src[:e], minlength=v)
    top = np.argsort(-deg, kind="stable")[:8]
    h = int(top.min() if hub_low else top.max())
    few = np.flatnonzero((deg >= 1) & (deg <= 2))
    n = int(few[few > h][0] if hub_low else few[few < h][0])
    s_, z = v, v + 1
    src = np.concatenate([g.src[:e], [s_, s_, h, n]])
    dst = np.concatenate([g.indices[:e], [h, n, z, z]])
    w = np.concatenate([g.weights[:e], np.ones(4, np.float32)])
    return type(g).from_edges(src, dst, w, v + 2), s_, z, h, n


@pytest.mark.parametrize("hub_low", [True, False])
@pytest.mark.parametrize("b", [1, 7, 64, 128, 512])
def test_tight_pred_f64_hub_ties_go_to_the_lower_id(cuda, b, hub_low):
    """Equal du from a hub (flagged, kept in L2) and a non-hub source:
    the lower id wins, with the flags and without (the flag rides bit 31
    of the source id and must not enter the compare), as in the plain
    pass; the gadget's source is column 0."""
    g, s_, z, h, n = _tie_graph(hub_low)
    ip, s, w = _layout(g, cuda)
    layout = (ip, s, w.double())
    items = fs.build_work_items(ip)
    hubs = fs.hub_flags(s, g.num_nodes, b, torch.float64,
                        budget=fs.hub_row_bytes(b) * 8)
    is_hub = torch.zeros(g.num_nodes, dtype=torch.bool, device=cuda)
    is_hub[s.long()[hubs.bool()]] = True
    assert bool(is_hub[h]) and not bool(is_hub[n])
    sources = np.concatenate([[s_], np.random.default_rng(b).choice(
        np.flatnonzero(np.diff(g.indptr)), b - 1)])
    d = _dist0(sources, g.num_nodes, b, cuda).double()
    d, _, _ = fs.fanout_fixpoint(d, *layout, max_iter=g.num_nodes,
                                 items=items)
    assert float(d[h, 0]) == float(d[n, 0]) == 1.0
    dt = d.t().contiguous()
    coo = _coo(g, cuda)
    plain = pred_mod.tight_pred_pass_plain(dt, coo[0], coo[1],
                                           coo[2].double())
    assert int(plain[0, z]) == min(h, n)
    want_s, want_flags = pred_mod.tree_flags_plain(plain, dt, sources)
    for flags_in in (hubs, None):
        got = pred_mod.tight_pred_pass(d, *layout, items=items, hubs=flags_in)
        got_s, flags = pred_mod.tight_pred_pass(
            d, *layout, items=items, sources=sources, hubs=flags_in)
        torch.cuda.synchronize()
        assert int(got[z, 0]) == min(h, n)
        assert torch.equal(got, plain.t())
        assert torch.equal(got_s.t(), want_s)
        assert flags.tolist() == want_flags.tolist()


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_extract_hands_the_hub_flags_to_the_pass(cuda, precision,
                                                  monkeypatch):
    """A solve with trees passes the device graph's hub flags for the
    batch's width to the tight-edge pass at f64 (an R-MAT graph has
    hubs), None at f32; the trees are the same either way."""
    g = pjt.load_graph("rmat:scale=14,ef=16,seed=0")
    seen = []
    real = torch_backend.tight_pred_pass

    def spy(dist_vm, *args, **kw):
        seen.append((dist_vm.shape[1], kw.get("hubs")))
        return real(dist_vm, *args, **kw)

    def solve():
        backend = torch_backend.TorchBackend(
            pjt.SolverConfig(precision=precision, mesh_shape=(1,)),
            device=cuda)
        res = pjt.ParallelJohnsonSolver(backend=backend).solve(
            g, np.arange(0, 4096, 16), predecessors=True)
        assert res.stats.routes_by_phase["fanout"].endswith("+pred")
        return backend, res

    monkeypatch.setattr(torch_backend, "tight_pred_pass", spy)
    backend, res = solve()
    assert len(seen) == 1 and seen[0][0] == 256
    hubs = seen[0][1]
    if precision == "f32":
        assert hubs is None
        return
    assert hubs is not None and hubs.dtype == torch.uint8
    assert torch.equal(hubs, backend.upload(g).hub_flags(256))
    # The same solve with the pass's plain loads: the same trees.
    monkeypatch.setattr(torch_backend, "tight_pred_pass",
                        lambda *a, **kw: real(*a, **{**kw, "hubs": None}))
    _, plain = solve()
    np.testing.assert_array_equal(johnson.to_numpy(res.predecessors),
                                  johnson.to_numpy(plain.predecessors))


def test_f64_kernels_reject_mixed_types(cuda):
    g = pjt.load_graph("rmat:scale=6,ef=4,seed=0")
    ip, s, w = _layout(g, cuda)
    d = torch.zeros((g.num_nodes, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        fs.fanout_sweep(d, ip, s, w)            # f32 weights
    with pytest.raises(TypeError):
        pred_mod.tight_pred_pass(d, ip, s, w)
    with pytest.raises(TypeError):
        fs.fanout_sweep(d, ip, s, w.double(), out=torch.empty_like(d).float())
    from paralleljohnson_tpu_torch.ops import fw

    with pytest.raises(TypeError):
        fw.fw_kleene(torch.zeros((8, 8), dtype=torch.float64, device=cuda),
                     out=torch.zeros((8, 8), device=cuda))


F64_SOLVES = [
    ("rmat:scale=10,ef=8,seed=2", {}, {}, "pallas-vm"),
    ("grid:rows=30,cols=30,neg=0.2,seed=2", {}, {}, "pallas-vm"),
    ("dag:n=300,p=0.05,neg=0.4,seed=3", {}, dict(predecessors=True),
     "pallas-vm+pred"),
    ("er:n=300,p=0.1,seed=1", dict(fw=False), {}, "dense-squaring-pallas"),
    ("er:n=300,p=0.1,seed=1", dict(fw=False),
     dict(sources=np.arange(0, 300, 7)), "dense-iterate-pallas"),
    ("er:n=700,p=0.1,seed=4", {}, dict(predecessors=True), "fw-tile+pred"),
]


@pytest.mark.parametrize("spec,cfg,kw,route", F64_SOLVES)
def test_f64_solve_on_card_equals_cpu(cuda, spec, cfg, kw, route):
    """``precision="f64"`` on the card through each hand route: float64
    rows (and trees) bitwise the CPU's f64 solve, with the route's
    kernels launched; nothing raises for the precision."""
    from paralleljohnson_tpu_torch.ops import kernel_launches

    g = pjt.load_graph(spec)
    c = pjt.SolverConfig(precision="f64", mesh_shape=(1,), **cfg)
    want = pjt.ParallelJohnsonSolver(c, device="cpu").solve(g, **kw)
    before = kernel_launches()
    got = pjt.ParallelJohnsonSolver(c, device=cuda).solve(g, **kw)
    after = kernel_launches()
    assert got.stats.routes_by_phase["fanout"] == route
    assert got.stats.routes_by_phase == want.stats.routes_by_phase
    assert got.matrix.dtype == np.float64
    np.testing.assert_array_equal(got.matrix, want.matrix)
    needs = {"pallas-vm": ["fanout_sweep"], "dense": ["minplus"],
             "fw-tile": ["fw_kleene", "minplus"]}
    for prefix, names in needs.items():
        if route.startswith(prefix):
            for name in names:
                assert after[name] > before[name], name
    if kw.get("predecessors"):
        assert after["tight_pred"] > before["tight_pred"]
        np.testing.assert_array_equal(johnson.to_numpy(got.predecessors),
                                      johnson.to_numpy(want.predecessors))
        validate_pred_tree(g, johnson.to_numpy(got.dist),
                           johnson.to_numpy(got.predecessors), got.sources)


def test_f64_batch_apsp_on_card_equals_cpu(cuda):
    graphs = [pjt.load_graph(f"er:n={24 + i},p=0.15,seed={i}")
              for i in range(16)]
    graphs[5] = pjt.load_graph("dag:n=40,p=0.2,neg=0.4,seed=5")
    c = pjt.SolverConfig(precision="f64")
    want = pjt.ParallelJohnsonSolver(c, device="cpu").solve_batch(graphs)
    before = fs.fanout_sweep.launches
    got = pjt.ParallelJohnsonSolver(c, device=cuda).solve_batch(graphs)
    assert fs.fanout_sweep.launches > before
    for a, b in zip(got, want):
        assert a.matrix.dtype == np.float64
        np.testing.assert_array_equal(a.matrix, b.matrix)


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
    """Two mesh ranks sharing the card (the in-process exchange: device
    copies on the card), every collective bounded by 60 s."""
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
    assert "threads: ranks share a card" in mesh.describe()

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
    """With a card per rank the in-process exchange copies between the
    cards (each ordered pair's first copy made before the run):
    ``sharded-1d``, the edge-sharded phase 1 and the all-gather, rows
    bitwise one card's."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"a card per rank needs two cards; {n} visible")
    monkeypatch.delenv("PJ_MESH_DEVICES", raising=False)
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 120.0)
    from paralleljohnson_tpu_torch.parallel import make_mesh, sharded_fanout

    ranks = min(n, 4)
    mesh = make_mesh((ranks,), device=cuda)
    assert mesh.backends() == ["threads"]
    assert "threads: a card per rank, device copies" in mesh.describe()
    assert set(mesh.peer_access()) == {(a, b) for a in range(ranks)
                                       for b in range(ranks) if a != b}
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


@pytest.mark.parametrize("placement", ["shared", "distinct"])
def test_mesh_gather_source_reused_at_once(cuda, monkeypatch, placement):
    """No rank's source block is reused while a peer's copy of it is in
    flight: on four ranks sharing the card (``shared``) or a card each
    (``distinct``, as many as there are up to four), each rank
    overwrites its source block right after every ``all_gather``
    returns, frees it and at once fills a block of the same size (which
    the caching allocator hands the freed memory), 100 times; every
    rank's gathered rows stay bitwise one card's (R-MAT-12 rows, each
    rank's block 32 MiB)."""
    from paralleljohnson_tpu_torch.parallel import make_mesh

    n = torch.cuda.device_count()
    if placement == "distinct":
        if n < 2:
            pytest.skip(f"a card per rank needs two cards; {n} visible")
        ranks = min(n, 4)
        monkeypatch.setenv("PJ_MESH_DEVICES", ",".join(
            f"cuda:{i}" for i in range(ranks)))
    else:
        ranks = 4
        monkeypatch.setenv("PJ_MESH_DEVICES", "cuda:0*4")
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 120.0)
    g = pjt.load_graph(F64_RMAT)
    per, tile = 64, 32
    sources = np.arange(0, g.num_nodes, 5)[:per * ranks]
    want = torch.as_tensor(pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(mesh_shape=(1,)), device=cuda).solve(
            g, sources).matrix)
    blocks = [want[r * per:(r + 1) * per].repeat(tile, 1)
              for r in range(ranks)]
    mesh = make_mesh(device=cuda)
    assert mesh.size == ranks and mesh.backends() == ["threads"]
    mine = {r: blocks[r].to(mesh.devices[r]) for r in range(ranks)}
    expect = {d: torch.stack(blocks).to(d) for d in set(mesh.devices)}

    def body(comm):
        bad = torch.zeros((), dtype=torch.int64, device=comm.device)
        for _ in range(100):
            src = mine[comm.rank].clone()
            got = comm.all_gather(src)
            src.fill_(float("nan"))
            del src
            junk = torch.full_like(mine[comm.rank], -1.0)
            bad += (torch.stack(got) != expect[comm.device]).sum()
            del junk, got
        return int(bad)

    assert mesh.run(body) == [0] * ranks
    mesh.close()


# -- precision="f64" above the solver on the card ----------------------------


@pytest.fixture
def four_ranks(cuda, monkeypatch):
    """Four mesh ranks sharing the card (the in-process exchange: device
    copies on the card), every collective bounded by 60 s."""
    monkeypatch.setenv("PJ_MESH_DEVICES", "cuda:0*4")
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 60.0)
    return cuda


F64_RMAT = "rmat:scale=12,ef=8,seed=4"
F64_GRID = "grid:rows=48,cols=40,neg=0.2,seed=6"
# chip_smoke's phase 24 (e) lattice: float weights, no negative ones.
F64_LATTICE = "grid:rows=64,cols=64,seed=3"
F64_MESH = [
    (F64_RMAT, dict(mesh_shape=(4,)), np.arange(0, 4096, 61)[:40], False,
     {"fanout": "sharded-1d"}),
    (F64_RMAT, dict(mesh_shape=(2, 2)), np.arange(0, 4096, 61)[:40], False,
     {"fanout": "sharded-2d"}),
    (F64_GRID, dict(mesh_shape=(4,), edge_shard=True),
     np.arange(0, 1920, 37)[:32], True,
     {"bellman_ford": "edge-sharded", "fanout": "sharded-1d+pred"}),
    # 150 rows per source group: the tree pass takes the hub flags.
    (F64_RMAT, dict(mesh_shape=(2, 2)), np.arange(0, 4096, 13)[:300], True,
     {"fanout": "sharded-2d+pred"}),
    (F64_LATTICE, dict(mesh_shape=(4,), gauss_seidel=True, frontier=False),
     np.arange(64), False, {"fanout": "gs-sharded"}),
    (F64_LATTICE, dict(mesh_shape=(4,), dia=True), np.arange(64), False,
     {"fanout": "dia-sharded"}),
]


@pytest.mark.parametrize("spec,cfg,sources,pred,routes", F64_MESH)
def test_mesh_f64_on_card_equals_one_card(four_ranks, monkeypatch, spec, cfg,
                                          sources, pred, routes):
    """Each sharded route at f64 on four ranks sharing the card: float64
    rows bitwise the single-card f64 solve's (within rtol 1e-12 on the
    float-weight lattice, and there also scipy's), the f64 sweep (and
    ``tight_pred`` on each extracting rank) launched, trees valid; every
    rank's hub flags take a quarter of the L2 budget. ``gs-sharded`` and
    ``dia-sharded`` run plain torch on each rank: no sweep, no flags."""
    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod

    budgets = []
    real = mesh_mod.hub_flags

    def spy(*args, budget, **kw):
        budgets.append(budget)
        return real(*args, budget=budget, **kw)

    monkeypatch.setattr(mesh_mod, "hub_flags", spy)
    g = pjt.load_graph(spec)
    want = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(precision="f64", mesh_shape=(1,)),
        device=four_ranks).solve(g, sources, predecessors=pred)
    before = _counts()
    with pjt.ParallelJohnsonSolver(
            pjt.SolverConfig(precision="f64", **cfg),
            device=four_ranks) as solver:
        got = solver.solve(g, sources, predecessors=pred)
    after = _counts()
    assert got.stats.routes_by_phase == routes
    assert got.matrix.dtype == np.float64
    if routes["fanout"] in ("gs-sharded", "dia-sharded"):
        import scipy.sparse.csgraph as csgraph

        np.testing.assert_allclose(got.matrix, want.matrix, rtol=1e-12,
                                   atol=0)
        oracle = csgraph.dijkstra(g.to_scipy().astype(np.float64),
                                  directed=True, indices=sources)
        np.testing.assert_allclose(got.matrix, oracle, rtol=1e-12, atol=0)
        assert not budgets
        return
    np.testing.assert_array_equal(got.matrix, want.matrix)
    assert after["fanout_sweep"] > before["fanout_sweep"]
    assert budgets and set(budgets) == {fs.HUB_L2_BYTES // 4}
    if pred:
        extracting = 2 if len(cfg["mesh_shape"]) == 2 else 4
        assert after["tight_pred"] == before["tight_pred"] + extracting
        validate_pred_tree(g, johnson.to_numpy(got.dist),
                           johnson.to_numpy(got.predecessors), sources)


def test_fleet_f64_on_card_equals_one_card(cuda, tmp_path):
    """The plan's ``precision="f64"`` reaches both in-process workers on
    the card: shards written and merged at f64 through the f64 sweep, rows
    bitwise the single-card f64 solve."""
    from paralleljohnson_tpu_torch import distributed
    from paralleljohnson_tpu_torch.distributed.launch import (
        run_in_process_fleet,
    )

    spec = "er:n=1024,p=0.004,seed=13"
    cfg = {"source_batch_size": 64, "precision": "f64"}
    coord = distributed.plan_fleet(tmp_path / "coord", spec, n_workers=2,
                                   config=cfg)
    before = fs.fanout_sweep.launches
    report = run_in_process_fleet(coord, 2, device=cuda)
    assert report.ok and set(report.worker_rcs.values()) == {0}
    assert fs.fanout_sweep.launches > before
    g = pjt.load_graph(spec)
    mat = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**cfg),
                                    device=cuda).solve(g).matrix
    rows = distributed.fleet_rows(coord.dir)
    assert sorted(rows) == list(range(g.num_nodes))
    for s, row in rows.items():
        assert row.dtype == np.float64
        np.testing.assert_array_equal(row, mat[s], err_msg=f"row {s}")


def test_repair_f64_on_card_equals_fresh_solve(cuda, tmp_path):
    """An f64 checkpoint of an integer-weight float64 lattice repaired on
    the card: in 10 parts the boundary core (384 vertices) closes on the
    f64 min-plus (``dense-iterate-pallas``); rows bitwise a fresh
    single-card f64 solve of the updated graph."""
    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.incremental import (
        IncrementalState, repair_checkpoint,
    )
    from paralleljohnson_tpu_torch.utils.checkpoint import (
        BatchCheckpointer, graph_digest,
    )

    g = grid2d(40, 40, seed=17).astype(np.float64)
    g = g.with_weights(np.maximum(1.0, np.rint(g.weights)))
    cfg = pjt.SolverConfig(checkpoint_dir=str(tmp_path), source_batch_size=64,
                           precision="f64")
    pjt.ParallelJohnsonSolver(cfg, device=cuda).solve(g)
    before = _counts()
    state = IncrementalState.build(g, num_parts=10, config=cfg, device=cuda)
    assert state.core_closed.dtype == np.float64
    state.save(BatchCheckpointer(tmp_path, graph_key=graph_digest(g)).dir)
    e = g.num_real_edges
    idx = np.random.default_rng(5).choice(e, 4, replace=False)
    updates = [(int(g.src[i]), int(g.indices[i]),
                1.0 if j % 2 == 0 else float(g.weights[i]) + 3.0)
               for j, i in enumerate(idx)]
    result = repair_checkpoint(tmp_path, g, updates, config=cfg,
                               state=state, device=cuda)
    assert _counts()["minplus"] > before["minplus"]
    assert result.rows_recomputed > 0
    new_g, _ = g.apply_edge_updates(updates)
    mat = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(source_batch_size=64, precision="f64"),
        device=cuda).solve(new_g).matrix
    ck = BatchCheckpointer(tmp_path, graph_key=graph_digest(new_g))
    man = ck.manifest()
    assert len(man) == g.num_nodes
    for fn in sorted({f for _b, f in man.values()}):
        srcs = ck.batch_sources(fn)
        rows, _ = ck.load(int(man[int(srcs[0])][0]), srcs)
        assert rows.dtype == np.float64
        for i, s in enumerate(srcs):
            np.testing.assert_array_equal(rows[i], mat[int(s)])


def test_query_engine_f64_on_card_answers_the_solve(cuda, tmp_path):
    """A store from an f64 solve's checkpoint on the card: cold hits,
    scheduled misses (the f64 sweep) and then hot hits, host-forced and
    device-forced alike, every answer the single-card f64 solve's."""
    import json

    from paralleljohnson_tpu_torch.graphs import erdos_renyi
    from paralleljohnson_tpu_torch.serve import QueryEngine, TileStore

    g = erdos_renyi(400, 0.02, seed=5).astype(np.float64)
    g = g.with_weights(np.random.default_rng(4).uniform(
        1.0, 10.0, g.weights.shape[0]))
    cfg = pjt.SolverConfig(precision="f64")
    mat = pjt.ParallelJohnsonSolver(cfg, device=cuda).solve(g).matrix
    rng = np.random.default_rng(8)
    reqs = [{"id": i, "source": int(s),
             "dst": [int(d) for d in rng.integers(0, 400, 4)]}
            for i, s in enumerate(rng.integers(0, 400, 64))]
    outs = []
    for mode in ("off", "on"):
        d = tmp_path / mode
        pjt.ParallelJohnsonSolver(
            pjt.SolverConfig(precision="f64", checkpoint_dir=str(d)),
            device=cuda).solve(g, np.arange(0, 400, 2))
        engine = QueryEngine(g, TileStore(d, g, hot_rows=256), config=cfg,
                             device=cuda, device_lookup=mode,
                             stats_interval_s=0)
        before = fs.fanout_sweep.launches
        got = [engine.query_batch([dict(r) for r in reqs]) for _ in range(2)]
        assert fs.fanout_sweep.launches > before  # the odd sources
        assert (engine.stats.device_lookups > 0) == (mode == "on")
        engine.close()
        for r in got[0] + got[1]:
            assert r["distances"] == [float(mat[r["source"], t])
                                      for t in r["dst"]]
        outs.append(json.dumps(got, sort_keys=True))
    assert outs[0] == outs[1]


def test_approx_f64_config_on_card_equals_cpu(cuda):
    """``approx_apsp`` under an f64 config on the card: estimates and
    certificates bitwise the CPU's; an error budget of 0 takes the exact
    plan, its rows bitwise the single-card f64 solve."""
    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.solver import approx

    g = grid2d(256, 8, seed=23).astype(np.float64)
    src = np.arange(0, 2048, 97)
    cfg = pjt.SolverConfig(precision="f64")
    card = approx.approx_apsp(g, src, config=cfg, epsilon=0.5, device=cuda)
    cpu = approx.approx_apsp(g, src, config=cfg, epsilon=0.5, device="cpu")
    assert card.dist.tobytes() == cpu.dist.tobytes()
    assert card.max_error.tobytes() == cpu.max_error.tobytes()
    exact, dec = approx.solve_with_budget(g, src, config=cfg,
                                          error_budget=0.0, device=cuda)
    assert dec.chosen.plan.name == "exact"
    one = pjt.ParallelJohnsonSolver(cfg, device=cuda).solve(g, src)
    np.testing.assert_array_equal(johnson.to_numpy(exact.dist),
                                  johnson.to_numpy(one.dist))


def test_mesh_f64_nccl_on_distinct_cards(cuda, monkeypatch):
    """With a card per rank the f64 collectives copy between the cards
    (the in-process exchange): the edge-sharded phase 1 and
    ``sharded-1d`` at f64, rows bitwise one card's; each rank, alone on
    its card, takes the whole L2 budget for its hub flags."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"a card per rank needs two cards; {n} visible")
    monkeypatch.delenv("PJ_MESH_DEVICES", raising=False)
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 120.0)
    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod

    budgets = []
    real = mesh_mod.hub_flags

    def spy(*args, budget, **kw):
        budgets.append(budget)
        return real(*args, budget=budget, **kw)

    monkeypatch.setattr(mesh_mod, "hub_flags", spy)
    ranks = min(n, 4)
    for spec, kw in ((F64_GRID, dict(edge_shard=True)), (F64_RMAT, {})):
        g = pjt.load_graph(spec)
        sources = np.arange(0, g.num_nodes, 37)[:32]
        want = pjt.ParallelJohnsonSolver(
            pjt.SolverConfig(precision="f64", mesh_shape=(1,)),
            device=cuda).solve(g, sources)
        with pjt.ParallelJohnsonSolver(
                pjt.SolverConfig(precision="f64", mesh_shape=(ranks,), **kw),
                device=cuda) as solver:
            got = solver.solve(g, sources)
            assert solver.backend._mesh().backends() == ["threads"]
        assert got.stats.routes_by_phase["fanout"] == "sharded-1d"
        np.testing.assert_array_equal(got.matrix, want.matrix)
    assert budgets and set(budgets) == {fs.HUB_L2_BYTES}


# -- the default mesh over every card ----------------------------------------


@pytest.fixture
def every_card(cuda, monkeypatch):
    """Every visible card as the default mesh (``PJ_MESH_DEVICES`` unset),
    every collective bounded by 120 s; skips below two cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"the default mesh over every card needs two cards; "
                    f"{n} visible")
    monkeypatch.delenv("PJ_MESH_DEVICES", raising=False)
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 120.0)
    return n


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("spec,pred,routes", [
    (F64_RMAT, False, {"fanout": "sharded-1d"}),
    (F64_RMAT, True, {"fanout": "sharded-1d+pred"}),
    (F64_GRID, True, {"bellman_ford": "frontier",
                      "fanout": "sharded-1d+pred"}),
])
def test_every_card_default_config(cuda, every_card, precision, spec, pred,
                                    routes):
    """A default config at f32 and at f64 takes every card (a rank per
    card, device copies between them): the rows bitwise
    ``mesh_shape=(1,)``'s for the
    same sources, with and without trees (trees valid); phase 1 on the
    grid keeps the frontier route, as the reference's gate does; the hand
    sweep launched; ``with`` drops the default mesh's streams."""
    g = pjt.load_graph(spec)
    sources = np.arange(0, g.num_nodes, 37)[:96]
    want = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(precision=precision, mesh_shape=(1,)),
        device=cuda).solve(g, sources, predecessors=pred)
    before = _counts()["fanout_sweep"]
    with pjt.ParallelJohnsonSolver(pjt.SolverConfig(precision=precision),
                                   device=cuda) as solver:
        got = solver.solve(g, sources, predecessors=pred)
        mesh = solver.backend._mesh()
        assert mesh.size == every_card and mesh.backends() == ["threads"]
        assert len(mesh._streams) == every_card
    assert not mesh._streams
    assert got.stats.routes_by_phase == routes
    assert _counts()["fanout_sweep"] > before
    np.testing.assert_array_equal(got.matrix, want.matrix)
    if pred:
        validate_pred_tree(g, got.matrix, johnson.to_numpy(got.predecessors),
                           sources)


def test_every_card_build_solve_close_loop(cuda, every_card):
    """Build, solve and close 20 meshes over the cards in one process (the
    default mesh, ``mesh_shape=(n,)``, a 2-D mesh where four cards allow
    it, and ``sharded_fanout(replicate=True)`` on a mesh made directly):
    every result bitwise one card's, no closed mesh left holding
    streams."""
    from paralleljohnson_tpu_torch.parallel import make_mesh, sharded_fanout

    g = pjt.load_graph(F64_RMAT)
    sources = np.arange(0, g.num_nodes, 61)[:40]
    want = pjt.ParallelJohnsonSolver(pjt.SolverConfig(mesh_shape=(1,)),
                                     device=cuda).solve(g, sources).matrix
    dg = pjt.get_backend("torch", pjt.SolverConfig(), device=cuda).upload(g)
    (ip, s_in, w_in), items = dg.fanout_layout()
    shapes = [None, (every_card,)] + ([(2, 2)] if every_card >= 4 else [])
    meshes = []
    for i in range(20):
        if i % 4 == 3:
            mesh = make_mesh(device=cuda)
            dist, _, _ = sharded_fanout(
                mesh, sources, dg.src, dg.dst, dg.weights,
                num_nodes=g.num_nodes, max_iter=g.num_nodes,
                layout="vertex_major", replicate=True,
                in_edges=(ip, s_in, w_in, items))
            mesh.close()
            meshes.append(mesh)
            np.testing.assert_array_equal(dist.cpu().numpy(), want)
            assert len(dist.replicas) == every_card
            continue
        shape = shapes[i % len(shapes)]
        with pjt.ParallelJohnsonSolver(pjt.SolverConfig(mesh_shape=shape),
                                       device=cuda) as solver:
            got = solver.solve(g, sources)
            meshes.append(solver.backend._mesh())
        np.testing.assert_array_equal(got.matrix, want)
    assert not any(m._streams for m in meshes)


@pytest.mark.parametrize("fail_at", [0, 1])
def test_every_card_rank_failure(cuda, every_card, fail_at):
    """A rank that raises before its first collective or between two, a
    rank per card: the other ranks are released (the failing rank breaks
    the run's barriers), the error reaches the caller, and the next run
    on the same mesh makes fresh barriers and gives one card's rows;
    three times over."""
    from paralleljohnson_tpu_torch.parallel import make_mesh, sharded_fanout

    g = pjt.load_graph(F64_RMAT)
    sources = np.arange(0, g.num_nodes, 61)[:40]
    want = pjt.ParallelJohnsonSolver(pjt.SolverConfig(mesh_shape=(1,)),
                                     device=cuda).solve(g, sources).matrix
    dg = pjt.get_backend("torch", pjt.SolverConfig(), device=cuda).upload(g)
    (ip, s_in, w_in), items = dg.fanout_layout()
    mesh = make_mesh(device=cuda)

    def body(comm):
        x = torch.ones(4, device=comm.device)
        for step in range(2):
            if comm.rank == 1 and step == fail_at:
                raise KeyError("rank 1")
            comm.all_reduce_min_(x)
        return x

    for _ in range(3):
        with pytest.raises(KeyError, match="rank 1"):
            mesh.run(body)
        dist, _, _ = sharded_fanout(
            mesh, sources, dg.src, dg.dst, dg.weights, num_nodes=g.num_nodes,
            max_iter=g.num_nodes, layout="vertex_major",
            in_edges=(ip, s_in, w_in, items))
        np.testing.assert_array_equal(dist.cpu().numpy(), want)
    mesh.close()


def test_every_card_rank_timeout(cuda, every_card, monkeypatch):
    """A rank that never posts its collective, a rank per card: the ranks
    waiting for it leave at their barrier's timeout, past the run's limit
    the caller gets ``TimeoutError`` naming only the rank that never
    posted, and a fresh run on the same mesh works."""
    import threading

    from paralleljohnson_tpu_torch.parallel import make_mesh
    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(mesh_mod, "DEFAULT_TIMEOUT_S", 4.0)
    monkeypatch.setattr(mesh_mod, "JOIN_GRACE_S", 4.0)
    mesh = make_mesh(device=cuda)
    release = threading.Event()

    def body(comm):
        x = torch.full((8,), float(comm.rank), device=comm.device)
        if comm.rank == 1:
            release.wait(60)
            return x
        comm.all_reduce_min_(x)
        return float(x.min())  # waits on the card for the collective

    try:
        with pytest.raises(TimeoutError, match="still running") as err:
            mesh.run(body)
        assert "rank1" in str(err.value) and "rank0" not in str(err.value)
    finally:
        release.set()

    def again(comm):
        x = torch.full((8,), float(comm.rank), device=comm.device)
        comm.all_reduce_min_(x)
        return float(x.max())

    assert mesh.run(again) == [0.0] * every_card
    mesh.close()


@pytest.mark.parametrize("skew_ms", [0, 5, 20, 100])
def test_every_card_skewed_first_collective(cuda, every_card, skew_ms):
    """The four-card crash's pattern (``scripts/torch_mesh_stress.py
    --only skew_first``), once per case on fresh meshes over every card:
    an edge mesh runs one round of edge-sharded Bellman-Ford and is
    closed; then on a fresh mesh rank 0 posts its first collectives at
    once (an integer gather, then an all-gather of its [V, b] block of
    one card's rows) while the other ranks compute their blocks with the
    hand sweep and go on launching it for ``skew_ms`` before they post.
    Every rank's gathered rows bitwise one card's."""
    import time

    from paralleljohnson_tpu_torch.parallel import (
        edge_sharded_bellman_ford, make_edge_mesh, make_mesh,
    )

    g = pjt.load_graph(F64_RMAT)
    per = 10
    sources = np.arange(0, g.num_nodes, 61)[:per * every_card]
    want = pjt.ParallelJohnsonSolver(pjt.SolverConfig(mesh_shape=(1,)),
                                     device=cuda).solve(g, sources).matrix
    want_vm = torch.as_tensor(want.T.copy())
    dg = pjt.get_backend("torch", pjt.SolverConfig(), device=cuda).upload(g)
    (ip, s_in, w_in), items = dg.fanout_layout()
    cards = [torch.device("cuda", i) for i in range(every_card)]
    layouts = [tuple(x.to(c) for x in (ip, s_in, w_in))
               + (fs.build_work_items(ip.to(c)),) for c in cards]
    first_rows = want_vm[:, :per].contiguous().to(cards[0])
    dist0 = [_dist0(sources[r * per:(r + 1) * per], g.num_nodes, per,
                    cards[r]) for r in range(every_card)]
    zeros = torch.zeros(g.num_nodes, device=cuda)

    emesh = make_edge_mesh(device=cuda)
    d, _, improving = edge_sharded_bellman_ford(
        emesh, zeros, dg.src, dg.dst, dg.weights, max_iter=1)
    emesh.close()
    assert not improving and torch.equal(d.cpu(), zeros.cpu())

    def body(comm):
        r, iters = comm.rank, 0
        if r == 0:
            block = first_rows
        else:
            ip_r, s_r, w_r, items_r = layouts[r]
            block, iters, _ = fs.fanout_fixpoint(
                dist0[r], ip_r, s_r, w_r, max_iter=g.num_nodes,
                items=items_r)
            buf = torch.empty_like(block)
            end = time.perf_counter() + skew_ms / 1000.0
            while time.perf_counter() < end:
                for _ in range(16):
                    fs.fanout_sweep(block, ip_r, s_r, w_r, items=items_r,
                                    out=buf)
                torch.cuda.current_stream().synchronize()
        ranks = comm.gather_ints([r, iters])
        return ranks, torch.cat(comm.all_gather(block), 1)

    mesh = make_mesh(device=cuda)
    got = mesh.run(body)
    mesh.close()
    for ranks, gathered in got:
        assert ranks[:, 0].tolist() == list(range(every_card))
        assert ranks[0, 1] == 0 and (ranks[1:, 1] > 0).all()
        assert torch.equal(gathered.cpu(), want_vm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_card_runs_each_kernel(cuda, every_card, dtype):
    """Each hand kernel launched on every card of one process, card 0
    first, bitwise its plain version: a kernel attribute (the min-plus
    tiles' shared memory above 48 KB, the Kleene cluster's non-portable
    size) belongs to one card's context and is set once per card, not
    once per process."""
    from paralleljohnson_tpu_torch.ops import fw

    rng = np.random.default_rng(5)
    d, a = _operands(rng, 1024, 1024, 1024)
    d, a = torch.as_tensor(d).to(dtype), torch.as_tensor(a).to(dtype)
    m = torch.as_tensor(fw_tile_matrix(512, 512)).to(dtype)
    g = pjt.load_graph(F64_RMAT)
    sources = np.arange(0, g.num_nodes, 97)[:32]
    want_mp, want_kl = minplus_plain(d, a), fw.tile_kleene(m)
    want = None
    for i in range(every_card):
        card = torch.device("cuda", i)
        assert torch.equal(minplus_kernel(d.to(card), a.to(card)).cpu(),
                           want_mp)
        assert torch.equal(fw.fw_kleene(m.to(card)).cpu(), want_kl)
        with pjt.ParallelJohnsonSolver(pjt.SolverConfig(
                mesh_shape=(1,), precision="f64" if dtype == torch.float64
                else "f32"), device=card) as solver:
            got = solver.solve(g, sources, predecessors=True)
        assert got.stats.routes_by_phase["fanout"] == "pallas-vm+pred"
        validate_pred_tree(g, got.matrix, johnson.to_numpy(got.predecessors),
                           sources)
        if want is None:
            want = got.matrix
        np.testing.assert_array_equal(got.matrix, want)
