"""PyTorch port: the fan-out sweep (``ops/fanout_sweep.py``) against the
JAX package's Pallas sweep (``ops/pallas_sweep.py``) in interpret mode.

Both compute the same Jacobi sweep — every candidate reads the OLD
distances and the min of exactly rounded f32 sums is order-free — so one
sweep agrees bitwise, and the fixpoint agrees in distances, iteration
count and the still-improving flag. The card's
side is in tests/test_torch_cuda.py; here the kernel's work-item schedule
(split rows, partial minima, the combine) and the grouped fixpoint loop
are checked with the plain version."""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from paralleljohnson_tpu.graphs import erdos_renyi, grid2d, rmat
from paralleljohnson_tpu.ops.pallas_sweep import (
    build_pallas_sweep_layout, pallas_fanout, pallas_fanout_sweep,
)

from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
from test_torch_cuda import hub_graph


def _ref_inputs(g, vb, ec):
    """The reference layout and chunk weights, as tests/test_pallas_sweep.py
    builds them."""
    lay = build_pallas_sweep_layout(g.indptr, g.indices, g.num_nodes,
                                    vb=vb, ec=ec)
    order = lay["edge_order"]
    w = np.where(order >= 0, g.weights[np.maximum(order, 0)], np.inf)
    return lay, w.astype(np.float32)


def _ref_args(lay, w):
    return [jnp.asarray(lay[k]) if k != "w" else jnp.asarray(w)
            for k in ("srcl_ck", "dstl_ck", "w", "runend_ck", "sb_ids",
                      "db_ids", "first_ck")]


def _port_layout(g, device="cpu"):
    e = g.num_real_edges
    src = torch.as_tensor(g.src[:e]).to(device)
    dst = torch.as_tensor(g.indices[:e]).to(device)
    lay = fs.build_in_edge_layout(src, dst, g.num_nodes)
    w_in = torch.as_tensor(g.weights[:e]).to(device)[lay["order"]].contiguous()
    return lay["indptr_in"], lay["src_in"], w_in


def _dist0(sources, rows, b):
    d = np.full((rows, b), np.inf, np.float32)
    d[sources, np.arange(b)] = 0.0
    return d


def _with_inf_edges(g, frac, seed):
    """The same structure with a fraction of weights set to +inf."""
    rng = np.random.default_rng(seed)
    w = g.weights.copy()
    w[rng.random(w.shape[0]) < frac] = np.inf
    return g.with_weights(w)


def _star(l):
    """An R-MAT graph with a hub of 5 * l + 3 in-edges, rows of exactly l
    and l + 1 in-edges, and an empty row (vertices 0, 1, 2, 3)."""
    scale = max(8, (5 * l + 8).bit_length())
    return hub_graph(rmat(scale, 8, seed=1), l)


GRAPHS = [
    pytest.param(lambda: rmat(9, 8, seed=4), 128, 256, id="rmat9"),
    pytest.param(lambda: grid2d(20, 20, seed=2), 64, 128, id="grid20"),
    pytest.param(lambda: erdos_renyi(300, 0.02, seed=6), 128, 256, id="er300"),
    pytest.param(lambda: _with_inf_edges(rmat(8, 8, seed=1), 0.3, 2), 64,
                 128, id="rmat8-inf-edges"),
]


@pytest.mark.parametrize("maker,vb,ec", GRAPHS)
def test_single_sweep_bitwise_equals_pallas(maker, vb, ec):
    """One plain sweep == one interpret-mode Pallas sweep, bitwise, from
    the initial block and from blocks one and two sweeps in (finite
    values to fold)."""
    g = maker()
    v = g.num_nodes
    lay, w = _ref_inputs(g, vb, ec)
    sources = np.array([0, 3, v - 1, 7, v // 2], np.int32)
    args = _ref_args(lay, w)
    ref_sweep = jax.jit(functools.partial(
        pallas_fanout_sweep, vb=vb, interpret=True
    ))
    layout = _port_layout(g)
    d = jnp.asarray(_dist0(sources, lay["v_pad"], len(sources)))
    for _ in range(3):
        want = np.asarray(ref_sweep(d, *args))
        old = np.array(d)[:v]
        got, improved = fs.fanout_sweep(torch.as_tensor(old), *layout)
        np.testing.assert_array_equal(got.numpy(), want[:v])
        assert bool(improved) == bool((want[:v] < old).any())
        d = jnp.asarray(want)


@pytest.mark.parametrize("maker,vb,ec", GRAPHS)
def test_fixpoint_equals_pallas_fanout(maker, vb, ec):
    """dist, iterations and the still-improving flag all equal."""
    g = maker()
    v = g.num_nodes
    lay, w = _ref_inputs(g, vb, ec)
    sources = np.array([0, 1, v // 2, v - 1], np.int32)
    d0 = _dist0(sources, lay["v_pad"], len(sources))
    dist, iters, improving = pallas_fanout(
        jnp.asarray(d0), *_ref_args(lay, w), vb=vb, max_iter=v,
        interpret=True,
    )
    got, it, imp = fs.fanout_fixpoint(
        torch.as_tensor(d0[:v]), *_port_layout(g), max_iter=v
    )
    dist = np.asarray(dist)
    np.testing.assert_array_equal(got.numpy(), dist[:v])
    assert np.isinf(dist[v:]).all()  # reference pad rows stay +inf
    assert it == int(iters)
    assert imp == bool(improving) is False


def test_fixpoint_iteration_cap_matches():
    """Capped below convergence: same partial block, both still improving."""
    g = grid2d(16, 24, seed=5)
    v = g.num_nodes
    lay, w = _ref_inputs(g, 64, 128)
    sources = np.array([0, v - 1], np.int32)
    d0 = _dist0(sources, lay["v_pad"], 2)
    dist, iters, improving = pallas_fanout(
        jnp.asarray(d0), *_ref_args(lay, w), vb=64, max_iter=5,
        interpret=True,
    )
    got, it, imp = fs.fanout_fixpoint(
        torch.as_tensor(d0[:v]), *_port_layout(g), max_iter=5
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(dist)[:v])
    assert it == int(iters) == 5
    assert imp is True and bool(improving) is True


def test_in_edge_layout_structure():
    g = rmat(8, 8, seed=1)
    e = g.num_real_edges
    indptr_in, src_in, w_in = _port_layout(g)
    dst = g.indices[:e]
    order = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(
        indptr_in.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=g.num_nodes))]),
    )
    np.testing.assert_array_equal(src_in.numpy(), g.src[:e][order])
    np.testing.assert_array_equal(w_in.numpy(), g.weights[:e][order])
    assert indptr_in.dtype == src_in.dtype == torch.int32


def test_plain_sweep_chunking_is_invisible(monkeypatch):
    """Edge chunks of the plain version never change a bit (Jacobi reads
    the old block in every chunk)."""
    g = rmat(9, 8, seed=4)
    layout = _port_layout(g)
    d0 = torch.as_tensor(_dist0([0, 5, 9], g.num_nodes, 3))
    d1, _ = fs.fanout_sweep_plain(d0, *layout)
    whole, _ = fs.fanout_sweep_plain(d1, *layout)
    monkeypatch.setattr(fs, "edge_chunk_for", lambda b, e: 97)
    chunked, _ = fs.fanout_sweep_plain(d1, *layout)
    assert torch.equal(whole, chunked)


def test_backend_pallas_vm_matches_reference_backend(monkeypatch):
    """Backend level: route 'pallas-vm' on both sides, bitwise rows; the
    reference slices the batch (slice shrunk to 3 to cover stitching)."""
    from paralleljohnson_tpu.backends import get_backend as ref_get
    from paralleljohnson_tpu.backends import jax_backend as jb
    from paralleljohnson_tpu.config import SolverConfig as RefConfig

    from paralleljohnson_tpu_torch import get_backend, interop
    from paralleljohnson_tpu_torch.config import SolverConfig

    monkeypatch.setattr(jb, "PALLAS_BATCH_SLICE", 3)
    g = grid2d(12, 12, seed=5)
    sources = np.array([0, 7, 50, 99, 120, 143, 1], np.int64)
    ref = ref_get("jax", RefConfig(use_pallas=True, mesh_shape=(1,)))
    want = ref.multi_source(ref.upload(g), sources)

    be = get_backend("torch", SolverConfig(use_pallas=True), device="cpu")
    pg = interop.graph_from_arrays(g.indptr, g.indices, g.weights)
    got = be.multi_source(be.upload(pg), sources)
    assert got.route == want.route == "pallas-vm"
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert got.iterations == want.iterations
    assert got.converged and want.converged



ITEM_CASES = [
    pytest.param(lambda: rmat(9, 8, seed=4), 8, id="rmat9-L8"),
    pytest.param(lambda: rmat(9, 8, seed=4), fs.ITEM_EDGES, id="rmat9-L"),
    pytest.param(lambda: _star(16), 16, id="star-L16"),
    pytest.param(lambda: _star(fs.ITEM_EDGES), fs.ITEM_EDGES, id="star-L"),
]


def _items(indptr, wi):
    """The kernel's items as (row, first edge, end edge, piece): the
    pieces of split rows (piece k), then every other row whole (-1)."""
    deg = np.diff(indptr)
    rows = np.flatnonzero(deg <= wi.item_edges)
    pieces = wi.pieces.numpy().astype(np.int64)
    whole = np.stack([rows, indptr[rows], indptr[rows + 1],
                      np.full_like(rows, -1)], 1)
    return np.concatenate([
        np.concatenate([pieces, np.arange(len(pieces))[:, None]], 1), whole,
    ])


@pytest.mark.parametrize("maker,l", ITEM_CASES)
def test_work_items_cover_every_edge_once(maker, l):
    """Items tile each row's in-edges in CSC order, at most L each; the
    pieces of rows longer than L come first (table order = scratch row);
    every other row is one whole item, empty rows included."""
    g = maker()
    indptr = _port_layout(g)[0].numpy().astype(np.int64)
    deg = np.diff(indptr)
    wi = fs.build_work_items(torch.as_tensor(indptr, dtype=torch.int32), l)
    assert wi.item_edges == l and wi.pieces.dtype == torch.int32
    rows, e0, e1, slot = _items(indptr, wi).T
    ns = wi.n_split
    assert (slot[:ns] == np.arange(ns)).all() and (slot[ns:] == -1).all()
    assert (deg[rows[:ns]] > l).all() and (deg[rows[ns:]] <= l).all()
    assert ((e1 - e0) <= l).all() and (e1 >= e0).all()
    # Split rows: pieces back to back in CSC order, ceil(deg / L) each.
    split_rows = np.flatnonzero(deg > l)
    np.testing.assert_array_equal(wi.split_rows.numpy(), split_rows)
    np.testing.assert_array_equal(np.unique(rows[:ns]), split_rows)
    ptr = wi.split_ptr.numpy()
    assert ptr[-1] == ns
    np.testing.assert_array_equal(np.diff(ptr), -(-deg[split_rows] // l))
    for r, p0, p1 in zip(split_rows, ptr[:-1], ptr[1:]):
        assert (rows[p0:p1] == r).all()
        assert e0[p0] == indptr[r] and e1[p1 - 1] == indptr[r + 1]
        np.testing.assert_array_equal(e0[p0 + 1:p1], e1[p0:p1 - 1])
    # In CSC order within each group; every edge exactly once.
    assert (np.diff(e0[:ns]) > 0).all() and (np.diff(rows[ns:]) > 0).all()
    covered = np.concatenate([np.arange(a, b) for a, b in zip(e0, e1)])
    np.testing.assert_array_equal(np.sort(covered), np.arange(indptr[-1]))


def test_work_items_star_has_hub_split_and_empty_row():
    l = 16
    indptr = _port_layout(_star(l))[0]
    wi = fs.build_work_items(indptr, l)
    rows = wi.pieces.numpy()[:, 0]
    assert (rows == 0).sum() == 6  # ceil((5l + 3) / l)
    assert (rows == 2).sum() == 2 and not (rows == 1).any()
    assert {0, 2} <= set(wi.split_rows.tolist()) and 1 not in wi.split_rows
    items = _items(indptr.numpy().astype(np.int64), wi)
    (empty,) = np.flatnonzero(items[:, 0] == 3)
    assert items[empty, 1] == items[empty, 2] and items[empty, 3] == -1


def _items_sweep(dist, layout, wi):
    """The kernel's schedule in numpy: each item folds its edges; whole
    rows fold into old, split rows' pieces into partial rows that a second
    pass folds into old. Returns (new, improved)."""
    indptr, src, w = (t.numpy() for t in layout)
    old = dist.numpy()
    new = old.copy()
    partial = np.empty((wi.n_split, old.shape[1]), np.float32)
    for r, a, b, slot in _items(indptr.astype(np.int64), wi):
        part = np.min(old[src[a:b]] + w[a:b, None], axis=0,
                      initial=np.float32(np.inf))
        if slot < 0:
            new[r] = np.minimum(old[r], part)
        else:
            partial[slot] = part
    ptr = wi.split_ptr.numpy()
    for r, p0, p1 in zip(wi.split_rows.numpy(), ptr[:-1], ptr[1:]):
        new[r] = np.minimum(old[r], partial[p0:p1].min(axis=0))
    return new, bool((new < old).any())


@pytest.mark.parametrize("maker,l", ITEM_CASES[:3] + [
    pytest.param(lambda: _with_inf_edges(_star(8), 0.3, 5), 8,
                 id="star-L8-inf-edges"),
])
def test_work_item_schedule_equals_plain_sweep(maker, l):
    """Partial minima over L-edge pieces, combined with old afterwards,
    give the plain sweep bitwise, with the same flag (the flag is taken
    against old once every piece is in)."""
    g = maker()
    layout = _port_layout(g)
    wi = fs.build_work_items(layout[0], l)
    v = g.num_nodes
    b = 5
    d = torch.as_tensor(_dist0(np.array([0, 1, 2, v - 1, v // 2]), v, b))
    for _ in range(4):
        want, imp = fs.fanout_sweep_plain(d, *layout)
        got, flag = _items_sweep(d, layout, wi)
        np.testing.assert_array_equal(got, want.numpy())
        assert flag == bool(imp)
        d = want


FIXPOINT_CASES = [
    # (graph, max_iter or None for V, sweeps): 39 and 40 sweeps to the
    # fixpoint, so K = 3 and K = 8 each meet one fixpoint mid-group and
    # one on a group's last sweep; the cap of 5 cuts K = 3's second group
    # to 2 sweeps.
    pytest.param(lambda: grid2d(20, 20, seed=2), None, 39, id="grid20"),
    pytest.param(lambda: grid2d(16, 24, seed=5), None, 40, id="grid16x24"),
    pytest.param(lambda: grid2d(16, 24, seed=5), 5, 5, id="grid16x24-cap5"),
    pytest.param(lambda: _with_inf_edges(_star(8), 0.3, 5), None, None,
                 id="star-inf-edges"),
]


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("maker,max_iter,sweeps", FIXPOINT_CASES)
def test_grouped_fixpoint_equals_pallas_fanout(monkeypatch, maker, max_iter,
                                               sweeps, k):
    """Sweeps launched K at a time, one host read per group: dist,
    iterations and flag equal ``pallas_fanout``'s, and the host reads stay
    within ceil(iterations / K) + 1."""
    monkeypatch.setattr(fs, "SWEEPS_PER_SYNC", k)
    g = maker()
    v = g.num_nodes
    cap = max_iter or v
    lay, w = _ref_inputs(g, 64, 128)
    sources = np.array([0, 1, v // 2, v - 1], np.int32)
    d0 = _dist0(sources, lay["v_pad"], len(sources))
    dist, iters, improving = pallas_fanout(
        jnp.asarray(d0), *_ref_args(lay, w), vb=64, max_iter=cap,
        interpret=True,
    )
    before = fs.fanout_fixpoint.host_reads
    got, it, imp = fs.fanout_fixpoint(
        torch.as_tensor(d0[:v]), *_port_layout(g), max_iter=cap
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(dist)[:v])
    assert it == int(iters)
    assert sweeps is None or it == sweeps
    assert imp == bool(improving) == (max_iter is not None)
    assert fs.fanout_fixpoint.host_reads - before <= math.ceil(it / k) + 1


def test_skipped_sweep_writes_nothing():
    """prev = 0: the sweep leaves ``out`` and ``improved`` as they were."""
    g = grid2d(6, 7, seed=1)
    layout = _port_layout(g)
    d = torch.as_tensor(_dist0(np.array([0, 5]), g.num_nodes, 2))
    out = torch.full_like(d, 7.0)
    flag = torch.zeros(1, dtype=torch.int32)
    got, f = fs.fanout_sweep(d, *layout, out=out, improved=flag,
                             prev=torch.zeros(1, dtype=torch.int32))
    assert got is out and f is flag
    assert bool((out == 7.0).all()) and int(flag[0]) == 0
    got, f = fs.fanout_sweep(d, *layout, out=out, improved=flag,
                             prev=torch.ones(1, dtype=torch.int32))
    assert torch.equal(got, fs.fanout_sweep_plain(d, *layout)[0])
    assert int(f[0]) == 1
