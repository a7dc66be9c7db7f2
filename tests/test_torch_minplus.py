"""PyTorch port: the min-plus product (``ops/minplus.py``) and the dense
family of ``ops/relax.py`` against the JAX package's Pallas product
(``ops/pallas_kernels.py``, interpret mode) and its XLA ``relax.minplus``.

Every output entry is the exact min of exactly rounded f32 sums, so all
three agree bitwise whatever their blocking. The card's side is in
tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from paralleljohnson_tpu.graphs import erdos_renyi
from paralleljohnson_tpu.ops import relax as ref_relax
from paralleljohnson_tpu.ops.pallas_kernels import minplus_pallas

from paralleljohnson_tpu_torch.ops import minplus as mp_mod
from paralleljohnson_tpu_torch.ops import relax
from paralleljohnson_tpu_torch.ops.minplus import (
    minplus_fixpoint,
    minplus_kernel,
    minplus_plain,
    minplus_plan,
)


def _operands(rng, i, k, j, inf_frac=0.3):
    d = rng.random((i, k)).astype(np.float32)
    a = rng.random((k, j)).astype(np.float32)
    d[rng.random((i, k)) < inf_frac] = np.inf
    a[rng.random((k, j)) < inf_frac] = np.inf
    return d, a


SHAPES = [(5, 7, 9), (8, 128, 128), (100, 300, 50), (1, 1, 1), (64, 33, 65),
          (3, 129, 2)]


@pytest.mark.parametrize("shape", SHAPES)
def test_minplus_plain_bitwise_equals_pallas_and_xla(shape):
    i, k, j = shape
    d, a = _operands(np.random.default_rng(sum(shape)), i, k, j)
    want_pallas = np.asarray(
        minplus_pallas(jnp.asarray(d), jnp.asarray(a), interpret=True)
    )
    want_xla = np.asarray(ref_relax.minplus(jnp.asarray(d), jnp.asarray(a)))
    got = minplus_kernel(torch.as_tensor(d), torch.as_tensor(a)).numpy()
    assert got.shape == (i, j)
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_xla)


def test_minplus_all_inf_rows_and_identity():
    d = np.full((4, 16), np.inf, np.float32)
    d[2, 3] = 1.5
    a = np.zeros((16, 16), np.float32)
    got = minplus_plain(torch.as_tensor(d), torch.as_tensor(a)).numpy()
    want = np.asarray(
        minplus_pallas(jnp.asarray(d), jnp.asarray(a), interpret=True)
    )
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[[0, 1, 3]]).all() and (got[2] == 1.5).all()


def test_minplus_row_blocking_is_invisible():
    """The plain product's row and k blocking never change a bit."""
    d, a = _operands(np.random.default_rng(3), 48, 96, 72)
    whole = relax.minplus(torch.as_tensor(d), torch.as_tensor(a))
    small = relax.minplus(torch.as_tensor(d), torch.as_tensor(a),
                          k_block=7, budget_elems=500)
    assert torch.equal(whole, small)


def _adjacency_pair(g):
    ref = ref_relax.dense_adjacency(
        jnp.asarray(g.src, jnp.int32), jnp.asarray(g.indices, jnp.int32),
        jnp.asarray(g.weights, jnp.float32), g.num_nodes,
    )
    port = relax.dense_adjacency(
        torch.as_tensor(g.src), torch.as_tensor(g.indices),
        torch.as_tensor(g.weights), g.num_nodes,
    )
    return np.asarray(ref), port


def test_dense_adjacency_bitwise():
    g = erdos_renyi(40, 0.15, seed=11).pad_edges(64)
    ref, port = _adjacency_pair(g)
    np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("n_sources", [8, 40])  # iterate / squaring regimes
def test_dense_fanout_bitwise_equals_pallas_route(n_sources):
    g = erdos_renyi(40, 0.15, seed=11)
    ref_a, a = _adjacency_pair(g)
    sources = np.arange(n_sources)
    mp = functools.partial(minplus_pallas, interpret=True)
    want, it_w, imp_w = ref_relax.dense_fanout(
        jnp.asarray(ref_a), jnp.asarray(sources, jnp.int32),
        max_iter=g.num_nodes, mp=mp,
    )
    got, it, imp = relax.dense_fanout(
        a, torch.as_tensor(sources), max_iter=g.num_nodes, mp=minplus_kernel
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert it == int(it_w) and imp == bool(imp_w) is False
    assert (relax.dense_fanout_regime(40, n_sources)
            == ref_relax.dense_fanout_regime(40, n_sources))



PLAN_SHAPES = [(1, 1024, 1024), (16, 1024, 1024), (100, 1024, 1024),
               (128, 1024, 1024), (511, 1024, 1024), (1024, 1024, 1024),
               (1000, 777, 513), (300, 400, 200), (5, 7, 9), (3, 129, 2),
               (64, 33, 65), (4096, 4096, 4096), (1, 0, 3)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_minplus_plan_covers_the_product_once(shape):
    """The plan's tiles cover [I, J] once (no tile wholly outside), its
    splits cover [0, K) once and none is empty, k_split is a whole number
    of k-tiles; a batch of at most 16 (128) rows takes 16-row (32-row)
    tiles, a wider one the tile that pads fewer rows."""
    i, k, j = shape
    p = minplus_plan(i, k, j)
    gx, gy, gz = p.grid(i, j)
    assert (gx - 1) * mp_mod.TILE_COLS < j <= gx * mp_mod.TILE_COLS
    assert (gy - 1) * p.rows < i <= gy * p.rows
    assert p.rows in mp_mod.TILE_ROWS
    if i <= 16:
        assert p.rows == 16
    elif i <= 128:
        assert p.rows == 32
    else:
        assert gy * p.rows == min(-(-i // r) * r for r in (32, 128))
    assert 1 <= p.splits == gz <= mp_mod.MAX_SPLITS
    assert p.k_split % mp_mod.TILE_K == 0
    covered = [(z * p.k_split, min(k, (z + 1) * p.k_split))
               for z in range(p.splits)]
    if k:
        assert all(lo < hi for lo, hi in covered)
        assert covered[0][0] == 0 and covered[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))
    else:
        assert p.splits == 1
    if p.splits > 1:
        assert p.k_split >= mp_mod.MIN_SPLIT_K
        assert gx * gy * p.splits <= mp_mod.SMS * mp_mod.RESIDENT[p.rows]


def test_minplus_plan_at_the_dense_routes_shapes():
    """Split K where the output tiles alone leave the card idle, not at
    large shapes; a narrow source batch gets a narrow tile."""
    assert minplus_plan(1024, 1024, 1024)[:2] == (128, 4)
    assert minplus_plan(511, 1024, 1024)[:2] == (128, 8)
    assert minplus_plan(128, 1024, 1024)[:2] == (32, 16)
    assert minplus_plan(16, 1024, 1024)[:2] == (16, 16)
    assert minplus_plan(200, 1024, 1024).rows == 32
    assert minplus_plan(1, 1024, 1024).rows == 16
    assert minplus_plan(4096, 4096, 4096).splits == 1
    assert minplus_plan(2048, 2048, 2048).splits == 1


def _split_fold(d, a, plan):
    """The kernel's schedule in torch: every (tile, split) block's partial
    min-plus product, folded over the splits with torch.minimum."""
    i, k = d.shape
    j = a.shape[1]
    part = torch.full((plan.splits, i, j), float("inf"))
    gx, gy, _ = plan.grid(i, j)
    for z in range(plan.splits):
        ks = slice(z * plan.k_split, min(k, (z + 1) * plan.k_split))
        for y in range(gy):
            rs = slice(y * plan.rows, (y + 1) * plan.rows)
            for x in range(gx):
                cs = slice(x * mp_mod.TILE_COLS, (x + 1) * mp_mod.TILE_COLS)
                part[z, rs, cs] = minplus_plain(d[rs, ks], a[ks, cs])
    return part.amin(dim=0) if plan.splits > 1 else part[0]


@pytest.mark.parametrize("shape", [(16, 256, 130), (129, 200, 70),
                                   (40, 1000, 33), (100, 300, 50)])
def test_split_and_fold_bitwise_equals_plain_and_pallas(shape):
    i, k, j = shape
    rng = np.random.default_rng(sum(shape))
    d, a = _operands(rng, i, k, j)
    d[(rng.random((i, k)) < 0.2) & np.isfinite(d)] *= -3  # negative entries
    plan = minplus_plan(i, k, j)
    got = _split_fold(torch.as_tensor(d), torch.as_tensor(a), plan)
    assert torch.equal(got, minplus_plain(torch.as_tensor(d),
                                          torch.as_tensor(a)))
    want = np.asarray(minplus_pallas(jnp.asarray(d), jnp.asarray(a),
                                     interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    if shape != (100, 300, 50):
        assert plan.splits > 1


def test_minplus_kernel_flags_on_cpu():
    """``improved`` is set where out < d; a product whose ``prev`` holds 0
    is skipped and writes nothing."""
    d, a = _operands(np.random.default_rng(4), 6, 6, 6)
    np.fill_diagonal(a, 0.0)
    d, a = torch.as_tensor(d), torch.as_tensor(a)
    flag = torch.zeros(1, dtype=torch.int32)
    out = torch.empty_like(d)
    minplus_kernel(d, a, out=out, improved=flag)
    assert torch.equal(out, minplus_plain(d, a))
    assert int(flag[0]) == int(bool((out < d).any()))
    eye = torch.full((6, 6), float("inf")).fill_diagonal_(0.0)
    fixed = torch.zeros(1, dtype=torch.int32)
    minplus_kernel(out, eye, out=d, improved=fixed)
    assert int(fixed[0]) == 0 and torch.equal(d, out)  # the identity
    stale = torch.full_like(d, 7.0)
    minplus_kernel(d, a, out=stale, improved=flag,
                   prev=torch.zeros(1, dtype=torch.int32))
    assert bool((stale == 7.0).all())


@pytest.mark.parametrize("group", [1, 2, 16])
@pytest.mark.parametrize("cap", [None, 1, 3, 5])
def test_minplus_fixpoint_equals_reference_iterate_regime(monkeypatch, group,
                                                          cap):
    """The grouped fixpoint through ``dense_fanout(fixpoint=)`` against the
    reference's ``dense_fanout`` (Pallas interpret mode) in the iterate
    regime: dist bitwise, iterations, flag; host reads <= ceil(it / group)
    + 1. A cap of 3 or 5 at group 2 stops mid-group."""
    monkeypatch.setattr(mp_mod, "PRODUCTS_PER_SYNC", group)
    g = erdos_renyi(40, 0.08, seed=13)
    ref_a, a = _adjacency_pair(g)
    sources = np.array([0, 5, 11, 30, 39])
    max_iter = cap or g.num_nodes
    mp = functools.partial(minplus_pallas, interpret=True)
    want, it_w, imp_w = ref_relax.dense_fanout(
        jnp.asarray(ref_a), jnp.asarray(sources, jnp.int32),
        max_iter=max_iter, mp=mp,
    )
    before = minplus_fixpoint.host_reads
    got, it, imp = relax.dense_fanout(
        a, torch.as_tensor(sources), max_iter=max_iter, mp=minplus_kernel,
        fixpoint=minplus_fixpoint,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (it, imp) == (int(it_w), bool(imp_w))
    assert minplus_fixpoint.host_reads - before <= -(-it // group) + 1
    if cap is None:
        assert imp is False and it > 3
    else:
        assert imp is True and it == cap
