"""PyTorch port: the fan-out sweep (``ops/fanout_sweep.py``) against the
JAX package's Pallas sweep (``ops/pallas_sweep.py``) in interpret mode.

Both compute the same Jacobi sweep — every candidate reads the OLD
distances and the min of exactly rounded f32 sums is order-free — so one
sweep agrees bitwise, and the fixpoint agrees in distances, iteration
count and the still-improving flag. The card's
side is in tests/test_torch_cuda.py."""

import functools

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

