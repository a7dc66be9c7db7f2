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

from paralleljohnson_tpu_torch.ops import relax
from paralleljohnson_tpu_torch.ops.minplus import minplus_kernel, minplus_plain


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

