"""PyTorch port: the sharded fan-out (``parallel.mesh``) against the JAX
package's, on the CPU.

The reference runs on its harness's eight simulated CPU devices; the port
runs on eight CPU ranks (``PJ_MESH_DEVICES=cpu*8``: eight threads, each
with its gloo process groups). Each case of ``tests/test_sharding.py``
runs through both packages on the same graph and sources: rows bitwise
equal on integer weights (else within rtol 1e-5, the reference test's
tolerance against the oracle), the same flags, and the same exact
row-sweep accounting. Every collective is bounded by
``parallel.mesh.DEFAULT_TIMEOUT_S`` = 30 s, every rank thread by 30 s more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu import ParallelJohnsonSolver as RefSolver
from paralleljohnson_tpu import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import erdos_renyi, random_dag
from paralleljohnson_tpu.parallel import make_mesh as ref_make_mesh
from paralleljohnson_tpu.parallel import multihost as ref_multihost
from paralleljohnson_tpu.parallel import sharded_fanout as ref_sharded_fanout

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.parallel import (
    make_mesh,
    make_mesh_2d,
    multihost,
    sharded_fanout,
)
from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod
from paralleljohnson_tpu_torch.parallel.mesh import visible_devices

from conftest import oracle_apsp

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the reference's 8-device mesh"
)


@pytest.fixture(autouse=True)
def _eight_cpu_ranks(monkeypatch):
    monkeypatch.setenv("PJ_MESH_DEVICES", "cpu*8")
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 30.0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int(g):
    return g.with_weights(np.round(g.weights * 8))


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _coo(g):
    """(src, dst, w) of ``g`` for the reference and for the port."""
    ref = (jnp.asarray(g.src, jnp.int32), jnp.asarray(g.indices, jnp.int32),
           jnp.asarray(g.weights, jnp.float32))
    port = (torch.as_tensor(g.src, dtype=torch.int32),
            torch.as_tensor(g.indices, dtype=torch.int32),
            torch.as_tensor(g.weights, dtype=torch.float32))
    return ref, port


def _rows_equal(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_eight_devices_present(monkeypatch):
    assert len(jax.devices()) == len(visible_devices("cpu")) == 8
    # Without the rank list the CPU is one rank: torch sees one device.
    monkeypatch.delenv("PJ_MESH_DEVICES")
    assert visible_devices("cpu") == [torch.device("cpu")]


def test_make_mesh_shapes(monkeypatch):
    assert make_mesh().size == ref_make_mesh().devices.size == 8
    assert make_mesh((4,)).size == ref_make_mesh((4,)).devices.size == 4
    assert make_mesh((4,)).shape == dict(ref_make_mesh((4,)).shape)
    for mk in (make_mesh, ref_make_mesh):
        with pytest.raises(ValueError, match="needs 16 devices; only 8"):
            mk((16,))
    monkeypatch.delenv("PJ_MESH_DEVICES")
    with pytest.raises(ValueError, match="needs 4 devices; only 1"):
        make_mesh((4,))


def test_default_mesh_is_one_card(monkeypatch):
    """On a host with several cards ``mesh_shape=None`` is one rank (the
    cards join a mesh only when a shape or the rank list asks, where the
    reference takes every device); an explicit shape takes the first
    cards. No card is touched: a mesh names its devices until it runs."""
    monkeypatch.delenv("PJ_MESH_DEVICES")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = tuple(torch.device("cuda", i) for i in range(4))
    one = make_mesh(device="cuda")
    assert one.devices == cards[:1] and one.backends() == []
    assert one.describe() == "1-rank sources mesh on cuda:0 x1"
    assert make_mesh((4,), device="cuda").devices == cards
    assert make_mesh_2d((2, 2), device="cuda").devices == cards
    with pytest.raises(ValueError, match="needs 5 devices; only 4"):
        make_mesh((5,), device="cuda")
    monkeypatch.setenv("PJ_MESH_DEVICES", "cuda:0*3")
    assert make_mesh(device="cuda").devices == (cards[0],) * 3


def test_solver_close_shuts_the_mesh_groups():
    """A sharded solve keeps its process groups for the next solve;
    ``close()``, and leaving a ``with`` block, shut them down (and take
    the mesh off the list closed at exit); a later solve builds fresh
    groups and gives the same rows."""
    g = _port(_int(erdos_renyi(48, 0.1, seed=46)))
    cfg = pjt.SolverConfig(mesh_shape=(8,), dense_threshold=0)
    with pjt.ParallelJohnsonSolver(cfg, device="cpu") as solver:
        first = solver.solve(g, np.arange(16))
        mesh = solver.backend._mesh()
        assert mesh._pgs and mesh in mesh_mod._open_meshes
    assert first.stats.routes_by_phase["fanout"] == "sharded-1d"
    assert not mesh._pgs and mesh not in mesh_mod._open_meshes
    again = solver.solve(g, np.arange(16))
    assert mesh._pgs
    solver.close()
    assert not mesh._pgs
    _rows_equal(again.matrix, first.matrix, True)


@pytest.mark.parametrize("integer", [False, True])
def test_sharded_fanout_matches_oracle(integer):
    g = erdos_renyi(64, 0.08, seed=41)
    if integer:
        g = _int(g)
    (rs, rd, rw), (s, d, w) = _coo(g)
    ref = ref_sharded_fanout(ref_make_mesh(), np.arange(64), rs, rd, rw,
                             num_nodes=64, max_iter=64)
    dist, iters, improving = sharded_fanout(make_mesh(), np.arange(64), s, d,
                                            w, num_nodes=64, max_iter=64)
    assert not improving and not bool(ref[2])
    assert iters == int(ref[1]) > 0
    _rows_equal(dist, ref[0], integer)
    np.testing.assert_allclose(dist.numpy(), oracle_apsp(g), rtol=1e-5)


def test_sharded_fanout_ragged_batch():
    """Source counts not divisible by the rank count get padded + sliced,
    on both layouts (vertex-major runs the hand sweep's plain version)."""
    g = _int(erdos_renyi(40, 0.1, seed=42))
    sources = np.array([1, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31])
    (rs, rd, rw), (s, d, w) = _coo(g)
    ref, _, _ = ref_sharded_fanout(ref_make_mesh(), sources, rs, rd, rw,
                                   num_nodes=40, max_iter=40)
    for layout in ("source_major", "vertex_major"):
        order = torch.argsort(d, stable=True)
        edges = (s, d, w) if layout == "source_major" else (
            s[order], d[order], w[order])
        dist, _, _ = sharded_fanout(make_mesh(), sources, *edges,
                                    num_nodes=40, max_iter=40, layout=layout)
        assert dist.shape == (11, 40)
        _rows_equal(dist, ref, True)


def test_solver_uses_mesh_end_to_end():
    """Full Johnson through the public API on the 8-rank mesh, negative
    weights included (phase 1 edge-sharded, the fan-out sharded-1d), equal
    to the reference's sharded solve and the numpy backend."""
    g = _int(random_dag(56, 0.12, negative_fraction=0.4, seed=43))
    ref = RefSolver(RefConfig(backend="jax")).solve(g)
    port = pjt.ParallelJohnsonSolver(pjt.SolverConfig(),
                                     device="cpu").solve(_port(g))
    assert port.stats.routes_by_phase == ref.stats.routes_by_phase == {
        "bellman_ford": "edge-sharded", "fanout": "sharded-1d"}
    _rows_equal(port.matrix, ref.matrix, True)
    numpy_rows = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(backend="numpy")).solve(_port(g)).matrix
    np.testing.assert_allclose(port.matrix, numpy_rows, rtol=1e-5, atol=1e-5)


def test_mesh_subset_and_batching():
    g = _int(erdos_renyi(48, 0.1, seed=44))
    cfg = dict(mesh_shape=(4,), source_batch_size=16)
    ref = RefSolver(RefConfig(backend="jax", **cfg)).solve(g)
    port = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**cfg),
                                     device="cpu").solve(_port(g))
    assert port.stats.routes_by_phase["fanout"] == "sharded-1d"
    assert port.stats.final_batch == ref.stats.final_batch == 16
    _rows_equal(port.matrix, ref.matrix, True)
    np.testing.assert_allclose(port.matrix, oracle_apsp(g), rtol=1e-5)


def test_sharded_equals_local():
    g = _int(erdos_renyi(52, 0.1, seed=45))
    sharded = pjt.ParallelJohnsonSolver(pjt.SolverConfig(),
                                        device="cpu").solve(_port(g))
    local = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(mesh_shape=(1,), dense_threshold=0),
        device="cpu").solve(_port(g))
    assert local.stats.routes_by_phase["fanout"] == "pallas-vm"
    _rows_equal(sharded.matrix, local.matrix, True)
    # Exact per-rank accounting: ranks that converge early bill fewer
    # sweeps than one block iterated to the slowest row.
    assert 0 < sharded.stats.edges_relaxed <= local.stats.edges_relaxed


def test_multihost_helpers_single_process(monkeypatch):
    """Without a launcher environment ``initialize()`` is a no-op, the
    global mesh covers every rank of this process, and the host-padded
    global sources feed the sharded fan-out."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    info = multihost.process_info()
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 8, "global_devices": 8}
    assert {k: info[k] for k in ("process_count", "global_devices")} == {
        k: ref_multihost.process_info()[k]
        for k in ("process_count", "global_devices")}
    mesh = multihost.global_mesh()
    assert mesh.size == 8 and not mesh.multiprocess
    g = erdos_renyi(32, 0.15, seed=4)
    sources = multihost.global_sources(mesh, np.arange(16))
    _, (s, d, w) = _coo(g)
    dist, iters, improving = sharded_fanout(
        mesh, sources, s, d, w, num_nodes=g.num_nodes, max_iter=g.num_nodes)
    assert dist.shape == (16, 32) and not improving


def test_global_sources_pads_off_multiple():
    """Off-multiple batches are padded on the host copy, as the
    reference's ``global_sources`` pads them."""
    mesh = multihost.global_mesh()
    arr = multihost.global_sources(mesh, np.arange(13))
    ref = ref_multihost.global_sources(ref_multihost.global_mesh(),
                                       np.arange(13))
    assert arr.shape == ref.shape == (16,)
    assert int(arr[13]) == int(ref[13]) == 0  # duplicates sources[0]
    np.testing.assert_array_equal(arr, np.asarray(ref))
    g = erdos_renyi(24, 0.2, seed=6)
    _, (s, d, w) = _coo(g)
    dist, _, improving = sharded_fanout(mesh, arr, s, d, w, num_nodes=24,
                                        max_iter=24)
    assert dist.shape == (16, 24) and not improving


def test_row_sweeps_accounting_exact():
    """Per-rank sweeps x real rows (never the max sweeps x B overcount),
    the reference's exact number."""
    g = _int(erdos_renyi(40, 0.12, seed=3))
    sources = np.arange(11)  # ragged: 5 pad rows across ranks 5-7
    (rs, rd, rw), (s, d, w) = _coo(g)
    ref = ref_sharded_fanout(ref_make_mesh(), sources, rs, rd, rw,
                             num_nodes=40, max_iter=40, with_row_sweeps=True)
    dist, iters, improving, row_sweeps = sharded_fanout(
        make_mesh(), sources, s, d, w, num_nodes=40, max_iter=40,
        with_row_sweeps=True)
    assert dist.shape == (11, 40)
    assert row_sweeps == int(ref[3])
    assert 11 <= row_sweeps <= iters * 11
