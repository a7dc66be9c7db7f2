"""PyTorch port: the sharded fan-out (``parallel.mesh``) against the JAX
package's, on the CPU.

The reference runs on its harness's eight simulated CPU devices; the port
runs on eight CPU ranks (``PJ_MESH_DEVICES=cpu*8``: eight threads trading
tensors through the mesh's in-process exchange). Each case of ``tests/test_sharding.py``
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
from paralleljohnson_tpu.graphs import erdos_renyi, grid2d, random_dag, rmat
from paralleljohnson_tpu.parallel import make_mesh as ref_make_mesh
from paralleljohnson_tpu.parallel import multihost as ref_multihost
from paralleljohnson_tpu.parallel import sharded_fanout as ref_sharded_fanout
from paralleljohnson_tpu.utils.paths import validate_pred_tree

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


def _four_cards(monkeypatch):
    """A host with four cards, as far as the mesh and the backend look:
    no card is touched, since a mesh names its devices until it runs."""
    monkeypatch.delenv("PJ_MESH_DEVICES")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    return tuple(torch.device("cuda", i) for i in range(4))


def test_default_mesh_takes_every_card(monkeypatch):
    """On a host with several cards ``mesh_shape=None`` takes every card,
    as the reference's ``make_mesh(None)`` takes every device, at f32 and
    at f64 alike, and its collectives run on the in-process exchange, a
    card per rank, device to device; the rank list still wins, an explicit shape takes the first cards, and the CPU stays
    one rank. No card is touched: a mesh names its devices until it
    runs."""
    cards = _four_cards(monkeypatch)
    assert mesh_mod.default_devices("cuda") == list(cards)
    every = make_mesh(device="cuda")
    assert every.devices == cards and every.backends() == ["threads"]
    assert every.describe() == ("4-rank sources mesh on cuda:0, cuda:1, "
                                "cuda:2, cuda:3 (threads: a card per rank, "
                                "device copies)")
    assert mesh_mod.make_edge_mesh(device="cuda").devices == cards
    assert make_mesh((1,), device="cuda").devices == cards[:1]
    assert make_mesh((2,), device="cuda").devices == cards[:2]
    assert make_mesh_2d((2, 2), device="cuda").devices == cards
    with pytest.raises(ValueError, match="needs 5 devices; only 4"):
        make_mesh((5,), device="cuda")
    assert make_mesh(device="cpu").devices == (torch.device("cpu"),)

    def backend_meshes(**cfg):
        backend = pjt.get_backend("torch", pjt.SolverConfig(**cfg),
                                  device="cuda")
        return backend._mesh().devices, backend._edge_mesh().devices

    for precision in ("f32", "f64"):
        assert backend_meshes(precision=precision) == (cards, cards)
        assert backend_meshes(precision=precision,
                              mesh_shape=(2,)) == (cards[:2], cards[:2])
    monkeypatch.setenv("PJ_MESH_DEVICES", "cuda:0*3")
    assert make_mesh(device="cuda").devices == (cards[0],) * 3
    assert backend_meshes(precision="f64") == ((cards[0],) * 3,) * 2
    assert make_mesh(device="cpu").devices == (torch.device("cpu"),)
    monkeypatch.setenv("PJ_MESH_DEVICES", "cuda:1,cuda:3")
    assert mesh_mod.default_devices("cuda") == [cards[1], cards[3]]
    assert backend_meshes(precision="f64") == ((cards[1], cards[3]),) * 2


def test_default_f64_config_takes_four_nccl_ranks(monkeypatch):
    """A default ``SolverConfig(precision="f64")`` on a host with four
    cards builds a four-rank mesh, a rank per card, its collectives on
    the in-process exchange, for the fan-out and for edge-sharded phase 1
    alike: the f64 default is every card, as the reference's
    ``make_mesh(None)`` is every device under x64."""
    cards = _four_cards(monkeypatch)
    solver = pjt.ParallelJohnsonSolver(pjt.SolverConfig(precision="f64"),
                                       device="cuda")
    for mesh in (solver.backend._mesh(), solver.backend._edge_mesh()):
        assert mesh.devices == cards and mesh.size == 4
        assert mesh.backends() == ["threads"]
        assert mesh.describe().endswith("(threads: a card per rank, "
                                        "device copies)")
    assert solver.backend._sources_axis_size() == 4


@pytest.mark.parametrize("name", ["make_mesh", "make_edge_mesh",
                                  "make_mesh_2d"])
def test_mesh_constructors_take_the_references_arguments(name):
    """Each mesh constructor takes the reference's arguments, in its
    order, with its defaults, and nothing more but the port's keyword-only
    ``device``: no precision decides which devices a mesh takes."""
    import inspect

    import paralleljohnson_tpu.parallel.mesh as ref_mesh_mod

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    port = params(getattr(mesh_mod, name))
    assert port[-1] == ("device", inspect.Parameter.KEYWORD_ONLY, None)
    assert port[:-1] == params(getattr(ref_mesh_mod, name))


def test_solver_close_shuts_the_mesh_groups(monkeypatch):
    """A sharded solve keeps its meshes for the next solve; ``close()``,
    and leaving a ``with`` block, close them (dropping what the exchange
    keeps between runs, the ranks' streams on a card); a later solve runs
    on the same mesh afresh and gives the same rows."""
    closed = []
    real = mesh_mod.Mesh.close

    def spy(mesh):
        closed.append(mesh)
        real(mesh)

    monkeypatch.setattr(mesh_mod.Mesh, "close", spy)
    g = _port(_int(erdos_renyi(48, 0.1, seed=46)))
    cfg = pjt.SolverConfig(mesh_shape=(8,), dense_threshold=0)
    with pjt.ParallelJohnsonSolver(cfg, device="cpu") as solver:
        first = solver.solve(g, np.arange(16))
        mesh = solver.backend._mesh()
        assert not closed
    assert first.stats.routes_by_phase["fanout"] == "sharded-1d"
    assert any(m is mesh for m in closed) and not mesh._streams
    closed.clear()
    again = solver.solve(g, np.arange(16))
    assert solver.backend._mesh() is mesh and not closed
    solver.close()
    assert any(m is mesh for m in closed)
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


def test_rank_threads_copy_nothing_between_devices(monkeypatch):
    """Every copy of the caller's tensors to a rank device is made in the
    caller's thread before the run, none in a rank thread: on four cards
    a rank thread that copied the in-edge CSC from the caller's card
    while its peers waited in an NCCL all-gather never returned. Driven
    on 8 CPU ranks through edge-sharded phase 1, the sharded fan-out and
    trees on a 1-D and a 2-D mesh."""
    import threading

    threads = []
    real = mesh_mod._to

    def spy(obj, dev):
        threads.append(threading.current_thread().name)
        return real(obj, dev)

    monkeypatch.setattr(mesh_mod, "_to", spy)
    g = _port(_int(random_dag(56, 0.12, negative_fraction=0.4, seed=43)))
    routes = []
    for shape in ((8,), (4, 2)):
        with pjt.ParallelJohnsonSolver(
                pjt.SolverConfig(mesh_shape=shape, edge_shard=True),
                device="cpu") as solver:
            res = solver.solve(g, np.arange(24), predecessors=True)
        routes.append(dict(res.stats.routes_by_phase))
    assert routes == [
        {"bellman_ford": "edge-sharded", "fanout": "sharded-1d+pred"},
        {"bellman_ford": "edge-sharded", "fanout": "sharded-2d+pred"}]
    assert threads and set(threads) == {threading.current_thread().name}


def _shifted(g, seed):
    """``g``'s weights x8 rounded, plus a random integer potential
    difference p(u) - p(v): negative weights, no negative cycle (a
    cycle's sum is unchanged)."""
    p = np.random.default_rng(seed).integers(0, 24, g.num_nodes)
    w = np.round(g.weights * 8) + p[g.src] - p[g.indices]
    return g.with_weights(w.astype(np.float32))


DEFAULT_CASES = {
    "rmat10": lambda: _int(rmat(10, seed=3)),
    "rmat10-neg": lambda: _shifted(rmat(10, seed=3), 5),
    "grid16-neg": lambda: _int(grid2d(16, 16, negative_fraction=0.3,
                                      seed=7)),
    "rmat10-float": lambda: rmat(10, seed=3),
}


@pytest.mark.parametrize("trees", [False, True])
@pytest.mark.parametrize("case", list(DEFAULT_CASES))
def test_default_config_takes_the_reference_routes(case, trees):
    """A default config on eight CPU ranks against the reference's
    default on its eight devices: each phase's route, its sweep count,
    and the rows (bitwise on integer weights, rtol 1e-6 on float ones).
    With trees the reference's sharded tight-edge pass fails under this
    JAX (a scan carry's varying axes) and it falls back to the argmin
    sweep (``pred-sweep``); the port takes ``sharded-1d+pred``, and both
    trees are valid."""
    g = DEFAULT_CASES[case]()
    sources = np.arange(0, g.num_nodes, 5)[:64]
    ref = RefSolver(RefConfig(backend="jax")).solve(g, sources,
                                                   predecessors=trees)
    port = pjt.ParallelJohnsonSolver(pjt.SolverConfig(), device="cpu")
    with port:
        got = port.solve(_port(g), sources, predecessors=trees)
        assert port.backend._mesh().size == 8
    want_routes = dict(ref.stats.routes_by_phase)
    if trees:
        assert want_routes["fanout"] == "pred-sweep"
        want_routes["fanout"] = "sharded-1d+pred"
    assert got.stats.routes_by_phase == want_routes
    assert want_routes["fanout"].startswith("sharded-1d")
    assert ("bellman_ford" in want_routes) == g.has_negative_weights
    if g.has_negative_weights:
        assert want_routes["bellman_ford"] == "edge-sharded"
    assert dict(got.stats.iterations_by_phase) == dict(
        ref.stats.iterations_by_phase)
    if case.endswith("float"):
        np.testing.assert_allclose(got.matrix, np.asarray(ref.matrix),
                                   rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.matrix, np.asarray(ref.matrix))
    if trees:
        validate_pred_tree(g, got.matrix, np.asarray(got.predecessors),
                           sources)
        validate_pred_tree(g, np.asarray(ref.matrix),
                           np.asarray(ref.predecessors), sources)


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


def test_run_past_its_limit_raises_and_the_mesh_recovers(monkeypatch):
    """A rank that never posts its collective: past the run's limit the
    caller gets ``TimeoutError``, the groups are dropped (the ranks still
    waiting leave on their groups' own timeout), and the next run on the
    same mesh builds fresh groups and completes."""
    import threading

    monkeypatch.setattr(mesh_mod, "DEFAULT_TIMEOUT_S", 2.0)
    monkeypatch.setattr(mesh_mod, "JOIN_GRACE_S", 1.0)
    mesh = make_mesh((4,))
    release = threading.Event()

    def body(comm):
        x = torch.full((4,), float(comm.rank))
        if comm.rank == 1:
            release.wait(30)
            return x
        return comm.all_reduce_min_(x)

    try:
        with pytest.raises(TimeoutError, match="still running") as err:
            mesh.run(body)
        # The ranks waiting at the barrier left on its own timeout.
        assert "rank1" in str(err.value) and "rank0" not in str(err.value)
    finally:
        release.set()

    def again(comm):
        return float(comm.all_reduce_min_(
            torch.full((4,), float(comm.rank))).max())

    assert mesh.run(again) == [0.0] * 4
    mesh.close()
