"""PyTorch port: ``parallel/multihost.py``, the two sharded resilience
cases and the multichip dry run, against the JAX package, on the CPU.

- ``tests/test_multihost_env.py``'s cases with torch's launcher names
  (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``),
  ``torch.distributed.init_process_group`` mocked;
- a two-process run like ``tests/test_multihost.py``: two processes over
  a localhost gloo group (``tests/torch_multihost_child.py``), the sharded
  fan-out with the explicit all-gather on a host-padded batch, the same
  row-sweep total and rows in both, equal to an in-process 2-rank mesh;
- ``tests/test_resilience.py``'s sharded cases: a collective failure on
  CPU ranks degrades to one device (``+1dev-fallback``), an OOM shrinks
  the batch and keeps the mesh;
- the checks of ``__graft_entry__._dryrun_multichip_impl`` on 8 CPU ranks.

Mesh tests run on eight CPU ranks (``PJ_MESH_DEVICES=cpu*8``) with every
collective bounded by ``parallel.mesh.DEFAULT_TIMEOUT_S`` = 30 s; the
child processes by 120 s."""

import hashlib
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu import ParallelJohnsonSolver as RefSolver
from paralleljohnson_tpu import SolverConfig as RefConfig
from paralleljohnson_tpu.backends import get_backend as ref_get_backend
from paralleljohnson_tpu.graphs import erdos_renyi, grid2d, random_dag
from paralleljohnson_tpu.parallel import multihost as ref_multihost
from paralleljohnson_tpu.parallel import (
    edge_sharded_bellman_ford as ref_edge_bf,
    make_edge_mesh as ref_make_edge_mesh,
    make_mesh as ref_make_mesh,
    sharded_fanout as ref_sharded_fanout,
)

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.backends import get_backend
from paralleljohnson_tpu_torch.ops import relax
from paralleljohnson_tpu_torch.parallel import (
    edge_sharded_bellman_ford,
    make_edge_mesh,
    make_mesh,
    make_mesh_2d,
    multihost,
    sharded_fanout,
    sharded_fanout_2d,
)
from paralleljohnson_tpu_torch.utils.faults import Fault, FaultPlan
from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

REPO = Path(__file__).resolve().parent.parent
CHILD = Path(__file__).with_name("torch_multihost_child.py")
LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

needs_eight = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the reference's 8-device mesh")


@pytest.fixture(autouse=True)
def _eight_cpu_ranks(monkeypatch):
    monkeypatch.setenv("PJ_MESH_DEVICES", "cpu*8")
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 30.0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def capture_init(monkeypatch):
    """Mock ``torch.distributed.init_process_group``; record its kwargs."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _coo(g):
    return (torch.as_tensor(g.src, dtype=torch.int32),
            torch.as_tensor(g.indices, dtype=torch.int32),
            torch.as_tensor(g.weights, dtype=torch.float32))


# -- initialize(): the launcher environment ----------------------------------


def test_initialize_noop_without_env_or_args(capture_init, monkeypatch):
    for var in LAUNCHER_ENV:
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert capture_init == []  # a no-op initializes nothing


def test_initialize_env_plumbing(capture_init, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert multihost.initialize(device="cpu") is True
    # init_method None: torch's env:// rendezvous reads MASTER_ADDR /
    # MASTER_PORT (under torchrun, the launcher's store).
    assert capture_init == [{
        "backend": "gloo",
        "init_method": None,
        "world_size": 4,
        "rank": 2,
    }]


def test_initialize_args_override_env(capture_init, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert multihost.initialize(
        coordinator_address="127.0.0.1:9", num_processes=2, process_id=1,
        device="cpu",
    ) is True
    assert capture_init[0]["init_method"] == "tcp://127.0.0.1:9"
    assert capture_init[0]["world_size"] == 2
    assert capture_init[0]["rank"] == 1


def test_initialize_num_processes_alone_triggers(capture_init, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize(device="cpu") is True
    # No address: torch's own env:// rendezvous.
    assert capture_init[0]["world_size"] == 1
    assert capture_init[0]["init_method"] is None


# -- global_sources and process_info ------------------------------------------


@needs_eight
def test_global_sources_pads_to_device_multiple():
    mesh = multihost.global_mesh()
    assert mesh.size == ref_multihost.global_mesh().devices.size == 8
    b = 10  # off-multiple: 10 -> 16
    arr = multihost.global_sources(mesh, np.arange(b))
    ref = np.asarray(ref_multihost.global_sources(
        ref_multihost.global_mesh(), np.arange(b)))
    assert arr.shape == ref.shape == (16,)
    assert list(arr[:b]) == list(range(b))
    assert list(arr[b:]) == [0] * (16 - b)  # duplicates sources[0]
    assert arr.dtype == ref.dtype == np.int32


@needs_eight
def test_global_sources_exact_multiple_unpadded():
    mesh = multihost.global_mesh()
    arr = multihost.global_sources(mesh, np.arange(16))
    assert arr.shape == (16,)
    assert list(arr) == list(range(16))


@needs_eight
def test_global_sources_row_accounting_under_virtual_mesh():
    """The padded global sources + ``n_real_rows`` keep the row-sweep
    accounting exact (the duplicate pad rows are not billed), equal to the
    reference's total."""
    g = erdos_renyi(32, 0.15, seed=5)
    b = 10
    garr = multihost.global_sources(multihost.global_mesh(), np.arange(b))
    dist, iters, improving, row_sweeps = sharded_fanout(
        multihost.global_mesh(), garr, *_coo(g), num_nodes=g.num_nodes,
        max_iter=g.num_nodes, replicate=True, with_row_sweeps=True,
        n_real_rows=b)
    ref_mesh = ref_multihost.global_mesh()
    ref = ref_sharded_fanout(
        ref_mesh, ref_multihost.global_sources(ref_mesh, np.arange(b)),
        jnp.asarray(g.src), jnp.asarray(g.indices), jnp.asarray(g.weights),
        num_nodes=g.num_nodes, max_iter=g.num_nodes, replicate=True,
        with_row_sweeps=True, n_real_rows=b)
    assert not improving
    assert row_sweeps == int(ref[3])
    assert b <= row_sweeps <= iters * b
    rows = dist.numpy()[:b]
    assert rows.shape == (b, g.num_nodes)
    assert np.isfinite(rows[np.arange(b), np.arange(b)]).all()
    np.testing.assert_allclose(rows, np.asarray(ref[0])[:b], rtol=1e-6)
    # replicate=True: every rank holds the whole matrix.
    assert len(dist.replicas) == 8
    for copy in dist.replicas:
        assert torch.equal(copy, dist)


@needs_eight
def test_process_info_reports_topology(monkeypatch):
    info = multihost.process_info()
    ref = ref_multihost.process_info()
    assert info["process_count"] == ref["process_count"] == 1
    assert info["local_devices"] == info["global_devices"] == 8
    assert ref["local_devices"] == ref["global_devices"] == 8


# -- two processes ------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_fanout(monkeypatch):
    port = _free_port()
    nprocs = 2
    env = {k: v for k, v in os.environ.items()
           if k not in LAUNCHER_ENV and k != "PJ_MESH_DEVICES"}
    env["PYTHONPATH"] = str(REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, str(CHILD), str(i), str(nprocs), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=str(REPO))
        for i in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
    lines = [line for out in outs for line in out.splitlines()
             if line.startswith("MHOK")]
    assert len(lines) == nprocs, outs
    fields = [dict(kv.split("=") for kv in line.split()[1:]) for line in lines]
    # The same exact accounting and rows in both processes ...
    assert len({f["row_sweeps"] for f in fields}) == 1, lines
    assert len({f["rows"] for f in fields}) == 1, lines
    # ... and as an in-process mesh of two CPU ranks computes them.
    monkeypatch.setenv("PJ_MESH_DEVICES", "cpu*2")
    g = pjt.graphs.erdos_renyi(48, 0.12, seed=5)
    b = 11
    garr = multihost.global_sources(make_mesh(), np.arange(b))
    dist, iters, _, row_sweeps = sharded_fanout(
        make_mesh(), garr, *_coo(g), num_nodes=g.num_nodes,
        max_iter=g.num_nodes, replicate=True, with_row_sweeps=True,
        n_real_rows=b)
    rows = np.ascontiguousarray(dist.numpy()[:b])
    assert fields[0]["rows"] == hashlib.sha256(rows.tobytes()).hexdigest()
    assert int(fields[0]["row_sweeps"]) == row_sweeps
    assert int(fields[0]["iters"]) == iters


# -- the sharded -> single-device fallback ------------------------------------


@needs_eight
def test_sharded_fanout_falls_back_to_single_device():
    """A collective failure on the sharded fan-out of CPU ranks degrades
    the solve to one device, tagged ``+1dev-fallback``, as the reference
    does; later solves on the same backend stay on one rank."""
    g = erdos_renyi(64, 0.08, seed=41)
    ref = RefSolver(RefConfig(backend="jax")).solve(g)
    plan = FaultPlan([
        Fault(stage="sharded_fanout", kind="error", attempt=1, times=99),
    ])
    solver = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(fault_plan=plan, retry_attempts=1), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = solver.solve(_port(g))
    route = res.stats.routes_by_phase["fanout"]
    assert route.endswith("+1dev-fallback")
    np.testing.assert_allclose(res.matrix, np.asarray(ref.dist), rtol=1e-6)
    assert solver.backend._mesh().size == 1
    res2 = solver.solve(_port(g))
    assert "sharded" not in res2.stats.routes_by_phase["fanout"]
    np.testing.assert_allclose(res2.matrix, np.asarray(ref.dist), rtol=1e-6)


@needs_eight
def test_sharded_oom_degrades_batch_not_mesh():
    """An OOM inside the sharded path belongs to the batch degrader
    (shrink, stay sharded), not the single-device fallback."""
    g = erdos_renyi(64, 0.08, seed=41)
    ref = RefSolver(RefConfig(backend="jax")).solve(g)
    plan = FaultPlan([Fault(stage="sharded_fanout", kind="oom", attempt=1)])
    solver = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(fault_plan=plan, source_batch_size=64,
                         pipeline_depth=1), device="cpu")
    res = solver.solve(_port(g))
    assert res.stats.oom_degradations == 1
    assert res.stats.final_batch == 32
    assert solver.backend._mesh().size > 1  # the mesh is untouched
    assert res.stats.routes_by_phase["fanout"] == "sharded-1d"
    np.testing.assert_allclose(res.matrix, np.asarray(ref.dist), rtol=1e-6)


# -- the multichip dry run's checks -------------------------------------------


@needs_eight
def test_dryrun_multichip_checks_on_eight_ranks():
    """``__graft_entry__._dryrun_multichip_impl``'s checks through the
    port on 8 CPU ranks, each beside the reference's number: phase 1
    edge-sharded, the sharded fan-out with the all-gather and
    predecessors, the 2-D mesh agreeing with the 1-D one, and the
    ``gs-sharded`` and ``dia-sharded`` fan-outs."""
    n = 8
    g = random_dag(32, 0.15, negative_fraction=0.4, seed=7).pad_edges(128)
    v = g.num_nodes
    src, dst, w = _coo(g)
    h, bf_iters, bf_improving = edge_sharded_bellman_ford(
        make_edge_mesh((n,)), torch.zeros(v), src, dst, w, max_iter=v)
    ref_h, ref_iters, _ = ref_edge_bf(
        ref_make_edge_mesh((n,)), jnp.zeros(v, jnp.float32),
        jnp.asarray(g.src), jnp.asarray(g.indices),
        jnp.asarray(g.weights, jnp.float32), max_iter=v)
    assert not bf_improving and bf_iters == int(ref_iters)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=1e-6,
                               atol=1e-6)
    wp = relax.reweight_weights(w, src, dst, h)

    sources = np.arange(v)
    dist, iters, improving, pred = sharded_fanout(
        make_mesh((n,)), sources, src, dst, wp, num_nodes=v, max_iter=v,
        replicate=True, with_pred=True)
    hh = h.numpy()
    dist = dist.numpy() - hh[sources][:, None] + hh[None, :]
    assert dist.shape == (v, v) and not improving
    assert np.allclose(np.diag(dist), 0.0, atol=1e-5)
    assert pred.shape == dist.shape
    ref = ref_sharded_fanout(
        ref_make_mesh((n,)), sources, jnp.asarray(g.src),
        jnp.asarray(g.indices), jnp.asarray(wp.numpy()), num_nodes=v,
        max_iter=v, replicate=True, with_pred=True)
    assert iters == int(ref[1])
    ref_rows = np.asarray(ref[0]) - hh[sources][:, None] + hh[None, :]
    np.testing.assert_allclose(dist, ref_rows, rtol=1e-5, atol=1e-5)
    real = _port(random_dag(32, 0.15, negative_fraction=0.4, seed=7))
    validate_pred_tree(real, dist, pred.numpy(), sources)

    d2, _, imp2 = sharded_fanout_2d(make_mesh_2d((n // 2, 2)), sources, src,
                                    dst, wp, num_nodes=v, max_iter=v)
    assert not imp2
    d2 = d2.numpy() - hh[:, None] + hh[None, :]
    assert np.allclose(d2, dist, atol=1e-5), "2-D mesh != 1-D mesh result"

    gg = grid2d(12, 12, seed=3)
    port_gg = _port(gg)
    rows = {}
    for name, kw in (("gs-sharded", dict(gauss_seidel=True, frontier=False,
                                         gs_block_size=32)),
                     ("dia-sharded", dict(dia=True))):
        cfg = dict(mesh_shape=(n,), **kw)
        be = get_backend("torch", pjt.SolverConfig(**cfg), device="cpu")
        res = be.multi_source(be.upload(port_gg), np.arange(16))
        ref_be = ref_get_backend("jax", RefConfig(**cfg))
        ref_res = ref_be.multi_source(ref_be.upload(gg), np.arange(16))
        assert res.route == ref_res.route == name
        assert res.converged and res.dist.shape == (16, gg.num_nodes)
        assert res.iterations == ref_res.iterations
        assert res.edges_relaxed == ref_res.edges_relaxed
        np.testing.assert_allclose(res.dist.numpy(), np.asarray(ref_res.dist),
                                   rtol=1e-6)
        rows[name] = res.dist.numpy()
    assert np.allclose(rows["dia-sharded"], rows["gs-sharded"], atol=1e-4)
