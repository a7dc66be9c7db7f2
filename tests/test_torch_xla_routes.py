"""PyTorch port: the JAX package's XLA fan-out routes in plain PyTorch,
on the CPU against the reference's same routes.

``use_pallas=False`` takes ``dense-*`` (the plain min-plus product) on
dense graphs, ``vm-blocked`` above ``VM_BLOCK`` vertices and ``vm`` below;
``fanout_layout="source_major"`` takes ``sweep-sm``. Both packages run the
same route on the same graph: distances bitwise (integer weights), the
same route tags and the same sweep counts (the port keeps the reference's
edge chunks, so its chunk-level Gauss-Seidel takes the same steps).
``VM_BLOCK`` is lowered in both packages so that small graphs reach
``vm-blocked``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from paralleljohnson_tpu.backends import jax_backend
from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import erdos_renyi, load_graph, random_dag
from paralleljohnson_tpu.ops import relax as ref_relax
from paralleljohnson_tpu.solver import (
    ConvergenceError as RefConvergenceError,
    ParallelJohnsonSolver as RefSolver,
)

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.backends import torch_backend
from paralleljohnson_tpu_torch.ops import relax as port_relax
from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

XLA = dict(use_pallas=False, mesh_shape=(1,), fw=False, frontier=False,
           dia=False, gauss_seidel=False, bucket=False, dirty_window=False)
VB = 64  # VM_BLOCK in both packages for the vm-blocked cases


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _int(g):
    return g.with_weights(np.round(g.weights))


GRAPHS = {
    "dag-neg-int": lambda: _int(random_dag(150, 0.04, negative_fraction=0.4,
                                           seed=3)),
    "rmat-int": lambda: _int(load_graph("rmat:scale=8,ef=8,seed=2")),
    "grid-int": lambda: load_graph("grid:rows=12,cols=14,seed=1").with_weights(
        np.floor(load_graph("grid:rows=12,cols=14,seed=1").weights) + 1),
    "er-dense-int": lambda: _int(erdos_renyi(64, 0.15, seed=5)),
}

ROUTES = {  # route -> (config overrides, graphs that reach it)
    "vm": ({}, ["dag-neg-int", "rmat-int", "grid-int"]),
    "vm-blocked": ({}, ["dag-neg-int", "rmat-int", "grid-int"]),
    "sweep-sm": ({"fanout_layout": "source_major"},
                 ["dag-neg-int", "rmat-int", "grid-int"]),
    "dense": ({}, ["er-dense-int"]),
}
CASES = [(r, n) for r, (_, names) in ROUTES.items() for n in names]


@pytest.fixture
def vm_block(monkeypatch):
    """Lower VM_BLOCK in both packages (vm-blocked above it)."""
    monkeypatch.setattr(jax_backend, "VM_BLOCK", VB)
    monkeypatch.setattr(torch_backend, "VM_BLOCK", VB)


def _solvers(route, **overrides):
    ref_cfg = RefConfig(**{**XLA, **ROUTES[route][0], **overrides})
    cfg = interop.config_from_dict(dataclasses.asdict(ref_cfg))
    return RefSolver(ref_cfg), pjt.ParallelJohnsonSolver(cfg, device="cpu")


def _want_route(route, port):
    fanout = port.stats.routes_by_phase["fanout"]
    if route == "dense":
        assert fanout.startswith("dense-") and not fanout.endswith("-pallas")
    else:
        assert fanout.split("+")[0] == route


@pytest.mark.parametrize("route,name", CASES)
def test_xla_route_matches_reference(request, route, name):
    if route == "vm-blocked":
        request.getfixturevalue("vm_block")
    g = GRAPHS[name]()
    sources = np.arange(0, g.num_nodes, 3)
    ref, port = _solvers(route)
    want = ref.solve(g, sources)
    got = port.solve(_port(g), sources)
    _want_route(route, got)
    assert got.stats.routes_by_phase == want.stats.routes_by_phase
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))
    assert got.stats.iterations_by_phase == want.stats.iterations_by_phase
    assert got.stats.edges_relaxed == want.stats.edges_relaxed


@pytest.mark.parametrize("route,name", [("vm", "rmat-int"),
                                        ("vm-blocked", "grid-int"),
                                        ("sweep-sm", "dag-neg-int"),
                                        ("dense", "er-dense-int")])
def test_xla_route_pred_matches_reference(request, route, name):
    """Extraction rides every route: ``<route>+pred``, trees equal to the
    reference's and valid."""
    if route == "vm-blocked":
        request.getfixturevalue("vm_block")
    g = GRAPHS[name]()
    sources = np.arange(0, g.num_nodes, 5)
    ref, port = _solvers(route)
    want = ref.solve(g, sources, predecessors=True)
    got = port.solve(_port(g), sources, predecessors=True)
    assert got.stats.routes_by_phase["fanout"].endswith("+pred")
    assert got.stats.routes_by_phase == want.stats.routes_by_phase
    np.testing.assert_array_equal(to_numpy(got.dist), np.asarray(want.dist))
    np.testing.assert_array_equal(to_numpy(got.predecessors),
                                  np.asarray(want.predecessors))
    validate_pred_tree(_port(g), to_numpy(got.dist),
                       to_numpy(got.predecessors), sources)


@pytest.mark.parametrize("name", ["dag-neg-int", "rmat-int"])
def test_vm_blocked_equals_pallas_vm_rows(vm_block, name):
    g = _port(GRAPHS[name]())
    hand = pjt.ParallelJohnsonSolver(device="cpu").solve(g)
    xla = pjt.ParallelJohnsonSolver(pjt.SolverConfig(use_pallas=False),
                                    device="cpu").solve(g)
    assert hand.stats.routes_by_phase["fanout"] == "pallas-vm"
    assert xla.stats.routes_by_phase["fanout"] == "vm-blocked"
    np.testing.assert_array_equal(xla.matrix, hand.matrix)


@pytest.mark.parametrize("vb,ec", [(64, 128), (100, 37)])
def test_vm_blocked_layouts_and_sweeps_match_reference(vb, ec):
    """The host builder equals the reference's array for array; the
    device builder (torch ops, here on the CPU) equals the host one; one
    blocked sweep and one vm sweep equal the reference's bitwise."""
    g = _int(load_graph("rmat:scale=9,ef=8,seed=4"))
    e = g.num_real_edges
    want = ref_relax.build_vm_blocked_layout(g.indptr, g.indices,
                                             g.num_nodes, vb=vb, ec=ec)
    host = port_relax.build_vm_blocked_layout(g.indptr, g.indices,
                                              g.num_nodes, vb=vb, ec=ec)
    for key in ("src_ck", "dstl_ck", "base_ck", "edge_order"):
        np.testing.assert_array_equal(host[key], want[key])
    counts = np.bincount(g.indices[:e] // vb,
                         minlength=-(-g.num_nodes // vb))
    w = torch.as_tensor(g.weights[:e])
    dev = port_relax.build_vm_blocked_layout_device(
        torch.as_tensor(g.src[:e]), torch.as_tensor(g.indices[:e]), w,
        counts, vb=vb, ec=ec)
    for key in ("src_ck", "dstl_ck"):
        np.testing.assert_array_equal(dev[key].numpy(), host[key])
    np.testing.assert_array_equal(dev["base_ck"], host["base_ck"])
    order = host["edge_order"]
    w_host = np.where(order >= 0, g.weights[np.maximum(order, 0)], np.inf)
    np.testing.assert_array_equal(dev["w_ck"].numpy(), w_host)
    w2 = w * 2
    np.testing.assert_array_equal(
        port_relax.regather_vm_blocked_weights(
            w2, dev["order"], dev["slots"], dev["src_ck"].numel(),
            tuple(dev["src_ck"].shape)).numpy(), w_host * 2)

    b = 6
    v_pad = vb * -(-g.num_nodes // vb)
    d = np.full((v_pad, b), np.inf, np.float32)
    d[np.arange(b) * 7, np.arange(b)] = 0.0
    for _ in range(2):  # two sweeps in: finite values to fold
        ref_d = ref_relax.relax_sweep_vm_blocked(
            jnp.asarray(d), *(jnp.asarray(host[k]) for k in
                              ("src_ck", "dstl_ck")),
            jnp.asarray(w_host.astype(np.float32)),
            jnp.asarray(host["base_ck"]), vb=vb)
        got = port_relax.relax_sweep_vm_blocked(
            torch.as_tensor(d), dev["src_ck"], dev["dstl_ck"], dev["w_ck"],
            host["base_ck"], vb=vb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_d))
        d = got.numpy()

    by = np.argsort(g.indices[:e], kind="stable")
    coo = [g.src[:e][by], g.indices[:e][by], g.weights[:e][by]]
    d = d[:g.num_nodes]
    ref_d = ref_relax.relax_sweep_vm(jnp.asarray(d),
                                     *(jnp.asarray(x) for x in coo),
                                     edge_chunk=ec)
    got = port_relax.relax_sweep_vm(torch.as_tensor(d),
                                    *(torch.as_tensor(x) for x in coo),
                                    edge_chunk=ec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_d))


def test_vm_blocked_device_build_and_reweight(vm_block, monkeypatch):
    """The device builder's route equals the host builder's; the layout
    structure survives reweighting (same object), its weights do not."""
    g = _port(GRAPHS["dag-neg-int"]())
    cfg = pjt.SolverConfig(use_pallas=False)
    host = pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(g)
    monkeypatch.setattr(torch_backend, "VMB_DEVICE_BUILD_MIN_EDGES", 0)
    backend = pjt.get_backend("torch", cfg, device="cpu")
    solver = pjt.ParallelJohnsonSolver(cfg, backend=backend)
    dev = solver.solve(g)
    assert dev.stats.routes_by_phase["fanout"] == "vm-blocked"
    np.testing.assert_array_equal(dev.matrix, host.matrix)

    dg = backend.upload(g)
    lay = dg.vm_blocked_layout(VB, 128)
    rew = backend.reweight(dg, torch.zeros(g.num_nodes) + 0.5 *
                           torch.arange(g.num_nodes))
    lay2 = rew.vm_blocked_layout(VB, 128)
    assert lay2["src_ck"] is lay["src_ck"]
    assert not torch.equal(lay2["w_ck"], lay["w_ck"])
    backend.clear_caches(rew)
    assert not rew._struct_cache and not rew._by_dst_cache


@pytest.mark.parametrize("route", ["vm", "sweep-sm"])
def test_xla_convergence_cap_raises_in_both(route):
    g = GRAPHS["rmat-int"]()
    ref, port = _solvers(route, max_iterations=2)
    with pytest.raises(RefConvergenceError):
        ref.solve(g)
    with pytest.raises(pjt.ConvergenceError):
        port.solve(_port(g))
