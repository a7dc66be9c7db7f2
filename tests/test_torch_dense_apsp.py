"""PyTorch port: dense APSP against the JAX package on the CPU.

Blocked Floyd-Warshall (``ops.fw``: ``tile_kleene``, ``fw_apsp_blocked``,
the ``fw`` / ``fw-tile`` fan-out route and its gate), the condensed
partitioned route (``solver.partitioned``, ``condensed+fw``) and
``solve_batch`` through ``TorchBackend.batch_apsp`` (``batch-vmapped``).

Tolerances. The closure, its products and the Kleene steps compute the
reference's candidates with the same f32 adds in the same association
(min is exact), so FW and the condensed route are held bitwise to the
reference on float weights too; a float-weight difference is a bug.
``batch_apsp`` runs the reference's Jacobi sweeps over the disjoint
union, so it is bitwise as well on integer weights and held to rtol
1e-6 on float weights, where a path sum could round differently if a
sweep were ever split. Routes that associate path sums differently
from each other (``fw`` against ``dense-squaring``) agree bitwise only
on integer weights.

The reference runs with ``mesh_shape=(1,)``: the test harness gives JAX
eight CPU devices, and its FW route is single-device.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from paralleljohnson_tpu.backends import get_backend as ref_get_backend
from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import CSRGraph, erdos_renyi, grid2d, random_dag
from paralleljohnson_tpu.ops import fw as ref_fw
from paralleljohnson_tpu.solver import (
    NegativeCycleError as RefNegativeCycleError,
    ParallelJohnsonSolver as RefSolver,
)
from paralleljohnson_tpu.solver import partitioned as ref_part

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.ops import fw as port_fw
from paralleljohnson_tpu_torch.solver import partitioned as port_part
from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

from conftest import oracle_apsp

ONE = dict(mesh_shape=(1,))


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _intw(g, *, seed=1, keep_sign=False):
    """Small-integer weights (exact in f32) on ``g``'s structure;
    ``keep_sign`` keeps which edges were negative (DAG-safe)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 10, g.num_real_edges).astype(np.float32)
    if keep_sign:
        w = np.where(g.weights[:g.num_real_edges] < 0, -w, w)
    return g.with_weights(w)


def _round3(g):
    """Integer weights of the same signs: round(3 w)."""
    return g.with_weights(np.round(g.weights * 3))


def _solve_both(g, sources=None, *, predecessors=False, **kw):
    ref_cfg = RefConfig(**{**ONE, **kw})
    ref = RefSolver(ref_cfg).solve(g, sources, predecessors=predecessors)
    cfg = interop.config_from_dict(dataclasses.asdict(ref_cfg))
    port = pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(
        _port(g), sources, predecessors=predecessors)
    return ref, port


def _tile(t, seed, *, negative_diagonal=False):
    """A random f32 [t, t] matrix with +inf holes and a 0 diagonal:
    w(i, j) + p(i) - p(j) for w >= 0 and a potential p, so entries go
    negative and no cycle does; or with a negative 2-cycle on the last
    two vertices, which turns the diagonal negative in the last two
    steps (where row and column k change during step k itself) without
    overflowing f32."""
    rng = np.random.default_rng(seed)
    p = rng.random(t) * 4
    m = (rng.random((t, t)) * 10 + p[:, None] - p[None, :]).astype(np.float32)
    m[rng.random((t, t)) < 0.8] = np.inf
    np.fill_diagonal(m, 0.0)
    if negative_diagonal:
        m[t - 2, t - 1], m[t - 1, t - 2] = np.float32(-1.5), np.float32(0.25)
    return m


# -- ops.fw -------------------------------------------------------------------


@pytest.mark.parametrize("negative_diagonal", [False, True])
@pytest.mark.parametrize("t", [128, 384])
def test_tile_kleene_bitwise(t, negative_diagonal):
    """The plain loop and the wrapper on CPU tensors equal the
    reference's ``tile_kleene`` bitwise on float entries, also when a
    diagonal entry goes negative (read-before-write), at tile sizes the
    card tests hold the kernel to."""
    m = _tile(t, 3, negative_diagonal=negative_diagonal)
    want = np.asarray(ref_fw.tile_kleene(jnp.asarray(m)))
    got = port_fw.tile_kleene(torch.as_tensor(m)).numpy()
    np.testing.assert_array_equal(got, want)
    out = torch.zeros((t, t))
    assert port_fw.fw_kleene(torch.as_tensor(m), out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    assert (np.diagonal(want) < 0).any() == negative_diagonal


@pytest.mark.parametrize("t", range(128, 2049, 128))
def test_kleene_plan_fits_the_card(t):
    """Every tile size ``config.fw_tile`` allows: the rows and columns
    divide evenly over the CTAs (one column per thread), the dynamic
    shared memory fits a block's 227 KB, the cluster has at most 16 CTAs,
    and every tile of a default path (t <= DEFAULT_FW_TILE) closes in one
    cluster launch."""
    plan = port_fw.kleene_plan(t)
    assert plan.smem_bytes <= 232448
    assert 1 <= plan.cluster <= 16
    assert t % plan.rows == 0 and t % plan.cols == 0
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    if plan.variant == "cluster":
        assert plan.cluster == (port_fw.KLEENE_CTAS_DOWN
                                * port_fw.KLEENE_CTAS_ACROSS)
        assert port_fw.KLEENE_CTAS_DOWN * plan.rows == t
        assert port_fw.KLEENE_CTAS_ACROSS * plan.cols == t
        assert plan.threads == port_fw.KLEENE_THREAD_ROWS * plan.cols
        assert plan.rows // port_fw.KLEENE_THREAD_ROWS in port_fw.KLEENE_ROWS
    else:
        assert plan.variant == "step"
        assert t > port_fw.KLEENE_CLUSTER_MAX_T
    if t <= port_fw.DEFAULT_FW_TILE:
        assert plan.variant == "cluster"


@pytest.mark.parametrize("t", [1, 100, 129, 200, 300, 500])
def test_kleene_plan_pads_ragged_tiles(t):
    """A t that is not a multiple of 128 is padded to whole CTAs of whole
    warps with the fewest rows per thread that cover it, as the kernel
    takes it (square padded tile, 16-byte column pieces, the hand-over
    buffers and their two mbarriers in shared memory)."""
    plan = port_fw.kleene_plan(t)
    rr = plan.rows // port_fw.KLEENE_THREAD_ROWS
    down = port_fw.KLEENE_CTAS_DOWN * port_fw.KLEENE_THREAD_ROWS
    assert plan.variant == "cluster" and plan.cluster == 16
    assert rr == min(r for r in port_fw.KLEENE_ROWS if down * r >= t)
    assert (port_fw.KLEENE_CTAS_DOWN * plan.rows
            == port_fw.KLEENE_CTAS_ACROSS * plan.cols >= t)
    assert plan.cols % 32 == 0 and rr % 4 == 0
    assert plan.threads == port_fw.KLEENE_THREAD_ROWS * plan.cols
    assert plan.smem_bytes == 16 + 4 * (2 * plan.cols + 3 * plan.rows)


def test_fw_kleene_cpu_ignores_scratch():
    """On CPU tensors the closure takes ``tile_kleene`` whatever scratch
    it is given."""
    m = torch.as_tensor(_tile(128, 4))
    want = port_fw.tile_kleene(m)
    for scratch in (None, torch.empty(0)):
        got = port_fw.fw_kleene(m, scratch=scratch)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [100, 256, 384])
def test_fw_apsp_blocked_bitwise_float(n):
    """nb = 1, 2 and 3 tiles of 128 (100 pads to one tile): bitwise the
    reference's closure on float weights with negative entries."""
    a = _tile(n, n)
    ref_closed, ref_neg = ref_fw.fw_closure(
        ref_fw.pad_dense(jnp.asarray(a), 128), tile=128)
    got, neg = port_fw.fw_closure(
        port_fw.pad_dense(torch.as_tensor(a), 128), tile=128)
    assert neg is bool(ref_neg) is False
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_closed))


def test_fw_negative_cycle_flag(neg_cycle_graph):
    """A negative cycle raises the flag in both packages, and the blocked
    closure leaves its input alone (fw_closure) or closes it in place
    (fw_apsp_blocked)."""
    g = neg_cycle_graph
    a = np.full((4, 4), np.inf, np.float32)
    np.fill_diagonal(a, 0.0)
    a[g.src, g.indices] = g.weights
    _, ref_neg = ref_fw.fw_closure(ref_fw.pad_dense(jnp.asarray(a), 128),
                                   tile=128)
    padded = port_fw.pad_dense(torch.as_tensor(a), 128)
    before = padded.clone()
    _, neg = port_fw.fw_closure(padded, tile=128)
    assert neg is bool(ref_neg) is True
    assert torch.equal(padded, before)
    closed, neg = port_fw.fw_apsp_blocked(padded, tile=128)
    assert closed is padded and neg


@pytest.mark.parametrize("fn", ["pad_tiles", "effective_tile", "fw_mac_count",
                                "fw_analytic_cost"])
def test_fw_helpers_equal(fn):
    for v in (1, 90, 128, 200, 300, 512, 513, 1024, 2048, 5000, 16384):
        for tile in (128, 256, 384, 512, 1024):
            args = (v, tile)
            if fn in ("fw_mac_count", "fw_analytic_cost"):
                args = (ref_fw.pad_tiles(v, tile), tile)
            assert getattr(port_fw, fn)(*args) == getattr(ref_fw, fn)(*args)
    if fn == "effective_tile":
        assert port_fw.effective_tile(300, None) == ref_fw.effective_tile(
            300, None)
    if fn == "fw_mac_count":
        with pytest.raises(ValueError):
            port_fw.fw_mac_count(300, 128)
    assert (port_fw.FW_TILE, port_fw.DEFAULT_FW_TILE, port_fw.FW_KBLOCK) == (
        ref_fw.FW_TILE, 512, ref_fw.FW_KBLOCK)


# -- the fw route -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _gate_graph(v, p):
    return _intw(erdos_renyi(v, p, seed=4))


GATE_TABLE = [  # (V, B, density, fw, fw_threshold, fw_tile)
    (1536, 1536, 0.1, "auto", 1 << 14, None),
    (1536, 16, 0.1, "auto", 1 << 14, None),      # iterate regime
    (1536, 1536, 0.004, "auto", 1 << 14, None),  # density gate
    (40, 40, 0.2, "auto", 1 << 14, None),        # squaring counts win
    (1536, 1536, 0.1, "auto", 512, None),        # beyond fw_threshold
    (300, 300, 0.2, "auto", 1 << 14, None),      # one 384 tile wins
    (300, 300, 0.2, "auto", 1 << 14, 128),       # three 128 tiles
    (40, 40, 0.2, True, 1 << 14, None),          # forced
    (1536, 1536, 0.1, False, 1 << 14, None),     # disabled
]


@pytest.mark.parametrize("v,b,p,flag,threshold,tile", GATE_TABLE)
def test_use_fw_matches_reference(v, b, p, flag, threshold, tile):
    g = _gate_graph(v, p)
    ref_cfg = RefConfig(fw=flag, fw_threshold=threshold, fw_tile=tile, **ONE)
    ref_be = ref_get_backend("jax", ref_cfg)
    port_be = pjt.get_backend(
        "torch", interop.config_from_dict(dataclasses.asdict(ref_cfg)),
        device="cpu")
    want = ref_be._use_fw(ref_be.upload(g), b)
    assert port_be._use_fw(port_be.upload(_port(g)), b) == want


FORCED = {  # name -> (graph, config overrides, route)
    "fw": (lambda: erdos_renyi(90, 0.2, seed=1), {"fw_tile": 128}, "fw"),
    "fw-tile": (lambda: erdos_renyi(200, 0.12, seed=2), {"fw_tile": 128},
                "fw-tile"),
    "fw-tile-johnson": (lambda: random_dag(160, 0.08, negative_fraction=0.35,
                                           seed=5), {"fw_tile": 128},
                        "fw-tile"),
}


@pytest.mark.parametrize("name", sorted(FORCED))
def test_forced_fw_solve_matches_reference(name):
    """Forced fw on float weights: tags, counters and matrices equal
    (the negative-weight graph reweights first, then takes fw)."""
    make, kw, route = FORCED[name]
    g = make()
    ref, port = _solve_both(g, fw=True, **kw)
    assert port.stats.routes_by_phase == ref.stats.routes_by_phase
    assert port.stats.routes_by_phase["fanout"] == route
    assert dict(port.stats.iterations_by_phase) == dict(
        ref.stats.iterations_by_phase)
    assert port.stats.edges_relaxed == ref.stats.edges_relaxed
    np.testing.assert_array_equal(port.matrix, np.asarray(ref.matrix))


def test_default_config_dense_er_takes_fw_in_both():
    """The squaring regime of a dense ER with float weights at default
    config: both packages take ``fw`` (one 384 tile), matrices bitwise
    equal, and the squaring route agrees within rtol 1e-6."""
    g = erdos_renyi(300, 0.2, seed=7)
    ref, port = _solve_both(g)
    assert ref.stats.routes_by_phase["fanout"] == "fw"
    assert port.stats.routes_by_phase["fanout"] == "fw"
    np.testing.assert_array_equal(port.matrix, np.asarray(ref.matrix))
    sq = pjt.ParallelJohnsonSolver(pjt.SolverConfig(fw=False),
                                   device="cpu").solve(_port(g))
    assert sq.stats.routes_by_phase["fanout"] == "dense-squaring-pallas"
    np.testing.assert_allclose(port.matrix, sq.matrix, rtol=1e-6)


def test_fw_pred_trees_valid_and_equal():
    """``fw-tile+pred``: one tight-edge pass after the closure; the trees
    are the reference's and valid."""
    g = _intw(random_dag(100, 0.12, negative_fraction=0.35, seed=9),
              seed=2, keep_sign=True)
    ref, port = _solve_both(g, predecessors=True, fw=True, fw_tile=128)
    assert port.stats.routes_by_phase == ref.stats.routes_by_phase
    assert port.stats.routes_by_phase["fanout"] == "fw+pred"
    np.testing.assert_array_equal(to_numpy(port.dist), np.asarray(ref.dist))
    np.testing.assert_array_equal(to_numpy(port.predecessors),
                                  np.asarray(ref.predecessors))
    validate_pred_tree(_port(g), to_numpy(port.dist),
                       to_numpy(port.predecessors), port.sources)


def test_fw_auto_failure_degrades_forced_raises(monkeypatch):
    """An fw build that raises: ``"auto"`` warns once and falls through
    to the dense route, ``fw=True`` propagates."""
    from paralleljohnson_tpu_torch.backends import torch_backend

    def broken(*a, **k):
        raise RuntimeError("injected fw failure")

    monkeypatch.setattr(torch_backend, "_fw_apsp_kernel", broken)
    g = _port(erdos_renyi(300, 0.2, seed=7))
    solver = pjt.ParallelJohnsonSolver(device="cpu")
    with pytest.warns(RuntimeWarning, match="Floyd-Warshall"):
        res = solver.solve(g)
    assert res.stats.routes_by_phase["fanout"] == "dense-squaring-pallas"
    assert solver.backend._fw_disabled
    with pytest.raises(RuntimeError, match="injected"):
        pjt.ParallelJohnsonSolver(pjt.SolverConfig(fw=True),
                                  device="cpu").solve(g)


# -- the condensed route ------------------------------------------------------


def _condensed_both(g, sources=None, **kw):
    ref = ref_part.solve_condensed(g, sources, config=RefConfig(**ONE), **kw)
    port = port_part.solve_condensed(_port(g), sources,
                                     config=pjt.SolverConfig(), device="cpu",
                                     **kw)
    return ref, port


def _two_components():
    a = _intw(grid2d(6, 6, seed=1))
    e = a.num_real_edges
    return CSRGraph.from_edges(
        np.concatenate([a.src[:e], a.src[:e] + 36]),
        np.concatenate([a.indices[:e], a.indices[:e] + 36]),
        np.concatenate([a.weights[:e], a.weights[:e]]), 72)


CONDENSED = {  # name -> (graph, sources)
    "grid-int-negative": (lambda: _round3(
        grid2d(12, 12, negative_fraction=0.2, seed=3)), None),
    "grid-float-negative": (lambda: grid2d(12, 12, negative_fraction=0.2,
                                           seed=5), None),
    "er-subset-duplicates": (lambda: _intw(erdos_renyi(150, 0.015, seed=9),
                                           seed=2), np.array([5, 3, 3, 77])),
    "disconnected-parts": (_two_components, None),
}


@pytest.mark.parametrize("name", sorted(CONDENSED))
def test_condensed_matches_reference(name):
    """Same partition, same closures, same products: bitwise on integer
    and float weights, with the same counters."""
    make, sources = CONDENSED[name]
    g = make()
    (rd, _, ri), (pd, _, pi) = _condensed_both(g, sources, num_parts=4)
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(
        port_part.partition_by_pivots(_port(g), 4),
        ref_part.partition_by_pivots(g, 4))
    for key in ("route", "macs", "k_steps", "num_parts", "core_size",
                "part_sizes", "expand_products_skipped",
                "expand_macs_skipped", "params"):
        assert pi[key] == ri[key], key
    assert set(pi["seconds"]) == {"partition", "local_closures",
                                  "core_closure", "expansion"}
    if name.endswith("int-negative") or name == "er-subset-duplicates":
        want = oracle_apsp(g)
        np.testing.assert_array_equal(
            pd, want if sources is None else want[sources])


def _cycle_in_part():
    edges = [(0, 1, 1.0), (1, 2, 2.0), (2, 3, -4.0), (3, 1, 1.0)] + [
        (i, i + 1, 1.0) for i in range(4, 20)]
    s, d, w = zip(*edges)
    return CSRGraph.from_edges(s, d, w, 21), 3, 0


def _cycle_across_parts():
    n = 10
    w = [1.0] * (n - 1) + [-float(n)]
    return CSRGraph.from_edges(list(range(n)), [(i + 1) % n for i in range(n)],
                               w, n), 3, 1


@pytest.mark.parametrize("make", [_cycle_in_part, _cycle_across_parts],
                         ids=["within-part", "across-parts"])
def test_condensed_negative_cycle_raises_in_both(make):
    g, parts, seed = make()
    with pytest.raises(RefNegativeCycleError):
        ref_part.solve_condensed(g, num_parts=parts, config=RefConfig(**ONE),
                                 seed=seed)
    with pytest.raises(pjt.NegativeCycleError):
        port_part.solve_condensed(_port(g), num_parts=parts,
                                  config=pjt.SolverConfig(), seed=seed,
                                  device="cpu")


def test_condensed_defaults_to_the_card(monkeypatch):
    """Like ``ParallelJohnsonSolver``, ``solve_condensed`` runs on the card
    unless asked for the CPU, and raises rather than fall back without
    one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_part.solve_condensed(_port(_intw(grid2d(6, 6, seed=1))),
                                  config=pjt.SolverConfig())


def test_condensed_predecessors_match_reference():
    g = _intw(random_dag(60, 0.15, negative_fraction=0.4, seed=17), seed=19,
              keep_sign=True)
    (rd, rp, ri), (pd, pp, pi) = _condensed_both(g, predecessors=True,
                                                 num_parts=3)
    assert pi["route"] == ri["route"] == "condensed+fw+pred"
    assert pi["pred_ok"] and ri["pred_ok"]
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(pp, rp)
    validate_pred_tree(_port(g), pd, pp, np.arange(g.num_nodes))


def test_solver_condensed_route_tag_counters_and_plan():
    """``partitioned=True`` through the solver: the reference's tag and
    counters, the matrix bitwise, and the decision in ``stats.plan``."""
    g = _intw(grid2d(14, 14, seed=4))
    ref, port = _solve_both(g, partitioned=True)
    assert port.stats.routes_by_phase == ref.stats.routes_by_phase == {
        "fanout": "condensed+fw"}
    assert port.stats.edges_relaxed == ref.stats.edges_relaxed
    assert dict(port.stats.iterations_by_phase) == dict(
        ref.stats.iterations_by_phase)
    np.testing.assert_array_equal(port.matrix, np.asarray(ref.matrix))
    plan = port.stats.plan
    assert plan["chosen"] == "condensed+fw" and "forces" in plan["reason"]
    assert plan["params"] == ref.stats.plan["params"]
    assert plan["params_source"] == {"fw_tile": "default",
                                     "partition_parts": "default"}


def test_condensed_auto_is_off():
    """``"auto"`` stays off here (TPU-only in the reference, and off in
    it on this CPU too); ``False`` pins the standard route."""
    g = _intw(grid2d(40, 40, seed=2))  # V = 1600: in the reference's range
    for flag in ("auto", False):
        solver = pjt.ParallelJohnsonSolver(pjt.SolverConfig(partitioned=flag),
                                           device="cpu")
        taken, reason = solver._use_partitioned(_port(g), np.arange(1600))
        assert not taken and reason
    ref = RefSolver(RefConfig(**ONE))
    assert not ref._use_partitioned(g, np.arange(1600))
    res = pjt.ParallelJohnsonSolver(device="cpu").solve(_port(g),
                                                        np.arange(8))
    assert res.stats.plan["chosen"] == "standard"
    assert "condensed" not in res.stats.routes_by_phase["fanout"]


# -- solve_batch --------------------------------------------------------------


def _batch(integer, *, negative=True):
    """8 graphs of 32-64 vertices, one of them with negative weights."""
    graphs = []
    for i, n in enumerate((32, 40, 48, 56, 64, 33, 47, 64)):
        if negative and i == 3:
            g = random_dag(n, 0.15, negative_fraction=0.35, seed=i)
        else:
            g = erdos_renyi(n, 0.1, seed=i)
        graphs.append(_intw(g, seed=i, keep_sign=True) if integer else g)
    return graphs


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
def test_solve_batch_matches_reference(integer):
    graphs = _batch(integer)
    ref_solver = RefSolver(RefConfig(**ONE))
    want = ref_solver.solve_batch(graphs)
    got = pjt.ParallelJohnsonSolver(device="cpu").solve_batch(
        [_port(g) for g in graphs])
    assert len(got) == len(graphs)
    assert got[0].stats.routes_by_phase == want[0].stats.routes_by_phase == {
        "batch_apsp": "batch-vmapped"}
    assert (got[0].stats.iterations_by_phase["batch_apsp"]
            == want[0].stats.iterations_by_phase["batch_apsp"])
    for g, a, b in zip(graphs, got, want):
        assert to_numpy(a.dist).shape == (g.num_nodes, g.num_nodes)
        if integer:
            np.testing.assert_array_equal(to_numpy(a.dist), np.asarray(b.dist))
        else:
            np.testing.assert_allclose(to_numpy(a.dist), np.asarray(b.dist),
                                       rtol=1e-6)
        np.testing.assert_allclose(to_numpy(a.dist), oracle_apsp(g),
                                   rtol=1e-5, atol=1e-4)


def test_solve_batch_slabs_and_negative_cycle(neg_cycle_graph, monkeypatch):
    """Several slabs give the one-slab result; a batch holding a negative
    cycle raises in both packages."""
    from paralleljohnson_tpu_torch.backends import torch_backend

    graphs = [_port(g) for g in _batch(True)]
    one = pjt.ParallelJohnsonSolver(device="cpu").solve_batch(graphs)
    monkeypatch.setattr(torch_backend, "CPU_BUDGET_BYTES",
                        3 * torch_backend.BATCH_APSP_BLOCKS * 64 * 64 * 4)
    many = pjt.ParallelJohnsonSolver(device="cpu").solve_batch(graphs)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(to_numpy(a.dist), to_numpy(b.dist))
    assert (many[0].stats.iterations_by_phase
            == one[0].stats.iterations_by_phase)
    bad = _batch(True)[:3] + [neg_cycle_graph]
    with pytest.raises(RefNegativeCycleError):
        RefSolver(RefConfig(**ONE)).solve_batch(bad)
    with pytest.raises(pjt.NegativeCycleError):
        pjt.ParallelJohnsonSolver(device="cpu").solve_batch(
            [_port(g) for g in bad])
