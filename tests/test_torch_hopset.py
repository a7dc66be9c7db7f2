"""PyTorch port: the certified approximate tier (``ops/hopset.py``,
``solver/approx.py``) against the JAX package's, on the reference's cases
(``tests/test_hopset.py``).

Bitwise equal across the packages: ``bounded_hop_rows`` (rows,
``iterations``, ``converged``, ``examined``) at the default ``edge_chunk``
and at small ones where several chunks run (the sweep is chunk-level
Gauss-Seidel: the port launches the fan-out sweep once per chunk, chained
through the carry), the built hopset, and ``approx_apsp``'s ``dist`` and
``max_error``. Equal: the budget planner's chosen plan at budget 0, at a
positive budget and under both forces. Every certificate is held against
scipy's exact rows. Each package loads the other's ``hopset.npz``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import CSRGraph, erdos_renyi, grid2d
from paralleljohnson_tpu.ops import hopset as ref_hs
from paralleljohnson_tpu.solver import approx as ref_approx

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop, planner
from paralleljohnson_tpu_torch.observe.store import CostModel, ProfileStore
from paralleljohnson_tpu_torch.ops import fanout_sweep
from paralleljohnson_tpu_torch.ops import hopset as hs
from paralleljohnson_tpu_torch.ops import relax
from paralleljohnson_tpu_torch.solver import approx
from paralleljohnson_tpu_torch.solver.johnson import to_numpy

from conftest import oracle_apsp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU, and an oversubscribed torch thread pool slows small solves by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _bits(a):
    return np.ascontiguousarray(a).tobytes()


def _assert_certified(est, err, exact, *, context=""):
    """Wherever ``max_error`` is finite: the estimate's reachability is
    the truth's, and ``|estimate - exact| <= max_error``."""
    certified = np.isfinite(err)
    finite_agrees = np.isfinite(exact) == np.isfinite(est)
    assert bool(np.all(finite_agrees[certified])), context
    both = certified & np.isfinite(exact) & np.isfinite(est)
    assert bool(np.all(np.abs(est[both] - exact[both]) <= err[both])), context


def _two_components():
    a = grid2d(4, 4, seed=2)
    e = a.num_real_edges
    s, d, w = a.src, a.indices[:e], a.weights[:e]
    return CSRGraph.from_edges(np.concatenate([s, s + 16]),
                               np.concatenate([d, d + 16]),
                               np.concatenate([w, w]), 32)


# -- bounded-hop rows ---------------------------------------------------------


GRAPHS = {
    "grid": lambda: grid2d(20, 12, seed=3),
    "er": lambda: erdos_renyi(96, 0.05, seed=11),
    "corridor": lambda: grid2d(64, 4, seed=23),
}


@pytest.mark.parametrize("edge_chunk", [1 << 20, 64, 7])
@pytest.mark.parametrize("beta", [4, 9, 300])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bounded_hop_rows_bitwise_reference(graph, beta, edge_chunk):
    """Rows, iterations, converged and examined are the reference's, at
    one chunk and at several (the chunked sweep converges in fewer sweeps
    than a Jacobi one, and rows cut at the cap are tighter)."""
    g = GRAPHS[graph]()
    sources = np.array([0, 5, g.num_nodes // 2, g.num_nodes - 1])
    ref = ref_hs.bounded_hop_rows(g, sources, beta=beta,
                                  edge_chunk=edge_chunk)
    port = hs.bounded_hop_rows(_port(g), sources, beta=beta,
                               edge_chunk=edge_chunk, device="cpu")
    assert _bits(np.asarray(ref[0])) == _bits(port[0])
    assert port[1:] == (int(ref[1]), bool(ref[2]), int(ref[3]))


def test_chunking_changes_rows_cut_at_the_cap():
    """The chunking trap: below the fixpoint a multi-chunk sweep reaches
    further than a Jacobi one, so the rows differ from the one-chunk
    rows, exactly as the reference's do."""
    g = grid2d(64, 4, seed=23)
    src = np.array([0])
    one = hs.bounded_hop_rows(_port(g), src, beta=6, device="cpu")
    many = hs.bounded_hop_rows(_port(g), src, beta=6, edge_chunk=64,
                               device="cpu")
    assert not one[2] and not many[2]
    assert np.isfinite(many[0]).sum() > np.isfinite(one[0]).sum()
    assert np.all(many[0] <= one[0])


def test_seeded_rows_bitwise_and_exact_at_fixpoint():
    g = grid2d(12, 12, seed=9)
    sources = np.array([3, 70])
    seed = np.full((2, g.num_nodes), np.inf, np.float32)
    seed[0, 100] = 40.0
    seed[1, 5] = 7.5
    ref = ref_hs.bounded_hop_rows(g, sources, beta=400, seed_rows=seed)
    port = hs.bounded_hop_rows(_port(g), sources, beta=400, seed_rows=seed,
                               device="cpu")
    assert _bits(np.asarray(ref[0])) == _bits(port[0])
    assert port[2] is True and port[1] == int(ref[1])


def test_chunked_fixpoint_equals_its_plain_version():
    """The fixpoint the card runs (``fanout_fixpoint_chunks`` over
    ``hop_chunks``' layouts: grouped sweeps, shared flags) and the plain
    chunk-level Gauss-Seidel sweep in torch ops
    (``relax.bellman_ford_sweeps_vm`` over the edges in stable
    destination order, built here from the graph's arrays) agree on
    rows, iterations and the flag, on the CPU."""
    g = _port(grid2d(30, 6, seed=4))
    chunks = hs.hop_chunks(g, edge_chunk=50, device="cpu")
    assert len(chunks) > 1
    e = g.num_real_edges
    order = np.argsort(g.indices[:e], kind="stable")
    src, dst, w = (torch.as_tensor(np.asarray(a[:e])[order])
                   for a in (g.src, g.indices, g.weights))
    for beta in (3, 17, 500):
        d0 = torch.full((g.num_nodes, 3), np.inf, dtype=torch.float32)
        d0[[0, 9, 100], [0, 1, 2]] = 0.0
        a = fanout_sweep.fanout_fixpoint_chunks(d0.clone(), chunks,
                                                max_iter=beta)
        b = relax.bellman_ford_sweeps_vm(d0.clone(), src, dst, w,
                                         max_iter=beta, edge_chunk=50)
        assert torch.equal(a[0], b[0]) and a[1:] == b[1:]


def test_empty_and_edgeless_cases_match_reference():
    g = grid2d(4, 4, seed=1)
    empty = hs.bounded_hop_rows(_port(g), np.zeros(0, np.int64), beta=4,
                                device="cpu")
    assert empty[0].shape == (0, 16) and empty[1:] == (0, True, 0)
    bare = CSRGraph.from_edges([], [], [], 5)
    ref = ref_hs.bounded_hop_rows(bare, np.array([1, 3]), beta=4)
    port = hs.bounded_hop_rows(_port(bare), np.array([1, 3]), beta=4,
                               device="cpu")
    assert _bits(np.asarray(ref[0])) == _bits(port[0])
    assert port[1:] == tuple(ref[1:])


# -- the hopset and approx_apsp ----------------------------------------------


@pytest.mark.parametrize("picker", ["uniform", "coverage", "boundary"])
def test_build_hopset_bitwise_reference(picker):
    g = grid2d(10, 8, seed=23)
    ref = ref_hs.build_hopset(g, epsilon=0.5, k=6, beta=8, seed=5,
                              picker=picker)
    port = hs.build_hopset(_port(g), epsilon=0.5, k=6, beta=8, seed=5,
                           picker=picker, device="cpu")
    for field in ("pivots", "fwd", "rev"):
        assert _bits(getattr(port, field)) == _bits(getattr(ref, field))
    for field in ("epsilon", "beta", "converged", "nonnegative", "digest",
                  "picker", "seed", "edges_examined"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.num_hopset_edges == ref.num_hopset_edges
    assert _bits(port.relay_rows(np.arange(10))) == \
        _bits(ref.relay_rows(np.arange(10)))


@pytest.mark.parametrize("case,eps", [
    ("grid", 0.5), ("corridor", 0.1), ("corridor", 0.5), ("er", 0.3),
    ("components", 0.5)])
def test_approx_apsp_bitwise_reference_and_certified(case, eps):
    g = _two_components() if case == "components" else GRAPHS[case]()
    rng = np.random.default_rng(7)
    sources = np.sort(rng.choice(g.num_nodes, size=min(16, g.num_nodes),
                                 replace=False))
    ref = ref_approx.approx_apsp(g, sources,
                                 config=RefConfig(backend="numpy"),
                                 epsilon=eps)
    port = approx.approx_apsp(_port(g), sources, epsilon=eps, device="cpu")
    assert _bits(port.dist) == _bits(ref.dist)
    assert _bits(port.max_error) == _bits(ref.max_error)
    assert port.converged == ref.converged
    for key in ("beta", "k", "hopset_edges", "hopset_converged",
                "query_converged", "edges_examined", "batches"):
        assert port.stats[key] == ref.stats[key], key
    _assert_certified(port.dist, port.max_error, oracle_apsp(g)[sources],
                      context=case)


def test_unreachable_never_silently_bounded():
    g = _two_components()
    res = approx.approx_apsp(_port(g), np.arange(16, dtype=np.int64),
                             epsilon=0.5, device="cpu")
    certified = np.isfinite(res.max_error[:, 16:])
    assert bool(np.all(np.isinf(res.dist[:, 16:][certified])))


def test_converged_result_is_exact_to_f32():
    g = grid2d(4, 4, seed=5)
    res = approx.approx_apsp(_port(g), None, epsilon=0.5, device="cpu")
    assert res.converged and res.exact
    assert np.allclose(res.dist, oracle_apsp(g), rtol=1e-5, atol=1e-5)


def test_landmark_composition_bitwise_reference():
    """Composing a landmark index into the bounds (tighter wins per entry)
    keeps both packages bitwise alike."""
    from paralleljohnson_tpu.serve import LandmarkIndex as RefIndex

    g = grid2d(64, 4, seed=23)
    ref_lm = RefIndex.build(g, 4, config=RefConfig(backend="numpy"), seed=2)
    lm = interop.landmarks_from_arrays(ref_lm.sources, ref_lm.fwd,
                                       ref_lm.rev,
                                       nonnegative=ref_lm.nonnegative,
                                       digest=ref_lm.digest)
    src = np.array([0, 100, 255])
    # A small hopset (k = 2, beta = 4): the query sweep stops at its cap,
    # so every row is finished through the composed intervals.
    ref_hop = ref_hs.build_hopset(g, epsilon=0.5, k=2, beta=4, seed=1)
    hop = interop.hopset_from_arrays(**dataclasses.asdict(ref_hop))
    ref = ref_approx.approx_apsp(g, src, config=RefConfig(backend="numpy"),
                                 hopset=ref_hop, landmarks=ref_lm)
    port = approx.approx_apsp(_port(g), src, hopset=hop, landmarks=lm,
                              device="cpu")
    assert not port.converged
    assert _bits(port.dist) == _bits(ref.dist)
    assert _bits(port.max_error) == _bits(ref.max_error)


# -- budget arbitration -------------------------------------------------------


def _budget_both(g, budget, **cfg):
    ref, ref_dec = ref_approx.solve_with_budget(
        g, config=RefConfig(backend="numpy", **cfg), error_budget=budget)
    port, dec = approx.solve_with_budget(
        _port(g), config=pjt.SolverConfig(**cfg), error_budget=budget,
        device="cpu")
    assert dec.chosen.plan.name == ref_dec.chosen.plan.name
    assert port.plan["chosen"] == ref.plan["chosen"]
    assert [c["plan"] for c in port.plan["candidates"]] == \
        [c["plan"] for c in ref.plan["candidates"]]
    assert [c["qualified"] for c in port.plan["candidates"]] == \
        [c["qualified"] for c in ref.plan["candidates"]]
    return ref, port


def test_budget_zero_always_picks_exact():
    # Integer weights: the exact routes of the two packages differ (the
    # reference's dense squaring associates path sums otherwise).
    g = grid2d(6, 6, seed=4)
    g = g.with_weights(np.maximum(1.0, np.rint(g.weights)).astype(np.float32))
    ref, port = _budget_both(g, 0.0)
    assert port.plan["chosen"] == "exact" and not port.plan.get("degraded")
    assert _bits(to_numpy(port.matrix)) == _bits(np.asarray(ref.matrix))


def test_positive_budget_picks_hopset():
    g = grid2d(6, 6, seed=4)
    ref, port = _budget_both(g, 0.5)
    assert port.route == "hopset+bf" and port.plan["chosen"] == "hopset+bf"
    assert _bits(port.dist) == _bits(ref.dist)
    assert _bits(port.max_error) == _bits(ref.max_error)
    _assert_certified(port.dist, port.max_error, oracle_apsp(g))


def test_forces_pin_the_plan_as_in_the_reference():
    g = grid2d(4, 4, seed=4)
    _, port = _budget_both(g, 0.5, hopset=False)
    assert port.plan["chosen"] == "exact"
    _, port = _budget_both(g, 0.5, hopset=True)
    assert port.plan["chosen"] == "hopset+bf"
    for fn, cfg in ((ref_approx.solve_with_budget,
                     RefConfig(backend="numpy", hopset=True)),
                    (lambda g, **kw: approx.solve_with_budget(
                        _port(g), device="cpu", **kw),
                     pjt.SolverConfig(hopset=True))):
        with pytest.raises(ValueError, match="error_budget"):
            fn(g, config=cfg, error_budget=0.0)


def test_negative_weights_disqualify_hopset(tiny_graph):
    _, port = _budget_both(tiny_graph, 0.5)
    reasons = {c["plan"]: c["reason"] for c in port.plan["candidates"]}
    assert port.plan["chosen"] == "exact" and "negative" in reasons[
        "hopset+bf"]
    with pytest.raises(ValueError, match="non-negative"):
        approx.approx_apsp(_port(tiny_graph), None, device="cpu")


def test_forced_hopset_failure_raises_and_auto_gives_way(monkeypatch):
    """A failed hopset build raises under ``hopset=True``; under auto the
    exact plan serves, and the decision says it degraded."""
    def boom(*a, **kw):
        raise RuntimeError("hopset build failed")

    monkeypatch.setattr(hs, "build_hopset", boom)
    g = _port(grid2d(4, 4, seed=4))
    with pytest.raises(RuntimeError, match="hopset build failed"):
        approx.solve_with_budget(g, config=pjt.SolverConfig(hopset=True),
                                 error_budget=0.5, device="cpu")
    res, _ = approx.solve_with_budget(g, error_budget=0.5, device="cpu")
    assert res.plan["chosen"] == "hopset+bf" and res.plan["built"] == "exact"


def test_exact_plan_prices_the_ports_route(tmp_path):
    """A deliberate difference from the reference: the exact plan prices
    ``pallas-vm`` first, the port's exact sparse route, so a store
    measured on the card prices the plan by the route that serves it.
    With only ``pallas-vm`` records the port prices the plan and the
    reference leaves it unpriced."""
    from paralleljohnson_tpu import planner as ref_planner

    exact = {p.name: p for p in approx.APPROX_PLANS}["exact"]
    ref_exact = {p.name: p for p in ref_approx.APPROX_PLANS}["exact"]
    assert exact.price_routes == ("pallas-vm",) + ref_exact.price_routes
    store = ProfileStore(tmp_path)
    for b, wall in ((16, 0.01), (64, 0.04)):
        store.append({"kind": "solve", "platform": "cpu", "route":
                      "pallas-vm", "nodes": 36, "edges": 120, "batch": b,
                      "measured": {"wall_s": wall, "compute_s": wall}})
    model = CostModel.fit(store)
    import types

    ctx = types.SimpleNamespace(
        graph=_port(grid2d(6, 6, seed=4)), config=pjt.SolverConfig(),
        error_budget=0.0, params={})
    dec = planner.select(approx.APPROX_PLANS, ctx, model=model,
                         platform="cpu", num_edges=120, batch=36,
                         config=ctx.config)
    cand = {c.plan.name: c for c in dec.candidates}["exact"]
    assert cand.priced_route == "pallas-vm"
    ref_dec = ref_planner.select(ref_approx.APPROX_PLANS, ctx, model=model,
                                 platform="cpu", num_edges=120, batch=36,
                                 config=ctx.config)
    assert {c.plan.name: c for c in ref_dec.candidates}[
        "exact"].priced_route is None


def test_approx_plans_declare_the_reference_plans():
    fields = ("name", "entry", "priority", "force_overrides", "tunables")
    assert [tuple(getattr(p, f) for f in fields)
            for p in approx.APPROX_PLANS] == [
        tuple(getattr(p, f) for f in fields)
        for p in ref_approx.APPROX_PLANS]


# -- fleet construction, persistence, the engine tier ------------------------


def test_fleet_build_bitwise_identical(tmp_path):
    g = erdos_renyi(48, 0.08, seed=17)
    single = hs.build_hopset(_port(g), epsilon=0.5, k=8, beta=8, seed=3,
                             device="cpu")
    fleet = approx.fleet_build_hopset(tmp_path / "port", _port(g),
                                      n_workers=3, epsilon=0.5, k=8, beta=8,
                                      seed=3, device="cpu")
    ref = ref_approx.fleet_build_hopset(tmp_path / "ref", g, n_workers=3,
                                        epsilon=0.5, k=8, beta=8, seed=3)
    for h in (fleet, ref):
        for field in ("pivots", "fwd", "rev"):
            assert _bits(getattr(h, field)) == _bits(getattr(single, field))
        assert h.converged == single.converged and h.digest == single.digest
    assert fleet.edges_examined == ref.edges_examined > 0
    merged = ref_approx.merge_hopset_shards(tmp_path / "port", g,
                                            epsilon=0.5, seed=3, expect_k=8)
    assert _bits(merged.fwd) == _bits(single.fwd)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_save_load_across_packages_and_digest_guard(writer, tmp_path):
    g = grid2d(5, 5, seed=21)
    if writer == "ref":
        hop = ref_hs.build_hopset(g, epsilon=0.4, k=5, beta=8, seed=0)
    else:
        hop = hs.build_hopset(_port(g), epsilon=0.4, k=5, beta=8, seed=0,
                              device="cpu")
    hop.save(tmp_path)
    loaded = [m.Hopset.load(tmp_path, expect_digest=hop.digest)
              for m in (ref_hs, hs)]
    carried = interop.hopset_from_arrays(**dataclasses.asdict(hop))
    for back in (*loaded, carried):
        for field in ("pivots", "fwd", "rev"):
            assert _bits(getattr(back, field)) == _bits(getattr(hop, field))
        for field in ("epsilon", "beta", "converged", "digest"):
            assert getattr(back, field) == getattr(hop, field)
        for s in (0, 12, 24):
            for a, b in zip(back.estimate_row(s), hop.estimate_row(s)):
                assert _bits(a) == _bits(b)
    assert all(m.Hopset.load(tmp_path, expect_digest="deadbeef") is None
               for m in (ref_hs, hs))
    with pytest.raises(ValueError, match="unknown Hopset fields"):
        interop.hopset_from_arrays(bogus=1)
    with pytest.raises(ValueError, match="digest"):
        approx.approx_apsp(_port(grid2d(5, 5, seed=2)), None, hopset=carried,
                           device="cpu")


def test_engine_hopset_tier_bitwise_reference(tmp_path):
    from paralleljohnson_tpu.serve import QueryEngine as RefEngine
    from paralleljohnson_tpu.serve import TileStore as RefStore

    from paralleljohnson_tpu_torch.serve import QueryEngine, TileStore

    g = grid2d(6, 6, seed=25)
    exact = oracle_apsp(g)
    ref_hop = ref_hs.build_hopset(g, epsilon=0.5, seed=0)
    hop = interop.hopset_from_arrays(**dataclasses.asdict(ref_hop))
    ref_eng = RefEngine(g, RefStore(tmp_path / "ref", g), hopset=ref_hop,
                        config=RefConfig(backend="numpy"),
                        miss_policy="hopset", stats_interval_s=0)
    eng = QueryEngine(_port(g), TileStore(tmp_path / "port", _port(g)),
                      hopset=hop, miss_policy="hopset", device="cpu",
                      stats_interval_s=0)
    reqs = [{"id": i, "source": s, "dst": t, "mode": m} for i, (s, t, m) in
            enumerate([(0, 35, "hopset"), (17, 3, "hopset"), (5, 5, "hopset"),
                       (1, 2, "approx"), (4, None, "hopset")])]
    out, ref_out = eng.query_batch(reqs), ref_eng.query_batch(reqs)
    assert out == ref_out
    for r in out[:4]:
        assert r["tier"] == "hopset" and r["exact"] is False
        assert abs(r["distance"] - exact[r["source"], r["dst"]]) <= \
            r["max_error"]
    summary = eng.serve_summary()
    assert summary["engine"]["hopset_answers"] == 5
    assert summary["hopset"] == ref_eng.serve_summary()["hopset"]
    text = eng.write_metrics(tmp_path / "m.prom").read_text()
    assert "pjtpu_hopset_answers_total 5.0" in text
    with pytest.raises(ValueError, match="digest"):
        QueryEngine(_port(grid2d(6, 6, seed=2)),
                    TileStore(None, _port(grid2d(6, 6, seed=2))),
                    hopset=hop, miss_policy="hopset", device="cpu")
    with pytest.raises(ValueError, match="hopset"):
        QueryEngine(_port(g), TileStore(None, _port(g)),
                    miss_policy="hopset", device="cpu")
    eng.close()
    ref_eng.close()


def test_hopset_record_and_regress_ingest():
    from paralleljohnson_tpu_torch.observe.regress import normalize_record

    g = grid2d(6, 6, seed=27)
    hop = hs.build_hopset(_port(g), epsilon=0.5, seed=0, device="cpu")
    rec = approx.hopset_record(hop, _port(g), platform="cpu")
    ref_rec = ref_approx.hopset_record(
        ref_hs.build_hopset(g, epsilon=0.5, seed=0), g, platform="cpu")
    drop = ("ts", "construction_s")
    assert {k: v for k, v in rec.items() if k not in drop} == \
        {k: v for k, v in ref_rec.items() if k not in drop}
    (row,) = normalize_record(rec, source="test")
    assert row["bench"].startswith("hopset:") and "eps0.5" in row["bench"]


def test_auto_knobs_equal_reference():
    for v in (2, 100, 4096, 1 << 20):
        assert hs.auto_num_pivots(v) == ref_hs.auto_num_pivots(v)
        for eps in (1e-6, 0.1, 0.5, 10.0):
            assert hs.auto_beta(v, eps) == ref_hs.auto_beta(v, eps)
    assert (hs.BETA_MIN, hs.BETA_MAX) == (ref_hs.BETA_MIN, ref_hs.BETA_MAX)
    assert hs.HOPSET_FILENAME == ref_hs.HOPSET_FILENAME


def test_hopset_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _port(grid2d(4, 4, seed=1))
    with pytest.raises(RuntimeError, match="cuda"):
        hs.bounded_hop_rows(g, np.array([0]), beta=4)
    with pytest.raises(RuntimeError, match="cuda"):
        approx.approx_apsp(g, None)
