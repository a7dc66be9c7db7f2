"""PyTorch port: the serving tier (``serve/{store,landmarks,device_query,
engine}``) against the JAX package's, on the reference's cases
(``tests/test_serve.py``, ``tests/test_device_residency.py``).

Every case runs the same seeded graph, queries and store operations
through both packages on the CPU, with integer weights so that every
exact route of either package gives the same f32 rows. Bitwise equal
across the packages: exact answers and the tier they report, the landmark
raw bounds and the finished ``(estimate, max_error)``, and the responses
of the host-forced and the device-forced lookup paths (within each
package and across the two). Equal: the serving counters (hits, misses,
scheduled batches, stale, errors). Every certificate is held against
scipy's exact rows. Each package reads the other's landmark index and
``serve_stats.json``."""

import json
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu import ParallelJohnsonSolver as RefSolver
from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import erdos_renyi, random_dag
from paralleljohnson_tpu import serve as ref_serve

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop, planner
from paralleljohnson_tpu_torch import serve
from paralleljohnson_tpu_torch.serve import device_query
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


def intw(g, *, keep_sign=False):
    """Integer weights (>= 1, or rounded with their sign on a DAG): every
    route of either package sums them exactly in f32."""
    w = np.rint(g.weights)
    w = w if keep_sign else np.maximum(1.0, w)
    return g.with_weights(w.astype(np.float32))


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _pkg(name):
    """The serving API of one package, with the port on the CPU."""
    if name == "port":
        return types.SimpleNamespace(
            name=name, mod=serve, graph=_port,
            solver=lambda **kw: pjt.ParallelJohnsonSolver(
                pjt.SolverConfig(**kw), device="cpu"),
            config=pjt.SolverConfig, dev={"device": "cpu"})
    return types.SimpleNamespace(
        name=name, mod=ref_serve, graph=lambda g: g,
        solver=lambda **kw: RefSolver(RefConfig(**kw)),
        config=RefConfig, dev={})


PKGS = [_pkg("ref"), _pkg("port")]


def _engine(p, g, store_dir, *, landmarks=None, **kw):
    kw.setdefault("stats_interval_s", 0)
    return p.mod.QueryEngine(g, p.mod.TileStore(store_dir, g, **{
        k: kw.pop(k) for k in ("hot_rows", "warm_rows") if k in kw}),
        landmarks=landmarks, config=p.config(), **p.dev, **kw)


def _landmarks(p, g, k, **kw):
    return p.mod.LandmarkIndex.build(g, k, config=p.config(), **p.dev, **kw)


def _canon(responses):
    return json.dumps(responses, sort_keys=True)


def _counters(engine):
    s = engine.stats
    return (s.queries_total, s.exact_answers, s.approx_answers,
            s.hopset_answers, s.errors, s.batches_scheduled,
            s.solved_sources, s.stale_answers, s.shed_answers,
            s.device_lookups, s.host_lookups, dict(s.hits_by_tier),
            engine.store.hits_hot, engine.store.hits_warm,
            engine.store.hits_cold, engine.store.misses,
            engine.store.demotions, engine.store.evictions,
            engine.store.cold_loads)


def _both(fn, tmp_path):
    """``fn(pkg, dir)`` in each package, in its own directory."""
    return [fn(p, tmp_path / p.name) for p in PKGS]


# -- the exact serving contract ----------------------------------------------


def test_exact_answers_bitwise_equal_to_solver(tmp_path):
    g = intw(erdos_renyi(48, 0.08, seed=3))
    exact = oracle_apsp(g)
    rng = np.random.default_rng(0)
    pairs = [(int(s), int(t)) for s, t in rng.integers(0, 48, size=(20, 2))]

    def run(p, d):
        gg = p.graph(g)
        mat = to_numpy(p.solver().solve(gg).matrix)
        engine = _engine(p, gg, d)
        out = [engine.query(s, t) for s, t in pairs]
        for r, (s, t) in zip(out, pairs):
            assert r["exact"] is True and r["max_error"] == 0.0
            assert r["distance"] == float(mat[s, t])
        return out, _counters(engine)

    ref, port = _both(run, tmp_path)
    assert _canon(ref[0]) == _canon(port[0]) and ref[1] == port[1]
    for r, (s, t) in zip(port[0], pairs):
        assert r["distance"] == exact[s, t]


def test_exact_contract_negative_weights(tmp_path):
    """The Johnson path (reweight + unreweight) serves bitwise too."""
    g = intw(random_dag(30, 0.15, negative_fraction=0.3, seed=7),
             keep_sign=True)
    assert g.has_negative_weights
    exact = oracle_apsp(g)

    def run(p, d):
        engine = _engine(p, p.graph(g), d)
        return [engine.query(s, t) for s, t in
                [(0, 29), (7, 3), (12, 12), (2, 20), (29, 0)]]

    ref, port = _both(run, tmp_path)
    assert _canon(ref) == _canon(port)
    for r in port:
        assert r["exact"] is True
        assert r["distance"] == exact[r["source"], r["dst"]]


def test_cold_query_schedules_one_batch_then_hits_lru(tmp_path):
    g = intw(erdos_renyi(32, 0.1, seed=5))

    def run(p, d):
        engine = _engine(p, p.graph(g), d)
        r1, r2 = engine.query(4, 9), engine.query(4, 11)
        assert r1["tier"] == "solved" and r2["tier"] == "hot"
        assert engine.stats.batches_scheduled == 1
        return [r1, r2], _counters(engine)

    ref, port = _both(run, tmp_path)
    assert _canon(ref[0]) == _canon(port[0]) and ref[1] == port[1]


def test_batch_aggregation_one_solve_for_all_misses(tmp_path):
    g = intw(erdos_renyi(32, 0.1, seed=6))
    reqs = [{"id": i, "source": s, "dst": (s + 1) % 32}
            for i, s in enumerate([3, 7, 3, 11, 7, 3])]

    def run(p, d):
        engine = _engine(p, p.graph(g), d)
        out = engine.query_batch([dict(r) for r in reqs])
        assert engine.stats.batches_scheduled == 1
        assert engine.stats.solved_sources == 3 and engine.store.misses == 3
        return out, _counters(engine)

    ref, port = _both(run, tmp_path)
    assert _canon(ref[0]) == _canon(port[0]) and ref[1] == port[1]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_store_attaches_to_finished_solve_dir(writer, tmp_path):
    """Either package's store over the other's (or its own) checkpointed
    solve serves from the cold tier without scheduling anything, and
    promotes the decoded batch to warm."""
    g = intw(erdos_renyi(40, 0.1, seed=8))
    w = PKGS[0] if writer == "ref" else PKGS[1]
    full = to_numpy(w.solver(source_batch_size=10,
                             checkpoint_dir=str(tmp_path)).solve(
        w.graph(g)).matrix)
    outs = []
    for p in PKGS:
        engine = _engine(p, p.graph(g), tmp_path)
        r, r2 = engine.query(17, 23), engine.query(17, 5)
        assert r["tier"] == "cold" and r2["tier"] == "warm"
        assert engine.stats.batches_scheduled == 0
        assert engine.store.cold_loads == 1
        assert r["distance"] == float(full[17, 23])
        outs.append(([r, r2], _counters(engine)))
    assert _canon(outs[0][0]) == _canon(outs[1][0])
    assert outs[0][1] == outs[1][1]


def test_one_to_many_and_full_row(tmp_path):
    g = intw(erdos_renyi(24, 0.15, seed=9))
    exact = oracle_apsp(g)

    def run(p, d):
        engine = _engine(p, p.graph(g), d)
        return [engine.query(2, [0, 5, 23]), engine.query(2)]

    ref, port = _both(run, tmp_path)
    assert _canon(ref) == _canon(port)
    np.testing.assert_array_equal(port[0]["distances"], exact[2, [0, 5, 23]])
    np.testing.assert_array_equal(port[1]["distances"], exact[2])


def test_tier_demotion_and_eviction():
    g = intw(erdos_renyi(24, 0.15, seed=10))
    stats = []
    for p in PKGS:
        gg = p.graph(g)
        store = p.mod.TileStore(None, gg, hot_rows=2, warm_rows=3)
        res = p.solver().solve(gg, sources=np.arange(6))
        store.put(res.sources, res.dist)
        assert store.demotions == 4 and store.evictions == 1
        assert store.get(5)[1] == "hot" and store.get(3)[1] == "warm"
        assert store.get(0) == (None, None)
        st = store.stats()
        st.pop("digest")
        stats.append(st)
    assert stats[0] == stats[1]


# -- the approximate serving contract ----------------------------------------


def _assert_bounds_hold(lm, exact):
    for s in range(exact.shape[0]):
        lower, upper = lm.bounds_row(s)
        assert np.all(lower <= exact[s]) and np.all(exact[s] <= upper), s
        est, err = lm.estimate_row(s)
        both_inf = np.isinf(est) & np.isinf(exact[s])
        with np.errstate(invalid="ignore"):
            diff = np.where(both_inf, 0.0, np.abs(est - exact[s]))
        assert np.all(diff <= err), s


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("picker", ["uniform", "coverage", "boundary"])
def test_landmark_bounds_bitwise_and_certified(seed, picker):
    """The two packages pick the same pivots, solve the same rows, and
    give bitwise the same raw and finished bounds; every bound holds
    against scipy's exact rows (sparse graphs with unreachable pairs)."""
    g = intw(erdos_renyi(28, 0.07, seed=seed))
    exact = oracle_apsp(g)
    assert np.isinf(exact).any()
    ref, port = (_landmarks(p, p.graph(g), 4, seed=seed, picker=picker)
                 for p in PKGS)
    np.testing.assert_array_equal(port.sources, ref.sources)
    assert port.fwd.tobytes() == ref.fwd.tobytes()
    assert port.rev.tobytes() == ref.rev.tobytes()
    assert port.digest == ref.digest
    for s in range(g.num_nodes):
        for a, b in zip(port.raw_bounds_row(s), ref.raw_bounds_row(s)):
            assert a.tobytes() == b.tobytes()
        for a, b in zip(port.estimate_row(s), ref.estimate_row(s)):
            assert a.tobytes() == b.tobytes()
    _assert_bounds_hold(port, exact)


def test_landmark_miss_policy_answers_flagged(tmp_path):
    g = intw(erdos_renyi(40, 0.08, seed=11))
    exact = oracle_apsp(g)
    rng = np.random.default_rng(2)
    pairs = [(int(s), int(t)) for s, t in rng.integers(0, 40, size=(15, 2))]

    def run(p, d):
        gg = p.graph(g)
        engine = _engine(p, gg, d, landmarks=_landmarks(p, gg, 5, seed=1),
                         miss_policy="landmark")
        out = [engine.query(s, t) for s, t in pairs]
        assert engine.stats.batches_scheduled == 0
        assert engine.stats.approx_answers == 15
        return out, _counters(engine)

    ref, port = _both(run, tmp_path)
    assert _canon(ref[0]) == _canon(port[0]) and ref[1] == port[1]
    for r, (s, t) in zip(port[0], pairs):
        assert r["exact"] is False and r["tier"] == "landmark"
        if not (np.isinf(r["distance"]) and np.isinf(exact[s, t])):
            assert abs(r["distance"] - exact[s, t]) <= r["max_error"]


def test_landmark_policy_requires_index_and_mode_override(tmp_path):
    g = _port(intw(erdos_renyi(30, 0.1, seed=12)))
    with pytest.raises(ValueError, match="landmark"):
        serve.QueryEngine(g, serve.TileStore(tmp_path, g), device="cpu",
                          miss_policy="landmark")
    lm = serve.LandmarkIndex.build(g, 4, device="cpu")
    engine = serve.QueryEngine(g, serve.TileStore(tmp_path, g), landmarks=lm,
                               device="cpu", stats_interval_s=0)
    r = engine.query(3, 9, mode="approx")
    assert r["exact"] is False and "max_error" in r
    assert engine.stats.batches_scheduled == 0


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_landmark_index_persistence_across_packages(writer, tmp_path):
    """Each package loads the index the other saved (digest-guarded) and
    answers bitwise the same; ``interop.landmarks_from_arrays`` carries a
    reference index into the port."""
    g = intw(erdos_renyi(20, 0.15, seed=13))
    w = PKGS[0] if writer == "ref" else PKGS[1]
    lm = _landmarks(w, w.graph(g), 3)
    lm.save(tmp_path)
    loaded = [p.mod.LandmarkIndex.load(tmp_path, expect_digest=lm.digest)
              for p in PKGS]
    assert all(x is not None and x.k == 3 for x in loaded)
    assert all(p.mod.LandmarkIndex.load(tmp_path, expect_digest="ffff")
               is None for p in PKGS)
    carried = interop.landmarks_from_arrays(
        lm.sources, lm.fwd, lm.rev, nonnegative=lm.nonnegative,
        digest=lm.digest)
    for s in range(g.num_nodes):
        want = lm.estimate_row(s)
        for idx in (*loaded, carried):
            for a, b in zip(idx.estimate_row(s), want):
                assert a.tobytes() == b.tobytes()


# -- errors, metrics, persistence --------------------------------------------


def test_query_errors_survive_the_batch(tmp_path):
    g = intw(erdos_renyi(16, 0.2, seed=14))
    reqs = [{"source": 999, "dst": 0}, {"source": 1, "dst": 2},
            {"source": 1, "dst": [0, 99]}, "not an object"]

    def run(p, d):
        engine = _engine(p, p.graph(g), d)
        out = engine.query_batch(list(reqs))
        with pytest.raises(p.mod.QueryError):
            engine.query(-1, 0)
        return out, _counters(engine)

    ref, port = _both(run, tmp_path)
    assert _canon(ref[0]) == _canon(port[0]) and ref[1] == port[1]
    assert port[1][4] == 4


def test_engine_close_idempotent_and_query_after_close_raises(tmp_path):
    g = _port(intw(erdos_renyi(16, 0.2, seed=17)))
    engine = serve.QueryEngine(g, serve.TileStore(tmp_path, g),
                               device="cpu", stats_interval_s=0)
    engine.query(0, 1)
    engine.close()
    engine.close()
    assert engine.closed
    for call in (lambda: engine.query(2, 3),
                 lambda: engine.query_batch([{"source": 2, "dst": 3}]),
                 lambda: engine.warm([4, 5])):
        with pytest.raises(serve.QueryError, match="closed"):
            call()
    assert engine.stats.queries_total == 1


def test_serve_prom_metrics_and_stats_file_read_across(tmp_path):
    """The prom export matches the reference's lines, and each package's
    engine reads the same ``serve_stats.json`` shape (the JAX package's
    reader, ``observe.top``, reads the port's file)."""
    from paralleljohnson_tpu.observe import top as ref_top
    from paralleljohnson_tpu_torch.utils.telemetry import validate_prom_text

    g = intw(erdos_renyi(16, 0.2, seed=15))
    texts, payloads = [], []
    for p in PKGS:
        gg = p.graph(g)
        store = p.mod.TileStore(tmp_path / p.name, gg)
        engine = p.mod.QueryEngine(gg, store, config=p.config(), **p.dev,
                                   stats_interval_s=0)
        for s in range(4):
            engine.query(s, (s + 1) % 16)
        text = engine.write_metrics(tmp_path / f"{p.name}.prom",
                                    labels={"command": "serve"}).read_text()
        validate_prom_text(text)
        texts.append(sorted(line for line in text.splitlines()
                            if "latency" not in line and "burn" not in line
                            and "hit_rate" not in line))
        engine.close()
        stats_file = store.ckpt.dir / p.mod.SERVE_STATS_FILENAME
        payloads.append(json.loads(stats_file.read_text()))
        assert 'pjtpu_query_latency_ms_count{command="serve"} 4.0' in text
        assert "pjtpu_query_latency_p50_ms" not in text
    assert texts[0] == texts[1]
    ref, port = payloads
    assert set(ref) == set(port)
    assert port["engine"]["queries_total"] == 4
    assert port["store"]["hot_capacity"] == ref["store"]["hot_capacity"]
    doc = ref_top.gather_ops(serve_store=tmp_path / "port", now=port["ts"])
    assert doc["serve"][0]["serve"]["queries_total"] == 4


def test_concurrent_query_engine_exact_and_lossless_counters(tmp_path):
    """Many threads on one engine over a half-solved checkpoint: every
    answer bitwise exact, no lost increment, at most one solve per
    aggregated miss batch."""
    g = _port(intw(erdos_renyi(48, 0.1, seed=21)))
    exact = oracle_apsp(g)
    pjt.ParallelJohnsonSolver(pjt.SolverConfig(
        source_batch_size=8, checkpoint_dir=str(tmp_path)),
        device="cpu").solve(g, sources=np.arange(24))
    engine = serve.QueryEngine(g, serve.TileStore(tmp_path, g),
                               device="cpu", stats_interval_s=0)
    n_threads, per_thread = 8, 6
    rng = np.random.default_rng(3)
    plans = [[(int(s), int(t)) for s, t in rng.integers(0, 48, (per_thread, 2))]
             for _ in range(n_threads)]
    failures: list = []
    barrier = threading.Barrier(n_threads)

    def hammer(k):
        try:
            barrier.wait(timeout=30)
            reqs = [{"id": i, "source": s, "dst": t}
                    for i, (s, t) in enumerate(plans[k])]
            for resp, (s, t) in zip(engine.query_batch(reqs), plans[k]):
                assert resp["exact"] is True
                assert resp["distance"] == exact[s, t], (s, t)
        except BaseException as e:  # noqa: BLE001
            failures.append(e)

    threads = [threading.Thread(target=hammer, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert failures == []
    total = n_threads * per_thread
    assert engine.stats.queries_total == engine.stats.exact_answers == total
    assert engine.stats.hist.count == total
    assert engine.metrics.counter("pjtpu_queries").total == total
    assert sum(engine.stats.hits_by_tier.values()) == total
    missed = sum(1 for plan in plans if any(s >= 24 for s, _ in plan))
    assert engine.stats.batches_scheduled <= missed
    assert engine.stats.solved_sources <= 24


def test_serve_stats_rewritten_periodically_while_serving(tmp_path):
    """serve_stats.json is rewritten while the engine serves: each wait
    is on the file's content and mtime, with a deadline of its own."""
    g = _port(intw(erdos_renyi(24, 0.15, seed=22)))
    store = serve.TileStore(tmp_path, g)
    engine = serve.QueryEngine(g, store, device="cpu", stats_interval_s=0.05)
    stats_file = store.ckpt.dir / serve.SERVE_STATS_FILENAME

    def wait_for(queries):
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            try:
                payload = json.loads(stats_file.read_text())
                if payload["engine"]["queries_total"] >= queries:
                    return payload, stats_file.stat().st_mtime_ns
            except (OSError, ValueError):
                pass
            time.sleep(0.02)
        pytest.fail(f"no serve_stats.json with {queries} queries in 20 s")

    engine.query(1, 2)
    payload, mtime = wait_for(1)
    assert "ts" in payload and "live" in payload
    engine.query(3, 4)
    payload, mtime2 = wait_for(2)
    assert mtime2 >= mtime
    engine.close()


def test_stale_exact_answers_carry_max_error(tmp_path):
    g = intw(erdos_renyi(48, 0.08, seed=3))

    def run(p, d):
        gg = p.graph(g)
        engine = _engine(p, gg, d, landmarks=_landmarks(p, gg, 4))
        fresh = engine.query(2, 7)
        engine.store.mark_stale([2])
        r, row = engine.query(2, 7), engine.query(2)
        bare = _engine(p, gg, d / "bare")
        bare.query(1, 3)
        bare.store.mark_stale([1])
        return [fresh, r, row, bare.query(1, 3)], _counters(engine)

    ref, port = _both(run, tmp_path)
    assert _canon(ref[0]) == _canon(port[0]) and ref[1] == port[1]
    fresh, r, row, bare = port[0]
    assert "stale" not in fresh and r["stale"] is True
    assert r["distance"] == fresh["distance"] and r["max_error"] >= 0.0
    assert row["stale"] is True and len(row["max_error"]) == 48
    assert bare["stale"] is True and np.isinf(bare["max_error"])


def test_pivot_pickers_equal_reference():
    g = intw(erdos_renyi(64, 0.08, seed=9))
    for picker in serve.PIVOT_PICKERS:
        for k in (0, 6, 64):
            a = serve.pick_pivots(_port(g), k, seed=4, picker=picker)
            b = ref_serve.pick_pivots(g, k, seed=4, picker=picker)
            np.testing.assert_array_equal(a, b)
    assert serve.PIVOT_PICKERS == ref_serve.PIVOT_PICKERS
    with pytest.raises(ValueError):
        serve.pick_pivots(_port(g), 6, picker="degree")


# -- the device lookup path (reference: tests/test_device_residency.py) ------


def _mixed_requests(n, rng):
    reqs = []
    for i in range(24):
        kind, s = i % 4, int(rng.integers(0, n))
        if kind == 0:
            reqs.append({"id": i, "source": s, "dst": int(rng.integers(0, n))})
        elif kind == 1:
            reqs.append({"id": i, "source": s,
                         "dst": [int(d) for d in rng.integers(0, n, 3)]})
        elif kind == 2:
            reqs.append({"id": i, "source": s})
        else:
            reqs.append({"id": i, "source": s,
                         "dst": int(rng.integers(0, n)), "mode": "approx"})
    return reqs


def _lookup_engine(p, d, mode, *, hot_rows=64):
    gg = p.graph(intw(erdos_renyi(48, 0.08, seed=3)))
    return _engine(p, gg, d, landmarks=_landmarks(p, gg, 4),
                   device_lookup=mode, hot_rows=hot_rows)


def test_device_vs_host_bitwise_parity_across_tiers_and_packages(tmp_path):
    """Forced-device and forced-host engines answer an exact / landmark /
    row / pair mix identically, in each package and across the two, with
    the same counters."""
    reqs = _mixed_requests(48, np.random.default_rng(0))
    outs, counters = [], []
    for p in PKGS:
        for mode in ("off", "on"):
            engine = _lookup_engine(p, tmp_path / p.name / mode, mode)
            engine.warm(range(0, 48, 2))
            outs.append(_canon(engine.query_batch([dict(r) for r in reqs])))
            assert (engine.stats.device_lookups > 0) == (mode == "on")
            counters.append(_counters(engine))
    assert len(set(outs)) == 1
    assert counters[0] == counters[2]
    # The split of the device-forced run differs by design: the port's
    # landmark sub-path rides the device (torch has real f64), while the
    # reference's f64 probe keeps it on the host where JAX has no x64.
    split = slice(9, 11)
    assert counters[1][:9] == counters[3][:9]
    assert counters[1][11:] == counters[3][11:]
    assert sum(counters[1][split]) == sum(counters[3][split])
    assert counters[3][9] >= counters[1][9]


def test_raw_landmark_bounds_bitwise_vs_numpy(tmp_path):
    """The device path's raw f64 bounds (torch ops) against the host's
    ``raw_bounds_row``, byte for byte, on rows with +inf entries and
    negative finite entries."""
    g = _port(intw(random_dag(48, 0.1, negative_fraction=0.3, seed=5),
                   keep_sign=True))
    lm = serve.LandmarkIndex.build(g, 4, device="cpu")
    assert np.isinf(lm.fwd).any() and (lm.fwd[np.isfinite(lm.fwd)] < 0).any()
    path = device_query.DeviceQueryPath(serve.TileStore(tmp_path, g), lm,
                                        device="cpu")
    assert path.landmark_device_ok()
    rng = np.random.default_rng(1)
    s_idx, t_idx = rng.integers(0, 48, 13), rng.integers(0, 48, 13)
    lo_d, up_d = path.landmark_pairs(s_idx, t_idx)
    for i, (s, t) in enumerate(zip(s_idx, t_idx)):
        lo_h, up_h = lm.raw_bounds_row(int(s), np.asarray([int(t)]))
        assert lo_d[i].tobytes() == lo_h[0].tobytes()
        assert up_d[i].tobytes() == up_h[0].tobytes()
    lo_r, up_r = path.landmark_rows(s_idx[:9])
    for i, s in enumerate(s_idx[:9]):
        lo_h, up_h = lm.raw_bounds_row(int(s), None)
        assert lo_r[i].tobytes() == lo_h.tobytes()
        assert up_r[i].tobytes() == up_h.tobytes()


def test_eviction_mid_batch_invalidates_tile(tmp_path):
    engine = _lookup_engine(PKGS[1], tmp_path, "on", hot_rows=8)
    engine.warm(range(8))
    r0 = engine.query(0, 5)
    path = engine._device_path_maybe()
    rebuilds0 = path.tile_rebuilds
    engine.warm(range(8, 16))
    r1 = engine.query(8, 5)
    assert path.tile_rebuilds > rebuilds0
    r2 = engine.query(0, 5)
    assert r2["distance"] == r0["distance"] and r1["exact"] and r2["exact"]


def test_stale_rows_never_in_device_tile(tmp_path):
    engine = _lookup_engine(PKGS[1], tmp_path, "on")
    engine.warm(range(8))
    engine.query(1, 3)
    path = engine._device_path_maybe()
    assert 1 in path.refresh()
    engine.store.mark_stale([1])
    assert 1 not in path.refresh()
    r = engine.query(1, 3)
    assert r["stale"] is True and "max_error" in r


def test_forcing_either_path_reproduces_the_other(tmp_path):
    """``device_lookup`` auto / on / off answer alike in both packages and
    choose the same plan; on the CPU auto keeps the host walk; the forced
    device decision says where the landmark bounds ran."""
    reqs = _mixed_requests(48, np.random.default_rng(7))
    outs, chosen = [], []
    for p in PKGS:
        for mode in ("auto", "on", "off"):
            engine = _lookup_engine(p, tmp_path / p.name / mode, mode)
            engine.warm(range(0, 48, 3))
            outs.append(_canon(engine.query_batch([dict(r) for r in reqs])))
            chosen.append(engine.last_lookup_decision["chosen"])
            if p.name == "port" and mode == "on":
                reason = engine.last_lookup_decision["reason"]
                assert "forced" in reason and "f64 on the device" in reason
    assert len(set(outs)) == 1
    assert chosen[:3] == chosen[3:] == ["host_lookup", "device_lookup",
                                        "host_lookup"]


def test_hit_accounting_identical_across_paths(tmp_path):
    reqs = [{"source": i % 16, "dst": (i * 5) % 48} for i in range(20)]
    hits = []
    for p in PKGS:
        for mode in ("off", "on"):
            engine = _lookup_engine(p, tmp_path / p.name / mode, mode)
            engine.warm(range(16))
            engine.query_batch([dict(r) for r in reqs])
            hits.append(engine.store.hits_hot)
    assert len(set(hits)) == 1 and hits[0] > 0


def test_tiny_batch_stays_on_host_under_auto(tmp_path):
    engine = _lookup_engine(PKGS[1], tmp_path, "auto")
    engine.warm(range(8))
    engine.query(1, 2)
    assert engine.last_lookup_decision["chosen"] == "host_lookup"
    assert planner.MIN_DEVICE_LOOKUP_BATCH > 1


def test_auto_device_fault_degrades_only_on_cpu(tmp_path, monkeypatch):
    """A fault of the device path under ``device_lookup="auto"``: a CPU
    engine answers from the host walk and says why; the same fault on a
    CUDA engine raises (the device the engine holds is what decides)."""
    def boom(self):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(device_query.DeviceQueryPath, "refresh", boom)
    engine = _lookup_engine(PKGS[1], tmp_path, "auto")
    engine.warm(range(8))
    (r,) = engine.query_batch([{"source": 1, "dst": 2}])
    assert r["exact"] is True
    assert engine.last_lookup_decision["chosen"] == "host_lookup"
    assert "injected device fault" in json.dumps(engine.last_lookup_decision)
    engine.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="injected device fault"):
        engine.query_batch([{"source": 1, "dst": 2}])
    engine.close()


def test_query_engine_without_card_raises(tmp_path, monkeypatch):
    """The engine runs on the card unless asked for the CPU, and raises
    rather than serve from the host when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _port(intw(erdos_renyi(16, 0.2, seed=1)))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.QueryEngine(g, serve.TileStore(tmp_path, g))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.LandmarkIndex.build(g, 2)


def test_serve_exports_the_reference_names():
    assert sorted(serve.__all__) == sorted(ref_serve.__all__)
    assert serve.SERVE_PROM_METRICS is not None
    assert [m[0] for m in serve.SERVE_PROM_METRICS] == \
        [m[0] for m in ref_serve.SERVE_PROM_METRICS]
