"""PyTorch port: the traffic front end (``serve/frontend.py``: admission,
deadlines, certified shedding, drain, HTTP, ``MicroBatcher``), the serve
fleet (``serve/fleet.py`` membership and routing, ``serve/router.py``)
and the operations console (``observe/top.py``), on the reference's cases
(``tests/test_frontend.py``, ``tests/test_fleet_serve.py``,
``tests/test_top.py``; their CLI and subprocess cases wait for the port's
CLI).

The cases run the port on the CPU through real sockets. Where a result is
the reference's by construction it is compared with it: the hash ring's
owners, the routing files either package writes, and ``gather_ops`` over
the same stores and coordinators. Every wait has a deadline of its own
(socket timeouts, ``join(timeout=...)``, polls with a deadline)."""

import functools
import json
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu.observe import top as ref_top
from paralleljohnson_tpu.serve import fleet as ref_fleet

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import serve
from paralleljohnson_tpu_torch.graphs import erdos_renyi, grid2d
from paralleljohnson_tpu_torch.observe.live import SLO, LogHistogram
from paralleljohnson_tpu_torch.observe.top import gather_ops, render_ops
from paralleljohnson_tpu_torch.serve import (
    PROTOCOL,
    FleetRouter,
    MicroBatcher,
    ReplicaRegistration,
    RoutingTable,
    ServeFrontend,
    TileStore,
    live_replicas,
    parse_listen,
    publish_routing,
    read_replicas,
    read_routing,
)
from paralleljohnson_tpu_torch.serve.fleet import replicas_dir, routing_path
from paralleljohnson_tpu_torch.incremental.status import write_repair_status
from paralleljohnson_tpu_torch.utils.faults import Fault, FaultPlan

# The port's entry points on the CPU (they default to the card).
QueryEngine = functools.partial(serve.QueryEngine, device="cpu")
ParallelJohnsonSolver = functools.partial(pjt.ParallelJohnsonSolver,
                                          device="cpu")
SolverConfig = pjt.SolverConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU, and an oversubscribed torch thread pool slows small solves by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _landmarks(g, k, **kw):
    return serve.LandmarkIndex.build(g, k, device="cpu", **kw)


def _cfg(**kw) -> SolverConfig:
    return SolverConfig(**kw)



# One tight-windowed SLO so burn tests are fast and deterministic.
_TIGHT_SLO = SLO(name="serve", latency_ms=25.0, latency_pct=99.0,
                 availability=0.9, rules=((10.0, 1.0, 2.0),))


def _world(tmp_path, *, warm=16, n=32, config=None, slo=None, **fe_kw):
    g = erdos_renyi(n, 0.15, seed=3)
    cfg = config or _cfg()
    store = TileStore(tmp_path / "store", g, warm_rows=n)
    lm = _landmarks(g, 4, config=_cfg(), seed=0)
    engine = QueryEngine(g, store, landmarks=lm, config=cfg,
                         slo=slo or _TIGHT_SLO, stats_interval_s=0)
    engine.warm(np.arange(warm))
    frontend = ServeFrontend(engine, **fe_kw).start()
    return g, engine, frontend


class _Client:
    """One blocking JSONL client: connect, read header, round-trip."""

    def __init__(self, frontend, timeout=30.0):
        self.sock = socket.create_connection(frontend.address,
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        self.f = self.sock.makefile("rw", encoding="utf-8", newline="\n")
        self.header = json.loads(self.f.readline())

    def send(self, req: dict) -> None:
        self.f.write(json.dumps(req) + "\n")
        self.f.flush()

    def recv(self) -> dict:
        return json.loads(self.f.readline())

    def ask(self, req: dict) -> dict:
        self.send(req)
        return self.recv()

    def close(self) -> None:
        self.f.close()
        self.sock.close()


def _force_burn(engine, bad=50):
    for _ in range(bad):
        engine.metrics.observe_slo(engine.slo.name, None, ok=False)
    assert engine.slo_tracker().burning


def _clear_burn(engine, good=600):
    for _ in range(good):
        engine.metrics.observe_slo(engine.slo.name, 0.1, ok=True)
    assert not engine.slo_tracker().burning


# -- protocol + exactness -----------------------------------------------------


def test_parse_listen():
    assert parse_listen("127.0.0.1:0") == ("127.0.0.1", 0)
    assert parse_listen("0.0.0.0:7070") == ("0.0.0.0", 7070)
    with pytest.raises(ValueError):
        parse_listen("7070")
    with pytest.raises(ValueError):
        parse_listen("host:port")


def test_header_then_bitwise_exact_roundtrip(tmp_path):
    g, engine, fe = _world(tmp_path)
    exact = np.asarray(ParallelJohnsonSolver(_cfg()).solve(g).matrix)
    try:
        c = _Client(fe)
        assert c.header["protocol"] == PROTOCOL
        assert c.header["graph_digest"] == engine.store.digest
        for s, t in [(3, 9), (1, 30), (15, 0)]:
            r = c.ask({"id": f"{s}-{t}", "source": s, "dst": t})
            assert r["id"] == f"{s}-{t}"
            assert r["exact"] is True and "shed" not in r
            assert r["distance"] == float(exact[s, t])
        # Malformed lines get error responses, the connection survives.
        c.f.write("not json\n")
        c.f.flush()
        assert "error" in c.recv()
        r = c.ask({"id": "after", "source": 2, "dst": 5})
        assert r["exact"] is True
        c.close()
    finally:
        fe.drain()


def test_health_op(tmp_path):
    _, engine, fe = _world(tmp_path)
    try:
        c = _Client(fe)
        h = c.ask({"op": "health"})
        assert h["ok"] is True and h["protocol"] == PROTOCOL
        assert h["open_connections"] == 1
        assert h["shedding"] is False and h["draining"] is False
        assert h["rejected"] == 0 and h["deadline_drops"] == 0
        c.close()
    finally:
        fe.drain()


def test_health_reads_heartbeat_torn_file_degrades(tmp_path):
    """The health endpoint's heartbeat verdict must degrade to
    fresh=false on a torn/partial file, never crash the connection."""
    hb = tmp_path / "hb.json"
    hb.write_text('{"ts": 123.0, "stage": "fan')  # torn mid-rewrite
    _, engine, fe = _world(tmp_path, heartbeat_file=hb)
    try:
        c = _Client(fe)
        h = c.ask({"op": "health"})
        assert h["heartbeat"]["fresh"] is False
        assert "error" in h["heartbeat"]
        # The connection survived the torn read.
        assert c.ask({"source": 1, "dst": 2})["exact"] is True
        c.close()
    finally:
        fe.drain()


# -- admission control --------------------------------------------------------


def test_connection_bound_rejects_with_retry_after(tmp_path):
    _, engine, fe = _world(tmp_path, max_connections=1)
    try:
        c1 = _Client(fe)
        # Connection 2 is past the bound: one explicit line, then close.
        s2 = socket.create_connection(fe.address, timeout=10)
        f2 = s2.makefile("r", encoding="utf-8", newline="\n")
        r = json.loads(f2.readline())
        assert r["error"] == "overloaded"
        assert r["reason"] == "max_connections"
        assert r["retry_after_ms"] > 0
        assert f2.readline() == ""  # closed, not queued
        s2.close()
        assert engine.stats.rejected == 1
        # Slot freed -> next connection admitted.
        c1.close()
        deadline = time.time() + 10
        while engine.stats.open_connections and time.time() < deadline:
            time.sleep(0.01)
        c3 = _Client(fe)
        assert c3.ask({"source": 0, "dst": 1})["exact"] is True
        c3.close()
    finally:
        fe.drain()


def test_inflight_bound_rejects_instead_of_queueing(tmp_path):
    # serve_lookup stall holds the only in-flight slot long enough for
    # a second request to hit the bound (injectable sleep = real sleep
    # here: the stall must occupy wall-clock for the race to exist).
    plan = FaultPlan([Fault(stage="serve_lookup", kind="slow_ms",
                            attempt=1, slow_ms=600.0)])
    _, engine, fe = _world(tmp_path, config=_cfg(fault_plan=plan),
                           max_inflight=1)
    try:
        ca, cb = _Client(fe), _Client(fe)
        ca.send({"id": "slow", "source": 1, "dst": 2})
        time.sleep(0.15)  # let A occupy the slot inside the stall
        rb = cb.ask({"id": "fast", "source": 3, "dst": 4})
        assert rb["error"] == "overloaded"
        assert rb["reason"] == "max_inflight"
        assert rb["retry_after_ms"] > 0
        ra = ca.recv()  # A still completes exactly
        assert ra["exact"] is True
        assert engine.stats.rejected == 1
        ca.close()
        cb.close()
    finally:
        fe.drain()


def test_deadline_drop_never_touches_the_engine(tmp_path):
    plan = FaultPlan([Fault(stage="serve_lookup", kind="slow_ms",
                            attempt=1, slow_ms=600.0)])
    _, engine, fe = _world(tmp_path, config=_cfg(fault_plan=plan),
                           max_inflight=1)
    try:
        ca, cb = _Client(fe), _Client(fe)
        ca.send({"id": "slow", "source": 1, "dst": 2})
        time.sleep(0.15)
        t0 = time.perf_counter()
        rb = cb.ask({"id": "dl", "source": 3, "dst": 4,
                     "deadline_ms": 100})
        waited = time.perf_counter() - t0
        assert rb["error"] == "deadline"
        assert rb["deadline_ms"] == 100
        assert waited < 0.55  # dropped at its deadline, not after the stall
        assert ca.recv()["exact"] is True
        # The dropped request never reached the engine: one query total.
        assert engine.stats.queries_total == 1
        assert engine.stats.deadline_drops == 1
        assert engine.stats.rejected == 0
        ca.close()
        cb.close()
    finally:
        fe.drain()


def test_burn_sheds_misses_with_certified_bounds_and_recovers(tmp_path):
    g, engine, fe = _world(tmp_path, warm=16)
    exact = np.asarray(ParallelJohnsonSolver(_cfg()).solve(g).matrix)
    try:
        c = _Client(fe)
        _force_burn(engine)
        batches_before = engine.stats.batches_scheduled
        # Exact-MISS under burn: a flagged landmark answer, no solve.
        r = c.ask({"id": "miss", "source": 30, "dst": 5})
        assert r["shed"] is True and r["exact"] is False
        assert r["tier"] == "landmark"
        e = float(exact[30, 5])
        if not (np.isinf(r["distance"]) and np.isinf(e)):
            assert abs(r["distance"] - e) <= r["max_error"]
        assert engine.stats.batches_scheduled == batches_before
        assert engine.stats.shed_answers == 1
        # HIT under burn: still answered exactly, unflagged.
        r2 = c.ask({"id": "hit", "source": 3, "dst": 7})
        assert r2["exact"] is True and "shed" not in r2
        assert r2["distance"] == float(exact[3, 7])
        # Burn clears -> the same miss schedules a real solve again.
        _clear_burn(engine)
        r3 = c.ask({"id": "recovered", "source": 29, "dst": 5})
        assert r3["exact"] is True and "shed" not in r3
        assert r3["distance"] == float(exact[29, 5])
        assert engine.stats.batches_scheduled == batches_before + 1
        # Both transitions were counted (engage + disengage).
        assert engine.metrics.counter(
            "pjtpu_slo_shed_transitions").total == 2
        c.close()
    finally:
        fe.drain()


@pytest.mark.parametrize("policy", ["landmark", "reject"])
def test_shed_answers_and_counters_equal_reference(policy, tmp_path):
    """The same burn, the same requests through either package's front
    end (integer weights): the same answers, shed flags and bounds, and
    the same shed / rejected / scheduled counters."""
    from paralleljohnson_tpu import serve as ref_serve
    from paralleljohnson_tpu.config import SolverConfig as RefConfig
    from paralleljohnson_tpu.graphs import erdos_renyi as ref_er

    from paralleljohnson_tpu_torch.interop import graph_from_arrays

    ref_g = ref_er(32, 0.15, seed=3)
    ref_g = ref_g.with_weights(np.maximum(1.0, np.rint(ref_g.weights))
                               .astype(np.float32))
    reqs = [{"id": i, "source": s, "dst": t} for i, (s, t) in enumerate(
        [(30, 5), (3, 7), (25, 1), (30, 9), (2, 31)])]
    # Windows long enough that the forced burn outlasts the requests on a
    # loaded machine (the tight SLO's short window is one second).
    slo = SLO(name="serve", latency_ms=25.0, latency_pct=99.0,
              availability=0.9, rules=((120.0, 60.0, 2.0),))
    runs = []
    for pkg in ("port", "ref"):
        if pkg == "port":
            mod, g = serve, graph_from_arrays(ref_g.indptr, ref_g.indices,
                                              ref_g.weights)
            lm = mod.LandmarkIndex.build(g, 4, seed=0, device="cpu")
            engine = mod.QueryEngine(g, mod.TileStore(tmp_path / pkg, g),
                                     landmarks=lm, slo=slo,
                                     stats_interval_s=0, device="cpu")
        else:
            mod, g = ref_serve, ref_g
            cfg = RefConfig(backend="numpy")
            lm = mod.LandmarkIndex.build(g, 4, config=cfg, seed=0)
            engine = mod.QueryEngine(g, mod.TileStore(tmp_path / pkg, g),
                                     landmarks=lm, config=cfg,
                                     slo=slo, stats_interval_s=0)
        engine.warm(np.arange(16))
        fe = mod.ServeFrontend(engine, shed_policy=policy).start()
        try:
            c = _Client(fe)
            _force_burn(engine)
            out = [c.ask(dict(r)) for r in reqs]
            _clear_burn(engine)
            out.append(c.ask({"id": "after", "source": 30, "dst": 5}))
            c.close()
            st = engine.stats
            runs.append((out, (st.shed_answers, st.rejected,
                               st.batches_scheduled, st.queries_total,
                               st.exact_answers, st.approx_answers)))
        finally:
            fe.drain()
    assert runs[0] == runs[1]
    assert runs[0][1][:2] == ((3, 0) if policy == "landmark" else (0, 3))


def test_low_traffic_guard_keeps_single_failure_from_shedding(tmp_path):
    """A lone bad event on a near-idle server makes the burn-rate math
    scream (1/1 bad = the whole budget) — but with fewer than
    shed_min_events observations in the rule's long window the front
    end must NOT act on it: the next exact-miss still gets a real
    solve. Raising the volume past the guard with the same bad
    fraction DOES shed (the guard gates volume, not severity)."""
    g, engine, fe = _world(tmp_path, shed_min_events=20)
    try:
        c = _Client(fe)
        engine.metrics.observe_slo(engine.slo.name, None, ok=False)
        assert engine.slo_tracker().burning  # the verdict itself fires
        r = c.ask({"id": 1, "source": 30, "dst": 5})
        assert r["exact"] is True and "shed" not in r  # ...but no degrade
        assert engine.stats.shed_answers == 0
        _force_burn(engine, bad=50)  # real volume, same verdict
        r2 = c.ask({"id": 2, "source": 29, "dst": 5})
        assert r2["shed"] is True
        c.close()
    finally:
        fe.drain()


def test_shed_policy_reject_turns_misses_into_rejections(tmp_path):
    _, engine, fe = _world(tmp_path, shed_policy="reject")
    try:
        c = _Client(fe)
        _force_burn(engine)
        r = c.ask({"id": 1, "source": 30, "dst": 5})
        assert r["error"] == "overloaded" and r["shed"] is True
        assert r["reason"] == "shedding"
        assert engine.stats.rejected == 1
        assert engine.stats.shed_answers == 0
        # Hits still answer exactly under the reject policy too.
        assert c.ask({"source": 2, "dst": 3})["exact"] is True
        c.close()
    finally:
        fe.drain()


def test_shed_policy_off_never_sheds(tmp_path):
    _, engine, fe = _world(tmp_path, shed_policy="off")
    try:
        c = _Client(fe)
        _force_burn(engine)
        r = c.ask({"id": 1, "source": 30, "dst": 5})
        assert r["exact"] is True and "shed" not in r
        assert engine.stats.shed_answers == 0
        c.close()
    finally:
        fe.drain()


def test_shed_policy_landmark_requires_index(tmp_path):
    g = erdos_renyi(16, 0.2, seed=1)
    engine = QueryEngine(g, TileStore(None, g), config=_cfg(),
                         stats_interval_s=0)
    with pytest.raises(ValueError, match="shed_policy"):
        ServeFrontend(engine, shed_policy="landmark")
    with pytest.raises(ValueError, match="shed_policy"):
        ServeFrontend(engine, shed_policy="drop-everything")


# -- fault injection through the serving path ---------------------------------


def test_injected_solve_failure_is_an_error_response_not_a_hang(tmp_path):
    plan = FaultPlan([Fault(stage="serve_solve", kind="error",
                            attempt=1)])
    g, engine, fe = _world(tmp_path, config=_cfg(fault_plan=plan))
    exact = np.asarray(ParallelJohnsonSolver(_cfg()).solve(g).matrix)
    try:
        c = _Client(fe)
        r = c.ask({"id": "boom", "source": 30, "dst": 5})
        assert "internal" in r["error"] and "InjectedFaultError" in r["error"]
        assert engine.stats.errors == 1
        # The failure spent error budget (it is visible to the burn
        # alert), and the connection is still usable — the retry of the
        # same query now succeeds, bitwise.
        assert engine.slo_tracker().bad.total == 1
        # With ZERO good traffic beside it, that one bad event is a
        # 100% bad fraction — the tight burn rule fires and the retry
        # would (correctly) shed. Restore a healthy stream first: the
        # point here is the failure path, not the shedding path.
        _clear_burn(engine)
        r2 = c.ask({"id": "retry", "source": 30, "dst": 5})
        assert r2["exact"] is True
        assert r2["distance"] == float(exact[30, 5])
        c.close()
    finally:
        fe.drain()


def test_injected_accept_fault_refuses_connection_explicitly(tmp_path):
    plan = FaultPlan([Fault(stage="serve_accept", kind="error",
                            attempt=1)])
    _, engine, fe = _world(tmp_path, fault_plan=plan)
    try:
        s = socket.create_connection(fe.address, timeout=10)
        f = s.makefile("r", encoding="utf-8", newline="\n")
        r = json.loads(f.readline())
        assert r["error"] == "unavailable" and "injected" in r["detail"]
        assert f.readline() == ""
        s.close()
        # The next connection (attempt 2, no fault) serves normally.
        c = _Client(fe)
        assert c.ask({"source": 1, "dst": 2})["exact"] is True
        c.close()
    finally:
        fe.drain()


# -- drain + closed-engine contract -------------------------------------------


def test_drain_is_idempotent_and_closes_engine(tmp_path):
    from paralleljohnson_tpu_torch.serve import QueryError

    _, engine, fe = _world(tmp_path)
    fe.drain()
    fe.drain()  # second call: no-op, no exception
    assert engine.closed
    with pytest.raises(QueryError, match="closed"):
        engine.query(1, 2)
    # Snapshots flushed atomically by the drain (both readable).
    stats = json.loads(
        (engine.store.ckpt.dir / "serve_stats.json").read_text())
    assert "shed_answers" in stats["engine"]
    live = json.loads(
        (engine.store.ckpt.dir / "serve_live.json").read_text())
    assert live["kind"] == "live_metrics"


# -- per-client fairness --------------------------------


def test_per_client_cap_limits_the_hog_not_the_polite(tmp_path):
    # One global pool of 4 slots, one slot per client key: the hog's
    # second in-flight request is rejected with client_limited while a
    # polite client flows through untouched — admission fairness, not
    # first-come-first-starve.
    plan = FaultPlan([Fault(stage="serve_lookup", kind="slow_ms",
                            attempt=1, slow_ms=500.0)])
    _, engine, fe = _world(tmp_path, config=_cfg(fault_plan=plan),
                           max_inflight=4, max_inflight_per_client=1)
    try:
        hog_a, hog_b, polite = _Client(fe), _Client(fe), _Client(fe)
        hog_a.send({"id": "h1", "source": 1, "dst": 2,
                    "client_id": "hog"})
        time.sleep(0.15)  # the stall holds hog's one per-key slot
        rb = hog_b.ask({"id": "h2", "source": 3, "dst": 4,
                        "client_id": "hog"})
        assert rb["error"] == "overloaded"
        assert rb["client_limited"] is True
        assert rb["reason"] == "max_inflight_per_client"
        assert rb["retry_after_ms"] > 0
        # The polite client's slot is its own: global capacity remains.
        rp = polite.ask({"id": "p", "source": 5, "dst": 6,
                         "client_id": "polite"})
        assert rp.get("error") is None and rp["exact"] is True
        assert hog_a.recv()["exact"] is True  # the hog's first completes
        assert engine.stats.client_limited == 1
        assert engine.stats.rejected == 0  # the global bound never bit
        snap = engine.metrics.snapshot()
        assert snap["counters"]["pjtpu_client_limited"]["total"] == 1
        for c in (hog_a, hog_b, polite):
            c.close()
    finally:
        fe.drain()


def test_per_client_cap_falls_back_to_peer_address(tmp_path):
    # No client_id: the key is the peer address, so two connections
    # from the same host share one per-key slot.
    plan = FaultPlan([Fault(stage="serve_lookup", kind="slow_ms",
                            attempt=1, slow_ms=500.0)])
    _, engine, fe = _world(tmp_path, config=_cfg(fault_plan=plan),
                           max_inflight=4, max_inflight_per_client=1)
    try:
        ca, cb = _Client(fe), _Client(fe)
        ca.send({"id": "a", "source": 1, "dst": 2})
        time.sleep(0.15)
        rb = cb.ask({"id": "b", "source": 3, "dst": 4})
        assert rb["error"] == "overloaded"
        assert rb["client_limited"] is True
        assert ca.recv()["exact"] is True
        ca.close()
        cb.close()
    finally:
        fe.drain()


def test_client_limited_counter_rides_the_prom_table():
    from paralleljohnson_tpu_torch.serve import SERVE_PROM_METRICS

    names = [m[0] for m in SERVE_PROM_METRICS]
    assert "pjtpu_client_limited_total" in names


def test_per_client_two_client_hammer_no_starvation(tmp_path):
    # Concurrent hammer: the hog floods from many sockets under one
    # client_id while the polite client paces single requests. Every
    # polite request must answer exactly — zero starvation — and every
    # hog rejection is the flagged client_limited kind.
    _, engine, fe = _world(tmp_path, max_inflight=2,
                           max_inflight_per_client=1)
    try:
        stop = threading.Event()
        hog_answers, hog_limited, hog_other = [], [], []

        def hog(k):
            c = _Client(fe)
            i = 0
            while not stop.is_set():
                r = c.ask({"id": f"hog-{k}-{i}", "source": 1, "dst": 2,
                           "client_id": "hog"})
                if r.get("error") is None:
                    hog_answers.append(r)
                elif r.get("client_limited"):
                    hog_limited.append(r)
                else:
                    hog_other.append(r)
                i += 1

        threads = [threading.Thread(target=hog, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        polite = _Client(fe)
        polite_ok = 0
        for i in range(25):
            r = polite.ask({"id": f"p-{i}", "source": 3, "dst": 4,
                            "client_id": "polite"})
            assert r.get("error") is None, f"polite starved at {i}: {r}"
            assert r["exact"] is True
            polite_ok += 1
        # The hog's overlap is a race the scheduler decides: give it up
        # to 10 s more to hit its cap before the verdict.
        deadline = time.monotonic() + 10
        while not hog_limited and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        polite.close()
        assert polite_ok == 25
        assert hog_limited, "the hammer never hit the per-client cap"
        assert engine.stats.client_limited == len(hog_limited)
        # Global admission may also have bitten, but nothing unflagged.
        assert all(r["error"] == "overloaded" for r in hog_other)
    finally:
        fe.drain()


# -- HTTP adaptation ------------------------------------


def _http(fe, method, path, body=None, timeout=30.0):
    import http.client

    conn = http.client.HTTPConnection(*fe.address, timeout=timeout)
    payload = json.dumps(body) if body is not None else None
    conn.request(method, path, body=payload,
                 headers={"Content-Type": "application/json"}
                 if payload else {})
    resp = conn.getresponse()
    doc = json.loads(resp.read() or b"{}")
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, doc, headers


def test_http_query_healthz_and_404(tmp_path):
    g, engine, fe = _world(tmp_path, http=True)
    exact = np.asarray(ParallelJohnsonSolver(_cfg()).solve(g).matrix)
    try:
        status, doc, _ = _http(fe, "POST", "/query",
                               {"id": "q1", "source": 3, "dst": 9})
        assert status == 200
        assert doc["exact"] is True
        assert doc["distance"] == float(exact[3, 9])
        status, doc, _ = _http(fe, "GET", "/healthz")
        assert status == 200 and doc["ok"] is True
        status, doc, _ = _http(fe, "GET", "/nope")
        assert status == 404
        # A malformed body is a 400, not a dropped connection.
        import http.client
        conn = http.client.HTTPConnection(*fe.address, timeout=10)
        conn.request("POST", "/query", body="not json",
                     headers={"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
        conn.close()
    finally:
        fe.drain()


def test_http_frontend_still_speaks_line_protocol(tmp_path):
    """An ``--http`` replica must still serve ``pjtpu-serve/1`` traffic
    — the fleet router forwards line-protocol regardless of a replica's
    HTTP flag, so the listener sniffs per connection: HTTP clients send
    a method token first, line clients wait for the server header."""
    g, _, fe = _world(tmp_path, http=True)
    exact = np.asarray(ParallelJohnsonSolver(_cfg()).solve(g).matrix)
    try:
        c = _Client(fe)
        assert c.header["protocol"] == "pjtpu-serve/1"
        r = c.ask({"id": 1, "source": 3, "dst": 9})
        assert r["exact"] is True
        assert r["distance"] == float(exact[3, 9])
        c.close()
        # ...and the same listener still answers HTTP afterwards.
        status, doc, _ = _http(fe, "POST", "/query",
                               {"id": "q2", "source": 3, "dst": 9})
        assert status == 200 and doc["distance"] == float(exact[3, 9])
    finally:
        fe.drain()


def test_http_keepalive_two_queries_one_connection(tmp_path):
    import http.client

    g, _, fe = _world(tmp_path, http=True)
    exact = np.asarray(ParallelJohnsonSolver(_cfg()).solve(g).matrix)
    try:
        conn = http.client.HTTPConnection(*fe.address, timeout=30)
        for s, t in [(1, 8), (2, 12)]:
            conn.request("POST", "/query",
                         body=json.dumps({"source": s, "dst": t}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            doc = json.loads(resp.read())
            assert doc["distance"] == float(exact[s, t])
        conn.close()
    finally:
        fe.drain()


def test_http_overload_maps_429_with_retry_after(tmp_path):
    plan = FaultPlan([Fault(stage="serve_lookup", kind="slow_ms",
                            attempt=1, slow_ms=600.0)])
    _, engine, fe = _world(tmp_path, config=_cfg(fault_plan=plan),
                           max_inflight=1, http=True)
    try:
        slow_result = {}

        def slow():
            slow_result["resp"] = _http(
                fe, "POST", "/query", {"id": "slow", "source": 1,
                                       "dst": 2})

        t = threading.Thread(target=slow)
        t.start()
        time.sleep(0.2)  # the stall occupies the one in-flight slot
        status, doc, headers = _http(fe, "POST", "/query",
                                     {"id": "fast", "source": 3,
                                      "dst": 4})
        assert status == 429
        assert doc["error"] == "overloaded"
        assert int(headers["Retry-After"]) >= 1
        t.join(timeout=30)
        assert not t.is_alive()
        assert slow_result["resp"][0] == 200  # the slow one completed
    finally:
        fe.drain()


def test_http_healthz_503_on_stale_heartbeat(tmp_path):
    hb = tmp_path / "hb.json"
    hb.write_text(json.dumps({"ts": 123.0, "stage": "dead"}))  # ancient
    _, _, fe = _world(tmp_path, http=True, heartbeat_file=hb)
    try:
        status, doc, _ = _http(fe, "GET", "/healthz")
        assert status == 503
        assert doc["heartbeat"]["fresh"] is False
    finally:
        fe.drain()


# -- real signals / subprocesses (slow set; chaos drill is the full twin) ----


class _RecordingEngine:
    """A stand-in engine that records batch widths and echoes ids."""

    def __init__(self, delay_s=0.0):
        self.widths = []
        self.delay_s = delay_s

    def query_batch(self, reqs):
        if self.delay_s:
            time.sleep(self.delay_s)
        self.widths.append(len(reqs))
        return [{"id": r.get("id"), "ok": True} for r in reqs]


def _submit_all(mb, n):
    out = [None] * n

    def worker(i):
        out[i] = mb.submit({"id": i})

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    return out


def test_microbatcher_combines_and_routes_by_slot():
    eng = _RecordingEngine(delay_s=0.005)
    mb = MicroBatcher(eng, max_width=8, wait_ms=0.0)
    out = _submit_all(mb, 24)
    # Every submitter got ITS response back (slot routing, not ids).
    assert [o["id"] for o in out] == list(range(24))
    assert sum(eng.widths) == 24
    # The leader's batch-execution time convoys followers: widths
    # beyond 1 appear without any configured wait, and `combined`
    # counts exactly the members of those width>1 batches.
    assert max(eng.widths) > 1
    assert mb.combined == sum(w for w in eng.widths if w > 1)
    assert mb.batches == len(eng.widths)


def test_microbatcher_width_cap_is_hard():
    eng = _RecordingEngine(delay_s=0.01)
    mb = MicroBatcher(eng, max_width=4, wait_ms=2.0)
    _submit_all(mb, 17)
    assert max(eng.widths) <= 4
    assert sum(eng.widths) == 17


def test_microbatcher_single_caller_zero_wait_no_latency_tax():
    eng = _RecordingEngine()
    mb = MicroBatcher(eng, max_width=32, wait_ms=0.0)
    t0 = time.perf_counter()
    out = mb.submit({"id": 0})
    dt = time.perf_counter() - t0
    assert out["id"] == 0 and eng.widths == [1]
    assert dt < 0.5  # no sleep on the solo path


def test_microbatcher_exception_reaches_every_member():
    class _Boom:
        def query_batch(self, reqs):
            raise RuntimeError("store exploded")

    mb = MicroBatcher(_Boom(), max_width=8, wait_ms=1.0)
    errs = []

    def worker(i):
        try:
            mb.submit({"id": i})
        except RuntimeError as e:
            errs.append(str(e))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert errs == ["store exploded"] * 6


def test_frontend_batches_concurrent_socket_clients(tmp_path):
    """K concurrent socket clients must land in combined engine batches
    and still each receive their own (bitwise-correct) answer."""
    g, engine, frontend = _world(tmp_path, batch_window=8,
                                 batch_wait_ms=2.0, max_inflight=16)
    try:
        n = 12
        answers = [None] * n
        gate = threading.Barrier(n)

        def one(i):
            c = _Client(frontend)
            try:
                gate.wait(timeout=10)  # connect first, then fire together
                answers[i] = c.ask(
                    {"op": "query", "id": i, "source": i, "dst": (i + 3) % 32})
            finally:
                c.close()

        ts = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive()
        assert all(a is not None and "error" not in a for a in answers)
        for i, a in enumerate(answers):
            assert a["id"] == i
            assert a["distance"] == engine.query(i, (i + 3) % 32)["distance"]
        assert frontend.batcher is not None
        assert frontend.batcher.combined > 0  # some convoys formed
        # batch_width histogram observed the convoy widths
        stats = engine.stats.as_dict()
        assert "batch_width_p50" in stats
    finally:
        frontend.drain()


def test_frontend_batch_window_one_disables_batching(tmp_path):
    g, engine, frontend = _world(tmp_path, batch_window=1)
    try:
        assert frontend.batcher is None
        c = _Client(frontend)
        try:
            r = c.ask({"op": "query", "source": 1, "dst": 2})
            assert "distance" in r
        finally:
            c.close()
        assert frontend.health()["batch_window"] == 1
    finally:
        frontend.drain()



# -- the serve fleet (reference: tests/test_fleet_serve.py) --------------


def _members(rids, base_port=9000):
    return {rid: {"host": "127.0.0.1", "port": base_port + i}
            for i, rid in enumerate(rids)}


# -- membership records -------------------------------------------------------


def test_registration_record_beat_and_deregister(tmp_path):
    reg = ReplicaRegistration(tmp_path, "r0", host="127.0.0.1", port=7070,
                              graph_digest="abcd", interval_s=60.0)
    reg.beat()
    recs = read_replicas(tmp_path)
    assert [r["replica_id"] for r in recs] == ["r0"]
    assert recs[0]["port"] == 7070
    assert recs[0]["graph_digest"] == "abcd"
    assert recs[0]["stale"] is False
    assert recs[0]["age_s"] is not None
    ts1 = recs[0]["ts"]
    reg.beat()
    assert read_replicas(tmp_path)[0]["ts"] >= ts1
    reg.stop(deregister=True)
    assert read_replicas(tmp_path) == []


def test_read_replicas_flags_stale_and_torn(tmp_path):
    ReplicaRegistration(tmp_path, "fresh", host="h", port=1).beat()
    stale = ReplicaRegistration(tmp_path, "old", host="h", port=2)
    stale.beat()
    # Rewind the stale record's ts far past the staleness horizon.
    p = replicas_dir(tmp_path) / "old.json"
    rec = json.loads(p.read_text())
    rec["ts"] -= 3600.0
    p.write_text(json.dumps(rec))
    (replicas_dir(tmp_path) / "torn.json").write_text('{"kind": "serve_')
    by_id = {r["replica_id"]: r for r in read_replicas(tmp_path)}
    assert by_id["fresh"]["stale"] is False
    assert by_id["old"]["stale"] is True
    assert by_id["torn"]["torn"] is True and by_id["torn"]["stale"] is True
    # live_replicas serves routing: only the fresh record qualifies.
    assert [r["replica_id"] for r in live_replicas(tmp_path)] == ["fresh"]


# -- consistent-hash routing --------------------------------------------------


def test_routing_spreads_and_removal_moves_only_the_corpse(tmp_path):
    rids = ["a", "b", "c", "d"]
    table = RoutingTable(_members(rids), vnodes=64)
    sources = [str(s) for s in range(3000)]
    owners = {s: table.owner(s) for s in sources}
    counts = {rid: sum(1 for o in owners.values() if o == rid)
              for rid in rids}
    # Balanced-ish: every replica owns a real share.
    assert all(c > len(sources) * 0.1 for c in counts.values()), counts
    # Remove one replica: the STRONG consistency claim — every source a
    # survivor owned stays with that survivor; only "c"'s sources move.
    survivors = RoutingTable(_members(["a", "b", "d"]), vnodes=64)
    moved = 0
    for s in sources:
        if owners[s] == "c":
            moved += 1
            assert survivors.owner(s) != "c"
        else:
            assert survivors.owner(s) == owners[s], s
    assert moved == counts["c"]
    assert moved < len(sources) * 0.5  # ~1/N, never a wholesale reshuffle


def test_routing_owner_hash_is_process_stable():
    # blake2b, never Python hash(): two tables built independently agree.
    t1 = RoutingTable(_members(["x", "y"]), vnodes=32)
    t2 = RoutingTable(_members(["x", "y"]), vnodes=32)
    assert [t1.owner(str(s)) for s in range(100)] == \
        [t2.owner(str(s)) for s in range(100)]
    assert RoutingTable({}).owner("5") is None
    # ...and the reference's ring puts every source where the port's does.
    t3 = ref_fleet.RoutingTable(_members(["x", "y"]), vnodes=32)
    assert [t3.owner(str(s)) for s in range(100)] == \
        [t1.owner(str(s)) for s in range(100)]


def test_publish_routing_epoch_monotonic_and_round_trips(tmp_path):
    t1 = publish_routing(tmp_path, _members(["a", "b"]))
    t2 = publish_routing(tmp_path, _members(["a"]))
    assert t2.epoch > t1.epoch
    got = read_routing(tmp_path)
    assert got.epoch == t2.epoch
    assert got.address("a") == ("127.0.0.1", 9000)
    assert got.owner("7") == "a"
    # min_epoch lets a router fence off a stale table it already beat.
    t3 = publish_routing(tmp_path, _members(["a", "b"]), min_epoch=50)
    assert t3.epoch == 50


def test_torn_routing_json_reads_as_none(tmp_path):
    publish_routing(tmp_path, _members(["a"]))
    routing_path(tmp_path).write_text('{"kind": "serve_routing", "ep')
    assert read_routing(tmp_path) is None  # degrade, never raise


# -- the forwarding router ----------------------------------------------------


def _replica_world(tmp_path, name, g, fleet_dir, exact_warm):
    store = TileStore(tmp_path / name, g, warm_rows=g.num_nodes)
    engine = QueryEngine(g, store, config=_cfg(), stats_interval_s=0)
    engine.warm(exact_warm)
    fe = ServeFrontend(engine, shed_policy="reject", fleet_dir=fleet_dir,
                       replica_id=name, fleet_heartbeat_s=0.2).start()
    return fe


class _LineClient:
    def __init__(self, addr, timeout=30.0):
        self.sock = socket.create_connection(addr, timeout=timeout)
        self.sock.settimeout(timeout)
        self.f = self.sock.makefile("rw", encoding="utf-8", newline="\n")
        self.header = json.loads(self.f.readline())

    def ask(self, req: dict) -> dict:
        self.f.write(json.dumps(req) + "\n")
        self.f.flush()
        return json.loads(self.f.readline())

    def close(self):
        self.f.close()
        self.sock.close()


def test_router_forwards_and_misroute_is_only_colder(tmp_path):
    g = grid2d(5, 5, seed=0)
    n = g.num_nodes
    exact = np.asarray(ParallelJohnsonSolver(_cfg()).solve(g).matrix)
    fleet = tmp_path / "fleet"
    fes = [_replica_world(tmp_path, f"rep-{i}", g, fleet, np.arange(n))
           for i in range(2)]
    router = None
    try:
        router = FleetRouter(fleet, stale_after_s=5.0,
                             refresh_interval_s=0.1).start()
        c = _LineClient(router.address())
        assert c.header["router"] is True
        assert c.header["protocol"] == "pjtpu-serve/1"
        table = router.table
        for s in range(0, n, 3):
            r = c.ask({"id": s, "source": s, "dst": (s * 7) % n})
            assert r.get("error") is None, r
            assert r["exact"] is True
            assert float(r["distance"]) == float(exact[s, (s * 7) % n])
        # health through the router aggregates the fleet.
        h = c.ask({"op": "health"})
        assert h["router"] is True and h["replicas_live"] == 2
        c.close()
        # Misroute on purpose: ask the replica that does NOT own source
        # 0 directly. Ownership is a locality hint — the answer must be
        # byte-identical anyway.
        owner = table.owner("0")
        non_owner = next(fe for fe in fes if fe.replica_id != owner)
        d = _LineClient(non_owner.address)
        r = d.ask({"id": "mis", "source": 0, "dst": n - 1})
        assert r["exact"] is True
        assert float(r["distance"]) == float(exact[0, n - 1])
        d.close()
    finally:
        if router is not None:
            router.drain()
        for fe in fes:
            fe.drain()


def test_router_with_empty_fleet_returns_unavailable(tmp_path):
    router = FleetRouter(tmp_path / "nobody", stale_after_s=1.0,
                         max_attempts=2, retry_after_ms=7).start()
    try:
        c = _LineClient(router.address())
        r = c.ask({"id": 1, "source": 0, "dst": 1})
        assert r["error"] == "unavailable"
        assert r["retry_after_ms"] == 7
        c.close()
    finally:
        router.drain()


# -- merged fleet observability ----------------------------------------------


def _fleet_record(fleet_dir, rid, hist, *, stale=False, slo=None):
    """A membership record carrying a live snapshot, the shape the
    frontend's heartbeat payload_fn publishes."""
    reg = ReplicaRegistration(fleet_dir, rid, host="127.0.0.1", port=1234)
    reg.beat()
    p = replicas_dir(fleet_dir) / f"{rid}.json"
    rec = json.loads(p.read_text())
    rec["live"] = {
        "kind": "live_metrics",
        "counters": {"pjtpu_queries": {"total": hist.count}},
        "histograms": {"pjtpu_query_latency_ms": hist.summary()},
        "slos": {"serve": slo or {
            "burning": False, "bad_total": 0.0,
            "events_total": float(hist.count),
            "objective": {"latency_ms": 10_000.0, "latency_pct": 99.0},
        }},
    }
    if stale:
        rec["ts"] -= 3600.0
    p.write_text(json.dumps(rec))


def test_fleet_merge_matches_pooled_sample_oracle(tmp_path):
    rng = np.random.default_rng(7)
    s1 = rng.lognormal(0.0, 1.0, 4000)
    s2 = rng.lognormal(1.0, 0.7, 4000)
    h1, h2 = LogHistogram(), LogHistogram()
    h1.record_many(s1)
    h2.record_many(s2)
    _fleet_record(tmp_path, "r1", h1)
    _fleet_record(tmp_path, "r2", h2)
    publish_routing(tmp_path, _members(["r1", "r2"]))
    doc = gather_ops(serve_fleet=tmp_path)
    sf = doc["serve_fleet"]
    merged = sf["merged"]
    assert merged.get("histogram_merge_error") is None
    assert sf["routing"]["epoch"] == 1
    assert sorted(sf["replicas"]) == ["r1", "r2"]
    # The merged estimate must land within its own one-bucket bound of
    # the pooled-sample oracle — exactly what a pooled histogram of all
    # 8000 samples would certify.
    pooled = np.concatenate([s1, s2])
    for p in (50, 99):
        oracle = float(np.percentile(pooled, p,
                                     method="inverted_cdf"))
        est = merged[f"p{p}_ms"]
        err = merged[f"p{p}_err_ms"]
        assert abs(est - oracle) <= err + 1e-9, (p, est, oracle, err)
    assert merged["verdict"] == "ok"
    # Render path never chokes on the fleet document.
    assert "SERVE-FLEET" in render_ops(doc)


def test_fleet_merge_geometry_guard_degrades(tmp_path):
    h1 = LogHistogram()
    h2 = LogHistogram(lo=0.5, hi=100.0, growth=2.0)  # mismatched bins
    h1.record_many([1.0, 2.0, 3.0])
    h2.record_many([1.0, 2.0, 3.0])
    _fleet_record(tmp_path, "r1", h1)
    _fleet_record(tmp_path, "r2", h2)
    doc = gather_ops(serve_fleet=tmp_path)
    merged = doc["serve_fleet"]["merged"]
    assert "different geometry" in merged["histogram_merge_error"]
    assert merged.get("p99_ms") is None
    render_ops(doc)  # geometry guard renders, never crashes


def test_fleet_view_flags_dead_replica_and_excludes_it(tmp_path):
    h1, h2 = LogHistogram(), LogHistogram()
    h1.record_many([1.0] * 10)
    h2.record_many([500.0] * 10)
    _fleet_record(tmp_path, "alive", h1)
    _fleet_record(tmp_path, "dead", h2, stale=True)
    (replicas_dir(tmp_path) / "torn.json").write_text("{nope")
    doc = gather_ops(serve_fleet=tmp_path)
    sf = doc["serve_fleet"]
    assert sf["replicas"]["dead"]["stale"] is True
    assert sf["replicas"]["torn"]["torn"] is True
    assert sf["merged"]["replicas_live"] == 1
    # The dead replica's 500 ms tail must NOT pollute the merged view.
    assert sf["merged"]["p99_ms"] < 100.0
    out = render_ops(doc)
    assert "STALE" in out or "stale" in out


# -- live-fleet miss path --------------------------------------


def test_second_process_commit_turns_miss_into_cold_hit(tmp_path):
    g = erdos_renyi(24, 0.2, seed=5)
    n = g.num_nodes
    store = TileStore(tmp_path / "shared", g, warm_rows=4)
    engine = QueryEngine(g, store, config=_cfg(), stats_interval_s=0)
    engine.warm([0, 1])
    scheduled_before = engine.stats.batches_scheduled

    # "Another replica" commits sources 5..9 into the SAME checkpoint
    # dir — a separate TileStore over a separate engine, the way a
    # fleet peer would.
    peer_store = TileStore(tmp_path / "shared", g, warm_rows=4)
    peer = QueryEngine(g, peer_store, config=_cfg(), stats_interval_s=0)
    peer.warm([5, 6, 7, 8, 9])
    peer.close()

    # The next would-be miss re-scans the manifest first: cold hit, no
    # scheduled solve.
    resp = engine.query_batch([{"source": 5, "dst": 3}])[0]
    assert resp["exact"] is True
    assert engine.stats.batches_scheduled == scheduled_before
    # A genuinely unsolved source still schedules (the re-scan is a
    # freshness check, not a suppressor).
    engine.query_batch([{"source": 15, "dst": 3}])
    assert engine.stats.batches_scheduled == scheduled_before + 1
    exact = np.asarray(ParallelJohnsonSolver(_cfg()).solve(g).matrix)
    assert float(resp["distance"]) == float(exact[5, 3])
    engine.close()



# -- the operations console (reference: tests/test_top.py) ---------------


@pytest.fixture(scope="module")
def ops_world(tmp_path_factory):
    """One serve store (stats + repair marker) and one finished
    in-process fleet, shared by the gather/render/CLI tests."""
    root = tmp_path_factory.mktemp("ops")
    store_dir = root / "store"
    coord_dir = root / "coord"

    g = erdos_renyi(32, 0.12, seed=3)
    store = TileStore(store_dir, g)
    engine = QueryEngine(g, store, config=SolverConfig(),
                        stats_interval_s=0)
    for s in range(5):
        engine.query(s, (s + 1) % 32)
    engine.close()  # publishes serve_stats.json (with ts + live view)
    write_repair_status(
        store.ckpt.dir, status="repairing", new_digest="feed",
        affected=[1, 2, 3], total_sources=32, dirty_parts=1, parts_total=4,
    )

    from paralleljohnson_tpu_torch.distributed import plan_fleet
    from paralleljohnson_tpu_torch.distributed.launch import run_in_process_fleet

    coord = plan_fleet(coord_dir, "er:n=48,p=0.1,seed=1", n_workers=2,
                       backend="numpy")
    report = run_in_process_fleet(coord, 2, device="cpu")
    assert report.ok
    return {"store": store_dir, "coord": coord_dir}


def test_gather_joins_all_four_surfaces(ops_world):
    doc = gather_ops(serve_store=ops_world["store"],
                     coordinator_dir=ops_world["coord"])
    # The reference's console reads the same files into the same document.
    assert ref_top.gather_ops(serve_store=ops_world["store"],
                              coordinator_dir=ops_world["coord"],
                              now=doc["ts"]) == doc
    # serve: throughput + bounded latency + SLO state.
    assert len(doc["serve"]) == 1
    s = doc["serve"][0]["serve"]
    assert s["queries_total"] == 5
    assert s["p99_ms"] > 0 and s["p99_err_ms"] >= 0
    assert s["stale"] is False
    assert s["live"]["slos"]["serve"]["burning"] is False
    assert "rate_60s" in s["live"]["rates"]["pjtpu_queries"]
    # fleet: lease table + per-worker heartbeats/metrics with ETAs.
    fleet = doc["fleet"]
    assert fleet["done"] is True
    assert fleet["leases"]["committed"] == fleet["leases_total"]
    assert set(fleet["workers"]) == {"w0", "w1"}
    w0 = fleet["workers"]["w0"]
    assert w0["leases_committed"] >= 1
    assert "eta_s" in w0
    assert w0["metrics"]["histograms"]["pjtpu_lease_wall_ms"]["count"] >= 1
    # repair status rides along.
    assert doc["repairs"][0]["status"] == "repairing"
    assert doc["repairs"][0]["dirty_parts"] == 1
    assert doc["repairs"][0]["affected"] == 3


def test_snapshots_flagged_stale_by_age(ops_world):
    """The same world read with a zero stale threshold: every snapshot
    is still READABLE but now flagged stale — the dead-producer view."""
    doc = gather_ops(serve_store=ops_world["store"],
                     coordinator_dir=ops_world["coord"],
                     stale_after_s=0.0)
    assert doc["serve"][0]["serve"]["stale"] is True
    assert doc["serve"][0]["serve"]["queries_total"] == 5  # readable
    for w in doc["fleet"]["workers"].values():
        assert w["stale"] is True
    assert doc["repairs"][0]["stale"] is True


def test_top_shed_rate_column(tmp_path):
    """a serve entry whose frontend shed/rejected under
    overload surfaces those counters (plus the 60 s shed RATE from the
    live snapshot) in the gathered document and the rendered console;
    a plain JSONL-loop serve (all zeros) keeps the old layout."""
    import time as _time

    from paralleljohnson_tpu_torch.serve.engine import SERVE_STATS_FILENAME

    d = tmp_path / "graph_feed"
    d.mkdir(parents=True)
    now = _time.time()
    (d / SERVE_STATS_FILENAME).write_text(json.dumps({
        "ts": now, "pid": 1234,
        "engine": {
            "queries_total": 100, "errors": 2, "stale_answers": 0,
            "shed_answers": 17, "rejected": 9, "deadline_drops": 3,
            "open_connections": 4,
            "p50_ms": 1.0, "p50_err_ms": 0.1,
            "p99_ms": 5.0, "p99_err_ms": 0.5,
            "hits_by_tier": {"hot": 83},
        },
        "store": {"hit_rate": 0.9, "digest": "feed"},
        "live": {
            "kind": "live_metrics",
            "counters": {
                "pjtpu_queries": {"total": 100, "rate_60s": 10.0},
                "pjtpu_shed_answers": {"total": 17, "rate_60s": 1.7},
            },
        },
    }))
    doc = gather_ops(serve_store=tmp_path, now=now)
    s = doc["serve"][0]["serve"]
    assert s["shed_answers"] == 17 and s["shed_rate_60s"] == 1.7
    assert s["rejected"] == 9 and s["deadline_drops"] == 3
    assert s["open_connections"] == 4
    text = render_ops(doc)
    assert "shed 17 (1.70/s 1m)" in text
    assert "rejected 9" in text and "deadline-drops 3" in text
    # All-zero overload counters: the overload line is omitted.
    payload = json.loads((d / SERVE_STATS_FILENAME).read_text())
    for k in ("shed_answers", "rejected", "deadline_drops",
              "open_connections"):
        payload["engine"][k] = 0
    (d / SERVE_STATS_FILENAME).write_text(json.dumps(payload))
    text = render_ops(gather_ops(serve_store=tmp_path, now=now))
    assert "rejected" not in text and "deadline-drops" not in text


def test_top_tolerates_missing_sources(tmp_path):
    """Absent serve stats / a dir that is not a coordinator: the
    console reports what it can instead of crashing (an ops tool must
    work mid-incident, when files are half-missing)."""
    doc = gather_ops(serve_store=tmp_path / "nope",
                     coordinator_dir=tmp_path / "empty")
    assert doc["serve"] == [] and doc["repairs"] == []
    assert "error" in doc["fleet"]
    text = render_ops(doc)
    assert "FLEET" in text


def test_top_lookup_path_line(tmp_path):
    """device/host lookup counters and the aggregated batch
    width percentiles surface in the gathered document and the render;
    an engine that never moved either counter keeps the old layout."""
    import time as _time

    from paralleljohnson_tpu_torch.serve.engine import SERVE_STATS_FILENAME

    d = tmp_path / "graph_feed"
    d.mkdir(parents=True)
    now = _time.time()
    (d / SERVE_STATS_FILENAME).write_text(json.dumps({
        "ts": now, "pid": 99,
        "engine": {
            "queries_total": 60, "errors": 0, "stale_answers": 0,
            "device_lookups": 41, "host_lookups": 19,
            "batch_width_p50": 8.0, "batch_width_p99": 16.0,
            "p50_ms": 1.0, "p50_err_ms": 0.1,
            "p99_ms": 5.0, "p99_err_ms": 0.5,
            "hits_by_tier": {"hot": 41},
        },
        "store": {"hit_rate": 0.9, "digest": "feed"},
    }))
    doc = gather_ops(serve_store=tmp_path, now=now)
    s = doc["serve"][0]["serve"]
    assert s["device_lookups"] == 41 and s["host_lookups"] == 19
    assert s["batch_width_p50"] == 8.0
    text = render_ops(doc)
    assert "lookups device 41 / host 19" in text
    assert "batch-width p50 8.00 p99 16.00" in text
    payload = json.loads((d / SERVE_STATS_FILENAME).read_text())
    payload["engine"]["device_lookups"] = 0
    payload["engine"]["host_lookups"] = 0
    (d / SERVE_STATS_FILENAME).write_text(json.dumps(payload))
    text = render_ops(gather_ops(serve_store=tmp_path, now=now))
    assert "lookups device" not in text

