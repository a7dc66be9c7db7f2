"""PyTorch port: telemetry (``utils/telemetry.py``), the live metrics and
request tracing it carries (``observe/{live,trace}.py``), and the
profiler scope (``utils/profiling.py``), against the JAX package.

A pinned-route solve with a flight recorder gives the same span names
with the same parents, and the same events, in both packages; so does
the faulted pipelined solve (a transient error, a double OOM: window
collapse, then batch halving). The port's Chrome trace validates, the
reference's assembler reads the port's flight files, and the metrics
registries agree after a 4-batch solve. On the CPU the heartbeat
reports no device memory: CUDA is never initialised."""

import collections
import dataclasses
import io
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import erdos_renyi, random_dag
from paralleljohnson_tpu.observe import trace as ref_trace
from paralleljohnson_tpu.observe.live import MetricsRegistry as RefRegistry
from paralleljohnson_tpu.solver import ParallelJohnsonSolver as RefSolver
from paralleljohnson_tpu.utils import telemetry as ref_tel
from paralleljohnson_tpu.utils.faults import Fault as RefFault
from paralleljohnson_tpu.utils.faults import FaultPlan as RefFaultPlan
from paralleljohnson_tpu.utils.metrics import (
    latency_percentiles as ref_latency_percentiles,
)

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop
from paralleljohnson_tpu_torch.observe import trace
from paralleljohnson_tpu_torch.observe.live import MetricsRegistry
from paralleljohnson_tpu_torch.utils import profiling
from paralleljohnson_tpu_torch.utils.faults import Fault, FaultPlan
from paralleljohnson_tpu_torch.utils.metrics import (
    SolverStats,
    latency_percentiles,
    phase_timer,
)
from paralleljohnson_tpu_torch.utils.telemetry import (
    NULL_TELEMETRY,
    HeartbeatReporter,
    Telemetry,
    Tracer,
    validate_chrome_trace,
    validate_prom_text,
    write_prom_metrics,
)

PINNED = dict(use_pallas=True, mesh_shape=(1,), fw=False, frontier=False,
              dia=False, gauss_seidel=False, bucket=False)


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


def _tree(records):
    """(span name, parent span name) pairs and event names, as multisets:
    the flight file's story without ids, times or threads. The port's
    step spans (``pj.*``, which the JAX package does not have) are left
    out, a span under one counted under its nearest other ancestor."""
    begins = {r["id"]: r for r in records if r["type"] == "span_begin"}

    def parent_name(b):
        parent = b["parent"]
        while parent and begins[parent]["name"].startswith("pj."):
            parent = begins[parent]["parent"]
        return begins[parent]["name"] if parent else None

    spans = collections.Counter(
        (b["name"], parent_name(b)) for b in begins.values()
        if not b["name"].startswith("pj."))
    events = collections.Counter(r["name"] for r in records
                                 if r["type"] == "event")
    return spans, events


def _flight(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def _solve_both(tmp_path, graph, sources, ref_kw, port_kw, *, port_device):
    """One traced solve per package into its own flight file; returns
    (ref records, port records, ref result, port result, port telemetry)."""
    out = []
    for pkg, make, solver_of, g in (
        ("ref", ref_tel.Telemetry.create,
         lambda tel: RefSolver(RefConfig(telemetry=tel, **ref_kw)), graph),
        ("port", Telemetry.create,
         lambda tel: pjt.ParallelJohnsonSolver(
             pjt.SolverConfig(telemetry=tel, **port_kw), device=port_device),
         _port(graph)),
    ):
        tel = make(trace_dir=tmp_path / pkg, label=pkg)
        res = solver_of(tel).solve(g, sources)
        tel.close()
        out.append((_flight(tmp_path / pkg / f"flight-{pkg}.jsonl"), res, tel))
    (ref_recs, ref_res, _), (port_recs, port_res, port_tel) = out
    return ref_recs, port_recs, ref_res, port_res, port_tel


def test_pinned_solve_spans_and_events_equal_reference(tmp_path):
    """Negative weights (phase 1 on ``sweep``, reweight), four checkpointed
    batches at depth 2 on the hand sweep route: the same spans under the
    same parents and the same events (routes, the sweep's trajectory,
    window and resume markers) in both flight files."""
    g = random_dag(120, 0.06, negative_fraction=0.4, seed=5)
    g = g.with_weights(np.round(g.weights))
    kw = dict(PINNED, source_batch_size=32, pipeline_depth=2)
    ref_recs, port_recs, ref_res, port_res, tel = _solve_both(
        tmp_path, g, None, dict(kw, checkpoint_dir=str(tmp_path / "rc")),
        dict(kw, checkpoint_dir=str(tmp_path / "pc")), port_device="cpu")
    assert port_res.stats.routes_by_phase == ref_res.stats.routes_by_phase
    np.testing.assert_array_equal(port_res.matrix, np.asarray(ref_res.matrix))
    spans, events = _tree(port_recs)
    assert (spans, events) == _tree(ref_recs)
    assert spans[("ckpt_write", "finalize")] + spans[
        ("ckpt_write", "download")] == 4
    assert events["route"] == 5 and events["trajectory"] == 1
    route_of = {(e["attrs"]["stage"], e["attrs"].get("batch")):
                e["attrs"]["route"] for e in port_recs
                if e.get("name") == "route"}
    assert route_of[("bellman_ford", None)] == "sweep"
    assert route_of[("fanout", 3)] == "pallas-vm"
    validate_chrome_trace(json.loads(
        (tmp_path / "port" / "trace-port.json").read_text()))
    summary = tel.summary()
    assert summary["open_spans"] == 0 and summary["events"]["route"] == 5


def _faulted(pkg, tmp_path):
    if pkg == "ref":
        plan = RefFaultPlan([
            RefFault(stage="fanout", kind="error", batch=0, attempt=1),
            RefFault(stage="fanout", kind="oom", batch=1, attempt=1,
                     times=2)])
        tel = ref_tel.Telemetry.create(trace_dir=tmp_path, label=pkg)
        cfg = RefConfig(backend="numpy", source_batch_size=32,
                        pipeline_depth=2, fault_plan=plan,
                        checkpoint_dir=str(tmp_path / "ck"),
                        retry_backoff_s=0.001, telemetry=tel)
        res = RefSolver(cfg).solve(erdos_renyi(96, 0.08, seed=5))
    else:
        plan = FaultPlan([
            Fault(stage="fanout", kind="error", batch=0, attempt=1),
            Fault(stage="fanout", kind="oom", batch=1, attempt=1, times=2)])
        tel = Telemetry.create(trace_dir=tmp_path, label=pkg)
        cfg = pjt.SolverConfig(**PINNED, source_batch_size=32,
                               pipeline_depth=2, fault_plan=plan,
                               checkpoint_dir=str(tmp_path / "ck"),
                               retry_backoff_s=0.001, telemetry=tel)
        res = pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(
            _port(erdos_renyi(96, 0.08, seed=5)))
    tel.close()
    return _flight(tmp_path / f"flight-{pkg}.jsonl"), res


def test_faulted_solve_tells_the_reference_story(tmp_path):
    """The retry, the window collapse before the batch halving 32 -> 16,
    the failed attempts' error spans and every checkpoint write on its
    writer thread, parented to the finalize that submitted it."""
    ref_recs, ref_res = _faulted("ref", tmp_path / "ref")
    port_recs, port_res = _faulted("port", tmp_path / "port")
    np.testing.assert_allclose(port_res.matrix, ref_res.matrix, rtol=1e-6)
    assert _tree(port_recs) == _tree(ref_recs)

    def story(recs):
        ends = {r["id"]: r for r in recs if r["type"] == "span_end"}
        return ([(e["name"], e["attrs"]) for e in recs
                 if e["type"] == "event" and e["name"] != "route"],
                [(b["attrs"]["batch"], b["attrs"]["attempt"],
                  ends[b["id"]]["status"]) for b in recs
                 if b["type"] == "span_begin" and b["name"] == "fanout"])

    assert story(port_recs) == story(ref_recs)
    events = [e for e in port_recs if e["type"] == "event"]
    names = [e["name"] for e in events]
    assert names.index("window_collapse") < names.index("oom_degrade")
    begins = {r["id"]: r for r in port_recs if r["type"] == "span_begin"}
    ckpt = [b for b in begins.values() if b["name"] == "ckpt_write"]
    assert len(ckpt) == 5
    assert all("ckpt-writer" in b["thread"] for b in ckpt)
    assert all(begins[b["parent"]]["name"] in ("finalize", "download")
               for b in ckpt)
    assert any("pipeline" in b["thread"] for b in begins.values()
               if b["name"] == "finalize")
    assert port_res.stats.final_batch == 16
    assert port_res.stats.final_pipeline_depth == 1


def test_reference_assembler_reads_the_ports_flight_files(tmp_path):
    """A solve under a sampled trace: the reference's assembler joins the
    port's flight file into one single-rooted trace holding every span."""
    g = _port(erdos_renyi(64, 0.1, seed=2))
    tel = Telemetry.create(trace_dir=tmp_path, label="traced")
    ctx = trace.TraceContext(trace.mint_trace_id())
    with trace.use_trace(ctx):
        pjt.ParallelJohnsonSolver(
            pjt.SolverConfig(source_batch_size=16, telemetry=tel),
            device="cpu").solve(g)
    tel.close()
    assembly = ref_trace.assemble([tmp_path])
    (proc,) = assembly["processes"]
    recs = _flight(tmp_path / "flight-traced.jsonl")
    assert proc["n_records"] == len(recs) and proc["label"] == "traced"
    got = assembly["traces"][ctx.trace_id]
    assert len(got["spans"]) == sum(r["type"] == "span_begin" for r in recs)
    assert got["single_rooted"] and not got["open"]
    assert {s["name"] for s in got["spans"]} >= {"solve", "finalize",
                                                  "fanout"}
    # And the port's own assembler reads the reference's format alike.
    ours = trace.assemble([tmp_path])
    assert set(ours["traces"]) == {ctx.trace_id}
    assert len(ours["traces"][ctx.trace_id]["spans"]) == len(got["spans"])


def test_metrics_registries_agree_after_four_batches():
    g = erdos_renyi(64, 0.1, seed=3)
    ref_m, port_m = RefRegistry(), MetricsRegistry()
    RefSolver(RefConfig(**PINNED, source_batch_size=16,
                        metrics=ref_m)).solve(g)
    pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(**PINNED, source_batch_size=16, metrics=port_m),
        device="cpu").solve(_port(g))
    ours, theirs = port_m.snapshot(), ref_m.snapshot()
    assert {k: v["total"] for k, v in ours["counters"].items()} == {
        k: v["total"] for k, v in theirs["counters"].items()} == {
        "pjtpu_solver_batches": 4.0}
    assert ours["histograms"]["pjtpu_solver_batch_wall_ms"]["count"] == 4
    assert theirs["histograms"]["pjtpu_solver_batch_wall_ms"]["count"] == 4


def test_convergence_auto_records_for_a_telemetry_sink():
    """``convergence="auto"`` instruments the routes when a telemetry sink
    is set, as the reference does, and a ``trajectory`` event carries the
    summary and the frontier curve."""
    g = _port(erdos_renyi(300, 0.02, seed=3))
    cfg = dict(PINNED, use_pallas=False)
    plain = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**cfg),
                                      device="cpu").solve(g, np.arange(8))
    assert not plain.stats.convergence
    tel = Telemetry(tracer=Tracer())
    traced = pjt.ParallelJohnsonSolver(pjt.SolverConfig(telemetry=tel, **cfg),
                                       device="cpu").solve(g, np.arange(8))
    assert traced.stats.convergence["fanout"]["iterations"] > 0
    (event,) = [r for r in tel.tracer.records() if r.get("name") ==
                "trajectory"]
    assert event["attrs"]["route"] == "vm"
    assert event["attrs"]["frontier_curve"]
    np.testing.assert_array_equal(traced.matrix, plain.matrix)


def test_heartbeat_without_cuda_reports_no_device_memory(tmp_path):
    hb = HeartbeatReporter(tmp_path / "hb.json", interval_s=0.05).start()
    hb.update(stage="fanout", batch=1)
    time.sleep(0.15)
    hb.stop()
    payload = json.loads((tmp_path / "hb.json").read_text())
    assert payload["stage"] == "fanout" and payload["seq"] >= 2
    assert payload["device_memory"] is None
    assert not torch.cuda.is_initialized()


def test_heartbeat_follows_a_multibatch_solve(tmp_path):
    tel = Telemetry.create(heartbeat_file=tmp_path / "hb.json",
                           heartbeat_interval_s=0.05)
    g = _port(erdos_renyi(64, 0.1, seed=3))
    pjt.ParallelJohnsonSolver(pjt.SolverConfig(source_batch_size=16,
                                               telemetry=tel),
                              device="cpu").solve(g)
    tel.close()
    hb = json.loads((tmp_path / "hb.json").read_text())
    assert (hb["op"], hb["batches_done"], hb["sources_done"]) == (
        "solve", 4, 64)
    assert hb["roofline_bound"]


def test_null_telemetry_is_the_default():
    solver = pjt.ParallelJohnsonSolver(device="cpu")
    assert solver._tel is NULL_TELEMETRY and not NULL_TELEMETRY
    assert NULL_TELEMETRY.span("a") is NULL_TELEMETRY.span("b")


def test_phase_timer_span_closes_with_the_error():
    tel = Telemetry(tracer=Tracer())
    stats = SolverStats()
    with pytest.raises(RuntimeError):
        with phase_timer(stats, "upload", tel):
            raise RuntimeError("dead phase")
    begin, end = [r for r in tel.tracer.records() if r["type"] != "meta"]
    assert begin["name"] == "phase:upload" and begin["attrs"] == {
        "kind": "phase"}
    assert end["status"] == "error" and "dead phase" in end["error"]
    assert stats.phase_seconds["upload"] >= 0


@pytest.mark.parametrize("kind", ["seeded", "empty", "generator"])
def test_latency_percentiles_equals_reference(kind):
    """``utils.metrics.latency_percentiles``: the same samples through
    both packages give equal dicts (``p<N>_ms`` and ``p<N>_err_ms``, zeros
    on empty input), from a list, an empty list or a generator, at the
    default percentiles and at (10, 50, 90, 99.9)."""
    rng = np.random.default_rng(22)
    samples = rng.lognormal(0.0, 1.5, 2000).tolist() + [0.0, 1e-4, 5e7]
    if kind == "empty":
        samples = []
    for pcts in ((50, 99), (10, 50, 90, 99.9)):
        if kind == "generator":
            got = latency_percentiles((x for x in samples), pcts)
            want = ref_latency_percentiles((x for x in samples), pcts)
        else:
            got = latency_percentiles(samples, pcts)
            want = ref_latency_percentiles(samples, pcts)
        assert got == want
        assert set(got) == ({f"p{p}_ms" for p in pcts}
                            | {f"p{p}_err_ms" for p in pcts})
        if kind == "empty":
            assert set(got.values()) == {0.0}


def test_prom_export_equals_reference(tmp_path):
    g = erdos_renyi(64, 0.1, seed=3)
    res = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**PINNED),
                                    device="cpu").solve(_port(g))
    ours = write_prom_metrics(res.stats, tmp_path / "ours.prom",
                              labels={"config": "x"}).read_text()
    validate_prom_text(ours)
    stats = dataclasses.replace(res.stats)
    theirs = ref_tel.write_prom_metrics(stats, tmp_path / "theirs.prom",
                                        labels={"config": "x"}).read_text()
    assert ours == theirs


def test_device_trace_and_log_stats(tmp_path):
    g = _port(erdos_renyi(64, 0.1, seed=3))
    tel = Telemetry(tracer=Tracer())
    with profiling.device_trace(str(tmp_path), telemetry=tel):
        with profiling.annotate("bench-region"):
            res = pjt.ParallelJohnsonSolver(device="cpu").solve(g)
    names = {e["name"] for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"bench-region", "fanout", "upload"} <= names
    assert [r["name"] for r in tel.tracer.records()
            if r["type"] == "event"] == ["device_trace"]
    with profiling.device_trace(None) as prof:
        assert prof is None
    buf = io.StringIO()
    payload = profiling.log_stats(res.stats, stream=buf)
    assert json.loads(buf.getvalue()) == payload
    assert payload["event"] == "pjtpu.solve" and payload["roofline_bound"]


def test_graceful_stop_ends_a_child():
    import subprocess
    import sys

    from paralleljohnson_tpu_torch.utils.procs import graceful_stop

    p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    t0 = time.perf_counter()
    graceful_stop(p, term_wait=10, kill_wait=10)
    assert p.poll() is not None and time.perf_counter() - t0 < 10
    graceful_stop(p)  # an ended child: a no-op, never raises
