"""PyTorch port: the solve's step spans (``utils.metrics.program_span``).

Every step of a CPU solve is a ``record_function`` on the profiler's
timeline, nested in its phase or in ``pj.solve``; each flight-recorder
span starts where its profiler twin starts, on the same clock; the
Chrome export and the overlay place events by that clock; and without
telemetry nothing is recorded and no answer changes."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import observe
from paralleljohnson_tpu_torch.utils import profiling
from paralleljohnson_tpu_torch.utils.metrics import (
    PHASES,
    Span,
    flight_name,
    program_span,
)
from paralleljohnson_tpu_torch.utils.telemetry import (
    Telemetry,
    Tracer,
    chrome_trace_from_records,
    validate_chrome_trace,
)

PINNED = dict(use_pallas=True, mesh_shape=(1,), fw=False, frontier=False,
              dia=False, gauss_seidel=False, bucket=False)
STEPS = [v for k, v in vars(Span).items() if k.isupper()]
# Where each span nests on the solve's own thread (serial pipeline).
PARENT = {
    Span.SOLVE_PLAN: Span.SOLVE,
    Span.SOLVE_POTENTIALS: Span.SOLVE,
    Span.SOLVE_OBSERVE: Span.SOLVE,
    "upload": Span.SOLVE,
    "fanout": Span.SOLVE,
    Span.UPLOAD_PAD: "upload",
    Span.UPLOAD_SRC: "upload",
    Span.UPLOAD_CAST: "upload",
    Span.UPLOAD_COPY: "upload",
    Span.FANOUT_LAYOUT: "fanout",
    Span.FANOUT_BATCH: "fanout",
    Span.FANOUT_HOST_READ: Span.FANOUT_BATCH,
    Span.FANOUT_FINALIZE: Span.FANOUT_BATCH,
    Span.HOST_TABLE: Span.FANOUT_FINALIZE,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(neg=0.0, n=96, seed=3):
    return pjt.load_graph(f"dag:n={n},p=0.06,neg={neg},seed={seed}")


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` (host only); returns (its value,
    [(name, start_ns, end_ns)] of the program's spans)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("pj.") or name in PHASES:
            start = int(e.start_ns())
            spans.append((name, start, start + int(e.duration_ns())))
    return out, spans


def _inside(child, spans, parent_name):
    _, s, e = child
    return any(n == parent_name and ps <= s and e <= pe
               for n, ps, pe in spans)


def _solver(**kw):
    cfg = dict(PINNED, source_batch_size=32, pipeline_depth=1)
    cfg.update(kw)
    return pjt.ParallelJohnsonSolver(pjt.SolverConfig(**cfg), device="cpu")


def test_every_step_span_nests_in_its_phase_or_the_solve():
    """A three-batch serial solve (host rows, so each finalize copies its
    table) shows every step span, each inside the span it belongs to."""
    g = _graph()
    _, spans = _profiled(lambda: _solver().solve(g))
    names = {n for n, _, _ in spans}
    assert set(STEPS) <= names, set(STEPS) - names
    assert sum(n == Span.SOLVE for n in names) == 1
    for child in spans:
        want = PARENT.get(child[0])
        if want is not None:
            assert _inside(child, spans, want), (child[0], want)
    batches = [s for s in spans if s[0] == Span.FANOUT_BATCH]
    assert len(batches) == 3


@pytest.mark.parametrize("entry", ["solve", "solve_range", "multi_source",
                                   "sssp", "solve_reduced"])
def test_each_entry_point_is_one_solve_span(entry):
    """Each public entry point is one ``pj.solve`` with its phases, the
    upload's steps and the bookkeeping inside it."""
    g = _graph()
    solver = _solver()
    call = {
        "solve": lambda: solver.solve(g, np.arange(8)),
        "solve_range": lambda: solver.solve_range(g, 0, 8),
        "multi_source": lambda: solver.multi_source(g, np.arange(8)),
        "sssp": lambda: solver.sssp(g, 0),
        "solve_reduced": lambda: solver.solve_reduced(
            g, np.arange(8), reduce_rows="checksum"),
    }[entry]
    _, spans = _profiled(call)
    (solve,) = [s for s in spans if s[0] == Span.SOLVE]
    inner = [s for s in spans if s[0] != Span.SOLVE
             and s[0] != Span.SOLVE_POTENTIALS]
    assert {"upload", Span.UPLOAD_COPY, Span.SOLVE_OBSERVE} <= {
        s[0] for s in inner}
    for s in inner:
        assert solve[1] <= s[1] and s[2] <= solve[2], s[0]


def test_null_telemetry_records_nothing_and_spans_change_no_answer(
        monkeypatch):
    """Negative arcs (phase 1, the reweight and the un-reweight run), two
    pipelined batches: the rows are bitwise the same with the spans
    stubbed out, by default, with telemetry on and under the profiler;
    by default the flight recorder writes nothing."""
    g = _graph(neg=0.4, n=80, seed=5)
    emitted = []
    real_emit = Tracer._emit
    monkeypatch.setattr(Tracer, "_emit",
                        lambda self, rec: emitted.append(rec)
                        or real_emit(self, rec))

    def solve(**kw):
        return _solver(pipeline_depth=2, **kw).solve(g).matrix

    default = solve()
    assert emitted == []
    profiled, spans = _profiled(solve)
    assert spans
    traced = solve(telemetry=Telemetry(tracer=Tracer()))
    assert emitted
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function",
                  lambda name: contextlib.nullcontext())
        _, no_spans = _profiled(solve)
        bare = solve()
    assert no_spans == []
    for other in (profiled, traced, bare):
        assert np.array_equal(default, other)


def test_flight_spans_start_with_their_profiler_twins():
    """Every flight record carries ``ns``; each flight span of a serial
    solve starts within 5 ms of its ``record_function`` twin in the same
    profiler session."""
    g = _graph()
    tel = Telemetry(tracer=Tracer())
    _, spans = _profiled(lambda: _solver(telemetry=tel).solve(g))
    recs = tel.tracer.records()
    assert all(isinstance(r["ns"], int) for r in recs)
    twins = {}
    for name, start, _ in spans:
        twins.setdefault(flight_name(name), []).append(start)
    begins = {}
    for r in recs:
        if r["type"] == "span_begin" and r["name"] in twins:
            begins.setdefault(r["name"], []).append(r["ns"])
    assert {"solve", "phase:upload", "phase:fanout", "finalize",
            Span.UPLOAD_COPY, Span.FANOUT_BATCH, Span.HOST_TABLE} <= set(
                begins)
    for name, starts in begins.items():
        assert len(starts) == len(twins[name]), name
        for ours, theirs in zip(sorted(starts), sorted(twins[name])):
            assert abs(ours - theirs) < 5_000_000, name


def test_flight_attrs_of_the_copy_and_the_table():
    g = _graph()
    tel = Telemetry(tracer=Tracer())
    _solver(telemetry=tel).solve(g)
    begins = [r for r in tel.tracer.records() if r["type"] == "span_begin"]
    (copy,) = [b for b in begins if b["name"] == Span.UPLOAD_COPY]
    m = pjt.SolverConfig().edge_pad_multiple
    e_pad = -(-g.num_edges // m) * m
    assert copy["attrs"] == {"bytes": 3 * 4 * e_pad}
    tables = [b["attrs"] for b in begins if b["name"] == Span.HOST_TABLE]
    assert tables == [{"bytes": 32 * 96 * 4, "staged": False}] * 3
    batches = [b["attrs"] for b in begins if b["name"] == Span.FANOUT_BATCH]
    assert batches == [{"batch": i, "width": 32} for i in range(3)]
    layouts = {b["attrs"]["key"] for b in begins
               if b["name"] == Span.FANOUT_LAYOUT}
    assert {"in_edges", "w_in"} <= layouts


def test_chrome_trace_places_events_by_ns():
    """``ts`` is microseconds since the epoch from ``ns``; ``t`` only
    where a record has no ``ns``."""
    ns0 = 1_792_000_000_000_000_000
    recs = [
        {"type": "meta", "pid": 7, "t": 0.0, "ns": ns0},
        {"type": "span_begin", "id": 1, "parent": None, "name": "a",
         "t": 50.0, "ns": ns0 + 2_000, "tid": 1, "thread": "main",
         "attrs": {}},
        {"type": "span_end", "id": 1, "t": 99.0, "ns": ns0 + 7_000,
         "status": "ok"},
        {"type": "event", "name": "e", "t": 60.0, "ns": ns0 + 3_000,
         "span": 1, "tid": 1, "thread": "main", "attrs": {}},
        {"type": "span_begin", "id": 2, "parent": None, "name": "old",
         "t": 1.5, "tid": 1, "thread": "main", "attrs": {}},
    ]
    trace = chrome_trace_from_records(recs)
    validate_chrome_trace(trace)
    by = {e["name"]: e for e in trace["traceEvents"] if e["ph"] != "M"}
    assert by["a"]["ts"] == pytest.approx(ns0 / 1e3 + 2.0)
    assert by["a"]["dur"] == pytest.approx(5.0, abs=0.5)
    assert by["e"]["ts"] == pytest.approx(ns0 / 1e3 + 3.0)
    assert by["old"]["ph"] == "B" and by["old"]["ts"] == 1.5e6


def test_overlay_moves_flight_events_onto_the_profilers_base():
    base = 1_790_000_000_000_000_000
    profile = {"baseTimeNanoseconds": base, "traceEvents": [
        {"name": "upload", "ph": "X", "cat": "user_annotation", "pid": 9,
         "tid": 9, "ts": 1000.0, "dur": 10.0}]}
    flight = {"traceEvents": [
        {"name": "thread_name", "ph": "M", "pid": 9, "tid": 0,
         "args": {"name": "main"}},
        {"name": "phase:upload", "ph": "X", "pid": 9, "tid": 0,
         "ts": base / 1e3 + 1000.25, "dur": 10.0, "args": {}}]}
    merged = profiling.overlay_traces(profile, flight)
    validate_chrome_trace(merged)
    assert merged["baseTimeNanoseconds"] == base
    (ours,) = [e for e in merged["traceEvents"] if e["name"] ==
               "phase:upload"]
    assert ours["pid"] == profiling.FLIGHT_PID
    assert ours["ts"] == pytest.approx(1000.25)
    assert profile["traceEvents"][0] in merged["traceEvents"]


def test_cli_traces_of_one_run_line_up(tmp_path):
    """``--trace-dir`` and ``--profile`` of one CLI solve: every phase of
    the flight trace starts within 1 ms of its profiler twin."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(root),
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path),
           "OMP_NUM_THREADS": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "paralleljohnson_tpu_torch", "solve",
         "er:n=120,p=0.05,seed=1", "--device", "cpu", "--batch-size", "40",
         "--trace-dir", "td", "--profile", "pd"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    check = subprocess.run(
        [sys.executable, str(root / "scripts" / "torch_trace_overlay.py"),
         "pd/trace.json", "td/trace-solve.json", "-o", "merged.json"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert check.returncode == 0, check.stdout + check.stderr[-2000:]
    got = json.loads(check.stdout.strip().splitlines()[-1])
    assert {"solve", "phase:upload", "phase:fanout",
            Span.FANOUT_BATCH} <= set(got["spans"])
    merged = json.loads((tmp_path / "merged.json").read_text())
    # The pipelined finalizes run on a worker thread, which the profiler
    # does not record: they are in the overlay from the flight file only.
    assert {e["name"] for e in merged["traceEvents"]
            if e.get("pid") == profiling.FLIGHT_PID} >= {"solve", "finalize"}


def test_degree_bias_only_for_a_profile_store(monkeypatch, tmp_path):
    calls = []
    real = observe.degree_bias_from_degrees
    monkeypatch.setattr(observe, "degree_bias_from_degrees",
                        lambda d: calls.append(1) or real(d))
    g = _graph()
    _solver().solve(g, np.arange(8))
    assert calls == []
    _solver(profile_store=str(tmp_path / "ps")).solve(g, np.arange(8))
    assert calls == [1]


def test_program_span_closes_both_spans_on_an_error():
    tel = Telemetry(tracer=Tracer())
    with pytest.raises(RuntimeError):
        with program_span(Span.FANOUT_BATCH, tel, batch=0, width=4):
            raise RuntimeError("dead batch")
    begin, end = [r for r in tel.tracer.records() if r["type"] != "meta"]
    assert begin["name"] == Span.FANOUT_BATCH
    assert begin["attrs"] == {"batch": 0, "width": 4}
    assert end["status"] == "error" and end["ns"] >= begin["ns"]
