"""PyTorch port: the command line's serving verbs (``serve``, ``top``,
``serve --route``) against the JAX package's, on the CPU.

As in ``tests/test_torch_cli.py``: each reference case runs through both
packages' CLIs (the port's with ``--device cpu``), in process where the
reference test calls ``main`` and as ``python -m`` subprocesses where it
starts replicas: the same exit codes, answers, JSON keys and trace
shapes. ``top`` reads one operations world (a serve store with a repair
marker and a finished fleet, written by the port) from both packages."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu import cli as ref_cli
from paralleljohnson_tpu.observe import trace as ref_trace
from paralleljohnson_tpu.serve import FleetRouter as RefRouter
from paralleljohnson_tpu.serve import read_routing as ref_read_routing
from paralleljohnson_tpu.utils.telemetry import Telemetry as RefTelemetry

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import cli
from paralleljohnson_tpu_torch.distributed import plan_fleet
from paralleljohnson_tpu_torch.distributed.launch import run_in_process_fleet
from paralleljohnson_tpu_torch.graphs import erdos_renyi, grid2d
from paralleljohnson_tpu_torch.incremental import write_repair_status
from paralleljohnson_tpu_torch.observe import trace as port_trace
from paralleljohnson_tpu_torch.serve import PROTOCOL, FleetRouter, QueryEngine
from paralleljohnson_tpu_torch.serve import TileStore, read_routing
from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from paralleljohnson_tpu_torch.utils.telemetry import Telemetry

REPO = Path(__file__).resolve().parent.parent

# Per package: the CLI's main, its ``python -m`` module and the flags a
# replica of it needs, its router, routing reader, telemetry and trace
# assembler.
PACKAGES = {
    "ref": dict(main=ref_cli.main, module="paralleljohnson_tpu.cli",
                flags=[], router=RefRouter, read_routing=ref_read_routing,
                telemetry=RefTelemetry, assemble=ref_trace.assemble),
    "port": dict(main=cli.main, module="paralleljohnson_tpu_torch",
                 flags=["--device", "cpu"], router=FleetRouter,
                 read_routing=read_routing, telemetry=Telemetry,
                 assemble=port_trace.assemble),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several pytest
    workers on the CPU, and torch's thread pool oversubscribed by them
    slows the small ops of these solves by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return env


def _spawn(pkg: str, args: list[str], **kw) -> subprocess.Popen:
    p = PACKAGES[pkg]
    return subprocess.Popen(
        [sys.executable, "-m", p["module"], *args, *p["flags"]],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, text=True, **kw)


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)


class _Client:
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


def _exact(g) -> np.ndarray:
    return to_numpy(pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(backend="numpy"), device="cpu").solve(g).matrix)


# -- tests/test_serve.py ------------------------------------------------------


def test_cli_serve_jsonl_loop(tmp_path, capsys):
    queries = tmp_path / "q.jsonl"
    queries.write_text(
        '{"id": 0, "source": 1, "dst": 4}\n'
        '{"id": 1, "source": 1, "dst": [2, 3]}\n'
        '{"id": 2, "source": 6, "dst": 1, "mode": "approx"}\n')
    exact = _exact(pjt.load_graph("er:n=32,p=0.12"))
    answers = {}
    for name, p in PACKAGES.items():
        store = tmp_path / name
        rc = p["main"](["serve", "er:n=32,p=0.12", "--backend", "numpy",
                        "--store-dir", str(store), "--landmarks", "3",
                        "--queries", str(queries), *p["flags"]])
        assert rc == 0
        lines = [json.loads(ln) for ln in
                 capsys.readouterr().out.strip().splitlines()]
        assert [r["id"] for r in lines] == [0, 1, 2]
        assert lines[0]["exact"] is True
        assert float(lines[0]["distance"]) == float(exact[1, 4])
        assert [float(d) for d in lines[1]["distances"]] == \
            [float(exact[1, 2]), float(exact[1, 3])]
        assert lines[2]["exact"] is False and "max_error" in lines[2]
        est, want = lines[2]["distance"], exact[6, 1]
        assert est == want or abs(est - want) <= lines[2]["max_error"]
        assert list(store.glob("graph_*/rows_*.npz"))
        assert list(store.glob("graph_*/landmarks.npz"))
        answers[name] = lines
    for ref, got in zip(answers["ref"], answers["port"]):
        assert set(got) == set(ref)


def test_cli_serve_default_backend_on_the_cpu(tmp_path, capsys):
    """The port's default backend (torch, plain versions on the CPU)
    answers the reference's queries with the direct solve's rows (rtol
    1e-6: a scheduled one-source batch takes another route than the
    all-sources solve)."""
    queries = tmp_path / "q.jsonl"
    queries.write_text('{"id": 0, "source": 1, "dst": 4}\n'
                       '{"id": 1, "source": 3, "dst": null}\n')
    g = pjt.load_graph("er:n=32,p=0.12")
    want = to_numpy(pjt.ParallelJohnsonSolver(device="cpu").solve(g).matrix)
    assert cli.main(["serve", "er:n=32,p=0.12", "--queries", str(queries),
                     "--device", "cpu"]) == 0
    a, b = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]
    np.testing.assert_allclose(a["distance"], want[1, 4], rtol=1e-6)
    row = np.array([np.inf if d is None else d for d in b["distances"]],
                   np.float32)
    np.testing.assert_array_equal(np.isinf(row), np.isinf(want[3]))
    np.testing.assert_allclose(row, want[3], rtol=1e-6)


def test_cli_serve_malformed_line_exit_code(tmp_path, capsys):
    queries = tmp_path / "q.jsonl"
    queries.write_text('{"source": 0, "dst": 1}\nnot json\n')
    for name, p in PACKAGES.items():
        rc = p["main"](["serve", "er:n=16,p=0.2", "--backend", "numpy",
                        "--queries", str(queries), *p["flags"]])
        assert rc == 1, name
        lines = [json.loads(ln) for ln in
                 capsys.readouterr().out.strip().splitlines()]
        assert len(lines) == 2
        assert "distance" in lines[0] and "error" in lines[1]


def test_cli_serve_requires_a_graph(capsys):
    for name, p in PACKAGES.items():
        assert p["main"](["serve", *p["flags"]]) == 1, name
        assert "requires a GRAPH" in capsys.readouterr().err


# -- tests/test_frontend.py ---------------------------------------------------


@pytest.mark.slow  # as the reference's: a serving subprocess per package
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_cli_listen_sigterm_drains_exit_zero(pkg, tmp_path):
    proc = _spawn(pkg, ["serve", "er:n=32,p=0.15", "--backend", "numpy",
                        "--store-dir", str(tmp_path / "store"), "--listen",
                        "127.0.0.1:0", "--landmarks", "3",
                        "--stats-interval", "0.2"])
    try:
        announce = json.loads(proc.stdout.readline())
        assert announce["protocol"] == PROTOCOL
        c = _Client((announce["host"], announce["port"]))
        for i in range(5):
            assert "distance" in c.ask({"id": i, "source": i, "dst": i + 1})
        c.close()
        os.kill(proc.pid, signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        _stop([proc])
    assert rc == 0
    stats = list((tmp_path / "store").glob("graph_*/serve_stats.json"))
    assert stats, "drain did not flush serve_stats.json"
    assert json.loads(stats[0].read_text())["engine"]["queries_total"] >= 5
    live = list((tmp_path / "store").glob("graph_*/serve_live.json"))
    assert live and json.loads(live[0].read_text())["kind"] == "live_metrics"


# -- tests/test_fleet_serve.py ------------------------------------------------


@pytest.mark.slow  # as the reference's: real subprocesses + SIGKILL
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_router_survives_sigkill_of_owner(pkg, tmp_path):
    rows = 6
    g = grid2d(rows, rows, negative_fraction=0.0, seed=0)
    n = g.num_nodes
    exact = _exact(g)
    fleet = tmp_path / "fleet"
    store_dir = tmp_path / "store"
    seed_engine = QueryEngine(g, TileStore(store_dir, g, warm_rows=n),
                              config=pjt.SolverConfig(backend="numpy"),
                              stats_interval_s=0, device="cpu")
    seed_engine.warm(np.arange(n))
    seed_engine.close()
    procs, router = [], None
    p = PACKAGES[pkg]
    try:
        for i in range(2):
            procs.append(_spawn(pkg, [
                "serve", f"grid:rows={rows},cols={rows}", "--listen",
                "127.0.0.1:0", "--store-dir", str(store_dir), "--backend",
                "numpy", "--fleet-dir", str(fleet), "--replica-id",
                f"kill-{i}", "--replica-heartbeat", "0.2"],
                stderr=subprocess.DEVNULL))
            json.loads(procs[-1].stdout.readline())  # announce
        router = p["router"](fleet, stale_after_s=1.5,
                             refresh_interval_s=0.1).start()
        epoch_before = router.table.epoch
        victim_rid = router.table.owner("0")
        victim = procs[int(victim_rid.rsplit("-", 1)[1])]
        c = _Client(router.address())
        assert float(c.ask({"id": 0, "source": 0, "dst": 1})["distance"]) \
            == float(exact[0, 1])
        c.close()
        victim.send_signal(signal.SIGKILL)
        victim.wait()
        t_kill = time.monotonic()
        answered = None
        while time.monotonic() - t_kill < 10.0:
            try:
                c = _Client(router.address(), timeout=5)
                r = c.ask({"id": 1, "source": 0, "dst": 1})
                c.close()
                if r.get("error") is None:
                    answered = r
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        lapse = time.monotonic() - t_kill
        assert answered is not None, "dead replica's sources never re-routed"
        assert float(answered["distance"]) == float(exact[0, 1])
        assert lapse < 1.5 + 2.0, f"re-route took {lapse:.2f}s"
        after = p["read_routing"](fleet)
        assert after.epoch > epoch_before
        assert all(after.owner(str(s)) != victim_rid for s in range(n))
    finally:
        if router is not None:
            router.drain()
        _stop(procs)


def test_router_cli_announces_and_forwards(tmp_path):
    """``serve --route`` (the router as a process of its own) over one
    in-process-warmed replica process: the announce line, then a routed
    answer equal to the direct solve's."""
    g = grid2d(5, 5, negative_fraction=0.0, seed=0)
    exact = _exact(g)
    fleet, store_dir = tmp_path / "fleet", tmp_path / "store"
    eng = QueryEngine(g, TileStore(store_dir, g, warm_rows=25),
                      config=pjt.SolverConfig(backend="numpy"),
                      stats_interval_s=0, device="cpu")
    eng.warm(np.arange(25))
    eng.close()
    procs = []
    try:
        procs.append(_spawn("port", [
            "serve", "grid:rows=5,cols=5", "--listen", "127.0.0.1:0",
            "--store-dir", str(store_dir), "--backend", "numpy",
            "--shed-policy", "reject", "--fleet-dir", str(fleet),
            "--replica-id", "rep-0", "--replica-heartbeat", "0.2"]))
        json.loads(procs[-1].stdout.readline())
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paralleljohnson_tpu_torch", "serve",
             "--route", str(fleet), "--listen", "127.0.0.1:0"],
            env=_env(), cwd=REPO, stdout=subprocess.PIPE, text=True))
        ann = json.loads(procs[-1].stdout.readline())
        assert ann["router"] is True and ann["protocol"] == PROTOCOL
        assert ann["epoch"] >= 1
        c = _Client((ann["host"], ann["port"]))
        r = c.ask({"id": 0, "source": 3, "dst": 11})
        c.close()
        assert float(r["distance"]) == float(exact[3, 11])
    finally:
        _stop(procs)
    assert [p.returncode for p in procs] == [0, 0]


# -- tests/test_trace.py ------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_router_mints_and_replica_joins_end_to_end(pkg, tmp_path):
    """A replica process (the package's CLI) and an in-process router,
    each with a flight recorder: the routed answer's trace assembles into
    one single-rooted timeline over router and replica."""
    g = grid2d(5, 5, seed=0)
    n = g.num_nodes
    exact = _exact(g)
    p = PACKAGES[pkg]
    fleet, store_dir = tmp_path / "fleet", tmp_path / "store"
    trace_root = tmp_path / "tr"
    eng = QueryEngine(g, TileStore(store_dir, g, warm_rows=n),
                      config=pjt.SolverConfig(backend="numpy"),
                      stats_interval_s=0, device="cpu")
    eng.warm(np.arange(n))
    eng.close()
    rep = _spawn(pkg, ["serve", "grid:rows=5,cols=5,seed=0", "--listen",
                       "127.0.0.1:0", "--store-dir", str(store_dir),
                       "--backend", "numpy", "--shed-policy", "reject",
                       "--fleet-dir", str(fleet), "--replica-id", "rep-0",
                       "--replica-heartbeat", "0.2", "--trace-dir",
                       str(trace_root / "rep")])
    router, router_tel = None, p["telemetry"].create(
        trace_dir=trace_root / "router", label="router")
    try:
        json.loads(rep.stdout.readline())
        router = p["router"](fleet, stale_after_s=5.0, refresh_interval_s=0.1,
                             telemetry=router_tel).start()
        c = _Client(router.address())
        r = c.ask({"id": 0, "source": 3, "dst": 11})
        c.close()
        assert float(r["distance"]) == float(exact[3, 11])
        tid = r["trace_id"]
    finally:
        if router is not None:
            router.drain()
        router_tel.close()
        _stop([rep])
    assert rep.returncode == 0
    tr = p["assemble"]([trace_root])["traces"][tid]
    assert tr["single_rooted"] is True, tr["roots"]
    assert set(tr["processes"]) == {"router", "serve"}
    names = [s["name"] for s in tr["spans"]]
    for required in ("route_request", "forward", "serve_request"):
        assert required in names, names
    serve_span = next(s for s in tr["spans"] if s["name"] == "serve_request")
    fwd = next(s for s in tr["spans"] if s["name"] == "forward")
    assert serve_span["parent_ref"] == fwd["ref"]
    assert not tr["open"] and not tr["unresolved"]


# -- tests/test_top.py --------------------------------------------------------


@pytest.fixture(scope="module")
def ops_world(tmp_path_factory):
    """One serve store (stats + repair marker) and one finished in-process
    fleet, written by the port, read by both packages' ``top``."""
    root = tmp_path_factory.mktemp("ops")
    g = erdos_renyi(32, 0.12, seed=3)
    store = TileStore(root / "store", g)
    engine = QueryEngine(g, store, config=pjt.SolverConfig(backend="numpy"),
                         stats_interval_s=0, device="cpu")
    for s in range(5):
        engine.query(s, (s + 1) % 32)
    engine.close()
    write_repair_status(store.ckpt.dir, status="repairing", new_digest="feed",
                        affected=[1, 2, 3], total_sources=32, dirty_parts=1,
                        parts_total=4)
    coord = plan_fleet(root / "coord", "er:n=48,p=0.1,seed=1", n_workers=2,
                       backend="numpy")
    assert run_in_process_fleet(coord, 2, device="cpu").ok
    return {"store": root / "store", "coord": root / "coord"}


def _drop_clocks(doc):
    """The document without its wall-clock readings (ages, stamps)."""
    if isinstance(doc, dict):
        return {k: _drop_clocks(v) for k, v in doc.items()
                if not (k.endswith("_s") or k in ("ts", "now", "generated"))}
    if isinstance(doc, list):
        return [_drop_clocks(v) for v in doc]
    return doc


def test_cli_top_once_json_single_document(ops_world, capsys):
    docs = {}
    for name, p in PACKAGES.items():
        rc = p["main"](["top", "--once", "--json", "--serve-store",
                        str(ops_world["store"]), "--coordinator-dir",
                        str(ops_world["coord"])])
        assert rc == 0
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) == 1  # ONE joined document
        doc = docs[name] = json.loads(out[0])
        assert doc["serve"][0]["serve"]["queries_total"] == 5
        assert doc["fleet"]["leases"]["committed"] >= 1
        assert doc["repairs"][0]["new_digest"] == "feed"
    assert set(docs["port"]) == set(docs["ref"])
    assert docs["port"]["fleet"]["leases"] == docs["ref"]["fleet"]["leases"]
    assert _drop_clocks(docs["port"]["repairs"]) == \
        _drop_clocks(docs["ref"]["repairs"])


def test_cli_top_ascii_render(ops_world, capsys):
    for name, p in PACKAGES.items():
        rc = p["main"](["top", "--once", "--serve-store",
                        str(ops_world["store"]), "--coordinator-dir",
                        str(ops_world["coord"])])
        assert rc == 0
        out = capsys.readouterr().out
        for needle in ("pjtpu top", "SERVE", "FLEET", "REPAIR", "SLO serve",
                       "w0", "dirty parts 1/4"):
            assert needle in out, f"{name}: missing {needle!r}:\n{out}"


def test_cli_top_requires_a_target(capsys):
    for name, p in PACKAGES.items():
        assert p["main"](["top", "--once"]) == 1, name
        assert "needs --serve-store" in capsys.readouterr().err


def test_top_cli_fleet_absent_dir_never_crashes(tmp_path, capsys):
    for name, p in PACKAGES.items():
        rc = p["main"](["top", "--fleet-dir", str(tmp_path / "nothing"),
                        "--once", "--json"])
        assert rc == 0
        sf = json.loads(capsys.readouterr().out)["serve_fleet"]
        assert sf["replicas"] == {}
        assert sf["merged"]["verdict"] == "no-replicas"
