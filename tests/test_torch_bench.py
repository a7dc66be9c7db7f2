"""PyTorch port: the bench harness (``benchmarks.py``) against the JAX
package's.

Every config of the port's ``CONFIGS`` runs at the smoke preset on the
CPU and agrees with the JAX package's row for the same config on the
graph it built and the answer it got: ``nodes``, ``edges``, ``sources``,
``finite_frac`` / ``reached_frac`` and ``rows_checksum`` (rtol 1e-6), with
no ``failed`` from the harness's own bitwise, planner and tuner checks.
Rates and ``edges_relaxed`` are not compared: the edge chunking differs.
The JAX side runs once for the module."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu import benchmarks as ref_bench

from paralleljohnson_tpu_torch import benchmarks
from paralleljohnson_tpu_torch.observe.regress import BenchHistory, normalize_record
from paralleljohnson_tpu_torch.utils.telemetry import validate_chrome_trace

# serve_overload's verdict rests on wall-clock phases (2x its calibrated
# capacity, then a cooldown) that a loaded CPU cannot hold; it has a test
# of its own below, which grades every answer it served. serve_fleet
# starts three replica processes per package, and the reference runs its
# row in the slow set; its row has a slow test of its own below.
CONFIGS = sorted(set(benchmarks.CONFIGS) - {"serve_overload", "serve_fleet"})
COMPARED = ("nodes", "edges", "sources", "finite_frac", "reached_frac",
            "rows_checksum", "scale", "graphs", "nodes_each")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU, and torch's thread pool oversubscribed by them slows the small
    ops of these loops by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_rows():
    return {r.config: r for r in ref_bench.run(CONFIGS, backend="jax",
                                               preset="smoke")}


@pytest.fixture(scope="module")
def port_rows(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    rows = benchmarks.run(CONFIGS, preset="smoke", device="cpu",
                          telemetry_dir=str(d / "trace"),
                          profile_dir=str(d / "profiles"))
    return d, {r.config: r for r in rows}


def test_configs_are_the_reference_configs_with_ported_modules():
    assert set(benchmarks.CONFIGS) == set(ref_bench.CONFIGS)
    assert len(benchmarks.CONFIGS) == 18
    for name in benchmarks.CONFIGS:
        assert benchmarks._SIZES[name] == ref_bench._SIZES[name]
    assert benchmarks._PRESETS == ref_bench._PRESETS


@pytest.mark.parametrize("name", CONFIGS)
def test_smoke_row_agrees_with_reference(name, ref_rows, port_rows):
    _, rows = port_rows
    port, ref = rows[name].detail, ref_rows[name].detail
    assert "failed" not in port, port.get("failed")
    assert "failed" not in ref, ref.get("failed")
    shared = [k for k in COMPARED if k in ref]
    assert shared == [k for k in COMPARED if k in port]
    for key in shared:
        if isinstance(ref[key], dict):  # planner_dispatch's graphs
            shape = lambda gs: {g: (v["nodes"], v["edges"], v["batch"])  # noqa: E731
                                for g, v in gs.items()}
            assert shape(port[key]) == shape(ref[key])
        elif isinstance(ref[key], float):
            np.testing.assert_allclose(port[key], ref[key], rtol=1e-6)
        else:
            assert port[key] == ref[key], key
    assert port["platform"] == "cpu" and "device" not in port
    assert rows[name].n_chips == 1 and rows[name].backend == "torch"


def test_in_bench_checks_ran(port_rows):
    """The harness's own grading ran on the port's registries: the planner
    pick graded against forced runs (``pallas-vm`` among them), the tuner's
    zero-budget no-op and bitwise dispatch, the dirty window's evidence
    loop on real trajectory records."""
    _, rows = port_rows
    pd = rows["planner_dispatch"].detail
    assert pd["all_bitwise"] and pd["all_routes_agree"]
    for g in ("scrambled_grid", "rmat"):
        assert "pallas-vm" in pd["graphs"][g]["measured"]
        assert pd["graphs"][g]["pick"] is not None
    pt = rows["planner_tuning"].detail
    assert pt["zero_budget"]["store_untouched"]
    assert pt["zero_budget"]["bitwise_vs_storeless"]
    assert pt["dispatch"]["bitwise_vs_forced"]
    assert pt["tuning"]["probes"] >= 2
    dw = rows["dirty_window"].detail["dispatch"]
    assert dw["grid"]["engage"] is True and dw["rmat"]["engage"] is False
    assert rows["dense_apsp_fw"].detail["route"] == "fanout:fw"


def test_fleet_and_repair_rows_as_reference(port_rows, ref_rows):
    """``distributed_fleet`` (in-process workers at smoke) and
    ``incremental_update`` keep the reference's in-bench checks and detail
    keys: 1-worker and N-worker fleet rows bitwise, the repair bitwise a
    fresh solve with fewer dirty parts than parts; their counters equal
    the reference's."""
    _, rows = port_rows
    fl, ref_fl = rows["distributed_fleet"].detail, \
        ref_rows["distributed_fleet"].detail
    own = {"telemetry", "platform", "device", "worker_kernel_build_s"}
    assert set(fl) - own == set(ref_fl) - {"telemetry", "platform"}
    assert fl["worker_mode"] == "in-process" and fl["requeues"] == 0
    for key in ("nodes", "graph_spec", "workers", "leases", "committed_by"):
        assert fl[key] == ref_fl[key], key
    assert set(fl["worker_kernel_build_s"].values()) == {None}  # the CPU
    inc, ref_inc = rows["incremental_update"].detail, \
        ref_rows["incremental_update"].detail
    assert set(inc) - own == set(ref_inc) - {"telemetry", "platform"}
    assert inc["dirty_parts"] < inc["parts_total"]
    assert inc["repair_speedup"] > 0 and inc["full_resolve_wall_s"] > 0
    for key in ("nodes", "edges", "k_updates", "dirty_parts", "parts_total",
                "core_recomputed", "affected_rows", "rows_recomputed",
                "rows_patched", "rows_copied"):
        assert inc[key] == ref_inc[key], key
    assert rows["incremental_update"].edges_relaxed == \
        ref_rows["incremental_update"].edges_relaxed


def test_telemetry_and_history_artifacts(port_rows):
    d, rows = port_rows
    for name in CONFIGS:
        flight = (d / "trace" / f"flight-{name}.jsonl").read_text()
        assert json.loads(flight.splitlines()[0])["type"] == "meta"
        validate_chrome_trace(json.loads(
            (d / "trace" / f"trace-{name}.json").read_text()))
        assert "telemetry" in rows[name].detail
    hb = json.loads((d / "trace" / "heartbeat.json").read_text())
    assert hb["device_memory"] is None  # CUDA never initialised here
    hist = BenchHistory(d / "profiles").rows()
    assert {r["bench"] for r in hist} == set(CONFIGS)
    assert {r["backend"] for r in hist} == {"torch"}


def test_normalize_record_keeps_the_rows_backend(port_rows):
    _, rows = port_rows
    line = json.loads(rows["rmat_apsp"].as_json_line())
    (row,) = normalize_record(line)
    assert row["backend"] == "torch" and row["platform"] == "cpu"
    for kind in ("plan", "tune"):
        rec = {"kind": kind, "nodes": 64, "edges": 256, "batch": 1,
               "platform": "cpu", "knob": "fw_tile", "value": 128,
               "measured": {"wall_s": 0.1}}
        assert normalize_record(rec)[0]["backend"] == "torch"
        assert normalize_record({**rec, "backend": "jax"})[0]["backend"] \
            == "jax"


@pytest.mark.parametrize("backend", ["cpp", "numpy"])
def test_host_backends_rows(backend, ref_rows):
    rows = {r.config: r for r in benchmarks.run(
        ["rmat_apsp", "planner_tuning"], backend=backend, preset="smoke",
        device="cpu")}
    rm = rows["rmat_apsp"].detail
    assert rm["platform"] == "cpu" and "failed" not in rm
    np.testing.assert_allclose(rm["rows_checksum"],
                               ref_rows["rmat_apsp"].detail["rows_checksum"],
                               rtol=1e-6)
    assert "skipped" in rows["planner_tuning"].detail


def test_serve_rows_as_reference(port_rows, ref_rows):
    """``serve_queries``' host-forced and device-forced lookups answer
    bitwise alike in both packages, over the same graph and mix;
    ``approx_apsp`` certifies every entry it measured."""
    _, rows = port_rows
    sq, ref_sq = rows["serve_queries"].detail, \
        ref_rows["serve_queries"].detail
    for key in ("queries", "landmarks", "warm_sources", "clients"):
        assert sq[key] == ref_sq[key], key
    assert sq["lookup"]["bitwise_identical"]
    assert ref_sq["lookup"]["bitwise_identical"]
    assert sq["lookup"]["device_lookups"] > 0
    ap, ref_ap = rows["approx_apsp"].detail, ref_rows["approx_apsp"].detail
    for eps in ("eps_0.1", "eps_0.5"):
        for key in ("beta", "hopset_edges", "hopset_converged",
                    "query_converged", "measured_max_error",
                    "certified_max_bound", "certified_frac"):
            assert ap[eps][key] == ref_ap[eps][key], (eps, key)


def test_serve_overload_grades_every_answer():
    """Through real sockets at twice its calibrated capacity, every
    answer the frontend served is graded against the direct solve: exact
    answers bitwise, shed answers flagged and inside a finite certificate,
    no unexpected errors or hung clients; the overload phase shed and
    rejected, the shed fraction stayed under half, the SLO's p99 was met
    and shedding disengaged in the cooldown: no ``failed`` verdict, as
    the reference's ``test_serve_overload_contract`` holds."""
    (rec,) = benchmarks.run(["serve_overload"], preset="smoke", device="cpu")
    d = rec.detail
    assert "failed" not in d, d["failed"]
    assert d["shed_late_cooldown"] == 0
    assert d["exact_bitwise_checked"] > 0
    assert d["accepted"] + d["rejected"] > 0
    assert d["platform"] == "cpu"


@pytest.mark.parametrize("name", ["er1k_aspp"])
def test_unknown_or_unported_config_rejected(name):
    with pytest.raises(ValueError, match="unknown config"):
        benchmarks.run([name], device="cpu")


def test_serve_fleet_is_a_config(monkeypatch):
    """``run(["serve_fleet"])`` dispatches to the config (stubbed here: the
    real row starts replica processes, below) instead of rejecting it."""
    def stub(backend, preset):
        return benchmarks.BenchRecord("serve_fleet", backend, preset, 1.0, 0,
                                      0.0, 1, {})

    monkeypatch.setitem(benchmarks.CONFIGS, "serve_fleet", stub)
    (rec,) = benchmarks.run(["serve_fleet"], preset="smoke", device="cpu")
    assert rec.config == "serve_fleet" and "failed" not in rec.detail
    assert rec.detail["platform"] == "cpu"


@pytest.mark.slow  # as the reference's row: replica subprocesses + a kill
def test_serve_fleet_smoke_row_as_reference():
    """The kill drill through ``python -m paralleljohnson_tpu_torch serve``
    replicas: every check of the reference's row holds (no hung client,
    non-shed answers bitwise the direct solve, the re-published table
    within the lapse budget, the merged SLO verdict, a router-to-replica
    trace with a retry hop, the unsolved source's serve_solve), with the
    reference row's detail keys."""
    (ref,) = ref_bench.run(["serve_fleet"], backend="jax", preset="smoke")
    (rec,) = benchmarks.run(["serve_fleet"], preset="smoke", device="cpu")
    d, ref_d = rec.detail, ref.detail
    assert "failed" not in d, d.get("failed")
    assert "failed" not in ref_d, ref_d.get("failed")
    assert set(d) == set(ref_d)
    for key in ("nodes", "edges", "replicas", "clients", "reroute_budget_s"):
        assert d[key] == ref_d[key], key
    assert d["verdict"] == "ok" and d["retry_traces"] >= 1
    assert d["exact_bitwise_checked"] > 0 and d["platform"] == "cpu"


def test_unknown_preset_rejected():
    with pytest.raises(ValueError, match="preset"):
        benchmarks.run(["er1k_apsp"], preset="huge", device="cpu")


def test_failed_config_row_points_at_flight_file(tmp_path, monkeypatch):
    def boom(backend, preset):
        raise RuntimeError("config exploded")

    monkeypatch.setitem(benchmarks.CONFIGS, "er1k_apsp", boom)
    (rec,) = benchmarks.run(["er1k_apsp"], device="cpu",
                            telemetry_dir=str(tmp_path))
    assert rec.detail["failed"] == "RuntimeError: config exploded"
    flight = rec.detail["flight_recorder"]
    events = [json.loads(ln) for ln in open(flight)]
    assert any(e.get("name") == "config_failed" for e in events)


def test_update_baseline_md_as_reference(tmp_path, port_rows):
    """The port's table rewrite produces the reference's bytes for the
    same records, and a failed row never clobbers a measurement."""
    _, rows = port_rows
    recs = [rows["er1k_apsp"], rows["dimacs_ny_bf"]]
    ours, theirs = tmp_path / "ours.md", tmp_path / "theirs.md"
    for p in (ours, theirs):
        p.write_text("# BASELINE\n\nprose\n")
    benchmarks.update_baseline_md(recs, str(ours))
    ref_bench.update_baseline_md(
        [ref_bench.BenchRecord(**{k: getattr(r, k) for k in (
            "config", "backend", "preset", "wall_s", "edges_relaxed",
            "edges_relaxed_per_sec", "n_chips", "detail")}) for r in recs],
        str(theirs))
    assert ours.read_text() == theirs.read_text()
    failed = benchmarks.BenchRecord("er1k_apsp", "torch", "smoke", 1.0, 0,
                                    0.0, 1, {"failed": "x"})
    benchmarks.update_baseline_md([failed], str(ours))
    assert ours.read_text() == theirs.read_text()
