"""The metric arithmetic: the frozen yardstick, the trace's intervals,
each reader on a made-up run record."""

from __future__ import annotations

import math
import types

import numpy as np

from conftest import ROOT
from pjbench import check, manifest, trace
from pjbench.frozen import costs, peaks
from pjbench.trace import DeviceOp, HostEvent


def test_frozen_sweep_cost_matches_its_formula():
    c = costs.sweep_cost(1000, 5000, 64, 3)
    assert c["bytes_accessed"] == 3 * (2 * 4 * 1000 * 64 + 4 * 1001 + 8 * 5000)
    assert c["flops"] == 2.0 * 5000 * 64 * 3


def test_sweep_work_sums_sweep_cost_over_sweeps_of_any_width():
    widths = [325, 325, 196, 1, 7]
    got = costs.sweep_work(4000, 9000, sum(widths), len(widths))
    for key in ("bytes_accessed", "flops"):
        assert got[key] == sum(costs.sweep_cost(4000, 9000, b, 1)[key]
                               for b in widths)


def test_peaks_are_the_data_sheets():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.FP32_FLOPS_PER_S == 67e12


def test_merge_clip_busy():
    ops = [DeviceOp("a", 0, 0, 10), DeviceOp("b", 0, 5, 20),
           DeviceOp("c", 0, 30, 40), DeviceOp("d", 1, 0, 100)]
    assert trace.merged([(0, 10), (5, 20), (30, 40)]) == [(0, 20), (30, 40)]
    assert trace.busy_ns(ops, 0, 0, 50) == 30
    assert trace.busy_ns(ops, 0, 15, 35) == 10
    assert trace.busy_ns(ops, 1, 0, 50) == 50


def test_idle_gaps_are_named_by_the_innermost_host_event():
    ops = [DeviceOp("k", 0, 0, 10), DeviceOp("k", 0, 40, 50)]
    host = [HostEvent("pjbench.request", 0, 100),
            HostEvent("aten::copy_", 12, 38)]
    gaps = trace.idle_gaps(ops, host, 0, 0, 60)
    assert gaps == [["aten::copy_", 30e-9], ["pjbench.request", 10e-9]]


def test_op_seconds_short_names():
    ops = [DeviceOp("void (anonymous namespace)::sweep_items<float, 4, true, "
                    "2, false>(float const*)", 0, 0, 2000), DeviceOp("Memcpy HtoD (Pageable -> Device)",
                                          1, 0, 500)]
    assert trace.op_seconds(ops, 0, 10**9) == [
        ["sweep_items<float, 4, true, 2, false>", 2e-6],
        ["Memcpy HtoD (Pageable -> Device)", 5e-7]]


def _run(**kw):
    base = dict(t0=0.0, t_close=10.0, t0_ns=0, t_close_ns=10 * 10**9,
                deliveries=[(1.0, 300), (10.0, 300), (12.0, 300)],
                requests=[], trace=None, host_table_s=None,
                collective_s=None, setup_s=12.5, num_nodes=1000,
                num_edges=8000, mesh_size=1)
    base.update(kw)
    run = types.SimpleNamespace(**base)
    run.window_s = run.t_close - run.t0
    return run


def _read(name, run):
    return manifest.metric_reader(ROOT, name).read(run)


def test_rows_per_s_counts_deliveries_up_to_the_close():
    assert _read("rows_per_s", _run()) == 60.0
    assert _read("setup_s", _run()) == 12.5


def test_phase_shares():
    req = types.SimpleNamespace(phase_seconds={"upload": 1.0,
                                               "bellman_ford": 0.5},
                                fanout_iterations=0, fanout_row_sweeps=0)
    run = _run(requests=[req, req], host_table_s=2.0, collective_s=0.25)
    assert _read("upload_pct", run) == 20.0
    assert _read("potentials_pct", run) == 10.0
    assert _read("download_pct", run) == 20.0
    assert _read("collective_pct", run) == 2.5
    plain = types.SimpleNamespace(phase_seconds={"upload": 1.0},
                                  fanout_iterations=0, fanout_row_sweeps=0)
    quiet = _run(requests=[plain])
    for name in ("potentials_pct", "download_pct", "collective_pct",
                 "device_idle_pct", "fanout_sweep_roofline"):
        assert _read(name, quiet) is None


def test_device_idle_and_roofline_from_a_trace():
    v, e = 1000, 8000
    req = types.SimpleNamespace(phase_seconds={}, fanout_iterations=10,
                                fanout_row_sweeps=10 * 64)
    need = costs.sweep_cost(v, e, 64, 10)["bytes_accessed"]
    bound_ns = need / peaks.HBM_BYTES_PER_S * 1e9
    # Ten working sweeps at four times the bound, six skipped launches.
    work_ns = int(round(4 * bound_ns))
    ops = [DeviceOp("void sweep_items<float, 1, true, 1, false>(float const*)",
                    0, 0, work_ns)]
    ops += [DeviceOp("void combine_split_rows<float, true>(float const*)",
                     0, 10**9, 10**9 + 5) for _ in range(6)]
    ops += [DeviceOp("void combine_split_rows<float, true>(int*, Partial)",
                     0, 0, 10**6)]
    prof = types.SimpleNamespace(ops=ops, host=[])
    run = _run(requests=[req], trace=prof, num_nodes=v, num_edges=e)
    got = _read("fanout_sweep_roofline", run)
    assert math.isclose(got, 100 * bound_ns / (work_ns + 30), rel_tol=1e-9)
    busy = trace.busy_ns(ops, 0, 0, 10 * 10**9)
    assert math.isclose(_read("device_idle_pct", run),
                        100 * (1 - busy / 1e10))


def test_roofline_counts_every_rank():
    v, e = 1000, 8000
    req = types.SimpleNamespace(phase_seconds={}, fanout_iterations=5,
                                fanout_row_sweeps=5 * 256)
    ops = [DeviceOp("sweep_items<float>", d, 0, 10**6) for d in range(4)]
    one = _read("fanout_sweep_roofline", _run(
        requests=[req], trace=types.SimpleNamespace(ops=ops, host=[]),
        num_nodes=v, num_edges=e, mesh_size=4))
    need = costs.sweep_work(v, e, 5 * 256, 4 * 5)["bytes_accessed"]
    assert math.isclose(one, 100 * need / peaks.HBM_BYTES_PER_S / 4e-3)


def test_differing_counts_unequal_entries_inf_equal():
    a = np.array([0, 1, np.inf, 3], np.float32)
    b = np.array([0, 2, np.inf, np.inf], np.float32)
    assert check.differing(a, a) == 0
    assert check.differing(a, b) == 2
    assert check.passed({"x": {"value": 0, "limit": 0}})
    assert not check.passed({"x": {"value": 1, "limit": 0}})


def test_roofline_takes_the_operation_bound_where_it_binds():
    v, e, b = 10, 100_000, 512
    req = types.SimpleNamespace(phase_seconds={}, fanout_iterations=1,
                                fanout_row_sweeps=b)
    ops = [DeviceOp("sweep_items<float>", 0, 0, 10_000)]
    got = _read("fanout_sweep_roofline", _run(
        requests=[req], trace=types.SimpleNamespace(ops=ops, host=[]),
        num_nodes=v, num_edges=e))
    c = costs.sweep_cost(v, e, b, 1)
    assert c["flops"] / peaks.FP32_FLOPS_PER_S > (
        c["bytes_accessed"] / peaks.HBM_BYTES_PER_S)
    assert math.isclose(got, 100 * c["flops"] / peaks.FP32_FLOPS_PER_S / 1e-5)
