"""PyTorch port: the profile store, the cost model, the tuning layer, the
roofline table and ``finalize_solve``, on the CPU against the JAX package.

Each package reads the other's ``profiles.jsonl`` into the same
``CostModel`` entries and predictions; ``resolve_param`` picks the same
tuned values from the same records; a solve with a store writes the
reference's record kinds, priced by the port's analytic model."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import erdos_renyi, grid2d, permute_labels, rmat
from paralleljohnson_tpu.observe import costs as ref_costs
from paralleljohnson_tpu.observe import roofline as ref_roofline
from paralleljohnson_tpu.observe import tuning as ref_tuning
from paralleljohnson_tpu.observe.store import CostModel as RefCostModel
from paralleljohnson_tpu.observe.store import ProfileStore as RefStore
from paralleljohnson_tpu.solver import ParallelJohnsonSolver as RefSolver

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import interop, observe
from paralleljohnson_tpu_torch.observe import costs, roofline, tuning
from paralleljohnson_tpu_torch.observe.store import CostModel, ProfileStore
from paralleljohnson_tpu_torch.solver.johnson import to_numpy

ONE = dict(mesh_shape=(1,), dia=False, gauss_seidel=False, bucket=False)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several pytest
    workers on the CPU, and torch's thread pool oversubscribed by them
    slows the small ops of these loops by orders of magnitude (one
    dirty-window fixpoint on the 48x48 grid: 22 s against 0.03 s with
    eight busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def _grid():
    return grid2d(24, 24, negative_fraction=0.2, seed=1)


def _solve_into(package, store_dir, g, sources, **kw):
    """One ``solve`` and one ``sssp`` with a profile store, in ``package``."""
    ref_cfg = RefConfig(**{**ONE, **kw, "profile_store": str(store_dir)})
    if package == "ref":
        solver = RefSolver(ref_cfg)
        graph = g
    else:
        solver = pjt.ParallelJohnsonSolver(
            interop.config_from_dict(dataclasses.asdict(ref_cfg)),
            device="cpu")
        graph = _port(g)
    solver.solve(graph, sources)
    solver.solve(graph, sources)  # the second one is priced by the first
    solver.sssp(graph, 3)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_fits_the_others_store(tmp_path, writer):
    """The store one package writes reads back record for record in the
    other, and both fit the same ``CostModel`` entries and predictions."""
    g = _grid()
    _solve_into(writer, tmp_path, g, np.arange(16), use_pallas=False)
    port_recs = ProfileStore(tmp_path).records()
    assert port_recs == RefStore(tmp_path).records()
    assert {r["kind"] for r in port_recs} >= {"plan", "solve", "trajectory"}
    port_model, ref_model = CostModel.fit(port_recs), RefCostModel.fit(
        port_recs)
    assert port_model.entries == ref_model.entries and port_model.entries
    for route, _platform in port_model.entries:
        for b in (1, 16, 100):
            kw = dict(num_edges=g.num_real_edges, batch=b, platform="cpu")
            assert port_model.predict(route, **kw) == ref_model.predict(
                route, **kw)
    assert port_model.table() == ref_model.table()


def test_port_solve_records(tmp_path):
    """A port solve with a store: the reference's record kinds, the sweep
    routes priced by the analytic model, ``frontier`` with the explicit
    marker, the roofline, and a prediction on the second solve."""
    g = _port(_grid())
    solver = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(profile_store=str(tmp_path)), device="cpu")
    first = solver.solve(g, np.arange(16))
    assert first.stats.predicted_s is None
    second = solver.solve(g, np.arange(16))
    assert second.stats.predicted_s is not None and second.stats.predicted_s > 0
    cost = second.stats.analytic_cost
    assert cost["captures"] == 1 and cost["cost_sources"] == ["analytic-model"]
    assert cost["unavailable"] == ["no analytic cost model for route "
                                   "'frontier'"]
    v, e = g.num_nodes, g.num_real_edges
    sweeps = second.stats.iterations_by_phase["fanout"]
    want = costs.sweep_cost(v, e, 16, sweeps)
    assert cost["flops"] == want["flops"]
    assert cost["bytes_accessed"] == want["bytes_accessed"]
    roof = second.stats.roofline
    assert roof["platform"] == "cpu" and roof["bound"] in roofline.BOUND_KINDS
    recs = ProfileStore(tmp_path).records()
    assert [r["kind"] for r in recs] == ["plan", "solve", "plan", "solve"]
    plan, solve = recs[2], recs[3]
    assert plan["route"] == "pallas-vm" and plan["chosen"] == "pallas-vm"
    assert plan["params"]["source_batch"] == second.stats.final_batch
    assert solve["route"] == "pallas-vm" and solve["platform"] == "cpu"
    assert solve["cost"]["cost_sources"] == ["analytic-model"]
    assert "device" not in solve  # only cuda records name a card


def test_analytic_models_match_the_kernel_bounds():
    """The sweep's per-sweep bytes are chip_smoke's bound for the sweep
    kernel (f32: 4 (2 V B + (V + 1) + 2 E)), min-plus's the product's."""
    v, e, b = 1000, 16000, 128
    c = costs.sweep_cost(v, e, b, 1)
    assert c["bytes_accessed"] == 4 * (2 * v * b + (v + 1) + 2 * e)
    assert c["flops"] == 2 * e * b
    m = costs.minplus_cost(16, 1024, 512, 3)
    assert m["flops"] == 3 * 2 * 16 * 1024 * 512
    assert m["bytes_accessed"] == 3 * 4 * (16 * 1024 + 1024 * 512 + 16 * 512)
    assert costs.add_costs(c, m)["flops"] == c["flops"] + m["flops"]
    cap = costs.CostCapture(enabled=False)
    assert cap.analytic("vm", c, num_nodes=v, num_edges=e) is None
    cap = costs.CostCapture(platform="cuda")
    rec = cap.unavailable("gs", "why", num_nodes=v, num_edges=e, batch=b)
    assert rec["cost_analysis_unavailable"] == "why"
    assert rec["shape_bucket"] == list(ref_costs.shape_bucket(v, e, b))
    assert cap.records() == [rec]


def test_roofline_table_and_classification():
    """A cuda row (the H100 SXM5 datasheet) and a cpu row, no tpu or A100
    row; ``classify`` reads like the reference's on the cpu row."""
    assert set(roofline.PLATFORM_PEAKS) == {"cuda", "cpu"}
    assert roofline.PLATFORM_PEAKS["cuda"] == {"mem_gbps": 3350.0,
                                               "flops_gflops": 67000.0}
    assert roofline.PLATFORM_PEAKS["cpu"] == ref_roofline.PLATFORM_PEAKS["cpu"]
    assert roofline.BOUND_KINDS == ref_roofline.BOUND_KINDS
    for kw in (dict(flops=1e9, bytes_accessed=1e6, compute_s=0.1),
               dict(flops=1e6, bytes_accessed=1e9, compute_s=0.1),
               dict(flops=None, bytes_accessed=1e9),
               dict(flops=1e6, bytes_accessed=1e6, host_io_s=2.0,
                    wall_s=3.0)):
        assert roofline.classify(**kw, platform="cpu") == \
            ref_roofline.classify(**kw, platform="cpu")
    hbm = roofline.classify(flops=1e6, bytes_accessed=3.35e9,
                            platform="cuda")
    assert hbm["bound"] == "hbm" and hbm["t_hbm_s"] == pytest.approx(1e-3)
    assert roofline.classify(flops=6.7e10, bytes_accessed=1.0,
                             platform="cuda")["bound"] == "mxu"


def test_current_platform_and_card_info_without_a_card():
    assert observe.current_platform(torch.device("cpu")) == "cpu"
    assert observe.current_platform(None) == "cpu"
    assert observe.current_platform(torch.device("cuda", 0)) == "cuda"
    assert observe.current_platform("cuda:1") == "cuda"


def _tune_recs():
    """Tune and plan records of two shape buckets: in (cpu, 512, 16384)
    tile 256 measures 1.0 s, 512 (the seed) 2.0 s, 128 only censored; a
    demotion erases an old win of tile 384."""
    base = dict(platform="cpu", nodes=300, edges=9000, batch=300, ts=10.0)
    recs = [
        {**base, "kind": "plan", "params": {"fw_tile": 512},
         "measured": {"wall_s": 2.0, "compute_s": 2.0}},
        {**base, "kind": "tune", "knob": "fw_tile", "value": 256,
         "measured": {"wall_s": 1.0}},
        {**base, "kind": "tune", "knob": "fw_tile", "value": 128,
         "censored": True, "measured": {"wall_s": 0.1}},
        {**base, "kind": "plan", "params": {"fw_tile": 384}, "ts": 5.0,
         "measured": {"wall_s": 0.5}},
        {**base, "kind": "tune", "knob": "fw_tile", "value": 384,
         "event": "demote", "ts": 6.0},
        {**base, "kind": "plan", "nodes": 5000, "params": {"fw_tile": 128},
         "measured": {"wall_s": 0.01}},
        {**base, "kind": "plan", "params": {"pipeline_depth": 3},
         "measured": {"wall_s": 1.0}},
        {**base, "kind": "plan", "params": {"pipeline_depth": 2},
         "measured": {"wall_s": 1.9}},
    ]
    return recs


@pytest.mark.parametrize("knob,explicit,fallback", [
    ("fw_tile", None, 512), ("fw_tile", 128, 512),
    ("pipeline_depth", None, 2), ("partition_parts", None, 4),
])
@pytest.mark.parametrize("nodes", [300, 5000])
def test_resolve_param_picks_the_reference_value(tmp_path, monkeypatch,
                                                 knob, explicit, fallback,
                                                 nodes):
    store = ProfileStore(tmp_path)
    for r in _tune_recs():
        store.append(r)
    valid = lambda t: isinstance(t, int) and t >= 1  # noqa: E731
    kw = dict(store_dir=str(tmp_path), platform="cpu", num_nodes=nodes,
              num_edges=9000, validate=valid)
    got = tuning.resolve_param(knob, explicit, fallback, **kw)
    assert got == ref_tuning.resolve_param(knob, explicit, fallback, **kw)
    assert tuning.param_provenance(knob, fallback=fallback, **kw) == \
        ref_tuning.param_provenance(knob, fallback=fallback, **kw)
    if knob == "fw_tile" and explicit is None and nodes == 300:
        assert got == (256, "profile-tuned")
    monkeypatch.setenv("PJ_NO_TUNE", "1")
    assert tuning.resolve_param(knob, explicit, fallback, **kw) == \
        ref_tuning.resolve_param(knob, explicit, fallback, **kw)
    assert tuning.resolve_param(knob, None, fallback, platform="cpu",
                                num_nodes=nodes, num_edges=9000) == (
        fallback, "default")


def test_solves_pick_up_the_tuned_fw_tile(tmp_path):
    """A store whose records favour fw_tile 128 for this shape: the port's
    and the reference's ``fw`` solves both take 128 ("profile-tuned"),
    bitwise equal to an explicit ``fw_tile=128`` solve."""
    g = erdos_renyi(300, 0.1, seed=3)
    g = g.with_weights(np.round(g.weights))
    base = dict(platform="cpu", nodes=g.num_nodes, edges=g.num_real_edges,
                batch=300, ts=1.0)
    store = ProfileStore(tmp_path)
    for tile, wall in ((512, 1.0), (128, 0.1)):
        store.append({**base, "kind": "plan", "params": {"fw_tile": tile},
                      "measured": {"wall_s": wall}})
    kw = dict(fw=True, profile_store=str(tmp_path))
    port = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**kw),
                                     device="cpu").solve(_port(g))
    params = port.stats.plans_by_phase["fanout"]["params"]
    assert (params["fw_tile"], params["fw_tile_source"]) == (
        128, "profile-tuned")
    ref = RefSolver(RefConfig(**ONE, **kw)).solve(g)
    assert ref.stats.plan["params"]["fw_tile"] == 128
    pinned = pjt.ParallelJohnsonSolver(pjt.SolverConfig(fw=True, fw_tile=128),
                                       device="cpu").solve(_port(g))
    np.testing.assert_array_equal(to_numpy(port.dist), to_numpy(pinned.dist))
    np.testing.assert_array_equal(to_numpy(port.dist), np.asarray(ref.dist))


def test_dirty_window_and_profile_store_no_longer_raise(tmp_path):
    """``dirty_window=True`` and ``profile_store`` are honoured now, and
    so is ``telemetry``: the same solve with a flight recorder returns
    the same rows, bitwise."""
    g = _port(_grid())
    res = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(dirty_window=True, profile_store=str(tmp_path)),
        device="cpu").solve(g, np.arange(8))
    assert res.stats.routes_by_phase["fanout"] == "vm-blocked+dw"
    assert ProfileStore(tmp_path).records()
    assert pjt.SolverConfig(dirty_window=True,
                            profile_store="x").unsupported("cuda") == []
    from paralleljohnson_tpu_torch.utils.telemetry import Telemetry

    traced = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(dirty_window=True, telemetry=Telemetry()),
        device="cpu").solve(g, np.arange(8))
    np.testing.assert_array_equal(to_numpy(traced.dist), to_numpy(res.dist))


def test_profile_dir_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("PJ_PROFILE_DIR", str(tmp_path))
    assert costs.resolve_profile_dir() == str(tmp_path)
    assert costs.resolve_profile_dir("x") == "x"
    g = _port(rmat(7, 8, seed=1))
    pjt.ParallelJohnsonSolver(device="cpu").multi_source(g, np.arange(4))
    recs = ProfileStore(tmp_path).records()
    assert [r["kind"] for r in recs] == ["plan", "solve"]
    assert recs[1]["label"] == "multi_source"
