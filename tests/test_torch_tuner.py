"""PyTorch port: the budgeted probe tuner (``tuner.py``) against the JAX
package's.

The same bucket, seed and records give the same candidate lists; the
declared work list is the reference's, the approximate tier's
``approx_beta`` included; a store either package's ``tune_bucket`` writes
resolves to the same tuned value in the other. The reference's
invariants hold in the port (a hard wall, zero budget as a no-op, the
noise band, censored values never promoted), with injected ``solve_fn``
probes whose walls are sleeps, and one real probe on the CPU. The
idle-capacity farm (plan, lease, run, harvest) plans the reference's
jobs and keeps its crash contract, and the repair-vs-resolve walk
decides as the reference's."""

import json
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu import planner as ref_planner
from paralleljohnson_tpu import tuner as ref_tuner
from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import load_graph
from paralleljohnson_tpu.observe import tuning as ref_tuning
from paralleljohnson_tpu.observe.store import ProfileStore as RefStore

from paralleljohnson_tpu_torch import interop, planner, tuner
from paralleljohnson_tpu_torch.config import SolverConfig
from paralleljohnson_tpu_torch.observe import tuning
from paralleljohnson_tpu_torch.observe.store import ProfileStore

SPEC = "er:n=64,p=0.1,seed=1"
PORTED = list(tuner.KNOB_SPECS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU, and an oversubscribed torch thread pool slows small solves by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return load_graph(SPEC)


@pytest.fixture(scope="module")
def port_graph(graph):
    return interop.graph_from_arrays(graph.indptr, graph.indices,
                                     graph.weights)


def _sleeper(walls: dict):
    def fn(graph, sources, cfg):
        time.sleep(walls[cfg.fw_tile])

    return fn


def test_knob_specs_and_work_list_equal_reference():
    fields = ("name", "config_field", "plan", "overrides")
    assert {k: tuple(getattr(s, f) for f in fields)
            for k, s in tuner.KNOB_SPECS.items()} == {
        k: tuple(getattr(s, f) for f in fields)
        for k, s in ref_tuner.KNOB_SPECS.items()}
    assert tuner.declared_tunables() == ref_tuner.declared_tunables()
    assert ("hopset+bf", "approx_beta") in tuner.declared_tunables()
    assert tuner.tunable_knobs() == ref_tuner.tunable_knobs()


@pytest.mark.parametrize("knob", PORTED)
@pytest.mark.parametrize("cfg", [{}, {"fw_tile": 384, "partition_parts": 6,
                                      "delta": 2.0, "source_batch_size": 48,
                                      "pipeline_depth": 3}])
@pytest.mark.parametrize("shape", [(64, 400), (5000, 40000)])
def test_propose_candidates_equal_reference(knob, cfg, shape):
    v, e = shape
    kw = dict(num_nodes=v, num_edges=e, platform="cpu")
    plain = tuner.propose_candidates(knob, config=SolverConfig(**cfg), **kw)
    assert plain == ref_tuner.propose_candidates(
        knob, config=RefConfig(**cfg), **kw)
    spec = tuner.KNOB_SPECS[knob]
    assert all(spec.validate(c) for c in plain)
    recs = [ref_planner.tune_record(knob=knob, value=plain[-1],
                                    platform="cpu", num_nodes=v,
                                    num_edges=e, wall_s=0.1),
            {"kind": "plan", "platform": "cpu", "nodes": v, "edges": e,
             "params": {knob: plain[0]}}]
    got = tuner.propose_candidates(knob, config=SolverConfig(**cfg),
                                   records=recs, **kw)
    assert got == ref_tuner.propose_candidates(
        knob, config=RefConfig(**cfg), records=recs, **kw)
    assert sorted(map(str, got)) == sorted(map(str, plain))


def test_approx_beta_names_the_missing_module(port_graph, tmp_path):
    """``solver/approx`` is ported: ``approx_beta`` proposes the
    reference's candidates (seeded by ``auto_beta``) and a real probe
    runs the forced ``hopset+bf`` plan on the CPU, uncensored."""
    kw = dict(num_nodes=64, num_edges=400, platform="cpu")
    assert tuner.propose_candidates("approx_beta", **kw) == \
        ref_tuner.propose_candidates("approx_beta", **kw)
    res = tuner.run_probe(port_graph, knob="approx_beta", value=4,
                          store=ProfileStore(tmp_path), budget_s=60.0,
                          device="cpu")
    assert not res.censored and res.wall_s is not None
    assert ProfileStore(tmp_path).records()[-1]["kind"] == "tune"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tuned_store_resolves_alike_in_both_packages(writer, graph,
                                                     port_graph, tmp_path):
    """One package's ``tune_bucket`` writes the store (a challenger past
    the band); both packages' resolvers and provenance tables read it the
    same way."""
    kw = dict(knobs=["fw_tile"], candidates={"fw_tile": [512, 640]},
              probe_budget_s=30.0, bucket_budget_s=60.0,
              solve_fn=_sleeper({512: 0.30, 640: 0.02}))
    store = tmp_path / "store"
    if writer == "port":
        summary = tuner.tune_bucket(port_graph, store_dir=store,
                                    config=SolverConfig(fw_tile=512),
                                    device="cpu", **kw)
    else:
        summary = ref_tuner.tune_bucket(graph, store_dir=store,
                                        config=RefConfig(fw_tile=512), **kw)
    assert summary["knobs"]["fw_tile"]["winner"] == 640
    q = dict(store_dir=str(store), platform="cpu",
             num_nodes=graph.num_nodes, num_edges=graph.num_real_edges,
             fallback=512)
    assert tuning.tuned_value("fw_tile", **q) == 640
    assert ref_tuning.tuned_value("fw_tile", **q) == 640
    assert ProfileStore(store).records() == RefStore(store).records()
    prov = dict(store_dir=store, platform="cpu", num_nodes=graph.num_nodes,
                num_edges=graph.num_real_edges)
    ours = tuner.provenance_table(config=SolverConfig(fw_tile=512), **prov)
    theirs = ref_tuner.provenance_table(config=RefConfig(fw_tile=512), **prov)
    assert ours == theirs
    assert ours[0]["knob"] == "fw_tile"
    assert ours[0]["source"] == "tuner-promoted"


def test_probe_budget_is_a_hard_wall(port_graph, tmp_path):
    store = ProfileStore(tmp_path / "store")
    t0 = time.perf_counter()
    res = tuner.run_probe(port_graph, knob="fw_tile", value=256, store=store,
                          budget_s=0.3, solve_fn=_sleeper({256: 30.0}),
                          device="cpu")
    assert time.perf_counter() - t0 < 5.0
    assert res.censored and res.wall_s is None and "budget" in res.reason
    (rec,) = store.records()
    assert rec["censored"] is True and rec["platform"] == "cpu"
    assert tuning.tuned_value(
        "fw_tile", store_dir=str(tmp_path / "store"), platform="cpu",
        num_nodes=port_graph.num_nodes, num_edges=port_graph.num_real_edges,
        fallback=128) is None


def test_probe_error_is_censored_and_bad_candidate_rejected(port_graph,
                                                            tmp_path):
    def boom(graph, sources, cfg):
        raise RuntimeError("probe exploded")

    store = ProfileStore(tmp_path / "store")
    res = tuner.run_probe(port_graph, knob="fw_tile", value=256, store=store,
                          budget_s=5.0, solve_fn=boom, device="cpu")
    assert res.censored and "probe exploded" in res.reason
    assert [r["censored"] for r in store.records()] == [True]
    with pytest.raises(ValueError, match="invalid candidate"):
        tuner.run_probe(port_graph, knob="fw_tile", value=100, store=store,
                        budget_s=1.0, device="cpu")


def test_real_probe_lands_its_solve_records(port_graph, tmp_path):
    """The default probe solves the graph on the device it is given with
    the knob pinned and its route forced; its plan and solve records and
    one tune record land in the store."""
    store = ProfileStore(tmp_path / "store")
    res = tuner.run_probe(port_graph, knob="fw_tile", value=128, store=store,
                          budget_s=120.0, device="cpu")
    assert not res.censored and res.records_landed >= 2
    kinds = [r["kind"] for r in store.records()]
    assert kinds[-1] == "tune" and "plan" in kinds and "solve" in kinds
    plan = next(r for r in store.records() if r["kind"] == "plan")
    assert plan["params"]["fw_tile"] == 128 and plan["platform"] == "cpu"


def test_zero_budget_never_opens_the_store(port_graph, tmp_path):
    summary = tuner.tune_bucket(
        port_graph, store_dir=tmp_path / "store", knobs=["fw_tile"],
        candidates={"fw_tile": [128, 256]}, bucket_budget_s=0.0,
        solve_fn=_sleeper({128: 0.01, 256: 0.01}), device="cpu")
    assert summary["probes"] == 0
    assert summary["skipped"] == "zero tuning budget"
    assert not (tmp_path / "store").exists()


@pytest.mark.parametrize("walls,winner", [
    ({512: 0.30, 640: 0.27}, None),   # faster, but inside the 25% band
    ({512: 0.30, 640: 0.02}, 640),    # past the band: promoted
])
def test_noise_band_gates_promotion(port_graph, tmp_path, walls, winner):
    summary = tuner.tune_bucket(
        port_graph, store_dir=tmp_path / "store",
        config=SolverConfig(fw_tile=512), knobs=["fw_tile"],
        candidates={"fw_tile": [512, 640]}, probe_budget_s=30.0,
        bucket_budget_s=60.0, solve_fn=_sleeper(walls), device="cpu")
    knob = summary["knobs"]["fw_tile"]
    assert knob["seed"] == 512
    assert knob["winner"] == winner
    assert knob["promoted"] is (winner is not None)
    assert planner.PLANNER_NOISE_BAND == tuning.TUNE_NOISE_BAND


def test_censored_challenger_never_promotes(port_graph, tmp_path):
    summary = tuner.tune_bucket(
        port_graph, store_dir=tmp_path / "store",
        config=SolverConfig(fw_tile=512), knobs=["fw_tile"],
        candidates={"fw_tile": [512, 640]}, probe_budget_s=0.3,
        bucket_budget_s=60.0, max_rungs=0,
        solve_fn=_sleeper({512: 0.02, 640: 30.0}), device="cpu")
    knob = summary["knobs"]["fw_tile"]
    assert summary["censored"] >= 1
    assert knob["winner"] is None and knob["promoted"] is False
    measured = {r["value"] for r in ProfileStore(tmp_path / "store").records()
                if r.get("kind") == "tune" and not r.get("censored")}
    assert 640 not in measured


def test_unknown_knob_raises(port_graph, tmp_path):
    with pytest.raises(ValueError, match="unknown knob"):
        tuner.tune_bucket(port_graph, store_dir=tmp_path / "s",
                          knobs=["warp_drive"], device="cpu")


# -- the idle-capacity farm ---------------------------------------------------


def _fleet(tmp_path, graph, *, package="port", **kw):
    kw.setdefault("knobs", ["fw_tile"])
    kw.setdefault("candidates", {"fw_tile": [256, 384]})
    kw.setdefault("probe_budget_s", 5.0)
    if package == "port":
        return tuner.plan_tuning_fleet(tmp_path / "fleet", graph_spec=SPEC,
                                       graph=graph, device="cpu", **kw)
    return ref_tuner.plan_tuning_fleet(tmp_path / "fleet", graph_spec=SPEC,
                                       graph=graph, **kw)


@pytest.mark.parametrize("kw", [
    {},
    {"knobs": ["fw_tile", "source_batch", "pipeline_depth"],
     "candidates": None, "probe_budget_s": 2.0},
    {"knobs": ["partition_parts", "delta"], "candidates": None,
     "probe_budget_s": 1.0, "target_lease_s": 2.0},
])
def test_tuning_fleet_plan_equals_reference(kw, graph, port_graph, tmp_path):
    ours = _fleet(tmp_path / "port", port_graph, **kw)
    theirs = _fleet(tmp_path / "ref", graph, package="ref", **kw)
    assert ours.spec["config"] == theirs.spec["config"]
    for key in ("graph_spec", "graph_digest", "num_sources", "leases",
                "lease_deadline_s"):
        assert ours.spec[key] == theirs.spec[key], key
    assert ours.spec["backend"] == "torch"
    # approx_beta (solver/approx) plans the reference's leases too.
    ours = _fleet(tmp_path / "port_approx", port_graph, knobs=["approx_beta"],
                  candidates=None)
    theirs = _fleet(tmp_path / "ref_approx", graph, package="ref",
                    knobs=["approx_beta"], candidates=None)
    assert ours.spec["config"] == theirs.spec["config"]
    assert ours.spec["leases"] == theirs.spec["leases"]


def test_tuning_lease_crash_requeues_and_second_worker_commits(
        port_graph, tmp_path):
    """The crash contract for tuning leases: a claimed lease whose worker
    dies requeues; the survivor's commit wins; the dead worker's late
    commit is stale; harvest merges only the committed shard."""
    from paralleljohnson_tpu_torch.distributed.coordinator import (
        Coordinator, StaleLeaseError,
    )

    coord = _fleet(tmp_path, port_graph, lease_deadline_s=5.0)
    assert len(coord.leases()) == 1
    stale_coord = Coordinator(tmp_path / "fleet")
    lease = stale_coord.claim("wA", now=100.0)
    shard_a = ProfileStore(
        stale_coord.shard_dir("wA") / f"tune-lease{lease.lease_id}")
    tuner.run_probe(port_graph, knob="fw_tile", value=256, store=shard_a,
                    budget_s=5.0, label="tuner:wA",
                    solve_fn=_sleeper({256: 0.01}), device="cpu")
    assert [e["ev"] for e in stale_coord.reap(now=200.0)] == ["requeued"]
    result = tuner.try_tuning_lease(
        tmp_path / "fleet", "wB", graph=port_graph,
        solve_fn=_sleeper({256: 0.01, 384: 0.01}), device="cpu")
    assert result is not None and result["lease"] == lease.lease_id
    assert len(result["probes"]) == 2
    committed = Coordinator(tmp_path / "fleet").leases()[0]
    assert (committed.state, committed.committed_by) == ("committed", "wB")
    with pytest.raises(StaleLeaseError):
        stale_coord.commit(lease.lease_id, "wA", now=300.0)
    out = tuner.harvest_tuning(tmp_path / "fleet", tmp_path / "store")
    assert out["leases_harvested"] == 1 and out["records"] > 0
    labels = {r.get("label") for r in ProfileStore(tmp_path / "store")
              .records()}
    assert labels == {"tuner:wB"}


@pytest.mark.parametrize("harvester", ["port", "ref"])
def test_harvest_is_idempotent_and_reads_across_packages(
        harvester, port_graph, tmp_path):
    """A port fleet drained by ``run_tuning_worker`` is harvested once by
    either package's ``harvest_tuning``; a second harvest merges
    nothing."""
    _fleet(tmp_path, port_graph)
    done = tuner.run_tuning_worker(
        tmp_path / "fleet", "w0", graph=port_graph,
        solve_fn=_sleeper({256: 0.01, 384: 0.01}), device="cpu")
    assert done["fleet_done"] and len(done["leases"]) == 1
    harvest = (tuner if harvester == "port" else ref_tuner).harvest_tuning
    first = harvest(tmp_path / "fleet", tmp_path / "store")
    assert first["leases_harvested"] == 1 and first["fleet_done"]
    n = len(ProfileStore(tmp_path / "store").records())
    second = harvest(tmp_path / "fleet", tmp_path / "store")
    assert second["leases_harvested"] == 0
    assert second["total_harvested"] == first["total_harvested"]
    assert len(ProfileStore(tmp_path / "store").records()) == n
    assert json.loads((tmp_path / "fleet" / tuner.HARVESTED_FILE)
                      .read_text()) == [0]


def test_try_tuning_lease_ignores_other_dirs_and_graphs(port_graph, tmp_path):
    from paralleljohnson_tpu_torch.distributed.coordinator import Coordinator
    from paralleljohnson_tpu_torch.graphs import load_graph as port_load

    assert tuner.try_tuning_lease(tmp_path / "nope", "w0", graph=port_graph,
                                  device="cpu") is None
    Coordinator.create(tmp_path / "solve", graph_spec=SPEC,
                       graph_digest="d" * 16, num_sources=8, lease_sources=4)
    assert tuner.try_tuning_lease(tmp_path / "solve", "w0", graph=port_graph,
                                  device="cpu") is None
    _fleet(tmp_path, port_graph)
    other = port_load("er:n=48,p=0.1,seed=2")
    assert tuner.try_tuning_lease(tmp_path / "fleet", "w0", graph=other,
                                  device="cpu") is None
    assert Coordinator(tmp_path / "fleet").leases()[0].state == "pending"


def test_probe_failure_commits_and_lease_error_releases(port_graph, tmp_path,
                                                        monkeypatch):
    from paralleljohnson_tpu_torch.distributed.coordinator import Coordinator

    def boom(graph, sources, cfg):
        raise RuntimeError("bad candidate")

    _fleet(tmp_path / "a", port_graph)
    result = tuner.try_tuning_lease(tmp_path / "a" / "fleet", "w0",
                                    graph=port_graph, solve_fn=boom,
                                    device="cpu")
    assert result is not None and all(p["censored"]
                                      for p in result["probes"])
    assert Coordinator(tmp_path / "a" / "fleet").leases()[0].state \
        == "committed"

    def broken_probe(*a, **kw):
        raise OSError("shard store unwritable")

    _fleet(tmp_path / "b", port_graph)
    monkeypatch.setattr(tuner, "run_probe", broken_probe)
    with pytest.raises(OSError, match="unwritable"):
        tuner.try_tuning_lease(tmp_path / "b" / "fleet", "w0",
                               graph=port_graph, device="cpu")
    assert Coordinator(tmp_path / "b" / "fleet").leases()[0].state \
        == "pending"


def test_fleet_worker_drains_tuning_leases_when_idle(port_graph, tmp_path):
    """A solve worker with nothing left to claim runs the tuning fleet's
    leases (``--tune-dir``) before it exits."""
    from paralleljohnson_tpu_torch import distributed

    _fleet(tmp_path, port_graph, candidates={"fw_tile": [128]})
    coord = distributed.plan_fleet(tmp_path / "solve", SPEC, n_workers=1,
                                   num_sources=8, lease_sources=8,
                                   config={"source_batch_size": 8})
    coord.claim("other")  # the one lease is held elsewhere
    with pytest.raises(TimeoutError, match="no claimable lease"):
        distributed.run_worker(coord.dir, "w1", device="cpu",
                               tune_dir=tmp_path / "fleet",
                               idle_timeout_s=0.2, poll_s=0.05)
    summary = json.loads(coord.worker_summary_path("w1").read_text())
    assert summary["tuning_leases"] == 1 and summary["claims"] == 0
    assert summary["rc"] == 1


# -- the repair-vs-resolve walk -----------------------------------------------


@pytest.mark.parametrize("strategy", ["auto", "repair", "resolve"])
def test_repair_select_parity_unpriced(strategy, graph, port_graph,
                                       tmp_path):
    from paralleljohnson_tpu.incremental.repair import (
        decide_repair_strategy as ref_decide,
    )
    from paralleljohnson_tpu_torch.incremental.repair import (
        decide_repair_strategy,
    )

    report = types.SimpleNamespace(old_digest="0" * 16, new_digest="1" * 16,
                                   changed_edges=np.zeros((0, 3)))
    ours = decide_repair_strategy(
        tmp_path / "ckpt", port_graph, report,
        config=SolverConfig(profile_store=None), strategy=strategy,
        device="cpu")
    theirs = ref_decide(tmp_path / "ckpt", graph, report,
                        config=RefConfig(profile_store=None),
                        strategy=strategy)
    assert ours.as_dict() == theirs.as_dict()
    assert ours.chosen.plan.name == ("resolve" if strategy == "resolve"
                                     else "repair")
    assert ours.params["affected_rows_estimate"] == graph.num_nodes
    with pytest.raises(ValueError, match="auto/repair/resolve"):
        decide_repair_strategy(tmp_path / "ckpt", port_graph, report,
                               strategy="yolo", device="cpu")
