"""PyTorch port: the distributed solve fleet (``distributed/*``) against
the JAX package's.

Each coordinator and manifest case of the reference's
``tests/test_distributed.py`` runs on both packages' ``Coordinator`` with
the same explicit clocks and hand-written heartbeats, and their lease
tables, events and errors must be equal. The same fleet plan runs through
each package's in-process fleet: lease tables equal, merged rows bitwise
equal to each other and to the port's ``solve()``, and each package's
``status()`` and ``fleet_rows`` read the other's directory. A subprocess
fleet runs on the CPU (``--device cpu``); the kill drill is slow-marked,
as the reference's is."""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu import distributed as ref_dist
from paralleljohnson_tpu.distributed import launch as ref_launch
from paralleljohnson_tpu.utils import checkpoint as ref_ckpt

from paralleljohnson_tpu_torch import ParallelJohnsonSolver, SolverConfig
from paralleljohnson_tpu_torch import distributed
from paralleljohnson_tpu_torch.distributed import launch, worker
from paralleljohnson_tpu_torch.graphs import load_graph
from paralleljohnson_tpu_torch.utils import checkpoint

SPEC = "er:n=96,p=0.04,seed=7"
# The parity plan: ER-96 at average degree ~4, nonnegative
# weights, so no reweighting and every route's rows agree bitwise.
FLEET_SPEC = f"er:n=96,p={round(4.0 / 96, 6)},seed=13"
BATCH = {"source_batch_size": 16}
PACKAGES = {"port": (distributed, checkpoint), "ref": (ref_dist, ref_ckpt)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU, and an oversubscribed torch thread pool slows small solves by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coord(dist, d, *, num_sources=40, lease_sources=10, deadline=5.0,
           stale=5.0, **kw):
    return dist.Coordinator.create(
        d / "coord", graph_spec=SPEC, graph_digest="d" * 16,
        num_sources=num_sources, lease_sources=lease_sources,
        lease_deadline_s=deadline, heartbeat_stale_s=stale, **kw)


def _beat(coord, worker_id, ts):
    p = coord.heartbeat_path(worker_id)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps({"ts": ts}), encoding="utf-8")


def _table(leases):
    return [l.as_dict() for l in leases]


def _events(events):
    return [{k: e[k] for k in sorted(e)} for e in events]


def _outcome(fn):
    """``("ok", value)`` or ``("raised", type name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))


# -- the coordinator's state machine, case by case --------------------------


def case_plan_partitions_sources(dist, d):
    coord = _coord(dist, d, num_sources=25, lease_sources=10)
    assert [(l.start, l.stop) for l in coord.leases()] == [
        (0, 10), (10, 20), (20, 25)]
    return {"table": _table(coord.leases()), "done": coord.done()}


def case_create_refuses_existing_plan(dist, d):
    _coord(dist, d)
    out = _outcome(lambda: _coord(dist, d))
    assert out[0] == "raised" and "already exists" in out[2]
    return out[:2]


def case_claim_commit_lifecycle(dist, d):
    coord = _coord(dist, d, num_sources=20, lease_sources=10)
    a = coord.claim("w0", now=100.0)
    b = coord.claim("w1", now=100.0)
    none = coord.claim("w2", now=100.0)
    coord.commit(0, "w0", now=101.0)
    coord.commit(1, "w1", now=101.0)
    status = coord.status(now=102.0)
    assert none is None and coord.done()
    assert status["committed_by"] == {"w0": 1, "w1": 1}
    return {"claims": [a.as_dict(), b.as_dict()],
            "table": _table(coord.leases()),
            "status": {k: status[k] for k in (
                "leases", "requeues", "extensions", "committed_by",
                "outstanding", "done", "leases_total")}}


def case_lapsed_lease_requeues_when_heartbeat_stale(dist, d):
    coord = _coord(dist, d, deadline=5.0, stale=5.0)
    coord.claim("w0", now=100.0)
    _beat(coord, "w0", 100.0)
    early = coord.reap(now=104.0)
    events = coord.reap(now=106.0)
    again = coord.claim("w1", now=106.0)
    assert early == [] and [e["ev"] for e in events] == ["requeued"]
    assert again.lease_id == 0 and again.owner == "w1"
    return {"events": _events(events), "table": _table(coord.leases())}


def case_lapsed_lease_extends_when_heartbeat_fresh(dist, d):
    coord = _coord(dist, d, deadline=5.0, stale=60.0)
    coord.claim("w0", now=100.0)
    _beat(coord, "w0", 104.0)
    events = coord.reap(now=106.0)
    lease = coord.leases()[0]
    assert [e["ev"] for e in events] == ["extended"]
    assert lease.deadline == 111.0 and lease.extensions == 1
    coord.commit(0, "w0", now=108.0)
    return {"events": _events(events), "table": _table(coord.leases())}


def case_stale_commit_and_release_raise(dist, d):
    coord = _coord(dist, d, deadline=5.0, stale=5.0)
    coord.claim("w0", now=100.0)
    coord.reap(now=200.0)
    coord.claim("w1", now=200.0)
    stale = _outcome(lambda: coord.commit(0, "w0", now=201.0))
    release = _outcome(lambda: coord.release(0, "w0", reason="error",
                                             now=201.0))
    coord.commit(0, "w1", now=202.0)
    assert stale[:2] == release[:2] == ("raised", "StaleLeaseError")
    assert "re-queued" in stale[2]
    return {"stale": stale, "release": release,
            "table": _table(coord.leases())}


def case_release_requeues_and_recover_worker(dist, d):
    coord = _coord(dist, d, num_sources=20, lease_sources=10)
    coord.claim("w0", now=100.0)
    coord.release(0, "w0", reason="error", now=101.0)
    after_release = _table(coord.leases())
    coord.claim("w0", now=102.0)
    recovered = coord.recover_worker("w0", now=103.0)
    assert recovered == [0] and coord.leases()[0].state == "pending"
    return {"after_release": after_release, "recovered": recovered,
            "table": _table(coord.leases())}


def case_log_replay_resumes_and_rejects_corruption(dist, d):
    coord = _coord(dist, d, num_sources=20, lease_sources=10)
    coord.claim("w0", now=100.0)
    coord.commit(0, "w0", now=101.0)
    replayed = [l.state for l in dist.Coordinator(coord.dir).leases()]
    log = coord.dir / "leases.jsonl"
    log.write_text(log.read_text() + '{"ev": "claim', encoding="utf-8")
    torn = [l.state for l in dist.Coordinator(coord.dir).leases()]
    lines = log.read_text().splitlines()
    lines[0] = '{"torn": '
    log.write_text("\n".join(lines) + "\n", encoding="utf-8")
    corrupt = _outcome(lambda: dist.Coordinator(coord.dir).leases())
    assert replayed == torn == ["committed", "pending"]
    assert corrupt[1] == "CoordinatorError" and "leases.jsonl:1" in corrupt[2]
    return {"replayed": replayed, "torn": torn, "corrupt": corrupt[:2]}


def case_invalid_transition_is_loud(dist, d):
    coord = _coord(dist, d)
    with open(coord.dir / "leases.jsonl", "a", encoding="utf-8") as f:
        f.write(json.dumps({"ev": "committed", "lease": 0, "worker": "w0",
                            "ts": 1.0}) + "\n")
    out = _outcome(coord.leases)
    assert out[1] == "CoordinatorError" and "invalid transition" in out[2]
    return out[:2]


COORDINATOR_CASES = {name[len("case_"):]: fn for name, fn in globals().items()
                     if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(COORDINATOR_CASES))
def test_coordinator_case_matches_reference(case, tmp_path):
    fn = COORDINATOR_CASES[case]
    got = {name: fn(dist, tmp_path / name)
           for name, (dist, _) in PACKAGES.items()}
    assert got["port"] == got["ref"]


def test_create_refuses_unregistered_backend_and_defaults_to_torch(tmp_path):
    with pytest.raises(distributed.CoordinatorError, match="'jax' is not"):
        _coord(distributed, tmp_path, backend="jax")
    assert not (tmp_path / "coord" / "fleet.json").exists()
    assert _coord(distributed, tmp_path).spec["backend"] == "torch"


# -- manifest union ----------------------------------------------------------


def _shard_with(ckpt, d, name, batches):
    out = d / name
    saver = ckpt.BatchCheckpointer(out)
    for idx, sources in batches.items():
        sources = np.asarray(sources, np.int64)
        saver.save(idx, sources,
                   np.full((len(sources), 4), float(idx), np.float32))
    return out


@pytest.mark.parametrize("shards,error", [
    ({"a": {0: [0, 1], 1: [2, 3]}, "b": {0: [4, 5]}}, None),
    ({"a": {0: [0, 1, 2]}, "b": {0: [2, 3]}}, "source 2"),
    ({"a": {0: [0]}, "empty": {}}, "manifest.json"),
])
def test_union_manifests_matches_reference(shards, error, tmp_path):
    got = {}
    for name, (_, ckpt) in PACKAGES.items():
        d = tmp_path / name
        dirs = []
        for shard, batches in shards.items():
            dirs.append(_shard_with(ckpt, d, shard, batches))
            dirs[-1].mkdir(parents=True, exist_ok=True)
        out = _outcome(lambda: ckpt.union_manifests(dirs))
        if out[0] == "ok":
            out = ("ok", {s: (b, Path(f).relative_to(d).as_posix())
                          for s, (b, f) in out[1].items()})
        else:
            out = (*out[:2], out[2].replace(d.as_posix(), "<d>"))
        got[name] = out
    assert got["port"] == got["ref"]
    if error is None:
        assert sorted(got["port"][1]) == [0, 1, 2, 3, 4, 5]
    else:
        assert error in got["port"][2]


def case_manifest_orphans(dist, ckpt, d):
    coord = _coord(dist, d, num_sources=4, lease_sources=2, deadline=5.0,
                   stale=5.0)
    digest = coord.spec["graph_digest"]
    rng = np.random.default_rng(0)

    def solve_into(worker_id, lease):
        sources = np.arange(lease.start, lease.stop)
        ckpt.BatchCheckpointer(coord.shard_dir(worker_id),
                               graph_key=digest).save(
            0, sources, rng.random((len(sources), 4)).astype(np.float32))

    solve_into("w0", coord.claim("w0", now=100.0))
    coord.reap(now=200.0)
    for _ in range(2):
        lease = coord.claim("w1", now=200.0)
        solve_into("w1", lease)
        coord.commit(lease.lease_id, "w1", now=201.0)
    manifest = dist.build_fleet_manifest(coord)
    assert manifest["leases_committed"] == 2
    assert {e["worker"] for e in manifest["files"].values()} == {"w1"}
    assert len(manifest["orphaned_files"]) == 1
    assert manifest["orphaned_files"][0].startswith("shards/w0/")
    return ("ok", manifest)


def case_manifest_missing_rows(dist, ckpt, d):
    coord = _coord(dist, d, num_sources=4, lease_sources=4)
    lease = coord.claim("w0", now=100.0)
    ckpt.BatchCheckpointer(coord.shard_dir("w0"),
                           graph_key=coord.spec["graph_digest"]).save(
        0, np.arange(2), np.zeros((2, 4), np.float32))
    coord.commit(lease.lease_id, "w0", now=101.0)
    out = _outcome(lambda: dist.build_fleet_manifest(coord))
    assert out[1] == "ValueError" and "missing 2 source row" in out[2]
    return ("raised", out[1], out[2].split(": ", 1)[1])


@pytest.mark.parametrize("case", [case_manifest_orphans,
                                  case_manifest_missing_rows],
                         ids=["orphans_dead_workers_rows", "missing_rows"])
def test_fleet_manifest_matches_reference(case, tmp_path):
    got = {name: case(dist, ckpt, tmp_path / name)
           for name, (dist, ckpt) in PACKAGES.items()}
    assert got["port"] == got["ref"]


# -- solve_range and the worker ----------------------------------------------


def test_solve_range_validates_and_matches_solve():
    g = load_graph(SPEC)
    solver = ParallelJohnsonSolver(SolverConfig(), device="cpu")
    for lo, hi in ((5, 5), (0, g.num_nodes + 1)):
        with pytest.raises(ValueError, match="subrange"):
            solver.solve_range(g, lo, hi)
    res = solver.solve_range(g, 8, 12)
    assert list(res.sources) == [8, 9, 10, 11]
    np.testing.assert_array_equal(
        res.matrix, solver.solve(g, np.arange(8, 12)).matrix)


def test_worker_rejects_wrong_graph_digest(tmp_path):
    coord = distributed.Coordinator.create(
        tmp_path / "coord", graph_spec=SPEC, graph_digest="0" * 16,
        num_sources=8, lease_sources=4)
    with pytest.raises(distributed.CoordinatorError, match="digest mismatch"):
        distributed.run_worker(coord.dir, "w0", device="cpu")
    summary = json.loads(coord.worker_summary_path("w0").read_text())
    assert summary["rc"] == 1 and "digest mismatch" in summary["error"]


def test_worker_without_card_raises_and_claims_nothing(tmp_path,
                                                      monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the worker on a host without a CUDA device")
    coord = distributed.plan_fleet(tmp_path / "coord", SPEC, n_workers=1,
                                   num_sources=8, config=BATCH)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        distributed.run_worker(coord.dir, "w0")
    summary = json.loads(coord.worker_summary_path("w0").read_text())
    assert summary["rc"] == 1 and summary["device"] == "cuda"
    assert {l.state for l in coord.leases()} == {"pending"}
    # --multihost without torch's launcher environment initializes
    # nothing, and the worker carries on to its device check.
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        worker.main([str(coord.dir), "--worker-id", "w1", "--multihost"])
    assert not torch.distributed.is_initialized()
    summary = json.loads(coord.worker_summary_path("w1").read_text())
    assert summary["rc"] == 1 and summary["device"] == "cuda"


def test_worker_command_names_the_device_and_keeps_the_environment(
        monkeypatch, tmp_path):
    cmd = launch._worker_cmd(tmp_path, "w3", device="cpu",
                             self_kill_after_claims=2)
    assert cmd[1:] == ["-m", "paralleljohnson_tpu_torch.distributed.worker",
                       str(tmp_path), "--worker-id", "w3", "--device", "cpu",
                       "--self-kill-after-claims", "2"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    env = launch._worker_env({"PJ_X": "1"})
    assert env["CUDA_VISIBLE_DEVICES"] == "0" and env["PJ_X"] == "1"
    assert "JAX_PLATFORMS" not in env


# -- the same fleet through both packages ------------------------------------


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleets")
    port = distributed.plan_fleet(d / "port", FLEET_SPEC, n_workers=3,
                                  config=BATCH)
    ref = ref_dist.plan_fleet(d / "ref", FLEET_SPEC, n_workers=3,
                              config=BATCH)
    reports = {"port": launch.run_in_process_fleet(port, 3, device="cpu"),
               "ref": ref_launch.run_in_process_fleet(ref, 3)}
    return {"port": port, "ref": ref}, reports


def _lease_key(lease):
    return (lease.lease_id, lease.start, lease.stop, lease.state,
            lease.owner, lease.committed_by, lease.requeues, lease.extensions)


def test_in_process_fleet_lease_tables_and_rows_match_reference(fleets):
    coords, reports = fleets
    for name, rep in reports.items():
        assert rep.ok and rep.requeues == 0, (name, rep.as_dict())
        assert set(rep.worker_rcs.values()) == {0}
    assert [_lease_key(l) for l in coords["port"].leases()] == [
        _lease_key(l) for l in coords["ref"].leases()]
    assert len(coords["port"].leases()) == 12
    g = load_graph(FLEET_SPEC)
    mat = ParallelJohnsonSolver(SolverConfig(**BATCH),
                                device="cpu").solve(g).matrix
    rows = {name: distributed.fleet_rows(c.dir) for name, c in coords.items()}
    assert sorted(rows["port"]) == sorted(rows["ref"]) == list(
        range(g.num_nodes))
    for s in range(g.num_nodes):
        assert np.array_equal(rows["port"][s], rows["ref"][s]), s
        assert np.array_equal(rows["port"][s], mat[s]), s
    summary = json.loads(coords["port"].worker_summary_path("w0").read_text())
    ref_summary = json.loads(
        coords["ref"].worker_summary_path("w0").read_text())
    keys = ("leases_committed", "sources_solved", "claims", "stale_commits",
            "tuning_leases", "rc")
    assert {k: summary[k] for k in keys} == {k: ref_summary[k] for k in keys}
    assert summary["device"] == "cpu" and summary["kernel_build_s"] is None


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_status_and_rows_read_across_packages(reader, fleets):
    """Each package's ``status()`` and ``fleet_rows`` read the directory
    the other package's fleet wrote, and agree with its own reading."""
    coords, _ = fleets
    writer = "ref" if reader == "port" else "port"
    d = coords[writer].dir
    dist = PACKAGES[reader][0]
    now = 2e9
    theirs = dist.Coordinator(d).status(now=now)
    own = coords[writer].status(now=now)
    assert theirs == own and theirs["done"]
    assert theirs["leases"] == {"pending": 0, "leased": 0, "committed": 12}
    rows = dist.fleet_rows(d)
    for s, row in distributed.fleet_rows(d).items():
        assert np.array_equal(rows[s], row)


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_in_process_fleet_bitwise_and_serves(reader, fleets):
    """The reference's serving half of its fleet test: a ``TileStore``
    attached to either package's fleet directory reads through the merged
    shard manifest and serves every row bitwise one solve's, at hit rate
    1.0."""
    if reader == "port":
        from paralleljohnson_tpu_torch.distributed.manifest import (
            ShardedCheckpointer,
        )
        from paralleljohnson_tpu_torch.serve import TileStore
    else:
        from paralleljohnson_tpu.distributed.manifest import (
            ShardedCheckpointer,
        )
        from paralleljohnson_tpu.serve import TileStore

    coords, _ = fleets
    g = load_graph(FLEET_SPEC)
    mat = ParallelJohnsonSolver(SolverConfig(**BATCH),
                                device="cpu").solve(g).matrix
    for writer in ("port", "ref"):
        store = TileStore(coords[writer].dir, g, hot_rows=8, warm_rows=32)
        assert isinstance(store.ckpt, ShardedCheckpointer)
        for s in range(g.num_nodes):
            row, tier = store.get(s)
            assert tier in ("cold", "warm", "hot"), (writer, s)
            assert np.array_equal(np.asarray(row), mat[s]), (writer, s)
        assert store.hit_rate() == 1.0


def test_fleet_resume_in_process(tmp_path):
    coord = distributed.plan_fleet(tmp_path / "coord", SPEC, n_workers=2,
                                   config=BATCH)
    first = distributed.run_worker(coord.dir, "w0", max_leases=2,
                                   device="cpu")
    assert len(first["leases_committed"]) == 2 and not coord.done()
    distributed.run_worker(coord.dir, "w1", device="cpu")
    assert coord.done()
    distributed.build_fleet_manifest(coord)
    assert sorted(distributed.fleet_rows(coord.dir)) == list(range(96))


def test_sharded_checkpointer_growth_overlay(tmp_path):
    coord = distributed.plan_fleet(tmp_path / "coord", SPEC, n_workers=1,
                                   num_sources=16, config=BATCH)
    launch.run_in_process_fleet(coord, 1, device="cpu")
    g = load_graph(SPEC)
    sc = distributed.ShardedCheckpointer(coord.dir, graph_key=g)
    assert sorted(sc.manifest()) == list(range(16))
    ParallelJohnsonSolver(SolverConfig(checkpoint_dir=str(coord.dir)),
                          device="cpu").solve(g, sources=np.arange(16, 24))
    man = sc.manifest()
    assert sorted(man) == list(range(24))
    batch, relpath = man[20]
    row, _ = sc.load(batch, sc.batch_sources(relpath))
    assert row is not None


# -- subprocess workers on the CPU --------------------------------------------


def test_subprocess_fleet_on_cpu(tmp_path):
    """Two worker subprocesses through ``python -m
    paralleljohnson_tpu_torch.distributed.worker --device cpu``: every
    lease committed, rc 0, rows bitwise equal to one solve."""
    coord = distributed.plan_fleet(tmp_path / "coord", SPEC, n_workers=2,
                                   num_sources=48, lease_sources=24,
                                   config=BATCH)
    report = distributed.launch_local_fleet(coord, 2, poll_s=0.1,
                                            timeout_s=120, device="cpu")
    assert report.ok, report.as_dict()
    assert report.worker_rcs == {"w0": 0, "w1": 0}
    g = load_graph(SPEC)
    mat = ParallelJohnsonSolver(SolverConfig(**BATCH), device="cpu").solve(
        g, np.arange(48)).matrix
    rows = distributed.fleet_rows(coord.dir)
    assert sorted(rows) == list(range(48))
    for s, row in rows.items():
        assert np.array_equal(row, mat[s]), s
    for wid in ("w0", "w1"):
        summary = json.loads(coord.worker_summary_path(wid).read_text())
        assert summary["device"] == "cpu" and summary["rc"] == 0


@pytest.mark.slow
def test_subprocess_fleet_kill_requeues_and_completes(tmp_path):
    """The reference's drill: 3 worker subprocesses, one SIGKILLed
    holding a lease; the lease requeues on its stale heartbeat, the
    survivors finish, rows bitwise equal to one solve."""
    coord = distributed.plan_fleet(
        tmp_path / "coord", SPEC, n_workers=3, lease_deadline_s=2.0,
        heartbeat_stale_s=2.0, heartbeat_interval_s=0.2, config=BATCH)
    report = distributed.launch_local_fleet(
        coord, 3, poll_s=0.25, timeout_s=300, self_kill={"w0": 2},
        device="cpu")
    assert report.ok, report.as_dict()
    assert report.requeues >= 1
    assert report.worker_rcs["w0"] == -9
    g = load_graph(SPEC)
    mat = ParallelJohnsonSolver(SolverConfig(**BATCH),
                                device="cpu").solve(g).matrix
    rows = distributed.fleet_rows(coord.dir)
    assert sorted(rows) == list(range(g.num_nodes))
    for s, row in rows.items():
        assert np.array_equal(row, mat[s]), s
