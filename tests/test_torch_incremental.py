"""PyTorch port: incremental repair (``incremental/*``) against the JAX
package's, on the reference's fixtures (``tests/test_incremental.py``).

The same solved checkpoint of an integer-weight 9x9 lattice is repaired
by both packages, each in its own copy, for every repair case of the
reference: the ``RepairResult`` counters (dirty parts, core recomputed,
affected / recomputed / patched / copied rows, the plan decision) are
equal, and the repaired rows are bitwise equal across the two packages
and to a fresh ``solve()`` of the updated graph. Partition labels,
dirty sets, update files, the status marker and the persisted
``IncrementalState`` are equal or readable across packages; a negative
cycle raises in both."""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu.config import SolverConfig as RefConfig
from paralleljohnson_tpu.graphs import grid2d as ref_grid2d
from paralleljohnson_tpu import incremental as ref_inc
from paralleljohnson_tpu.incremental import fleet as ref_fleet
from paralleljohnson_tpu.incremental import state as ref_state
from paralleljohnson_tpu.observe.store import CostModel as RefCostModel
from paralleljohnson_tpu.solver import partitioned as ref_partitioned
from paralleljohnson_tpu.solver.johnson import (
    NegativeCycleError as RefNegativeCycleError,
)

from paralleljohnson_tpu_torch import (
    NegativeCycleError,
    ParallelJohnsonSolver,
    SolverConfig,
    interop,
)
from paralleljohnson_tpu_torch import incremental
from paralleljohnson_tpu_torch.distributed import Coordinator
from paralleljohnson_tpu_torch.incremental import fleet, state as port_state
from paralleljohnson_tpu_torch.observe.store import CostModel, ProfileStore
from paralleljohnson_tpu_torch.solver import partitioned
from paralleljohnson_tpu_torch.utils.checkpoint import (
    BatchCheckpointer,
    graph_digest,
)

BATCH = 32
COUNTERS = ("old_digest", "new_digest", "trivial", "parts_total",
            "dirty_parts_closed", "core_recomputed", "boundary_changed",
            "full_row_parts", "col_parts", "affected_rows",
            "rows_recomputed", "rows_patched", "rows_copied",
            "batches_rewritten", "expand_macs", "dirty_set", "plan")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU, and an oversubscribed torch thread pool slows small solves by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def intify(g):
    return g.with_weights(np.maximum(1.0, np.rint(g.weights))
                          .astype(np.float32))


def _port(g):
    return interop.graph_from_arrays(g.indptr, g.indices, g.weights)


def solve_rows(g) -> np.ndarray:
    return ParallelJohnsonSolver(SolverConfig(source_batch_size=BATCH),
                                 device="cpu").solve(g).matrix


def checkpoint_rows(d, g) -> dict:
    ck = BatchCheckpointer(d, graph_key=graph_digest(g))
    man = ck.manifest()
    out = {}
    for fn in sorted({f for _b, f in man.values()}):
        srcs = ck.batch_sources(fn)
        loaded = ck.load(int(man[int(srcs[0])][0]), srcs)
        assert loaded is not None, f"unreadable repaired batch {fn}"
        for i, s in enumerate(srcs):
            out[int(s)] = loaded[0][i]
    return out


def _solve_into(d, g, *, num_parts, package="port"):
    """Checkpoint ``g`` into ``d`` and attach the incremental state,
    through the port or the JAX package."""
    if package == "port":
        cfg = SolverConfig(checkpoint_dir=str(d), source_batch_size=BATCH)
        ParallelJohnsonSolver(cfg, device="cpu").solve(g)
        st = incremental.IncrementalState.build(g, num_parts=num_parts,
                                                seed=0, device="cpu")
    else:
        from paralleljohnson_tpu.solver import ParallelJohnsonSolver as Ref

        Ref(RefConfig(checkpoint_dir=str(d), source_batch_size=BATCH)
            ).solve(g)
        st = ref_inc.IncrementalState.build(g, num_parts=num_parts, seed=0)
    st.save(BatchCheckpointer(d, graph_key=graph_digest(g)).dir)
    return st


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """One checkpoint of the reference's lattice, solved and attached by
    the port; each repair case copies it once per package."""
    ref_g = intify(ref_grid2d(9, 9, seed=1))
    g = _port(ref_g)
    d = tmp_path_factory.mktemp("incr") / "ckpt"
    st = _solve_into(d, g, num_parts=3)
    return g, ref_g, d, st


def _copies(base, tmp_path):
    g, ref_g, d, _ = base
    out = {}
    for name in ("port", "ref"):
        shutil.copytree(d, tmp_path / name)
        out[name] = tmp_path / name
    return out


def _cfg(package, d, **kw):
    cls = SolverConfig if package == "port" else RefConfig
    return cls(checkpoint_dir=str(d), source_batch_size=BATCH, **kw)


def _repair(package, d, g, updates, **kw):
    if package == "port":
        return incremental.repair_checkpoint(d, g, updates,
                                             config=_cfg("port", d),
                                             device="cpu", **kw)
    return ref_inc.repair_checkpoint(d, g, updates, config=_cfg("ref", d),
                                     **kw)


def _counters(result):
    d = result.as_dict()
    return {k: d.get(k) for k in COUNTERS}


def _repair_both(graphs, dirs, updates):
    """Repair each package's copy with the same updates; returns the
    port's result after checking counters and rows across packages and
    against a fresh solve of the updated graph."""
    g, ref_g = graphs
    port = _repair("port", dirs["port"], g, updates)
    ref = _repair("ref", dirs["ref"], ref_g, updates)
    assert _counters(port) == _counters(ref)
    new_g, _ = g.apply_edge_updates(updates)
    fresh = solve_rows(new_g)
    rows = {name: checkpoint_rows(dirs[name], new_g) for name in dirs}
    assert sorted(rows["port"]) == sorted(rows["ref"]) == list(
        range(g.num_nodes))
    for s in range(g.num_nodes):
        np.testing.assert_array_equal(rows["port"][s], rows["ref"][s],
                                      err_msg=f"row {s}: port != reference")
        np.testing.assert_array_equal(rows["port"][s], fresh[s],
                                      err_msg=f"row {s}: != fresh solve")
    return port, rows["port"]


# -- the state, partitions, dirty sets ---------------------------------------


@pytest.mark.parametrize("spec,k,seed", [
    ("grid:rows=9,cols=9,seed=1", 3, 0),
    ("grid:rows=16,cols=16,seed=2", 4, 5),
    ("er:n=120,p=0.05,seed=3", 6, 1),
    ("rmat:scale=8,ef=4,seed=2", 8, 3),
])
def test_partition_labels_equal_reference(spec, k, seed):
    from paralleljohnson_tpu.graphs import load_graph as ref_load

    ref_g = ref_load(spec)
    got = partitioned.partition_by_pivots(_port(ref_g), k, seed=seed)
    want = ref_partitioned.partition_by_pivots(ref_g, k, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert partitioned.auto_num_parts(ref_g.num_nodes) == \
        ref_partitioned.auto_num_parts(ref_g.num_nodes)


def test_state_equals_reference_and_loads_across_packages(base, tmp_path):
    g, ref_g, _, st = base
    ref = ref_inc.IncrementalState.build(ref_g, num_parts=3, seed=0)
    assert st.graph_digest == ref.graph_digest == graph_digest(g)
    assert st.part_digests == ref.part_digests
    assert st.core_digest == ref.core_digest
    for a, b in ((st.labels, ref.labels), (st.part_ids, ref.part_ids),
                 (st.boundary, ref.boundary), (st.core_closed,
                                                ref.core_closed)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(st.locals_closed, ref.locals_closed, strict=True):
        np.testing.assert_array_equal(a, b)
    # Each package loads what the other saved; a wrong digest is invisible.
    for writer, reader, saved in (
            (st, ref_inc.IncrementalState, "port"),
            (ref, incremental.IncrementalState, "ref")):
        writer.save(tmp_path / saved)
        loaded = reader.load(tmp_path / saved, expect_digest=st.graph_digest)
        assert loaded is not None and loaded.core_digest == st.core_digest
        assert loaded.part_digests == st.part_digests
        for a, b in zip(loaded.locals_closed, st.locals_closed, strict=True):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(loaded.core_closed, st.core_closed)
        assert reader.load(tmp_path / saved, expect_digest="0" * 16) is None


def test_closure_padding_matches_reference():
    assert port_state._CLOSURE_V_BUCKET == ref_state._CLOSURE_V_BUCKET == 128
    cfg = port_state.closure_config(SolverConfig(source_batch_size=7))
    assert cfg.source_batch_size == 128 and cfg.checkpoint_dir is None
    assert cfg.partitioned is False and cfg.profile_store is None


def test_diagnose_matches_reference(base):
    g, _, _, st = base
    labels = st.labels
    e = g.num_real_edges
    within = np.flatnonzero(labels[g.src[:e]] == labels[g.indices[:e]])
    cross = np.flatnonzero(labels[g.src[:e]] != labels[g.indices[:e]])
    rng = np.random.default_rng(4)
    batches = [
        [(int(g.src[i]), int(g.indices[i]), 1.0, 2.0) for i in idx]
        for idx in ([within[0], cross[0]], [within[0]], [cross[1]],
                    rng.choice(e, 9, replace=False))
    ]
    ref = ref_inc.IncrementalState.load(
        BatchCheckpointer(base[2], graph_key=graph_digest(g)).dir,
        expect_digest=graph_digest(g))
    for changed in batches:
        got = incremental.diagnose(st, changed).as_dict()
        assert got == ref_inc.diagnose(ref, changed).as_dict()
    first = incremental.diagnose(st, batches[0])
    assert first.dirty_parts == [int(labels[g.src[within[0]]])]
    assert first.cross_changed == 1 and first.core_dirty


# -- edge updates, update files, the status marker ---------------------------


def test_apply_edge_updates_matches_reference(base):
    g, ref_g, _, _ = base
    u, v = int(g.src[10]), int(g.indices[10])
    u2, v2 = int(g.src[20]), int(g.indices[20])
    for updates in ([(u, v, float(g.weights[10]) + 5.0), (0, 80, 7.0),
                     (u2, v2, None)],
                    [(u, v, float(g.weights[10])), (0, 80, None)],
                    [(u, v, 99.0), (u, v, None)]):
        g2, rep = g.apply_edge_updates(updates)
        r2, ref_rep = ref_g.apply_edge_updates(updates)
        assert (rep.added, rep.removed, rep.reweighted, rep.unchanged,
                rep.num_changed, rep.old_digest, rep.new_digest) == (
            ref_rep.added, ref_rep.removed, ref_rep.reweighted,
            ref_rep.unchanged, ref_rep.num_changed, ref_rep.old_digest,
            ref_rep.new_digest)
        np.testing.assert_array_equal(np.asarray(rep.changed_edges),
                                      np.asarray(ref_rep.changed_edges))
        for a, b in ((g2.indptr, r2.indptr), (g2.indices, r2.indices),
                     (g2.weights, r2.weights)):
            np.testing.assert_array_equal(a, b)
    for bad, match in (([(0, g.num_nodes, 1.0)], "out of vertex range"),
                       ([(0, 1, float("nan"))], "invalid weight"),
                       ([(0, 1)], "triple")):
        with pytest.raises(ValueError, match=match):
            g.apply_edge_updates(bad)


def test_load_updates_matches_reference(tmp_path):
    p = tmp_path / "u.jsonl"
    p.write_text("# comment\n" '{"u": 1, "v": 2, "w": 3.5}\n'
                 '{"u": 3, "v": 4, "w": null}\n' '{"u": 9, "v": 1, "w": "x"}\n'
                 "5 6 inf\n" "7 8 2\n" "2 3 -\n", encoding="utf-8")
    got = incremental.load_updates(p)
    assert got == ref_inc.load_updates(p)
    assert got[:4] == [(1, 2, 3.5), (3, 4, None), (9, 1, None), (5, 6, None)]
    for name, text, match in (("bad.txt", "1 2 3\nnot an update\n",
                               r"bad\.txt:2"),
                              ("empty.txt", "# nothing\n", "no updates")):
        f = tmp_path / name
        f.write_text(text, encoding="utf-8")
        for load in (incremental.load_updates, ref_inc.load_updates):
            with pytest.raises(ValueError, match=match):
                load(f)


@pytest.mark.parametrize("affected", [[3, 1, 2], "all", []])
def test_repair_status_reads_across_packages(affected, tmp_path):
    for writer, reader in ((incremental, ref_inc), (ref_inc, incremental)):
        d = tmp_path / writer.__name__
        writer.write_repair_status(d, status="repairing", new_digest="ab",
                                   affected=affected, total_sources=10,
                                   dirty_parts=1, parts_total=3)
        got = reader.read_repair_status(d)
        want = writer.read_repair_status(d)
        assert got == want and got["status"] == "repairing"
        assert reader.stale_sources(got) == writer.stale_sources(want)
    with pytest.raises(ValueError, match="bad repair status"):
        incremental.write_repair_status(tmp_path, status="odd",
                                        new_digest="x", affected=[],
                                        total_sources=1)


# -- the repair cases of the reference ---------------------------------------


def upd_heavy_insert(g, st):
    """A non-improving insert inside one part: every row copied."""
    labels = st.labels
    existing = {(int(a), int(b)) for a, b in zip(g.src, g.indices)}
    u, v = next((u, v) for u in range(0, 12) for v in range(12, 30)
                if labels[u] == labels[v] and (u, v) not in existing)
    return [(u, v, 900.0)]


def upd_decrease(g, st):
    return [(int(g.src[5]), int(g.indices[5]), 1.0 / 4.0)]


def upd_k_edge_mixed(g, st):
    labels = st.labels
    e = g.num_real_edges
    j = int(np.flatnonzero(labels[g.src[:e]] != labels[g.indices[:e]])[0])
    existing = {(int(a), int(b)) for a, b in zip(g.src, g.indices)}
    u_new, v_new = next((u, v) for u in range(g.num_nodes)
                        for v in range(g.num_nodes)
                        if u != v and (u, v) not in existing)
    return [(int(g.src[2]), int(g.indices[2]), 1.0),
            (int(g.src[j]), int(g.indices[j]), None),
            (u_new, v_new, 2.0)]


def upd_disconnecting_parts(g, st):
    labels = st.labels
    e = g.num_real_edges
    cross = np.flatnonzero(labels[g.src[:e]] != labels[g.indices[:e]])
    return [(int(g.src[i]), int(g.indices[i]), None) for i in cross]


def upd_core_only(g, st):
    """One cross-part edge made cheaper: the core alone is dirty."""
    labels = st.labels
    e = g.num_real_edges
    j = int(np.flatnonzero(labels[g.src[:e]] != labels[g.indices[:e]])[2])
    return [(int(g.src[j]), int(g.indices[j]), 1.0)]


REPAIR_CASES = {name[len("upd_"):]: fn for name, fn in globals().items()
                if name.startswith("upd_")}


@pytest.mark.parametrize("case", sorted(REPAIR_CASES))
def test_repair_case_matches_reference(case, base, tmp_path):
    g, ref_g, _, st = base
    updates = REPAIR_CASES[case](g, st)
    out, rows = _repair_both((g, ref_g), _copies(base, tmp_path), updates)
    if case == "heavy_insert":
        assert out.dirty_parts_closed == 1 and not out.core_recomputed
        assert out.affected_rows == 0 and out.rows_copied == g.num_nodes
    elif case == "decrease":
        assert 0 < out.dirty_parts_closed < out.parts_total
        assert out.affected_rows > 0
    elif case == "k_edge_mixed":
        assert out.batches_rewritten > 0
    elif case == "disconnecting_parts":
        assert out.boundary_changed
        s = int(np.flatnonzero(st.labels == st.labels[0])[0])
        other = int(np.flatnonzero(st.labels != st.labels[0])[0])
        assert np.isinf(rows[s][other])
    elif case == "core_only":
        assert out.dirty_parts_closed == 0 and out.core_recomputed
    for name in ("port", "ref"):
        status = incremental.read_repair_status(BatchCheckpointer(
            tmp_path / name, graph_key=out.old_digest).dir)
        assert status["status"] == "done"
        assert status["affected"] == ([] if case == "heavy_insert"
                                      else status["affected"])


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_random_repair_matches_reference(seed, tmp_path):
    """The reference's deterministic twin: fixed seeds, random single-
    and k-edge batches on a 5x5 lattice; each package solves, attaches
    its own state and repairs its own checkpoint."""
    rng = np.random.default_rng(seed)
    ref_g = intify(ref_grid2d(5, 5, seed=seed))
    g = _port(ref_g)
    dirs = {name: tmp_path / name for name in ("port", "ref")}
    for name, graph in (("port", g), ("ref", ref_g)):
        _solve_into(dirs[name], graph, num_parts=2, package=name)
    e = g.num_real_edges
    updates = []
    for _ in range(int(rng.integers(1, 5))):
        kind = rng.integers(0, 4)
        if kind == 3:
            u = int(rng.integers(0, g.num_nodes))
            v = int(rng.integers(0, g.num_nodes - 1))
            updates.append((u, v + (v >= u), float(rng.integers(1, 9))))
        else:
            i = int(rng.integers(0, e))
            u, v = int(g.src[i]), int(g.indices[i])
            updates.append((u, v, None) if kind == 2
                           else (u, v, float(rng.integers(1, 9))))
    out, _ = _repair_both((g, ref_g), dirs, updates)
    assert out.dirty_parts_closed <= len(out.diag.dirty_parts)


def test_repair_negative_cycle_create_then_destroy(base, tmp_path):
    g, ref_g, _, _ = base
    dirs = _copies(base, tmp_path)
    creating = [(0, 1, 1.0), (1, 0, -5.0)]
    with pytest.raises(NegativeCycleError):
        _repair("port", dirs["port"], g, creating)
    with pytest.raises(RefNegativeCycleError):
        _repair("ref", dirs["ref"], ref_g, creating)
    digest = graph_digest(g)
    for d in dirs.values():
        old = BatchCheckpointer(d, graph_key=digest).dir
        assert incremental.read_repair_status(old)["status"] == "failed"
        assert len(checkpoint_rows(d, g)) == g.num_nodes
    _repair_both((g, ref_g), dirs, creating + [(1, 0, 6.0)])


def test_repair_chained_updates(base, tmp_path):
    g, ref_g, _, _ = base
    dirs = _copies(base, tmp_path)
    upd1 = [(int(g.src[7]), int(g.indices[7]), 1.0)]
    _repair_both((g, ref_g), dirs, upd1)
    g1, _ = g.apply_edge_updates(upd1)
    r1, _ = ref_g.apply_edge_updates(upd1)
    d1 = graph_digest(g1)
    for d in dirs.values():
        assert incremental.IncrementalState.load(
            BatchCheckpointer(d, graph_key=d1).dir, expect_digest=d1)
    upd2 = [(int(g1.src[11]), int(g1.indices[11]), 1.0)]
    _repair_both((g1, r1), dirs, upd2)


def test_repair_trivial_noop(base, tmp_path):
    g, ref_g, _, _ = base
    dirs = _copies(base, tmp_path)
    upd = [(int(g.src[0]), int(g.indices[0]), float(g.weights[0]))]
    port = _repair("port", dirs["port"], g, upd)
    ref = _repair("ref", dirs["ref"], ref_g, upd)
    assert port.trivial and port.new_digest == port.old_digest
    assert _counters(port) == _counters(ref)
    assert incremental.read_repair_status(
        BatchCheckpointer(dirs["port"], graph_key=graph_digest(g)).dir) is None


def test_repair_profile_record_reads_in_both_packages(base, tmp_path):
    g, ref_g, _, _ = base
    dirs = _copies(base, tmp_path)
    upd = [(int(g.src[3]), int(g.indices[3]), 1.0)]
    stores = {name: tmp_path / f"profiles-{name}" for name in dirs}
    incremental.repair_checkpoint(
        dirs["port"], g, upd, device="cpu",
        config=_cfg("port", dirs["port"], profile_store=str(stores["port"])))
    ref_inc.repair_checkpoint(
        dirs["ref"], ref_g, upd,
        config=_cfg("ref", dirs["ref"], profile_store=str(stores["ref"])))
    recs = {name: [r for r in ProfileStore(d).records()
                   if r.get("kind") == "repair"] for name, d in stores.items()}
    assert len(recs["port"]) == len(recs["ref"]) == 1
    port, ref = recs["port"][0], recs["ref"][0]
    assert port["route"] == ref["route"] == "incremental-repair"
    assert port["platform"] == "cpu" and port["batch"] == ref["batch"]
    timing = ("closures_s", "expand_s", "io_s", "wall_s")
    assert ({k: v for k, v in port["repair"].items() if k not in timing}
            == {k: v for k, v in ref["repair"].items() if k not in timing})
    for fit in (CostModel.fit, RefCostModel.fit):
        model = fit(ProfileStore(stores["port"]).records())
        assert any(r == "incremental-repair" for r, _p in model.entries)


def test_repair_fleet_matches_reference(base, tmp_path):
    g, ref_g, _, _ = base
    dirs = _copies(base, tmp_path)
    updates = [(int(g.src[4]), int(g.indices[4]), 1.0)]
    port = fleet.run_in_process_repair_fleet(
        dirs["port"], g, updates, coordinator_dir=tmp_path / "pc",
        workers=2, lease_rows=16, config=_cfg("port", dirs["port"]),
        device="cpu")
    ref = ref_fleet.run_in_process_repair_fleet(
        dirs["ref"], ref_g, updates, coordinator_dir=tmp_path / "rc",
        workers=2, lease_rows=16, config=_cfg("ref", dirs["ref"]))
    assert _counters(port) == _counters(ref)
    new_g, _ = g.apply_edge_updates(updates)
    fresh = solve_rows(new_g)
    rows = {n: checkpoint_rows(d, new_g) for n, d in dirs.items()}
    for s in range(g.num_nodes):
        np.testing.assert_array_equal(rows["port"][s], fresh[s])
        np.testing.assert_array_equal(rows["port"][s], rows["ref"][s])
    status = Coordinator(tmp_path / "pc").status()
    assert status["leases"]["committed"] == status["leases_total"] > 1
    assert len(status["committed_by"]) >= 2
    assert status["graph_spec"] == f"repair:{port.new_digest}"
    ref_status = Coordinator(tmp_path / "rc").status()
    assert status["committed_by"] == ref_status["committed_by"]


# -- the serve side: stale answers from the pre-update store ------------------


def _stale_serving(package, d, g, probe):
    """An engine over the OLD graph's store in ``d``: the answers to
    ``probe`` (source -> 3), the stale set, the stale counter and its
    prom line."""
    if package == "port":
        from paralleljohnson_tpu_torch.serve import QueryEngine, TileStore

        store = TileStore(d, g)
        engine = QueryEngine(g, store, config=SolverConfig(), device="cpu",
                             stats_interval_s=0)
    else:
        from paralleljohnson_tpu.serve import QueryEngine, TileStore

        store = TileStore(d, g)
        engine = QueryEngine(g, store, config=RefConfig(),
                             stats_interval_s=0)
    answers = [engine.query(s, 3) for s in probe]
    text = engine.write_metrics(d / f"{package}.prom").read_text()
    summary = engine.serve_summary()["engine"]["stale_answers"]
    engine.close()
    return answers, store.stale_info(), engine.stats.stale_answers, \
        summary, text


def test_repair_decrease_bitwise_and_stale_serving(base, tmp_path):
    """The reference's serve-side check of a distance-changing decrease:
    after the repair (rows bitwise a fresh solve, fewer dirty parts than
    parts), each package's engine over the OLD graph's store flags
    exactly the affected sources ``stale`` (counted, exported), and the
    two packages answer alike; the NEW digest's store serves fresh,
    unflagged rows."""
    from paralleljohnson_tpu_torch.serve import QueryEngine, TileStore

    g, ref_g, _, st = base
    dirs = _copies(base, tmp_path)
    updates = upd_decrease(g, st)
    out, _ = _repair_both((g, ref_g), dirs, updates)
    assert 0 < out.dirty_parts_closed < out.parts_total
    assert out.affected_rows > 0
    probe = [0, 1, g.num_nodes // 2, g.num_nodes - 1]
    port = _stale_serving("port", dirs["port"], g, probe)
    ref = _stale_serving("ref", dirs["ref"], ref_g, probe)
    answers, stale_set, n_counted, n_summary, text = port
    assert stale_set is not None and stale_set == ref[1]
    for s, resp in zip(probe, answers):
        expected = stale_set == "all" or s in stale_set
        assert resp.get("stale", False) == expected, (s, resp)
    n_stale = sum(1 for s in probe if stale_set == "all" or s in stale_set)
    assert n_counted == n_summary == ref[2] == n_stale > 0
    assert f"pjtpu_stale_answers_total {float(n_stale)}" in text
    assert answers == ref[0]
    new_g, _ = g.apply_edge_updates(updates)
    engine = QueryEngine(new_g, TileStore(dirs["port"], new_g),
                         config=SolverConfig(), device="cpu",
                         stats_interval_s=0)
    r = engine.query(probe[0], 3)
    engine.close()
    assert "stale" not in r and r["exact"] is True
    assert r["distance"] == float(solve_rows(new_g)[probe[0], 3])


def test_tilestore_manual_stale_marks():
    from paralleljohnson_tpu.serve import TileStore as RefTileStore

    from paralleljohnson_tpu_torch.serve import TileStore

    ref_g = intify(ref_grid2d(3, 3, seed=0))
    for store in (TileStore(None, _port(ref_g)), RefTileStore(None, ref_g)):
        assert store.stale_info() is None
        assert not store.is_stale(0)
        store.mark_stale([1, 2])
        assert store.is_stale(1) and store.is_stale(2)
        assert not store.is_stale(0)
        store.mark_stale("all")
        assert store.is_stale(0)
        store.clear_stale()
        assert store.stale_info() is None
        with pytest.raises(ValueError):
            store.mark_stale("some")
