"""PyTorch port at ``precision="f64"`` above the solver, on the CPU: the
mesh's sharded routes, the fleet, incremental repair, serving, the
approximate tier and the command line's f64 verbs, against the JAX
package at f64.

``jax_enable_x64`` is a process-wide switch, so the reference runs once,
in a subprocess with x64 on and the eight host devices of
``tests/conftest.py`` (as ``tests/test_torch_f64.py`` runs it), under a
time limit of its own. It saves its inputs and outputs to an ``.npz``
and its checkpoints, fleet plans and update files to a directory that
the port's side reads. The port is held to them bitwise on integer
weights and to ``rtol=1e-12`` on float weights (the weights are f64
values that no f32 holds; path sums may associate differently, e.g.
through potentials found by another sweep order), with equal flags,
equal ``RepairResult`` counters and valid trees. The port's mesh runs
on eight CPU ranks (``PJ_MESH_DEVICES=cpu*8``).

Where the reference cannot run a layer at f64, the port is held to its
own single-device f64 solve and to scipy instead (ROADMAP Queue 3): the
reference's sharded Gauss-Seidel fan-out raises under x64 and its sharded
tight-edge pass falls back to the argmin sweep at either precision.
Neither package's ``fleet solve`` takes ``--precision``: a fleet runs at
f64 from a plan whose config says so. The card's side is in
``tests/test_torch_cuda.py`` (``-k f64``)."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import cli, distributed, incremental, interop
from paralleljohnson_tpu_torch import serve
from paralleljohnson_tpu_torch.distributed.launch import run_in_process_fleet
from paralleljohnson_tpu_torch.incremental.fleet import (
    run_in_process_repair_fleet,
)
from paralleljohnson_tpu_torch.incremental.updates import load_updates
from paralleljohnson_tpu_torch.solver import approx
from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from paralleljohnson_tpu_torch.utils.checkpoint import (
    BatchCheckpointer,
    graph_digest,
)
from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

from conftest import oracle_apsp

REPO = Path(__file__).resolve().parent.parent
# The reference's side: the JAX import, eight-device sharded solves, two
# fleets, two repairs, two engines, the approximate tier and four CLI
# commands took ~25 s on one core of the CPU container.
REFERENCE_TIMEOUT_S = 120
RTOL = 1e-12

_SCRIPT = r"""
import contextlib
import io
import json
import os
import shutil
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

from paralleljohnson_tpu import ParallelJohnsonSolver, SolverConfig, cli
from paralleljohnson_tpu import distributed, incremental, serve
from paralleljohnson_tpu.distributed.launch import run_in_process_fleet
from paralleljohnson_tpu.incremental.fleet import run_in_process_repair_fleet
from paralleljohnson_tpu.graphs import (
    CSRGraph, grid2d, load_graph, random_dag, rmat, save_dimacs,
)
from paralleljohnson_tpu.incremental.updates import load_updates
from paralleljohnson_tpu.solver import approx
from paralleljohnson_tpu.utils.checkpoint import BatchCheckpointer, graph_digest

out, work = {}, Path(sys.argv[2])
assert len(jax.devices()) == 8


def f64(**kw):
    return SolverConfig(precision="f64", **kw)


def save_graph(tag, g):
    out[f"g_{tag}_indptr"] = g.indptr
    out[f"g_{tag}_indices"] = g.indices
    out[f"g_{tag}_weights"] = g.weights


def variants(tag, g, seed, *, keep=False):
    # Integer weights (the values rounded, signs kept) and float weights
    # that no f32 holds (uniform magnitudes, signs kept); ``keep``: the
    # generator's own values in f64 (a grid's negative arcs stay
    # cycle-free only with them).
    rng = np.random.default_rng(seed)
    w = g.weights.astype(np.float64)
    fw = w if keep else np.sign(w) * rng.uniform(0.5, 10.0, w.shape[0])
    for kind, ww in (("int", np.round(w)), ("float", fw)):
        gg = g.astype(np.float64).with_weights(ww)
        save_graph(f"{tag}_{kind}", gg)
        yield kind, gg


def rows_of(d, g):
    ck = BatchCheckpointer(d, graph_key=graph_digest(g))
    man = ck.manifest()
    rows = {}
    for fn in sorted({f for _b, f in man.values()}):
        srcs = ck.batch_sources(fn)
        got = ck.load(int(man[int(srcs[0])][0]), srcs)
        for i, s in enumerate(srcs):
            rows[int(s)] = got[0][i]
    return np.stack([rows[s] for s in sorted(rows)])


def run_cli(tag, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            rc = cli.main(argv)
        except SystemExit as e:  # argparse refused the command line
            rc = e.code
    out[f"cli_{tag}_rc"] = np.array(rc)
    out[f"cli_{tag}_out"] = np.array(buf.getvalue())


# -- the mesh: each sharded route through solve() -----------------------------
graphs = {
    "rm10": (rmat(10, 8, seed=2), 31, False),
    "rm8": (rmat(8, 8, seed=4), 32, False),
    "dag": (random_dag(60, 0.1, negative_fraction=0.4, seed=21), 33, False),
    "lat": (load_graph("grid:rows=16,cols=16,neg=0.2,seed=1"), 34, True),
}
built = {}
for tag, (g, seed, keep) in graphs.items():
    for kind, gg in variants(tag, g, seed, keep=keep):
        built[f"{tag}_{kind}"] = gg
for case, (gtag, kw, sources, pred) in json.loads(sys.argv[3]).items():
    g = built[gtag]
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    try:
        res = ParallelJohnsonSolver(f64(**kw)).solve(
            g, None if sources is None else np.asarray(sources),
            predecessors=pred)
    except Exception as e:
        out[f"mesh_{case}_error"] = np.array(f"{type(e).__name__}: {e}")
        continue
    out[f"mesh_{case}_dist"] = np.asarray(res.matrix)
    out[f"mesh_{case}_routes"] = np.array(json.dumps(
        res.stats.routes_by_phase))
    out[f"mesh_{case}_iters"] = np.array(json.dumps(
        res.stats.iterations_by_phase))
cyc = CSRGraph.from_edges([0, 1, 2, 3], [1, 2, 3, 1], [1.0, 2.0, -4.0, 1.0],
                          4).astype(np.float64)
try:
    ParallelJohnsonSolver(f64(mesh_shape=(8,), edge_shard=True)).solve(cyc)
except Exception as e:
    out["mesh_cycle_raised"] = np.array(type(e).__name__)

# -- the fleet: float weights (a spec) and integer weights (a .gr file) -------
FLEET = "er:n=96,p=0.041667,seed=13"
gi = load_graph(FLEET)
save_dimacs(gi.with_weights(np.round(gi.weights)), work / "fleet_int.gr")
for tag, spec in (("float", FLEET), ("int", str(work / "fleet_int.gr"))):
    coord = distributed.plan_fleet(
        work / f"fleet_{tag}", spec, n_workers=3,
        config={"source_batch_size": 16, "precision": "f64"})
    rep = run_in_process_fleet(coord, 3)
    rows = distributed.fleet_rows(coord.dir)
    out[f"fleet_{tag}_rows"] = np.stack([rows[s] for s in sorted(rows)])
    out[f"fleet_{tag}_ok"] = np.array([rep.ok, rep.leases_committed,
                                       rep.leases_total])

# -- incremental repair: one update file each --------------------------------
COUNTERS = json.loads(sys.argv[4])
lat = {
    "int": (grid2d(12, 12, seed=2), 4),
    "float": (grid2d(9, 9, seed=1), 3),
}
for kind, (g, parts) in lat.items():
    rng = np.random.default_rng(40)
    w = (np.maximum(1.0, np.rint(g.weights)).astype(np.float64)
         if kind == "int" else rng.uniform(1.0, 10.0, g.weights.shape[0]))
    g = g.astype(np.float64).with_weights(w)
    save_graph(f"rep_{kind}", g)
    e = g.num_real_edges
    picks = rng.choice(e, 3, replace=False)
    ups = [(int(g.src[picks[0]]), int(g.indices[picks[0]]), 0.5),
           (int(g.src[picks[1]]), int(g.indices[picks[1]]),
            float(g.weights[picks[1]]) + 7.0 / 3.0),
           (0, g.num_nodes - 1, 1.0 / 3.0 if kind == "float" else 2.0)]
    path = work / f"rep_{kind}.jsonl"
    path.write_text("".join(json.dumps({"u": u, "v": v, "w": ww}) + "\n"
                            for u, v, ww in ups))
    d = work / f"rep_{kind}"
    cfg = f64(checkpoint_dir=str(d), source_batch_size=32)
    ParallelJohnsonSolver(cfg).solve(g)
    st = incremental.IncrementalState.build(g, num_parts=parts, seed=0,
                                            config=cfg)
    st.save(BatchCheckpointer(d, graph_key=graph_digest(g)).dir)
    shutil.copytree(d, work / f"rep_{kind}_fleet")
    res = incremental.repair_checkpoint(d, g, load_updates(path), config=cfg)
    got = res.as_dict()
    out[f"rep_{kind}_counters"] = np.array(json.dumps(
        {k: got.get(k) for k in COUNTERS}))
    new_g, _ = g.apply_edge_updates(load_updates(path))
    out[f"rep_{kind}_rows"] = rows_of(d, new_g)
    d = work / f"rep_{kind}_fleet"
    res = run_in_process_repair_fleet(
        d, g, load_updates(path), coordinator_dir=work / f"rep_{kind}_coord",
        workers=2, lease_rows=16,
        config=f64(checkpoint_dir=str(d), source_batch_size=32))
    got = res.as_dict()
    out[f"repfleet_{kind}_counters"] = np.array(json.dumps(
        {k: got.get(k) for k in COUNTERS}))
    out[f"repfleet_{kind}_rows"] = rows_of(d, new_g)

# -- serving: a store from an f64 solve's checkpoint ---------------------------
REQS = json.loads(sys.argv[5])
for kind, gg in variants("er", load_graph("er:n=64,p=0.08,seed=3"), 35):
    d = work / f"serve_{kind}"
    ParallelJohnsonSolver(f64(checkpoint_dir=str(d), source_batch_size=16)
                          ).solve(gg, np.arange(0, 64, 2))
    engine = serve.QueryEngine(gg, serve.TileStore(d, gg, hot_rows=16),
                               config=f64(), stats_interval_s=0)
    # The second batch finds the first one's rows hot.
    answers = [engine.query_batch([dict(r) for r in REQS])
               for _ in range(2)]
    s = engine.stats
    out[f"serve_{kind}_answers"] = np.array(json.dumps(answers))
    out[f"serve_{kind}_counters"] = np.array(json.dumps([
        s.queries_total, s.exact_answers, s.batches_scheduled,
        s.solved_sources, dict(s.hits_by_tier), engine.store.misses]))
    engine.close()

# -- the approximate tier under an f64 config --------------------------------
apx = grid2d(10, 8, seed=23).astype(np.float64)
apx = apx.with_weights(np.random.default_rng(36).uniform(
    1.0, 10.0, apx.weights.shape[0]))
save_graph("apx_grid", apx)
for tag, g in (("grid", apx), ("rmat", built["rm8_int"])):
    src = np.arange(0, g.num_nodes, 5)[:16]
    res = approx.approx_apsp(g, src, config=f64(), epsilon=0.5)
    out[f"apx_{tag}_dist"] = res.dist
    out[f"apx_{tag}_err"] = res.max_error
    out[f"apx_{tag}_converged"] = np.array(res.converged)
    out[f"apx_{tag}_exact"] = np.asarray(
        ParallelJohnsonSolver(f64()).solve(g, src).dist)
    exact, dec = approx.solve_with_budget(g, src, config=f64(),
                                          error_budget=0.0)
    out[f"apx_{tag}_budget0"] = np.asarray(exact.dist)
    out[f"apx_{tag}_budget0_plan"] = np.array(dec.chosen.plan.name)

# -- the command line at --precision f64 -------------------------------------
lat9 = grid2d(9, 9, seed=1)
lat9 = lat9.with_weights(np.rint(lat9.weights).astype(np.float32))
save_dimacs(lat9, work / "cli.gr")
gr = str(work / "cli.gr")
upd = work / "cli_upd.jsonl"
upd.write_text(json.dumps({"u": int(lat9.src[5]), "v": int(lat9.indices[5]),
                           "w": 1.0}) + "\n")
ck = str(work / "cli_ck")
run_cli("solve", ["solve", gr, "--precision", "f64", "--checkpoint-dir", ck,
                  "--batch-size", "32"])
run_cli("update", ["update", gr, "--updates", str(upd), "--checkpoint-dir",
                   ck, "--precision", "f64", "--partition-parts", "3",
                   "--json"])
out["cli_update_rows"] = rows_of(ck, load_graph(gr).apply_edge_updates(
    load_updates(upd))[0])
(work / "cli_q.jsonl").write_text(
    '{"id": 0, "source": 1, "dst": 40}\n'
    '{"id": 1, "source": 7, "dst": [3, 60, 80]}\n'
    '{"id": 2, "source": 22}\n')
run_cli("serve", ["serve", gr, "--precision", "f64", "--store-dir",
                  str(work / "cli_store"), "--queries",
                  str(work / "cli_q.jsonl")])
run_cli("fleet", ["fleet", "solve", gr, "--precision", "f64", "--in-process",
                  "--coordinator-dir", str(work / "cli_fleet")])

np.savez(sys.argv[1], **out)
print("ok", jax.config.jax_enable_x64)
"""

# Each mesh case: (graph, config, sources, predecessors). The 2-D and
# 1-D tree cases run the port's sharded tight-edge pass; the
# reference's falls back to the argmin sweep (``pred-sweep``).
MESH = {
    **{f"s1d_{k}": (f"rm10_{k}", dict(mesh_shape=[8]),
                    list(range(0, 1024, 23)), False) for k in ("int", "float")},
    **{f"s2d_{k}": (f"rm8_{k}", dict(mesh_shape=[4, 2]), list(range(22)),
                    False) for k in ("int", "float")},
    **{f"edge_{k}": (f"dag_{k}", dict(mesh_shape=[8], edge_shard=True), None,
                     False) for k in ("int", "float")},
    **{f"dia_{k}": (f"lat_{k}", dict(mesh_shape=[8], dia=True),
                    list(range(16)), False) for k in ("int", "float")},
    **{f"gs_{k}": (f"lat_{k}", dict(mesh_shape=[8], gauss_seidel=True),
                   list(range(16)), False) for k in ("int", "float")},
    "s2dp_int": ("lat_int", dict(mesh_shape=[4, 2]),
                 list(range(0, 256, 8)), True),
    "s1dp_float": ("lat_float", dict(mesh_shape=[8]),
                   list(range(0, 256, 9)), True),
}
COUNTERS = ("old_digest", "new_digest", "trivial", "parts_total",
            "dirty_parts_closed", "core_recomputed", "boundary_changed",
            "full_row_parts", "col_parts", "affected_rows",
            "rows_recomputed", "rows_patched", "rows_copied",
            "batches_rewritten", "expand_macs", "dirty_set", "plan")


def _requests():
    """Pairs, several targets and full rows, from sources in the store
    (even: the solve's checkpoint) and not (odd: scheduled misses)."""
    rng = np.random.default_rng(9)
    reqs = []
    for i in range(18):
        s = int(rng.integers(0, 64))
        if i % 3 == 0:
            reqs.append({"id": i, "source": s, "dst": int(rng.integers(64))})
        elif i % 3 == 1:
            reqs.append({"id": i, "source": s,
                         "dst": [int(t) for t in rng.integers(0, 64, 4)]})
        else:
            reqs.append({"id": i, "source": s})
    return reqs


REQS = _requests()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU, and an oversubscribed torch thread pool slows small solves by
    orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _eight_cpu_ranks(monkeypatch):
    monkeypatch.setenv("PJ_MESH_DEVICES", "cpu*8")
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 30.0)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's f64 arrays (the subprocess above) and the
    directory of its checkpoints, plans and update files."""
    work = tmp_path_factory.mktemp("f64_layers")
    path = work / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(path), str(work),
         json.dumps(MESH), json.dumps(COUNTERS), json.dumps(REQS)],
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=REFERENCE_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["ok", "True"]
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, work


def _graph(arrays, tag):
    return interop.graph_from_arrays(arrays[f"g_{tag}_indptr"],
                                     arrays[f"g_{tag}_indices"],
                                     arrays[f"g_{tag}_weights"])


def _f64(**kw):
    return pjt.SolverConfig(precision="f64", **kw)


def _solver(**kw):
    return pjt.ParallelJohnsonSolver(_f64(**kw), device="cpu")


def _rows_equal(got, want, integer):
    """Bitwise on integer weights; else the same +inf pattern and
    ``rtol=1e-12``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == np.float64
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, rtol=RTOL)


def _values_equal(got, want, integer):
    """Two JSON documents (answers, reports) alike: the same structure,
    numbers bitwise on integer weights and to ``rtol=1e-12`` else."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _values_equal(got[k], want[k], integer)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _values_equal(a, b, integer)
    elif isinstance(want, float) and not isinstance(got, bool):
        if integer or not np.isfinite(want):
            assert got == want
        else:
            assert got == pytest.approx(want, rel=RTOL, abs=0.0)
    else:
        assert got == want


# -- the mesh -----------------------------------------------------------------


@pytest.mark.parametrize("case", [c for c in MESH if not c.startswith("gs")])
def test_mesh_routes_f64_equal_reference(ref, case):
    """Each sharded route at f64 on eight CPU ranks (``sharded-1d``,
    ``sharded-2d``, ``edge-sharded`` phase 1, ``dia-sharded``, and the
    sharded tight-edge pass on the 1-D and 2-D meshes): the reference's
    route tags (the tree cases aside) and rows; trees valid."""
    arrays, _ = ref
    gtag, kw, sources, pred = MESH[case]
    g = _graph(arrays, gtag)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
    res = _solver(**kw).solve(
        g, None if sources is None else np.asarray(sources),
        predecessors=pred)
    routes = res.stats.routes_by_phase
    want = json.loads(str(arrays[f"mesh_{case}_routes"]))
    if pred:
        assert want["fanout"] == "pred-sweep"
        assert routes["fanout"] == ("sharded-2d+pred" if case == "s2dp_int"
                                    else "sharded-1d+pred")
        validate_pred_tree(g, res.matrix, to_numpy(res.predecessors),
                           res.sources)
    else:
        assert routes == want
        assert res.stats.iterations_by_phase == json.loads(
            str(arrays[f"mesh_{case}_iters"]))
    _rows_equal(res.matrix, arrays[f"mesh_{case}_dist"], "int" in case)


@pytest.mark.parametrize("kind", ["int", "float"])
def test_gs_sharded_f64_equals_one_rank_and_scipy(ref, kind):
    """The reference's sharded Gauss-Seidel fan-out raises under x64 (an
    int32 / int64 index mix in its ``dynamic_slice``; ROADMAP Queue 3).
    The port's ``gs-sharded`` rows at f64 are bitwise its one-rank ``gs``
    rows and scipy's to ``rtol=1e-12``."""
    arrays, _ = ref
    assert "dynamic_slice" in str(arrays[f"mesh_gs_{kind}_error"])
    gtag, kw, sources, _ = MESH[f"gs_{kind}"]
    g = _graph(arrays, gtag)
    sharded = _solver(mesh_shape=(8,), gauss_seidel=True).solve(g, sources)
    one = _solver(mesh_shape=(1,), gauss_seidel=True).solve(g, sources)
    assert sharded.stats.routes_by_phase["fanout"] == "gs-sharded"
    assert one.stats.routes_by_phase["fanout"] == "gs"
    np.testing.assert_array_equal(sharded.matrix, one.matrix)
    _rows_equal(sharded.matrix, oracle_apsp(g)[sources], False)


def test_mesh_negative_cycle_f64_raises_in_both(ref):
    arrays, _ = ref
    assert str(arrays["mesh_cycle_raised"]) == "NegativeCycleError"
    cyc = pjt.CSRGraph.from_edges([0, 1, 2, 3], [1, 2, 3, 1],
                                  [1.0, 2.0, -4.0, 1.0], 4).astype(np.float64)
    with pytest.raises(pjt.NegativeCycleError):
        _solver(mesh_shape=(8,), edge_shard=True).solve(cyc)


def test_rank_hub_flags_divide_the_budget_among_ranks_sharing_a_card(
        monkeypatch):
    """The sharded routes' one rule for the f64 hub flags
    (``parallel.mesh.rank_hub_flags``): a rank on a card builds them
    with ``HUB_L2_BYTES`` divided by the ranks that share its card (all
    of a multi-process mesh's ranks have a card each); a CPU rank builds
    none. No card is touched: the flags builder is replaced."""
    from paralleljohnson_tpu_torch.ops.fanout_sweep import HUB_L2_BYTES
    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod

    budgets = []
    monkeypatch.setattr(mesh_mod, "hub_flags",
                        lambda *a, budget, **kw: budgets.append(budget))

    def flags(mesh, rank):
        comm = types.SimpleNamespace(mesh=mesh, rank=rank,
                                     device=mesh.devices[rank])
        return mesh_mod.rank_hub_flags(comm, None, 8, 128, torch.float64)

    cards = [torch.device("cuda", 0)] * 3 + [torch.device("cuda", 1)]
    mesh = mesh_mod.Mesh(cards, ("sources",), (4,))
    for rank in range(4):
        flags(mesh, rank)
    assert budgets == [HUB_L2_BYTES // 3] * 3 + [HUB_L2_BYTES]
    world = mesh_mod.Mesh(cards[:1] * 4, ("sources",), (4,), world=2)
    flags(world, 2)
    assert budgets[-1] == HUB_L2_BYTES
    cpu = mesh_mod.Mesh([torch.device("cpu")] * 8, ("sources",), (8,))
    assert flags(cpu, 0) is None and len(budgets) == 5


# -- the fleet ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int", "float"])
def test_fleet_f64_rows_equal_reference(ref, tmp_path, kind):
    """The plan's config carries ``precision="f64"`` to every worker: the
    shards are written and merged at f64, ``fleet_rows`` returns float64
    rows, the reference's (bitwise on the integer ``.gr`` file) and
    bitwise the port's single-device f64 solve."""
    arrays, work = ref
    spec = ("er:n=96,p=0.041667,seed=13" if kind == "float"
            else str(work / "fleet_int.gr"))
    coord = distributed.plan_fleet(
        tmp_path / "coord", spec, n_workers=3,
        config={"source_batch_size": 16, "precision": "f64"})
    assert coord.spec["config"]["precision"] == "f64"
    report = run_in_process_fleet(coord, 3, device="cpu")
    assert [report.ok, report.leases_committed, report.leases_total] == \
        arrays[f"fleet_{kind}_ok"].tolist()
    rows = distributed.fleet_rows(coord.dir)
    got = np.stack([rows[s] for s in sorted(rows)])
    _rows_equal(got, arrays[f"fleet_{kind}_rows"], kind == "int")
    one = _solver(source_batch_size=16).solve(pjt.load_graph(spec)).matrix
    np.testing.assert_array_equal(got, one)


# -- incremental repair -------------------------------------------------------


def _checkpoint_rows(d, g):
    ck = BatchCheckpointer(d, graph_key=graph_digest(g))
    man = ck.manifest()
    rows = {}
    for fn in sorted({f for _b, f in man.values()}):
        srcs = ck.batch_sources(fn)
        got = ck.load(int(man[int(srcs[0])][0]), srcs)
        for i, s in enumerate(srcs):
            rows[int(s)] = got[0][i]
    return np.stack([rows[s] for s in sorted(rows)])


@pytest.mark.parametrize("kind,parts", [("int", 4), ("float", 3)])
def test_repair_f64_equals_reference(ref, tmp_path, kind, parts):
    """An f64 checkpoint repaired from one update file, by the serial
    engine and by a two-worker repair fleet on a copy: the reference's
    ``RepairResult`` counters for each, its repaired rows (bitwise on the
    integer 12x12 lattice), and the rows of a fresh f64 solve of the
    updated graph; the closures and ``_np_minplus`` run at f64."""
    arrays, work = ref
    g = _graph(arrays, f"rep_{kind}")
    updates = load_updates(work / f"rep_{kind}.jsonl")
    d = tmp_path / "ck"
    cfg = _f64(checkpoint_dir=str(d), source_batch_size=32)
    pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(g)
    st = incremental.IncrementalState.build(g, num_parts=parts, seed=0,
                                            config=cfg, device="cpu")
    assert st.core_closed.dtype == np.float64
    st.save(BatchCheckpointer(d, graph_key=graph_digest(g)).dir)
    fleet_dir = tmp_path / "fleet"
    shutil.copytree(d, fleet_dir)
    res = incremental.repair_checkpoint(d, g, updates, config=cfg,
                                        device="cpu")
    got = res.as_dict()
    want = json.loads(str(arrays[f"rep_{kind}_counters"]))
    assert {k: got.get(k) for k in COUNTERS} == json.loads(json.dumps(
        {k: want[k] for k in COUNTERS}))
    assert got["rows_recomputed"] > 0
    new_g, _ = g.apply_edge_updates(updates)
    rows = _checkpoint_rows(d, new_g)
    _rows_equal(rows, arrays[f"rep_{kind}_rows"], kind == "int")
    fresh = _solver(source_batch_size=32).solve(new_g).matrix
    _rows_equal(rows, fresh, kind == "int")
    res = run_in_process_repair_fleet(
        fleet_dir, g, updates, coordinator_dir=tmp_path / "coord",
        workers=2, lease_rows=16,
        config=_f64(checkpoint_dir=str(fleet_dir), source_batch_size=32),
        device="cpu")
    got = res.as_dict()
    want = json.loads(str(arrays[f"repfleet_{kind}_counters"]))
    assert {k: got.get(k) for k in COUNTERS} == json.loads(json.dumps(
        {k: want[k] for k in COUNTERS}))
    fleet_rows = _checkpoint_rows(fleet_dir, new_g)
    np.testing.assert_array_equal(fleet_rows, rows)
    _rows_equal(fleet_rows, arrays[f"repfleet_{kind}_rows"], kind == "int")


# -- serving ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int", "float"])
def test_serve_f64_hits_misses_and_device_lookup(ref, tmp_path, kind):
    """A store built from an f64 solve's checkpoint (even sources): cold
    hits, scheduled misses (odd sources, solved at f64) and full rows
    answer in f64, then the same requests hit the hot tier: the
    reference's answers and counters; the host-forced and the
    device-forced lookups (CPU tensors) answer bitwise alike."""
    arrays, _ = ref
    g = _graph(arrays, f"er_{kind}")
    want = json.loads(str(arrays[f"serve_{kind}_answers"]))
    outs = []
    for mode in ("off", "on"):
        d = tmp_path / mode
        _solver(checkpoint_dir=str(d), source_batch_size=16).solve(
            g, np.arange(0, 64, 2))
        engine = serve.QueryEngine(g, serve.TileStore(d, g, hot_rows=16),
                                   config=_f64(), stats_interval_s=0,
                                   device="cpu", device_lookup=mode)
        try:
            got = [engine.query_batch([dict(r) for r in REQS])
                   for _ in range(2)]
            s = engine.stats
            assert (s.device_lookups > 0) == (mode == "on")
            counters = [s.queries_total, s.exact_answers,
                        s.batches_scheduled, s.solved_sources,
                        dict(s.hits_by_tier), engine.store.misses]
        finally:
            engine.close()
        assert counters == json.loads(str(arrays[f"serve_{kind}_counters"]))
        _values_equal(got, want, kind == "int")
        outs.append(json.dumps(got, sort_keys=True))
    assert outs[0] == outs[1]
    exact = oracle_apsp(g)
    for r in want[0]:
        if "dst" in r and isinstance(r["dst"], int):
            assert r["distance"] == pytest.approx(exact[r["source"], r["dst"]],
                                                  rel=RTOL)


# -- the approximate tier -----------------------------------------------------


@pytest.mark.parametrize("tag", ["grid", "rmat"])
def test_approx_f64_config_equals_reference(ref, tag):
    """``approx_apsp`` under an f64 config: the hopset stays f32 (as in
    the reference), estimates and certificates bitwise the reference's,
    and every certified interval holds the reference's exact f64 row; an
    error budget of 0 takes the exact plan at f64."""
    arrays, _ = ref
    g = _graph(arrays, "apx_grid" if tag == "grid" else "rm8_int")
    src = np.arange(0, g.num_nodes, 5)[:16]
    res = approx.approx_apsp(g, src, config=_f64(), epsilon=0.5,
                             device="cpu")
    np.testing.assert_array_equal(res.dist, arrays[f"apx_{tag}_dist"])
    np.testing.assert_array_equal(res.max_error, arrays[f"apx_{tag}_err"])
    assert res.converged == bool(arrays[f"apx_{tag}_converged"])
    exact = arrays[f"apx_{tag}_exact"]
    certified = np.isfinite(res.max_error)
    assert certified.any()
    # A certified +inf estimate is a proven unreachable pair.
    pinned = certified & ~(np.isinf(res.dist) & np.isinf(exact))
    assert bool(np.all(np.abs(res.dist[pinned] - exact[pinned])
                       <= res.max_error[pinned]))
    got, dec = approx.solve_with_budget(g, src, config=_f64(),
                                        error_budget=0.0, device="cpu")
    assert dec.chosen.plan.name == str(arrays[f"apx_{tag}_budget0_plan"])
    _rows_equal(to_numpy(got.dist), arrays[f"apx_{tag}_budget0"],
                tag == "rmat")


# -- the command line ---------------------------------------------------------


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--device", "cpu"])
    return rc, buf.getvalue()


def test_cli_update_precision_f64(ref, tmp_path):
    """``update --precision f64``: the repair of an f64 checkpoint, the
    reference's report and repaired rows (integer weights: bitwise)."""
    arrays, work = ref
    gr = str(work / "cli.gr")
    ck = str(tmp_path / "ck")
    assert _cli(["solve", gr, "--precision", "f64", "--checkpoint-dir", ck,
                 "--batch-size", "32"])[0] == int(arrays["cli_solve_rc"]) == 0
    rc, out = _cli(["update", gr, "--updates", str(work / "cli_upd.jsonl"),
                    "--checkpoint-dir", ck, "--precision", "f64",
                    "--partition-parts", "3", "--json"])
    assert rc == int(arrays["cli_update_rc"]) == 0
    got, want = json.loads(out), json.loads(str(arrays["cli_update_out"]))
    assert set(got) == set(want)
    for key in ("dirty_parts_closed", "parts_total", "batches_rewritten",
                "new_digest", "rows_recomputed", "rows_patched",
                "rows_copied"):
        assert got[key] == want[key], key
    new_g, _ = pjt.load_graph(gr).apply_edge_updates(
        load_updates(work / "cli_upd.jsonl"))
    rows = _checkpoint_rows(ck, new_g)
    _rows_equal(rows, arrays["cli_update_rows"], True)


def test_cli_serve_precision_f64(ref, tmp_path):
    """``serve --precision f64``: every answer the reference's (integer
    weights: bitwise), rows solved at f64."""
    arrays, work = ref
    rc, out = _cli(["serve", str(work / "cli.gr"), "--precision", "f64",
                    "--store-dir", str(tmp_path / "store"), "--queries",
                    str(work / "cli_q.jsonl")])
    assert rc == int(arrays["cli_serve_rc"]) == 0
    got = [json.loads(ln) for ln in out.strip().splitlines()]
    want = [json.loads(ln) for ln in
            str(arrays["cli_serve_out"]).strip().splitlines()]
    _values_equal(got, want, True)
    assert list((tmp_path / "store").glob("graph_*/rows_*.npz"))


def test_cli_fleet_precision_f64(ref, tmp_path, capsys):
    """``fleet solve --precision f64``: refused by both packages' parsers
    (exit 2), as the reference's fleet verb takes no ``--precision``; a
    fleet runs at f64 from a plan whose config says so
    (``test_fleet_f64_rows_equal_reference``)."""
    arrays, work = ref
    with pytest.raises(SystemExit) as e:
        _cli(["fleet", "solve", str(work / "cli.gr"), "--precision", "f64",
              "--in-process", "--coordinator-dir", str(tmp_path / "fleet")])
    assert e.value.code == int(arrays["cli_fleet_rc"]) == 2
    assert "--precision" in capsys.readouterr().err
    assert not (tmp_path / "fleet").exists()
