"""PyTorch port: the command line (``cli.py``, ``__main__.py``,
``utils/platform.py``) against the JAX package's, on the CPU.

Each test runs one reference CLI case through both
``paralleljohnson_tpu.cli.main`` (the backend the reference test uses)
and ``paralleljohnson_tpu_torch.cli.main`` with ``--device cpu``, on the
same graph spec, sources and flags: the same exit code, the same
``error:`` / ``negative`` text on stderr, the same JSON key set (the
port's ``info`` adds ``kernels`` and ``cuda_available``, its stats
``plans_by_phase``, its ``--log-stats`` line ``kernel_launches``; ``backend``,
platform, devices and the auto route tag may differ), and ``--output``
rows within rtol 1e-6 (the graphs' weights are not integers).

Port-only cases: a solve without ``--device cpu`` on a host without a
card exits 1 naming ``--device cpu``; ``--mesh-shape 8`` runs on eight
CPU ranks (``PJ_MESH_DEVICES``);
``info`` runs as a subprocess with ``jax`` and ``paralleljohnson_tpu``
blocked from import; ``compilation_cache_dir`` moves the kernels' build
directory until a library has loaded. Serving, ``top`` and the router
are in ``tests/test_torch_cli_serve.py``."""

import json
import os
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paralleljohnson_tpu import cli as ref_cli
from paralleljohnson_tpu.graphs import save_dimacs

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch import cli
from paralleljohnson_tpu_torch.incremental import IncrementalState
from paralleljohnson_tpu_torch.ops import _cuda
from paralleljohnson_tpu_torch.utils import platform
from paralleljohnson_tpu_torch.utils.checkpoint import (
    BatchCheckpointer,
    graph_digest,
)
from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

REPO = Path(__file__).resolve().parent.parent
# Verbs whose parser takes --device (fleet's solve/resume too).
DEVICE_VERBS = {"solve", "sssp", "batch", "bench", "serve", "update", "tune",
                "fleet"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs several pytest
    workers on the CPU, and torch's thread pool oversubscribed by them
    slows the small ops of these solves by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_argv(argv: list[str]) -> list[str]:
    """The reference argv for the port: ``--backend jax`` becomes the
    default torch backend, and every verb that holds tensors runs with
    ``--device cpu``."""
    out = list(argv)
    if "--backend" in out:
        i = out.index("--backend")
        if out[i + 1] == "jax":
            del out[i:i + 2]
    if out[0] in DEVICE_VERBS and not (out[0] == "fleet"
                                       and out[1] == "status"):
        out += ["--device", "cpu"]
    return out


def both(capsys, argv, port=None):
    """Run ``argv`` through the reference CLI, then ``port`` (default
    ``port_argv(argv)``) through the port's. Returns ((rc, out, err) of
    the reference, the same of the port)."""
    rc_ref = ref_cli.main(list(argv))
    ref = capsys.readouterr()
    rc = cli.main(port if port is not None else port_argv(argv))
    got = capsys.readouterr()
    return (rc_ref, ref.out, ref.err), (rc, got.out, got.err)


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


# The port's SolverStats also carries each phase's dispatch decision.
STATS_PORT_ONLY = {"plans_by_phase"}


def same_keys(ref: dict, got: dict, *, port_only=()) -> None:
    assert set(got) - set(port_only) - STATS_PORT_ONLY == set(ref)


def close_rows(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- tests/test_cli.py --------------------------------------------------------


def test_info(capsys):
    (rc_ref, ref, _), (rc, out, _) = both(capsys, ["info"])
    assert rc_ref == rc == 0
    ref, out = json.loads(ref), json.loads(out)
    assert "jax" in ref["backends"] and "torch" in out["backends"]
    assert "numpy" in out["backends"] and "cpp" in out["backends"]
    assert out["loaders"] == ref["loaders"] and "dimacs" in out["loaders"]
    same_keys(ref, out, port_only={"kernels", "cuda_available"})
    for block in ("resilience", "observability", "serving", "incremental",
                  "pipeline", "cost_observatory", "convergence_observatory",
                  "dirty_window", "planner"):
        assert set(out[block]) == set(ref[block]), block
    assert out["cuda_available"] is False
    assert out["default_backend_platform"] == "cpu"
    assert out["devices"] == [{"device": "cpu"}]
    k = out["kernels"]
    assert set(k["libraries"]) == {"fanout_sweep", "minplus", "tight_pred",
                                   "fw_kleene"}
    for name, lib in k["libraries"].items():
        assert lib["source"] == f"paralleljohnson_tpu_torch/csrc/{name}.cu"
        assert Path(lib["library"]).parent == Path(k["build_dir"])


def test_info_graph_route_diagnosis(capsys):
    argv = ["info", "grid:rows=9,cols=9,seed=1", "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    ref, gi = last_json(ref)["graph"], last_json(out)["graph"]
    assert set(gi) == set(ref)
    assert set(gi["routes"]) == set(ref["routes"]) == {
        "dense", "fw", "dia", "bucket", "gauss_seidel", "dirty_window",
        "frontier", "edge_shard", "pred", "partitioned",
    }
    # One device: the edge-sharded route is declined (the reference's
    # test harness gives JAX eight CPU devices).
    assert gi["routes"]["edge_shard"] is False
    assert {k: v for k, v in gi["routes"].items() if k != "edge_shard"} \
        == {k: v for k, v in ref["routes"].items() if k != "edge_shard"}
    assert gi["nodes"] == 81 and gi["dia_qualifies"]
    assert gi["dia_offsets"] == ref["dia_offsets"] == [-9, -1, 1, 9]
    assert gi["routes"]["dirty_window"] is False
    assert "no profile store" in gi["dw_decision"]["reason"]
    assert gi["routes"]["fw"] is False and gi["routes"]["partitioned"] is False
    assert gi["routes"]["pred"] == "extract"


def test_solve_json(capsys):
    argv = ["solve", "er:n=40,p=0.1,seed=1", "--backend", "numpy", "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    ref, out = json.loads(ref), json.loads(out)
    same_keys(ref, out)
    assert out["shape"] == ref["shape"] == [40, 40]
    assert out["edges_relaxed"] > 0
    assert out["finite_fraction"] == ref["finite_fraction"]


def test_solve_output_npz(tmp_path, capsys):
    ref_f, out_f = str(tmp_path / "r.npz"), str(tmp_path / "p.npz")
    argv = ["solve", "er:n=20,p=0.2,seed=2", "--backend", "numpy",
            "--output"]
    (rc_ref, _, _), (rc, _, _) = both(capsys, argv + [ref_f],
                                      port_argv(argv + [out_f]))
    assert rc_ref == rc == 0
    with np.load(ref_f) as r, np.load(out_f) as p:
        assert set(p) == set(r)
        assert p["dist"].shape == (20, 20)
        close_rows(p["dist"], r["dist"])
        np.testing.assert_array_equal(p["sources"], r["sources"])


def test_solve_sources_subset(tmp_path, capsys):
    ref_f, out_f = str(tmp_path / "r.npz"), str(tmp_path / "p.npz")
    argv = ["solve", "er:n=30,p=0.1,seed=3", "--sources", "0,5,9", "--json",
            "--output"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv + [ref_f],
                                          port_argv(argv + [out_f]))
    assert rc_ref == rc == 0
    assert json.loads(out)["shape"] == json.loads(ref)["shape"] == [3, 30]
    with np.load(ref_f) as r, np.load(out_f) as p:
        close_rows(p["dist"], r["dist"])


def test_sssp(capsys):
    argv = ["sssp", "dag:n=30,p=0.1,neg=0.4,seed=4", "--source", "0",
            "--backend", "numpy", "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    ref, out = json.loads(ref), json.loads(out)
    same_keys(ref, out)
    assert out["shape"] == ref["shape"] == [1, 30]


def test_batch(capsys):
    argv = ["batch", "4", "16", "0.2", "--backend", "numpy", "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    ref, out = json.loads(ref), json.loads(out)
    same_keys(ref, out)
    assert out["graphs"] == ref["graphs"] == 4
    assert out["matrix_shape"] == ref["matrix_shape"]


def test_batch_torch_route(capsys):
    """The default backend's batch route on both sides: one fan-out over
    the batch's disjoint union."""
    argv = ["batch", "4", "16", "0.2", "--backend", "jax", "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    ref, out = json.loads(ref), json.loads(out)
    same_keys(ref, out)
    assert out["routes_by_phase"]["batch_apsp"] == "batch-vmapped"


def test_negative_cycle_exit_code(tmp_path, capsys):
    gr = tmp_path / "cycle.gr"
    gr.write_text("p sp 3 3\na 1 2 1\na 2 3 -5\na 3 1 1\n")
    for backend in ("numpy", "jax"):
        argv = ["solve", str(gr), "--backend", backend]
        (rc_ref, _, ref_err), (rc, _, err) = both(capsys, argv)
        assert rc_ref == rc == 2
        assert "negative" in ref_err and "negative" in err


def test_bad_graph_spec_exit_code(capsys):
    argv = ["solve", "bogus.xyz", "--backend", "numpy"]
    (rc_ref, _, ref_err), (rc, _, err) = both(capsys, argv)
    assert rc_ref == rc == 1
    assert "error:" in ref_err and "error:" in err


@pytest.mark.slow  # as the reference's: a profiler trace's IO
def test_cli_profile_and_log_stats(tmp_path, capsys):
    argv = ["solve", "er:n=24,p=0.2,seed=1", "--backend", "jax", "--profile",
            str(tmp_path / "ref"), "--log-stats", "--json"]
    port = port_argv(argv)
    port[port.index("--profile") + 1] = str(tmp_path / "port")
    (rc_ref, ref, ref_err), (rc, out, err) = both(capsys, argv, port)
    assert rc_ref == rc == 0
    assert last_json(out)["edges_relaxed"] > 0
    ref_line, line = last_json(ref_err), last_json(err)
    assert line["event"] == ref_line["event"] == "pjtpu.solve"
    same_keys(ref_line, line, port_only={"kernel_launches"})
    # CPU tensors never launch a kernel.
    assert set(line["kernel_launches"].values()) == {0}
    assert (tmp_path / "port" / "trace.json").exists()


def test_cli_use_pallas_flag(capsys):
    argv = ["solve", "er:n=24,p=0.2,seed=4", "--backend", "jax",
            "--use-pallas", "true", "--json", "--validate"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    assert last_json(out)["finite_fraction"] == \
        last_json(ref)["finite_fraction"] > 0


def test_cli_predecessors_output(tmp_path, capsys):
    ref_f, out_f = str(tmp_path / "r.npz"), str(tmp_path / "p.npz")
    argv = ["solve", "er:n=24,p=0.2,seed=2", "--backend", "jax",
            "--predecessors", "--json", "--output"]
    (rc_ref, _, _), (rc, out, _) = both(capsys, argv + [ref_f],
                                        port_argv(argv + [out_f]))
    assert rc_ref == rc == 0
    g = pjt.load_graph("er:n=24,p=0.2,seed=2")
    with np.load(ref_f) as r, np.load(out_f) as p:
        assert set(p) == set(r)
        assert p["predecessors"].shape == p["dist"].shape
        close_rows(p["dist"], r["dist"])
        validate_pred_tree(g, p["dist"], p["predecessors"], p["sources"])


def test_cli_batch_predecessors_rejected(capsys):
    argv = ["batch", "4", "16", "0.2", "--backend", "numpy", "--predecessors"]
    (rc_ref, _, ref_err), (rc, _, err) = both(capsys, argv)
    assert rc_ref == rc == 1
    assert "--predecessors" in ref_err and "--predecessors" in err


def test_cli_mesh_shape(capsys, monkeypatch, tmp_path):
    """The reference spreads a solve over its harness's eight devices; the
    port over eight CPU ranks (``PJ_MESH_DEVICES``), with the same rows.
    A mesh larger than the ranks exits 1 in both, and ``--edge-shard
    true`` runs phase 1 edge-sharded on the eight ranks."""
    monkeypatch.setenv("PJ_MESH_DEVICES", "cpu*8")
    monkeypatch.setattr(
        "paralleljohnson_tpu_torch.parallel.mesh.DEFAULT_TIMEOUT_S", 60.0)
    out_ref, out = tmp_path / "ref.npz", tmp_path / "port.npz"
    argv = ["solve", "er:n=48,p=0.1,seed=4", "--mesh-shape", "8",
            "--dense-threshold", "0", "--json"]
    rc_ref = ref_cli.main(argv + ["--output", str(out_ref)])
    ref = capsys.readouterr().out
    rc = cli.main(port_argv(argv + ["--output", str(out)]))
    got = capsys.readouterr().out
    assert rc_ref == rc == 0
    assert last_json(ref)["shape"] == last_json(got)["shape"] == [48, 48]
    assert last_json(got)["routes_by_phase"]["fanout"] == "sharded-1d"
    with np.load(out_ref) as a, np.load(out) as b:
        close_rows(b["dist"], a["dist"])
    argv = ["solve", "er:n=24,p=0.1,seed=4", "--mesh-shape", "999"]
    (rc_ref, _, _), (rc, _, err) = both(capsys, argv)
    assert rc_ref == rc == 1 and "error:" in err
    argv = ["solve", "dag:n=40,p=0.1,neg=0.4,seed=2", "--edge-shard", "true",
            "--json"]
    assert cli.main(port_argv(argv)) == 0
    routes = last_json(capsys.readouterr().out)["routes_by_phase"]
    assert routes == {"bellman_ford": "edge-sharded", "fanout": "sharded-1d"}


def test_cli_frontier_and_layout_flags(capsys):
    argv = ["sssp", "er:n=64,p=0.08,seed=2", "--source", "0", "--frontier",
            "true", "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    assert last_json(out)["routes_by_phase"] == \
        last_json(ref)["routes_by_phase"]
    argv = ["solve", "er:n=32,p=0.1,seed=2", "--fanout-layout",
            "source_major", "--mesh-shape", "1", "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    same_keys(last_json(ref), last_json(out))


def test_solve_reduce_streaming(capsys):
    argv = ["solve", "er:n=80,p=0.08,seed=2", "--num-sources", "24",
            "--reduce", "checksum", "--batch-size", "10", "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    ref, out = last_json(ref), last_json(out)
    same_keys(ref, out)
    assert out["reducer"] == "checksum"
    assert out["batches"] == ref["batches"] == 3
    assert all(isinstance(v, float) for v in out["values"])
    np.testing.assert_allclose(out["values"], ref["values"], rtol=1e-6)


def test_solve_reduce_rejects_predecessors(capsys):
    argv = ["solve", "er:n=40,p=0.1,seed=1", "--reduce", "checksum",
            "--predecessors"]
    (rc_ref, _, ref_err), (rc, _, err) = both(capsys, argv)
    assert rc_ref == rc == 1
    assert "--predecessors" in ref_err and "--predecessors" in err


def test_solve_reduce_rejects_output_and_validate(tmp_path, capsys):
    argv = ["solve", "er:n=40,p=0.1,seed=1", "--reduce", "checksum",
            "--output", str(tmp_path / "x.npz"), "--validate"]
    (rc_ref, _, ref_err), (rc, _, err) = both(capsys, argv)
    assert rc_ref == rc == 1
    for e in (ref_err, err):
        assert "--output" in e and "--validate" in e


def test_cli_bucket_and_delta_flags(capsys):
    argv = ["sssp", "grid:rows=11,cols=11,neg=0.2,seed=3", "--source", "0",
            "--bucket", "true", "--delta", "12.5", "--json", "--log-stats"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    assert last_json(out)["routes_by_phase"]["bellman_ford"] == \
        last_json(ref)["routes_by_phase"]["bellman_ford"] == "bucket"
    argv = ["sssp", "grid:rows=8,cols=8", "--source", "0", "--bucket",
            "true", "--dia", "true"]
    (rc_ref, _, _), (rc, _, err) = both(capsys, argv)
    assert rc_ref == rc == 1 and "mutually-exclusive" in err


# -- the other reference files' CLI cases -------------------------------------


def test_cli_bench_subcommand(tmp_path, capsys):
    argv = ["bench", "er1k_apsp", "--backend", "numpy", "--preset", "smoke",
            "--update-baseline"]
    (rc_ref, ref, _), (rc, out, _) = both(
        capsys, argv + [str(tmp_path / "R.md")],
        port_argv(argv + [str(tmp_path / "P.md")]))
    assert rc_ref == rc == 0
    ref, out = last_json(ref), last_json(out)
    assert out["config"] == ref["config"] == "er1k_apsp"
    same_keys(ref, out)
    assert out["detail"]["platform"] == "cpu"
    assert "er1k_apsp" in (tmp_path / "P.md").read_text()


def test_cli_bench_unknown_config_exit_code(capsys):
    assert cli.main(["bench", "nope", "--device", "cpu"]) == 1
    assert "unknown config" in capsys.readouterr().err


SPEC = "er:n=96,p=0.04,seed=7"


def test_cli_fleet_solve_and_status(tmp_path, capsys):
    rows = {}
    for name, main in (("ref", ref_cli.main), ("port", cli.main)):
        coord = str(tmp_path / name)
        argv = ["fleet", "solve", SPEC, "--coordinator-dir", coord,
                "--workers", "2", "--num-sources", "24", "--lease-sources",
                "8", "--batch-size", "8", "--in-process"]
        assert main(argv if name == "ref" else port_argv(argv)) == 0
        report = last_json(capsys.readouterr().out)
        assert report["leases_committed"] == report["leases_total"] == 3
        assert report["manifest_path"].endswith("fleet_manifest.json")
        assert main(["fleet", "status", "--coordinator-dir", coord]) == 0
        status = json.loads(capsys.readouterr().out)
        assert status["done"] is True and status["leases"]["committed"] == 3
        rc = main(["fleet", "status", "--coordinator-dir",
                   str(tmp_path / "no")])
        assert rc == 1 and "no fleet plan" in capsys.readouterr().err
        rows[name] = (set(report), set(status))
    assert rows["port"] == rows["ref"]


@pytest.mark.slow  # as the reference's: worker subprocesses
def test_cli_fleet_solve_subprocess(tmp_path, capsys):
    argv = ["fleet", "solve", SPEC, "--workers", "2", "--lease-sources", "24",
            "--batch-size", "16", "--coordinator-dir"]
    (rc_ref, ref, _), (rc, out, _) = both(
        capsys, argv + [str(tmp_path / "r")],
        port_argv(argv + [str(tmp_path / "p")]))
    assert rc_ref == rc == 0
    for report in (last_json(ref), last_json(out)):
        assert report["leases_committed"] == report["leases_total"]
        assert set(report["worker_rcs"].values()) == {0}


def _intify(g):
    return g.with_weights(np.round(g.weights).astype(np.float32))


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """One solved checkpoint of the integer-weight 9x9 grid with its
    incremental state attached (the reference test's), built once."""
    g = _intify(pjt.load_graph("grid:rows=9,cols=9,seed=1"))
    d = tmp_path_factory.mktemp("incr") / "ckpt"
    cfg = pjt.SolverConfig(checkpoint_dir=str(d), source_batch_size=32)
    pjt.ParallelJohnsonSolver(cfg, device="cpu").solve(g)
    ck = BatchCheckpointer(d, graph_key=graph_digest(g))
    IncrementalState.build(g, num_parts=3, seed=0, device="cpu").save(ck.dir)
    gr = d.parent / "g.gr"
    save_dimacs(_ref_graph(g), gr)
    return g, d, gr


def _ref_graph(g):
    from paralleljohnson_tpu.graphs import CSRGraph as RefGraph

    return RefGraph(indptr=np.asarray(g.indptr), indices=np.asarray(g.indices),
                    weights=np.asarray(g.weights))


def test_cli_update_exit_codes(base, tmp_path, capsys):
    g, d0, gr = base
    upd = tmp_path / "u.jsonl"
    upd.write_text(json.dumps({"u": int(g.src[5]), "v": int(g.indices[5]),
                               "w": 1.0}) + "\n", encoding="utf-8")
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"u": 0, "v": 1, "w": 1}\n{"u": 1, "v": 0, "w": -9}\n',
                   encoding="utf-8")
    mal = tmp_path / "mal.txt"
    mal.write_text("not an update\n", encoding="utf-8")
    dirs = {}
    for name in ("ref", "port"):
        dirs[name] = tmp_path / name
        shutil.copytree(d0, dirs[name])

    def run(args):
        return both(capsys, ["update", str(gr), "--updates", *args[:1],
                             "--checkpoint-dir", str(dirs["ref"]), *args[1:]],
                    port_argv(["update", str(gr), "--updates", *args[:1],
                               "--checkpoint-dir", str(dirs["port"]),
                               *args[1:]]))

    (rc_ref, ref, _), (rc, out, _) = run([str(upd), "--dry-run"])
    assert rc_ref == rc == 0
    ref, out = json.loads(ref), json.loads(out)
    same_keys(ref, out)
    assert out["dry_run"] and out["dirty_set"] == ref["dirty_set"]
    assert out["dirty_set"]["dirty_parts"]
    (rc_ref, ref, _), (rc, out, _) = run([str(upd), "--json"])
    assert rc_ref == rc == 0
    ref, out = json.loads(ref), json.loads(out)
    same_keys(ref, out)
    for key in ("dirty_parts_closed", "parts_total", "batches_rewritten",
                "new_digest"):
        assert out[key] == ref[key], key
    assert out["dirty_parts_closed"] < out["parts_total"]
    (rc_ref, _, _), (rc, _, _) = run([str(bad)])
    assert rc_ref == rc == 2
    (rc_ref, _, ref_err), (rc, _, err) = run([str(mal)])
    assert rc_ref == rc == 1
    assert "mal.txt:1" in ref_err and "mal.txt:1" in err
    argv = ["update", str(gr), "--updates", str(upd)]
    (rc_ref, _, _), (rc, _, err) = both(capsys, argv)
    assert rc_ref == rc == 1 and "--checkpoint-dir" in err


def test_cli_info_incremental_block(base, tmp_path, capsys):
    g, d0, gr = base
    upd = tmp_path / "u.jsonl"
    upd.write_text('{"u": 0, "v": 1, "w": 2}\n', encoding="utf-8")
    d = tmp_path / "ckpt"
    shutil.copytree(d0, d)
    argv = ["info", str(gr), "--updates", str(upd), "--checkpoint-dir",
            str(d), "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    ref, block = json.loads(ref)["incremental"], json.loads(out)["incremental"]
    assert set(block) == set(ref)
    assert sorted(block["exit_codes"]) == ["0", "1", "2", "3"]
    assert "update" in block["command"]
    diag = block["diagnosis"]
    assert diag["checkpoint_batches"] == ref["diagnosis"]["checkpoint_batches"] > 0
    assert diag["report"]["num_changed"] == 1
    assert diag["dirty_set"] == ref["diagnosis"]["dirty_set"]


def test_cli_info_prints_priced_route_table(tmp_path, capsys, monkeypatch):
    from paralleljohnson_tpu_torch.observe import ProfileStore

    store = ProfileStore(tmp_path)
    for i in range(3):
        batch = 8 << i
        store.append({
            "kind": "solve", "route": "vm", "platform": "cpu", "nodes": 64,
            "edges": 1000, "batch": batch,
            "measured": {"compute_s": 1e-6 * batch * 1000,
                         "wall_s": 1e-6 * batch * 1000},
            "edges_relaxed": batch * 1000,
            "cost": {"flops": 2.0 * batch * 1000,
                     "bytes_accessed": 16.0 * batch * 1000,
                     "transcendentals": 0.0},
            "roofline": {"bound": "hbm"},
        })
    monkeypatch.delenv("PJ_PROFILE_DIR", raising=False)
    argv = ["info", "--profile-store", str(tmp_path), "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    ref, obs = json.loads(ref)["cost_observatory"], \
        json.loads(out)["cost_observatory"]
    assert set(obs) == set(ref)
    assert obs["records"] == ref["records"] == 3
    assert obs["priced_routes"][0]["route"] == "vm"
    assert obs["priced_routes"][0]["s_per_edge_row"] > 0
    assert obs["priced_routes"][0]["s_per_edge_row"] == \
        pytest.approx(ref["priced_routes"][0]["s_per_edge_row"])


def test_stats_and_cli_expose_pipeline_fields(capsys):
    argv = ["solve", "er:n=32,p=0.1", "--backend", "numpy", "--batch-size",
            "8", "--pipeline-depth", "3", "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    out = last_json(out)
    same_keys(last_json(ref), out)
    assert out["final_pipeline_depth"] == 3 and out["overlap_saved_s"] >= 0.0
    assert "download_s" in out and "ckpt_wait_s" in out
    (rc_ref, ref, _), (rc, out, _) = both(capsys, ["info", "--json"])
    assert rc_ref == rc == 0
    ref, info = json.loads(ref)["pipeline"], json.loads(out)["pipeline"]
    assert set(info) == set(ref)
    assert info["pipeline_depth"] == ref["pipeline_depth"] == 2
    assert info["compilation_cache_env"] == "PJ_COMPILE_CACHE"


def test_cli_resilience_flags_and_json_stats(capsys):
    argv = ["solve", "er:n=32,p=0.1", "--backend", "numpy", "--batch-size",
            "16", "--retry-attempts", "2", "--min-source-batch", "4",
            "--stage-deadline", "30", "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    ref, out = last_json(ref), last_json(out)
    for key in ("retries", "oom_degradations", "final_batch",
                "abandoned_stages"):
        assert out[key] == ref[key], key
    assert out["final_batch"] == 16 and out["abandoned_stages"] == []


def test_cli_info_reports_resilience_defaults(capsys):
    (rc_ref, ref, _), (rc, out, _) = both(capsys, ["info", "--json"])
    assert rc_ref == rc == 0
    ref, r = json.loads(ref)["resilience"], json.loads(out)["resilience"]
    assert set(r) == set(ref)
    assert r["retry_attempts"] == ref["retry_attempts"] == 3
    assert r["min_source_batch"] == ref["min_source_batch"] == 8
    assert "halve the source batch" in r["oom_degradation"]


def test_cli_observability_flags(tmp_path, capsys):
    from paralleljohnson_tpu_torch.utils.telemetry import (
        read_heartbeat,
        validate_chrome_trace,
    )

    for name, main in (("ref", ref_cli.main), ("port", cli.main)):
        d = tmp_path / name
        argv = ["solve", "er:n=32,p=0.1", "--backend", "numpy",
                "--batch-size", "8", "--trace-dir", str(d / "tr"),
                "--heartbeat-file", str(d / "hb.json"),
                "--heartbeat-interval", "0.05",
                "--metrics-file", str(d / "m.prom")]
        assert main(argv if name == "ref" else port_argv(argv)) == 0
        capsys.readouterr()
        assert (d / "tr" / "flight-solve.jsonl").exists()
        validate_chrome_trace(json.loads(
            (d / "tr" / "trace-solve.json").read_text()))
        assert "pjtpu_edges_relaxed_total" in (d / "m.prom").read_text()
        assert read_heartbeat(d / "hb.json")["batches_done"] == 4


def test_cli_solve_convergence_flag(capsys):
    """The route is pinned to ``vm``: the reference's auto takes it on the
    CPU, the port's auto the hand sweep ``pallas-vm``, which records no
    trajectory in either package."""
    argv = ["solve", "er:n=48,p=0.1,seed=1", "--backend", "jax",
            "--mesh-shape", "1", "--dense-threshold", "0", "--use-pallas",
            "false", "--convergence", "true", "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    ref, out = last_json(ref), last_json(out)
    assert out["routes_by_phase"] == ref["routes_by_phase"] == {"fanout": "vm"}
    assert set(out["convergence"]) == set(ref["convergence"])
    assert out["convergence"]["fanout"]["iterations"] == \
        ref["convergence"]["fanout"]["iterations"] > 0
    argv = argv[:-1]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    assert "convergence[fanout]:" in ref and "convergence[fanout]:" in out


def test_cli_info_convergence_block(capsys):
    (rc_ref, ref, _), (rc, out, _) = both(capsys, ["info"])
    assert rc_ref == rc == 0
    ref, block = (json.loads(ref)["convergence_observatory"],
                  json.loads(out)["convergence_observatory"])
    assert set(block) == set(ref)
    assert block["heartbeat_fields"] == ref["heartbeat_fields"] == [
        "iter", "frontier_size", "eta_s"]
    assert block["instrumented_routes"] == ref["instrumented_routes"]


def test_cli_budgeted_solve(tmp_path, capsys):
    ref_f, out_f = str(tmp_path / "r.npz"), str(tmp_path / "p.npz")
    argv = ["solve", "grid:rows=6,cols=6,seed=1", "--backend", "numpy",
            "--error-budget", "0.5", "--approx-epsilon", "0.5", "--json",
            "--output"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv + [ref_f],
                                          port_argv(argv + [out_f]))
    assert rc_ref == rc == 0
    ref, out = json.loads(ref), json.loads(out)
    same_keys(ref, out)
    assert out["route"] == ref["route"] == "hopset+bf"
    assert out["exact"] == ref["exact"]
    assert out["plan"]["chosen"] == ref["plan"]["chosen"] == "hopset+bf"
    assert out["certified_frac"] == ref["certified_frac"] == 1.0
    with np.load(ref_f) as r, np.load(out_f) as p:
        assert p["dist"].shape == (36, 36)
        assert np.all(np.isfinite(p["max_error"]))
        close_rows(p["dist"], r["dist"])


def test_cli_budget_zero_stays_exact(capsys):
    argv = ["solve", "grid:rows=5,cols=5,seed=1", "--backend", "numpy",
            "--json"]
    (rc_ref, ref, _), (rc, out, _) = both(capsys, argv)
    assert rc_ref == rc == 0
    ref, out = json.loads(ref), json.loads(out)
    same_keys(ref, out)
    assert "route" not in out and out["edges_relaxed"] > 0


def test_cli_forced_hopset_zero_budget_is_an_error(capsys):
    argv = ["solve", "grid:rows=4,cols=4,seed=1", "--backend", "numpy",
            "--hopset", "true"]
    (rc_ref, _, ref_err), (rc, _, err) = both(capsys, argv)
    assert rc_ref == rc == 1
    assert "error_budget" in ref_err and "error_budget" in err


# -- the port's own cases -----------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["solve", "er:n=40,p=0.1,seed=1"],
    ["sssp", "er:n=40,p=0.1,seed=1", "--source", "0"],
    ["batch", "2", "16", "0.2"],
    ["serve", "er:n=16,p=0.2"],
    ["bench", "er1k_apsp"],
    ["tune", "er:n=16,p=0.2"],
    ["fleet", "resume", "--coordinator-dir", "nowhere"],
])
def test_no_card_without_device_cpu_exits_1(argv, capsys, monkeypatch):
    """Without a card, a verb that holds tensors exits 1 and names
    ``--device cpu``: it never runs on the CPU by itself, whatever
    ``JAX_PLATFORMS`` says (the tests set it to cpu)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert os.environ.get("JAX_PLATFORMS") == "cpu"
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert err.startswith("error:") and "--device cpu" in err


def test_help_lists_every_verb():
    out = subprocess.run([sys.executable, "-m", "paralleljohnson_tpu_torch",
                          "--help"], capture_output=True, text=True,
                         cwd=REPO, timeout=120).stdout
    for verb in ("solve", "sssp", "batch", "bench", "serve", "top", "update",
                 "tune", "fleet", "info"):
        assert verb in out


def _flags(parser) -> dict:
    """Every option string of every (sub)parser, by verb path."""
    import argparse

    out = {}

    def walk(p, path):
        out[path] = {s for a in p._actions for s in a.option_strings}
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sp in a.choices.items():
                    walk(sp, f"{path} {name}".strip())

    walk(parser, "")
    return out


def test_every_reference_flag_is_accepted():
    """The port's parsers accept every flag name of the reference's (and
    add ``--device`` where tensors are held)."""
    import argparse

    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        captured["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            ref_cli.main(["info"])
    finally:
        argparse.ArgumentParser.parse_args = real
    ref = _flags(captured["parser"])
    port = _flags(cli._parser())
    assert set(port) == set(ref)
    for path, flags in ref.items():
        assert flags <= port[path], (path, flags - port[path])
        extra = port[path] - flags
        assert extra <= {"--device"}, (path, extra)


def test_info_imports_no_jax():
    """``python -m paralleljohnson_tpu_torch info`` with ``jax`` and the
    JAX package blocked from import."""
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['paralleljohnson_tpu'] = None; "
            "sys.argv = ['paralleljohnson_tpu_torch', 'info', '--json']; "
            "runpy.run_module('paralleljohnson_tpu_torch', "
            "run_name='__main__')")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=120)
    assert p.returncode == 0, p.stderr
    info = json.loads(p.stdout)
    assert "torch" in info["backends"] and "kernels" in info


def test_compilation_cache_dir_sets_build_dir(tmp_path, monkeypatch, capsys):
    """``compilation_cache_dir`` (or ``$PJ_COMPILE_CACHE``) is where the
    kernels are built, until a library has loaded; a directory that
    cannot be made warns and keeps the default."""
    monkeypatch.setattr(_cuda, "BUILD_DIR", _cuda.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(_cuda, "_libs", {})
    monkeypatch.delenv("PJ_COMPILE_CACHE", raising=False)
    assert platform.enable_compilation_cache(None) == str(_cuda.BUILD_DIR)
    d = tmp_path / "kc"
    assert cli.main(["solve", "er:n=20,p=0.2,seed=2", "--device", "cpu",
                     "--compilation-cache-dir", str(d)]) == 0
    capsys.readouterr()
    assert _cuda.BUILD_DIR == d.resolve() and d.is_dir()
    assert _cuda._target("minplus").parent == d.resolve()
    d2 = tmp_path / "env"
    monkeypatch.setenv("PJ_COMPILE_CACHE", str(d2))
    pjt.get_backend("torch", pjt.SolverConfig(), device="cpu")
    assert _cuda.BUILD_DIR == d2.resolve()
    monkeypatch.delenv("PJ_COMPILE_CACHE")
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.warns(RuntimeWarning, match="cannot build the kernels"):
        got = platform.enable_compilation_cache(str(blocker / "sub"))
    assert got == str(_cuda.DEFAULT_BUILD_DIR)
    # A loaded library pins its directory.
    monkeypatch.setitem(_cuda._libs, "minplus", object())
    with pytest.warns(RuntimeWarning, match="already loaded"):
        got = platform.enable_compilation_cache(str(tmp_path / "late"))
    assert got == str(_cuda.DEFAULT_BUILD_DIR)
    assert not (tmp_path / "late").exists()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert platform.enable_compilation_cache(None) == \
            str(_cuda.DEFAULT_BUILD_DIR)


def test_cli_device_resolution(monkeypatch):
    assert platform.cli_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        platform.cli_device("cuda")
