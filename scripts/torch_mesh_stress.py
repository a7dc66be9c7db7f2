#!/usr/bin/env python3
"""Load the in-process NCCL mesh beyond what the card tests do, one
scenario per child process, so a fatal signal in one is recorded and the
others still run.

    python3 scripts/torch_mesh_stress.py [--out DIR] [--only NAME,...]

Needs two cards or more (a card per rank, so the groups are NCCL).
Scenarios (``SCENARIOS``):

- ``loop``: build, solve and close many meshes in one process: 1-D meshes
  under ``sharded_fanout(replicate=True)``, solvers on every card (the
  default mesh) and on a 2-D mesh, each closed; every result held bitwise
  to one card's rows;
- ``churn``: for ``CHURN_S`` seconds, build a mesh over every card, run
  one round (a kernel, a MIN all-reduce, an integer gather) and close it:
  each round makes and releases the NCCL communicators anew;
- ``fail``: a rank raises between two collectives of a run, ten times on
  one mesh, each followed by a good run on the same mesh;
- ``fail_first``: a rank raises before its first collective;
- ``open_at_exit``: a mesh left open when the interpreter exits;
- ``dropped``: meshes dropped without ``close()`` and collected;
- ``skew``: one rank reaches its collective after the collective timeout
  (10 s) but inside the join limit: the run must raise a Python error or
  finish, and the process must live on to solve again;
- ``stuck``: one rank never posts its collective: the caller must get
  ``TimeoutError`` and the process must live on to solve again;
- ``f64_trees``: R-MAT-12 at f64 with trees over 96 sources under a
  default ``SolverConfig(precision="f64")`` (the default mesh: every
  card, NCCL), held bitwise to one card's, trees valid, with the run's
  limit at 20 s so a stuck run raises ``TimeoutError`` naming its entry
  point (where a rank thread once copied between cards while its peers
  waited in an NCCL collective, ROADMAP Queue 3).

Each child runs under ``python -X faulthandler`` and dumps every thread's
stack 15 s before its time limit; its whole output goes to
``DIR/<scenario>.log`` (default ``chiprun_out/mesh_stress``). Prints one
JSON line per scenario (return code, seconds, the signal if one killed
it, the child's last line) and a summary; exits 1 if any scenario failed.
Imports the package from ``PYTHONPATH`` first, so it can drive another
checkout (``PYTHONPATH=OTHER python3 scripts/torch_mesh_stress.py``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

# After PYTHONPATH, so that another checkout given there is the one run.
sys.path.append(str(Path(__file__).resolve().parent.parent))

SCENARIOS = ("loop", "churn", "fail", "fail_first", "open_at_exit",
             "dropped", "skew", "stuck", "f64_trees")
SPEC = "rmat:scale=12,ef=8,seed=4"
LOOP_MESHES = 24
CHURN_S = 35.0


def _setup():
    import numpy as np
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.parallel import mesh as mesh_mod

    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"needs two cards or more; {n} visible")
    os.environ.pop(mesh_mod.MESH_DEVICES_ENV, None)
    g = pjt.load_graph(SPEC)
    dg = pjt.get_backend("torch", pjt.SolverConfig(), device="cuda").upload(g)
    (ip, s_in, w_in), items = dg.fanout_layout()
    sources = np.arange(0, g.num_nodes, 61)[:40]
    with pjt.ParallelJohnsonSolver(pjt.SolverConfig(mesh_shape=(1,)),
                                   device="cuda") as one:
        want = one.solve(g, sources).matrix
    return dict(np=np, torch=torch, pjt=pjt, mesh_mod=mesh_mod, n=n, g=g,
                dg=dg, in_edges=(ip, s_in, w_in, items), sources=sources,
                want=want)


def _fanout(env, mesh):
    from paralleljohnson_tpu_torch.parallel import sharded_fanout

    dg, g = env["dg"], env["g"]
    dist, _, improving = sharded_fanout(
        mesh, env["sources"], dg.src, dg.dst, dg.weights,
        num_nodes=g.num_nodes, max_iter=g.num_nodes, layout="vertex_major",
        replicate=True, in_edges=env["in_edges"])
    assert not improving
    got = dist.cpu().numpy()
    env["np"].testing.assert_array_equal(got, env["want"])
    for copy in dist.replicas:
        assert env["torch"].equal(copy.cpu(), dist.cpu())


def _solve(env, **cfg):
    pjt = env["pjt"]
    with pjt.ParallelJohnsonSolver(pjt.SolverConfig(**cfg),
                                   device="cuda") as solver:
        res = solver.solve(env["g"], env["sources"])
    env["np"].testing.assert_array_equal(res.matrix, env["want"])
    return res.stats.routes_by_phase["fanout"]


def _failing_body(fail_at: int):
    def body(comm):
        import torch

        x = torch.ones(4, device=comm.device)
        for step in range(2):
            if comm.rank == 1 and step == fail_at:
                raise KeyError("rank 1")
            comm.all_reduce_min_(x)
        return x
    return body


def scenario(name: str) -> dict:
    env = _setup()
    mesh_mod, n = env["mesh_mod"], env["n"]
    out = {"cards": n}
    if name == "loop":
        routes = []
        for i in range(LOOP_MESHES):
            kind = i % 3
            if kind == 0:
                mesh = mesh_mod.make_mesh((n,), device="cuda")
                assert mesh.backends() == ["nccl"], mesh.describe()
                _fanout(env, mesh)
                mesh.close()
                routes.append("direct")
            elif kind == 1:
                routes.append(_solve(env, mesh_shape=(n,)))
            else:
                routes.append(_solve(env, mesh_shape=(2, n // 2)))
        out["routes"] = sorted(set(routes))
        out["meshes"] = LOOP_MESHES
    elif name == "churn":
        import torch

        def body(comm):
            a = torch.randn(512, 512, device=comm.device)
            x = (a @ a).amin(0) + comm.rank
            comm.all_reduce_min_(x)
            ranks = comm.gather_ints([comm.rank])
            return float(x.min()), ranks[:, 0].tolist()

        rounds, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < CHURN_S:
            mesh = mesh_mod.make_mesh((n,), device="cuda")
            got = mesh.run(body)
            mesh.close()
            assert all(r[1] == list(range(n)) for r in got), got
            rounds += 1
        out["rounds"] = rounds
    elif name in ("fail", "fail_first"):
        mesh = mesh_mod.make_mesh((n,), device="cuda")
        rounds = 10 if name == "fail" else 3
        for _ in range(rounds):
            try:
                mesh.run(_failing_body(1 if name == "fail" else 0))
            except KeyError:
                pass
            else:
                raise AssertionError("the failing run did not raise")
            _fanout(env, mesh)
        mesh.close()
        out["rounds"] = rounds
    elif name == "open_at_exit":
        mesh = mesh_mod.make_mesh((n,), device="cuda")
        _fanout(env, mesh)
        out["left_open"] = mesh.describe()
    elif name == "dropped":
        for _ in range(5):
            mesh = mesh_mod.make_mesh((n,), device="cuda")
            _fanout(env, mesh)
            del mesh
            gc.collect()
        out["dropped"] = 5
    elif name in ("skew", "stuck"):
        import torch

        mesh_mod.DEFAULT_TIMEOUT_S = 10.0
        mesh_mod.JOIN_GRACE_S = 20.0 if name == "skew" else 5.0
        mesh = mesh_mod.make_mesh((n,), device="cuda")
        _fanout(env, mesh)  # groups and communicators built

        def body(comm):
            x = torch.ones(4, device=comm.device)
            if comm.rank == 1:
                time.sleep(15.0 if name == "skew" else 60.0)
                if name == "stuck":
                    return x
            comm.all_reduce_min_(x)
            torch.cuda.current_stream().synchronize()
            return x

        t0 = time.perf_counter()
        try:
            mesh.run(body)
            out["run"] = "returned"
        except Exception as e:  # noqa: BLE001 — what it raised is the finding
            out["run"] = f"{type(e).__name__}: {str(e)[:200]}"
        out["run_s"] = time.perf_counter() - t0
        # The process must live on: a fresh mesh solves.
        fresh = mesh_mod.make_mesh((n,), device="cuda")
        _fanout(env, fresh)
        fresh.close()
        out["after"] = "solved on a fresh mesh"
    elif name == "f64_trees":
        from paralleljohnson_tpu_torch.solver.johnson import to_numpy
        from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

        np, pjt, g = env["np"], env["pjt"], env["g"]
        mesh_mod.DEFAULT_TIMEOUT_S = 15.0
        mesh_mod.JOIN_GRACE_S = 5.0
        sources = np.arange(0, g.num_nodes, 37)[:96]
        with pjt.ParallelJohnsonSolver(pjt.SolverConfig(
                precision="f64", mesh_shape=(1,)), device="cuda") as one:
            want = one.solve(g, sources, predecessors=True)
        print("one card solved", flush=True)
        t0 = time.perf_counter()
        with pjt.ParallelJohnsonSolver(pjt.SolverConfig(precision="f64"),
                                       device="cuda") as solver:
            got = solver.solve(g, sources, predecessors=True)
            mesh = solver.backend._mesh()
            assert mesh.size == n and mesh.backends() == ["nccl"], \
                mesh.describe()
        out["solve_s"] = time.perf_counter() - t0
        out["routes"] = dict(got.stats.routes_by_phase)
        np.testing.assert_array_equal(got.matrix, want.matrix)
        validate_pred_tree(g, got.matrix, to_numpy(got.predecessors),
                           sources)
    else:
        raise SystemExit(f"unknown scenario {name}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/mesh_stress")
    ap.add_argument("--only", default=",".join(SCENARIOS))
    ap.add_argument("--scenario", help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=240.0)
    args = ap.parse_args()
    if args.scenario:
        import faulthandler

        faulthandler.dump_traceback_later(max(5.0, args.timeout - 15.0))
        t0 = time.perf_counter()
        rec = scenario(args.scenario)
        rec["seconds"] = time.perf_counter() - t0
        print("STRESS " + json.dumps(rec), flush=True)
        return 0

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failed = []
    for name in args.only.split(","):
        log = out / f"{name}.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            try:
                rc = subprocess.run(
                    [sys.executable, "-X", "faulthandler", __file__,
                     "--scenario", name, "--timeout", str(args.timeout)],
                    stdout=f, stderr=subprocess.STDOUT,
                    timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
        text = log.read_text(errors="replace").strip().splitlines()
        last = next((ln for ln in reversed(text) if ln.startswith("STRESS")),
                    text[-1] if text else "")
        rec = {"scenario": name, "rc": rc,
               "seconds": time.perf_counter() - t0, "last": last[:400]}
        if isinstance(rc, int) and rc < 0:
            rec["signal"] = signal.Signals(-rc).name
        if rc != 0:
            failed.append(name)
        print(json.dumps(rec), flush=True)
    print(json.dumps({"scenarios": len(args.only.split(",")),
                      "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
