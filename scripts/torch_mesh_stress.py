#!/usr/bin/env python3
"""Load the in-process mesh over several cards beyond what the card tests
do, one scenario per child process, so a fatal signal in one is recorded
and the others still run.

    python3 scripts/torch_mesh_stress.py [--out DIR] [--only NAME,...]

Needs two cards or more (a card per rank: the rank threads trade tensors
through the mesh's in-process exchange, by device copies between the
cards).
Scenarios (``SCENARIOS``):

- ``loop``: build, solve and close many meshes in one process: 1-D meshes
  under ``sharded_fanout(replicate=True)``, solvers on every card (the
  default mesh) and on a 2-D mesh, each closed; every result held bitwise
  to one card's rows;
- ``churn``: for ``CHURN_S`` seconds, build a mesh over every card, run
  one round (a kernel, a MIN all-reduce, an integer gather) and close it:
  each round makes a fresh mesh and fresh barriers;
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
  card), held bitwise to one card's, trees valid, with the run's limit
  at 20 s so a stuck run raises ``TimeoutError`` naming its entry point
  (where a rank thread once copied between cards while its peers waited
  in an NCCL collective, ROADMAP Queue 3);
- ``skew_first``: the first collective of a fresh mesh reached on skewed
  arrival, in a loop for ``--budget-s`` seconds: each iteration builds an
  edge mesh over every card, runs one round of edge-sharded Bellman-Ford
  on it and closes it (unless ``--no-edge-mesh``), then builds a fresh
  fan-out mesh on which one rank (iteration k: rank k mod n) posts its
  first collectives at once (``gather_ints``, then an ``all_gather`` of
  its [V, b] block of one card's rows) while the others compute their
  blocks with the hand ``fanout_sweep`` kernel and go on launching it
  for a skew of 0, 5, 20 or 100 ms (``SKEW_MS``, changing every n
  iterations) before they post theirs; every rank's gathered rows are
  held bitwise to one card's. A child that dies is replaced by a fresh
  one, which goes on from the next iteration; prints the iterations, the
  iterations a minute, each fatal signal's iteration and the native
  frames caught, and the crash rate per iteration and per four-card
  minute. ``--no-edge-mesh`` leaves the edge mesh out; ``--dtype f64``
  runs the rows at f64 (the fixpoints with their hub flags). An iteration that takes more
  than ``SKEW_STALL_S`` dumps every thread's stack (the ranks' frames
  before the run's limit ends them).

Each child runs under ``python -X faulthandler``, with
``scripts/segv_backtrace.c`` preloaded where it builds and gives frames
on this host (the faulting thread's native frames after every thread's
Python stack, as ``scripts/torch_mesh_repeat.py`` runs the mesh card
tests), and dumps every thread's stack 15 s before its time limit; its
whole output goes to ``DIR/<scenario>.log`` (default
``chiprun_out/mesh_stress``; ``skew_first_NN.log`` per child). Prints
one JSON line per scenario (return code, seconds, the signal if one
killed it, the child's last line) and a summary; exits 1 if any scenario
failed. Imports the package from ``PYTHONPATH`` first, so it can drive
another checkout (``PYTHONPATH=OTHER python3
scripts/torch_mesh_stress.py``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

# After PYTHONPATH, so that another checkout given there is the one run.
sys.path.append(str(Path(__file__).resolve().parent.parent))
sys.path.append(str(Path(__file__).resolve().parent))

SCENARIOS = ("loop", "churn", "fail", "fail_first", "open_at_exit",
             "dropped", "skew", "stuck", "f64_trees", "skew_first")
SPEC = "rmat:scale=12,ef=8,seed=4"
LOOP_MESHES = 24
CHURN_S = 35.0
# skew_first: how long the late ranks go on launching sweeps before they
# post their first collective, by turns.
SKEW_MS = (0, 5, 20, 100)
# skew_first: each collective's limit, so a stuck iteration raises
# instead of holding the loop for the default 300 s; past SKEW_STALL_S an
# iteration dumps every thread's stack.
SKEW_TIMEOUT_S = 30.0
SKEW_STALL_S = 20.0


def _setup(precision: str = "f32"):
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
    if precision == "f64":
        w_in = w_in.double()
    with pjt.ParallelJohnsonSolver(pjt.SolverConfig(
            mesh_shape=(1,), precision=precision), device="cuda") as one:
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


def skew_first(env, start: int, budget_s: float, *,
               edge_mesh: bool = True) -> dict:
    """The ``skew_first`` loop of one child: iterations ``start``,
    ``start + 1``, ... until ``budget_s`` has passed. Prints
    ``SKEW_ITER k`` as iteration k starts and ``SKEW_DONE k`` once its
    rows are held, so the parent knows the iteration a fatal signal
    ended."""
    import faulthandler

    import torch

    from paralleljohnson_tpu_torch.ops.fanout_sweep import (
        fanout_fixpoint,
        fanout_sweep,
    )
    from paralleljohnson_tpu_torch.parallel import edge_sharded_bellman_ford

    mesh_mod, n, g, dg = env["mesh_mod"], env["n"], env["g"], env["dg"]
    mesh_mod.DEFAULT_TIMEOUT_S = SKEW_TIMEOUT_S
    mesh_mod.JOIN_GRACE_S = 10.0
    v = g.num_nodes
    sources = env["sources"]
    per = len(sources) // n
    want = env["want"][:n * per]
    want_vm = torch.as_tensor(want.T.copy())
    dtype = want_vm.dtype
    cards = [torch.device("cuda", i) for i in range(n)]
    place = mesh_mod._Placer()
    # Each rank's copy of the in-edge CSC, its one-card rows (what the
    # first rank posts) and its initial block, made before any mesh.
    in_edges = [place(env["in_edges"], c, "in_edges") for c in cards]
    rows = [want_vm[:, r * per:(r + 1) * per].contiguous().to(cards[r])
            for r in range(n)]
    dist0 = []
    for r in range(n):
        mine = torch.as_tensor(sources[r * per:(r + 1) * per]).to(cards[r])
        dist0.append(mesh_mod._dist0_vm(mine, v, dtype))
    zeros = torch.zeros(v, dtype=dtype, device=dg.weights.device)
    weights = dg.weights.to(dtype)
    torch.cuda.synchronize()

    def body(first: int, skew_s: float):
        def run(comm):
            r = comm.rank
            iters = 0
            if r == first:
                block = rows[r]
            else:
                ip, s_in, w_in, items = in_edges[r]
                block, iters, _ = fanout_fixpoint(
                    dist0[r].clone(), ip, s_in, w_in, max_iter=v,
                    items=items)
                buf = torch.empty_like(block)
                end = time.perf_counter() + skew_s
                k = 0
                while time.perf_counter() < end:
                    fanout_sweep(block, ip, s_in, w_in, items=items, out=buf)
                    k += 1
                    if k % 16 == 0:
                        torch.cuda.current_stream().synchronize()
            ranks = comm.gather_ints([r, iters])
            return ranks, torch.cat(comm.all_gather(block), 1)
        return run

    t0 = time.perf_counter()
    k = start
    while time.perf_counter() - t0 < budget_s:
        first = k % n
        skew_ms = SKEW_MS[(k // n) % len(SKEW_MS)]
        print(f"SKEW_ITER {k} first={first} skew_ms={skew_ms}", flush=True)
        faulthandler.dump_traceback_later(SKEW_STALL_S)
        if edge_mesh:
            emesh = mesh_mod.make_edge_mesh((n,), device="cuda")
            d, _, improving = edge_sharded_bellman_ford(
                emesh, zeros, dg.src, dg.dst, weights, max_iter=1)
            emesh.close()
            assert not improving and torch.equal(d.cpu(), zeros.cpu())
        mesh = mesh_mod.make_mesh((n,), device="cuda")
        got = mesh.run(body(first, skew_ms / 1000.0), label="skew_first")
        mesh.close()
        for r, (ranks, gathered) in enumerate(got):
            assert ranks[:, 0].tolist() == list(range(n)), ranks
            assert torch.equal(gathered.cpu(), want_vm), f"rank {r}"
        faulthandler.cancel_dump_traceback_later()
        print(f"SKEW_DONE {k}", flush=True)
        k += 1
    return {"first_iteration": start, "iterations": k - start,
            "loop_s": time.perf_counter() - t0, "edge_mesh": edge_mesh,
            "dtype": str(dtype)}


def scenario(name: str, args) -> dict:
    env = _setup(args.dtype if name == "skew_first" else "f32")
    mesh_mod, n = env["mesh_mod"], env["n"]
    out = {"cards": n}
    if name == "loop":
        routes = []
        for i in range(LOOP_MESHES):
            kind = i % 3
            if kind == 0:
                mesh = mesh_mod.make_mesh((n,), device="cuda")
                assert mesh.backends() == ["threads"], mesh.describe()
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
        _fanout(env, mesh)  # a first run on the mesh

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
            assert mesh.size == n and mesh.backends() == ["threads"], \
                mesh.describe()
        out["solve_s"] = time.perf_counter() - t0
        out["routes"] = dict(got.stats.routes_by_phase)
        np.testing.assert_array_equal(got.matrix, want.matrix)
        validate_pred_tree(g, got.matrix, to_numpy(got.predecessors),
                           sources)
    elif name == "skew_first":
        out.update(skew_first(env, args.start, args.budget_s,
                              edge_mesh=not args.no_edge_mesh))
    else:
        raise SystemExit(f"unknown scenario {name}")
    return out


def _handler(out: Path) -> tuple[dict, dict]:
    """The native-frame probe of ``torch_mesh_repeat.py`` (on a child that
    dereferences a null pointer), and the environment the scenarios run
    in: the handler preloaded where it gave frames."""
    from torch_mesh_repeat import probe

    found = probe(out)
    env = dict(os.environ)
    if "backtrace" in found["works"]:
        env["LD_PRELOAD"] = found["backtrace"]["lib"]
    return found, env


def run_skew_first(args, out: Path, env: dict) -> dict:
    """Children of the ``skew_first`` scenario, one after another for
    ``args.budget_s`` seconds, each going on from the iteration after the
    last one held (or after the one a child died in)."""
    from torch_mesh_repeat import FRAME

    env = dict(env, TORCH_SHOW_CPP_STACKTRACES="1")
    flags = (["--no-edge-mesh"] if args.no_edge_mesh else []) + [
        "--dtype", args.dtype]
    t0 = time.perf_counter()
    nxt, child, done, bad_starts = 0, 0, 0, 0
    crashes, errors, loop_s = [], [], 0.0
    last = ""
    while True:
        left = args.budget_s - (time.perf_counter() - t0)
        if left < 20.0 or bad_starts >= 3:
            break
        child += 1
        log = out / f"skew_first_{child:02d}.log"
        cmd = [sys.executable, "-X", "faulthandler", __file__,
               "--scenario", "skew_first", "--timeout", str(left + 120.0),
               "--start", str(nxt), "--budget-s", str(left), *flags]
        with open(log, "w") as f:
            try:
                rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                                    env=env, timeout=left + 180.0).returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
        text = log.read_text(errors="replace")
        started = [int(x) for x in re.findall(r"^SKEW_ITER (\d+)", text,
                                              re.M)]
        held = [int(x) for x in re.findall(r"^SKEW_DONE (\d+)", text, re.M)]
        done += len(held)
        stress = re.findall(r"^STRESS (.*)$", text, re.M)
        if stress:
            rec = json.loads(stress[-1])
            loop_s += rec.get("loop_s", 0.0)
            last = stress[-1][:400]
        if rc == 0:
            nxt = (held[-1] + 1) if held else nxt
            bad_starts = 0
            continue
        at = started[-1] if started else None
        rec = {"child": child, "rc": rc, "iteration": at, "log": str(log),
               "native_frames": len(FRAME.findall(text))}
        if isinstance(rc, int) and rc < 0:
            rec["signal"] = signal.Signals(-rc).name
            crashes.append(rec)
        else:
            errors.append(rec)
        print(json.dumps({"skew_first_child": rec}), flush=True)
        if at is None:
            bad_starts += 1
        else:
            nxt, bad_starts = at + 1, 0
    secs = time.perf_counter() - t0
    started_n = done + len(crashes) + len([e for e in errors
                                           if e["iteration"] is not None])
    return {"scenario": "skew_first", "rc": 1 if crashes or errors else 0,
            "seconds": secs, "children": child, "iterations": started_n,
            "held": done, "iterations_per_min": 60.0 * started_n / secs,
            "crashes": crashes, "errors": errors,
            "crash_per_iteration": len(crashes) / max(1, started_n),
            "crashes_per_min": len(crashes) / (secs / 60.0),
            "edge_mesh": not args.no_edge_mesh, "dtype": args.dtype,
            "loop_s": loop_s,
            "last": last}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/mesh_stress")
    ap.add_argument("--only", default=",".join(SCENARIOS))
    ap.add_argument("--scenario", help=argparse.SUPPRESS)
    ap.add_argument("--start", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=240.0)
    ap.add_argument("--budget-s", type=float, default=300.0,
                    help="skew_first: seconds of iterations")
    ap.add_argument("--no-edge-mesh", action="store_true",
                    help="skew_first: no edge mesh before the fan-out mesh")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32",
                    help="skew_first: the rows' precision")
    args = ap.parse_args()
    if args.scenario:
        import faulthandler

        faulthandler.dump_traceback_later(max(5.0, args.timeout - 15.0))
        t0 = time.perf_counter()
        rec = scenario(args.scenario, args)
        rec["seconds"] = time.perf_counter() - t0
        print("STRESS " + json.dumps(rec), flush=True)
        return 0

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    found, env = _handler(out)
    print(json.dumps({"probe": found}), flush=True)
    failed = []
    for name in args.only.split(","):
        if name == "skew_first":
            rec = run_skew_first(args, out, env)
            if rec["rc"] != 0:
                failed.append(name)
            print(json.dumps(rec), flush=True)
            continue
        log = out / f"{name}.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            try:
                rc = subprocess.run(
                    [sys.executable, "-X", "faulthandler", __file__,
                     "--scenario", name, "--timeout", str(args.timeout)],
                    stdout=f, stderr=subprocess.STDOUT, env=env,
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
