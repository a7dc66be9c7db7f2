#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of paralleljohnson on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

  1. the card (``nvidia-smi`` name and power limit), then the build of
     every hand kernel from ``paralleljohnson_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version on the card
     (``torch.equal``): the fan-out sweep at RMAT-20 with B = 128 and
     B = 512, the min-plus product at 1024^3, 1000x777x513 and with
     all-+inf rows;
  3. ``solve()`` on ``rmat:scale=20,ef=16,seed=0`` over 512 sources
     (route ``pallas-vm``), 2 rows checked against scipy Dijkstra;
  4. ``solve()`` on ``grid:rows=512,cols=512,neg=0.2,seed=0`` over 256
     sources (phase 1, reweight, un-reweight): the potentials checked
     feasible on every edge, 2 rows against scipy Dijkstra on the graph
     reweighted with them;
  5. ``solve()`` on ``er:n=1024,p=0.1,seed=0`` for all sources (route
     ``dense-squaring-pallas``), the whole matrix against scipy;
  6. the fan-out sweep against its plain version (``torch.equal`` and the
     same flag, every sweep) on the grid solve's own inputs: the
     reweighted in-edge layout the solve ran on, B = 256, from the
     sources to the fixpoint, which must take the solve's sweep count
     and un-reweight to the solve's rows bitwise;
  7. a 4-edge negative cycle raises ``NegativeCycleError`` on the card;
  8. CUDA-event times of each kernel and its plain version at the main
     path's shapes, with the bound the card could reach.

Phases 3-5 are the main path: the kernels' launch counters are set to 0
just before and read just after. The last two lines are the ``kernels``
summary and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32 (non-tensor)
# operations/s. The data sheet counts an FMA as two operations; both
# kernels' inner step is an add and a min, two instructions that do not
# fuse, so they issue at half that rate. The bound of a kernel is the
# larger of its bytes and its FP32 instructions over these.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_F32_INSTR_S = PEAK_F32_OPS_S / 2

RMAT_SPEC = "rmat:scale=20,ef=16,seed=0"
GRID_SPEC = "grid:rows=512,cols=512,neg=0.2,seed=0"
ER_SPEC = "er:n=1024,p=0.1,seed=0"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, instructions: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = instructions / PEAK_F32_INSTR_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "drives the port on a CUDA card", file=sys.stderr)
        return 2

    import numpy as np
    import scipy.sparse.csgraph as csgraph

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
    from paralleljohnson_tpu_torch.ops import _cuda
    from paralleljohnson_tpu_torch.ops.fanout_sweep import (
        fanout_sweep, fanout_sweep_plain,
    )
    from paralleljohnson_tpu_torch.ops.minplus import (
        minplus_kernel, minplus_plain,
    )
    from paralleljohnson_tpu_torch.solver.johnson import _unreweight, to_numpy

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def event_ms(fn, reps: int, warmup: int = 1) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def max_abs_err(got, want) -> float:
        if not torch.equal(torch.isinf(got), torch.isinf(want)):
            return float("nan")
        fin = torch.isfinite(want)
        if not bool(fin.any()):
            return 0.0
        return float((got[fin] - want[fin]).abs().max())

    # -- phase 1: the card and the build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    logs = _cuda.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": kind})

    # -- phase 2: each kernel against its plain version ---------------------
    t0 = time.perf_counter()
    rmat = pjt.load_graph(RMAT_SPEC)
    gen_s = time.perf_counter() - t0
    v, e = rmat.num_nodes, rmat.num_real_edges
    layout_graph = TorchBackend(pjt.SolverConfig(), device=dev).upload(rmat)
    layout = layout_graph.by_dst()
    rng = np.random.default_rng(0)
    sweep_states = {}
    sweep_checks = []
    for b in (128, 512):
        src = torch.as_tensor(rng.choice(v, b, replace=False)).to(dev)
        d = torch.full((v, b), float("inf"), device=dev)
        d[src, torch.arange(b, device=dev)] = 0.0
        for _ in range(3):  # a block with finite values to fold
            d, _ = fanout_sweep_plain(d, *layout)
        got, flag = fanout_sweep(d, *layout)
        want, imp = fanout_sweep_plain(d, *layout)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = max_abs_err(got, want)
        sweep_checks.append({"B": b, "equal": equal, "max_abs_err": err,
                             "flag": bool(flag.item()), "plain_flag": bool(imp)})
        if not equal or bool(flag.item()) != bool(imp):
            raise AssertionError(f"fanout_sweep disagrees with plain at B={b}: "
                                 f"{sweep_checks[-1]}")
        sweep_states[b] = (d, err)
        del got, want
    mp_checks = []
    mp_err = {}
    for (i, k, j, inf_rows) in ((1024, 1024, 1024, False),
                                (1000, 777, 513, False),
                                (300, 400, 200, True)):
        g_rng = np.random.default_rng(i + k + j)
        dm = torch.as_tensor(g_rng.random((i, k), dtype=np.float32) * 10)
        am = torch.as_tensor(g_rng.random((k, j), dtype=np.float32) * 10)
        dm[torch.as_tensor(g_rng.random((i, k)) < 0.3)] = float("inf")
        am[torch.as_tensor(g_rng.random((k, j)) < 0.3)] = float("inf")
        if inf_rows:
            dm[::3] = float("inf")
        dm, am = dm.to(dev), am.to(dev)
        got = minplus_kernel(dm, am)
        want = minplus_plain(dm, am)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = max_abs_err(got, want)
        mp_checks.append({"shape": [i, k, j], "inf_rows": inf_rows,
                          "equal": equal, "max_abs_err": err})
        if not equal:
            raise AssertionError(f"minplus disagrees with plain: {mp_checks[-1]}")
        mp_err[(i, k, j)] = err
    in_deg = (layout[0][1:] - layout[0][:-1]).cpu()
    emit({"phase": "kernel_vs_plain", "rmat_gen_s": gen_s, "V": v, "E": e,
          "max_in_degree": int(in_deg.max()),
          "rows_in_degree_ge_10000": int((in_deg >= 10000).sum()),
          "fanout_sweep": sweep_checks, "minplus": mp_checks})

    # -- phases 3-5: the main path ------------------------------------------
    fanout_sweep.launches = 0
    minplus_kernel.launches = 0
    per_solve = {}

    class FanoutGraphProbe(TorchBackend):
        """The torch backend, keeping the device graph its fan-out ran on
        (the reweighted one when the graph has negative weights)."""

        fanout_graph = None

        def multi_source(self, dgraph, sources):
            self.fanout_graph = dgraph
            return super().multi_source(dgraph, sources)

    def run_solve(label, graph, sources, backend=None):
        before = (fanout_sweep.launches, minplus_kernel.launches)
        solver = pjt.ParallelJohnsonSolver(pjt.SolverConfig(), backend=backend,
                                           device="cuda")
        res, secs = sync_time(lambda: solver.solve(graph, sources))
        per_solve[label] = {
            "fanout_sweep": fanout_sweep.launches - before[0],
            "minplus": minplus_kernel.launches - before[1],
        }
        return res, secs

    # 3: RMAT-20, 512 sources, route pallas-vm.
    sources = np.sort(np.random.default_rng(1).choice(v, 512, replace=False))
    res, secs = run_solve("rmat20", rmat, sources)
    route = res.stats.routes_by_phase["fanout"]
    if route != "pallas-vm":
        raise AssertionError(f"rmat20 fan-out took route {route}")
    rows = to_numpy(res.dist)
    if rows.shape != (512, v):
        raise AssertionError(f"rmat20 rows shape {rows.shape}")
    check = [0, 511]
    oracle = csgraph.dijkstra(rmat.to_scipy().astype(np.float64),
                              directed=True, indices=sources[check])
    np.testing.assert_array_equal(np.isinf(rows[check]), np.isinf(oracle))
    np.testing.assert_allclose(rows[check], oracle, rtol=1e-5)
    if per_solve["rmat20"]["fanout_sweep"] == 0:
        raise AssertionError("rmat20 solve launched no fanout_sweep kernel")
    emit({"phase": "solve_rmat20", "spec": RMAT_SPEC, "V": v, "E": e,
          "sources": 512, "seconds": secs, "route": route,
          "iterations": dict(res.stats.iterations_by_phase),
          "phase_seconds": dict(res.stats.phase_seconds),
          "launches": per_solve["rmat20"],
          "reachable_fraction": float(np.isfinite(rows).mean()),
          "checked_rows": check})
    del res, rows

    # 4: the 512x512 grid with negative weights, 256 sources.
    grid = pjt.load_graph(GRID_SPEC)
    gsrc = np.sort(np.random.default_rng(2).choice(
        grid.num_nodes, 256, replace=False))
    probe = FanoutGraphProbe(pjt.SolverConfig(), device=dev)
    res, secs = run_solve("grid512", grid, gsrc, backend=probe)
    h = to_numpy(res.potentials).astype(np.float64)
    w = grid.weights.astype(np.float64)
    slack = w + h[grid.src] - h[grid.indices]
    tol = 1e-5 * max(1.0, np.abs(h).max(), np.abs(w).max())
    if not slack.min() >= -tol:
        raise AssertionError(f"potentials infeasible: min slack {slack.min()}")
    rows = to_numpy(res.dist)
    check = [0, 255]
    rew = grid.with_weights(np.maximum(slack, 0.0))
    d_rew = csgraph.dijkstra(rew.to_scipy(), directed=True,
                             indices=gsrc[check])
    oracle = d_rew - h[gsrc[check]][:, None] + h[None, :]
    np.testing.assert_array_equal(np.isinf(rows[check]), np.isinf(oracle))
    np.testing.assert_allclose(rows[check], oracle, rtol=1e-5, atol=1e-3)
    emit({"phase": "solve_grid512", "spec": GRID_SPEC,
          "V": grid.num_nodes, "E": grid.num_real_edges, "sources": 256,
          "seconds": secs, "routes": dict(res.stats.routes_by_phase),
          "iterations": dict(res.stats.iterations_by_phase),
          "phase_seconds": dict(res.stats.phase_seconds),
          "launches": per_solve["grid512"], "min_slack": float(slack.min()),
          "checked_rows": check})
    grid_fanout_s = res.stats.phase_seconds["fanout"]
    grid_sweeps = res.stats.iterations_by_phase["fanout"]
    grid_res = res
    del res, rows

    # 5: dense ER-1024, all sources, route dense-squaring-pallas.
    er = pjt.load_graph(ER_SPEC)
    res, secs = run_solve("er1024", er, None)
    route = res.stats.routes_by_phase["fanout"]
    if route != "dense-squaring-pallas":
        raise AssertionError(f"er1024 fan-out took route {route}")
    oracle = csgraph.dijkstra(er.to_scipy().astype(np.float64), directed=True)
    np.testing.assert_allclose(res.matrix, oracle, rtol=1e-5)
    if per_solve["er1024"]["minplus"] == 0:
        raise AssertionError("er1024 solve launched no minplus kernel")
    emit({"phase": "solve_er1024", "spec": ER_SPEC, "V": er.num_nodes,
          "E": er.num_real_edges, "sources": er.num_nodes, "seconds": secs,
          "route": route, "iterations": dict(res.stats.iterations_by_phase),
          "launches": per_solve["er1024"]})
    del res

    launches = {"fanout_sweep": fanout_sweep.launches,
                "minplus": minplus_kernel.launches}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {name}")

    # -- phase 6: the sweep against its plain version on the grid's inputs ---
    # The layout the grid solve's fan-out ran on: reweighted weights,
    # clamped at 0, and B = 256 (two column tiles of the kernel). Kernel
    # and plain version run in lockstep from the sources to the fixpoint.
    g_layout = probe.fanout_graph.by_dst()
    gv, ge, gb = grid.num_nodes, grid.num_real_edges, len(gsrc)
    d = torch.full((gv, gb), float("inf"), device=dev)
    d[torch.as_tensor(gsrc, device=dev), torch.arange(gb, device=dev)] = 0.0
    grid_err, sweeps, improving, d_timing = 0.0, 0, True, None
    while improving:
        got, flag = fanout_sweep(d, *g_layout)
        want, imp = fanout_sweep_plain(d, *g_layout)
        improving = bool(flag.item())
        if not torch.equal(got, want) or improving != bool(imp):
            raise AssertionError(
                f"fanout_sweep disagrees with plain on the grid at sweep "
                f"{sweeps}: max_abs_err {max_abs_err(got, want)}, flag "
                f"{improving}, plain flag {bool(imp)}")
        grid_err = max(grid_err, max_abs_err(got, want))
        d = got
        sweeps += 1
        if sweeps == min(50, grid_sweeps):
            d_timing = d.clone()
        if sweeps > grid_sweeps:
            break
    if sweeps != grid_sweeps:
        raise AssertionError(f"lockstep fixpoint took {sweeps} sweeps, the "
                             f"solve {grid_sweeps}")
    rows = _unreweight(d.t().contiguous(), grid_res.potentials, gsrc)
    if not torch.equal(rows, grid_res.dist):
        raise AssertionError("the lockstep fixpoint, un-reweighted, differs "
                             "from the grid solve's rows")
    emit({"phase": "kernel_vs_plain_grid", "spec": GRID_SPEC, "B": gb,
          "sweeps_checked": sweeps, "equal": True, "max_abs_err": grid_err,
          "zero_weight_fraction": float((g_layout[2] == 0).float().mean()),
          "rows_equal_solve": True})
    del grid_res, rows, got, want

    # -- phase 7: negative cycle on the card ---------------------------------
    cyc = pjt.CSRGraph.from_edges([0, 1, 2, 3], [1, 2, 3, 1],
                                  [1.0, 2.0, -4.0, 1.0], 4)
    try:
        pjt.ParallelJohnsonSolver(device="cuda").solve(cyc)
    except pjt.NegativeCycleError:
        emit({"phase": "negative_cycle", "raised": "NegativeCycleError"})
    else:
        raise AssertionError("negative cycle not detected on the card")

    # -- phase 8: times at the main path's shapes ----------------------------
    timings = {}
    for b, (d, _) in sweep_states.items():
        out = torch.empty_like(d)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        ms = event_ms(lambda: fanout_sweep(d, *layout, out=out,
                                           improved=flag), reps=10)
        plain = event_ms(lambda: fanout_sweep_plain(d, *layout), reps=2)
        bytes_moved = 4 * (2 * v * b + (v + 1) + 2 * e)
        bms, by = bound(bytes_moved, 2 * e * b)
        timings[f"fanout_sweep_B{b}"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "gathered_GB": 4 * e * b / 1e9,
        }
        del out
    # The grid fan-out's inputs 50 sweeps in (phase 6's layout), to split
    # its per-sweep solve time into kernel and host-loop time.
    d = d_timing
    out = torch.empty_like(d)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = event_ms(lambda: fanout_sweep(d, *g_layout, out=out, improved=flag),
                  reps=50)
    plain = event_ms(lambda: fanout_sweep_plain(d, *g_layout), reps=5)
    bms, by = bound(4 * (2 * gv * gb + (gv + 1) + 2 * ge), 2 * ge * gb)
    timings["fanout_sweep_grid512_B256"] = {
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "solve_s_per_sweep": grid_fanout_s / grid_sweeps,
    }
    i = k = j = 1024
    g_rng = np.random.default_rng(7)
    dm = torch.as_tensor(g_rng.random((i, k), dtype=np.float32)).to(dev)
    am = torch.as_tensor(g_rng.random((k, j), dtype=np.float32)).to(dev)
    ms = event_ms(lambda: minplus_kernel(dm, am), reps=20)
    plain = event_ms(lambda: minplus_plain(dm, am), reps=3)
    bms, by = bound(4 * (i * k + k * j + i * j), 2 * i * k * j)
    timings["minplus_1024"] = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                               "bound_by": by}
    emit({"phase": "timing", "device": kind, "power_limit": smi,
          "timings": timings})

    t_sw = timings["fanout_sweep_B512"]
    t_mp = timings["minplus_1024"]
    emit({"kernels": [
        {"name": "fanout_sweep", "route": "cuda",
         "source": "paralleljohnson_tpu_torch/csrc/fanout_sweep.cu",
         "replaces": "paralleljohnson_tpu/ops/pallas_sweep.py:255",
         "launches": launches["fanout_sweep"],
         "max_abs_err": max(grid_err,
                            *(err for _, err in sweep_states.values())),
         "ms": t_sw["ms"], "plain_ms": t_sw["plain_ms"],
         "bound_ms": t_sw["bound_ms"], "bound_by": t_sw["bound_by"],
         "library_ms": None},
        {"name": "minplus", "route": "cuda",
         "source": "paralleljohnson_tpu_torch/csrc/minplus.cu",
         "replaces": "paralleljohnson_tpu/ops/pallas_kernels.py:117",
         "launches": launches["minplus"],
         "max_abs_err": max(mp_err.values()),
         "ms": t_mp["ms"], "plain_ms": t_mp["plain_ms"],
         "bound_ms": t_mp["bound_ms"], "bound_by": t_mp["bound_by"],
         "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
