#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of paralleljohnson on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

  1. the card (``nvidia-smi`` name and power limit), then the build of
     every hand kernel from ``paralleljohnson_tpu_torch/csrc`` (``ptxas``
     registers, stack frames and spills, by function, none allowed;
     ``tight_pred``'s by template:
     pass width NV, float4 or scalar lanes, gathers per batch U) and each
     kernel's resident blocks per SM;
  2. each kernel against its plain PyTorch version on the card
     (``torch.equal``, same flag): the fan-out sweep at RMAT-20 with
     B = 128 and B = 512 and on a hub graph (one row of 5 L + 3
     in-edges, rows of L and L + 1, an empty row, +inf weights) at
     B = 1, 5, 128, 200, 512, so the split rows' partial minima and
     their combine run; the min-plus product at I x 1024 x 1024 for I =
     1, 16, 100, 128, 511, 1024 (every tile and split-K branch of
     ``minplus_plan``), 1000x777x513, 300x400x200 with all-+inf rows,
     negative finite entries, and ``d is a`` as in squaring; the
     tight-edge pass ``tight_pred`` (int32 trees, ``torch.equal``
     against ``tight_pred_pass_plain``; with the sources, its source
     mask and tree flags against ``tree_flags_plain``) on R-MAT-20's
     converged fan-out at B = 128 and 512, split hub rows included,
     where weights in [1, 10) raise neither flag;
  3. ``solve()`` on ``rmat:scale=20,ef=16,seed=0`` over 512 sources
     (route ``pallas-vm``), 2 rows checked against scipy Dijkstra;
  4. ``solve()`` on ``grid:rows=512,cols=512,neg=0.2,seed=0`` over 256
     sources (phase 1 on ``frontier``, the reference's default route on
     this low-degree graph; reweight, un-reweight): the potentials checked
     feasible on every edge, 2 rows against scipy Dijkstra on the graph
     reweighted with them;
  5. ``solve()`` on ``er:n=1024,p=0.1,seed=0`` with ``fw=False`` (the
     default takes ``fw-tile`` there: phase 16) for all sources (route
     ``dense-squaring-pallas``), the whole matrix against scipy; then for
     128 sources (route ``dense-iterate-pallas``, ``minplus_fixpoint``:
     at most ceil(iterations / 16) + 1 host reads), rows against scipy;
  6. the fan-out sweep against its plain version (``torch.equal`` and
     the same flag, every sweep) on the grid solve's own inputs: the
     reweighted in-edge layout the solve ran on, B = 256, from the
     sources to the fixpoint, which must take the solve's sweep count
     and un-reweight to the solve's rows bitwise; ``tight_pred`` against
     its plain version on that fixpoint (zero-weight ties throughout: it
     must raise the nondescending flag);
  7. a 4-edge negative cycle raises ``NegativeCycleError`` on the card;
  8. CUDA-event times of each kernel and its plain version at the main
     path's shapes, with the bound the card could reach: the sweep at
     L = ``ITEM_EDGES`` (RMAT-20, B = 128 and 512; grid, B = 256, also
     at its fixpoint, where no row drops), the grid fixpoint's host
     clock per sweep at ``SWEEPS_PER_SYNC`` sweeps per host read, and the
     min-plus product at I x 1024 x 1024 for I = 16, 128, 511, 1024 (the
     dense route's iterate and squaring shapes) and at 4096^3, both as
     the wrapper called back to back (``ms``, as the main path pays it)
     and as the card's time alone from CUDA-graph replays (``card_ms``);
     the 128-source ER-1024 fixpoint on the host clock; ``tight_pred``
     with the sources (as the pred solves call it) at R-MAT-20's fixpoint
     (B = 512, 128) and the grid's (B = 256), each with its template's
     registers and spills; the tree check (``certify_pred``) on those
     trees with the kernel's flags beside the check without them (source
     mask, coverage, pointer doubling): R-MAT-20 at B = 512 must certify
     with no walk, the grid must walk and pass;
  9. the pipelined batch driver: ``solve()`` on R-MAT-20 over phase 3's
     512 sources and 512 more, in 4 batches of 256 (1 GiB of rows each),
     at ``pipeline_depth`` 1, 2, 2, 1: rows equal bitwise across runs and
     to phase 3's, 2 rows against scipy; each run's fan-out seconds,
     download / wait / overlap seconds, ``clear_caches`` count, sweep
     launches and host reads; the time of one layout rebuild;
 10. ``solve_reduced`` on the same sources with each built-in reducer,
     against phase 9's rows reduced in numpy (``checksum`` to rtol 1e-6),
     with no call of ``_download_rows``;
 11. checkpoint/resume on the grid (256 sources, batches of 128, depth
     2): 2 batches written, both resumed, an injected OOM in batch 1
     that collapses the window, and an uncheckpointed solve, all
     bitwise equal;
 12. ``sssp`` on the grid (``frontier``) against phase 4's row (rtol
     1e-5, atol 1e-3)
     and on phase 7's negative cycle; ``multi_source`` on R-MAT-20 over
     phase 3's sources (bitwise, rows still on the card); ``solve_batch``
     of 4 ``er:n=256,p=0.1`` graphs (``batch-vmapped``) against their
     ``solve()``s on ``pallas-vm`` bitwise;
 13. ``predecessors=True`` solves (``validate_pred_tree`` on their
     trees): R-MAT-20 over phase 3's sources and the grid over phase 4's
     (``pallas-vm+pred``, rows bitwise equal to theirs), ``sssp`` on the
     grid (``frontier+pred``), the zero-weight tight cycle (``pred-sweep``
     after a warning), a 2-batch checkpointed solve resumed, ER-1024
     (``dense-squaring-pallas+pred``, ``fw=False``);
 14. the XLA routes in plain PyTorch beside the hand routes, rows
     bitwise equal: ``use_pallas=False`` (``vm-blocked``) on R-MAT-20
     at B = 128 and on the grid at B = 64, ``sweep-sm`` on R-MAT-16,
     XLA ``dense-squaring`` on ER-1024 (both with ``fw=False``); fan-out
     seconds per sweep of each route and of its hand route;
 15. the B=1 routes on the grid, in plain PyTorch: ``sssp`` from phase
     4's first source on ``sweep`` (``frontier=False``), ``frontier``
     (the default config), ``dia``, ``gs`` and ``bucket`` (forced), rows
     bitwise equal to ``sweep``'s, each with its seconds (the first call
     and a second ``bellman_ford`` on the same device graph), rounds,
     ``edges_relaxed`` and host reads; ``frontier+pred`` and ``dia+pred``
     (``validate_pred_tree``, a ``tight_pred`` launch); phase 7's
     negative cycle raised on each forced route; the default solve's
     tags (``frontier``, ``pallas-vm``) and its phase-1 seconds beside a
     ``frontier=False`` solve's (both warm, rows bitwise equal); the
     forced ``dia`` and ``gs`` fan-outs at B = 64 (rows bitwise equal to
     ``pallas-vm``'s) with seconds per round; a ``convergence=True``
     ``use_pallas=False`` solve's trajectory summary (``vm-blocked``);
 16. dense APSP: the ``fw_kleene`` kernel against ``tile_kleene`` at t =
     128, 256, 384, 512 (one cluster launch per closure) and 1024 (the
     step variant, t launches), each also on a tile whose diagonal goes
     negative, bitwise; ``kleene_plan(512)`` and the clusters the card
     holds; each variant's times (t = 512 and 1024) and, last in the
     phase, the kernels the card ran for one closure of each
     (``torch.profiler``: 1 and t);
     ``er:n=2048,p=0.1,seed=21`` with the reference's integer weights,
     all sources, default config
     (``fw-tile``), twice in turns with a forced ``dense-squaring-pallas``
     and ``pallas-vm`` solve, rows bitwise equal, with the products' card
     time per k-step at its shapes; phase 5's ER-1024 at default config
     (``fw-tile``) against scipy and within rtol 1e-6 of phase 5's
     squaring matrix, then ``fw-tile+pred``; the condensed route forced
     (``partitioned=True``) on ``grid:rows=64,cols=64,neg=0.2,seed=3``,
     all 4096 sources, against the default solve (rtol 1e-6, atol 1e-4;
     bitwise with the weights rounded), its stage split, and a negative
     cycle across parts that raises; ``solve_batch`` of
     ``random_graph_batch(10000, 256, 8/256, seed=0)`` (``batch-vmapped``),
     64 sampled graphs against scipy Johnson (rtol 1e-6) and bitwise
     against their own ``solve()``, beside a 100-graph ``solve()`` loop.

Each solving path is driven with the kernels' launch counters (and the
fixpoints' host reads) set to 0 just before and read just after:
phases 3-5 together, then each path of phases 9-16 on its own; a path
whose kernel was never launched fails (the plain-torch B=1 routes of
phase 15 need none). The last two lines are the
``kernels`` summary (launches summed over the paths, and by path) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
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
BATCH_SPEC = "er:n=256,p=0.1"  # phase 12's solve_batch, seeds 0-3
PRED_CKPT_SPEC = "grid:rows=64,cols=64,neg=0.2,seed=3"  # phases 13, 16
# Phase 16: the reference's dense FW benchmark graph (its weights are
# redrawn as integers from default_rng(22)) and the many-small-graphs
# config (BASELINE.json: 10k random 256-node graphs).
FW_SPEC = "er:n=2048,p=0.1,seed=21"
BATCH_APSP_GRAPHS = 10000
SWEEP_SM_SPEC = "rmat:scale=16,ef=8,seed=2"  # phase 14
# Phase 9: phase 3's 512 R-MAT-20 sources and this many more, in batches
# of MULTI_BATCH (a [256, 2^20] f32 block is 1 GiB). Phase 11: the grid,
# CKPT_SOURCES sources in batches of CKPT_BATCH.
MULTI_EXTRA_SOURCES = 512
MULTI_BATCH = 256
CKPT_SOURCES = 256
CKPT_BATCH = 128
# Min-plus shapes timed in phase 8 (I, K, J): B x V x V for B = 16, 128,
# 511 sources (the iterate regime) and V^3 (squaring) at V = 1024; and
# 4096^3, off the main path, for information.
MINPLUS_SHAPES = ((16, 1024, 1024), (128, 1024, 1024), (511, 1024, 1024),
                  (1024, 1024, 1024), (4096, 4096, 4096))
# Phase 16: the tile the Kleene kernel's step variant is checked and
# timed at (off every default path: config.fw_tile above 512).
KLEENE_STEP_T = 1024


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, instructions: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = instructions / PEAK_F32_INSTR_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def minplus_bound(i: int, k: int, j: int) -> tuple[float, str]:
    """The bound of an [i, k] x [k, j] min-plus product: both operands
    read and the result written once; an add and a min per candidate."""
    return bound(4 * (i * k + k * j + i * j), 2 * i * k * j)


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the finite entries; NaN when the +inf
    entries differ."""
    import torch

    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        return float("nan")
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0
    return float((got[fin] - want[fin]).abs().max())


def event_ms(fn, reps: int, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn``, called back to back from the host
    between two CUDA events: what a loop of calls pays, host time
    included when a call takes the host longer than the card."""
    import torch

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


def device_kernels(fn, name: str) -> int:
    """Kernels whose name holds ``name`` that the card ran in one call of
    ``fn``, from ``torch.profiler``'s CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.name)


def graph_ms(fn, reps: int) -> float:
    """The card's milliseconds per call of ``fn``: ``reps`` calls captured
    in a CUDA graph and replayed between two CUDA events, so that no host
    time is in it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sync_time(fn):
    """(fn(), host seconds), between two ``torch.cuda.synchronize()``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def ptxas_functions(log: str) -> list[dict]:
    """Registers, stack frame and spill bytes of each kernel function in a
    build's ``-Xptxas -v`` output."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            (cur["stack_frame"], cur["spill_stores"],
             cur["spill_loads"]) = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def tight_pred_templates(log: str) -> dict:
    """``tight_pred``'s items kernels by template (``NV{nv}_{vec|scalar}
    _U{u}``) and its combine kernels (``combine_{vec|scalar}``): registers
    and spill bytes, from the build log."""
    out = {}
    for f in ptxas_functions(log):
        m = re.search(r"pred_itemsILi(\d+)ELb([01])ELi(\d+)E", f["function"])
        c = re.search(r"combine_split_rowsILb([01])E", f["function"])
        if m:
            name = (f"NV{m.group(1)}_{'vec' if m.group(2) == '1' else 'scalar'}"
                    f"_U{m.group(3)}")
        elif c:
            name = f"combine_{'vec' if c.group(1) == '1' else 'scalar'}"
        else:
            continue
        out[name] = {k: f.get(k) for k in ("registers", "spill_stores",
                                           "spill_loads")}
    return out


def pred_template(b: int, vec: bool = True) -> str:
    """The ``tight_pred_templates`` key prefix of the items kernel a pass
    at width ``b`` runs (NV by B, as ``csrc/tight_pred.cu`` picks it)."""
    return f"NV{1 if b <= 128 else 2}_{'vec' if vec else 'scalar'}_U"


def counter(launches: dict):
    """``counted(path, fn, needs=())``: ``fn()`` on the host clock with
    every kernel's launch count (and the fixpoints' host reads) set to 0
    just before and read just after into ``launches[path]``; raises if a
    kernel named in ``needs`` was launched no time. Returns (fn(), s)."""
    from paralleljohnson_tpu_torch.ops import bucket as bucket_mod
    from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
    from paralleljohnson_tpu_torch.ops import fw as fw_mod
    from paralleljohnson_tpu_torch.ops import gauss_seidel as gs_mod
    from paralleljohnson_tpu_torch.ops import minplus as mp_mod
    from paralleljohnson_tpu_torch.ops import pred as pred_mod
    from paralleljohnson_tpu_torch.ops import relax

    # The host loops of the plain-torch routes, by the counter's name.
    loops = {"fanout_host_reads": fs.fanout_fixpoint,
             "sweep_host_reads": relax._sweeps_to_fixpoint,
             "frontier_host_reads": relax.bellman_ford_frontier,
             "gs_host_reads": gs_mod._gs_engine,
             "bucket_host_reads": bucket_mod.bellman_ford_bucketed}

    def counted(path, fn, needs=()):
        fs.fanout_sweep.launches = 0
        mp_mod.minplus_kernel.launches = 0
        pred_mod.tight_pred_pass.launches = 0
        fw_mod.fw_kleene.launches = 0
        for loop in loops.values():
            loop.host_reads = 0
        out = sync_time(fn)
        launches[path] = {"fanout_sweep": fs.fanout_sweep.launches,
                          "minplus": mp_mod.minplus_kernel.launches,
                          "tight_pred": pred_mod.tight_pred_pass.launches,
                          "fw_kleene": fw_mod.fw_kleene.launches,
                          **{k: f.host_reads for k, f in loops.items()}}
        for name in needs:
            if launches[path][name] == 0:
                raise AssertionError(f"{path} launched no {name} kernel")
        return out

    return counted


def solver_on(dev, backend_cls=None, **kw):
    """A solver on ``dev`` over ``backend_cls`` (the torch backend by
    default) with ``SolverConfig(**kw)``."""
    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend

    backend = (backend_cls or TorchBackend)(pjt.SolverConfig(**kw),
                                            device=dev)
    return pjt.ParallelJohnsonSolver(backend.config, backend=backend)


def drive_entry_points(dev, rmat, rmat_sources, rmat_rows, grid, grid_source,
                       grid_row, cycle_graph) -> dict:
    """Phases 9-12: the solver's batch driver and its other entry points
    on ``dev`` (the card). ``rmat_rows`` are phase 3's host rows over
    ``rmat_sources``; ``grid_row`` is phase 4's row of ``grid_source``.
    Each path runs with the kernels' launch counts set to 0 just before
    and read just after; returns those counts by path."""
    import tempfile

    import numpy as np
    import scipy.sparse.csgraph as csgraph
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
    from paralleljohnson_tpu_torch.solver.johnson import _ROW_REDUCERS, to_numpy
    from paralleljohnson_tpu_torch.utils.checkpoint import BatchCheckpointer

    class CountingBackend(TorchBackend):
        """The torch backend, counting ``clear_caches`` calls."""

        clears = 0

        def clear_caches(self, dgraph):
            self.clears += 1
            super().clear_caches(dgraph)

    launches = {}
    counted = counter(launches)

    def solver_with(backend_cls=TorchBackend, **kw):
        return solver_on(dev, backend_cls, **kw)

    # -- phase 9: multi-batch solve() on R-MAT-20, depth 1 and 2 in turns ----
    v = rmat.num_nodes
    extra = np.random.default_rng(9).choice(
        np.setdiff1d(np.arange(v), rmat_sources), MULTI_EXTRA_SOURCES,
        replace=False)
    sources = np.sort(np.concatenate([rmat_sources, extra]))
    at_phase3 = np.searchsorted(sources, rmat_sources)
    check = [int(np.searchsorted(sources, extra.min())),
             int(np.searchsorted(sources, extra.max()))]
    # What suggested_source_batch (the OOM degrader's re-consult) returns
    # before the runs and after each, on one device graph at depth 2:
    # mem_get_info counts the caching allocator's cached blocks as used.
    probe = TorchBackend(pjt.SolverConfig(), device=dev)
    dg = probe.upload(rmat)
    suggested_before = probe.suggested_source_batch(dg)
    free_before = torch.cuda.mem_get_info(dev)[0]
    rows = None
    runs = []
    for run, depth in enumerate((1, 2, 2, 1)):
        solver = solver_with(CountingBackend, source_batch_size=MULTI_BATCH,
                             pipeline_depth=depth)
        res, secs = counted(f"multi_batch_depth{depth}_run{run}",
                            lambda: solver.solve(rmat, sources),
                            needs=("fanout_sweep",))
        st = res.stats
        if (not isinstance(res.dist, np.ndarray)
                or res.dist.shape != (len(sources), v)):
            raise AssertionError(f"multi-batch rows: {type(res.dist)}")
        if st.final_pipeline_depth != depth or st.final_batch != MULTI_BATCH:
            raise AssertionError(f"depth {st.final_pipeline_depth}, batch "
                                 f"{st.final_batch}")
        if rows is None:
            rows = res.dist
            if not np.array_equal(rows[at_phase3], rmat_rows):
                raise AssertionError("multi-batch rows differ from phase 3's")
            oracle = csgraph.dijkstra(rmat.to_scipy().astype(np.float64),
                                      directed=True, indices=sources[check])
            np.testing.assert_array_equal(np.isinf(rows[check]),
                                          np.isinf(oracle))
            np.testing.assert_allclose(rows[check], oracle, rtol=1e-5)
        elif not np.array_equal(res.dist, rows):
            raise AssertionError(f"run {run} (depth {depth}) rows differ "
                                 "from run 0 (depth 1)")
        runs.append({
            "run": run, "depth": depth, "seconds": secs,
            "fanout_s": st.phase_seconds["fanout"],
            "upload_s": st.phase_seconds["upload"],
            "download_s": st.download_s, "ckpt_wait_s": st.ckpt_wait_s,
            "overlap_saved_s": st.overlap_saved_s,
            "final_pipeline_depth": st.final_pipeline_depth,
            "clear_caches": solver.backend.clears,
            "suggested_batch_after": probe.suggested_source_batch(dg),
            "free_GB_after": torch.cuda.mem_get_info(dev)[0] / 1e9,
            "reserved_GB_after": torch.cuda.memory_reserved(dev) / 1e9,
            "sweeps": st.iterations_by_phase["fanout"],
            "launches": launches[f"multi_batch_depth{depth}_run{run}"]})
        del res
    # One layout rebuild (what each batch pays after the download's clear).
    rebuild_s = []
    for _ in range(3):
        probe.clear_caches(dg)
        rebuild_s.append(sync_time(dg.fanout_layout)[1])
    del dg
    row_bytes = 4 * v * len(sources)
    emit({"phase": "multi_batch_rmat20", "spec": RMAT_SPEC,
          "sources": len(sources), "source_batch_size": MULTI_BATCH,
          "row_GB": row_bytes / 1e9, "runs": runs,
          "rows_equal_across_runs": True, "rows_equal_phase3": True,
          "checked_rows": check, "layout_rebuild_s": rebuild_s,
          "suggested_batch_before": suggested_before,
          "free_GB_before": free_before / 1e9,
          "depth1_download_GB_s": [row_bytes / r["download_s"] / 1e9
                                   for r in runs if r["depth"] == 1]})

    # -- phase 10: solve_reduced, no [B, V] block reaches the host -----------
    reduced = {}
    for name in ("reach_count", "eccentricity", "checksum"):
        solver = solver_with(source_batch_size=MULTI_BATCH)
        downloads = []
        download_rows = solver._download_rows

        def counting_download(*args, _inner=download_rows):
            downloads.append(1)
            return _inner(*args)

        solver._download_rows = counting_download
        red, secs = counted(
            f"solve_reduced_{name}",
            lambda: solver.solve_reduced(rmat, sources, reduce_rows=name),
            needs=("fanout_sweep",))
        if downloads:
            raise AssertionError(f"solve_reduced({name}) downloaded rows")
        fn = _ROW_REDUCERS[name]
        want = [fn(rows[k:k + MULTI_BATCH], None)
                for k in range(0, len(sources), MULTI_BATCH)]
        if len(red.values) != len(want):
            raise AssertionError(f"{name}: {len(red.values)} values")
        for got, exp in zip(red.values, want):
            if name == "checksum":
                np.testing.assert_allclose(got, exp, rtol=1e-6)
            elif not np.array_equal(np.asarray(got), exp):
                raise AssertionError(f"solve_reduced({name}) disagrees with "
                                     "phase 9's rows")
        reduced[name] = {"seconds": secs,
                         "fanout_s": red.stats.phase_seconds["fanout"],
                         "download_rows_calls": len(downloads),
                         "launches": launches[f"solve_reduced_{name}"]}
    emit({"phase": "solve_reduced_rmat20", "sources": len(sources),
          "reducers": reduced, "checksum_rtol": 1e-6})
    del rows

    # -- phase 11: checkpoint / resume / injected OOM on the grid ------------
    gsrc = np.sort(np.random.default_rng(11).choice(
        grid.num_nodes, CKPT_SOURCES, replace=False))
    n_batches = -(-CKPT_SOURCES // CKPT_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        first_dir, fault_dir = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        kw = dict(source_batch_size=CKPT_BATCH, pipeline_depth=2)
        first, s_first = counted(
            "checkpoint_write",
            lambda: solver_with(checkpoint_dir=first_dir, **kw).solve(
                grid, gsrc), needs=("fanout_sweep",))
        done = BatchCheckpointer(first_dir, graph_key=grid).completed_batches()
        if done != list(range(n_batches)) or first.stats.batches_resumed:
            raise AssertionError(f"first checkpointed run wrote {done}")
        again, s_again = counted(
            "checkpoint_resume",
            lambda: solver_with(checkpoint_dir=first_dir, **kw).solve(
                grid, gsrc))
        if again.stats.batches_resumed != n_batches:
            raise AssertionError(f"resumed {again.stats.batches_resumed} of "
                                 f"{n_batches} batches")
        plan = pjt.FaultPlan([pjt.Fault(stage="fanout", kind="oom", batch=1)])
        faulted, s_fault = counted(
            "checkpoint_injected_oom",
            lambda: solver_with(checkpoint_dir=fault_dir, fault_plan=plan,
                                **kw).solve(grid, gsrc),
            needs=("fanout_sweep",))
        if faulted.stats.final_pipeline_depth != 1:
            raise AssertionError("the injected OOM did not collapse the "
                                 "window")
        plain, _ = counted("checkpoint_plain_solve",
                           lambda: solver_with(**kw).solve(grid, gsrc),
                           needs=("fanout_sweep",))
        for label, other in (("resumed", again), ("injected OOM", faulted),
                             ("uncheckpointed", plain)):
            if not np.array_equal(to_numpy(other.dist), first.dist):
                raise AssertionError(f"the {label} run's rows differ")
        emit({"phase": "checkpoint_grid512", "spec": GRID_SPEC,
              "sources": CKPT_SOURCES, "source_batch_size": CKPT_BATCH,
              "batches_written": len(done),
              "batches_resumed": again.stats.batches_resumed,
              "seconds": {"write": s_first, "resume": s_again,
                          "injected_oom": s_fault},
              "write_run": {"fanout_s": first.stats.phase_seconds["fanout"],
                            "download_s": first.stats.download_s,
                            "ckpt_wait_s": first.stats.ckpt_wait_s,
                            "overlap_saved_s": first.stats.overlap_saved_s},
              "injected_oom": {"fired": [list(f) for f in plan.fired],
                               "final_pipeline_depth":
                                   faulted.stats.final_pipeline_depth,
                               "oom_degradations":
                                   faulted.stats.oom_degradations},
              "rows_equal": True})
        del first, again, faulted, plain

    # -- phase 12: sssp, multi_source, solve_batch ---------------------------
    solver = solver_with()
    res, s_sssp = counted("sssp_grid", lambda: solver.sssp(grid, grid_source))
    got = to_numpy(res.dist)[0]
    np.testing.assert_array_equal(np.isinf(got), np.isinf(grid_row))
    np.testing.assert_allclose(got, grid_row, rtol=1e-5, atol=1e-3)
    sssp_err = float(np.abs(np.where(np.isfinite(got), got - grid_row, 0)).max())
    try:
        solver.sssp(cycle_graph, 0)
    except pjt.NegativeCycleError:
        pass
    else:
        raise AssertionError("sssp missed the negative cycle")
    res, s_ms = counted("multi_source_rmat20",
                        lambda: solver.multi_source(rmat, rmat_sources),
                        needs=("fanout_sweep",))
    if (not isinstance(res.dist, torch.Tensor)
            or res.dist.device.type != dev.type):
        raise AssertionError("multi_source's single batch left the card")
    if not np.array_equal(to_numpy(res.dist), rmat_rows):
        raise AssertionError("multi_source rows differ from phase 3's")
    del res
    graphs = [pjt.load_graph(f"{BATCH_SPEC},seed={seed}") for seed in range(4)]
    batch, s_batch = counted("solve_batch_er256",
                             lambda: solver.solve_batch(graphs),
                             needs=("fanout_sweep",))
    # The same Jacobi sweeps one graph at a time: pallas-vm (these dense
    # graphs would take fw, which associates path sums differently).
    sparse = solver_on(dev, fw=False, dense_threshold=0)
    routes = []
    for g, r in zip(graphs, batch):
        single = sparse.solve(g)
        routes.append(r.stats.routes_by_phase["batch_apsp"])
        if routes[-1] != "batch-vmapped":
            raise AssertionError(f"solve_batch took route {routes[-1]}")
        if single.stats.routes_by_phase["fanout"] != "pallas-vm":
            raise AssertionError("the per-graph solve left pallas-vm")
        if not np.array_equal(to_numpy(r.dist), to_numpy(single.dist)):
            raise AssertionError("solve_batch differs from solve()")
    emit({"phase": "entry_points", "sssp": {
              "spec": GRID_SPEC, "source": int(grid_source),
              "seconds": s_sssp, "max_abs_err_vs_phase4": sssp_err,
              "rtol": 1e-5, "atol": 1e-3,
              "negative_cycle": "NegativeCycleError"},
          "multi_source": {"spec": RMAT_SPEC, "sources": len(rmat_sources),
                           "seconds": s_ms, "rows_equal_phase3": True},
          "solve_batch": {"spec": BATCH_SPEC, "graphs": len(graphs),
                          "seconds": s_batch, "routes": routes,
                          "equal_to_solve": True},
          "launches": {k: launches[k] for k in ("sssp_grid",
                                                "multi_source_rmat20",
                                                "solve_batch_er256")}})
    return launches


def drive_pred_paths(dev, rmat, rmat_sources, rmat_rows, grid, gsrc,
                     grid_rows, er, er_matrix) -> dict:
    """Phase 13: ``predecessors=True`` solves on ``dev``, each path counted
    from 0 (returns the counts by path): R-MAT-20 over phase 3's sources
    and the grid over phase 4's (rows bitwise equal to theirs), ``sssp``
    on the grid, the zero-weight tight cycle (``pred-sweep`` with a
    warning), a checkpointed 2-batch solve resumed, and ER-1024 (dense).
    Every tree passes ``validate_pred_tree`` (sampled rows on the large
    graphs)."""
    import tempfile
    import warnings

    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

    launches = {}
    counted = counter(launches)
    report = {}

    def check(label, graph, res, route, rows=None, want_rows=None):
        """Route, rows against ``want_rows`` (bitwise), and the trees of
        ``rows`` (all when None) validated against their own rows."""
        got_route = res.stats.routes_by_phase[
            "fanout" if "fanout" in res.stats.routes_by_phase
            else "bellman_ford"]
        # (A multi-batch solve lists its route once per batch: the
        # stats join distinct "+"-parts only.)
        if set(got_route.split("+")) != set(route.split("+")):
            raise AssertionError(f"{label} took route {got_route}")
        dist, pred = to_numpy(res.dist), to_numpy(res.predecessors)
        if want_rows is not None and not np.array_equal(
                dist[:len(want_rows)], want_rows):
            raise AssertionError(f"{label}: rows differ from the plain solve")
        sel = slice(None) if rows is None else rows
        validate_pred_tree(graph, dist[sel], pred[sel], res.sources[sel])
        report[label] = {
            "route": got_route, "rows": int(dist.shape[0]),
            "validated_rows": "all" if rows is None else list(rows),
            "fanout_s": res.stats.phase_seconds.get("fanout"),
            "iterations": dict(res.stats.iterations_by_phase),
            "launches": launches[label]}

    pred_kernels = ("fanout_sweep", "tight_pred")
    res, s_rmat = counted("pred_rmat20", lambda: solver_on(dev).solve(
        rmat, rmat_sources, predecessors=True), needs=pred_kernels)
    check("pred_rmat20", rmat, res, "pallas-vm+pred", [0, 255, 511],
          rmat_rows)
    report["pred_rmat20"]["seconds"] = s_rmat
    del res
    res, _ = counted("pred_grid512", lambda: solver_on(dev).solve(
        grid, gsrc, predecessors=True), needs=pred_kernels)
    check("pred_grid512", grid, res, "pallas-vm+pred", [0, 255], grid_rows)
    del res
    res, _ = counted("pred_sssp_grid512", lambda: solver_on(dev).sssp(
        grid, gsrc[0], predecessors=True), needs=("tight_pred",))
    check("pred_sssp_grid512", grid, res, "frontier+pred")
    zero = pjt.CSRGraph.from_edges([0, 3, 1, 2], [3, 1, 2, 1],
                                   [1.0, 0.0, 0.0, 0.0], 4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res, _ = counted("pred_zero_cycle", lambda: solver_on(dev).multi_source(
            zero, [0], predecessors=True), needs=("tight_pred",))
    if not any("fell back" in str(w.message) for w in caught):
        raise AssertionError("the zero-weight tight cycle did not warn")
    check("pred_zero_cycle", zero, res, "pred-sweep")
    small = pjt.load_graph(PRED_CKPT_SPEC)
    ssrc = np.arange(0, small.num_nodes, small.num_nodes // 256)[:256]
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(source_batch_size=128, checkpoint_dir=tmp)
        first, _ = counted("pred_checkpoint_write", lambda: solver_on(
            dev, **kw).solve(small, ssrc, predecessors=True),
            needs=pred_kernels)
        again, _ = counted("pred_checkpoint_resume", lambda: solver_on(
            dev, **kw).solve(small, ssrc, predecessors=True))
    if (first.stats.batches_resumed, again.stats.batches_resumed) != (0, 2):
        raise AssertionError("the checkpointed pred solve did not resume")
    for name in ("dist", "predecessors"):
        if not np.array_equal(getattr(first, name), getattr(again, name)):
            raise AssertionError(f"resumed {name} differ")
    check("pred_checkpoint_write", small, first, "pallas-vm+pred")
    report["pred_checkpoint_write"]["batches_resumed_after"] = 2
    res, _ = counted("pred_er1024", lambda: solver_on(dev, fw=False).solve(
        er, predecessors=True), needs=("minplus", "tight_pred"))
    check("pred_er1024", er, res, "dense-squaring-pallas+pred", None,
          er_matrix)
    del res
    emit({"phase": "pred_solves", "paths": report,
          "zero_cycle_warning": True})
    return launches


def drive_xla_routes(dev, rmat, rmat_sources, rmat_rows, grid, gsrc,
                     grid_rows, er, er_matrix) -> dict:
    """Phase 14: the JAX package's XLA routes in plain PyTorch on ``dev``,
    each beside the hand route on the same sources, rows bitwise equal:
    ``vm-blocked`` on R-MAT-20 (B = 128) and on the grid (B = 64),
    ``sweep-sm`` on R-MAT-16, XLA ``dense-squaring`` on ER-1024. Prints
    each route's fan-out seconds and seconds per sweep."""
    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy

    launches = {}
    counted = counter(launches)
    routes = {}

    def both(label, graph, sources, kw, want_route, want_rows=None,
             pin=None):
        """The hand route and the XLA route (``kw``), each with ``pin``."""
        pin = pin or {}
        hand, s_hand = counted(f"{label}_hand", lambda: solver_on(
            dev, **pin).solve(graph, sources))
        xla, s_xla = counted(label, lambda: solver_on(dev, **kw, **pin).solve(
            graph, sources))
        got = xla.stats.routes_by_phase["fanout"]
        if got != want_route:
            raise AssertionError(f"{label} took route {got}")
        rows = to_numpy(xla.dist)
        if not np.array_equal(rows, to_numpy(hand.dist)):
            raise AssertionError(f"{label}: rows differ from the hand route")
        if want_rows is not None and not np.array_equal(rows, want_rows):
            raise AssertionError(f"{label}: rows differ from the main path")
        entry = {"route": got, "hand_route": hand.stats.routes_by_phase[
            "fanout"], "sources": len(rows), "seconds": s_xla,
                 "hand_seconds": s_hand}
        for name, r in (("", xla), ("hand_", hand)):
            fan = r.stats.phase_seconds["fanout"]
            sweeps = r.stats.iterations_by_phase["fanout"]
            entry[f"{name}fanout_s"] = fan
            entry[f"{name}sweeps"] = sweeps
            entry[f"{name}s_per_sweep"] = fan / max(sweeps, 1)
        routes[label] = entry

    both("xla_vm_blocked_rmat20", rmat, rmat_sources[:128],
         {"use_pallas": False}, "vm-blocked", rmat_rows[:128])
    both("xla_vm_blocked_grid512", grid, gsrc[:64], {"use_pallas": False},
         "vm-blocked", grid_rows)
    sm = pjt.load_graph(SWEEP_SM_SPEC)
    both("xla_sweep_sm_rmat16", sm, np.arange(0, sm.num_nodes, 1024),
         {"fanout_layout": "source_major"}, "sweep-sm")
    both("xla_dense_er1024", er, np.arange(er.num_nodes),
         {"use_pallas": False}, "dense-squaring", er_matrix, {"fw": False})
    emit({"phase": "xla_routes", "routes": routes})
    return launches


def drive_b1_routes(dev, grid, gsrc, grid_rows, grid_solve_stats,
                    cycle_graph) -> dict:
    """Phase 15: the B=1 routes on ``dev`` (the card), each path counted
    from 0 (returns the counts by path). ``grid_rows`` are the default
    grid solve's first 64 rows over ``gsrc[:64]`` and ``grid_solve_stats``
    its stats (phase 4).

    ``sssp`` from ``gsrc[0]`` on ``sweep`` (``frontier=False``),
    ``frontier`` (the default config), ``dia``, ``gs`` and ``bucket``
    (forced): rows bitwise equal to ``sweep``'s; the first call (upload
    and layouts included) and a second ``bellman_ford`` on the same
    device graph, each on the host clock; ``frontier+pred`` and
    ``dia+pred`` trees validated; the negative cycle raised on each
    forced route; the default solve's phase-1 seconds (phase 4's, and a
    warm rerun) beside a ``frontier=False`` solve's; the ``dia`` and
    ``gs`` fan-outs at
    B = 64 beside ``pallas-vm``'s rows; a ``convergence=True``
    ``use_pallas=False`` solve's trajectory summary."""
    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree

    launches = {}
    counted = counter(launches)
    src = int(gsrc[0])
    routes = {"sweep": {"frontier": False}, "frontier": {},
              "dia": {"dia": True}, "gs": {"gauss_seidel": True},
              "bucket": {"bucket": True}}
    report, sweep_row = {}, None
    for name, kw in routes.items():
        res, first_s = counted(f"sssp_{name}", lambda: solver_on(
            dev, **kw).sssp(grid, src))
        tag = res.stats.routes_by_phase["bellman_ford"]
        if tag != name:
            raise AssertionError(f"sssp with {kw} took route {tag}")
        row = to_numpy(res.dist)[0]
        if sweep_row is None:
            sweep_row = row
        elif not np.array_equal(row, sweep_row):
            raise AssertionError(f"sssp on {name}: row differs from sweep's")
        backend = solver_on(dev, **kw).backend
        dgraph = backend.upload(grid)
        backend.bellman_ford(dgraph, src)  # builds the route's layouts
        again, bf_s = counted(f"sssp_{name}_again",
                              lambda: backend.bellman_ford(dgraph, src))
        if not np.array_equal(to_numpy(again.dist), sweep_row):
            raise AssertionError(f"{name}: second run differs")
        reads = {k: v for k, v in launches[f"sssp_{name}_again"].items()
                 if k.endswith("host_reads") and v}
        report[name] = {
            "first_s": first_s, "bf_s": bf_s,
            "iterations": again.iterations,
            "edges_relaxed": again.edges_relaxed,
            "host_reads": reads,
            "s_per_iteration": bf_s / max(again.iterations, 1)}
        del backend, dgraph, again
    pred = {}
    for name in ("frontier", "dia"):
        res, secs = counted(f"sssp_{name}_pred", lambda: solver_on(
            dev, **routes[name]).sssp(grid, src, predecessors=True),
            needs=("tight_pred",))
        tag = res.stats.routes_by_phase["bellman_ford"]
        if tag != f"{name}+pred":
            raise AssertionError(f"pred sssp took route {tag}")
        dist = to_numpy(res.dist)
        if not np.array_equal(dist[0], sweep_row):
            raise AssertionError(f"{name}+pred: row differs from sweep's")
        validate_pred_tree(grid, dist, to_numpy(res.predecessors),
                           res.sources)
        pred[name] = {"route": tag, "seconds": secs, "validated": True,
                      "tight_pred": launches[f"sssp_{name}_pred"][
                          "tight_pred"]}
    cycle = {}
    for name in ("frontier", "dia", "gs", "bucket"):
        try:
            solver_on(dev, **{**routes[name], "frontier": name == "frontier"}
                      ).sssp(cycle_graph, 0)
        except pjt.NegativeCycleError:
            cycle[name] = "NegativeCycleError"
        else:
            raise AssertionError(f"{name} missed the negative cycle")
    # The default grid solve (phase 4) against the same on sweep.
    tags = dict(grid_solve_stats.routes_by_phase)
    if tags != {"bellman_ford": "frontier", "fanout": "pallas-vm"}:
        raise AssertionError(f"default grid solve took {tags}")
    default = {"routes": tags, "phase4_bellman_ford_s":
               grid_solve_stats.phase_seconds["bellman_ford"]}
    # Warm, in turns: the default (frontier) solve, then frontier=False.
    for name, kw in (("frontier", {}), ("sweep", {"frontier": False})):
        res, secs = counted(f"solve_grid512_{name}", lambda: solver_on(
            dev, **kw).solve(grid, gsrc), needs=("fanout_sweep",))
        if res.stats.routes_by_phase != {"bellman_ford": name,
                                         "fanout": "pallas-vm"}:
            raise AssertionError(f"grid solve with {kw} took "
                                 f"{res.stats.routes_by_phase}")
        if not np.array_equal(to_numpy(res.dist)[:64], grid_rows):
            raise AssertionError(f"grid solve with {kw}: rows differ")
        default[name] = {
            "solve_s": secs,
            "bellman_ford_s": res.stats.phase_seconds["bellman_ford"],
            "bellman_ford_iterations":
                res.stats.iterations_by_phase["bellman_ford"],
            "fanout_s": res.stats.phase_seconds["fanout"]}
        del res
    fanout = {}
    for name in ("dia", "gs"):
        res, secs = counted(f"fanout_{name}_grid512", lambda: solver_on(
            dev, **routes[name]).solve(grid, gsrc[:64]))
        if res.stats.routes_by_phase != {"bellman_ford": name,
                                         "fanout": name}:
            raise AssertionError(f"{name} solve took "
                                 f"{res.stats.routes_by_phase}")
        if not np.array_equal(to_numpy(res.dist), grid_rows):
            raise AssertionError(f"{name} fan-out rows differ from "
                                 "pallas-vm's")
        fan = res.stats.phase_seconds["fanout"]
        sweeps = res.stats.iterations_by_phase["fanout"]
        fanout[name] = {"sources": 64, "seconds": secs, "fanout_s": fan,
                        "iterations": sweeps,
                        "s_per_iteration": fan / max(sweeps, 1),
                        "bellman_ford_s": res.stats.phase_seconds[
                            "bellman_ford"],
                        "host_reads": {k: v for k, v in launches[
                            f"fanout_{name}_grid512"].items()
                            if k.endswith("host_reads") and v}}
        del res
    res, secs = counted("trajectory_grid512", lambda: solver_on(
        dev, use_pallas=False, convergence=True).solve(grid, gsrc[:4]))
    conv = res.stats.convergence or {}
    if set(conv) != {"fanout"} or (
            conv["fanout"]["iterations"]
            != res.stats.iterations_by_phase["fanout"]):
        raise AssertionError(f"trajectory: {sorted(conv)}")
    if not np.array_equal(to_numpy(res.dist), grid_rows[:4]):
        raise AssertionError("trajectory solve rows differ")
    trajectory = {"routes": dict(res.stats.routes_by_phase), "seconds": secs,
                  "keys": sorted(conv),
                  "fanout": {k: conv["fanout"][k] for k in (
                      "iterations", "frontier_peak", "frontier_half_life",
                      "tail_iterations", "jfr_skippable_edge_frac",
                      "relaxations_total")}}
    emit({"phase": "b1_routes", "spec": GRID_SPEC, "source": src,
          "sssp": report, "pred": pred, "negative_cycle": cycle,
          "default_solve": default, "fanout_B64": fanout,
          "trajectory": trajectory})
    return launches


def drive_dense_apsp(dev, er, er_matrix) -> tuple[dict, dict]:
    """Phase 16: dense APSP on ``dev``, each path counted from 0. Returns
    (launches by path, the ``fw_kleene`` kernel's row data)."""
    import numpy as np
    import scipy.sparse.csgraph as csgraph
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.graphs import random_graph_batch
    from paralleljohnson_tpu_torch.ops import fw
    from paralleljohnson_tpu_torch.ops.minplus import minplus_kernel
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.paths import validate_pred_tree
    from test_torch_cuda import fw_tile_matrix

    launches = {}
    counted = counter(launches)
    out = {}
    t_phase = time.perf_counter()

    # The Kleene kernel against tile_kleene, bitwise, on the variant
    # kleene_plan names: one cluster launch up to t = 512, the step kernel
    # at KLEENE_STEP_T. Each tile also with a diagonal that goes negative
    # in its last two steps, where row and column k change during step k
    # (read-before-write).
    checks, errs = [], []
    for t in (128, 256, 384, 512, KLEENE_STEP_T):
        for neg in (False, True):
            m = torch.as_tensor(fw_tile_matrix(t, t, negative_diagonal=neg)
                                ).to(dev)
            got, want = fw.fw_kleene(m), fw.tile_kleene(m)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            checks.append({"t": t, "variant": fw.kleene_plan(t).variant,
                           "negative_diagonal": neg,
                           "equal": torch.equal(got, want),
                           "max_abs_err": err})
            if not checks[-1]["equal"]:
                raise AssertionError(f"fw_kleene disagrees with plain: "
                                     f"{checks[-1]}")
            errs.append(err)
    plan = fw.kleene_plan(fw.DEFAULT_FW_TILE)
    occupancy = fw.cluster_occupancy(plan, torch.cuda.current_device())
    emit({"phase": "fw_kleene_plan", "t": fw.DEFAULT_FW_TILE,
          "plan": plan._asdict(), "clusters_on_card": occupancy})
    if occupancy < 1:
        raise AssertionError(f"the card holds no Kleene cluster: {plan}")
    # Times of each variant at its t, with the scratch its plan asks for
    # (none on the cluster variant: the path the solve takes).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    variants = {}
    for t in (fw.DEFAULT_FW_TILE, KLEENE_STEP_T):
        plan = fw.kleene_plan(t)
        m = torch.as_tensor(fw_tile_matrix(t, t)).to(dev)
        dst = torch.empty((t, t), device=dev)
        scratch = (torch.empty((2, t, t), device=dev)
                   if plan.variant == "step" else None)
        kleene = lambda: fw.fw_kleene(m, out=dst, scratch=scratch)
        bms, by = bound(8 * t * t, 2 * t ** 3)
        variants[plan.variant] = {
            "t": t, "ms": event_ms(kleene, reps=20),
            "card_ms": graph_ms(kleene, reps=5),
            "plain_ms": event_ms(lambda: fw.tile_kleene(m), reps=2),
            "bound_ms": bms, "bound_by": by, "plan": plan._asdict()}
        if plan.variant == "cluster":
            # The cluster's own floor: 2 t^3 FP32 instructions on its
            # share of the card's SMs.
            variants[plan.variant]["cluster_floor_ms"] = (
                2 * t ** 3 / (PEAK_F32_INSTR_S * plan.cluster / sms) * 1e3)
            variants[plan.variant]["sms"] = sms
        del m, dst, scratch
    timing = variants["cluster"]

    # 16a: dense FW at the reference's full width, in turns with the
    # squaring and pallas-vm routes on the same graph.
    g = pjt.load_graph(FW_SPEC)
    g = g.with_weights(np.random.default_rng(22).integers(
        1, 10, g.num_real_edges).astype(np.float32))
    v = g.num_nodes
    runs = {"fw": ({}, "fw-tile", ("minplus", "fw_kleene")),
            "squaring": ({"fw": False, "dense_threshold": v,
                          "dense_min_density": 0}, "dense-squaring-pallas",
                         ("minplus",)),
            "pallas_vm": ({"fw": False}, "pallas-vm", ("fanout_sweep",))}
    walls = {name: [] for name in runs}
    rows, counts = {}, {}
    for rep in range(2):
        for name, (kw, want_route, needs) in runs.items():
            res, secs = counted(f"fw_er2048_{name}", lambda: solver_on(
                dev, **kw).solve(g), needs=needs)
            route = res.stats.routes_by_phase["fanout"]
            if route != want_route:
                raise AssertionError(f"er2048 {name} took route {route}")
            walls[name].append(secs)
            rows[name] = to_numpy(res.dist)
            counts[name] = {"route": route,
                            "iterations": res.stats.iterations_by_phase[
                                "fanout"],
                            "edges_relaxed": res.stats.edges_relaxed}
        for name in ("squaring", "pallas_vm"):
            if not np.array_equal(rows[name], rows["fw"]):
                raise AssertionError(f"er2048: fw rows differ from {name}'s")
    tile = fw.effective_tile(v, fw.DEFAULT_FW_TILE)
    vp = fw.pad_tiles(v, tile)
    shapes = {"row_panel": (tile, tile, vp), "col_panel": (vp, tile, tile),
              "trailing": (vp, tile, vp)}
    products = {}
    rng = np.random.default_rng(5)
    for name, (i, k, j) in shapes.items():
        dm = torch.as_tensor(rng.random((i, k), dtype=np.float32)).to(dev)
        am = torch.as_tensor(rng.random((k, j), dtype=np.float32)).to(dev)
        pms, pby = minplus_bound(i, k, j)
        products[name] = {"shape": [i, k, j],
                          "card_ms": graph_ms(lambda: minplus_kernel(dm, am),
                                              reps=10),
                          "bound_ms": pms, "bound_by": pby}
    a = fw.pad_dense(torch.full((v, v), float("inf"), device=dev), tile)
    a.fill_diagonal_(0.0)
    closure_ms = event_ms(lambda: fw.fw_closure(a, tile=tile), reps=3)
    kstep_card_ms = sum(p["card_ms"] for p in products.values())
    out["fw_er2048"] = {
        "spec": FW_SPEC, "V": v, "E": g.num_real_edges, "sources": v,
        "walls_s": walls, "routes": counts, "rows_bitwise_equal": True,
        "tile": tile,
        "ksteps": vp // tile, "fw_macs": fw.fw_mac_count(vp, tile),
        "closure_ms": closure_ms,
        "kleene_card_ms_per_closure": timing["card_ms"],
        "products_card_ms_per_kstep": kstep_card_ms,
        "products_bound_ms_per_kstep": sum(p["bound_ms"]
                                           for p in products.values()),
        "products": products,
        "launches": {name: launches[f"fw_er2048_{name}"] for name in runs}}
    emit({"phase": "dense_fw_er2048", **out["fw_er2048"]})
    del rows, a

    # 16b: the Queue 3 graph at default config, then with predecessors.
    res, secs = counted("fw_er1024", lambda: solver_on(dev).solve(er),
                        needs=("minplus", "fw_kleene"))
    if res.stats.routes_by_phase["fanout"] != "fw-tile":
        raise AssertionError(f"er1024 default took {res.stats.routes_by_phase}")
    oracle = csgraph.dijkstra(er.to_scipy().astype(np.float64), directed=True)
    np.testing.assert_allclose(res.matrix, oracle, rtol=1e-5)
    got = to_numpy(res.dist)
    np.testing.assert_allclose(got, er_matrix, rtol=1e-6)
    differ = int((got != er_matrix).sum())
    pres, psecs = counted("fw_er1024_pred", lambda: solver_on(dev).solve(
        er, predecessors=True), needs=("fw_kleene", "tight_pred"))
    if pres.stats.routes_by_phase["fanout"] != "fw-tile+pred":
        raise AssertionError(f"er1024 pred took {pres.stats.routes_by_phase}")
    if launches["fw_er1024_pred"]["tight_pred"] != 1:
        raise AssertionError("er1024 pred: not one tight_pred launch")
    if not np.array_equal(to_numpy(pres.dist), got):
        raise AssertionError("er1024 pred rows differ from the plain fw solve")
    validate_pred_tree(er, to_numpy(pres.dist), to_numpy(pres.predecessors),
                       pres.sources)
    out["fw_er1024"] = {"spec": ER_SPEC, "route": "fw-tile", "seconds": secs,
                        "pred_route": "fw-tile+pred", "pred_seconds": psecs,
                        "entries_differing_from_squaring": differ,
                        "rtol_vs_squaring": 1e-6,
                        "iterations": dict(res.stats.iterations_by_phase),
                        "edges_relaxed": res.stats.edges_relaxed,
                        "launches": launches["fw_er1024"],
                        "pred_launches": launches["fw_er1024_pred"]}
    emit({"phase": "dense_fw_er1024", **out["fw_er1024"]})
    del res, pres, got

    # 16c: the condensed route, forced, against the default solve.
    grid = pjt.load_graph(PRED_CKPT_SPEC)
    cond = {}
    for label, gr in (("float", grid),
                      ("int", grid.with_weights(np.round(grid.weights)))):
        std, s_std = counted(f"condensed_{label}_standard",
                             lambda: solver_on(dev).solve(gr))
        res, s_cond = counted(f"condensed_{label}", lambda: solver_on(
            dev, partitioned=True).solve(gr), needs=("minplus", "fw_kleene"))
        if res.stats.routes_by_phase["fanout"] != "condensed+fw":
            raise AssertionError(f"condensed took {res.stats.routes_by_phase}")
        want, have = to_numpy(std.dist), to_numpy(res.dist)
        if label == "int":
            if not np.array_equal(have, want):
                raise AssertionError("condensed rows differ on integer weights")
        else:
            np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-4)
        fin = np.isfinite(want)
        plan = res.stats.plan
        cond[label] = {
            "route": "condensed+fw", "seconds": s_cond,
            "standard_seconds": s_std,
            "standard_routes": dict(std.stats.routes_by_phase),
            "parts": plan["num_parts"], "core_size": plan["core_size"],
            "macs": res.stats.edges_relaxed,
            "k_steps": res.stats.iterations_by_phase["fanout"],
            "stage_seconds": plan["seconds"],
            "max_abs_err_vs_standard": float(np.abs(have[fin] - want[fin]).max()),
            "launches": launches[f"condensed_{label}"]}
    n = grid.num_nodes
    ring = pjt.CSRGraph.from_edges(np.arange(n), (np.arange(n) + 1) % n,
                                   np.r_[np.ones(n - 1), -float(n)], n)
    try:
        solver_on(dev, partitioned=True).solve(ring)
    except pjt.NegativeCycleError as e:
        if "across" not in str(e):
            raise AssertionError(f"ring cycle raised elsewhere: {e}")
    else:
        raise AssertionError("the condensed route missed a cycle across parts")
    out["condensed"] = {"spec": PRED_CKPT_SPEC, "V": n, "sources": n, **cond,
                        "negative_cycle_across_parts": "NegativeCycleError"}
    emit({"phase": "condensed_grid64", **out["condensed"]})

    # 16d: the many-small-graphs config through batch_apsp.
    t0 = time.perf_counter()
    graphs = random_graph_batch(BATCH_APSP_GRAPHS, 256, 8 / 256, seed=0)
    gen_s = time.perf_counter() - t0
    res, s_batch = counted("batch_apsp_10k", lambda: solver_on(
        dev).solve_batch(graphs), needs=("fanout_sweep",))
    st = res[0].stats
    if st.routes_by_phase != {"batch_apsp": "batch-vmapped"}:
        raise AssertionError(f"solve_batch took {st.routes_by_phase}")
    sample = np.sort(np.random.default_rng(6).choice(len(graphs), 64,
                                                     replace=False))
    single = solver_on(dev)
    for i in sample:
        gi, got = graphs[i], to_numpy(res[i].dist)
        oracle = csgraph.johnson(gi.to_scipy().astype(np.float64),
                                 directed=True)
        np.testing.assert_array_equal(np.isinf(got), np.isinf(oracle))
        np.testing.assert_allclose(got, oracle, rtol=1e-6)
        if not np.array_equal(got, to_numpy(single.solve(gi).dist)):
            raise AssertionError(f"batch graph {i} differs from its solve()")
    _, s_loop = counted("per_graph_solve_100", lambda: [
        single.solve(gi).dist for gi in graphs[:100]])
    out["batch_apsp"] = {
        "route": "batch-vmapped", "graphs": len(graphs), "V": 256,
        "p": 8 / 256,
        "edges": int(sum(gi.num_real_edges for gi in graphs)),
        "generate_s": gen_s, "seconds": s_batch,
        "phase_seconds": dict(st.phase_seconds),
        "iterations": st.iterations_by_phase["batch_apsp"],
        "edges_relaxed": st.edges_relaxed, "checked_graphs": len(sample),
        "per_graph_loop_100_s": s_loop,
        "launches": launches["batch_apsp_10k"],
        "phase16_s": time.perf_counter() - t_phase}
    emit({"phase": "batch_apsp_10k", **out["batch_apsp"]})
    del res, graphs

    # The kernels the card ran for one closure of each variant (last in
    # the phase: the profiler runs after every timed part), which must be
    # what kleene_plan says: one cluster launch, or the step kernel's t.
    for row in variants.values():
        t = row["t"]
        m = torch.as_tensor(fw_tile_matrix(t, t)).to(dev)
        row["launches_per_closure"] = device_kernels(
            lambda: fw.fw_kleene(m), "kleene")
        want = 1 if row["plan"]["variant"] == "cluster" else t
        if row["launches_per_closure"] != want:
            raise AssertionError(f"fw_kleene at t={t} ran "
                                 f"{row['launches_per_closure']} kernels, "
                                 f"its plan {want}")
        del m
    emit({"phase": "fw_kleene_vs_plain", "checks": checks,
          "timing": variants})
    return launches, {"errs": errs, "timing": timing, "variants": variants}


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
    from paralleljohnson_tpu_torch.ops import fanout_sweep as fs
    from paralleljohnson_tpu_torch.ops.fanout_sweep import (
        fanout_fixpoint, fanout_sweep, fanout_sweep_plain,
    )
    from paralleljohnson_tpu_torch.ops import minplus as mp_mod
    from paralleljohnson_tpu_torch.ops import relax
    from paralleljohnson_tpu_torch.ops.minplus import (
        minplus_fixpoint, minplus_kernel, minplus_plain, minplus_plan,
    )
    from paralleljohnson_tpu_torch.ops import pred as pred_mod
    from paralleljohnson_tpu_torch.ops.pred import (
        certify_pred, pred_reaches_root, tight_pred_pass,
        tight_pred_pass_plain, tree_flags_plain,
    )
    from paralleljohnson_tpu_torch.solver.johnson import _unreweight, to_numpy

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

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
    occupancy = {f"B{b}": fs.occupancy(b) for b in (128, 256, 512)}
    mp_occupancy = {rows: mp_mod.occupancy(rows) for rows in mp_mod.RESIDENT}
    pred_templates = tight_pred_templates(logs["tight_pred"])
    pred_occupancy = {f"B{b}": pred_mod.occupancy(b) for b in (128, 256, 512)}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "tight_pred_templates": pred_templates,
          "tight_pred_occupancy": pred_occupancy,
          "sweep_occupancy": occupancy,
          "minplus_occupancy": {f"rows{r}": n for r, n in mp_occupancy.items()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": kind})
    low = {k: o for k, o in occupancy.items() if o["blocks_per_sm"] < 2}
    if low:
        raise AssertionError(f"sweep kernel below 2 blocks per SM: {low}")
    low = {r: n for r, n in mp_occupancy.items() if n < mp_mod.RESIDENT[r]}
    if low:
        raise AssertionError(f"min-plus tiles below the plan's resident "
                             f"blocks per SM: {low}")
    # A stack frame is a register array that went to local memory (the
    # Kleene kernel's hazard: an array indexed by the step) even where
    # nothing spills.
    spills = [ln for lines in ptxas.values() for ln in lines
              if any(int(n) for n in re.findall(
                  r"(\d+) bytes (?:stack frame|spill)", ln))]
    if spills:
        raise AssertionError(f"ptxas reports stack frames or spills: {spills}")

    def sweep_equal(d, layout, items, label):
        """The kernel against the plain sweep on ``d``: raises unless
        ``torch.equal`` with the same flag. Returns (largest absolute
        error, flag, the plain sweep's result)."""
        want, imp = fanout_sweep_plain(d, *layout)
        got, flag = fanout_sweep(d, *layout, items=items)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if not torch.equal(got, want) or bool(flag.item()) != bool(imp):
            raise AssertionError(
                f"fanout_sweep disagrees with plain on {label}: max_abs_err "
                f"{err}, flag {bool(flag.item())}, plain flag {bool(imp)}")
        return err, bool(imp), want

    def pred_equal(d, lay, itm, coo, sources, label):
        """tight_pred on the converged ``d`` [V, B] against the plain
        pass over the COO ``coo`` on ``d``'s transpose, without and with
        the column ``sources``: raises unless the trees are ``torch.equal``
        and, with the sources, the masked trees and the flags equal
        ``tree_flags_plain``'s. Returns (largest absolute difference of
        the int32 trees, share of entries with a tight in-edge, flags)."""
        got = tight_pred_pass(d, *lay, items=itm)
        got_s, flags = tight_pred_pass(d, *lay, items=itm, sources=sources)
        dt = d.t().contiguous()
        plain = tight_pred_pass_plain(dt, *coo)
        want_s, want_flags = tree_flags_plain(plain, dt, sources)
        want = plain.t()
        torch.cuda.synchronize()
        err = max(float((got.long() - want.long()).abs().max()),
                  float((got_s.t().long() - want_s.long()).abs().max()))
        if not (torch.equal(got, want) and torch.equal(got_s.t(), want_s)
                and torch.equal(flags, want_flags)):
            raise AssertionError(
                f"tight_pred disagrees with plain on {label}: max_abs_err "
                f"{err}, flags {flags.tolist()}, plain {want_flags.tolist()}")
        del dt, plain, want_s
        return err, float((got >= 0).float().mean()), flags.tolist()

    # -- phase 2: each kernel against its plain version ---------------------
    t0 = time.perf_counter()
    rmat = pjt.load_graph(RMAT_SPEC)
    gen_s = time.perf_counter() - t0
    v, e = rmat.num_nodes, rmat.num_real_edges
    layout_graph = TorchBackend(pjt.SolverConfig(), device=dev).upload(rmat)
    layout = layout_graph.by_dst()
    items = layout_graph.work_items()
    rng = np.random.default_rng(0)
    sweep_states, sweep_sources = {}, {}
    sweep_checks = []
    for b in (128, 512):
        src = torch.as_tensor(rng.choice(v, b, replace=False)).to(dev)
        sweep_sources[b] = src
        d = torch.full((v, b), float("inf"), device=dev)
        d[src, torch.arange(b, device=dev)] = 0.0
        for _ in range(3):  # a block with finite values to fold
            d, _ = fanout_sweep_plain(d, *layout)
        err, flag, _ = sweep_equal(d, layout, items, f"RMAT-20 B={b}")
        sweep_checks.append({"graph": "rmat20", "B": b, "equal": True,
                             "max_abs_err": err, "flag": flag})
        sweep_states[b] = (d, err)
    # tight_pred on R-MAT-20's converged fan-out (its split hub rows
    # included), B = 128 and 512; the states stay for phase 8's times.
    rmat_coo = (layout_graph.src[:e], layout_graph.dst[:e],
                layout_graph.weights[:e])
    pred_states, pred_checks = {}, []
    for b, (d, _) in sweep_states.items():
        conv, sweeps, _ = fanout_fixpoint(d.clone(), *layout, max_iter=v,
                                          items=items)
        err, tight, flags = pred_equal(conv, layout, items, rmat_coo,
                                       sweep_sources[b], f"RMAT-20 B={b}")
        if flags != [0, 0]:  # weights in [1, 10): every tree descends
            raise AssertionError(f"RMAT-20 B={b} raised tree flags {flags}")
        pred_checks.append({"graph": "rmat20", "B": b, "equal": True,
                            "max_abs_err": err, "tight_share": tight,
                            "flags": flags, "sweeps_to_fixpoint": sweeps})
        pred_states[b] = conv
    # The hub graph of the card tests (JAX-free), on R-MAT-16.
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from test_torch_cuda import hub_graph

    hub = hub_graph(pjt.load_graph("rmat:scale=16,ef=8,seed=2"),
                    fs.ITEM_EDGES, inf_frac=0.3)
    hub_layout_graph = TorchBackend(pjt.SolverConfig(), device=dev).upload(hub)
    hub_layout = hub_layout_graph.by_dst()
    hub_items = hub_layout_graph.work_items()
    hub_rng = np.random.default_rng(3)
    hub_errs = []
    for b in (1, 5, 128, 200, 512):
        src = torch.as_tensor(hub_rng.integers(0, hub.num_nodes, b)).to(dev)
        d = torch.full((hub.num_nodes, b), float("inf"), device=dev)
        d[src, torch.arange(b, device=dev)] = 0.0
        for _ in range(3):
            d, _ = fanout_sweep_plain(d, *hub_layout)
        err, flag, _ = sweep_equal(d, hub_layout, hub_items,
                                   f"the hub graph B={b}")
        sweep_checks.append({"graph": "hub", "B": b, "equal": True,
                             "max_abs_err": err, "flag": flag})
        hub_errs.append(err)
    mp_checks = []
    mp_err = {}
    mp_cases = [(i, 1024, 1024, "") for i in (1, 16, 100, 128, 511, 1024)]
    mp_cases += [(1000, 777, 513, ""), (300, 400, 200, "inf_rows"),
                 (1024, 1024, 1024, "negative"), (512, 512, 512, "negative"),
                 (1024, 1024, 1024, "d_is_a"), (300, 300, 300, "d_is_a")]
    for (i, k, j, case) in mp_cases:
        g_rng = np.random.default_rng(i + k + j + len(case))
        dm = torch.as_tensor(g_rng.random((i, k), dtype=np.float32) * 10)
        am = torch.as_tensor(g_rng.random((k, j), dtype=np.float32) * 10)
        dm[torch.as_tensor(g_rng.random((i, k)) < 0.3)] = float("inf")
        am[torch.as_tensor(g_rng.random((k, j)) < 0.3)] = float("inf")
        if case == "inf_rows":
            dm[::3] = float("inf")
        if case == "negative":  # negative finite entries in both operands
            dm[torch.as_tensor(g_rng.random((i, k)) < 0.3) & dm.isfinite()] *= -1
            am[torch.as_tensor(g_rng.random((k, j)) < 0.3) & am.isfinite()] *= -1
        dm, am = dm.to(dev), am.to(dev)
        if case == "d_is_a":
            dm.fill_diagonal_(0.0)
            am = dm
        got = minplus_kernel(dm, am)
        want = minplus_plain(dm, am)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = max_abs_err(got, want)
        p = minplus_plan(i, k, j)
        mp_checks.append({"shape": [i, k, j], "case": case,
                          "tile_rows": p.rows, "splits": p.splits,
                          "equal": equal, "max_abs_err": err})
        if not equal:
            raise AssertionError(f"minplus disagrees with plain: {mp_checks[-1]}")
        mp_err[(i, k, j, case)] = err
    in_deg = (layout[0][1:] - layout[0][:-1]).cpu()
    hub_deg = (hub_layout[0][1:] - hub_layout[0][:-1]).cpu()
    emit({"phase": "kernel_vs_plain", "rmat_gen_s": gen_s, "V": v, "E": e,
          "max_in_degree": int(in_deg.max()),
          "rows_in_degree_ge_10000": int((in_deg >= 10000).sum()),
          "item_edges": items.item_edges,
          "items": v - items.split_rows.shape[0] + items.n_split,
          "split_items": items.n_split,
          "split_rows": items.split_rows.shape[0],
          "hub_graph": {"V": hub.num_nodes, "E": hub.num_real_edges,
                        "max_in_degree": int(hub_deg.max()),
                        "split_items": hub_items.n_split,
                        "split_rows": hub_items.split_rows.shape[0]},
          "fanout_sweep": sweep_checks, "minplus": mp_checks,
          "tight_pred": pred_checks})

    # -- phases 3-5: the main path ------------------------------------------
    fanout_sweep.launches = 0
    minplus_kernel.launches = 0
    fanout_fixpoint.host_reads = 0
    minplus_fixpoint.host_reads = 0
    per_solve = {}

    class FanoutGraphProbe(TorchBackend):
        """The torch backend, keeping the device graph its fan-out ran on
        (the reweighted one when the graph has negative weights)."""

        fanout_graph = None

        def multi_source(self, dgraph, sources):
            self.fanout_graph = dgraph
            return super().multi_source(dgraph, sources)

    def run_solve(label, graph, sources, backend=None, **kw):
        before = (fanout_sweep.launches, minplus_kernel.launches,
                  fanout_fixpoint.host_reads, minplus_fixpoint.host_reads)
        solver = pjt.ParallelJohnsonSolver(pjt.SolverConfig(**kw),
                                           backend=backend, device="cuda")
        res, secs = sync_time(lambda: solver.solve(graph, sources))
        per_solve[label] = {
            "fanout_sweep": fanout_sweep.launches - before[0],
            "minplus": minplus_kernel.launches - before[1],
            "fanout_host_reads": fanout_fixpoint.host_reads - before[2],
            "minplus_host_reads": minplus_fixpoint.host_reads - before[3],
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
    rmat_sources, rmat_rows = sources, rows  # for phases 9 and 12
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
    grid_row = rows[0].copy()  # for phase 12's sssp from gsrc[0]
    grid_rows = rows[:64].copy()  # for phases 13 and 14
    grid_fanout_s = res.stats.phase_seconds["fanout"]
    grid_solve_stats = res.stats  # for phase 15
    grid_sweeps = res.stats.iterations_by_phase["fanout"]
    grid_res = res
    del res, rows

    # 5: dense ER-1024, all sources, route dense-squaring-pallas (fw=False:
    # the default takes fw-tile here, phase 16).
    er = pjt.load_graph(ER_SPEC)
    res, secs = run_solve("er1024", er, None, fw=False)
    route = res.stats.routes_by_phase["fanout"]
    if route != "dense-squaring-pallas":
        raise AssertionError(f"er1024 fan-out took route {route}")
    oracle = csgraph.dijkstra(er.to_scipy().astype(np.float64), directed=True)
    np.testing.assert_allclose(res.matrix, oracle, rtol=1e-5)
    er_matrix = to_numpy(res.dist)  # sources 0..V-1: for phases 13 and 14
    if per_solve["er1024"]["minplus"] == 0:
        raise AssertionError("er1024 solve launched no minplus kernel")
    emit({"phase": "solve_er1024", "spec": ER_SPEC, "V": er.num_nodes,
          "E": er.num_real_edges, "sources": er.num_nodes, "seconds": secs,
          "route": route, "iterations": dict(res.stats.iterations_by_phase),
          "launches": per_solve["er1024"]})
    del res
    # 128 sources: 2B < V, route dense-iterate-pallas (minplus_fixpoint).
    esrc = np.sort(np.random.default_rng(4).choice(er.num_nodes, 128,
                                                   replace=False))
    res, secs = run_solve("er1024_b128", er, esrc, fw=False)
    route = res.stats.routes_by_phase["fanout"]
    if route != "dense-iterate-pallas":
        raise AssertionError(f"er1024 (128 sources) took route {route}")
    rows = to_numpy(res.dist)
    oracle = csgraph.dijkstra(er.to_scipy().astype(np.float64), directed=True,
                              indices=esrc)
    np.testing.assert_array_equal(np.isinf(rows), np.isinf(oracle))
    np.testing.assert_allclose(rows, oracle, rtol=1e-5)
    er_iters = res.stats.iterations_by_phase["fanout"]
    er_reads = per_solve["er1024_b128"]["minplus_host_reads"]
    if not 0 < er_reads <= -(-er_iters // mp_mod.PRODUCTS_PER_SYNC) + 1:
        raise AssertionError(f"er1024 (128 sources): {er_reads} host reads "
                             f"for {er_iters} products")
    emit({"phase": "solve_er1024_b128", "spec": ER_SPEC, "V": er.num_nodes,
          "sources": 128, "seconds": secs, "route": route,
          "iterations": er_iters,
          "products_per_sync": mp_mod.PRODUCTS_PER_SYNC,
          "minplus_launches": per_solve["er1024_b128"]["minplus"],
          "minplus_host_reads": er_reads,
          "phase_seconds": dict(res.stats.phase_seconds),
          "checked_rows": "all"})
    del res, rows

    launches = {"fanout_sweep": fanout_sweep.launches,
                "minplus": minplus_kernel.launches}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {name}")
    by_path = {"solve_phases_3_5": dict(launches)}

    # -- phase 6: the sweep against its plain version on the grid's inputs ---
    # The layout the grid solve's fan-out ran on: reweighted weights,
    # clamped at 0, and B = 256 (two float4 per lane). Kernel and plain
    # version run in lockstep from the sources to the fixpoint.
    g_layout = probe.fanout_graph.by_dst()
    g_items = probe.fanout_graph.work_items()
    gv, ge, gb = grid.num_nodes, grid.num_real_edges, len(gsrc)
    d = torch.full((gv, gb), float("inf"), device=dev)
    d[torch.as_tensor(gsrc, device=dev), torch.arange(gb, device=dev)] = 0.0
    d0_grid = d.clone()
    grid_err, sweeps, improving, d_timing = 0.0, 0, True, None
    while improving:
        err, improving, d = sweep_equal(d, g_layout, g_items,
                                        f"the grid at sweep {sweeps}")
        grid_err = max(grid_err, err)
        sweeps += 1
        if sweeps == min(50, grid_sweeps):
            d_timing = d
        if sweeps > grid_sweeps:
            break
    if sweeps != grid_sweeps:
        raise AssertionError(f"lockstep fixpoint took {sweeps} sweeps, the "
                             f"solve {grid_sweeps}")
    d_fix = d
    rows = _unreweight(d.t().contiguous(), grid_res.potentials, gsrc)
    if not torch.equal(rows, grid_res.dist):
        raise AssertionError("the lockstep fixpoint, un-reweighted, differs "
                             "from the grid solve's rows")
    # tight_pred on the same fixpoint, full of zero-weight ties.
    fg = probe.fanout_graph
    g_coo = (fg.src, fg.dst, fg.weights)  # padded: (0, 0, +inf) never tight
    gsrc_dev = torch.as_tensor(gsrc, device=dev)
    grid_pred_err, grid_tight, grid_flags = pred_equal(
        d_fix, g_layout, g_items, g_coo, gsrc_dev,
        "the grid's reweighted fixpoint")
    if grid_flags != [0, 1]:  # zero-weight ties: predecessors at equal dist
        raise AssertionError(f"the grid's tree flags are {grid_flags}, "
                             "expected nondescending alone")
    emit({"phase": "kernel_vs_plain_grid", "spec": GRID_SPEC, "B": gb,
          "sweeps_checked": sweeps, "equal": True, "max_abs_err": grid_err,
          "zero_weight_fraction": float((g_layout[2] == 0).float().mean()),
          "rows_equal_solve": True,
          "tight_pred": {"equal": True, "max_abs_err": grid_pred_err,
                         "tight_share": grid_tight, "flags": grid_flags}})
    del grid_res, rows

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
    one = torch.ones(1, dtype=torch.int32, device=dev)

    def sweep_ms(d, lay, itm, reps):
        """Each sweep (and the warm-up) sets a flag of its own, zeroed
        before the timed run, as in the fixpoint."""
        out = torch.empty_like(d)
        flags = torch.zeros((reps + 1) * fs.FLAG_STRIDE, dtype=torch.int32,
                            device=dev)
        words = iter(range(0, flags.numel(), fs.FLAG_STRIDE))
        scratch = torch.empty((itm.n_split, d.shape[1]), device=dev)

        def sweep():
            j = next(words)
            fanout_sweep(d, *lay, items=itm, out=out,
                         improved=flags[j:j + 1], prev=one, scratch=scratch)

        return event_ms(sweep, reps=reps)

    timings = {}
    for b, (d, _) in sweep_states.items():
        ms = sweep_ms(d, layout, items, 10)
        plain = event_ms(lambda: fanout_sweep_plain(d, *layout), reps=2)
        bms, by = bound(4 * (2 * v * b + (v + 1) + 2 * e), 2 * e * b)
        timings[f"fanout_sweep_B{b}"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "gathered_GB": 4 * e * b / 1e9, "item_edges": items.item_edges,
            "items": v - items.split_rows.shape[0] + items.n_split,
            "split_items": items.n_split,
            "scratch_bytes": 4 * items.n_split * b,
            "gather_depth": fs.occupancy(b)["gather_depth"],
        }
    # The grid fan-out's inputs 50 sweeps in (phase 6's layout).
    d = d_timing
    kernel_ms = sweep_ms(d, g_layout, g_items, 50)
    # The same sweep at the fixpoint, where no row drops and no warp
    # touches the flag.
    at_fixpoint = sweep_ms(d_fix, g_layout, g_items, 50)
    plain = event_ms(lambda: fanout_sweep_plain(d, *g_layout), reps=5)
    bms, by = bound(4 * (2 * gv * gb + (gv + 1) + 2 * ge), 2 * ge * gb)
    # The grid fixpoint from the sources on the host clock, twice, with
    # SWEEPS_PER_SYNC sweeps per host read: what each sweep costs beyond
    # its kernel is the host loop.
    host_loop = []
    for _ in range(2):
        start = d0_grid.clone()
        reads = fanout_fixpoint.host_reads
        (fix, it_fix, imp_fix), secs = sync_time(lambda: fanout_fixpoint(
            start, *g_layout, max_iter=gv, items=g_items))
        if it_fix != grid_sweeps or imp_fix or not torch.equal(fix, d_fix):
            raise AssertionError(f"grid fixpoint: {it_fix} sweeps (solve "
                                 f"{grid_sweeps}), improving {imp_fix}")
        host_loop.append({
            "s": secs, "ms_per_sweep": secs * 1e3 / it_fix,
            "host_loop_ms_per_sweep": secs * 1e3 / it_fix - kernel_ms,
            "host_reads": fanout_fixpoint.host_reads - reads})
        del start, fix
    timings["fanout_sweep_grid512_B256"] = {
        "ms": kernel_ms, "ms_at_fixpoint": at_fixpoint,
        "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "solve_s_per_sweep": grid_fanout_s / grid_sweeps,
        "solve_host_loop_ms_per_sweep":
            grid_fanout_s * 1e3 / grid_sweeps - kernel_ms,
        "sweeps_per_sync": fs.SWEEPS_PER_SYNC,
        "fixpoint_host_clock": host_loop,
    }
    # tight_pred at R-MAT-20's converged fan-out (B = 512, 128) and the
    # grid's fixpoint (B = 256), with the sources as the pred solves call
    # it: the kernel back to back, the plain pass and tree_flags_plain on
    # the transposed block, the bound. Bytes: dist read and pred written
    # once, the CSC, the split rows' int64 partial keys written and read;
    # operations: an add, a subtract and two compares per candidate
    # (gathered rows count as cache hits, as for the sweep).
    def pred_timing(d, lay, itm, coo, ne, sources, reps, plain_reps):
        vv, bb = d.shape
        ms = event_ms(lambda: tight_pred_pass(d, *lay, items=itm,
                                              sources=sources), reps=reps)
        dt = d.t().contiguous()
        plain = event_ms(lambda: tree_flags_plain(
            tight_pred_pass_plain(dt, *coo), dt, sources), reps=plain_reps)
        bms, by = bound(8 * vv * bb + 4 * (vv + 1) + 8 * ne
                        + 16 * itm.n_split * bb, 4 * ne * bb)
        tpl = {k: t for k, t in pred_templates.items()
               if k.startswith(pred_template(bb))}
        return {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                "scratch_bytes": 8 * itm.n_split * bb,
                "split_items": itm.n_split, "template": tpl,
                "occupancy": pred_mod.occupancy(bb)}

    def certify_timing(d, lay, itm, sources, reps):
        """The tree check on the pass's trees: ``certify_pred`` with the
        kernel's flags (one host read; the walk only when a predecessor
        is not strictly closer) beside the check without them (the source
        mask, coverage and the pointer-doubling walk). Returns the times,
        both answers and the walks each ran."""
        p_vm, flags = tight_pred_pass(d, *lay, items=itm, sources=sources)
        p_bv, d_bv = p_vm.t().contiguous(), d.t().contiguous()
        del p_vm
        out = {"flags": flags.tolist()}
        for name, kw in (("with_flags", {"flags": flags}), ("without", {})):
            oks = []
            walks = pred_reaches_root.walks
            out[f"certify_ms_{name}"] = event_ms(lambda: oks.append(bool(
                certify_pred(p_bv.clone() if not kw else p_bv, d_bv, sources,
                             **kw)[1])), reps=reps)
            out[f"ok_{name}"] = all(oks)
            out[f"walks_{name}"] = (pred_reaches_root.walks - walks) / (reps + 1)
        return out

    for b, d in sorted(pred_states.items(), reverse=True):
        timings[f"tight_pred_B{b}"] = pred_timing(
            d, layout, items, rmat_coo, e, sweep_sources[b], 10, 2)
    # The tree check on the B = 512 trees: weights in [1, 10), so the
    # flags certify them with no walk.
    cert = certify_timing(pred_states[512], layout, items,
                          sweep_sources[512], 3)
    if not (cert["ok_with_flags"] and cert["ok_without"]
            and cert["walks_with_flags"] == 0):
        raise AssertionError(f"R-MAT-20 B=512 tree check: {cert}")
    timings["tight_pred_B512"].update(cert)
    timings["tight_pred_grid512_B256"] = pred_timing(
        d_fix, g_layout, g_items, g_coo, ge, gsrc_dev, 20, 3)
    # The grid's trees tie at zero weights: the flags send the check to
    # the walk, which passes.
    cert = certify_timing(d_fix, g_layout, g_items, gsrc_dev, 3)
    if not (cert["flags"] == [0, 1] and cert["ok_with_flags"]
            and cert["ok_without"] and cert["walks_with_flags"] == 1):
        raise AssertionError(f"the grid's tree check: {cert}")
    timings["tight_pred_grid512_B256"].update(cert)
    # Min-plus at the dense route's shapes and 4096^3 (MINPLUS_SHAPES).
    for (i, k, j) in MINPLUS_SHAPES:
        g_rng = np.random.default_rng(7)
        dm = torch.as_tensor(g_rng.random((i, k), dtype=np.float32)).to(dev)
        am = torch.as_tensor(g_rng.random((k, j), dtype=np.float32)).to(dev)
        big = i * k * j > 1 << 30
        eager = event_ms(lambda: minplus_kernel(dm, am), reps=3 if big else 50)
        card = graph_ms(lambda: minplus_kernel(dm, am), reps=3 if big else 50)
        plain = event_ms(lambda: minplus_plain(dm, am), reps=1 if big else 3)
        bms, by = minplus_bound(i, k, j)
        p = minplus_plan(i, k, j)
        timings[f"minplus_{i}x{k}x{j}"] = {
            "ms": eager, "card_ms": card, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by,
            "card_share_of_bound": bms / card, "tile_rows": p.rows,
            "splits": p.splits, "blocks": int(np.prod(p.grid(i, j))),
            "partial_bytes": 4 * i * j * p.splits if p.splits > 1 else 0,
        }
        del dm, am
    # The iterate regime's fixpoint on the 128-source ER-1024 solve's own
    # inputs, on the host clock, twice: beside the products' card time
    # (minplus_128x1024x1024), the rest is the host's share.
    a_er = relax.dense_adjacency(
        *(torch.as_tensor(x).to(dev) for x in (er.src, er.indices,
                                               er.weights)), er.num_nodes)
    d0_er = relax.multi_source_init(torch.as_tensor(esrc).to(dev),
                                    er.num_nodes)
    fix_runs = []
    for _ in range(2):
        start = d0_er.clone()
        before = (minplus_kernel.launches, minplus_fixpoint.host_reads)
        (fix, it_fix, imp_fix), secs = sync_time(lambda: minplus_fixpoint(
            start, a_er, max_iter=er.num_nodes))
        if it_fix != er_iters or imp_fix:
            raise AssertionError(f"er1024 fixpoint: {it_fix} products (solve "
                                 f"{er_iters}), improving {imp_fix}")
        fix_runs.append({
            "s": secs, "products": it_fix,
            "launches": minplus_kernel.launches - before[0],
            "host_reads": minplus_fixpoint.host_reads - before[1],
            "ms_per_product": secs * 1e3 / it_fix})
        del start, fix
    timings["minplus_fixpoint_er1024_B128"] = {
        "host_clock": fix_runs,
        "card_ms": timings["minplus_128x1024x1024"]["card_ms"],
        "products_per_sync": mp_mod.PRODUCTS_PER_SYNC}
    emit({"phase": "timing", "device": kind, "power_limit": smi,
          "timings": timings})
    sweep_errs = [err for _, err in sweep_states.values()]
    pred_errs = [c["max_abs_err"] for c in pred_checks] + [grid_pred_err]
    del sweep_states, pred_states, d, d_fix, d_timing, d0_grid, d0_er, a_er
    torch.cuda.empty_cache()

    # -- phases 9-12: the batch driver and the other entry points -----------
    by_path.update(drive_entry_points(dev, rmat, rmat_sources, rmat_rows,
                                      grid, gsrc[0], grid_row, cyc))
    # -- phases 13-14: predecessor trees and the XLA routes -----------------
    by_path.update(drive_pred_paths(dev, rmat, rmat_sources, rmat_rows, grid,
                                    gsrc, grid_rows, er, er_matrix))
    by_path.update(drive_xla_routes(dev, rmat, rmat_sources, rmat_rows, grid,
                                    gsrc, grid_rows, er, er_matrix))
    # -- phase 15: the B=1 routes ------------------------------------------
    by_path.update(drive_b1_routes(dev, grid, gsrc, grid_rows,
                                   grid_solve_stats, cyc))
    # -- phase 16: dense APSP ------------------------------------------------
    dense_paths, kleene = drive_dense_apsp(dev, er, er_matrix)
    by_path.update(dense_paths)
    launches = {name: sum(p.get(name, 0) for p in by_path.values())
                for name in ("fanout_sweep", "minplus", "tight_pred",
                             "fw_kleene")}

    t_sw = timings["fanout_sweep_B512"]
    t_mp = timings["minplus_1024x1024x1024"]
    t_tp = timings["tight_pred_B512"]
    t_kl = kleene["timing"]
    emit({"kernels": [
        {"name": "fanout_sweep", "route": "cuda",
         "source": "paralleljohnson_tpu_torch/csrc/fanout_sweep.cu",
         "replaces": "paralleljohnson_tpu/ops/pallas_sweep.py:255",
         "launches": launches["fanout_sweep"],
         "launches_by_path": {k: p["fanout_sweep"] for k, p in by_path.items()},
         "max_abs_err": max(grid_err, *hub_errs,
                            *sweep_errs),
         "ms": t_sw["ms"], "plain_ms": t_sw["plain_ms"],
         "bound_ms": t_sw["bound_ms"], "bound_by": t_sw["bound_by"],
         "library_ms": None},
        {"name": "minplus", "route": "cuda",
         "source": "paralleljohnson_tpu_torch/csrc/minplus.cu",
         "replaces": "paralleljohnson_tpu/ops/pallas_kernels.py:117",
         "launches": launches["minplus"],
         "launches_by_path": {k: p["minplus"] for k, p in by_path.items()},
         "max_abs_err": max(mp_err.values()),
         "ms": t_mp["ms"], "card_ms": t_mp["card_ms"],
         "plain_ms": t_mp["plain_ms"], "bound_ms": t_mp["bound_ms"],
         "bound_by": t_mp["bound_by"], "library_ms": None},
        {"name": "tight_pred", "route": "cuda",
         "source": "paralleljohnson_tpu_torch/csrc/tight_pred.cu",
         "replaces": "paralleljohnson_tpu/ops/pred.py:69",
         "launches": launches["tight_pred"],
         "launches_by_path": {k: p.get("tight_pred", 0)
                              for k, p in by_path.items()},
         "max_abs_err": max(pred_errs),
         "ms": t_tp["ms"], "plain_ms": t_tp["plain_ms"],
         "bound_ms": t_tp["bound_ms"], "bound_by": t_tp["bound_by"],
         "library_ms": None},
        {"name": "fw_kleene", "route": "cuda",
         "source": "paralleljohnson_tpu_torch/csrc/fw_kleene.cu",
         "replaces": "paralleljohnson_tpu/ops/fw.py:100",
         "launches": launches["fw_kleene"],
         "launches_by_path": {k: p.get("fw_kleene", 0)
                              for k, p in by_path.items()},
         "max_abs_err": max(kleene["errs"]),
         "ms": t_kl["ms"], "card_ms": t_kl["card_ms"],
         "plain_ms": t_kl["plain_ms"], "bound_ms": t_kl["bound_ms"],
         "bound_by": t_kl["bound_by"], "library_ms": None,
         "variants": {name: {k: row[k] for k in (
             "t", "ms", "card_ms", "plain_ms", "bound_ms")}
             for name, row in kleene["variants"].items()}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
