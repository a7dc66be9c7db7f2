#!/usr/bin/env python3
"""Time the PyTorch port's ``tight_pred`` kernel on one CUDA card against
an earlier version of it and against variants, then the tree check and the
R-MAT-20 predecessor fan-out.

    python3 scripts/torch_tight_pred_timing.py [--baseline OLD.cu]
        [--variant NEW.cu ...] [--fanout-runs 3]
        [--f64-baseline OLD.cu] [--f64-variant NEW.cu ...] [--f64-only]
        [--f64-solve-runs 3] [--f64-solve-only]

1. The pass at ``chip_smoke.py``'s shapes: R-MAT-20's fan-out fixpoint at
   B = 512 and 128 (phase 2's sources) and the 512x512 grid's reweighted
   fixpoint at B = 256 (phase 4's sources). ``--baseline`` names a source
   with the first version's C entry point, ``pj_tight_pred(dist, pred,
   indptr, src, w, pieces, n_pieces, V, L, partial, split_rows,
   split_ptr, n_split_rows, B, stream)`` (``git show
   <commit>:paralleljohnson_tpu_torch/csrc/tight_pred.cu``); it has no
   source mask and no flags, so it is timed without them, beside the
   current kernel without them. ``--variant`` names sources with the
   current entry point (e.g. the current file with another ``Tune``
   table); each is timed with the sources and flags, beside the current
   kernel with them. Every source is built with the port's ``nvcc``
   flags and ``-Xptxas -v`` (registers and spills by template are
   printed), and all run on the same inputs in turns (A, B, ..., ..., B,
   A); their trees and flags must be equal. The bound is chip_smoke's.
2. The tree check on those trees: ``certify_pred`` with the kernel's
   flags and without them, and the pointer-doubling walk alone with int32
   indices (``pred_reaches_root``) beside the same walk on an int64 copy
   of the indices (the first version), in turns.
3. ``solve(predecessors=True)`` on R-MAT-20 over phase 3's 512 sources,
   ``--fanout-runs`` times, each beside the plain ``solve()`` (plain,
   pred, pred, plain, ...): fan-out seconds, their medians, launches and
   walks.
4. f64 (``pj_tight_pred_f64``): R-MAT-20's f64 fixpoints at B = 512,
   256 and 128 (phase 2's sources, 256 the first of the 512; the sweep's
   hub flags at that width) and the
   reweighted grid's at B = 256 and 64 (phase 4's sources and the first
   64 of them, the f64 pred path's; no hubs). The current kernel with
   the hub flags where the graph has them and without, each
   ``--f64-baseline`` (a source whose ``pj_tight_pred_f64`` has the
   first f64 kernel's C entry point, without hub flags: ``git show
   f3bebf2:paralleljohnson_tpu_torch/csrc/tight_pred.cu``) and each
   ``--f64-variant`` (current entry point, e.g. another ``Tune`` table),
   with the sources and flags, in turns (the current-entry-point kernels
   with the graph's hub flags and, where it has some, without); trees
   and flags equal the plain pass's. ``--f64-only`` runs parts 4 and 5
   alone.
5. The f64 pass on the solving path: ``solve(predecessors=True)`` at
   ``precision="f64"`` on R-MAT-20 over phase 3's 512 sources in one
   batch (chip_smoke's phase 25 solve), ``--f64-solve-runs`` times each
   with the hub flags ``_extract`` hands the pass and with them withheld
   from the pass (the sweep keeps its own), in turns (with, without,
   without, with, ...): the pass's card time (CUDA events around the
   backend's call), ``_extract``'s seconds (the pass and the tree check,
   between two synchronizations), the fan-out phase's and the solve's
   seconds, and their medians; rows and trees equal in every run.
   ``--f64-solve-only`` runs this part alone.

Prints the card's name and power limit, then one JSON line per part.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    GRID_SPEC, PEAK_F64_INSTR_S, RMAT_SPEC, bound, event_ms, sync_time,
    tight_pred_templates,
)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
OLD_ABI = (_P, _P, _P, _P, _P, _P, _L, _L, _I, _P, _P, _P, _L, _L, _P)


def build(src: Path, workdir: str, argtypes, entry: str = "pj_tight_pred"):
    """(the source's ``entry``, its ptxas templates)."""
    from paralleljohnson_tpu_torch.ops import _cuda

    lib = Path(workdir) / f"lib{src.stem}.so"
    out = subprocess.run(
        [_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
         str(src)], check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn, tight_pred_templates(out.stdout + out.stderr)


def states():
    """The fixpoints of chip_smoke's phases 2 and 6: yields (label, dist
    [V, B], CSC, work items, edge count, sources on the card)."""
    import numpy as np
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
    from paralleljohnson_tpu_torch.ops.fanout_sweep import fanout_fixpoint

    dev = torch.device("cuda")

    def fixpoint(layout, items, v, sources):
        d = torch.full((v, len(sources)), float("inf"), device=dev)
        src = torch.as_tensor(sources, device=dev)
        d[src, torch.arange(len(sources), device=dev)] = 0.0
        return fanout_fixpoint(d, *layout, max_iter=v, items=items)[0], src

    rmat = pjt.load_graph(RMAT_SPEC)
    v = rmat.num_nodes
    dg = TorchBackend(pjt.SolverConfig(), device=dev).upload(rmat)
    layout, items = dg.fanout_layout()
    rng = np.random.default_rng(0)  # chip_smoke phase 2: B = 128, then 512
    picks = {b: rng.choice(v, b, replace=False) for b in (128, 512)}
    for b in (512, 128):
        d, src = fixpoint(layout, items, v, picks[b])
        yield f"rmat20_B{b}", d, layout, items, rmat.num_real_edges, src
        del d
    del dg, layout, items

    class Probe(TorchBackend):
        fanout_graph = None

        def multi_source(self, dgraph, sources):
            self.fanout_graph = dgraph
            return super().multi_source(dgraph, sources)

    grid = pjt.load_graph(GRID_SPEC)
    gsrc = np.sort(np.random.default_rng(2).choice(grid.num_nodes, 256,
                                                   replace=False))
    probe = Probe(pjt.SolverConfig(), device=dev)
    pjt.ParallelJohnsonSolver(backend=probe).solve(grid, gsrc)
    layout, items = probe.fanout_graph.fanout_layout()
    d, src = fixpoint(layout, items, grid.num_nodes, gsrc)
    yield "grid512_B256", d, layout, items, grid.num_real_edges, src


def time_pass(baseline: Path | None, variants: list[Path]) -> dict:
    """Part 1; returns each state's trees and sources for part 2."""
    import torch

    from paralleljohnson_tpu_torch.ops import _cuda
    from paralleljohnson_tpu_torch.ops import pred as pm

    current = _cuda.lib("tight_pred").pj_tight_pred
    new_abi = _cuda.SIGNATURES["tight_pred"]["pj_tight_pred"]
    trees = {}
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"current": current}
        builds = {"current": tight_pred_templates(
            _cuda.build_all()["tight_pred"])}
        if baseline:
            fns["baseline"], builds["baseline"] = build(baseline, tmp, OLD_ABI)
        for k, path in enumerate(variants):
            name = f"variant{k}:{path.name}"
            fns[name], builds[name] = build(path, tmp, new_abi)
        print(json.dumps({"builds": builds}), flush=True)
        for label, d, (indptr, src_in, w_in), itm, e, sources in states():
            v, b = d.shape
            out = torch.empty((v, b), dtype=torch.int32, device=d.device)
            scratch = torch.empty((itm.n_split, b), dtype=torch.int64,
                                  device=d.device)
            flags = torch.zeros(2, dtype=torch.int32, device=d.device)
            src32 = sources.to(torch.int32)

            def call(fn, masked):
                if masked:
                    flags.zero_()
                if fn is fns.get("baseline"):  # the first entry point
                    extra = ()
                elif masked:
                    extra = (src32.data_ptr(), flags.data_ptr())
                else:
                    extra = (None, None)
                err = fn(d.data_ptr(), out.data_ptr(), indptr.data_ptr(),
                         src_in.data_ptr(), w_in.data_ptr(),
                         itm.pieces.data_ptr(), itm.n_split, v,
                         itm.item_edges, scratch.data_ptr(),
                         itm.split_rows.data_ptr(), itm.split_ptr.data_ptr(),
                         itm.split_rows.shape[0], *extra, b,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            # Turns: unmasked (baseline beside current), masked (current
            # beside the variants); equal trees and flags within each.
            groups = [("unmasked", False, [n for n in ("baseline", "current")
                                           if n in fns]),
                      ("masked", True, [n for n in fns if n != "baseline"])]
            row = {"state": label, "V": v, "B": b, "E": e,
                   "bound_ms": bound(8 * v * b + 4 * (v + 1) + 8 * e
                                     + 16 * itm.n_split * b, 4 * e * b)[0]}
            reps = 20 if b <= 256 and v < 1 << 20 else 5
            for group, masked, names in groups:
                results = {}
                for name in names:
                    call(fns[name], masked)
                    torch.cuda.synchronize()
                    results[name] = (out.clone(), flags.tolist())
                first = results[names[0]]
                for name, (p, f) in results.items():
                    if not torch.equal(p, first[0]) or (masked and f != first[1]):
                        raise AssertionError(f"{label} {group}: {name} differs "
                                             f"from {names[0]}")
                times = {}
                for name in names + names[::-1]:
                    times.setdefault(name, []).append(event_ms(
                        lambda: call(fns[name], masked), reps=reps))
                row[group] = {"ms": times,
                              "flags": first[1] if masked else None}
                if masked:
                    trees[label] = (first[0].t().contiguous(),
                                    d.t().contiguous(), sources,
                                    torch.tensor(first[1], dtype=torch.int32,
                                                 device=d.device))
                del results, first
            row["occupancy"] = pm.occupancy(b)
            print(json.dumps(row), flush=True)
            del d, out, scratch
            torch.cuda.empty_cache()
    return trees


def reaches_root_int64(pred):
    """The first version of ``ops.pred.pred_reaches_root``: the same walk,
    gathering on an int64 copy of the indices at every step."""
    import torch

    q = pred
    for _ in range(max(1, math.ceil(math.log2(max(q.shape[1], 2))))):
        pending = q >= 0
        if not bool(pending.any()):
            break
        q = torch.where(pending, torch.gather(q, 1, q.clamp_min(0).long()), q)
    return q == -1


def time_check(trees: dict) -> None:
    """Part 2."""
    import torch

    from paralleljohnson_tpu_torch.ops import pred as pm

    for label, (p_bv, d_bv, sources, flags) in trees.items():
        row = {"state": label, "flags": flags.tolist()}
        walks = pm.pred_reaches_root.walks
        row["certify_ms_with_flags"] = event_ms(
            lambda: bool(pm.certify_pred(p_bv, d_bv, sources,
                                         flags=flags)[1]), reps=5)
        row["walks_with_flags"] = (pm.pred_reaches_root.walks - walks) / 6
        row["ok_with_flags"] = bool(pm.certify_pred(p_bv, d_bv, sources,
                                                    flags=flags)[1])
        row["certify_ms_without"] = event_ms(
            lambda: bool(pm.certify_pred(p_bv.clone(), d_bv, sources)[1]),
            reps=3)
        walk = {"int32": lambda: bool(pm.pred_reaches_root(p_bv).all()),
                "int64": lambda: bool(reaches_root_int64(p_bv).all())}
        got = {name: fn() for name, fn in walk.items()}
        if got["int32"] != got["int64"]:
            raise AssertionError(f"{label}: the walks disagree: {got}")
        times = {}
        for name in ["int64", "int32", "int32", "int64"]:
            times.setdefault(name, []).append(event_ms(walk[name], reps=3))
        row["walk_ms"] = times
        row["walk_ok"] = got["int32"]
        print(json.dumps(row), flush=True)
    trees.clear()
    torch.cuda.empty_cache()


def time_fanout(runs: int) -> None:
    """Part 3."""
    import numpy as np

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.ops import pred as pm

    rmat = pjt.load_graph(RMAT_SPEC)
    sources = np.sort(np.random.default_rng(1).choice(rmat.num_nodes, 512,
                                                      replace=False))
    fanout = {"plain": [], "pred": []}
    detail = []
    for k in range(runs):
        for kind in (("plain", "pred") if k % 2 == 0 else ("pred", "plain")):
            launches, walks = pm.tight_pred_pass.launches, pm.pred_reaches_root.walks
            res, secs = sync_time(lambda: pjt.ParallelJohnsonSolver(
                device="cuda").solve(rmat, sources,
                                     predecessors=kind == "pred"))
            fanout[kind].append(res.stats.phase_seconds["fanout"])
            detail.append({"kind": kind, "seconds": secs,
                           "fanout_s": fanout[kind][-1],
                           "route": res.stats.routes_by_phase["fanout"],
                           "tight_pred_launches":
                               pm.tight_pred_pass.launches - launches,
                           "walks": pm.pred_reaches_root.walks - walks})
            del res
    print(json.dumps({"fanout": RMAT_SPEC, "sources": 512, "runs": detail,
                      "median_fanout_s": {k: statistics.median(t)
                                          for k, t in fanout.items()}}),
          flush=True)


def f64_states():
    """Part 4's fixpoints at f64: yields (label, dist [V, B], CSC, work
    items, COO edges, sources on the card, hub flags or None)."""
    import numpy as np
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
    from paralleljohnson_tpu_torch.ops.fanout_sweep import fanout_fixpoint

    dev = torch.device("cuda")
    cfg = pjt.SolverConfig(precision="f64")

    def fixpoint(layout, items, v, sources):
        d = torch.full((v, len(sources)), float("inf"), dtype=torch.float64,
                       device=dev)
        src = torch.as_tensor(sources, device=dev)
        d[src, torch.arange(len(sources), device=dev)] = 0.0
        return fanout_fixpoint(d, *layout, max_iter=v, items=items)[0], src

    def coo(dg, e):
        return dg.src[:e], dg.dst[:e], dg.weights[:e]

    rmat = pjt.load_graph(RMAT_SPEC)
    v = rmat.num_nodes
    dg = TorchBackend(cfg, device=dev).upload(rmat)
    layout, items = dg.fanout_layout()
    rng = np.random.default_rng(0)  # chip_smoke phase 2: B = 128, then 512
    picks = {b: rng.choice(v, b, replace=False) for b in (128, 512)}
    picks[256] = picks[512][:256]
    for b in (512, 256, 128):
        d, src = fixpoint(layout, items, v, picks[b])
        yield (f"rmat20_B{b}", d, layout, items, coo(dg, rmat.num_real_edges),
               src, dg.hub_flags(b))
        del d
    del dg, layout, items

    class Probe(TorchBackend):
        fanout_graph = None

        def multi_source(self, dgraph, sources):
            self.fanout_graph = dgraph
            return super().multi_source(dgraph, sources)

    grid = pjt.load_graph(GRID_SPEC)
    gsrc = np.sort(np.random.default_rng(2).choice(grid.num_nodes, 256,
                                                   replace=False))
    probe = Probe(cfg, device=dev)
    pjt.ParallelJohnsonSolver(backend=probe).solve(grid, gsrc)
    gdg = probe.fanout_graph
    layout, items = gdg.fanout_layout()
    for sources in (gsrc, gsrc[:64]):
        d, src = fixpoint(layout, items, grid.num_nodes, sources)
        yield (f"grid512_B{len(sources)}", d, layout, items,
               coo(gdg, grid.num_real_edges), src,
               gdg.hub_flags(len(sources)))
        del d


def time_f64(baseline: Path | None, variants: list[Path]) -> None:
    """Part 4."""
    import torch

    from paralleljohnson_tpu_torch.ops import _cuda
    from paralleljohnson_tpu_torch.ops import pred as pm

    f64 = torch.float64
    new_abi = _cuda.SIGNATURES["tight_pred"]["pj_tight_pred_f64"]
    # The first f64 entry point: no hub flags after w.
    old_abi = new_abi[:5] + new_abi[6:]
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"current": _cuda.lib("tight_pred").pj_tight_pred_f64}
        builds = {"current": tight_pred_templates(
            _cuda.build_all()["tight_pred"])}
        if baseline:
            fns["baseline"], builds["baseline"] = build(
                baseline, tmp, old_abi, entry="pj_tight_pred_f64")
        for k, path in enumerate(variants):
            name = f"variant{k}:{path.name}"
            fns[name], builds[name] = build(path, tmp, new_abi,
                                            entry="pj_tight_pred_f64")
        print(json.dumps({"f64_builds": builds}), flush=True)
        for label, d, (indptr, src_in, w_in), itm, coo, sources, hubs in \
                f64_states():
            v, b = d.shape
            e = src_in.shape[0]
            out = torch.empty((v, b), dtype=torch.int32, device=d.device)
            part_du = torch.empty((itm.n_split, b), dtype=f64,
                                  device=d.device)
            part_u = torch.empty((itm.n_split, b), dtype=torch.int32,
                                 device=d.device)
            flags = torch.zeros(2, dtype=torch.int32, device=d.device)
            src32 = sources.to(torch.int32)
            # (label, kernel, hub flags): each current-ABI kernel with the
            # graph's flags and, where it has some, without.
            runs = [(n, n, hubs) for n in fns if n != "baseline"]
            if hubs is not None:
                runs += [(f"{n}_no_hubs", n, None) for n in fns
                         if n != "baseline"]
            if "baseline" in fns:
                runs.append(("baseline", "baseline", None))

            def call(name, h):
                flags.zero_()
                fn = fns[name]
                hub = () if name == "baseline" else (
                    None if h is None else h.data_ptr(),)
                err = fn(d.data_ptr(), out.data_ptr(), indptr.data_ptr(),
                         src_in.data_ptr(), w_in.data_ptr(), *hub,
                         itm.pieces.data_ptr(), itm.n_split, v,
                         itm.item_edges, part_du.data_ptr(),
                         part_u.data_ptr(), itm.split_rows.data_ptr(),
                         itm.split_ptr.data_ptr(), itm.split_rows.shape[0],
                         src32.data_ptr(), flags.data_ptr(), b,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} failed: cudaError {err}")

            dt = d.t().contiguous()
            want, want_flags = pm.tree_flags_plain(
                pm.tight_pred_pass_plain(dt, *coo), dt, sources)
            del dt
            for run, name, h in runs:
                call(name, h)
                torch.cuda.synchronize()
                if not torch.equal(out.t(), want) \
                        or flags.tolist() != want_flags.tolist():
                    raise AssertionError(f"{label}: {run} differs from the "
                                         f"plain pass")
            del want
            times = {}
            for run, name, h in runs + runs[::-1]:
                times.setdefault(run, []).append(event_ms(
                    lambda: call(name, h), reps=5 if v >= 1 << 20 else 20))
            # chip_smoke's f64 bound (the function's bytes: no flags).
            bms, by = bound(8 * v * b + 4 * v * b + 4 * (v + 1) + 12 * e
                            + 24 * itm.n_split * b, 4 * e * b,
                            instr_s=PEAK_F64_INSTR_S)
            row = {"f64_state": label, "V": v, "B": b, "E": e,
                   "bound_ms": bms, "bound_by": by, "ms": times,
                   "flags": flags.tolist(),
                   "hub_edges": None if hubs is None else int(hubs.sum()),
                   "occupancy": {
                       "hubs": pm.occupancy(b, dtype=f64, hubs=True),
                       "plain": pm.occupancy(b, dtype=f64)}}
            print(json.dumps(row), flush=True)
            del d, out, part_du, part_u
            torch.cuda.empty_cache()


def time_f64_solve(runs: int) -> None:
    """Part 5."""
    import numpy as np
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends import torch_backend as tb
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy

    rmat = pjt.load_graph(RMAT_SPEC)
    sources = np.sort(np.random.default_rng(1).choice(rmat.num_nodes, 512,
                                                      replace=False))
    shipped_pass, shipped_extract = tb.tight_pred_pass, tb.TorchBackend._extract
    run = {}

    def timed_pass(*args, hubs=None, **kw):
        use = hubs if run["hubs"] else None
        run["flags_given"].append(hubs is not None)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = shipped_pass(*args, hubs=use, **kw)
        end.record()
        run["events"].append((start, end))
        return out

    def timed_extract(self, *args, **kw):
        out, secs = sync_time(lambda: shipped_extract(self, *args, **kw))
        run["extract_s"].append(secs)
        return out

    detail, first = [], None
    tb.tight_pred_pass, tb.TorchBackend._extract = timed_pass, timed_extract
    try:
        for k in range(2 * runs):
            hubs = k % 4 in (0, 3)
            run.update(hubs=hubs, flags_given=[], events=[], extract_s=[])
            solver = pjt.ParallelJohnsonSolver(
                pjt.SolverConfig(precision="f64", source_batch_size=512),
                device="cuda")
            res, secs = sync_time(lambda: solver.solve(rmat, sources,
                                                       predecessors=True))
            if hubs and not all(run["flags_given"]):
                raise AssertionError("_extract gave the f64 pass no hub "
                                     "flags on R-MAT-20")
            rows, pred = to_numpy(res.dist), to_numpy(res.predecessors)
            if first is None:
                first = (rows, pred)
            elif not (np.array_equal(rows, first[0])
                      and np.array_equal(pred, first[1])):
                raise AssertionError(f"f64 solve run {k}: rows or trees "
                                     f"differ from run 0")
            detail.append({
                "hubs": hubs, "seconds": secs,
                "fanout_s": res.stats.phase_seconds["fanout"],
                "route": res.stats.routes_by_phase["fanout"],
                "flags_given": run["flags_given"],
                "pass_ms": [s.elapsed_time(e) for s, e in run["events"]],
                "extract_s": run["extract_s"]})
            del res, rows, pred
    finally:
        tb.tight_pred_pass, tb.TorchBackend._extract = (shipped_pass,
                                                        shipped_extract)
    medians = {}
    for key in ("pass_ms", "extract_s", "fanout_s", "seconds"):
        for hubs in (True, False):
            vals = [sum(r[key]) if isinstance(r[key], list) else r[key]
                    for r in detail if r["hubs"] == hubs]
            medians[f"{key}_{'hubs' if hubs else 'no_hubs'}"] = \
                statistics.median(vals)
    print(json.dumps({"f64_solve": RMAT_SPEC, "sources": 512,
                      "source_batch_size": 512, "runs": detail,
                      "medians": medians}), flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--variant", type=Path, action="append", default=[])
    ap.add_argument("--fanout-runs", type=int, default=3)
    ap.add_argument("--f64-baseline", type=Path)
    ap.add_argument("--f64-variant", type=Path, action="append", default=[])
    ap.add_argument("--f64-only", action="store_true")
    ap.add_argument("--f64-solve-runs", type=int, default=3)
    ap.add_argument("--f64-solve-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script times the "
              "kernel on a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if not (args.f64_only or args.f64_solve_only):
        time_check(time_pass(args.baseline, args.variant))
        if args.fanout_runs:
            time_fanout(args.fanout_runs)
    if not args.f64_solve_only:
        time_f64(args.f64_baseline, args.f64_variant)
    if args.f64_solve_runs:
        time_f64_solve(args.f64_solve_runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
