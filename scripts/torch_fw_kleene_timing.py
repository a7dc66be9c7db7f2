#!/usr/bin/env python3
"""Time the PyTorch port's Kleene-closure kernel (``csrc/fw_kleene.cu``)
on one CUDA card against an earlier version of it and against variants,
then blocked Floyd-Warshall on the dense graphs beside squaring.

    python3 scripts/torch_fw_kleene_timing.py [--baseline OLD.cu]
        [--variant NEW.cu ...] [--solve-runs 2]
        [--f64-baseline OLD.cu ...] [--f64-variant NEW.cu ...] [--f64-only]

1. Builds. The current source through the port's build; ``--baseline``
   names a source with the step kernel's C entry point, ``pj_fw_kleene(
   in, ld_in, out, ld_out, buf0, buf1, t, stream)`` (t launches per
   closure: ``git show ab842c9:paralleljohnson_tpu_torch/csrc/
   fw_kleene.cu``); ``--variant`` names sources with the current C entry
   point, ``pj_fw_kleene(in, ld_in, out, ld_out, t, rows, cols, threads,
   smem, stream)`` given ``kleene_plan(t)`` (another synchronisation,
   placement or cluster shape; a source may lay its CTAs out in its own
   way and ignore the plan's shape). Each is built with the port's
   ``nvcc`` flags and ``-Xptxas -v``; registers, stack frames and spills
   are printed by kernel function.
2. Plans: ``kleene_plan(t)`` for those t up to 512, each with the
   clusters the card can hold at once (``cluster_occupancy``).
3. Checks: every kernel (the baseline, the current one, the variants,
   the step variant at t = 1024) bitwise against ``tile_kleene`` at t =
   128, 200 (13 CTAs, a ragged last warp), 256, 384, 512 (and 1024 for
   the step variant), with and without a negative diagonal. A mismatch
   stops the script.
4. Times at t = 128, 256, 512 and 1024: each kernel called back to back
   (``ms``, what a solve pays) and from CUDA-graph replays (``card_ms``,
   the card alone), in turns (A, B, ..., ..., B, A), beside the bound
   (the card's FP32 rate, chip_smoke's ``bound``) and the cluster's own
   floor (2 t^3 FP32 instructions on its 16 of the card's SMs).
5. Solves: chip_smoke's ER-2048 (``FW_SPEC``, integer weights) and
   ER-1024 (``ER_SPEC``) over all sources at default config
   (``fw-tile``) with the current kernel and with the baseline in its
   place, and ER-2048 on ``dense-squaring-pallas``, in turns,
   ``--solve-runs`` times each, on the host clock; rows bitwise equal.
6. f64 (``pj_fw_kleene_f64``): the current kernel (in rounds of
   ``KLEENE_STEPS_F64`` steps per hand-over), beside each
   ``--f64-baseline`` (a source whose ``pj_fw_kleene_f64`` and
   ``pj_fw_kleene_steps_f64`` have the first f64 kernel's C entry points
   (the current ones too; its plan is the f32 one, one step per
   hand-over): ``git show f3bebf2:paralleljohnson_tpu_torch/
   csrc/fw_kleene.cu``, or that file with another min) and each
   ``--f64-variant`` (the current entry points, e.g. another layout or
   closure, under the same plan): each bitwise
   ``tile_kleene`` at f64 at t = 128, 200, 256, 384, 512 (and the step
   variants at 1024), with and without a negative diagonal; then timed in
   turns at t = 512 (back to back and from CUDA-graph replays) and, the
   step variants, at t = 1024, beside the FP64 bound and the cluster's
   floor. ``--f64-only`` runs this part alone.

Prints the card's name and power limit, then one JSON line per part.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from chip_smoke import (  # noqa: E402
    ER_SPEC, FW_SPEC, PEAK_F32_INSTR_S, PEAK_F64_INSTR_S, bound, event_ms,
    graph_ms, ptxas_functions, solver_on, sync_time,
)
from test_torch_cuda import fw_tile_matrix  # noqa: E402

CHECK_T = (128, 200, 256, 384, 512)
TIME_T = (128, 256, 512, 1024)


def build(src: Path, workdir: str, name: str):
    """The library built from ``src`` and its ptxas rows by function."""
    from paralleljohnson_tpu_torch.ops import _cuda

    lib = Path(workdir) / f"lib{name}.so"
    out = subprocess.run(
        [_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
         str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib)), ptxas_functions(out.stdout + out.stderr)


def baseline_kleene(lib):
    """A ``fw_kleene``-like function on the step kernel's first C entry
    point (scratch allocated when None)."""
    import torch

    fn = lib.pj_fw_kleene
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def kleene(d, *, out=None, scratch=None):
        t = d.shape[0]
        out = torch.empty((t, t), device=d.device) if out is None else out
        if scratch is None or scratch.shape[0] != 2:
            scratch = torch.empty((2, t, t), device=d.device)
        err = fn(d.data_ptr(), d.stride(0), out.data_ptr(), out.stride(0),
                 scratch[0].data_ptr(), scratch[1].data_ptr(), t,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: cudaError {err}")
        return out

    return kleene


def variant_kleene(lib):
    """A ``fw_kleene``-like function on a variant source's cluster entry
    point, given ``kleene_plan(t)``."""
    import torch

    from paralleljohnson_tpu_torch.ops import _cuda, fw

    fn = lib.pj_fw_kleene
    fn.argtypes = list(_cuda.SIGNATURES["fw_kleene"]["pj_fw_kleene"])
    fn.restype = ctypes.c_int

    def kleene(d, *, out=None, scratch=None):
        t = d.shape[0]
        p = fw.kleene_plan(t)
        out = torch.empty((t, t), device=d.device) if out is None else out
        err = fn(d.data_ptr(), d.stride(0), out.data_ptr(), out.stride(0), t,
                 p.rows, p.cols, p.threads, p.smem_bytes,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant launch failed: cudaError {err}")
        return out

    return kleene


def kernels(baseline: Path | None, variants: list[Path], tmp: str) -> dict:
    """Part 1: the kernels by name, each a ``fw_kleene``-like function."""
    from paralleljohnson_tpu_torch.ops import _cuda, fw

    logs = _cuda.build_all()
    builds = {"current": ptxas_functions(logs["fw_kleene"])}
    fns = {}
    if baseline:
        lib, builds["baseline"] = build(baseline, tmp, "fw_kleene_baseline")
        fns["baseline"] = baseline_kleene(lib)
    fns["cluster"] = fw.fw_kleene
    for k, path in enumerate(variants):
        name = f"variant{k}:{path.name}"
        lib, builds[name] = build(path, tmp, f"fw_kleene_variant{k}")
        fns[name] = variant_kleene(lib)
    print(json.dumps({"builds": builds}), flush=True)
    return fns


def plans() -> None:
    """Part 2."""
    import torch

    from paralleljohnson_tpu_torch.ops import fw

    dev = torch.cuda.current_device()
    rows = [{"t": t, "plan": fw.kleene_plan(t)._asdict(),
             "clusters_on_card": fw.cluster_occupancy(fw.kleene_plan(t), dev)}
            for t in CHECK_T]
    print(json.dumps({"plans": rows}), flush=True)


def checks(fns: dict) -> None:
    """Part 3."""
    import torch

    from paralleljohnson_tpu_torch.ops import fw

    dev = torch.device("cuda")
    rows, wants = [], {}
    cases = [(name, t) for name in fns for t in CHECK_T]
    cases += [("step", 1024)] + ([("baseline", 1024)] if "baseline" in fns
                                 else [])
    for name, t in cases:
        fn = fns.get(name, fw.fw_kleene)
        for neg in (False, True):
            m = torch.as_tensor(fw_tile_matrix(t, t, negative_diagonal=neg))
            if (t, neg) not in wants:
                wants[t, neg] = fw.tile_kleene(m)
            got = fn(m.to(dev)).cpu()
            row = {"kernel": name, "t": t, "negative_diagonal": neg,
                   "equal": torch.equal(got, wants[t, neg])}
            rows.append(row)
            if not row["equal"]:
                print(json.dumps({"checks": rows}), flush=True)
                raise AssertionError(f"{name} disagrees with tile_kleene: {row}")
    print(json.dumps({"checks": rows}), flush=True)


def times(fns: dict) -> None:
    """Part 4."""
    import torch

    from paralleljohnson_tpu_torch.ops import fw

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for t in TIME_T:
        m = torch.as_tensor(fw_tile_matrix(t, t)).to(dev)
        dst = torch.empty((t, t), device=dev)
        scratch = torch.empty((2, t, t), device=dev)
        plan = fw.kleene_plan(t)
        names = [n for n in fns if t <= fw.KLEENE_CLUSTER_MAX_T
                 or not n.startswith(("cluster", "variant"))]
        if t > fw.KLEENE_CLUSTER_MAX_T:
            fns = {**fns, "step": fw.fw_kleene}
            names.append("step")
        res = {}
        for name in names + names[::-1]:
            fn = fns[name]
            call = lambda: fn(m, out=dst, scratch=scratch)
            res.setdefault(name, {"ms": [], "card_ms": []})
            res[name]["ms"].append(event_ms(call, reps=20))
            res[name]["card_ms"].append(graph_ms(call, reps=5))
        bms, by = bound(8 * t * t, 2 * t ** 3)
        row = {"t": t, "plan": plan._asdict(), "bound_ms": bms, "bound_by": by,
               "kernels": res}
        if plan.variant == "cluster":
            row["cluster_floor_ms"] = 2 * t ** 3 / (
                PEAK_F32_INSTR_S * plan.cluster / sms) * 1e3
        print(json.dumps(row), flush=True)
        del m, dst, scratch
    torch.cuda.empty_cache()


def solves(fns: dict, runs: int) -> None:
    """Part 5."""
    import numpy as np
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.ops import fw
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy

    er2048 = pjt.load_graph(FW_SPEC)
    er2048 = er2048.with_weights(np.random.default_rng(22).integers(
        1, 10, er2048.num_real_edges).astype(np.float32))
    er1024 = pjt.load_graph(ER_SPEC)
    current = fw.fw_kleene
    kinds = {"fw_current": ({}, current), "squaring": (
        {"fw": False, "dense_threshold": 2048, "dense_min_density": 0},
        current)}
    if "baseline" in fns:
        kinds["fw_baseline"] = ({}, fns["baseline"])
    for label, g, names in (("er2048", er2048, list(kinds)),
                            ("er1024", er1024, [k for k in kinds
                                                if k.startswith("fw")])):
        walls, rows, routes = {}, {}, {}
        order = names + names[::-1]
        try:
            for rep in range(runs):
                for name in (order if rep % 2 == 0 else order[::-1]):
                    kw, kleene = kinds[name]
                    fw.fw_kleene = kleene
                    res, secs = sync_time(lambda: solver_on(
                        torch.device("cuda"), **kw).solve(g))
                    walls.setdefault(name, []).append(secs)
                    routes[name] = res.stats.routes_by_phase["fanout"]
                    rows[name] = to_numpy(res.dist)
                    del res
        finally:
            fw.fw_kleene = current
        fw_rows = rows["fw_current"]
        equal = {n: bool(np.array_equal(r, fw_rows)) for n, r in rows.items()}
        print(json.dumps({"solve": label, "V": g.num_nodes, "walls_s": walls,
                          "routes": routes, "rows_equal_fw_current": equal}),
              flush=True)
        if not all(equal.values()):
            raise AssertionError(f"{label}: rows differ: {equal}")


def f64_kernels(baselines: list[Path], variants: list[Path],
                tmp: str) -> dict:
    """Part 6's kernels by name: (closure at t, step variant), each a
    function of (d, out, scratch)."""
    import torch

    from paralleljohnson_tpu_torch.ops import _cuda, fw

    f64 = torch.float64
    builds = {"current": [f for f in ptxas_functions(
        _cuda.build_all()["fw_kleene"]) if "Id" in f["function"]]}
    fns = {"current": lambda d, out, scratch: fw.fw_kleene(
        d, out=out, scratch=scratch)}
    for k, path in enumerate(variants):
        lib, builds[f"variant{k}:{path.name}"] = build(
            path, tmp, f"fw_kleene_f64_variant{k}")
        lib.pj_fw_kleene_f64.argtypes = list(
            _cuda.SIGNATURES["fw_kleene"]["pj_fw_kleene_f64"])

        def variant(d, out, scratch, lib=lib):
            t = d.shape[0]
            if t > fw.KLEENE_CLUSTER_MAX_T:
                return fw.fw_kleene(d, out=out, scratch=scratch)
            out = torch.empty((t, t), dtype=f64, device=d.device) \
                if out is None else out
            p = fw.kleene_plan(t, 8)
            err = lib.pj_fw_kleene_f64(
                d.data_ptr(), d.stride(0), out.data_ptr(), out.stride(0),
                t, p.rows, p.cols, p.threads, p.smem_bytes,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant launch failed: {err}")
            return out
        fns[f"variant{k}:{path.name}"] = variant
    for k, path in enumerate(baselines):
        name = f"baseline{k}:{path.name}"
        lib, builds[name] = build(path, tmp, f"fw_kleene_f64_baseline{k}")
        lib.pj_fw_kleene_f64.argtypes = list(
            _cuda.SIGNATURES["fw_kleene"]["pj_fw_kleene"])
        lib.pj_fw_kleene_steps_f64.argtypes = list(
            _cuda.SIGNATURES["fw_kleene"]["pj_fw_kleene_steps"])

        def first(d, out, scratch, lib=lib):
            t = d.shape[0]
            out = torch.empty((t, t), dtype=f64, device=d.device) \
                if out is None else out
            stream = torch.cuda.current_stream().cuda_stream
            if t <= fw.KLEENE_CLUSTER_MAX_T:
                p = fw.kleene_plan(t)  # one step per hand-over: its shape
                err = lib.pj_fw_kleene_f64(
                    d.data_ptr(), d.stride(0), out.data_ptr(), out.stride(0),
                    t, p.rows, p.cols, p.threads,
                    16 + 8 * (2 * p.cols + 3 * p.rows), stream)
            else:
                if scratch is None:
                    scratch = torch.empty((2, t, t), dtype=f64,
                                          device=d.device)
                err = lib.pj_fw_kleene_steps_f64(
                    d.data_ptr(), d.stride(0), out.data_ptr(), out.stride(0),
                    scratch[0].data_ptr(), scratch[1].data_ptr(), t, stream)
            if err:
                raise RuntimeError(f"{name} launch failed: cudaError {err}")
            return out
        fns[name] = first
    print(json.dumps({"f64_builds": builds}), flush=True)
    return fns


def f64_part(baselines: list[Path], variants: list[Path], tmp: str) -> None:
    """Part 6."""
    import torch

    from paralleljohnson_tpu_torch.ops import fw

    dev = torch.device("cuda")
    f64 = torch.float64
    fns = f64_kernels(baselines, variants, tmp)
    rows = []
    for t in CHECK_T + (1024,):
        for neg in (False, True):
            m = torch.as_tensor(fw_tile_matrix(t, t, negative_diagonal=neg)
                                ).double()
            m[torch.isfinite(m)] += 1e-9  # values f32 cannot hold
            want = fw.tile_kleene(m)
            for name, fn in fns.items():
                got = fn(m.to(dev), None, None).cpu()
                row = {"kernel": name, "t": t, "negative_diagonal": neg,
                       "equal": torch.equal(got, want)}
                rows.append(row)
                if not row["equal"]:
                    print(json.dumps({"f64_checks": rows}), flush=True)
                    raise AssertionError(f"{name} disagrees with "
                                         f"tile_kleene: {row}")
    print(json.dumps({"f64_checks": rows}), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for t in (fw.KLEENE_CLUSTER_MAX_T, 1024):
        m = torch.as_tensor(fw_tile_matrix(t, t)).double().to(dev)
        dst = torch.empty((t, t), dtype=f64, device=dev)
        scratch = torch.empty((2, t, t), dtype=f64, device=dev)
        kernels = dict(fns)
        if t > fw.KLEENE_CLUSTER_MAX_T:  # the port's one step variant
            kernels = {"step": fns["current"],
                       **{n: f for n, f in fns.items()
                          if n.startswith("baseline")}}
        names = list(kernels)
        res = {}
        for name in names + names[::-1]:
            call = lambda: kernels[name](m, dst, scratch)
            res.setdefault(name, {"ms": [], "card_ms": []})
            res[name]["ms"].append(event_ms(call, reps=20))
            res[name]["card_ms"].append(graph_ms(call, reps=5))
        bms, by = bound(16 * t * t, 2 * t ** 3, instr_s=PEAK_F64_INSTR_S)
        row = {"f64_t": t, "bound_ms": bms, "bound_by": by, "kernels": res}
        if t <= fw.KLEENE_CLUSTER_MAX_T:
            plan = fw.kleene_plan(t, 8)
            row["plan"] = plan._asdict()
            row["cluster_floor_ms"] = 2 * t ** 3 / (
                PEAK_F64_INSTR_S * plan.cluster / sms) * 1e3
            row["clusters_on_card"] = fw.cluster_occupancy(plan,
                                                           dev.index or 0)
        print(json.dumps(row), flush=True)
        del m, dst, scratch
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--variant", type=Path, action="append", default=[])
    ap.add_argument("--solve-runs", type=int, default=2)
    ap.add_argument("--f64-baseline", type=Path, action="append", default=[])
    ap.add_argument("--f64-variant", type=Path, action="append", default=[])
    ap.add_argument("--f64-only", action="store_true")
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
    with tempfile.TemporaryDirectory() as tmp:
        if not args.f64_only:
            fns = kernels(args.baseline, args.variant, tmp)
            plans()
            checks(fns)
            times(fns)
            if args.solve_runs:
                solves(fns, args.solve_runs)
        f64_part(args.f64_baseline, args.f64_variant, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
