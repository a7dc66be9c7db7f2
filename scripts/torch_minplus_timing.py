#!/usr/bin/env python3
"""Time the PyTorch port's min-plus product on one CUDA card against an
earlier version of its kernel, and the dense iterate regime's grouped
fixpoint against a loop that reads the host once per product.

    python3 scripts/torch_minplus_timing.py [--baseline OLD.cu]
        [--f64-baseline OLD.cu] [--f64-variant NEW.cu ...]
        [--f64-plans ROWS:SPLITS,...] [--f64-only]

1. The products of ``chip_smoke.MINPLUS_SHAPES`` (I x 1024 x 1024 for I
   = 16, 128, 511, 1024, and 4096^3): the card's time per product from
   CUDA-graph replays (``chip_smoke.graph_ms``) beside its bound
   (``chip_smoke.minplus_bound``). ``--baseline`` names a min-plus source
   whose C entry point is ``pj_minplus(d, a, out, I, K, J, stream)``, as
   the first version of the kernel had (``git show
   <commit>:paralleljohnson_tpu_torch/csrc/minplus.cu``). It is built with
   the port's ``nvcc`` flags and timed on the same inputs in turns with
   the current kernel (baseline, current, current, baseline); the two
   must agree bitwise, and with ``minplus_plain`` up to 1024^3. The SM
   clock and power that ``nvidia-smi`` read while the turns ran are
   printed beside the times.
2. The f64 products (``pj_minplus_f64``) at ``MINPLUS_SHAPES[:4]`` and
   ER-1024 ``fw-tile``'s panel products at tile 512 (``FW_SHAPES``):
   ``--f64-baseline`` names a source whose ``pj_minplus_f64`` has the
   current C ABI (``git show
   f3bebf2:paralleljohnson_tpu_torch/csrc/minplus.cu``, the first f64
   kernel), timed under the plan it was tuned for (``first_f64_plan``);
   the current kernel runs under ``minplus_plan(..., 8)``, and also
   under each ``--f64-plans`` entry (tile rows : splits) the tile takes;
   each ``--f64-variant`` source (current ABI, e.g. another
   ``f64_shape`` table made with ``sed``) under ``minplus_plan`` and
   those plans. In turns (A, B, ..., ..., B, A), CUDA-graph replays, each
   against ``minplus_plain`` bitwise, with the SM clock and power.
3. The iterate regime of ``relax.dense_fanout`` on chip_smoke's
   ``er:n=1024,p=0.1,seed=0`` with its 128 sources: the loop with one
   host read per product (no ``fixpoint``) and ``minplus_fixpoint``
   (``PRODUCTS_PER_SYNC`` products per read), in turns (loop, fixpoint,
   fixpoint, loop), 5 runs each, on the host clock around a
   ``torch.cuda.synchronize()``. Both must return the same rows and
   iteration count.

Prints the card's name and power limit, then one JSON line per shape and
one for the fixpoint. ``--f64-only`` runs part 2 alone.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    ER_SPEC, MINPLUS_SHAPES, PEAK_F64_INSTR_S, graph_ms, minplus_bound,
)

# ER-1024 ``fw-tile``'s products at tile 512: the row panel, the column
# panel and the trailing update of each k-step.
FW_SHAPES = ((512, 512, 1024), (1024, 512, 512), (1024, 512, 1024))


def build_baseline(src: Path, workdir: str):
    from paralleljohnson_tpu_torch.ops import _cuda

    lib = Path(workdir) / "libminplus_baseline.so"
    subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    handle = ctypes.CDLL(str(lib))
    handle.pj_minplus.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_void_p]
    handle.pj_minplus.restype = ctypes.c_int
    return handle.pj_minplus


def smi_samples():
    """Start sampling the SM clock and power (nvidia-smi every 100 ms);
    the returned function stops it and returns [[MHz, W], ...]."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)

    def stop():
        proc.terminate()
        samples = []
        for ln in proc.communicate()[0].splitlines():
            try:
                samples.append([float(x) for x in ln.split(",")])
            except ValueError:
                continue
        return samples

    return stop


def first_f64_plan(i: int, k: int, j: int) -> tuple[int, int, int]:
    """(rows, splits, k_split) of the first f64 kernel's plan: 16-row
    tiles up to 16 rows, else 32, and 5 and 3 resident blocks per SM."""
    n = max(i, 1)
    rows = 16 if n <= 16 else 32
    tiles = -(-n // rows) * -(-max(j, 1) // 128)
    splits = min(16, max(1, 132 * {16: 5, 32: 3}[rows] // tiles),
                 max(1, k // 64))
    k_split = 16 * max(1, math.ceil(math.ceil(k / splits) / 16))
    return rows, max(1, -(-k // k_split)), k_split


def split_plan(k: int, rows: int, splits: int) -> tuple[int, int, int]:
    """(rows, splits, k_split) with ``splits`` ranges of K (as
    ``minplus_plan`` cuts them)."""
    k_split = 16 * max(1, math.ceil(math.ceil(k / splits) / 16))
    return rows, max(1, -(-k // k_split)), k_split


def time_f64(baseline: Path | None, variants: list[Path],
             plans: list[tuple[int, int]]) -> None:
    import numpy as np
    import torch

    from paralleljohnson_tpu_torch.ops import _cuda
    from paralleljohnson_tpu_torch.ops import minplus as mp

    dev = torch.device("cuda")
    f64 = torch.float64
    argtypes = _cuda.SIGNATURES["minplus"]["pj_minplus_f64"]
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"current": _cuda.lib("minplus").pj_minplus_f64}
        logs = {}
        sources = ([("baseline", baseline)] if baseline else []) + [
            (f"variant{n}:{v.name}", v) for n, v in enumerate(variants)]
        for name, src in sources:
            lib = Path(tmp) / f"lib{name.replace(':', '_')}.so"
            out = subprocess.run(
                [_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(lib), str(src)],
                check=True, capture_output=True, text=True)
            logs[name] = [ln.strip() for ln in (out.stdout + out.stderr)
                          .splitlines() if "Id" in ln or "registers" in ln
                          or "spill" in ln]
            fn = ctypes.CDLL(str(lib)).pj_minplus_f64
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            builds[name] = fn
        print(json.dumps({"f64_builds": logs}), flush=True)
        for (i, k, j) in (*MINPLUS_SHAPES[:4], *FW_SHAPES):
            rng = np.random.default_rng(7)
            d = torch.as_tensor(rng.random((i, k))).to(dev)
            a = torch.as_tensor(rng.random((k, j))).to(dev)
            out = torch.empty((i, j), dtype=f64, device=dev)
            scratch = torch.empty(16 * i * j, dtype=f64, device=dev)
            want = mp.minplus_plain(d, a)
            runs = []
            if baseline:
                runs.append(("baseline", first_f64_plan(i, k, j)))
            cur = tuple(mp.minplus_plan(i, k, j, 8))
            for name in builds:
                if name == "baseline":
                    continue
                extra = [split_plan(k, r, n) for r, n in plans]
                runs += [(name, p) for p in dict.fromkeys([cur, *extra])]

            def call(fn, plan):
                rows, splits, k_split = plan
                err = fn(d.data_ptr(), a.data_ptr(), out.data_ptr(),
                         scratch.data_ptr(), i, k, j, rows, splits, k_split,
                         None, None, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            ok = []
            for name, plan in runs:
                out.fill_(0.0)
                try:
                    call(builds[name], plan)
                    torch.cuda.synchronize()
                except RuntimeError:  # a tile this build does not have
                    continue
                if not torch.equal(out, want):
                    raise AssertionError(f"{name} {plan} != plain at "
                                         f"{(i, k, j)}")
                ok.append((name, plan))
            stop = smi_samples()
            times: dict[str, list[float]] = {}
            for name, plan in ok + ok[::-1]:
                key = f"{name} rows={plan[0]} splits={plan[1]}"
                times.setdefault(key, []).append(graph_ms(
                    lambda: call(builds[name], plan), reps=20))
            samples = stop()
            bms, by = minplus_bound(i, k, j, itemsize=8,
                                    instr_s=PEAK_F64_INSTR_S)
            row = {"f64_shape": [i, k, j], "plan": list(cur),
                   "bound_ms": bms, "bound_by": by,
                   "sm_clock_mhz": sorted(c for c, *_ in samples),
                   "power_w": sorted(w for *_, w in samples),
                   "card_ms": times,
                   "share_of_bound": {n: bms / min(t)
                                      for n, t in times.items()}}
            print(json.dumps(row), flush=True)
            del d, a, out, scratch, want
            torch.cuda.empty_cache()


def time_products(baseline: Path | None) -> None:
    import numpy as np
    import torch

    from paralleljohnson_tpu_torch.ops import minplus as mp

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        base_fn = build_baseline(baseline, tmp) if baseline else None
        for (i, k, j) in MINPLUS_SHAPES:
            rng = np.random.default_rng(i + k + j)
            d = torch.as_tensor(rng.random((i, k), dtype=np.float32)).to(dev)
            a = torch.as_tensor(rng.random((k, j), dtype=np.float32)).to(dev)
            big = i * k * j > 1 << 30
            reps = 2 if big else 20
            out = torch.empty((i, j), device=dev)
            kernels = [("current", lambda: mp.minplus_kernel(d, a, out=out))]
            if base_fn is not None:
                def baseline_call():
                    err = base_fn(d.data_ptr(), a.data_ptr(), out.data_ptr(),
                                  i, k, j, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"baseline launch: cudaError {err}")
                kernels.insert(0, ("baseline", baseline_call))
            want = None if big else mp.minplus_plain(d, a)
            results = []
            for name, fn in kernels:
                out.fill_(0.0)
                fn()
                torch.cuda.synchronize()
                results.append(out.clone())
                if want is not None and not torch.equal(out, want):
                    raise AssertionError(f"{name} != plain at {(i, k, j)}")
            if not all(torch.equal(r, results[0]) for r in results):
                raise AssertionError(f"baseline != current at {(i, k, j)}")
            # The SM clock and power while the turns run: the bound
            # assumes the 1980 MHz boost clock.
            stop = smi_samples()
            times: dict[str, list[float]] = {}
            for name, fn in kernels + kernels[::-1]:
                times.setdefault(name, []).append(graph_ms(fn, reps))
            samples = stop()
            bms, by = minplus_bound(i, k, j)
            p = mp.minplus_plan(i, k, j)
            row = {"shape": [i, k, j], "reps": reps, "plan": p._asdict(),
                   "bound_ms": bms, "bound_by": by,
                   "sm_clock_mhz": sorted(c for c, *_ in samples),
                   "power_w": sorted(w for *_, w in samples)}
            for name, ts in times.items():
                row[f"{name}_card_ms"] = ts
                row[f"{name}_share_of_bound"] = bms / min(ts)
            print(json.dumps(row), flush=True)
            del d, a, out, want, results
            torch.cuda.empty_cache()


def time_fixpoint() -> None:
    import numpy as np
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.ops import minplus as mp
    from paralleljohnson_tpu_torch.ops import relax

    dev = torch.device("cuda")
    er = pjt.load_graph(ER_SPEC)
    v = er.num_nodes
    a = relax.dense_adjacency(*(torch.as_tensor(x).to(dev) for x in (
        er.src, er.indices, er.weights)), v)
    src = torch.as_tensor(np.sort(np.random.default_rng(4).choice(
        v, 128, replace=False))).to(dev)
    runs = {"loop": None, "fixpoint": mp.minplus_fixpoint}
    times: dict[str, list[float]] = {}
    results = {}
    for name in ["loop", "fixpoint", "fixpoint", "loop"]:
        for _ in range(5):
            launches = mp.minplus_kernel.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d, iters, improving = relax.dense_fanout(
                a, src, max_iter=v, mp=mp.minplus_kernel, fixpoint=runs[name])
            torch.cuda.synchronize()
            times.setdefault(name, []).append(time.perf_counter() - t0)
            results[name] = (d, iters, improving,
                             mp.minplus_kernel.launches - launches)
    (d_l, it_l, imp_l, n_l), (d_f, it_f, imp_f, n_f) = (
        results["loop"], results["fixpoint"])
    if not torch.equal(d_l, d_f) or (it_l, imp_l) != (it_f, imp_f):
        raise AssertionError(f"loop ({it_l}, {imp_l}) and fixpoint "
                             f"({it_f}, {imp_f}) disagree")
    print(json.dumps({
        "fixpoint": ER_SPEC, "sources": 128, "iterations": it_f,
        "products_per_sync": mp.PRODUCTS_PER_SYNC,
        "launches": {"loop": n_l, "fixpoint": n_f},
        "host_clock_s": times,
        "min_ms": {name: min(ts) * 1e3 for name, ts in times.items()}}),
        flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--f64-baseline", type=Path)
    ap.add_argument("--f64-variant", type=Path, action="append", default=[])
    ap.add_argument("--f64-plans", default="",
                    help="extra f64 plans, e.g. 32:1,64:2 (rows:splits)")
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
    plans = [tuple(int(x) for x in p.split(":"))
             for p in args.f64_plans.split(",") if p]
    if not args.f64_only:
        time_products(args.baseline)
    time_f64(args.f64_baseline, args.f64_variant, plans)
    if not args.f64_only:
        time_fixpoint()
    return 0


if __name__ == "__main__":
    sys.exit(main())
