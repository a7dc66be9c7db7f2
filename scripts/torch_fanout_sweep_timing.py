#!/usr/bin/env python3
"""Time the PyTorch port's f64 fan-out sweep on one CUDA card against an
earlier version of its kernel and against variants, in turns.

    python3 scripts/torch_fanout_sweep_timing.py [--baseline OLD.cu]
        [--variant NEW.cu ...] [--budgets-mb 16,32] [--reps 10]
        [--persisting-l2-mb MB]

The states are ``chip_smoke.py`` phase 25's and phase 4's: R-MAT-20 at
B = 512 and 128 (the sources phase 25 draws), and the 512x512 negative
grid, reweighted by its f64 solve, at B = 256 (phase 4's sources), each
after 3 sweeps from its sources, in float64.

``--baseline`` names a sweep source whose ``pj_fanout_sweep_f64`` takes
no hub flags (``git show
f3bebf2:paralleljohnson_tpu_torch/csrc/fanout_sweep.cu``, the first f64
kernel). The current kernel runs with the hub flags ``hub_flags`` builds
at ``HUB_L2_BYTES``, without any (its plain loads, as on a graph without
hubs), and with the flags at each ``--budgets-mb``; each ``--variant``
source (the current C ABI, e.g. the current file with another gather
depth, made with ``sed``) with the flags at each budget. Every source is
built with the port's ``nvcc`` flags and ``-Xptxas -v`` (registers and
spills are printed). All run on
the same state first and must agree bitwise (rows and flag); then each
is timed in turns (A, B, ..., ..., B, A): ``--reps`` sweeps between two
CUDA events, alternating two buffers as the fixpoint does, so a sweep
reads what the one before it wrote. The SM clock and power that
``nvidia-smi`` read while the turns ran are printed beside the times,
with the hub set's size, its bytes one pass wide and its share of the
edges, and the sweep's bound (chip_smoke's: bytes).

``--persisting-l2-mb`` then sets the CUDA context's persisting-L2 limit
(``cudaLimitPersistingL2CacheSize``, this process only) and times the
turns again.

Prints the card's name and power limit, then one JSON line per state.
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

from chip_smoke import (  # noqa: E402
    GRID_SPEC, PEAK_F64_INSTR_S, RMAT_SPEC, bound, f64_templates,
)
from torch_minplus_timing import smi_samples  # noqa: E402

SWEEPS_BEFORE = 3


def states():
    """Yields (label, dist [V, B] f64, CSC with f64 weights, work items,
    V) for R-MAT-20 at B = 512 and 128 and the reweighted grid at 256."""
    import numpy as np
    import torch

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
    from paralleljohnson_tpu_torch.ops.fanout_sweep import fanout_fixpoint

    dev = torch.device("cuda")
    f64 = torch.float64

    def start(layout, items, v, sources):
        d = torch.full((v, len(sources)), float("inf"), dtype=f64,
                       device=dev)
        d[torch.as_tensor(sources, device=dev),
          torch.arange(len(sources), device=dev)] = 0.0
        return fanout_fixpoint(d, *layout, max_iter=SWEEPS_BEFORE,
                               items=items)[0]

    rmat = pjt.load_graph(RMAT_SPEC)
    v = rmat.num_nodes
    dg = TorchBackend(pjt.SolverConfig(precision="f64"),
                      device=dev).upload(rmat)
    layout, items = dg.fanout_layout()
    rng = np.random.default_rng(25)  # chip_smoke phase 25: 128, then 512
    picks = {b: rng.choice(v, b, replace=False) for b in (128, 512)}
    for b in (512, 128):
        yield f"rmat20_B{b}", start(layout, items, v, picks[b]), layout, \
            items, v
    del dg, layout, items

    class Probe(TorchBackend):
        fanout_graph = None

        def multi_source(self, dgraph, sources):
            self.fanout_graph = dgraph
            return super().multi_source(dgraph, sources)

    grid = pjt.load_graph(GRID_SPEC)
    gsrc = np.sort(np.random.default_rng(2).choice(grid.num_nodes, 256,
                                                   replace=False))
    probe = Probe(pjt.SolverConfig(precision="f64"), device=dev)
    pjt.ParallelJohnsonSolver(backend=probe).solve(grid, gsrc)
    layout, items = probe.fanout_graph.fanout_layout()
    yield "grid512_B256", start(layout, items, grid.num_nodes, gsrc), \
        layout, items, grid.num_nodes


def build(src: Path, workdir: str, name: str, argtypes):
    """(the source's ``pj_fanout_sweep_f64``, its f64 ptxas lines)."""
    from paralleljohnson_tpu_torch.ops import _cuda

    lib = Path(workdir) / f"lib{name}.so"
    out = subprocess.run(
        [_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
         str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).pj_fanout_sweep_f64
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn, f64_templates({"fanout_sweep": out.stdout + out.stderr})


def persisting_l2(mb: int) -> dict:
    """Set this process's persisting-L2 limit; the card's L2 size, the
    most it allows, and the limit read back."""
    from torch.utils.cpp_extension import CUDA_HOME

    rt = ctypes.CDLL(str(Path(CUDA_HOME) / "lib64" / "libcudart.so"))
    size = ctypes.c_size_t(0)
    l2, most = ctypes.c_int(0), ctypes.c_int(0)
    rt.cudaDeviceGetAttribute(ctypes.byref(l2), 89, 0)    # L2 bytes
    rt.cudaDeviceGetAttribute(ctypes.byref(most), 108, 0)  # max persisting
    err = rt.cudaDeviceSetLimit(0x06, ctypes.c_size_t(mb << 20))
    rt.cudaDeviceGetLimit(ctypes.byref(size), 0x06)
    return {"l2_bytes": l2.value, "max_persisting_bytes": most.value,
            "set_error": err, "limit_bytes": size.value}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--variant", type=Path, action="append", default=[])
    ap.add_argument("--budgets-mb", default="")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--persisting-l2-mb", type=int)
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

    from paralleljohnson_tpu_torch.ops import _cuda
    from paralleljohnson_tpu_torch.ops import fanout_sweep as fs

    new_abi = _cuda.SIGNATURES["fanout_sweep"]["pj_fanout_sweep_f64"]
    old_abi = new_abi[:5] + new_abi[6:]
    budgets = [int(x) << 20 for x in args.budgets_mb.split(",") if x]
    f64 = torch.float64
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"current": _cuda.lib("fanout_sweep").pj_fanout_sweep_f64}
        builds = {"current": f64_templates(
            {"fanout_sweep": _cuda.build_all()["fanout_sweep"]})}
        if args.baseline:
            fns["baseline"], builds["baseline"] = build(
                args.baseline, tmp, "baseline", old_abi)
        for n, path in enumerate(args.variant):
            name = f"variant{n}:{path.name}"
            fns[name], builds[name] = build(path, tmp, f"variant{n}", new_abi)
        print(json.dumps({"builds": builds}), flush=True)
        for label, d, (ip, s, w), itm, v in states():
            b = d.shape[1]
            e = s.shape[0]
            bufs = (d, torch.empty_like(d))
            scratch = torch.empty((itm.n_split, b), dtype=f64,
                                  device=d.device)
            one = torch.ones(1, dtype=torch.int32, device=d.device)
            flag = torch.zeros(1, dtype=torch.int32, device=d.device)
            deg = torch.bincount(s.long(), minlength=v)
            row_bytes = fs.hub_row_bytes(b)
            hubs = {"hubs": fs.hub_flags(s, v, b, f64), "no hubs": None}
            sets = {"hubs": fs.hub_sources(deg, row_bytes)}
            for budget in budgets:
                key = f"hubs {budget >> 20} MB"
                hubs[key] = fs.hub_flags(s, v, b, f64, budget=budget)
                sets[key] = fs.hub_sources(deg, row_bytes, budget=budget)
            runs = ([("baseline", None)] if "baseline" in fns else []) + [
                ("current", k) for k in hubs] + [
                (n, k) for n in fns if n.startswith("variant")
                for k in hubs if k != "no hubs"]

            def call(name, hub_key, src, dst):
                h = hubs.get(hub_key)
                extra = () if name == "baseline" else (
                    None if h is None else h.data_ptr(),)
                err = fns[name](
                    src.data_ptr(), dst.data_ptr(), ip.data_ptr(),
                    s.data_ptr(), w.data_ptr(), *extra,
                    itm.pieces.data_ptr(), itm.n_split, v, itm.item_edges,
                    scratch.data_ptr(), itm.split_rows.data_ptr(),
                    itm.split_ptr.data_ptr(), itm.split_rows.shape[0],
                    one.data_ptr(), flag.data_ptr(), b,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            want, imp = fs.fanout_sweep_plain(d, ip, s, w)
            for name, key in runs:
                flag.zero_()
                call(name, key, d, bufs[1])
                torch.cuda.synchronize()
                if not torch.equal(bufs[1], want) or bool(flag.item()) \
                        != bool(imp):
                    raise AssertionError(f"{label}: {name} ({key}) differs "
                                         f"from the plain sweep")
            del want

            def turns():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                times: dict[str, list[float]] = {}
                stop = smi_samples()
                for name, key in runs + runs[::-1]:
                    call(name, key, bufs[0], bufs[1])  # warm-up
                    torch.cuda.synchronize()
                    start.record()
                    for r in range(args.reps):
                        call(name, key, bufs[r % 2], bufs[(r + 1) % 2])
                    end.record()
                    torch.cuda.synchronize()
                    times.setdefault(f"{name} ({key})" if key else name,
                                     []).append(
                        start.elapsed_time(end) / args.reps)
                samples = stop()
                return {"ms": times,
                        "sm_clock_mhz": sorted(c for c, *_ in samples),
                        "power_w": sorted(p for *_, p in samples)}

            row = {"state": label, "V": v, "B": b, "E": e,
                   "bound_ms": bound(8 * 2 * v * b + 4 * (v + 1) + 12 * e,
                                     2 * e * b,
                                     instr_s=PEAK_F64_INSTR_S)[0],
                   "pass_columns": fs.pass_columns(
                       b, 8, hubs=hubs["hubs"] is not None),
                   "occupancy": fs.occupancy(b, dtype=f64,
                                             hubs=hubs["hubs"] is not None),
                   "hub_sets": {
                       k: {"sources": int(h.numel()),
                           "bytes_one_pass": int(h.numel()) * row_bytes,
                           "edge_share": float(deg[h].sum()) / max(1, e),
                           "least_out_degree": (int(deg[h].min())
                                                if h.numel() else None)}
                       for k, h in sets.items()},
                   "turns": turns()}
            if args.persisting_l2_mb is not None:
                row["persisting_l2"] = persisting_l2(args.persisting_l2_mb)
                row["turns_persisting_l2"] = turns()
                persisting_l2(0)
            print(json.dumps(row), flush=True)
            del d, bufs, scratch, hubs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
