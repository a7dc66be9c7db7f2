#!/usr/bin/env python3
"""Run chip_smoke's phase 15 (the B=1 routes) on its own, on one CUDA
card: the 512x512 grid's default ``solve()`` over phase 4's 256 sources
first (its rows and stats are the phase's inputs), then
``chip_smoke.drive_b1_routes``.

    python3 scripts/torch_b1_routes.py [--repeat N]

``--repeat`` runs the phase N times (default 1) in one process, for the
spread of its host-clock seconds. Then, for each route, one warm
``bellman_ford`` from the same source under ``torch.profiler``: the
device kernels it launched, their summed device time and the wall time
around it (the device's busy share; the rest is the host's per-round
dispatch and reads). Prints the card's name and power limit, phase 15's
JSON line per repeat, the profile line, and the launch counts by path.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    GRID_SPEC, drive_b1_routes, emit, sync_time,
)


ROUTES = {"sweep": {"frontier": False}, "frontier": {},
          "dia": {"dia": True}, "gs": {"gauss_seidel": True},
          "bucket": {"bucket": True}}


def profile_route(dev, grid, source: int, kw: dict) -> dict:
    """One warm ``bellman_ford`` on the route ``kw`` forces, traced:
    rounds, device kernels and their summed device seconds, wall
    seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paralleljohnson_tpu_torch as pjt

    backend = pjt.get_backend("torch", pjt.SolverConfig(**kw), device=dev)
    dgraph = backend.upload(grid)
    backend.bellman_ford(dgraph, source)  # layouts, first launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res, wall = sync_time(lambda: backend.bellman_ford(dgraph, source))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    rounds = max(res.iterations, 1)
    return {"route": res.route, "rounds": res.iterations, "wall_s": wall,
            "kernels": len(kernels), "kernels_per_round": len(kernels) / rounds,
            "device_s": device_s, "device_busy_share": device_s / wall,
            "wall_per_round_ms": wall / rounds * 1e3,
            "device_per_round_ms": device_s / rounds * 1e3}


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_b1_routes: no CUDA card", file=sys.stderr)
        return 2

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    grid = pjt.load_graph(GRID_SPEC)
    gsrc = np.sort(np.random.default_rng(2).choice(
        grid.num_nodes, 256, replace=False))
    res = pjt.ParallelJohnsonSolver(device=dev).solve(grid, gsrc)
    grid_rows = to_numpy(res.dist)[:64].copy()
    cyc = pjt.CSRGraph.from_edges([0, 1, 2, 3], [1, 2, 3, 1],
                                  [1.0, 2.0, -4.0, 1.0], 4)
    for _ in range(args.repeat):
        launches = drive_b1_routes(dev, grid, gsrc, grid_rows, res.stats,
                                   cyc)
    emit({"profile": {name: profile_route(dev, grid, int(gsrc[0]), kw)
                      for name, kw in ROUTES.items()}})
    emit({"launches": launches, "device": torch.cuda.get_device_name(0),
          "power_limit": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
