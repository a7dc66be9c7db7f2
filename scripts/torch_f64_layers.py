#!/usr/bin/env python3
"""Run chip_smoke's phase 26 (``precision="f64"`` above the solver: the
mesh, the fleet, incremental repair, serving and the approximate tier)
on its own.

    python3 scripts/torch_f64_layers.py

Builds the hand kernels (as chip_smoke's phase 1 does), solves what
phase 26 is held against on the single card at f64 (phase 25's R-MAT-20
rows over phase 3's 512 sources; the negative 512x512 grid's rows over
the 64 tree sources, with trees), then runs
``chip_smoke.drive_f64_layers``. Prints the card's name and power limit,
each path's JSON line (wall, launches) and the launch counts by path;
exits 1 if the phase failed.
"""

from __future__ import annotations

import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_f64_layers: no CUDA card", file=sys.stderr)
        return 2

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.ops import _cuda
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _cuda.build_all()
    chip_smoke.emit({"build_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    rmat = pjt.load_graph(chip_smoke.RMAT_SPEC)
    rmat_sources = np.sort(np.random.default_rng(1).choice(
        rmat.num_nodes, 512, replace=False))
    grid = pjt.load_graph(chip_smoke.GRID_SPEC)
    gsrc = np.sort(np.random.default_rng(2).choice(
        grid.num_nodes, 256, replace=False))
    psrc = gsrc[:64]
    with chip_smoke.solver_on(dev, precision="f64") as solver:
        ref64 = {"rmat_rows": to_numpy(solver.solve(rmat, rmat_sources).dist)}
    with chip_smoke.solver_on(dev, precision="f64") as solver:
        ref64.update(grid_pred_sources=psrc, grid_pred_rows=to_numpy(
            solver.solve(grid, psrc, predecessors=True).dist))
    chip_smoke.emit({"single_card_f64_rows_s": time.perf_counter() - t0})
    try:
        launches = chip_smoke.drive_f64_layers(dev, rmat, rmat_sources, grid,
                                               ref64)
    except Exception:  # noqa: BLE001 — report and exit non-zero
        traceback.print_exc()
        return 1
    chip_smoke.emit({"launches_by_path": launches})
    return 0


if __name__ == "__main__":
    sys.exit(main())
