#!/usr/bin/env python3
"""Run chip_smoke's phase 24 (the mesh: ``parallel.mesh`` on ranks that
share one CUDA card) on its own.

    python3 scripts/torch_mesh.py
    python3 scripts/torch_mesh.py --processes 4

Builds the hand kernels (as chip_smoke's phase 1 does), solves what
phase 24 is held against on the single card (phase 3's R-MAT-20 rows over
512 sources on ``pallas-vm``; phase 13's rows of the negative 512x512 grid
over phase 4's 256 sources with trees), then runs ``chip_smoke.drive_mesh``.
Prints the card's name and power limit, each step's JSON line and the
launch counts by path; exits 1 if the phase failed.

``--processes N`` runs only phase 24's multi-process path
(``chip_smoke.mesh_processes``) with N processes in place of two: a
process per card where there are N cards, so NCCL; gloo where they
share. Its rows are held bitwise to a single-card solve.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh: no CUDA card", file=sys.stderr)
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
    if args.processes:
        try:
            chip_smoke.emit(chip_smoke.mesh_processes(args.processes, dev))
        except Exception:  # noqa: BLE001 — report and exit non-zero
            traceback.print_exc()
            return 1
        return 0
    t0 = time.perf_counter()
    rmat = pjt.load_graph(chip_smoke.RMAT_SPEC)
    rmat_sources = np.sort(np.random.default_rng(1).choice(
        rmat.num_nodes, 512, replace=False))
    rmat_rows = to_numpy(chip_smoke.solver_on(dev).solve(
        rmat, rmat_sources).dist)
    grid = pjt.load_graph(chip_smoke.GRID_SPEC)
    gsrc = np.sort(np.random.default_rng(2).choice(
        grid.num_nodes, 256, replace=False))
    grid_pred_rows = to_numpy(chip_smoke.solver_on(dev).solve(
        grid, gsrc, predecessors=True).dist)
    chip_smoke.emit({"single_card_rows_s": time.perf_counter() - t0})
    try:
        launches = chip_smoke.drive_mesh(dev, rmat, rmat_sources, rmat_rows,
                                         grid, gsrc, grid_pred_rows)
    except Exception:  # noqa: BLE001 — report and exit non-zero
        traceback.print_exc()
        return 1
    chip_smoke.emit({"launches_by_path": launches, "power_limit": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
