#!/usr/bin/env python3
"""Run chip_smoke's phase 17 (the dirty window and the priced planner) on
its own, on one CUDA card.

    python3 scripts/torch_dirty_window.py

Builds the hand kernels (as chip_smoke's phase 1 does, so no solve pays
a compile), generates R-MAT-20 (phase 17's second evidence graph), then
runs ``chip_smoke.drive_dirty_window``. Prints the card's name and power
limit, the phase's three JSON lines and the launch counts by path.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import RMAT_SPEC, drive_dirty_window, emit  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_dirty_window: no CUDA card", file=sys.stderr)
        return 2

    import paralleljohnson_tpu_torch as pjt
    from paralleljohnson_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _cuda.build_all()
    t1 = time.perf_counter()
    rmat = pjt.load_graph(RMAT_SPEC)
    emit({"build_s": t1 - t0, "rmat_generation_s": time.perf_counter() - t1})
    launches = drive_dirty_window(torch.device("cuda"), rmat)
    emit({"launches_by_path": launches, "power_limit": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
