#!/usr/bin/env python3
"""Run chip_smoke's phases 19-20 (the distributed fleet and incremental
repair) and the bench harness's ``distributed_fleet`` and
``incremental_update`` configs at ``full`` on their own, on one CUDA card.

    python3 scripts/torch_fleet_repair.py [--repair-side 96]

Builds the hand kernels (as chip_smoke's phase 1 does, so the fleet's
workers load them instead of compiling), then runs
``chip_smoke.drive_fleet`` and ``chip_smoke.drive_repair`` (phase 20 on a
``--repair-side`` lattice, chip_smoke's ``REPAIR_SIDE`` by default), then
``benchmarks.run`` over the two configs. Prints the card's name and power
limit, each phase's JSON line, the two rows and the launch counts by
path; exits 1 if a phase or a row failed.
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
    ap.add_argument("--repair-side", type=int, default=chip_smoke.REPAIR_SIDE)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_fleet_repair: no CUDA card", file=sys.stderr)
        return 2

    from paralleljohnson_tpu_torch import benchmarks
    from paralleljohnson_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _cuda.build_all()
    chip_smoke.emit({"build_s": time.perf_counter() - t0})
    chip_smoke.REPAIR_SIDE = args.repair_side
    dev = torch.device("cuda")
    launches, failed = {}, []
    for name, drive in (("fleet", chip_smoke.drive_fleet),
                        ("repair", chip_smoke.drive_repair)):
        try:
            launches.update(drive(dev))
        except Exception:  # noqa: BLE001 — report, run the next phase
            traceback.print_exc()
            failed.append(name)
    for rec in benchmarks.run(["distributed_fleet", "incremental_update"],
                              preset="full", device=dev):
        print(rec.as_json_line(), flush=True)
        if "failed" in rec.detail:
            failed.append(rec.config)
    chip_smoke.emit({"launches_by_path": launches, "failed": failed,
                     "power_limit": smi})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
