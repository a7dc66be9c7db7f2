#!/usr/bin/env python3
"""Run chip_smoke's phases 21-22 (the serving tier and the certified
approximate tier) and the bench harness's ``serve_queries`` and
``approx_apsp`` configs at ``full`` on their own, on one CUDA card.

    python3 scripts/torch_serve_approx.py [--no-bench]

Builds the hand kernels (as chip_smoke's phase 1 does), generates
R-MAT-20 (phase 22's multi-chunk hopset check), then runs
``chip_smoke.drive_serve`` (which also runs ``serve_overload`` at full)
and ``chip_smoke.drive_approx``, then ``benchmarks.run`` over the two
configs unless ``--no-bench``. Prints the card's name and power limit,
each phase's JSON line, the rows and the launch counts by path; exits 1
if a phase or a row failed.
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
    ap.add_argument("--no-bench", action="store_true",
                    help="skip the two bench configs after the phases")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_serve_approx: no CUDA card", file=sys.stderr)
        return 2

    import paralleljohnson_tpu_torch as pjt
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
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rmat = pjt.load_graph(chip_smoke.RMAT_SPEC)
    chip_smoke.emit({"rmat_load_s": time.perf_counter() - t0})
    launches, errs, failed = {}, [], []
    for name, drive in (("serve", lambda: chip_smoke.drive_serve(dev)),
                        ("approx", lambda: chip_smoke.drive_approx(dev,
                                                                   rmat))):
        try:
            paths, phase_errs = drive()
            launches.update(paths)
            errs += phase_errs
        except Exception:  # noqa: BLE001 — report, run the next phase
            traceback.print_exc()
            failed.append(name)
    if not args.no_bench:
        for rec in benchmarks.run(["serve_queries", "approx_apsp"],
                                  preset="full", device=dev):
            print(rec.as_json_line(), flush=True)
            if "failed" in rec.detail:
                failed.append(rec.config)
    chip_smoke.emit({"launches_by_path": launches, "max_abs_err":
                     max(errs, default=None), "failed": failed,
                     "power_limit": smi})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
