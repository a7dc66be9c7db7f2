#!/usr/bin/env python3
"""Run the PyTorch port's bench configs and print one JSON line per row.

    python3 scripts/torch_bench.py [CONFIG ...] [--preset full]
        [--backend torch|cpp|numpy] [--device cuda|cpu]
        [--trace-dir DIR] [--profile-dir DIR]

The same as ``python -m paralleljohnson_tpu_torch bench [CONFIG ...]
--profile-store DIR ...``, to which it forwards: it runs
``paralleljohnson_tpu_torch.benchmarks.run`` for the named configs (all
of ``CONFIGS`` when none is named) and prints each
``BenchRecord.as_json_line()``. ``--trace-dir`` turns on the flight
recorder per config, ``--profile-dir`` the profile store and the
bench-regression history. ``PJ_BENCH_RMAT_SCALE=22`` runs ``rmat_apsp``
at R-MAT-22 (row name ``rmat_apsp_s22``). On ``cuda`` the card's name and
power limit go to stderr first. Exits 1 when a row carries ``failed``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from paralleljohnson_tpu_torch import benchmarks, cli

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", metavar="CONFIG",
                    help=f"any of {sorted(benchmarks.CONFIGS)}")
    ap.add_argument("--preset", default="mini", choices=benchmarks._PRESETS)
    ap.add_argument("--backend", default="torch",
                    choices=("torch", "cpp", "numpy"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--profile-dir", default=None)
    args = ap.parse_args(argv)

    forward = ["bench", *args.configs, "--preset", args.preset,
               "--backend", args.backend, "--device", args.device]
    if args.trace_dir is not None:
        forward += ["--trace-dir", args.trace_dir]
    if args.profile_dir is not None:
        forward += ["--profile-store", args.profile_dir]
    return cli.main(forward)


if __name__ == "__main__":
    sys.exit(main())
