"""Run one cell of the benchmark once and print its result line.

    python3 pjbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Needs as many CUDA cards as the cell asks
for (exit 2 and no result line otherwise). The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``check`` last: each compared number beside its limit, which also end
standard error. Every build and kernel cache goes to ``pjbench/.cache``
in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "pjbench" / ".cache"
# Before torch loads: its and CUDA's own caches, at fixed paths in the
# checkout.
for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "cuda"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)
# The program's profile store, rank devices and build directory: a run
# takes none from its environment (no file an earlier run left behind).
for var in ("PJ_PROFILE_DIR", "PJ_MESH_DEVICES", "PJ_COMPILE_CACHE"):
    os.environ.pop(var, None)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(f"pjbench: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from pjbench import harness, manifest

    cell = manifest.cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        log("no CUDA card: torch.cuda.is_available() is false")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t_start=T_START,
                           log=log)
    loaded = harness.forbidden_loaded()
    if loaded:
        log(f"forbidden modules loaded: {', '.join(loaded)}")
        return 3
    for name, n in out["check"].items():
        log(f"check {name} {n['value']} limit {n['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
