"""The control of the check: the plain reference put in the program's
place, computed one precision lower (bfloat16 for the configurations'
float32), read through the same comparison as a run.

    python3 pjbench/control.py --workload <name> --seeds 11,12,13

For each seed: the cell's graph from that seed, as many sources as a
run checks drawn as a run draws them, then the reference's potentials
and rows in float32 and in the lower precision, and each
compared number of the lower one against the float32 one; where the
graph has negative arcs also the potentials of a phase 1 that returned
its starting state (h = 0), a planted fault. Prints one JSON line per
seed with each number beside the cell's limit; the check is sound where
the control fails at least one limit on every seed. Needs a card (or
``--device cpu`` at a size the CPU holds).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pjbench import check, manifest  # noqa: E402
from pjbench.harness import _source_pool  # noqa: E402
from pjbench.reference import shortest_paths as ref  # noqa: E402


def readings(root: Path, workload: str, seed: int, device,
             dtype=torch.bfloat16) -> dict:
    """The compared numbers of the reference at ``dtype`` against the
    reference at float32, on the cell's graph from ``seed``."""
    cell = manifest.cell(root, workload)
    conf, traffic = cell.config, cell.traffic
    csr = manifest.generator(root, conf["generator"]).build(conf, seed, device)
    pool = _source_pool(csr, traffic.get("source_pool", "all"))
    rng = np.random.default_rng([seed, 1, 1])
    request = pool[rng.choice(pool.shape[0], int(traffic["sources_per_request"]),
                              replace=False)]
    n = min(int(conf["check"]["sample_rows"]), request.shape[0])
    sources = request[np.sort(np.random.default_rng([seed, 3]).choice(
        request.shape[0], n, replace=False))]
    negative = bool((csr["weights"] < 0).any())
    block = int(conf["check"]["block_rows"])
    out = {}
    sides = {}
    for name, dt in (("reference", torch.float32), ("control", dtype)):
        arcs = ref.Arcs(csr, device, dt)
        h = ref.potentials(arcs) if negative else None
        rows = check.reference_rows(arcs, sources, h, block).astype(np.float32)
        sides[name] = {
            "h": None if h is None else h.float().cpu().numpy(),
            "rows": rows,
        }
        del arcs, h
    a, b = sides["reference"], sides["control"]
    if negative:
        out["potentials_differing"] = check.differing(b["h"], a["h"])
        # A phase 1 that returns its starting state (h = 0) in the
        # program's place: the planted fault that the potentials catch.
        out["potentials_differing_phase1_unchanged"] = check.differing(
            np.zeros_like(a["h"]), a["h"])
    out["rows_differing"] = check.differing(b["rows"], a["rows"])
    limits = conf["check"]["limits"]
    return {k: {"value": v, "limit": limits[k.split("_phase1")[0]]}
            for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = readings(ROOT, args.workload, seed, device)
        fails = not check.passed({k: v for k, v in numbers.items()
                                  if "_phase1" not in k})
        failed_all &= fails
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_fails": fails, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
