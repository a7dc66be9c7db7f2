#!/usr/bin/env python3
"""Per-request costs of the serving tier on one CUDA card: what a store
hit and a store miss (one scheduled exact solve) take, called on the
engine directly and through a ``ServeFrontend`` socket, on the
``serve_overload`` config's graph (``grid2d(40, 40, seed=41)``).

    python3 scripts/torch_serve_latency.py [--device cuda] [--misses 60]

A checkpoint-backed store (the config's) and an in-memory one, each warmed
with 400 sources (200 hot): the median and p90 milliseconds of hot hits,
warm-tier hits and misses, and of hits and misses through one socket
client. Prints the card's name and power limit and one JSON line per
measurement.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _ms(samples) -> dict:
    import numpy as np

    a = np.asarray(samples) * 1e3
    return {"median_ms": float(np.median(a)),
            "p90_ms": float(np.percentile(a, 90)), "n": len(a)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--misses", type=int, default=60)
    args = ap.parse_args()

    import numpy as np
    import torch

    from paralleljohnson_tpu_torch.graphs import grid2d
    from paralleljohnson_tpu_torch.serve import (
        QueryEngine, ServeFrontend, TileStore,
    )

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_serve_latency: no CUDA card", file=sys.stderr)
            return 2
        from paralleljohnson_tpu_torch.ops import _cuda

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0],
            flush=True)
        _cuda.build_all()
    g = grid2d(40, 40, seed=41)
    n = g.num_nodes
    warm = np.arange(400)

    def timed(fn, items):
        out = []
        for x in items:
            t0 = time.perf_counter()
            fn(int(x))
            out.append(time.perf_counter() - t0)
        return out

    for kind in ("checkpointed", "in_memory"):
        root = tempfile.mkdtemp() if kind == "checkpointed" else None
        engine = QueryEngine(g, TileStore(root, g, hot_rows=200, warm_rows=n),
                             stats_interval_s=0, device=args.device)
        engine.warm(warm)
        one = lambda s, t=5: engine.query_batch([{"source": s, "dst": t}])
        rows = {"store": kind, "direct": {
            "hot_hit": _ms(timed(one, range(200, 400))),
            "warm_tier_hit": _ms(timed(one, range(0, 200))),
            "miss": _ms(timed(one, range(400, 400 + args.misses)))}}
        fe = ServeFrontend(engine, max_inflight=2, shed_policy="off").start()
        sock = socket.create_connection(fe.address, timeout=30)
        f = sock.makefile("rw", encoding="utf-8", newline="\n")
        f.readline()

        def ask(s, t=7):
            f.write(json.dumps({"source": s, "dst": t}) + "\n")
            f.flush()
            return json.loads(f.readline())

        lo = 400 + args.misses
        rows["socket"] = {"hot_hit": _ms(timed(ask, range(200, 400))),
                          "miss": _ms(timed(ask, range(lo, lo + args.misses)))}
        f.close()
        sock.close()
        fe.drain()  # closes the engine
        print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
