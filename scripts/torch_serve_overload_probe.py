#!/usr/bin/env python3
"""Where a ``serve_overload`` request spends its admission slot: runs the
bench's ``serve_overload`` config once (``--preset full`` by default) with
the frontend's hot path timed, and prints, for each second of the run,
how many requests were admitted and rejected, how long an admitted
request held its in-flight slot (``ServeFrontend._answer_doc``), how much
of that was the engine's batch (``MicroBatcher._run_batch``), the wait
for the batcher's turn, and the batches' width.

    python3 scripts/torch_serve_overload_probe.py [--device cuda] [--preset full]

Prints the card's name and power limit (on ``cuda``), one JSON line per
second of the run (the overload phase first, then the cooldown), and the
config's row without its per-answer detail.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="full")
    args = ap.parse_args()

    import numpy as np
    import torch

    from paralleljohnson_tpu_torch import benchmarks
    from paralleljohnson_tpu_torch.serve import frontend

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_serve_overload_probe: no CUDA card", file=sys.stderr)
            return 2
        from paralleljohnson_tpu_torch.ops import _cuda

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0],
            flush=True)
        _cuda.build_all()

    lock = threading.Lock()
    admits: list = []    # (start, seconds, rejected)
    holds: list = []     # (start, seconds)
    batches: list = []   # (start, seconds, width)
    submits: list = []   # (start, seconds)

    def timed(fn, sink, extra=None):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            rec = (t0, time.perf_counter() - t0) + (
                () if extra is None else (extra(a, out),))
            with lock:
                sink.append(rec)
            return out
        return wrapper

    fe, mb = frontend.ServeFrontend, frontend.MicroBatcher
    fe._admit = timed(fe._admit, admits,
                      lambda a, out: "error" in out)
    fe._answer_doc = timed(fe._answer_doc, holds)
    mb.submit = timed(mb.submit, submits)
    mb._run_batch = timed(mb._run_batch, batches, lambda a, out: len(a[1]))

    (rec,) = benchmarks.run(["serve_overload"], preset=args.preset,
                            device=args.device)
    t_first = min(t for t, *_ in admits)

    def per_second(rows):
        out: dict = {}
        for r in rows:
            out.setdefault(int(r[0] - t_first), []).append(r)
        return out

    a_s, h_s, b_s, s_s = (per_second(x) for x in (admits, holds, batches,
                                                 submits))

    def ms(rows, i=1, q=(50, 90)):
        if not rows:
            return None
        v = np.asarray([r[i] for r in rows]) * 1e3
        return [float(np.percentile(v, p)) for p in q]

    for sec in sorted(a_s):
        a = a_s[sec]
        emit = {
            "second": sec, "requests": len(a),
            "rejected": sum(1 for r in a if r[2]),
            "slot_hold_ms_p50_p90": ms(h_s.get(sec, [])),
            "slot_busy_s": sum(r[1] for r in h_s.get(sec, [])),
            "engine_batch_ms_p50_p90": ms(b_s.get(sec, [])),
            "engine_busy_s": sum(r[1] for r in b_s.get(sec, [])),
            "submit_ms_p50_p90": ms(s_s.get(sec, [])),
            "batch_width_mean": (float(np.mean([r[2] for r in b_s[sec]]))
                                 if b_s.get(sec) else None),
        }
        print(json.dumps(emit), flush=True)
    d = dict(rec.detail)
    print(json.dumps({"config": rec.config, "wall_s": rec.wall_s,
                      **{k: d.get(k) for k in (
                          "capacity_per_s", "accepted", "rejected",
                          "shed_answers", "shed_frac", "shed_late_cooldown",
                          "cooldown_timeline", "p50_ms", "p99_ms", "slo",
                          "failed")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
