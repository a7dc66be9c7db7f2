"""Lay a flight recorder's Chrome trace over a ``torch.profiler`` trace
of the same run, and report how far each flight span starts from its
``record_function`` twin.

    python3 scripts/torch_trace_overlay.py PROFILE_DIR/trace.json \
        TRACE_DIR/trace-<cmd>.json [-o merged.json] [--max-ms 1]

(a CLI run with both ``--profile PROFILE_DIR`` and ``--trace-dir
TRACE_DIR`` writes the two). ``-o`` writes the overlay
(``utils.profiling.overlay_traces``) for https://ui.perfetto.dev. Prints
one JSON line: for each flight span name with profiler twins
(``phase:upload`` and ``upload``, ``solve`` and ``pj.solve``, a
``pj.*`` step and itself), how many flight spans it has and the largest
and median distance of their starts from the nearest twin's, in ms.
Exit 1 where a phase's largest distance passes ``--max-ms``, or no
phase was matched.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from paralleljohnson_tpu_torch.utils.metrics import (  # noqa: E402
    PHASES,
    Span,
    flight_name,
)
from paralleljohnson_tpu_torch.utils.profiling import (  # noqa: E402
    overlay_traces,
)


def _starts(events, keep) -> dict:
    out = defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X" and keep(ev):
            out[ev["name"]].append(float(ev["ts"]))
    return {k: sorted(v) for k, v in out.items()}


def twin_gaps(profile: dict, flight: dict) -> dict:
    """``{flight name: {"spans", "max_ms", "median_ms"}}`` over the flight
    spans whose profiler twins are in ``profile``, both on the profiler's
    clock (the overlay's)."""
    merged = overlay_traces(profile, flight)["traceEvents"]
    names = list(PHASES) + [v for k, v in vars(Span).items()
                            if k.isupper()]
    profiler_of = {flight_name(n): n for n in names}
    prof = _starts(merged, lambda e: e.get("cat") == "user_annotation")
    ours = _starts(flight["traceEvents"], lambda e: True)
    base_us = profile.get("baseTimeNanoseconds", 0) / 1e3
    out = {}
    for fname, starts in sorted(ours.items()):
        twins = prof.get(profiler_of.get(fname, ""), [])
        if not twins:
            continue
        gaps = [min(abs((f - base_us) - p) for p in twins) / 1e3
                for f in starts]
        out[fname] = {"spans": len(gaps), "max_ms": max(gaps),
                      "median_ms": statistics.median(gaps)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("profile", help="torch.profiler trace (trace.json)")
    ap.add_argument("flight", help="flight recorder's trace-<cmd>.json")
    ap.add_argument("-o", "--out", default=None,
                    help="write the overlay here")
    ap.add_argument("--max-ms", type=float, default=1.0)
    args = ap.parse_args(argv)
    profile = json.loads(Path(args.profile).read_text())
    flight = json.loads(Path(args.flight).read_text())
    if args.out:
        Path(args.out).write_text(json.dumps(overlay_traces(profile, flight)))
    gaps = twin_gaps(profile, flight)
    phases = {k: v for k, v in gaps.items() if k.startswith("phase:")}
    ok = bool(phases) and all(v["max_ms"] <= args.max_ms
                              for v in phases.values())
    print(json.dumps({"ok": ok, "max_ms": args.max_ms, "spans": gaps}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
