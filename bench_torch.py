#!/usr/bin/env python
"""Benchmark of the PyTorch port on the card: prints ONE JSON line
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N}``.

The counterpart of ``bench.py``. Headline config (BASELINE.json:2 metric
"edges-relaxed/sec/chip"): the batched N-source fan-out — Johnson phase
2, the dominant hot loop — on an R-MAT power-law graph, through
``paralleljohnson_tpu_torch``'s torch backend on one CUDA card (the hand
``fanout_sweep`` kernel). Each timed repeat ends in
``torch.cuda.synchronize()``; the rows stay on the card, as the full
R-MAT workloads cannot hold them on the host. ``vs_baseline`` is the
wall-clock speedup over scipy's heap Dijkstra on the same graph and
sources (the CPU reference stand-in; the reference publishes no
numbers, BASELINE.json:13). The rows are checked against scipy's after
the timed repeats.

Without a CUDA card it exits non-zero with a message: there is no CPU
fallback, since a CPU number is not a measurement of the card.

Env knobs: PJ_BENCH_SCALE (default 20: the attested R-MAT-20 config),
PJ_BENCH_SOURCES (128), PJ_BENCH_REPEATS (3). With PJ_PROFILE_DIR set,
the measurement is also appended to that profile store and to its
bench-regression history (a regression warns on stderr; stdout stays
the one JSON line).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _run_config(scale: int, n_sources: int, repeats: int) -> dict:
    """Build the graph, run the fan-out on the card, time it, and check
    the rows against scipy's Dijkstra."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph
    import torch

    from paralleljohnson_tpu_torch.backends import get_backend
    from paralleljohnson_tpu_torch.config import SolverConfig
    from paralleljohnson_tpu_torch.graphs import rmat
    from paralleljohnson_tpu_torch.observe import card_info

    device = torch.device("cuda", 0)
    backend = get_backend("torch", SolverConfig(), device=device)
    g = rmat(scale, 16, seed=42)
    rng = np.random.default_rng(0)
    sources = np.sort(
        rng.choice(g.num_nodes, size=n_sources, replace=False)
    ).astype(np.int64)

    dgraph = backend.upload(g)
    res = backend.multi_source(dgraph, sources)  # builds kernels, warms caches
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = backend.multi_source(dgraph, sources)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    dt = min(times)

    mat = sp.csr_matrix(
        (g.weights.astype(np.float64), g.indices, g.indptr),
        shape=(g.num_nodes, g.num_nodes),
    )
    t0 = time.perf_counter()
    ref = csgraph.dijkstra(mat, directed=True, indices=sources)
    t_ref = time.perf_counter() - t0
    ok = bool(np.allclose(res.dist.cpu().numpy(), ref, rtol=1e-3, atol=1e-2))
    if not ok:
        print("WARNING: result mismatch vs scipy oracle", file=sys.stderr)

    info = card_info(device)
    measured = {
        "edges_per_sec": res.edges_relaxed / dt,
        "dt": dt,
        "times": times,
        "t_ref": t_ref,
        "oracle_ok": ok,
        "scale": scale,
        "n_sources": n_sources,
        "platform": "cuda",
        "device": info["name"],
        "power_limit": info["power_limit"],
        "route": res.route,
        "iterations": res.iterations,
        "repeats": repeats,
    }
    bound = _append_profile(res, g, n_sources, dt)
    if bound is not None:
        measured["roofline_bound"] = bound
    return measured


def _append_profile(res, g, n_sources: int, dt: float):
    """Profile record of this measurement under ``$PJ_PROFILE_DIR`` (the
    backend is driven directly, without a solver, so the record is
    written here), with a roofline classification. Returns the bound (or
    None); never fatal."""
    try:
        profile_dir = os.environ.get("PJ_PROFILE_DIR")
        if not profile_dir:
            return None
        from paralleljohnson_tpu_torch.observe import ProfileStore, classify

        cost = getattr(res, "cost", None) or {
            "cost_analysis_unavailable":
                "capture disabled for this route/backend"
        }
        roof = classify(
            flops=cost.get("flops"),
            bytes_accessed=cost.get("bytes_accessed"),
            compute_s=dt,
            platform="cuda",
        )
        ProfileStore(profile_dir).append({
            "ts": time.time(),
            "kind": "bench",
            "label": "bench_torch.py",
            "route": res.route,
            "platform": "cuda",
            "nodes": g.num_nodes,
            "edges": g.num_real_edges,
            "batch": int(n_sources),
            "measured": {"wall_s": dt, "compute_s": dt},
            "edges_relaxed": int(res.edges_relaxed),
            "cost": cost,
            "roofline": roof,
        })
        return roof.get("bound")
    except Exception as e:  # noqa: BLE001 — observability is never fatal
        print(f"WARNING: profile-store append failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return None


def _record_history(measured: dict) -> None:
    """Append this measurement to the bench-regression history under
    ``$PJ_PROFILE_DIR`` and warn (stderr only) when it regresses against
    the per-(bench, backend, platform) trajectory. Never fatal, never
    changes the exit code."""
    try:
        profile_dir = os.environ.get("PJ_PROFILE_DIR")
        if not profile_dir:
            return
        from paralleljohnson_tpu_torch.observe.regress import (
            BenchHistory,
            detect_regressions,
        )

        row = {
            "bench": (
                f"driver:rmat{measured['scale']}x"
                f"{measured['n_sources']}src"
            ),
            "backend": "torch",
            "platform": measured["platform"],
            "preset": None,
            "wall_s": float(measured["dt"]),
            "detail": {
                "value": measured["edges_per_sec"],
                "route": measured.get("route"),
                "device": measured.get("device"),
                "power_limit": measured.get("power_limit"),
            },
            "source": "bench_torch.py",
        }
        hist = BenchHistory(profile_dir)
        for f in detect_regressions([row], hist.rows(), band=0.5):
            print(
                f"WARNING: bench regression — {f['bench']} on "
                f"{f['platform']} took {f['wall_s']:.3f}s vs baseline "
                f"{f['baseline_s']:.3f}s ({f['slowdown']:.2f}x, "
                f"roofline: {f['roofline_bound']})",
                file=sys.stderr,
            )
        hist.append(row)
    except Exception as e:  # noqa: BLE001 — observability is never fatal
        print(f"WARNING: bench history append failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr)


def _emit(measured: dict, tag: str) -> None:
    """ONE JSON line on stdout; ``detail`` carries the platform, the
    card and its power limit, and the scale."""
    out = {
        "metric": f"edges_relaxed_per_sec_per_chip[{tag}]",
        "value": round(measured["edges_per_sec"], 1),
        "unit": "edges/s",
        "vs_baseline": round(measured["t_ref"] / measured["dt"], 3),
        "detail": {
            k: measured[k]
            for k in ("platform", "device", "power_limit", "scale",
                      "n_sources", "dt", "times", "t_ref", "oracle_ok",
                      "route", "iterations", "repeats", "roofline_bound")
            if measured.get(k) is not None
        },
    }
    print(json.dumps(out))
    _record_history(measured)


def main() -> int:
    scale = int(os.environ.get("PJ_BENCH_SCALE", "20"))
    n_sources = int(os.environ.get("PJ_BENCH_SOURCES", "128"))
    repeats = int(os.environ.get("PJ_BENCH_REPEATS", "3"))
    import torch

    if not torch.cuda.is_available():
        print("bench_torch.py: no CUDA device; this benchmark measures the "
              "card and has no CPU fallback", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    measured = _run_config(scale, n_sources, repeats)
    _emit(measured, f"rmat{scale}x{n_sources}src,cuda")
    return 0 if measured["oracle_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
