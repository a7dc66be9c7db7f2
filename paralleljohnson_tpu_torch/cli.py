"""Command-line interface of the PyTorch port: the JAX package's verbs,
flag names, JSON keys and exit codes, on the card.

  python -m paralleljohnson_tpu_torch solve <graphspec> [--sources 0,5,9 | --num-sources K]
  python -m paralleljohnson_tpu_torch sssp  <graphspec> --source S
  python -m paralleljohnson_tpu_torch batch <count> <nodes> <p>
  python -m paralleljohnson_tpu_torch bench | serve | top | update | tune | fleet | info

Every verb that solves or holds tensors runs on the card (``--device
cuda``, the default) unless ``--device cpu`` is given; without a card it
exits 1 and says so, it never moves to the CPU by itself. Graph specs
are anything ``load_graph`` accepts: a path (.gr/.txt) or a scheme spec
like ``er:n=1000,p=0.01`` / ``rmat:scale=20``.

Exit codes: 0 ok; 1 error (an ``error:`` line on stderr); 2 negative
cycle; 3 corruption, an abandoned stage, or an incomplete fleet.

Where the port differs from the JAX package: ``--backend`` is ``torch``
(default), ``numpy`` or ``cpp``; a solve takes every rank device
``parallel.mesh.visible_devices`` lists (every card, as the JAX package
takes every device; one rank on the CPU unless ``PJ_MESH_DEVICES`` lists
more; at either ``--precision``), and ``--mesh-shape N`` the first N
of them (``--mesh-shape 1``: one card); ``--precision f64`` runs the
hand kernels' f64 versions on the card; ``--profile`` writes a
``torch.profiler`` trace; ``--compilation-cache-dir`` is the directory
the hand kernels are built into; ``bench`` exits 1 when a row carries
``failed``; ``--log-stats`` lines carry ``kernel_launches``, each hand
kernel's launches in the process; ``info`` reports the cards
(``nvidia-smi`` name and power limit) and the kernel libraries built.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_TRISTATE = {"auto": "auto", "true": True, "false": False}


def _tristate(p: argparse.ArgumentParser, flag: str, text: str) -> None:
    p.add_argument(flag, default="auto", choices=["auto", "true", "false"],
                   help=text)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where tensors live and kernels run: cuda (default; "
                        "exits 1 without a card) or cpu (the kernels' plain "
                        "PyTorch versions)")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--backend", default="torch",
                   help="execution backend: torch (default: the hand CUDA "
                        "kernels on the card), numpy (the scipy oracle) or "
                        "cpp (the C++/OpenMP baseline)")
    _add_device(p)
    p.add_argument("--precision", default="f32", choices=["f32", "f64"],
                   help="value type of the distances: f32 (default) or f64 "
                        "(the hand kernels' f64 versions on the card)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="sources per device batch")
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--dense-threshold", type=int, default=1024)
    _tristate(p, "--use-pallas",
              "hand-kernel routes: auto/true = pallas-vm and dense-*-pallas "
              "(the CUDA kernels on the card), false = the JAX package's "
              "XLA routes in plain PyTorch")
    p.add_argument("--mesh-shape", default=None, metavar="N[,M...]",
                   help="ranks along the sources mesh axis (e.g. 4; 1 "
                        "for one card); N,M is a 2-D sources x edges mesh "
                        "(rank devices: every card, or $PJ_MESH_DEVICES); "
                        "without it a solve takes every rank device")
    p.add_argument("--fanout-layout", default="auto",
                   choices=["auto", "source_major", "vertex_major"],
                   help="sparse fan-out data layout (auto = vertex_major)")
    _tristate(p, "--frontier",
              "frontier-compacted Bellman-Ford for high-diameter graphs: "
              "auto (low-degree graphs) / force / off")
    _tristate(p, "--edge-shard",
              "shard the edge list across the mesh for single-source "
              "Bellman-Ford (auto: a mesh of more than one rank, off the "
              "frontier family)")
    _tristate(p, "--gauss-seidel",
              "blocked Gauss-Seidel route (auto: off on cuda; true forces)")
    _tristate(p, "--dia",
              "gather-free DIA stencil route for diagonally-labeled graphs "
              "(auto: off on cuda; true forces)")
    p.add_argument("--dia-max-offsets", type=int, default=16,
                   help="max distinct edge diagonals the DIA route accepts")
    _tristate(p, "--bucket",
              "bucketed delta-stepping route for B=1 solves (auto: off on "
              "cuda; true forces)")
    p.add_argument("--delta", type=float, default=None,
                   help="bucket width of the bucket route (default: "
                        "auto-tune from mean edge weight x degree)")
    _tristate(p, "--fw",
              "blocked min-plus Floyd-Warshall dense-APSP route (fw_kleene "
              "and minplus kernels; auto: dense all-sources solves where "
              "it beats min-plus squaring)")
    p.add_argument("--fw-threshold", type=int, default=1 << 14,
                   help="max V the blocked-FW dense route accepts")
    p.add_argument("--fw-tile", type=int, default=None,
                   help="FW tile edge (multiple of 128; 512 default)")
    _tristate(p, "--partitioned",
              "condense-solve-expand partitioned APSP (auto: off on cuda; "
              "true forces)")
    p.add_argument("--partition-parts", type=int, default=None,
                   help="partition count of the condensed route "
                        "(default: auto-size from V)")
    _tristate(p, "--dirty-window",
              "dirty-window compacted relaxation (route vm-blocked+dw); "
              "auto engages only on the profile store's trajectory "
              "evidence")
    _tristate(p, "--planner",
              "priced dispatch registry: auto/true promote a cheaper "
              "qualified plan when the profile store prices both beyond "
              "the noise band; false = declared priority")
    _tristate(p, "--hopset",
              "certified (1+eps) hopset route hopset+bf: auto qualifies it "
              "exactly when --error-budget > 0 on a negative-free graph; "
              "true forces it (still requires a positive budget)")
    p.add_argument("--error-budget", type=float, default=0.0, metavar="R",
                   help="per-solve relative error budget (>= 0; 0 = exact "
                        "only)")
    p.add_argument("--approx-epsilon", type=float, default=0.1, metavar="E",
                   help="hopset tier target relative error eps > 0")
    p.add_argument("--approx-beta", type=int, default=None, metavar="B",
                   help="explicit hop budget (default: auto from V and eps)")
    p.add_argument("--dw-block", type=int, default=None,
                   help="vertices per dirty-window activity bit")
    p.add_argument("--gs-block-size", type=int, default=8192,
                   help="vertices per Gauss-Seidel block")
    p.add_argument("--gs-inner-cap", type=int, default=64,
                   help="max Gauss-Seidel inner iterations per block visit")
    _tristate(p, "--convergence",
              "per-iteration convergence trajectory recording (auto = on "
              "when a telemetry sink or profile store is configured)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="max fan-out batches in flight (1 = serial; "
                        "default: profile-tuned, else 2)")
    p.add_argument("--compilation-cache-dir", default=None, metavar="DIR",
                   help="directory the hand kernels are built into "
                        "(default: $PJ_COMPILE_CACHE if set, else "
                        "paralleljohnson_tpu_torch/_build/)")
    p.add_argument("--retry-attempts", type=int, default=3,
                   help="max attempts per solve stage (1 disables retries)")
    p.add_argument("--stage-deadline", type=float, default=None,
                   metavar="SECONDS",
                   help="per-attempt wall-clock cap enforced by a watchdog "
                        "thread (default: no watchdog)")
    p.add_argument("--min-source-batch", type=int, default=8,
                   help="floor of the OOM batch halving")
    p.add_argument("--predecessors", action="store_true",
                   help="also compute shortest-path trees (saved to --output)")
    _tristate(p, "--pred-extraction",
              "tight-edge predecessor extraction after the fixpoint (the "
              "tight_pred kernel; route '<route>+pred'); false = argmin "
              "sweep 'pred-sweep'")
    p.add_argument("--validate", action="store_true",
                   help="cross-check against the scipy oracle (slow)")
    p.add_argument("--output", default=None, help="write result .npz here")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit one machine-readable JSON line")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (trace.json) here")
    p.add_argument("--log-stats", action="store_true",
                   help="emit a structured JSON stats line to stderr")
    _add_observability(p)


def _add_observability(p: argparse.ArgumentParser) -> None:
    """Flight-recorder telemetry flags. Defaults come from PJ_TRACE_DIR /
    PJ_HEARTBEAT_FILE / PJ_HEARTBEAT_INTERVAL / PJ_METRICS_FILE /
    PJ_TRACE_SAMPLE / PJ_PROFILE_DIR."""
    p.add_argument("--trace-dir", default=os.environ.get("PJ_TRACE_DIR"),
                   metavar="DIR",
                   help="flight-recorder directory: span/event JSONL plus a "
                        "Chrome trace on completion (default: $PJ_TRACE_DIR)")
    p.add_argument("--heartbeat-file",
                   default=os.environ.get("PJ_HEARTBEAT_FILE"),
                   metavar="JSON",
                   help="atomically rewrite this progress JSON every "
                        "--heartbeat-interval seconds (default: "
                        "$PJ_HEARTBEAT_FILE)")
    p.add_argument("--heartbeat-interval", type=float,
                   default=float(os.environ.get("PJ_HEARTBEAT_INTERVAL",
                                                "5.0")),
                   metavar="SECONDS",
                   help="heartbeat rewrite period (default: "
                        "$PJ_HEARTBEAT_INTERVAL or 5)")
    p.add_argument("--metrics-file",
                   default=os.environ.get("PJ_METRICS_FILE"),
                   metavar="PROM",
                   help="write the solve's stats as a Prometheus textfile "
                        "(default: $PJ_METRICS_FILE)")
    p.add_argument("--trace-sample", type=float,
                   default=(float(os.environ["PJ_TRACE_SAMPLE"])
                            if os.environ.get("PJ_TRACE_SAMPLE") else None),
                   metavar="RATE",
                   help="head-based request-trace sampling rate in [0, 1] "
                        "for serve/router ingress (default: "
                        "$PJ_TRACE_SAMPLE; else 1.0 with --trace-dir, 0 "
                        "otherwise)")
    p.add_argument("--profile-store",
                   default=os.environ.get("PJ_PROFILE_DIR"),
                   metavar="DIR",
                   help="profile store: one record per solve in "
                        "DIR/profiles.jsonl, which prices later dispatch "
                        "(default: $PJ_PROFILE_DIR)")


def _telemetry(args, label: str):
    """The Telemetry façade the flags describe (None when off)."""
    from paralleljohnson_tpu_torch.utils.telemetry import Telemetry

    return Telemetry.create(
        trace_dir=args.trace_dir,
        heartbeat_file=args.heartbeat_file,
        heartbeat_interval_s=args.heartbeat_interval,
        label=label,
    )


def _config(args):
    from paralleljohnson_tpu_torch.config import SolverConfig

    t = _TRISTATE
    mesh_shape = None
    if args.mesh_shape is not None:
        mesh_shape = tuple(int(n) for n in args.mesh_shape.split(","))
    return SolverConfig(
        backend=args.backend,
        precision=args.precision,
        source_batch_size=args.batch_size,
        mesh_shape=mesh_shape,
        max_iterations=args.max_iterations,
        dense_threshold=args.dense_threshold,
        use_pallas=t[args.use_pallas],
        fanout_layout=args.fanout_layout,
        frontier=t[args.frontier],
        edge_shard=t[args.edge_shard],
        gauss_seidel=t[args.gauss_seidel],
        dia=t[args.dia],
        dia_max_offsets=args.dia_max_offsets,
        bucket=t[args.bucket],
        delta=args.delta,
        fw=t[args.fw],
        fw_threshold=args.fw_threshold,
        fw_tile=args.fw_tile,
        partitioned=t[args.partitioned],
        partition_parts=args.partition_parts,
        dirty_window=t[args.dirty_window],
        dw_block=args.dw_block,
        gs_block_size=args.gs_block_size,
        gs_inner_cap=args.gs_inner_cap,
        pred_extraction=t[args.pred_extraction],
        checkpoint_dir=args.checkpoint_dir,
        pipeline_depth=args.pipeline_depth,
        compilation_cache_dir=args.compilation_cache_dir,
        validate=args.validate,
        retry_attempts=args.retry_attempts,
        stage_deadline_s=args.stage_deadline,
        min_source_batch=args.min_source_batch,
        planner=t[args.planner],
        hopset=t[args.hopset],
        approx_epsilon=args.approx_epsilon,
        approx_beta=args.approx_beta,
        error_budget=args.error_budget,
        profile_store=args.profile_store,
        convergence=t[args.convergence],
        telemetry=_telemetry(args, args.command),
    )


def _log_stats(stats, label: str) -> None:
    """The ``--log-stats`` line, with this process's kernel launches."""
    from paralleljohnson_tpu_torch.ops import kernel_launches
    from paralleljohnson_tpu_torch.utils.profiling import log_stats

    log_stats(stats, label=label, extra={"kernel_launches": kernel_launches()})


def _write_metrics(stats, args) -> None:
    if getattr(args, "metrics_file", None):
        from paralleljohnson_tpu_torch.utils.telemetry import write_prom_metrics

        write_prom_metrics(stats, args.metrics_file,
                           labels={"command": args.command})


def _report_approx(res, args) -> None:
    """Report an ApproxResult (route hopset+bf): the certified-bound
    summary instead of the exact SolverStats surface."""
    fin = np.isfinite(res.max_error)
    payload = {
        "shape": list(res.dist.shape),
        "route": res.route,
        "exact": bool(res.exact),
        "certified_frac": round(float(np.mean(fin)), 6),
        "certified_max_bound": (
            float(res.max_error[fin].max()) if bool(fin.any()) else 0.0
        ),
        **res.stats,
        "plan": res.plan,
    }
    if args.output:
        np.savez_compressed(args.output, dist=res.dist, sources=res.sources,
                            max_error=res.max_error)
        payload["output"] = args.output
    if args.as_json:
        print(json.dumps(payload))
    else:
        print(f"distances: {res.dist.shape}, route {res.route} "
              f"(eps {res.stats.get('epsilon'):g}, beta "
              f"{res.stats.get('beta')}, "
              f"{payload['certified_frac']:.1%} certified, max bound "
              f"{payload['certified_max_bound']:g})")
        print(f"  construction: {res.stats.get('construction_s', 0) * 1e3:9.2f} ms"
              f"  query: {res.stats.get('query_s', 0) * 1e3:9.2f} ms")
        if res.plan:
            print(f"  planner: chose {res.plan.get('chosen')} — "
                  f"{res.plan.get('reason')}")


def _report(res, args) -> None:
    from paralleljohnson_tpu_torch.solver.johnson import to_numpy
    from paralleljohnson_tpu_torch.utils.reductions import finite_frac

    _write_metrics(res.stats, args)
    if getattr(args, "log_stats", False):
        _log_stats(res.stats, args.command)
    # On the device: np.isfinite would download the whole matrix for
    # one fraction.
    finite = finite_frac(res.dist)
    payload = {
        "shape": list(res.dist.shape),
        "finite_fraction": round(finite, 6),
        **res.stats.as_dict(),
    }
    if args.output:
        arrays = dict(dist=to_numpy(res.dist), sources=to_numpy(res.sources),
                      potentials=to_numpy(res.potentials))
        if res.predecessors is not None:
            arrays["predecessors"] = to_numpy(res.predecessors)
        np.savez_compressed(args.output, **arrays)
        payload["output"] = args.output
    if args.as_json:
        print(json.dumps(payload))
        return
    s = res.stats
    print(f"distances: {tuple(res.dist.shape)}, {finite:.1%} finite")
    for phase, secs in s.phase_seconds.items():
        print(f"  {phase:>14s}: {secs * 1e3:9.2f} ms")
    print(f"  edges relaxed: {s.edges_relaxed:,} "
          f"({s.edges_relaxed_per_second():,.0f}/s)")
    # Resilience summary, only when a recovery path fired.
    if s.retries or s.oom_degradations or s.abandoned_stages:
        parts = []
        if s.retries:
            parts.append(f"{s.retries} retries")
        if s.oom_degradations:
            parts.append(f"{s.oom_degradations} OOM degradations "
                          f"(final batch {s.final_batch})")
        if s.abandoned_stages:
            parts.append(f"abandoned: {', '.join(s.abandoned_stages)}")
        print(f"  resilience: {'; '.join(parts)}")
    if s.batches_resumed:
        print(f"  batches resumed from checkpoint: {s.batches_resumed}")
    roof = getattr(s, "roofline", None)
    if roof and roof.get("bound") not in (None, "unknown"):
        line = f"  roofline: {roof['bound']}-bound"
        if roof.get("why"):
            line += f" ({roof['why']})"
        print(line)
        if s.predicted_s is not None:
            print(f"  cost model: predicted {s.predicted_s * 1e3:.2f} ms"
                  f" vs measured {s.compute_seconds * 1e3:.2f} ms compute")
    plan = getattr(s, "plan", None)
    if plan:
        line = f"  plan: {plan.get('built') or plan.get('chosen')}"
        if plan.get("degraded"):
            line += f" (degraded from {plan.get('chosen')})"
        if plan.get("reason"):
            line += f" — {plan['reason']}"
        print(line)
        shown = {k: v for k, v in (plan.get("params") or {}).items()
                 if not k.endswith("_source")}
        if shown:
            print("  plan params: " + ", ".join(
                f"{k}={v}" for k, v in sorted(shown.items())))
    for phase, c in (getattr(s, "convergence", None) or {}).items():
        print(f"  convergence[{phase}]: {c.get('iterations', 0)} "
              f"iter (half-life {c.get('frontier_half_life', 0)}), "
              f"tail {c.get('tail_fraction', 0.0):.0%}, JFR-skippable "
              f"{c.get('jfr_skippable_edge_frac', 0.0):.0%} of examined "
              "edges")
    if s.download_s or s.ckpt_wait_s or s.overlap_saved_s:
        print(f"  pipeline (depth {s.final_pipeline_depth}): "
              f"download {s.download_s * 1e3:.2f} ms, "
              f"ckpt wait {s.ckpt_wait_s * 1e3:.2f} ms, "
              f"overlap saved {s.overlap_saved_s * 1e3:.2f} ms")
    if args.output:
        print(f"  wrote {args.output}")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m paralleljohnson_tpu_torch",
        description="parallel Johnson's-algorithm APSP solver on a CUDA "
                    "card (PyTorch port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("solve", help="Johnson APSP (all or some sources)")
    p.add_argument("graph", help="path or loader spec")
    p.add_argument("--sources", default=None,
                   help="comma-separated source vertices (default: all)")
    p.add_argument("--num-sources", type=int, default=None,
                   help="solve the first K sources only")
    p.add_argument("--reduce", default=None, metavar="REDUCER",
                   choices=["checksum", "eccentricity", "reach_count"],
                   help="streaming mode: reduce each source batch's rows on "
                        "the device instead of materializing the matrix")
    _add_common(p)

    p = sub.add_parser("sssp", help="single-source Bellman-Ford")
    p.add_argument("graph")
    p.add_argument("--source", type=int, required=True)
    _add_common(p)

    p = sub.add_parser("batch", help="many-small-graphs APSP "
                                     "(route batch-vmapped)")
    p.add_argument("count", type=int)
    p.add_argument("nodes", type=int)
    p.add_argument("p", type=float)
    p.add_argument("--seed", type=int, default=0)
    _add_common(p)

    p = sub.add_parser("bench", help="the bench harness's configs "
                                     "(one JSON row each)")
    p.add_argument("configs", nargs="*",
                   help="subset of configs (default: all)")
    p.add_argument("--backend", default="torch")
    _add_device(p)
    p.add_argument("--preset", default="mini",
                   choices=["smoke", "mini", "full"])
    p.add_argument("--update-baseline", default=None, metavar="MD",
                   help="rewrite the measured table in this BASELINE.md")
    p.add_argument("--trace-dir", default=os.environ.get("PJ_TRACE_DIR"),
                   metavar="DIR",
                   help="per-config flight recorder under DIR (default: "
                        "$PJ_TRACE_DIR)")
    p.add_argument("--profile-store", default=os.environ.get("PJ_PROFILE_DIR"),
                   metavar="DIR",
                   help="profile store and bench-regression history "
                        "(default: $PJ_PROFILE_DIR)")

    p = sub.add_parser("serve", help="query serving over a tile store: "
                                     "JSONL in (stdin, --queries or "
                                     "--listen), one JSON answer per query")
    p.add_argument("graph", nargs="?", default=None,
                   help="path or loader spec (omit with --route)")
    p.add_argument("--store-dir", default=None, metavar="DIR",
                   help="solve/checkpoint directory the tile store attaches "
                        "to; absent = in-memory tiers only")
    p.add_argument("--queries", default="-", metavar="JSONL",
                   help="query file, '-' = stdin (default). One object per "
                        "line: {\"id\": ..., \"source\": S, \"dst\": T | "
                        "[T,...] | null, \"mode\": \"exact\"|\"approx\"}")
    p.add_argument("--landmarks", type=int, default=0, metavar="K",
                   help="build (or reuse from the store) a K-pivot landmark "
                        "index for bounded-error answers (--miss-policy "
                        "landmark implies 16)")
    p.add_argument("--miss-policy", default="solve",
                   choices=["solve", "landmark", "hopset"],
                   help="store miss: 'solve' schedules one exact batch, "
                        "'landmark' / 'hopset' answer with certified bounds")
    p.add_argument("--hot-rows", type=int, default=None,
                   help="hot-tier (device-resident) capacity in rows")
    p.add_argument("--warm-rows", type=int, default=None,
                   help="warm-tier host-RAM LRU capacity in rows")
    p.add_argument("--batch-queries", type=int, default=64,
                   help="aggregate up to this many request lines into one "
                        "lookup")
    p.add_argument("--device-lookup", default="auto",
                   choices=["auto", "on", "off"],
                   help="lookup path: auto prices host tier walk vs device "
                        "megabatch per batch (identical answers)")
    p.add_argument("--landmark-picker", default="uniform",
                   choices=["uniform", "coverage", "boundary"],
                   help="pivot picker for a fresh landmark index or hopset")
    p.add_argument("--batch-window", type=int, default=None, metavar="W",
                   help="micro-batch up to W concurrent socket requests "
                        "(--listen only; default 32; 1 disables)")
    p.add_argument("--batch-wait-ms", type=float, default=None, metavar="MS",
                   help="fixed window the micro-batch leader waits "
                        "(default 0)")
    p.add_argument("--summary", action="store_true",
                   help="print the serving summary JSON to stderr at exit")
    p.add_argument("--slo-p99-ms", type=float, default=250.0,
                   help="SLO latency target for the p99 (default 250 ms)")
    p.add_argument("--slo-availability", type=float, default=0.999,
                   help="SLO availability target (default 0.999)")
    p.add_argument("--stats-interval", type=float, default=5.0,
                   metavar="SECONDS",
                   help="rewrite serve_stats.json in the store dir every N "
                        "seconds (0 disables)")
    p.add_argument("--listen", default=None, metavar="HOST:PORT",
                   help="serve newline-delimited JSON over TCP; port 0 "
                        "picks an ephemeral port (announced on stdout); "
                        "SIGTERM drains and exits 0")
    p.add_argument("--max-connections", type=int, default=64,
                   help="connection-admission bound (default 64)")
    p.add_argument("--max-inflight", type=int, default=8,
                   help="in-flight query bound (default 8)")
    p.add_argument("--shed-policy", default="landmark",
                   choices=["landmark", "hopset", "priced", "reject", "off"],
                   help="overload shedding when the SLO burn alert fires "
                        "(default landmark)")
    p.add_argument("--drain-timeout", type=float, default=10.0,
                   metavar="SECONDS",
                   help="SIGTERM drain deadline (default 10)")
    p.add_argument("--retry-after-ms", type=int, default=100,
                   help="retry_after_ms hint of overloaded rejections")
    p.add_argument("--shed-min-events", type=int, default=20,
                   help="observations in the burn rule's long window before "
                        "shedding engages (default 20; 0 disables)")
    p.add_argument("--max-inflight-per-client", type=int, default=None,
                   metavar="N",
                   help="per-client in-flight cap under --max-inflight")
    p.add_argument("--http", action="store_true",
                   help="speak minimal HTTP/1.1 on --listen: POST /query, "
                        "GET /healthz")
    p.add_argument("--fleet-dir", default=None, metavar="DIR",
                   help="register this replica in a serve-fleet directory "
                        "(requires --listen)")
    p.add_argument("--replica-id", default=None, metavar="ID",
                   help="membership record name (default: replica-<pid>)")
    p.add_argument("--replica-heartbeat", type=float, default=1.0,
                   metavar="SECONDS",
                   help="membership heartbeat interval (default 1)")
    p.add_argument("--route", default=None, metavar="FLEET_DIR",
                   help="router mode: forward pjtpu-serve/1 lines to the "
                        "owning replica of FLEET_DIR's consistent-hash "
                        "table (uses --listen for the bind address)")
    p.add_argument("--replica-stale", type=float, default=None,
                   metavar="SECONDS",
                   help="router: eject replicas whose membership record is "
                        "older than this (default: 5)")
    p.add_argument("--tune-dir", default=None, metavar="DIR",
                   help="drain probe leases from this tuning-fleet "
                        "directory while idle")
    _add_common(p)

    p = sub.add_parser("top", help="fleet-wide operations console")
    p.add_argument("--serve-store", default=None, metavar="DIR",
                   help="serving store whose serve_stats.json + "
                        "repair_status.json to join")
    p.add_argument("--coordinator-dir", default=None, metavar="DIR",
                   help="fleet coordinator directory")
    p.add_argument("--fleet-dir", default=None, metavar="DIR",
                   help="serve-fleet directory (replica heartbeats + "
                        "routing.json)")
    p.add_argument("--once", action="store_true",
                   help="print one view and exit")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the joined document as JSON")
    p.add_argument("--interval", type=float, default=2.0, metavar="SECONDS",
                   help="refresh period of the live view (default 2)")
    p.add_argument("--stale-after", type=float, default=15.0,
                   metavar="SECONDS",
                   help="flag a snapshot/heartbeat stale past this age")

    p = sub.add_parser("update", help="incremental graph update of a "
                                      "solved --checkpoint-dir")
    p.add_argument("graph", help="path or loader spec of the PRE-update "
                                 "graph the checkpoint was solved from")
    p.add_argument("--updates", required=True, metavar="FILE",
                   help="edge-update file: JSON {\"u\": U, \"v\": V, \"w\": "
                        "W|null} or 'U V W' lines (null/inf removes)")
    p.add_argument("--dry-run", action="store_true",
                   help="print the dirty-set diagnosis without repairing")
    p.add_argument("--fleet-dir", default=None, metavar="DIR",
                   help="shard the row regeneration through repair leases "
                        "(in-process workers)")
    p.add_argument("--fleet-workers", type=int, default=2,
                   help="worker claim loops for --fleet-dir (default 2)")
    p.add_argument("--strategy", default="auto",
                   choices=["auto", "repair", "resolve"],
                   help="repair-vs-resolve policy (auto prices both)")
    _add_common(p)

    p = sub.add_parser("tune", help="probe knob values under hard budgets "
                                    "into the profile store")
    p.add_argument("graph", help="path or loader spec of the graph (= the "
                                 "shape bucket) to calibrate")
    p.add_argument("--store-dir", default=None, metavar="DIR",
                   help="profile store (default: $PJ_PROFILE_DIR, else "
                        "bench_artifacts/profiles)")
    p.add_argument("--knobs", default=None, metavar="K1,K2",
                   help="comma-separated knob subset")
    p.add_argument("--probe-budget", type=float, default=30.0,
                   metavar="SECONDS", help="hard cap per probe (default 30)")
    p.add_argument("--bucket-budget", type=float, default=120.0,
                   metavar="SECONDS",
                   help="total probe budget; 0 does nothing (default 120)")
    p.add_argument("--fleet-dir", default=None, metavar="DIR",
                   help="plan the probes as coordinator tuning leases in DIR")
    p.add_argument("--workers", type=int, default=1,
                   help="in-process claim loops for --fleet-dir (0 = plan "
                        "only)")
    p.add_argument("--harvest", action="store_true",
                   help="merge committed tuning-lease shards from "
                        "--fleet-dir into the store and exit")
    p.add_argument("--json", action="store_true", dest="as_json")
    _add_device(p)

    p = sub.add_parser("fleet", help="distributed solve fleet over a "
                                     "coordinator dir")
    fsub = p.add_subparsers(dest="fleet_command", required=True)
    pf = fsub.add_parser("solve", help="plan a fleet, run local workers, "
                                       "merge the manifest")
    pf.add_argument("graph", help="path or loader spec")
    pf.add_argument("--coordinator-dir", required=True, metavar="DIR")
    pf.add_argument("--workers", type=int, default=2,
                    help="local worker subprocesses (default 2), all on "
                         "--device")
    pf.add_argument("--num-sources", type=int, default=None)
    pf.add_argument("--lease-sources", type=int, default=None)
    pf.add_argument("--lease-deadline", type=float, default=30.0,
                    metavar="SECONDS")
    pf.add_argument("--heartbeat-stale", type=float, default=None,
                    metavar="SECONDS")
    pf.add_argument("--backend", default="torch")
    pf.add_argument("--batch-size", type=int, default=None,
                    help="worker source_batch_size")
    pf.add_argument("--in-process", action="store_true",
                    help="run the workers sequentially in this process")
    _add_device(pf)
    pf = fsub.add_parser("status", help="lease counts, requeues, heartbeat "
                                        "ages, one JSON")
    pf.add_argument("--coordinator-dir", required=True, metavar="DIR")
    pf = fsub.add_parser("resume", help="continue an interrupted fleet")
    pf.add_argument("--coordinator-dir", required=True, metavar="DIR")
    pf.add_argument("--workers", type=int, default=2)
    _add_device(pf)

    p = sub.add_parser("info", help="environment summary; with a graph "
                                    "spec, the per-graph route diagnosis")
    p.add_argument("graph", nargs="?", default=None,
                   help="optional loader spec / path to diagnose")
    p.add_argument("--serve-store", default=None, metavar="DIR",
                   help="also report a tile store's persisted serving state")
    p.add_argument("--profile-store", default=None, metavar="DIR",
                   help="profile store to price routes from (default: "
                        "$PJ_PROFILE_DIR, else bench_artifacts/profiles "
                        "when present)")
    p.add_argument("--updates", default=None, metavar="FILE",
                   help="with a graph spec and --checkpoint-dir: diagnose "
                        "this update file's dirty set")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="checkpoint directory for the --updates diagnosis")
    p.add_argument("--json", action="store_true", dest="as_json")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "top":
        return _cmd_top(args)
    if args.command == "info":
        return _cmd_info(args)
    if args.command == "fleet" and args.fleet_command == "status":
        return _cmd_fleet(args, None)
    device = None
    if not (args.command == "serve" and args.route):
        # Every other verb solves or holds tensors: on the card unless
        # --device cpu, and never on the CPU by itself.
        from paralleljohnson_tpu_torch.utils.platform import cli_device

        try:
            device = cli_device(args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    if args.command == "bench":
        return _cmd_bench(args, device)
    if args.command == "fleet":
        return _cmd_fleet(args, device)
    if args.command == "tune":
        return _cmd_tune(args, device)
    return _cmd_solving(args, device)


def _cmd_bench(args, device) -> int:
    from paralleljohnson_tpu_torch import benchmarks

    if device.type == "cuda":
        from paralleljohnson_tpu_torch.observe import card_info

        card = card_info(device)
        print(f"nvidia-smi: {card['name']}, {card['power_limit']}",
              file=sys.stderr)
    try:
        records = benchmarks.run(
            args.configs or None, backend=args.backend, preset=args.preset,
            telemetry_dir=args.trace_dir, profile_dir=args.profile_store,
            device=str(device),
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    for r in records:
        print(r.as_json_line(), flush=True)
    if args.update_baseline:
        benchmarks.update_baseline_md(records, args.update_baseline)
    return 1 if any("failed" in r.detail for r in records) else 0


def _cmd_top(args) -> int:
    import time

    from paralleljohnson_tpu_torch.observe.top import gather_ops, render_ops

    if (args.serve_store is None and args.coordinator_dir is None
            and args.fleet_dir is None):
        print("error: pjtpu top needs --serve-store, --fleet-dir, and/or "
              "--coordinator-dir (nothing to watch)", file=sys.stderr)
        return 1
    try:
        while True:
            doc = gather_ops(serve_store=args.serve_store,
                             coordinator_dir=args.coordinator_dir,
                             serve_fleet=args.fleet_dir,
                             stale_after_s=args.stale_after)
            if args.as_json:
                print(json.dumps(doc), flush=True)
            else:
                if not args.once:
                    print("\x1b[2J\x1b[H", end="")  # repaint like top(1)
                print(render_ops(doc), flush=True)
            if args.once:
                return 0
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0


def _cmd_fleet(args, device) -> int:
    from paralleljohnson_tpu_torch.distributed import (
        Coordinator,
        CoordinatorError,
        launch_local_fleet,
        plan_fleet,
    )
    from paralleljohnson_tpu_torch.distributed.launch import run_in_process_fleet

    try:
        if args.fleet_command == "status":
            print(json.dumps(Coordinator(args.coordinator_dir).status(),
                             indent=2))
            return 0
        if args.fleet_command == "solve":
            config = {}
            if args.batch_size is not None:
                config["source_batch_size"] = args.batch_size
            coord = plan_fleet(
                args.coordinator_dir, args.graph,
                n_workers=args.workers,
                num_sources=args.num_sources,
                lease_sources=args.lease_sources,
                lease_deadline_s=args.lease_deadline,
                heartbeat_stale_s=args.heartbeat_stale,
                backend=args.backend,
                config=config,
            )
        else:  # resume
            coord = Coordinator(args.coordinator_dir)
        if getattr(args, "in_process", False):
            report = run_in_process_fleet(coord, args.workers,
                                          device=str(device))
        else:
            report = launch_local_fleet(coord, args.workers,
                                        device=str(device))
        print(json.dumps(report.as_dict()))
        if not report.ok:
            print(f"error: fleet incomplete — {report.leases_committed}/"
                  f"{report.leases_total} leases committed (resume with: "
                  f"pjtpu fleet resume --coordinator-dir {coord.dir})",
                  file=sys.stderr)
            return 3
        return 0
    except CoordinatorError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _cmd_tune(args, device) -> int:
    from paralleljohnson_tpu_torch import load_graph
    from paralleljohnson_tpu_torch import tuner
    from paralleljohnson_tpu_torch.distributed.coordinator import (
        CoordinatorError,
    )

    store_dir = (args.store_dir or os.environ.get("PJ_PROFILE_DIR")
                 or "bench_artifacts/profiles")
    knobs = ([k.strip() for k in args.knobs.split(",") if k.strip()]
             if args.knobs else None)
    try:
        if args.harvest:
            if not args.fleet_dir:
                print("error: --harvest needs --fleet-dir", file=sys.stderr)
                return 1
            print(json.dumps(tuner.harvest_tuning(args.fleet_dir, store_dir)))
            return 0
        g = load_graph(args.graph)
        if args.fleet_dir:
            coord = tuner.plan_tuning_fleet(
                args.fleet_dir, graph_spec=args.graph, graph=g, knobs=knobs,
                store_dir=store_dir, probe_budget_s=args.probe_budget,
                device=device,
            )
            out = {"fleet_dir": str(coord.dir), "leases": len(coord.leases()),
                   "workers": []}
            for w in range(args.workers):
                out["workers"].append(tuner.run_tuning_worker(
                    args.fleet_dir, f"tuner{w}", graph=g, device=device))
            if args.workers:
                out["harvest"] = tuner.harvest_tuning(args.fleet_dir,
                                                      store_dir)
            print(json.dumps(out, default=str))
            return 0
        summary = tuner.tune_bucket(
            g, store_dir=store_dir, knobs=knobs,
            probe_budget_s=args.probe_budget,
            bucket_budget_s=args.bucket_budget, device=device,
        )
        print(json.dumps(summary, default=str,
                         indent=None if args.as_json else 2))
        return 0
    except (CoordinatorError, ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _cmd_solving(args, device) -> int:
    """solve / sssp / batch / serve / update: one config, the reference's
    exception-to-exit-code mapping, telemetry closed on every path."""
    from paralleljohnson_tpu_torch import (
        NegativeCycleError,
        SolveCorruptionError,
        StageAbandonedError,
    )

    cfg = None
    try:
        cfg = _config(args)
        run = {"solve": _cmd_solve, "sssp": _cmd_sssp, "batch": _cmd_batch,
               "serve": _cmd_serve, "update": _cmd_update}[args.command]
        return run(args, cfg, device)
    except NegativeCycleError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (SolveCorruptionError, StageAbandonedError) as e:
        # Corruption the sanity guard caught, or a stage the watchdog
        # abandoned on every attempt.
        print(f"error: {e}", file=sys.stderr)
        return 3
    except (ValueError, FileNotFoundError, NotImplementedError) as e:
        # NotImplementedError: a config the port does not run yet
        # (SolverConfig.unsupported names the field).
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        # Stop the heartbeat, export the Chrome trace, close the flight
        # file, also on the error paths.
        tel = getattr(cfg, "telemetry", None)
        if tel is not None:
            tel.close()


def _sources(args):
    if args.sources is not None:
        return np.array([int(s) for s in args.sources.split(",")])
    if args.num_sources is not None:
        return np.arange(args.num_sources)
    return None


def _cmd_solve(args, cfg, device) -> int:
    from paralleljohnson_tpu_torch import ParallelJohnsonSolver, load_graph
    from paralleljohnson_tpu_torch.utils.profiling import device_trace

    g = load_graph(args.graph)
    sources = _sources(args)
    if args.reduce is not None:
        unsupported = [flag for flag, on in [
            ("--predecessors", args.predecessors),
            ("--output", args.output is not None),
            ("--validate", args.validate),
            ("--checkpoint-dir", args.checkpoint_dir is not None),
        ] if on]
        if unsupported:
            # Rows are reduced on the device and never materialized:
            # nothing to save or check.
            print(f"error: --reduce does not support "
                  f"{', '.join(unsupported)}", file=sys.stderr)
            return 1
        with (device_trace(args.profile, cfg.telemetry),
              ParallelJohnsonSolver(cfg, device=device) as solver):
            red = solver.solve_reduced(g, sources=sources,
                                       reduce_rows=args.reduce)
        _write_metrics(red.stats, args)
        if args.log_stats:
            _log_stats(red.stats, "solve--reduce")
        vals = [v.tolist() if hasattr(v, "tolist") else v for v in red.values]
        payload = {"reducer": args.reduce, "batches": len(vals),
                   "values": vals, **red.stats.as_dict()}
        print(json.dumps(payload) if args.as_json else
              f"{args.reduce}: {vals}")
        return 0
    if (cfg.error_budget > 0 or cfg.hopset is True) and not args.predecessors:
        # Budgeted solve: the planner arbitrates exact vs the certified
        # hopset+bf tier (a zero budget never reaches here).
        from paralleljohnson_tpu_torch.solver.approx import (
            ApproxResult,
            solve_with_budget,
        )

        with device_trace(args.profile, cfg.telemetry):
            res, _ = solve_with_budget(g, sources, config=cfg,
                                       telemetry=cfg.telemetry, device=device)
        if isinstance(res, ApproxResult):
            _report_approx(res, args)
        else:
            _report(res, args)
        return 0
    with (device_trace(args.profile, cfg.telemetry),
          ParallelJohnsonSolver(cfg, device=device) as solver):
        res = solver.solve(g, sources=sources,
                           predecessors=args.predecessors)
    _report(res, args)
    return 0


def _cmd_sssp(args, cfg, device) -> int:
    from paralleljohnson_tpu_torch import ParallelJohnsonSolver, load_graph
    from paralleljohnson_tpu_torch.utils.profiling import device_trace

    g = load_graph(args.graph)
    with (device_trace(args.profile, cfg.telemetry),
          ParallelJohnsonSolver(cfg, device=device) as solver):
        res = solver.sssp(g, args.source, predecessors=args.predecessors)
    _report(res, args)
    return 0


def _cmd_batch(args, cfg, device) -> int:
    from paralleljohnson_tpu_torch import ParallelJohnsonSolver
    from paralleljohnson_tpu_torch.graphs import random_graph_batch
    from paralleljohnson_tpu_torch.utils.profiling import device_trace

    if args.predecessors:
        print("error: batch mode does not support --predecessors",
              file=sys.stderr)
        return 1
    graphs = random_graph_batch(args.count, args.nodes, args.p, seed=args.seed)
    with (device_trace(args.profile, cfg.telemetry),
          ParallelJohnsonSolver(cfg, device=device) as solver):
        results = solver.solve_batch(graphs)
    stats = results[0].stats
    _write_metrics(stats, args)
    if args.log_stats:
        _log_stats(stats, "batch")
    payload = {"graphs": len(results),
               "matrix_shape": list(results[0].dist.shape),
               **stats.as_dict()}
    print(json.dumps(payload) if args.as_json else
          f"{len(results)} graphs solved; {stats.total_seconds:.3f}s total, "
          f"{stats.edges_relaxed:,} edges relaxed")
    return 0


def _cmd_serve(args, cfg, device) -> int:
    if args.route:
        return _serve_router(args)
    if args.graph is None:
        print("error: pjtpu serve requires a GRAPH positional (or --route "
              "FLEET_DIR for router mode)", file=sys.stderr)
        return 1
    from paralleljohnson_tpu_torch import load_graph
    from paralleljohnson_tpu_torch.observe.live import SLO
    from paralleljohnson_tpu_torch.serve import (
        DEFAULT_HOT_ROWS,
        DEFAULT_WARM_ROWS,
        LandmarkIndex,
        QueryEngine,
        TileStore,
    )

    g = load_graph(args.graph)
    store = TileStore(
        args.store_dir, g,
        hot_rows=DEFAULT_HOT_ROWS if args.hot_rows is None else args.hot_rows,
        warm_rows=(DEFAULT_WARM_ROWS if args.warm_rows is None
                   else args.warm_rows),
    )
    landmarks = None
    k = args.landmarks or (
        16 if args.miss_policy == "landmark"
        or (args.listen and args.shed_policy == "landmark") else 0)
    if k > 0:
        if store.ckpt is not None:
            landmarks = LandmarkIndex.load(store.ckpt.dir,
                                           expect_digest=store.digest)
            if landmarks is not None and landmarks.k != k:
                landmarks = None  # stale size: rebuild
        if landmarks is None:
            landmarks = LandmarkIndex.build(g, k, config=cfg,
                                            picker=args.landmark_picker,
                                            device=device)
            if store.ckpt is not None:
                landmarks.save(store.ckpt.dir)
    # The certified approximate tier: load-or-build the persisted
    # hopset like the landmark index (digest-guarded; other knobs mean
    # rebuild). 'priced' shedding uses whichever tiers exist.
    hopset = None
    if (args.miss_policy == "hopset"
            or (args.listen and args.shed_policy == "hopset")
            or cfg.hopset is True):
        from paralleljohnson_tpu_torch.ops.hopset import Hopset, build_hopset

        if store.ckpt is not None:
            hopset = Hopset.load(store.ckpt.dir, expect_digest=store.digest)
            if (hopset is not None
                    and (hopset.epsilon != cfg.approx_epsilon
                         or (cfg.approx_beta is not None
                             and hopset.beta != cfg.approx_beta))):
                hopset = None  # stale knobs: rebuild
        if hopset is None:
            hopset = build_hopset(g, epsilon=cfg.approx_epsilon,
                                  beta=cfg.approx_beta,
                                  picker=args.landmark_picker,
                                  telemetry=cfg.telemetry, device=device)
            if store.ckpt is not None:
                hopset.save(store.ckpt.dir)
    engine = QueryEngine(
        g, store, landmarks=landmarks, hopset=hopset, config=cfg,
        miss_policy=args.miss_policy, device_lookup=args.device_lookup,
        slo=SLO(name="serve", latency_ms=args.slo_p99_ms, latency_pct=99.0,
                availability=args.slo_availability),
        stats_interval_s=args.stats_interval, device=device,
    )
    # An open engine's stats thread keeps the process alive: close it on
    # every path out (close is idempotent; the drain closes it too).
    try:
        if args.listen:
            _serve_listen(args, cfg, engine)
            rc = 0
        else:
            rc = _serve_lines(args, engine)
    finally:
        engine.close()
    if getattr(args, "metrics_file", None):
        # The serve metric table (pjtpu_queries_total, ...), not the
        # solver's.
        engine.write_metrics(args.metrics_file, labels={"command": "serve"})
    if args.summary:
        print(json.dumps(engine.serve_summary()), file=sys.stderr)
    return rc


def _serve_listen(args, cfg, engine) -> None:
    """The socket front end in the foreground until SIGTERM/SIGINT, then
    a graceful drain."""
    from paralleljohnson_tpu_torch.serve import (
        PROTOCOL,
        ServeFrontend,
        parse_listen,
    )

    host, port = parse_listen(args.listen)
    fe_kw = {}
    if args.batch_window is not None:
        fe_kw["batch_window"] = args.batch_window
    if args.batch_wait_ms is not None:
        fe_kw["batch_wait_ms"] = args.batch_wait_ms
    frontend = ServeFrontend(
        engine, host=host, port=port,
        max_connections=args.max_connections,
        max_inflight=args.max_inflight,
        shed_policy=args.shed_policy,
        drain_timeout_s=args.drain_timeout,
        retry_after_ms=args.retry_after_ms,
        shed_min_events=args.shed_min_events,
        fault_plan=cfg.fault_plan,
        heartbeat_file=args.heartbeat_file,
        max_inflight_per_client=args.max_inflight_per_client,
        http=args.http,
        fleet_dir=args.fleet_dir,
        replica_id=args.replica_id,
        fleet_heartbeat_s=args.replica_heartbeat,
        tune_dir=args.tune_dir,
        trace_sample=args.trace_sample,
        **fe_kw,
    ).start()
    # The announce line drills parse for the bound (ephemeral) port.
    print(json.dumps({
        "listening": f"{frontend.address[0]}:{frontend.address[1]}",
        "host": frontend.address[0],
        "port": frontend.address[1],
        "protocol": PROTOCOL,
        "shed_policy": args.shed_policy,
        "max_connections": args.max_connections,
        "max_inflight": args.max_inflight,
        "replica_id": frontend.replica_id,
        "http": args.http,
    }), flush=True)
    frontend.run_until_shutdown()


def _serve_lines(args, engine) -> int:
    """The JSON-lines loop over stdin or --queries: exit 1 when a line
    was malformed."""
    stream = (sys.stdin if args.queries == "-"
              else open(args.queries, encoding="utf-8"))
    n_errors = 0
    try:
        def answer(lines: list) -> int:
            responses, errs = engine.query_lines(lines)
            for r in responses:
                print(json.dumps(r), flush=True)
            return errs

        buf: list = []
        for line in stream:
            if not line.strip():
                continue
            buf.append(line)
            if len(buf) >= max(1, args.batch_queries):
                n_errors += answer(buf)
                buf = []
        if buf:
            n_errors += answer(buf)
    finally:
        if stream is not sys.stdin:
            stream.close()
    return 1 if n_errors else 0


def _serve_router(args) -> int:
    """Router mode: no graph and no engine, the consistent-hash forwarder
    over the fleet's membership records."""
    from paralleljohnson_tpu_torch.serve import (
        PROTOCOL,
        FleetRouter,
        parse_listen,
    )

    host, port = parse_listen(args.listen or "127.0.0.1:0")
    tel = _telemetry(args, label="router")
    try:
        router = FleetRouter(
            args.route, host=host, port=port,
            stale_after_s=(args.replica_stale
                           if args.replica_stale is not None else 5.0),
            retry_after_ms=args.retry_after_ms,
            telemetry=tel,
            trace_sample=args.trace_sample,
        ).start()
        table = router.table
        print(json.dumps({
            "listening": f"{router.address()[0]}:{router.address()[1]}",
            "host": router.address()[0],
            "port": router.address()[1],
            "protocol": PROTOCOL,
            "router": True,
            "fleet_dir": str(args.route),
            "epoch": table.epoch if table is not None else 0,
        }), flush=True)
        router.run_until_shutdown()
    finally:
        if tel is not None:
            tel.close()
    return 0


def _cmd_update(args, cfg, device) -> int:
    from paralleljohnson_tpu_torch import load_graph
    from paralleljohnson_tpu_torch.incremental import (
        IncrementalState,
        diagnose,
        load_updates,
        repair_checkpoint,
    )

    if not args.checkpoint_dir:
        print("error: pjtpu update requires --checkpoint-dir (the solved "
              "checkpoint to repair)", file=sys.stderr)
        return 1
    g = load_graph(args.graph)
    updates = load_updates(args.updates)
    if args.dry_run:
        from paralleljohnson_tpu_torch.utils.checkpoint import (
            BatchCheckpointer,
            graph_digest,
        )

        digest = graph_digest(g)
        ck = BatchCheckpointer(args.checkpoint_dir, graph_key=digest)
        if not ck.manifest():
            print(f"error: {ck.dir}: no completed batches for this graph — "
                  "nothing to diagnose", file=sys.stderr)
            return 1
        state = IncrementalState.load(ck.dir, expect_digest=digest)
        if state is None:
            state = IncrementalState.build(g, num_parts=args.partition_parts,
                                           config=cfg, device=device)
            state.save(ck.dir)
        _, report = g.apply_edge_updates(updates)
        print(json.dumps({
            "dry_run": True,
            "report": report.as_dict(),
            "dirty_set": diagnose(state, report.changed_edges).as_dict(),
        }))
        return 0
    if args.fleet_dir:
        from paralleljohnson_tpu_torch.incremental.fleet import (
            run_in_process_repair_fleet,
        )

        result = run_in_process_repair_fleet(
            args.checkpoint_dir, g, updates, coordinator_dir=args.fleet_dir,
            workers=args.fleet_workers, config=cfg,
            num_parts=args.partition_parts, device=device)
    else:
        result = repair_checkpoint(
            args.checkpoint_dir, g, updates, config=cfg,
            num_parts=args.partition_parts, strategy=args.strategy,
            device=device)
    payload = result.as_dict()
    if args.as_json:
        print(json.dumps(payload))
    elif result.trivial:
        print("update was a no-op (no effective edge changes); checkpoint "
              "unchanged")
    else:
        print(f"repaired {payload['batches_rewritten']} batches under digest "
              f"{result.new_digest}: {payload['rows_recomputed']} rows "
              f"re-expanded, {payload['rows_patched']} column-patched, "
              f"{payload['rows_copied']} copied bitwise")
        print(f"  dirty parts closed: {payload['dirty_parts_closed']} of "
              f"{payload['parts_total']}"
              + (" (+ boundary core)" if payload["core_recomputed"] else ""))
        print(f"  walls: closures {payload['closures_s'] * 1e3:.1f} ms, "
              f"expand {payload['expand_s'] * 1e3:.1f} ms, io "
              f"{payload['io_s'] * 1e3:.1f} ms")
    return 0


# -- info ---------------------------------------------------------------------

def _devices() -> list[dict]:
    """The cards ``torch.cuda`` sees, each with its name and the power
    limit ``nvidia-smi`` reports; ``[{"device": "cpu"}]`` without one."""
    import torch

    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    from paralleljohnson_tpu_torch.observe import card_info

    return [{"device": f"cuda:{i}", **card_info(torch.device("cuda", i))}
            for i in range(torch.cuda.device_count())]


def _kernels_block() -> dict:
    """The hand kernels' build directory and which ``csrc/*.cu``
    libraries are built there for the current sources (``nvcc`` is never
    started)."""
    from paralleljohnson_tpu_torch.ops import _cuda
    from paralleljohnson_tpu_torch.utils.platform import build_dir

    where = build_dir()
    libs = {}
    for name in _cuda.SIGNATURES:
        lib = where / _cuda._target(name).name
        libs[name] = {"source": f"paralleljohnson_tpu_torch/csrc/{name}.cu",
                      "library": str(lib), "built": lib.exists()}
    return {"build_dir": str(where), "compilation_cache_env":
            "PJ_COMPILE_CACHE", "libraries": libs}


def _info_doc() -> dict:
    """The static half of ``info``: the defaults and surfaces each
    subsystem runs under (the JAX package's keys, the port's text)."""
    from paralleljohnson_tpu_torch import available_backends
    from paralleljohnson_tpu_torch.config import SolverConfig
    from paralleljohnson_tpu_torch.graphs import available_loaders

    import torch

    dc = SolverConfig()
    return {
        "backends": available_backends(),
        "loaders": available_loaders(),
        "devices": _devices(),
        "default_backend_platform": (
            "cuda" if torch.cuda.is_available() else "cpu"),
        "cuda_available": torch.cuda.is_available(),
        "kernels": _kernels_block(),
        "resilience": {
            "retry_attempts": dc.retry_attempts,
            "retry_backoff_s": dc.retry_backoff_s,
            "stage_deadline_s": dc.stage_deadline_s,
            "min_source_batch": dc.min_source_batch,
            "oom_degradation": (
                "on a CUDA out-of-memory error: collapse the pipeline "
                "window to 1, then clear_caches + halve the source batch "
                "(floor min_source_batch), resume from the failed batch"
            ),
        },
        "observability": {
            "flags": {
                "--trace-dir": "incremental span/event JSONL "
                               "(flight-<cmd>.jsonl, readable after a "
                               "kill) + Perfetto trace-<cmd>.json",
                "--heartbeat-file": "progress JSON atomically rewritten "
                                    "every interval (stage/batch, "
                                    "batches_done, host RSS, CUDA bytes "
                                    "in use)",
                "--heartbeat-interval": float(
                    os.environ.get("PJ_HEARTBEAT_INTERVAL", "5.0")),
                "--metrics-file": "Prometheus textfile export "
                                  "(pjtpu_* counters/gauges)",
                "--trace-sample": "head-based request-trace sampling rate "
                                  "for serve/router ingress (default 1.0 "
                                  "when --trace-dir is set, 0 otherwise; "
                                  "the verdict travels the wire)",
            },
            "env_defaults": ["PJ_TRACE_DIR", "PJ_HEARTBEAT_FILE",
                             "PJ_HEARTBEAT_INTERVAL", "PJ_METRICS_FILE",
                             "PJ_TRACE_SAMPLE"],
            "request_tracing": {
                "ingress": "router or replica: whichever sees the request "
                           "first mints trace_id and samples once; the "
                           "wire context ({'trace': {'id', 'parent', "
                           "'sampled'}}) threads every hop",
                "spans": ["route_request", "forward", "serve_request",
                          "convoy_batch", "convoy_member", "query",
                          "serve_solve", "device_megabatch",
                          "shed_decision"],
                "assembler": "paralleljohnson_tpu_torch.observe.trace."
                             "assemble([DIR, ...])",
                "request_tree": "observe.trace.assemble(...)['traces']"
                                "[TRACE_ID]",
            },
            "offline_reader": "paralleljohnson_tpu_torch.observe.trace."
                              "load_flight(<flight.jsonl>)",
            "hung_vs_progressing": (
                "a heartbeat mtime older than the stale age means hung; "
                "fresh means progressing"
            ),
            "disabled_by_default": True,
        },
        "serving": {
            "command": "python -m paralleljohnson_tpu_torch serve <graph> "
                       "[--store-dir DIR] [--queries FILE|-]",
            "store_tiers": {
                "hot": "device-resident rows, LRU (default capacity 128; "
                       "--hot-rows)",
                "warm": "host-RAM LRU of materialized rows (default 4096; "
                        "--warm-rows)",
                "cold": "checkpoint batches via the persisted manifest; "
                        "any solve --checkpoint-dir is attachable",
            },
            "query_format": (
                'JSONL, one object per line: {"id": ..., "source": S, '
                '"dst": T | [T, ...] | null (full row), "mode": "exact" | '
                '"approx"}'
            ),
            "answer_contract": (
                "exact=true answers are bitwise the solver's rows "
                "(max_error 0); exact=false landmark answers carry "
                "|answer - exact| <= max_error, never unflagged; "
                "stale=true answers (pre-update rows) carry a "
                "landmark-derived max_error drift estimate"
            ),
            "device_lookup": {
                "flags": "--device-lookup auto|on|off [--batch-window W] "
                         "[--batch-wait-ms MS]",
                "paths": {
                    "host_lookup": "per-source tier walk (hot/warm/cold)",
                    "device_lookup": "megabatched gathers over the stacked "
                                     "[B, V] hot tile + on-device landmark "
                                     "bounds, on the card",
                },
                "contract": (
                    "bit-for-bit identical answers on every path: exact "
                    "hits move f32 bits; raw landmark bounds (f64) "
                    "compute on the card, the tolerance widening and "
                    "estimate finishing run on the host through shared "
                    "helpers"
                ),
                "micro_batching": (
                    "--listen requests convoy-combine into engine batches "
                    "(the leader drains up to --batch-window pending "
                    "peers); batch_width_p50/p99 land in serve_stats.json"
                ),
                "decision": "engine serve summary + bench detail record "
                            "the planner why-line (lookup.auto_decision)",
            },
            "landmark_picker": (
                "--landmark-picker uniform|coverage|boundary: coverage "
                "weights pivots by degree, boundary samples partition-"
                "frontier vertices, uniform is the reproducible default"
            ),
            "approximate_tier": {
                "flags": "--hopset [--approx-epsilon E] [--approx-beta B] "
                         "[--error-budget R] [--miss-policy hopset] "
                         "[--shed-policy hopset|priced]",
                "route": (
                    "hopset+bf: beta-bounded-hop Bellman-Ford (the "
                    "fanout_sweep kernel over 2^20-edge chunks) seeded "
                    "with pivot-relay rows; qualified only under a finite "
                    "--error-budget"
                ),
                "certificate": (
                    "every hopset answer carries exact=false plus a finite "
                    "per-entry max_error; unproven infinity reports "
                    "max_error inf"
                ),
                "composition": (
                    "a landmark interval and a hopset interval on the same "
                    "answer intersect: the tighter certified bound wins"
                ),
                "construction": (
                    "k ~ sqrt(V) pivots, beta-bounded forward+reverse pivot "
                    "rows; persisted digest-guarded as hopset.npz next to "
                    "landmarks.npz"
                ),
                "pricing": (
                    "hopset+bf appears in cost_observatory.priced_routes "
                    "beside the exact routes (explicit unpriced marker "
                    "until profiled)"
                ),
            },
            "listen": {
                "command": "python -m paralleljohnson_tpu_torch serve "
                           "<graph> --listen HOST:PORT [--max-connections "
                           "N] [--max-inflight N] [--shed-policy "
                           "landmark|hopset|priced|reject|off] "
                           "[--drain-timeout S]",
                "protocol": (
                    "newline-delimited JSON over TCP; one header line "
                    "{protocol: 'pjtpu-serve/1', graph_digest, "
                    "shed_policy} per connection; requests may add "
                    "deadline_ms; {'op': 'health'} returns liveness"
                ),
                "admission": (
                    "past --max-connections / --max-inflight new work gets "
                    "{'error': 'overloaded', 'retry_after_ms': ...}; a "
                    "deadline_ms request may wait for a slot up to its "
                    "deadline, then drops without touching the engine"
                ),
                "shedding": (
                    "when the SLO burn-rate alert fires (backed by >= "
                    "--shed-min-events observations), exact-MISS queries "
                    "degrade to flagged certified answers; hits still "
                    "answer exactly"
                ),
                "drain": (
                    "SIGTERM stops accepting, finishes in-flight requests "
                    "under --drain-timeout, flushes serve_stats.json + "
                    "serve_live.json, closes the engine, exits 0"
                ),
                "chaos_drill": "bench serve_overload / serve_fleet",
            },
            "exit_codes": {
                "0": "all queries answered (or clean SIGTERM drain)",
                "1": "some queries malformed / bad arguments / no card "
                     "without --device cpu",
                "2": "negative cycle during a scheduled solve",
                "3": "corruption or abandoned stage",
            },
        },
        "incremental": {
            "command": "python -m paralleljohnson_tpu_torch update <graph> "
                       "--updates FILE --checkpoint-dir DIR [--dry-run] "
                       "[--fleet-dir DIR]",
            "update_format": (
                'one update per line: {"u": U, "v": V, "w": W|null} JSON '
                "or 'U V W' text; w of null/inf removes the edge, the "
                "last update to a pair wins"
            ),
            "repair": (
                "re-close only dirty parts + the boundary core on the "
                "card, re-expand only affected source ranges, commit per "
                "batch under the NEW graph digest: bitwise a fresh full "
                "solve on integer weights"
            ),
            "staleness": (
                "while (and after) repair runs, the OLD digest's store "
                "serves affected sources with stale: true "
                "(repair_status.json)"
            ),
            "exit_codes": {
                "0": "repair complete (or dry-run diagnosis printed)",
                "1": "bad arguments, malformed update file, or no "
                     "checkpoint for this graph",
                "2": "the update batch creates a negative cycle "
                     "(checkpoint left intact)",
                "3": "corruption or abandoned stage during repair",
            },
        },
        "pipeline": {
            "pipeline_depth": dc.pipeline_depth or 2,
            "pipeline_depth_auto": (
                "None = auto: profile-tuned per (platform, shape bucket) "
                "when the store has measured alternatives, else 2"
            ),
            "compilation_cache_dir": dc.compilation_cache_dir,
            "compilation_cache_env": "PJ_COMPILE_CACHE",
            "overlap": (
                "batch k's device-to-host row copy (side stream, "
                "page-locked buffer) + checkpoint write run behind batch "
                "k+1's kernels; each extra in-flight slot carries one "
                "[B, V] block of device memory"
            ),
        },
        "cost_observatory": {
            "flags": {
                "--profile-store": (
                    "analytic costs per (route, platform, shape bucket), "
                    "roofline-classify each solve, append one record per "
                    "solve to DIR/profiles.jsonl"
                ),
            },
            "env_default": "PJ_PROFILE_DIR",
            "offline_readers": [
                "paralleljohnson_tpu_torch.observe.ProfileStore(DIR)",
                "paralleljohnson_tpu_torch.observe.regress.BenchHistory("
                "DIR)",
            ],
            "bound_kinds": {
                "hbm": "analytic bytes / peak bandwidth >= analytic "
                       "operations / peak compute",
                "mxu": "compute floor above the bandwidth floor",
                "host-io": "downloads + checkpoint waits (net of pipeline "
                           "overlap) dominate the wall",
                "unknown": "no capture for this solve",
            },
        },
        "convergence_observatory": {
            "flags": {
                "--convergence": (
                    "auto (on when telemetry or a profile store is "
                    "configured) / true / false"
                ),
            },
            "instrumented_routes": [
                "sweep", "sweep-sm", "vm", "vm-blocked", "vm-blocked+dw",
                "gs", "dia", "bucket",
            ],
            "per_iteration": [
                "frontier_size (vertices whose distance improved)",
                "relaxations_applied (labels improved)",
                "residual_mass (sum of finite distance decreases)",
            ],
            "summary_fields": [
                "iterations", "frontier_half_life",
                "tail_fraction (frontier < 1% of V)",
                "jfr_skippable_edge_frac",
            ],
            "heartbeat_fields": ["iter", "frontier_size", "eta_s"],
            "offline_readers": [
                "paralleljohnson_tpu_torch.observe.convergence",
            ],
            "evidence": "profile store kind='trajectory' records",
        },
        "dirty_window": {
            "flags": {
                "--dirty-window": (
                    "auto (engage only when a profile-store trajectory "
                    "record for this graph shape shows a collapsing "
                    "frontier) / true / false"
                ),
                "--dw-block": "vertices per activity bit",
            },
            "route_tags": ["vm-blocked+dw", "gs+dw"],
            "counters": (
                "exact examined vs skipped edge slots per solve; skipped "
                "= rounds x E - examined"
            ),
            "dispatch": (
                "auto consults observe.convergence.dw_decision over the "
                "store's kind=trajectory records, vetoed where the cost "
                "model prices pallas-vm cheaper; never engages blindly"
            ),
            "evidence": "profile store kind='trajectory' records",
        },
        "planner": {
            "flags": {
                "--planner": (
                    "auto/true: promote a cheaper qualified plan above the "
                    "priority incumbent when the profile store's CostModel "
                    "prices both beyond the noise band; false: declared "
                    "priority. Forced route flags pin the forced plan"
                ),
            },
            "registry": (
                "each kernel family declares a Plan (qualification, cost "
                "hook, build, failure policy) in "
                "paralleljohnson_tpu_torch.planner; dispatch picks the "
                "cheapest qualified plan and degrades down the ranking"
            ),
            "noise_band": 0.25,
            "auto_tuned_parameters": {
                "fw_tile": "hand-tuned fallback 512",
                "partition_parts": (
                    "hand-tuned fallback ~sqrt(V)/8, clamp [2, 32]"
                ),
                "delta": (
                    "hand-tuned fallback: mean |w| x degree heuristic "
                    "(ops.bucket.auto_delta)"
                ),
                "source_batch": (
                    "hand-tuned fallback: device-memory budget "
                    "(suggested_source_batch)"
                ),
                "pipeline_depth": "hand-tuned fallback 2",
                "approx_beta": (
                    "hand-tuned fallback ops.hopset.auto_beta(V, epsilon)"
                ),
            },
            "tuner": (
                "tune probes candidate knob values under hard wall-clock "
                "budgets and lands kind='plan' records plus kind='tune' "
                "audit rows; promotion stays behind the 25% noise band"
            ),
            "tuning": (
                "per (platform, shape bucket) from the store's "
                "kind='plan' records: the value with the lowest recorded "
                "wall wins once >= 2 distinct values were measured; "
                "explicit config values always win"
            ),
            "records": "kind='plan' rows in profiles.jsonl",
        },
    }


def _serve_stores(root_dir: str) -> list[dict]:
    """Each graph store's persisted serving state under ``root_dir``
    (serve_stats.json, landmark and hopset sizes)."""
    from pathlib import Path

    from paralleljohnson_tpu_torch.serve import SERVE_STATS_FILENAME

    root = Path(root_dir)
    stores = []
    for d in sorted({root, *root.glob("graph_*")}):
        entry = {}
        stats_f = d / SERVE_STATS_FILENAME
        if stats_f.exists():
            try:
                entry.update(json.loads(stats_f.read_text(encoding="utf-8")))
            except ValueError:
                entry["error"] = "unreadable serve_stats.json"
        lm_f = d / "landmarks.npz"
        if lm_f.exists():
            try:
                with np.load(lm_f) as z:
                    entry["landmarks_persisted"] = int(len(z["sources"]))
            except Exception:  # noqa: BLE001 — report, don't die
                entry["landmarks_persisted"] = "unreadable"
        hs_f = d / "hopset.npz"
        if hs_f.exists():
            try:
                with np.load(hs_f) as z:
                    piv = z["pivots"]
                    rng = np.arange(len(piv))
                    edges = int(
                        np.isfinite(z["fwd"]).sum()
                        + np.isfinite(z["rev"]).sum()
                        - np.isfinite(z["fwd"][rng, piv]).sum()
                        - np.isfinite(z["rev"][rng, piv]).sum()
                    ) if len(piv) else 0
                    entry["hopset_persisted"] = {
                        "epsilon": float(z["epsilon"]),
                        "beta": int(z["beta"]),
                        "k": int(len(piv)),
                        "edges": edges,
                        "converged": bool(z["converged"]),
                    }
            except Exception:  # noqa: BLE001 — report, don't die
                entry["hopset_persisted"] = "unreadable"
        if entry:
            entry["dir"] = str(d)
            stores.append(entry)
    return stores


def _graph_diagnosis(args, store_dir, model, device) -> dict:
    """The route each phase would take on ``args.graph`` and why: the
    same gates dispatch consults, on the torch backend, nothing built."""
    from paralleljohnson_tpu_torch import load_graph
    from paralleljohnson_tpu_torch.backends import get_backend
    from paralleljohnson_tpu_torch.config import SolverConfig
    from paralleljohnson_tpu_torch.solver import ParallelJohnsonSolver

    g = load_graph(args.graph)
    be = get_backend("torch", SolverConfig(profile_store=args.profile_store),
                     device=device)
    dg = be.upload(g)
    dia_lay = be.dia_bundle(dg)
    batch = min(128, max(g.num_nodes, 1))
    out = {
        "nodes": g.num_nodes,
        "edges": g.num_real_edges,
        "max_degree": dg.max_degree,
        "negative_weights": bool(g.has_negative_weights),
        "routes": {
            "dense": bool(be._use_dense(dg)),
            "fw": bool(be._use_fw(dg, g.num_nodes)),
            "dia": bool(be._use_dia(dg)),
            "bucket": bool(be._use_bucket(dg)),
            "gauss_seidel": bool(be._use_gs(dg)),
            "dirty_window": bool(be._use_dw(dg, batch)),
            "frontier": bool(be._use_frontier(dg)),
            "edge_shard": bool(be._use_edge_shard(dg)),
            "pred": "extract" if be._use_pred_extraction() else "sweep",
        },
        "dia_qualifies": dia_lay is not None,
        "dia_offsets": (list(dia_lay["offsets"]) if dia_lay is not None
                        else None),
        "low_degree_family": bool(be._low_degree_family(dg)),
        "dw_decision": be._dw_decision(dg, batch),
    }
    try:
        out["plan"] = be.plan_preview(dg, batch)
    except Exception as e:  # noqa: BLE001 — report, don't die
        out["plan"] = {"error": f"{type(e).__name__}: {e}"}
    out["routes"]["partitioned"], _ = ParallelJohnsonSolver(
        SolverConfig(), backend=be)._use_partitioned(g, np.arange(g.num_nodes))
    if model is not None and model.entries:
        # This graph priced on every calibrated route, at B=1 and at the
        # fan-out width.
        priced = {}
        for entry in model.table():
            route = entry["route"]
            p1 = model.predict(route, num_edges=g.num_real_edges, batch=1,
                               platform=entry["platform"])
            pb = model.predict(route, num_edges=g.num_real_edges,
                               batch=min(128, g.num_nodes),
                               platform=entry["platform"])
            if p1 is not None:
                priced[f"{route}@{entry['platform']}"] = {
                    "predicted_s_b1": round(p1["predicted_s"], 6),
                    "predicted_s_b128": (round(pb["predicted_s"], 6)
                                         if pb is not None else None),
                    "calibration_n": entry["n"],
                }
        out["priced_routes"] = priced
    try:
        from paralleljohnson_tpu_torch.tuner import provenance_table

        out["tuned_knobs"] = provenance_table(
            store_dir=store_dir, num_nodes=g.num_nodes,
            num_edges=g.num_real_edges,
            config=SolverConfig(profile_store=args.profile_store),
            device=device)
    except Exception as e:  # noqa: BLE001 — report, don't die
        out["tuned_knobs"] = {"error": f"{type(e).__name__}: {e}"}
    return out


def _update_diagnosis(args, device) -> dict:
    """The dirty set ``update`` would re-close for ``args.updates``; the
    incremental state is built once and persisted if absent."""
    from paralleljohnson_tpu_torch import load_graph
    from paralleljohnson_tpu_torch.incremental import (
        IncrementalState,
        diagnose,
        load_updates,
    )
    from paralleljohnson_tpu_torch.utils.checkpoint import (
        BatchCheckpointer,
        graph_digest,
    )

    g = load_graph(args.graph)
    digest = graph_digest(g)
    ck = BatchCheckpointer(args.checkpoint_dir, graph_key=digest)
    state = IncrementalState.load(ck.dir, expect_digest=digest)
    if state is None:
        state = IncrementalState.build(g, device=device)
        state.save(ck.dir)
    _, report = g.apply_edge_updates(load_updates(args.updates))
    return {
        "checkpoint_batches": len(ck.completed_batches()),
        "report": report.as_dict(),
        "dirty_set": diagnose(state, report.changed_edges).as_dict(),
    }


def _cmd_info(args) -> int:
    """A diagnostic: exits 0 without a card (``cuda_available: false``).
    Its graph and update diagnoses run on the card when there is one."""
    import torch

    info = _info_doc()
    device = "cuda" if torch.cuda.is_available() else "cpu"
    store_dir = (
        args.profile_store
        or os.environ.get("PJ_PROFILE_DIR")
        or ("bench_artifacts/profiles"
            if os.path.isdir("bench_artifacts/profiles") else None)
    )
    model = None
    if store_dir is not None:
        try:
            from paralleljohnson_tpu_torch.observe import CostModel, ProfileStore
            from paralleljohnson_tpu_torch.planner import KNOWN_ROUTES

            store = ProfileStore(store_dir)
            model = CostModel.fit(store)
            obs = info["cost_observatory"]
            obs["store"] = str(store.path)
            obs["records"] = len(store.records())
            table = model.table()
            # Every registry route appears: unmeasured ones carry an
            # explicit unpriced marker, never silently omitted.
            priced = {e["route"] for e in table}
            table.extend({"route": r, "platform": None, "unpriced": True}
                         for r in KNOWN_ROUTES if r not in priced)
            obs["priced_routes"] = table
        except Exception as e:  # noqa: BLE001 — report, don't die
            info["cost_observatory"]["store_error"] = (
                f"{type(e).__name__}: {e}")
            model = None
    if args.serve_store is not None:
        info["serving"]["stores"] = _serve_stores(args.serve_store)
    if args.graph is not None:
        info["graph"] = _graph_diagnosis(args, store_dir, model, device)
    if args.updates is not None:
        if args.graph is None or args.checkpoint_dir is None:
            info["incremental"]["diagnosis_error"] = (
                "--updates needs a graph spec and --checkpoint-dir")
        else:
            try:
                info["incremental"]["diagnosis"] = _update_diagnosis(
                    args, device)
            except (ValueError, FileNotFoundError) as e:
                info["incremental"]["diagnosis_error"] = (
                    f"{type(e).__name__}: {e}")
    print(json.dumps(info, indent=None if args.as_json else 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
