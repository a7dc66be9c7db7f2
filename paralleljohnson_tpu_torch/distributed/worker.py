"""Fleet worker — one per host; claims leases and solves them through
the ordinary resilient/pipelined solver.

A worker is deliberately thin: every hard problem it has (retries,
watchdog deadlines, OOM degradation, checkpoint/resume, pipelining,
telemetry) is the single-host solver's, unchanged. What the worker adds:

- a claim/solve/commit loop against the filesystem coordinator;
- a per-worker **checkpoint shard dir** (``<coord>/shards/<worker>``)
  — the ordinary ``SolverConfig.checkpoint_dir``, so a re-claimed lease
  on the SAME worker resumes from its own completed batches, and the
  fleet manifest unions the per-shard ``BatchCheckpointer`` manifests;
- a per-worker heartbeat file (``<coord>/heartbeats/<worker>.json``,
  the existing :class:`HeartbeatReporter`) whose freshness is how the
  coordinator distinguishes slow-but-alive (extend the lease) from
  dead (requeue the range);
- a per-worker flight-recorder dir (``<coord>/telemetry/<worker>``)
  labeled by worker id — ``scripts/trace_summary.py --merge`` joins a
  whole fleet's dirs into one post-mortem timeline.

Run as a subprocess (the local fleet; ``--device cpu`` in the tests)::

    python -m paralleljohnson_tpu_torch.distributed.worker <coord-dir> \
        --worker-id w0 --device cuda

Several workers may share one card: each is its own process with its
own CUDA context, so the plan pins ``source_batch_size`` (a batch sized
from the free memory each process sees would overcommit the card). A
worker that cannot reach its device exits non-zero; it never falls back
to the CPU. ``--multihost`` calls ``parallel.multihost.initialize()``
first (one worker process per host; torch's launcher environment
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``; without it
nothing is initialized and the worker carries on).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

from paralleljohnson_tpu_torch.distributed.coordinator import (
    Coordinator,
    CoordinatorError,
    StaleLeaseError,
)


def _write_json_atomic(path: Path, payload: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    tmp.write_text(json.dumps(payload), encoding="utf-8")
    os.replace(tmp, path)


def run_worker(
    coordinator_dir: str | Path,
    worker_id: str,
    *,
    config_overrides: dict | None = None,
    max_leases: int | None = None,
    poll_s: float = 0.25,
    idle_timeout_s: float = 600.0,
    self_kill_after_claims: int | None = None,
    tune_dir: str | Path | None = None,
    device="cuda",
) -> dict:
    """Claim-solve-commit until the fleet is done (or ``max_leases``).

    ``device``: where the solver runs (the card by default; ``"cpu"``
    runs the plain PyTorch versions). On the card the kernels are built
    or loaded before the first claim; ``kernel_build_s`` in the summary
    is that time (~0 when the libraries are already built).

    ``tune_dir``: optional tuning-fleet directory
    (:func:`paralleljohnson_tpu_torch.tuner.plan_tuning_fleet`). When the solve
    coordinator has no claimable lease, the worker claims ONE tuning
    lease from ``tune_dir`` instead of sleeping — idle fleet capacity
    becomes calibration probes. Solve leases always win: tuning is only
    attempted when ``claim`` comes back empty.

    ``self_kill_after_claims=k``: after the k-th successful claim the
    worker SIGKILLs itself mid-lease — the deterministic host-loss
    injection the requeue tests and the fleet dryrun use (an abrupt
    death with a lease held and no cleanup, exactly like a crashed or
    OOM-killed host).

    Returns (and persists to ``<coord>/workers/<id>.summary.json``) a
    summary: leases committed, sources solved, edges relaxed, stale
    commits, wall seconds.
    """
    from paralleljohnson_tpu_torch.config import SolverConfig
    from paralleljohnson_tpu_torch.graphs import load_graph
    from paralleljohnson_tpu_torch.observe.live import MetricsRegistry
    from paralleljohnson_tpu_torch.observe.trace import (
        current_trace_id,
        trace_attrs as _trace_attrs,
    )
    from paralleljohnson_tpu_torch.solver import ParallelJohnsonSolver
    from paralleljohnson_tpu_torch.utils.checkpoint import graph_digest
    from paralleljohnson_tpu_torch.utils.telemetry import Telemetry

    coord = Coordinator(coordinator_dir)
    spec = coord.spec
    t0 = time.perf_counter()

    tel = Telemetry.create(
        trace_dir=coord.telemetry_dir(worker_id),
        heartbeat_file=coord.heartbeat_path(worker_id),
        heartbeat_interval_s=float(spec["heartbeat_interval_s"]),
        label=f"worker-{worker_id}",
    )
    # Live metrics: claim-to-commit lease latency + the solver's batch
    # walls/retry rates, atomically snapshotted into
    # <coord>/metrics/<worker>.json on the heartbeat's clock — a
    # SIGKILLed worker leaves a view fresh to within one interval, and
    # the fleet's top view joins every worker's snapshot.
    metrics = MetricsRegistry(
        label=f"worker-{worker_id}", telemetry=tel
    ).start_snapshotter(
        coord.metrics_path(worker_id),
        interval_s=float(spec["heartbeat_interval_s"]),
    )
    lease_hist = metrics.histogram("pjtpu_lease_wall_ms")
    summary = {
        "worker": worker_id,
        "pid": os.getpid(),
        "leases_committed": [],
        "sources_solved": 0,
        "edges_relaxed": 0,
        "stale_commits": 0,
        "claims": 0,
        "tuning_leases": 0,
        "device": str(device),
        "kernel_build_s": None,
        "wall_s": 0.0,
        "rc": 0,
    }
    solver = None
    try:
        graph = load_graph(spec["graph_spec"])
        digest = graph_digest(graph)
        if digest != spec["graph_digest"]:
            raise CoordinatorError(
                f"{coord.dir / 'fleet.json'}: graph digest mismatch — plan "
                f"expects {spec['graph_digest']}, spec "
                f"{spec['graph_spec']!r} loads as {digest}; a fleet must "
                "never mix rows from different graphs"
            )
        # A restarted worker must not let its fresh heartbeat vouch for
        # leases its previous incarnation died holding.
        requeued = coord.recover_worker(worker_id)
        if requeued and tel:
            tel.event("lease_requeued", worker=worker_id,
                      leases=requeued, reason="owner-restart")

        cfg_kwargs = dict(spec.get("config") or {})
        cfg_kwargs.update(config_overrides or {})
        cfg_kwargs["backend"] = cfg_kwargs.get("backend", spec["backend"])
        cfg_kwargs["checkpoint_dir"] = str(coord.shard_dir(worker_id))
        cfg_kwargs["telemetry"] = tel
        cfg_kwargs["metrics"] = metrics
        solver = ParallelJohnsonSolver(SolverConfig(**cfg_kwargs),
                                       device=device)
        if torch.device(device).type == "cuda":
            from paralleljohnson_tpu_torch.ops import _cuda

            t_build = time.perf_counter()
            _cuda.build_all()
            summary["kernel_build_s"] = round(
                time.perf_counter() - t_build, 6)

        idle_since = None
        while True:
            if max_leases is not None and summary["claims"] >= max_leases:
                break
            lease = coord.claim(worker_id)
            if lease is None:
                if coord.done():
                    break
                if tune_dir is not None:
                    # Idle-capacity farm: no solve lease to
                    # claim, so run one calibration probe lease instead
                    # of sleeping. Probes run under their own wall-clock
                    # caps, so a solve lease freed meanwhile is picked up
                    # within one probe budget.
                    from paralleljohnson_tpu_torch.tuner import try_tuning_lease

                    tuned = try_tuning_lease(tune_dir, worker_id,
                                             device=device)
                    if tuned is not None:
                        summary["tuning_leases"] += 1
                        if tel:
                            tel.event("tuning_lease", worker=worker_id,
                                      lease=tuned["lease"],
                                      probes=len(tuned["probes"]),
                                      **_trace_attrs())
                        idle_since = None
                        continue
                # Outstanding leases belong to other workers; they will
                # either commit or be re-queued by a reap — poll, with a
                # hard idle cap so an orphaned worker cannot spin forever.
                idle_since = idle_since or time.perf_counter()
                if time.perf_counter() - idle_since > idle_timeout_s:
                    raise TimeoutError(
                        f"worker {worker_id}: no claimable lease for "
                        f"{idle_timeout_s:.0f}s and the fleet is not done"
                    )
                time.sleep(poll_s)
                continue
            idle_since = None
            summary["claims"] += 1
            t_claim = time.perf_counter()
            metrics.counter("pjtpu_lease_claims").add(1)
            if (
                self_kill_after_claims is not None
                and summary["claims"] >= self_kill_after_claims
            ):
                # Injected host loss: die abruptly WITH the lease held.
                # flush=True then SIGKILL — no atexit, no finally, no
                # lease release: exactly what a crashed host looks like.
                print(f"FLEET-WORKER {worker_id}: self-kill holding lease "
                      f"{lease.lease_id}", flush=True)
                import signal

                os.kill(os.getpid(), signal.SIGKILL)
            if tel:
                # Leases claimed on behalf of a traced update carry the
                # originating trace id so the assembler can join worker
                # flights into the request's timeline.
                tel.event("lease_claimed", worker=worker_id,
                          lease=lease.lease_id,
                          start=lease.start, stop=lease.stop,
                          **_trace_attrs())
                tel.progress(worker=worker_id, lease=lease.lease_id,
                             lease_range=[lease.start, lease.stop])
            try:
                res = solver.solve_range(graph, lease.start, lease.stop)
            except Exception:
                # Give the range back before dying: survivors take it
                # without waiting out the deadline.
                try:
                    coord.release(lease.lease_id, worker_id, reason="error")
                    if tel:
                        tel.event("lease_requeued", worker=worker_id,
                                  lease=lease.lease_id, reason="error",
                                  **_trace_attrs())
                except StaleLeaseError:
                    pass
                raise
            try:
                coord.commit(lease.lease_id, worker_id)
            except StaleLeaseError:
                # Deadline lapsed mid-solve and someone re-queued the
                # range: drop it (the rows stay orphaned in this shard;
                # the manifest union only references committing owners).
                summary["stale_commits"] += 1
                metrics.counter("pjtpu_lease_stale_commits").add(1)
                if tel:
                    tel.event("lease_stale_commit", worker=worker_id,
                              lease=lease.lease_id, **_trace_attrs())
                continue
            # Claim-to-commit wall: what a lease actually costs this
            # worker (solve + checkpoint + coordinator round trips) —
            # the number lease sizing will be priced against.
            lease_hist.record((time.perf_counter() - t_claim) * 1e3,
                              exemplar=current_trace_id())
            metrics.counter("pjtpu_leases_committed").add(1)
            summary["leases_committed"].append(lease.lease_id)
            summary["sources_solved"] += lease.stop - lease.start
            summary["edges_relaxed"] += int(res.stats.edges_relaxed)
            if tel:
                tel.event("lease_committed", worker=worker_id,
                          lease=lease.lease_id, **_trace_attrs())
                tel.progress(leases_committed=len(summary["leases_committed"]))
    except BaseException as e:
        summary["rc"] = 1
        summary["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        if solver is not None:
            solver.close()
        summary["wall_s"] = round(time.perf_counter() - t0, 6)
        metrics.stop_snapshotter()
        try:
            _write_json_atomic(coord.worker_summary_path(worker_id), summary)
        except OSError:
            pass  # a read-only coordinator dir still solved the leases
        if tel is not None:
            tel.close()
    return summary


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="paralleljohnson_tpu_torch.distributed.worker",
        description="fleet worker: claim leases from a coordinator dir and "
                    "solve them through the resilient solver",
    )
    ap.add_argument("coordinator_dir")
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--max-leases", type=int, default=None)
    ap.add_argument("--poll-s", type=float, default=0.25)
    ap.add_argument("--idle-timeout-s", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="where the solver runs: cuda (the default; exits "
                         "non-zero without a card) or cpu")
    ap.add_argument("--multihost", action="store_true",
                    help="call parallel.multihost.initialize() before "
                         "building the solver (one worker process per host; "
                         "env-driven MASTER_ADDR / MASTER_PORT / WORLD_SIZE "
                         "/ RANK)")
    ap.add_argument("--self-kill-after-claims", type=int, default=None,
                    help="TEST HOOK: SIGKILL self after the Nth claim, "
                         "lease held (deterministic host-loss injection)")
    ap.add_argument("--tune-dir", default=None,
                    help="idle-capacity tuning: when the solve "
                         "coordinator has no claimable lease, drain one "
                         "probe lease from this tuning-fleet dir instead "
                         "of sleeping")
    args = ap.parse_args(argv)

    if args.multihost:
        from paralleljohnson_tpu_torch.parallel import multihost

        multihost.initialize(device=args.device)
    try:
        summary = run_worker(
            args.coordinator_dir,
            args.worker_id,
            max_leases=args.max_leases,
            poll_s=args.poll_s,
            idle_timeout_s=args.idle_timeout_s,
            self_kill_after_claims=args.self_kill_after_claims,
            tune_dir=args.tune_dir,
            device=args.device,
        )
    except (CoordinatorError, ValueError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
