"""Fleet launcher — plan, spawn, monitor, merge.

``plan_fleet`` writes the coordinator plan (graph digest, lease table);
``launch_local_fleet`` runs N worker **subprocesses on this host**, each
one mesh rank on ``device`` (``cuda``: the first card
``CUDA_VISIBLE_DEVICES`` leaves visible; several processes share it,
each with its own CUDA context), monitors them with a reap loop (a dead
worker's lapsed leases re-queue to survivors), and finishes by unioning
the shard manifests into ``fleet_manifest.json``. The one rank is set in
the workers' environment (``PJ_MESH_DEVICES``), as the JAX package's
launcher puts each local worker on one CPU device: N local workers never
each run a mesh over the same cards.

A multi-host fleet uses the SAME coordinator over a filesystem the hosts
share but not this launcher: each host runs one worker process directly
(``python -m paralleljohnson_tpu_torch.distributed.worker <dir>
--worker-id host<i>``) under its own process manager, and that worker's
solves take every card of its host (``mesh_shape=None``); the CLI's
``fleet status`` and ``fleet resume`` work on that dir unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from paralleljohnson_tpu_torch.distributed.coordinator import Coordinator
from paralleljohnson_tpu_torch.distributed.manifest import (
    FLEET_MANIFEST,
    build_fleet_manifest,
)


@dataclasses.dataclass
class FleetReport:
    """What a local fleet run produced (the CLI's ``fleet solve`` prints
    this as one JSON object)."""

    coordinator_dir: str
    n_workers: int
    wall_s: float
    requeues: int
    extensions: int
    leases_committed: int
    leases_total: int
    edges_relaxed: int
    worker_rcs: dict
    manifest_path: str | None
    status: dict

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def ok(self) -> bool:
        return (
            self.leases_committed == self.leases_total
            and self.manifest_path is not None
        )


def plan_fleet(
    coordinator_dir: str | Path,
    graph_spec: str,
    *,
    n_workers: int,
    num_sources: int | None = None,
    lease_sources: int | None = None,
    lease_deadline_s: float = 30.0,
    heartbeat_stale_s: float | None = None,
    heartbeat_interval_s: float | None = None,
    backend: str = "torch",
    config: dict | None = None,
) -> Coordinator:
    """Create the coordinator plan for ``graph_spec``.

    ``num_sources`` defaults to V (full APSP). ``lease_sources``
    defaults to ~4 leases per worker — coarse enough that claim traffic
    is noise, fine enough that a lost host re-queues a fraction of its
    work, not all of it. The graph is loaded once here to record its
    content digest: every worker re-loads from the spec and refuses a
    digest mismatch, so a fleet can never mix rows of different graphs.
    """
    from paralleljohnson_tpu_torch.graphs import load_graph
    from paralleljohnson_tpu_torch.utils.checkpoint import graph_digest

    graph = load_graph(graph_spec)
    n = graph.num_nodes if num_sources is None else int(num_sources)
    if lease_sources is None:
        lease_sources = max(1, -(-n // max(1, 4 * n_workers)))
    return Coordinator.create(
        coordinator_dir,
        graph_spec=graph_spec,
        graph_digest=graph_digest(graph),
        num_sources=n,
        lease_sources=int(lease_sources),
        lease_deadline_s=lease_deadline_s,
        heartbeat_stale_s=heartbeat_stale_s,
        heartbeat_interval_s=heartbeat_interval_s,
        backend=backend,
        config=config,
    )


def _worker_cmd(
    coordinator_dir: Path, worker_id: str, *,
    device="cuda",
    self_kill_after_claims: int | None = None,
    hold_until: Path | None = None,
) -> list[str]:
    cmd = [
        sys.executable, "-m", "paralleljohnson_tpu_torch.distributed.worker",
        str(coordinator_dir), "--worker-id", worker_id,
        "--device", str(device),
    ]
    if self_kill_after_claims is not None:
        cmd += ["--self-kill-after-claims", str(self_kill_after_claims)]
    if hold_until is not None:
        cmd += ["--hold-until", str(hold_until)]
    return cmd


def _worker_env(env: dict | None, device="cuda") -> dict:
    """Subprocess environment: inherit (the device is the worker's
    ``--device`` argument), pin the worker's mesh to one rank on that
    device (``PJ_MESH_DEVICES``; ``cuda`` is ``cuda:0``), and make the
    package importable even when run from a checkout."""
    import paralleljohnson_tpu_torch
    from paralleljohnson_tpu_torch.parallel.mesh import MESH_DEVICES_ENV

    out = dict(os.environ)
    out.update(env or {})
    dev = str(device)
    out[MESH_DEVICES_ENV] = "cuda:0" if dev == "cuda" else dev
    repo_root = str(Path(paralleljohnson_tpu_torch.__file__).resolve().parent.parent)
    parts = [repo_root] + [
        p for p in out.get("PYTHONPATH", "").split(os.pathsep) if p
    ]
    out["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
    return out


def launch_local_fleet(
    coordinator: Coordinator | str | Path,
    n_workers: int,
    *,
    env: dict | None = None,
    poll_s: float = 0.5,
    timeout_s: float | None = None,
    telemetry=None,
    self_kill: dict | None = None,
    device="cuda",
) -> FleetReport:
    """Run ``n_workers`` local worker subprocesses to completion, each
    one mesh rank on ``device`` (``cuda``: ``cuda:0`` for every worker;
    :func:`_worker_env`); a worker that cannot reach it exits non-zero,
    which ``worker_rcs`` shows.

    The monitor loop reaps lapsed leases every ``poll_s`` (a SIGKILLed
    worker's heartbeat goes stale, its range re-queues to survivors —
    each requeue lands as a ``lease_requeued`` telemetry event) and
    stops when every lease is committed, every worker died, or
    ``timeout_s`` passed. On success the shard manifests are unioned
    into ``fleet_manifest.json``; on partial completion the report says
    exactly what is missing (``fleet resume`` continues it).

    ``self_kill``: ``{worker_id: n_claims}`` fault injection — that
    worker SIGKILLs itself mid-lease after its n-th claim (the
    host-loss drill the dryrun and tests run). The other workers start
    at once but claim nothing until every such worker has exited
    (``--hold-until``), so each dies holding a lease and the drill
    always has one to requeue; the JAX package's launcher lets them
    race, and its survivors can drain every lease first.
    """
    from paralleljohnson_tpu_torch.utils.procs import graceful_stop

    coord = (
        coordinator if isinstance(coordinator, Coordinator)
        else Coordinator(coordinator)
    )
    worker_ids = [f"w{i}" for i in range(n_workers)]
    wenv = _worker_env(env, device)
    (coord.dir / "logs").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    procs: dict[str, subprocess.Popen] = {}
    logs = {}
    requeue_events = 0
    killed = [w for w in worker_ids if w in (self_kill or {})]
    hold = coord.dir / "logs" / "drill.go" if killed else None
    if hold is not None:
        hold.unlink(missing_ok=True)
    try:
        for wid in worker_ids:
            log = open(coord.dir / "logs" / f"{wid}.log", "ab")
            logs[wid] = log
            procs[wid] = subprocess.Popen(
                _worker_cmd(
                    coord.dir, wid, device=device,
                    self_kill_after_claims=(self_kill or {}).get(wid),
                    hold_until=None if wid in killed else hold,
                ),
                env=wenv, stdout=log, stderr=subprocess.STDOUT,
            )
        while True:
            if (hold is not None and not hold.exists()
                    and all(procs[w].poll() is not None for w in killed)):
                hold.touch()  # the drill's workers are dead: go
            for ev in coord.reap():
                if ev["ev"] == "requeued":
                    requeue_events += 1
                    if telemetry:
                        telemetry.event(
                            "lease_requeued", lease=ev["lease"],
                            worker=ev["worker"], reason=ev["reason"],
                        )
            if coord.done():
                break
            alive = [w for w, p in procs.items() if p.poll() is None]
            if not alive:
                break  # every worker exited with leases outstanding
            if timeout_s is not None and time.perf_counter() - t0 > timeout_s:
                break
            time.sleep(poll_s)
        # Workers exit on their own once the fleet is done; give them a
        # moment, then stop stragglers gently.
        deadline = time.time() + 30.0
        for wid, p in procs.items():
            remaining = max(0.1, deadline - time.time())
            try:
                p.wait(remaining)
            except subprocess.TimeoutExpired:
                graceful_stop(p)
    finally:
        for p in procs.values():
            if p.poll() is None:
                graceful_stop(p)
        for log in logs.values():
            log.close()
    status = coord.status()
    manifest_path = None
    if status["done"]:
        build_fleet_manifest(coord)
        manifest_path = str(coord.dir / FLEET_MANIFEST)
    edges = 0
    worker_rcs = {}
    for wid, p in procs.items():
        worker_rcs[wid] = p.returncode
        try:
            summary = json.loads(
                coord.worker_summary_path(wid).read_text(encoding="utf-8")
            )
            edges += int(summary.get("edges_relaxed", 0))
        except (OSError, ValueError):
            pass  # a killed worker leaves no summary — its log remains
    return FleetReport(
        coordinator_dir=str(coord.dir),
        n_workers=n_workers,
        wall_s=round(time.perf_counter() - t0, 6),
        requeues=status["requeues"],
        extensions=status["extensions"],
        leases_committed=status["leases"]["committed"],
        leases_total=status["leases_total"],
        edges_relaxed=edges,
        worker_rcs=worker_rcs,
        manifest_path=manifest_path,
        status=status,
    )


def run_in_process_fleet(
    coordinator: Coordinator | str | Path, n_workers: int, *,
    device="cuda",
) -> FleetReport:
    """Sequential in-process twin of :func:`launch_local_fleet` — the
    same claim/solve/commit/merge machinery with zero subprocess spawn
    cost. What the tier-1 tests and the smoke bench preset use (and a
    debugging convenience: pdb works). No concurrency, so no requeues
    can happen here."""
    from paralleljohnson_tpu_torch.distributed.worker import run_worker

    coord = (
        coordinator if isinstance(coordinator, Coordinator)
        else Coordinator(coordinator)
    )
    t0 = time.perf_counter()
    edges = 0
    worker_rcs = {}
    for i in range(n_workers):
        wid = f"w{i}"
        summary = run_worker(
            coord.dir, wid,
            max_leases=None if i == n_workers - 1 else max(
                1, len(coord.spec["leases"]) // n_workers
            ),
            device=device,
        )
        edges += int(summary["edges_relaxed"])
        worker_rcs[wid] = summary["rc"]
    status = coord.status()
    manifest_path = None
    if status["done"]:
        build_fleet_manifest(coord)
        manifest_path = str(coord.dir / FLEET_MANIFEST)
    return FleetReport(
        coordinator_dir=str(coord.dir),
        n_workers=n_workers,
        wall_s=round(time.perf_counter() - t0, 6),
        requeues=status["requeues"],
        extensions=status["extensions"],
        leases_committed=status["leases"]["committed"],
        leases_total=status["leases_total"],
        edges_relaxed=edges,
        worker_rcs=worker_rcs,
        manifest_path=manifest_path,
        status=status,
    )
