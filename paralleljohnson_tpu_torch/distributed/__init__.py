"""Distributed solve fleet — multi-host scale-out.

The single-host solver already survives OOMs, hung device calls, and
process kills (checkpoint/resume is the unit of recovery). This package
scales that resilience OUT: a **coordinator** partitions the source
space into leases (contiguous source ranges with an owner, a deadline,
and a ``pending -> leased -> committed`` state machine persisted as an
append-only JSONL), **workers** — one per host — claim leases and solve
their ranges through the ordinary resilient/pipelined solver into
per-worker checkpoint shard dirs, and a **shard manifest** unions the
per-worker manifests into one global source -> batch-file map that the
serving layer consumes unchanged. A worker whose lease deadline lapses
with a stale heartbeat has its range re-queued to survivors: a lost
host is a re-queued source range, not a dead run.

Runs end to end with local worker subprocesses over a filesystem
coordinator dir, on the card (several workers share it) or, with
``device="cpu"``, on the CPU; a multi-host fleet runs the SAME
coordinator with one worker process per host. The coordinator files keep
the JAX package's format, so either package reads the other's
directory.
"""

from paralleljohnson_tpu_torch.distributed.coordinator import (
    Coordinator,
    CoordinatorError,
    Lease,
    StaleLeaseError,
)
from paralleljohnson_tpu_torch.distributed.launch import (
    FleetReport,
    launch_local_fleet,
    plan_fleet,
)
from paralleljohnson_tpu_torch.distributed.manifest import (
    FLEET_MANIFEST,
    ShardedCheckpointer,
    build_fleet_manifest,
    fleet_rows,
)
from paralleljohnson_tpu_torch.distributed.worker import run_worker

__all__ = [
    "Coordinator",
    "CoordinatorError",
    "FLEET_MANIFEST",
    "FleetReport",
    "Lease",
    "ShardedCheckpointer",
    "StaleLeaseError",
    "build_fleet_manifest",
    "fleet_rows",
    "launch_local_fleet",
    "plan_fleet",
    "run_worker",
]
