"""Incremental APSP — *make graph updates cheap*.

Today's checkpoints are keyed by graph content digest, so any edge
change used to invalidate the whole directory. This package repairs a
checkpoint instead of re-solving it, along the condensed partitioned
decomposition (ROADMAP item 5; RAPID-Graph's recursive-decomposition
insight):

- :mod:`~paralleljohnson_tpu_torch.incremental.state` — the dependency-
  tracked partition state: graph digest -> per-part digests ->
  boundary-core digest, plus the cached closures repair reuses.
- :mod:`~paralleljohnson_tpu_torch.incremental.repair` — dirty-set
  diagnosis + the repair engine: re-close only dirty parts + the core
  (through the ordinary resilient solver), re-expand only affected
  source ranges, commit through the corruption-checked checkpoint
  writer. Bitwise-identical to a fresh full solve on integer weights.
- :mod:`~paralleljohnson_tpu_torch.incremental.status` — the
  stale-but-servable marker the serve layer reads: answers from the
  pre-update checkpoint carry ``stale: true`` while (and after) repair
  runs, never an unflagged stale value.
- :mod:`~paralleljohnson_tpu_torch.incremental.fleet` — repair sharding
  through the fleet's lease coordinator.
- :mod:`~paralleljohnson_tpu_torch.incremental.updates` — the
  edge-update file format.

Closures solve on the card by default (``config`` and ``device=`` go to
one ordinary solver per operation); the expansion stays host numpy, as
in the JAX package. Either package's persisted state loads in the other.
"""

from paralleljohnson_tpu_torch.incremental.repair import (  # noqa: F401
    DirtySet,
    RepairResult,
    diagnose,
    prepare_repair,
    repair_checkpoint,
)
from paralleljohnson_tpu_torch.incremental.state import (  # noqa: F401
    IncrementalState,
)
from paralleljohnson_tpu_torch.incremental.status import (  # noqa: F401
    REPAIR_STATUS_FILENAME,
    read_repair_status,
    stale_sources,
    write_repair_status,
)
from paralleljohnson_tpu_torch.incremental.updates import (  # noqa: F401
    load_updates,
    parse_update_line,
)

__all__ = [
    "DirtySet",
    "IncrementalState",
    "REPAIR_STATUS_FILENAME",
    "RepairResult",
    "diagnose",
    "load_updates",
    "parse_update_line",
    "prepare_repair",
    "read_repair_status",
    "repair_checkpoint",
    "stale_sources",
    "write_repair_status",
]
