"""Query-serving layer: the first subsystem where the solver is a
component rather than the product. A :class:`TileStore` tiers solved
distance rows (device-hot / host-RAM-LRU-warm / checkpoint-cold), a
:class:`QueryEngine` aggregates client queries into source-batched
lookups and schedules exact solves for misses, and a
:class:`LandmarkIndex` answers unsolved sources immediately with a
certified ``(estimate, max_error)`` bound. :class:`ServeFrontend` is the
threaded socket server with admission control, per-request deadlines,
burn-rate-triggered certified load shedding, and a SIGTERM drain.
Concurrent socket clients are micro-batched through a
:class:`MicroBatcher` into device-width ``query_batch`` calls, and a
:class:`DeviceQueryPath` answers them in megabatched gathers over the
resident hot tier when the planner prices the device route cheaper.

The PyTorch port of the JAX package's ``serve``: the engine, and
everything that solves or holds tensors, takes ``device=`` (the card
unless the caller asks for the CPU)."""

from paralleljohnson_tpu_torch.serve.device_query import DeviceQueryPath
from paralleljohnson_tpu_torch.serve.engine import (
    DEFAULT_SLO,
    QueryEngine,
    QueryError,
    SERVE_PROM_METRICS,
    SERVE_STATS_FILENAME,
    ServeStats,
)
from paralleljohnson_tpu_torch.serve.fleet import (
    ReplicaRegistration,
    RoutingTable,
    live_replicas,
    publish_routing,
    read_replicas,
    read_routing,
)
from paralleljohnson_tpu_torch.serve.frontend import (
    DEFAULT_BATCH_WAIT_MS,
    DEFAULT_BATCH_WINDOW,
    MicroBatcher,
    PROTOCOL,
    SHED_POLICIES,
    ServeFrontend,
    parse_listen,
)
from paralleljohnson_tpu_torch.serve.router import FleetRouter
from paralleljohnson_tpu_torch.serve.landmarks import (
    Bounds,
    LandmarkIndex,
    PIVOT_PICKERS,
    finish_estimates,
    pick_pivots,
    widen_bounds,
)
from paralleljohnson_tpu_torch.serve.store import (
    DEFAULT_HOT_ROWS,
    DEFAULT_WARM_ROWS,
    TileStore,
)

__all__ = [
    "Bounds",
    "DEFAULT_BATCH_WAIT_MS",
    "DEFAULT_BATCH_WINDOW",
    "DEFAULT_HOT_ROWS",
    "DEFAULT_SLO",
    "DEFAULT_WARM_ROWS",
    "DeviceQueryPath",
    "FleetRouter",
    "LandmarkIndex",
    "MicroBatcher",
    "PIVOT_PICKERS",
    "PROTOCOL",
    "QueryEngine",
    "QueryError",
    "ReplicaRegistration",
    "RoutingTable",
    "SERVE_PROM_METRICS",
    "SERVE_STATS_FILENAME",
    "SHED_POLICIES",
    "ServeFrontend",
    "ServeStats",
    "TileStore",
    "finish_estimates",
    "live_replicas",
    "parse_listen",
    "pick_pivots",
    "publish_routing",
    "read_replicas",
    "read_routing",
    "widen_bounds",
]
