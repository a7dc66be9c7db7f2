"""Solver configuration.

``SolverConfig`` keeps every field name and every validation rule of the
JAX package's config, so one ``dataclasses.asdict`` builds in both
packages (``interop.config_from_dict``). The PyTorch port honours the
subset its routes implement; a field that forces a route the port does
not have yet raises ``NotImplementedError`` at solve time, naming the
field (:meth:`SolverConfig.unsupported`), and is never silently ignored.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Fan-out batches in flight when ``pipeline_depth`` is None and no
# profile-tuned depth applies: double buffering, the JAX package's
# hand-tuned default (defined with the tuning layer).
from paralleljohnson_tpu_torch.observe.tuning import (  # noqa: F401
    DEFAULT_PIPELINE_DEPTH,
)

BACKENDS = ("torch", "numpy", "cpp")


@dataclasses.dataclass
class SolverConfig:
    """Knobs for :class:`~paralleljohnson_tpu_torch.solver.ParallelJohnsonSolver`.

    Honoured by the port:
      backend: ``"torch"`` (device tensors, hand CUDA kernels on the card,
        their plain PyTorch versions on the CPU), ``"numpy"`` (the scipy
        oracle backend) or ``"cpp"`` (the C++/OpenMP baseline).
      precision: ``"f32"`` or ``"f64"``: the distances' dtype on every
        route (each hand kernel has an f64 version on the card).
      source_batch_size: sources per fan-out call; ``None`` sizes the
        batch from the device's free memory (``suggested_source_batch``).
      mesh_shape: ``None`` every rank device (every card on cuda, as
        the JAX package takes every device, at f32 and f64; one rank on
        the CPU; or the ranks ``PJ_MESH_DEVICES`` lists:
        ``parallel.mesh.default_devices``),
        ``(n,)`` a 1-D "sources" mesh of the first n
        cards or listed ranks (route ``sharded-1d`` from n = 2) or
        ``(n_s, n_e)`` a 2-D ("sources", "edges") mesh (``sharded-2d``).
      edge_shard: on a mesh of more than one rank, B=1 Bellman-Ford
        (phase 1, ``sssp``) with the edge list sharded over the ranks
        (``edge-sharded``): ``True`` forces it, ``"auto"`` takes it off
        the frontier / GS / DIA / bucket routes' graphs.
      max_iterations: cap on relaxation sweeps; ``None`` = |V|.
      dense_threshold / dense_min_density: the dense min-plus gate —
        V <= threshold and E >= density x V^2.
      edge_pad_multiple: the uploaded COO edge list is padded to this
        multiple with (0, 0, +inf) no-op edges.
      use_pallas: ``True`` / ``"auto"`` run the hand-kernel routes
        (``pallas-vm`` and ``dense-*-pallas``: the CUDA kernels on the
        card, their plain versions on the CPU). ``False`` takes the XLA
        routes of the JAX package in plain PyTorch: ``vm-blocked`` for V
        above ``VM_BLOCK`` (2^16), ``vm`` below, ``dense-*`` on dense
        graphs.
      fanout_layout: ``"auto"`` / ``"vertex_major"`` (the routes above);
        ``"source_major"`` takes the source-major scatter sweep
        ``sweep-sm`` for every sparse graph.
      frontier / frontier_capacity: the compacted-frontier B=1 route
        (phase 1 and ``sssp``). ``"auto"`` takes it on the low-degree
        family (V >= 512, max out-degree 1..32), as the JAX package does
        on every platform; ``True`` forces it, ``False`` keeps ``sweep``.
        ``frontier_capacity`` overrides its id buffer (V/8, at least
        1024).
      dia / dia_max_offsets, gauss_seidel / gs_block_size / gs_inner_cap,
        bucket / delta: the DIA stencil (B=1 and fan-out), blocked
        Gauss-Seidel (B=1 and fan-out) and bucketed delta-stepping (B=1)
        routes. Their ``"auto"`` engages only on a TPU in the JAX
        package, so here it stays off; ``True`` forces the route
        (``dia=True`` on a labeling that is not diagonal falls through
        to the next route, as in the JAX package).
      convergence: ``True`` records the per-iteration trajectory
        counters into ``SolverStats.convergence`` on the routes the JAX
        package instruments (``sweep``, ``sweep-sm``, ``vm``,
        ``vm-blocked``, ``vm-blocked+dw``, ``dia``, ``gs``, ``bucket``);
        ``"auto"`` records when a telemetry sink or a profile store is
        configured; ``False`` records nothing.
      dirty_window / dw_block: the dirty-window fan-out
        (``relax.bellman_ford_sweeps_dw``, route ``vm-blocked+dw``; inside
        a Gauss-Seidel solve, ``gs+dw``). ``True`` forces it; ``"auto"``
        engages only on a profile store's trajectory records of this
        shape bucket that show a collapsing frontier
        (``observe.convergence.dw_decision``), unless the store's cost
        model prices the route that would otherwise serve (``pallas-vm``
        first) cheaper; ``False`` disables it. ``dw_block`` is the
        vertices per activity bit (None = 1).
      planner / profile_store: ``profile_store`` (or the
        ``PJ_PROFILE_DIR`` environment variable) names a directory whose
        ``profiles.jsonl`` (the JAX package's format) receives a plan,
        solve and trajectory record per completed solve; every dispatch
        walk (``planner.select``) is then priced from it, and the tuned
        parameters (``fw_tile``, ``partition_parts``, ``pipeline_depth``,
        the source batch, ``delta``) are read from it where the config
        leaves them None. ``planner=False`` keeps the walks unpriced.
      fw / fw_threshold / fw_tile: blocked Floyd-Warshall (``ops.fw``,
        routes ``fw`` / ``fw-tile``). ``"auto"`` takes it, on every
        device as the JAX package does, for an all-sources-scale batch
        (2B >= V) of a dense graph (``dense_min_density``) with V <=
        ``fw_threshold`` where the exact MAC counts beat min-plus
        squaring; ``True`` forces it, ``False`` disables it.
        ``fw_tile`` is the tile edge (a multiple of 128; None = 512).
      partitioned / partition_parts: the condensed partitioned route
        (``solver.partitioned``, route ``condensed+fw``). ``True`` forces
        it; ``"auto"`` engages only on a TPU in the JAX package, so here
        it stays off, as ``False`` keeps it. ``partition_parts`` is the
        part count (None = ~sqrt(V)/8 in [2, 32]).
      pred_extraction: how ``predecessors=True`` solves get their trees.
        ``"auto"`` / ``True``: the route's distances, then one tight-edge
        pass (``ops.pred``; the hand ``tight_pred`` kernel on the card);
        a tree that fails its check (a zero-weight tight cycle) falls
        back to the argmin sweep ``pred-sweep`` with a warning, and
        raises under ``True``. ``False``: ``pred-sweep`` always.
      validate: cross-check the result against the scipy Johnson oracle.
      checkpoint_dir: write each finished source batch there and resume
        from it (the JAX package's on-disk format; either package resumes
        the other's directory).
      pipeline_depth: source batches in flight in the fan-out (``None`` =
        2): batch k's download and checkpoint write run behind batch
        k+1's compute; 1 is the serial loop.
      retry_attempts / retry_backoff_s / stage_deadline_s: the retry
        policy of every solve stage (:meth:`retry_policy`).
      min_source_batch: the floor of the OOM batch halving.
      fault_plan: a ``utils.faults.FaultPlan`` of injected failures.
      telemetry: a ``utils.telemetry.Telemetry`` flight recorder and
        heartbeat (None = off): spans per entry point, phase, stage
        attempt, finalize and checkpoint write; route, trajectory,
        retry and window events.
      metrics: an ``observe.live.MetricsRegistry`` (None = off): the
        batch loop's per-batch wall histogram and batch / retry / OOM
        counters.

      compilation_cache_dir: the directory ``nvcc`` builds the hand
        kernels into (``utils.platform.enable_compilation_cache``; None =
        ``$PJ_COMPILE_CACHE``, else ``paralleljohnson_tpu_torch/_build/``),
        fixed for the process once a kernel library has loaded.
    """

    backend: str = "torch"
    precision: str = "f32"
    source_batch_size: int | None = None
    mesh_shape: tuple[int, ...] | None = None
    max_iterations: int | None = None
    dense_threshold: int = 1024
    dense_min_density: float = 1.0 / 16.0
    edge_pad_multiple: int = 512
    use_pallas: bool | str = "auto"
    fanout_layout: str = "auto"
    frontier: bool | str = "auto"
    frontier_capacity: int | None = None
    dia: bool | str = "auto"
    dia_max_offsets: int = 16
    bucket: bool | str = "auto"
    delta: float | None = None
    gauss_seidel: bool | str = "auto"
    gs_block_size: int = 8192
    gs_inner_cap: int = 64
    fw: bool | str = "auto"
    fw_threshold: int = 1 << 14
    fw_tile: int | None = None
    partitioned: bool | str = "auto"
    partition_parts: int | None = None
    dirty_window: bool | str = "auto"
    dw_block: int | None = None
    pred_extraction: bool | str = "auto"
    edge_shard: bool | str = "auto"
    hopset: bool | str = "auto"
    approx_epsilon: float = 0.1
    approx_beta: int | None = None
    error_budget: float = 0.0
    checkpoint_dir: str | None = None
    pipeline_depth: int | None = None
    compilation_cache_dir: str | None = None
    validate: bool = False
    retry_attempts: int = 3
    retry_backoff_s: float = 0.05
    stage_deadline_s: float | None = None
    min_source_batch: int = 8
    fault_plan: object | None = None
    planner: bool | str = "auto"
    profile_store: str | None = None
    convergence: bool | str = "auto"
    telemetry: object | None = None
    metrics: object | None = None

    @property
    def np_dtype(self):
        return {"f32": np.float32, "f64": np.float64}[self.precision]

    def unsupported(self, device_type: str) -> list[str]:
        """Fields whose values force a route or layer this port lacks, as
        ``"field=value"`` strings (empty = the config is fully honoured
        on ``device_type``). The solver raises ``NotImplementedError``
        naming them. Every field is honoured on ``cpu`` and ``cuda``
        since ``precision="f64"`` runs on the card; the check stays for
        the next field a port of the reference adds before its route."""
        del device_type
        return []

    def retry_policy(self):
        """The :class:`~paralleljohnson_tpu_torch.utils.resilience.RetryPolicy`
        these knobs describe (one construction point for solver/backend)."""
        from paralleljohnson_tpu_torch.utils.resilience import RetryPolicy

        return RetryPolicy(
            max_attempts=self.retry_attempts,
            backoff_s=self.retry_backoff_s,
            deadline_s=self.stage_deadline_s,
        )

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}"
            )
        if self.precision not in ("f32", "f64"):
            raise ValueError(f"precision must be f32/f64, got {self.precision!r}")
        if self.use_pallas not in (True, False, "auto"):
            raise ValueError(
                f"use_pallas must be True/False/'auto', got {self.use_pallas!r}"
            )
        if self.fanout_layout not in ("auto", "source_major", "vertex_major"):
            raise ValueError(
                "fanout_layout must be auto/source_major/vertex_major, "
                f"got {self.fanout_layout!r}"
            )
        for name in ("frontier", "gauss_seidel", "dia", "bucket", "fw",
                     "partitioned", "dirty_window", "pred_extraction",
                     "edge_shard", "hopset", "planner", "convergence"):
            value = getattr(self, name)
            if value not in (True, False, "auto"):
                raise ValueError(
                    f"{name} must be True/False/'auto', got {value!r}"
                )
        if self.delta is not None and not self.delta > 0:
            raise ValueError(
                f"delta must be > 0 (or None = auto), got {self.delta!r}"
            )
        if self.fw_threshold < 0:
            raise ValueError(
                f"fw_threshold must be >= 0, got {self.fw_threshold}"
            )
        if self.fw_tile is not None and (
            self.fw_tile < 128 or self.fw_tile % 128
        ):
            raise ValueError(
                f"fw_tile must be a multiple of 128, got {self.fw_tile}"
            )
        if self.partition_parts is not None and self.partition_parts < 1:
            raise ValueError(
                "partition_parts must be >= 1 (or None = auto), got "
                f"{self.partition_parts}"
            )
        # The forced kernel routes are mutually exclusive, as in the JAX
        # package: forcing two at once is rejected, never resolved by
        # dispatch order.
        forced = [
            name
            for name in ("frontier", "gauss_seidel", "dia", "bucket", "fw")
            if getattr(self, name) is True
        ]
        if len(forced) > 1:
            raise ValueError(
                "mutually-exclusive route flags forced together: "
                + " and ".join(f"{n}=True" for n in forced)
                + "; force at most one (the others dispatch by 'auto')"
            )
        for name in ("dia_max_offsets", "gs_block_size", "gs_inner_cap",
                     "retry_attempts", "min_source_batch"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}"
                )
        if self.dw_block is not None and self.dw_block < 1:
            raise ValueError(
                f"dw_block must be >= 1 (or None = auto), got {self.dw_block}"
            )
        if not self.approx_epsilon > 0:
            raise ValueError(
                f"approx_epsilon must be > 0, got {self.approx_epsilon!r}"
            )
        if self.approx_beta is not None and self.approx_beta < 2:
            raise ValueError(
                "approx_beta must be >= 2 (or None = auto), got "
                f"{self.approx_beta!r}"
            )
        if not self.error_budget >= 0:
            raise ValueError(
                f"error_budget must be >= 0, got {self.error_budget!r}"
            )
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {self.retry_backoff_s}"
            )
        if self.stage_deadline_s is not None and not self.stage_deadline_s > 0:
            raise ValueError(
                "stage_deadline_s must be > 0 (or None), "
                f"got {self.stage_deadline_s}"
            )
        if self.pipeline_depth is not None and self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}"
            )
