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
import math

import numpy as np

BACKENDS = ("torch", "numpy")


@dataclasses.dataclass
class SolverConfig:
    """Knobs for :class:`~paralleljohnson_tpu_torch.solver.ParallelJohnsonSolver`.

    Honoured by the port:
      backend: ``"torch"`` (device tensors, hand CUDA kernels on the card,
        their plain PyTorch versions on the CPU) or ``"numpy"`` (the scipy
        oracle backend).
      precision: ``"f32"``; ``"f64"`` runs only on the CPU (the hand
        kernels are f32).
      source_batch_size: sources per fan-out call; ``None`` sizes the
        batch from the device's free memory (``suggested_source_batch``).
      mesh_shape: ``None`` or a one-device shape; more devices are not
        ported yet.
      max_iterations: cap on relaxation sweeps; ``None`` = |V|.
      dense_threshold / dense_min_density: the dense min-plus gate —
        V <= threshold and E >= density x V^2.
      edge_pad_multiple: the uploaded COO edge list is padded to this
        multiple with (0, 0, +inf) no-op edges.
      use_pallas: ``True`` / ``"auto"`` run the hand-kernel routes
        (``pallas-vm`` and ``dense-*-pallas``: the CUDA kernels on the
        card, their plain versions on the CPU). ``False`` forces the XLA
        routes of the JAX package (``vm``, ``vm-blocked``, ``dense-*``),
        which are not ported yet and raise on every device.
      fanout_layout: ``"auto"`` / ``"vertex_major"``; ``"source_major"``
        is not ported yet.
      validate: cross-check the result against the scipy Johnson oracle.

    Kept for config parity; forcing them raises at solve time until the
    route is ported: ``frontier``, ``gauss_seidel``, ``dia``, ``bucket``,
    ``fw``, ``partitioned``, ``dirty_window``, ``edge_shard`` (``True``),
    ``checkpoint_dir``, ``telemetry``, ``metrics``, ``fault_plan`` and
    ``profile_store`` (set). The remaining knobs (``delta``,
    ``gs_block_size``, ``fw_tile``, ``pipeline_depth``, ``retry_*``,
    ...) only tune routes or layers the port does not have yet.
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
        naming them."""
        bad = [
            f"{name}=True"
            for name in ("fw", "dia", "gauss_seidel", "bucket", "frontier",
                         "dirty_window", "partitioned", "edge_shard")
            if getattr(self, name) is True
        ]
        if self.mesh_shape is not None and math.prod(self.mesh_shape) > 1:
            bad.append(f"mesh_shape={self.mesh_shape}")
        if self.fanout_layout == "source_major":
            bad.append("fanout_layout='source_major'")
        for name in ("checkpoint_dir", "profile_store", "telemetry",
                     "metrics", "fault_plan"):
            if getattr(self, name) is not None:
                bad.append(f"{name} set")
        if self.precision == "f64" and device_type == "cuda":
            bad.append("precision='f64' on cuda (the kernels are f32)")
        if self.use_pallas is False:
            bad.append(
                "use_pallas=False (the XLA routes vm / vm-blocked / dense "
                "are not ported)"
            )
        return bad

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
