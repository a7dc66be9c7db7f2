"""``TorchBackend`` — the device execution engine of the PyTorch port.

Owns the device-resident COO buffers and dispatches the kernels of
Johnson's algorithm with the JAX package's gates, plans and route tags.
Every dispatch is a ``planner.select`` walk over a plan registry
(:data:`SSSP_PLANS`, :data:`FANOUT_PLANS`; the JAX package's names,
priorities and price routes): the plans' qualifications are the gates
below, each with its reason, and with a profile store configured the
walk is priced from its records (``observe.store.CostModel``). Unpriced,
the walk is the declared priority order. The decision rides on
``KernelResult.plan``.

  - ``bellman_ford`` (B=1: phase 1's virtual-source pass and ``sssp``):
    ``dia`` (``dia=True`` on a diagonal labeling, ``ops.dia``),
    ``bucket`` (``bucket=True``, ``ops.bucket``; ``bucket+sweep`` when
    its step budget runs out), ``gs`` (``gauss_seidel=True``,
    ``ops.gauss_seidel``; ``gs+dw`` when the dirty window engages),
    ``frontier`` (the low-degree family: V >= 512 and max out-degree in
    1..32, or ``frontier=True``; ``relax.bellman_ford_frontier``), else
    ``sweep`` (``relax.bellman_ford_sweeps``). All plain PyTorch: the
    reference's are XLA code, not Pallas kernels. The auto gates of
    ``dia``, ``gs`` and ``bucket`` are TPU-only in the reference, and the
    port's CUDA gates keep them off; ``True`` forces them;
  - ``multi_source``: ``dia`` and ``gs`` when forced (as above); blocked
    Floyd-Warshall ``fw`` / ``fw-tile`` (``_use_fw``: the squaring regime
    2B >= V of a dense graph within ``fw_threshold`` where the exact MAC
    counts beat squaring, on every device as in the reference, or
    ``fw=True``; ``ops.fw``: the hand Kleene and min-plus kernels on the
    card); the dirty window ``vm-blocked+dw``
    (``relax.bellman_ford_sweeps_dw``: ``dirty_window=True``, or
    ``"auto"`` on the profile store's trajectory evidence, unless the
    store prices the route that would otherwise serve cheaper); dense
    graphs (``_use_dense``: V <= ``dense_threshold`` and E >=
    ``dense_min_density`` x V^2) to ``dense-{regime}-pallas`` through the
    hand min-plus kernel (the iterate regime through ``minplus_fixpoint``
    on the card), or to the plain product ``dense-{regime}`` under
    ``use_pallas=False``; the hand fan-out sweep ``pallas-vm`` (the port's
    CUDA gate: ``use_pallas`` True or ``"auto"``, vertex-major layout);
    under ``use_pallas=False`` the reference's XLA vertex-major routes in
    plain PyTorch, ``vm-blocked`` for V > ``VM_BLOCK`` and ``vm`` below;
    and ``fanout_layout="source_major"`` to ``sweep-sm``. On a mesh of
    more than one rank (``mesh_shape``, ``parallel.mesh``) the
    single-device plans decline: ``sharded-1d`` (rows sharded over the
    ranks, the hand sweep on each), ``sharded-2d`` (a 2-D ``mesh_shape``:
    edges sharded too), and the forced ``dia`` / ``gs`` as
    ``dia-sharded`` / ``gs-sharded``; B=1 takes ``edge-sharded``
    (``edge_shard=True``, or ``"auto"`` off the low-degree family);
  - ``bellman_ford_pred`` / ``multi_source_pred`` run the same dispatch,
    then one tight-edge pass over the converged distances (the hand
    ``tight_pred`` kernel on the card, ``ops.pred``): route ``<route>+pred``.
    A tree that fails its check (a zero-weight tight cycle) falls back,
    with a warning, to the argmin sweep ``pred-sweep``.

``batch_apsp`` (``solve_batch``) solves a batch of small graphs as one
graph, their disjoint union: phase 1 at B = 1, the reweight, and one
hand-sweep fan-out of ``v_max`` columns (route ``batch-vmapped``).

On a CUDA device the hand kernels are the main path; on the CPU their
plain PyTorch versions run (the wrappers choose by the tensors' device).

The per-iteration trajectory counters (``observe.convergence``) are
recorded under ``convergence=True``, or ``"auto"`` with a telemetry sink
or a profile store, on the routes the reference instruments: ``sweep``, ``sweep-sm``,
``vm``, ``vm-blocked``, ``vm-blocked+dw``, ``dia``, ``gs`` and
``bucket``. With a profile store each kernel call also carries its
analytic cost (``observe.costs``) on ``KernelResult.cost``.

``stage_rows_async`` starts a finished batch's device-to-host copy on a
side stream, so the pipelined fan-out overlaps it with the next batch.
"""

from __future__ import annotations

import dataclasses
import sys
import traceback
import warnings
from typing import NamedTuple

import numpy as np
import torch

from paralleljohnson_tpu_torch import observe, planner
from paralleljohnson_tpu_torch.backends.base import (
    Backend,
    KernelResult,
    register_backend,
)
from paralleljohnson_tpu_torch.graphs import CSRGraph
from paralleljohnson_tpu_torch.observe import convergence as conv
from paralleljohnson_tpu_torch.observe import costs
from paralleljohnson_tpu_torch.ops import relax
from paralleljohnson_tpu_torch.ops.bucket import (
    auto_capacity,
    auto_delta,
    bellman_ford_bucketed,
)
from paralleljohnson_tpu_torch.ops import fw as fw_ops
from paralleljohnson_tpu_torch.ops.dia import build_dia_layout, dia_sweep
from paralleljohnson_tpu_torch.ops.fanout_sweep import (
    WorkItems,
    build_in_edge_layout,
    fanout_fixpoint,
)
from paralleljohnson_tpu_torch.ops.minplus import (
    MAX_SPLITS,
    minplus_fixpoint,
    minplus_kernel,
)
from paralleljohnson_tpu_torch.ops.pred import certify_pred, tight_pred_pass
from paralleljohnson_tpu_torch.ops.gauss_seidel import (
    build_gs_layout,
    fanout_gs_body,
    sssp_gs_blocks,
)
from paralleljohnson_tpu_torch.parallel import mesh as mesh_ops
from paralleljohnson_tpu_torch.utils import resilience
from paralleljohnson_tpu_torch.utils.metrics import (
    warn_if_counter_wrapped,
    warn_if_traj_counter_wrapped,
)
from paralleljohnson_tpu_torch.utils.platform import enable_compilation_cache

# Distance blocks of [B, V] the source batch is budgeted for: the
# reference's six. The sweep's two alternating [V, B] buffers, the
# transposed [B, V] result and the un-reweight's two temporaries fit;
# the sweep's partial-minimum scratch (n_split rows) is budgeted on top.
# A predecessor solve carries three more (the int32 pred block and the
# extraction's two scan carries), and the pipelined fan-out one more
# [B, V] block (two with predecessors) per in-flight slot beyond the first.
BATCH_BLOCKS = 6
PRED_BATCH_BLOCKS = 9
# Memory budget of one fan-out call on the CPU (the reference's constant).
CPU_BUDGET_BYTES = 4 << 30
# Destination-block height of ``vm-blocked``; graphs with V above it take
# that route under use_pallas=False (the reference's constant).
VM_BLOCK = 1 << 16
# Edge count from which the vm-blocked layout is built on the device
# instead of in host numpy (the reference's constant).
VMB_DEVICE_BUILD_MIN_EDGES = 1 << 22
# [v_max, v_max] blocks per graph that batch_apsp budgets: the fixpoint's
# two alternating buffers, the transposed result and one un-reweight
# temporary.
BATCH_APSP_BLOCKS = 4


def _fw_apsp_kernel(sources, src, dst, w, *, num_nodes: int, tile: int,
                    dtype):
    """Blocked min-plus Floyd-Warshall APSP (``ops.fw``): the dense
    adjacency padded to a tile multiple, closed in place, then the rows
    of ``sources``. Returns (dist [B, V], negative_cycle host bool)."""
    a = relax.dense_adjacency(src, dst, w, num_nodes, dtype=dtype)
    closed, neg = fw_ops.fw_apsp_blocked(fw_ops.pad_dense(a, tile),
                                         tile=tile)
    return closed[sources, :num_nodes], neg


def _gs_examined_exact(iters_blk, real_edges_host: np.ndarray, b: int, *,
                       rounds: int, inner_cap: int) -> int:
    """Exact candidate relaxations of a GS solve, in Python ints: the sum
    over blocks of inner iterations x real edges, times the batch width,
    after the reference's wrap guard on its int32 per-block counter."""
    warn_if_counter_wrapped(rounds, inner_cap, where="gs")
    iters = np.asarray(iters_blk, np.int64)
    return int(np.dot(iters, real_edges_host.astype(np.int64))) * int(b)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request without a CUDA
    device raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


class StagedCopy(NamedTuple):
    """A device tensor's copy on its way to the host
    (:meth:`TorchBackend.stage_rows_async`)."""

    host: torch.Tensor        # page-locked, written by the side stream
    done: torch.cuda.Event    # recorded on the side stream after the copy

    def wait(self) -> np.ndarray:
        """The host rows, once the copy has landed (errors of the copy
        surface here)."""
        self.done.synchronize()
        return self.host.numpy()


@dataclasses.dataclass(frozen=True)
class TorchDeviceGraph:
    """Device-resident COO buffers (padded edges are (0, 0, +inf) no-ops)
    plus cached layouts.

    ``_struct_cache`` holds weight-independent structure (the in-edge CSC,
    its sort permutation, the sweep kernel's work items, the DIA and GS
    layouts' edge ids) and survives :meth:`TorchBackend.reweight`;
    ``_by_dst_cache`` holds what is gathered from the current weights and
    is dropped by it. ``host_graph`` is the uploaded host CSR (the
    caller's arrays, no copy): the DIA and GS layouts are built from its
    structure, whose weights go stale after a reweight.
    """

    src: torch.Tensor      # int32[E_pad]
    dst: torch.Tensor      # int32[E_pad]
    weights: torch.Tensor  # f32[E_pad]
    indptr: np.ndarray     # host int32[V+1]
    num_nodes: int
    num_real_edges: int
    host_graph: CSRGraph | None = dataclasses.field(
        default=None, compare=False, repr=False
    )
    _by_dst_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )
    _struct_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def device(self) -> torch.device:
        return self.weights.device

    def indptr_dev(self) -> torch.Tensor:
        """The CSR indptr on the device (int32[V+1]), cached."""
        cached = self._struct_cache.get("indptr")
        if cached is None:
            cached = torch.as_tensor(self.indptr, dtype=torch.int32).to(
                self.device)
            self._struct_cache["indptr"] = cached
        return cached

    @property
    def max_degree(self) -> int:
        """Max out-degree (host int, cached): the frontier and bucket
        kernels' out-edge tile width."""
        cached = self._struct_cache.get("max_deg")
        if cached is None:
            deg = np.diff(self.indptr)
            cached = int(deg.max()) if deg.size else 0
            self._struct_cache["max_deg"] = cached
        return cached

    def _gather_weights_with_holes(self, edge_ids) -> torch.Tensor:
        """The CURRENT weights at ``edge_ids`` (any shape), +inf at the
        negative ids (layout holes): how every weight-independent layout
        re-derives its weights after a reweight."""
        return torch.where(
            edge_ids >= 0, self.weights[edge_ids.clamp_min(0).long()],
            torch.full_like(self.weights[:1], float("inf")))

    def dia_layout(self, max_offsets: int) -> dict | None:
        """The DIA layout (``ops.dia.build_dia_layout``): offsets and
        per-slot edge ids cached across reweight, the [K, V] diagonal
        weights gathered from the current weights. None without a host
        CSR or when the labeling is not diagonal."""
        if self.host_graph is None:
            return None
        key = ("dia", max_offsets)
        struct = self._struct_cache.get(key)
        if struct == "none":
            return None
        if struct is None:
            g = self.host_graph
            host = build_dia_layout(g.indptr, g.indices, g.num_nodes,
                                    max_offsets=max_offsets)
            if host is None:
                self._struct_cache[key] = "none"
                return None
            struct = {
                "offsets": host["offsets"],
                "diag_edge": torch.as_tensor(host["diag_edge"]).to(
                    self.device),
                "num_entries": host["num_entries"],
            }
            self._struct_cache[key] = struct
        w_diag = self._by_dst_cache.get(key)
        if w_diag is None:
            w_diag = self._gather_weights_with_holes(struct["diag_edge"])
            self._by_dst_cache[key] = w_diag
        return {**struct, "w_diag": w_diag}

    def dw_layout(self, vb: int) -> dict:
        """The dirty-window layout (``relax.build_dw_layout``): the
        per-source-block out-edge tiles cached across reweight, their
        weights gathered from the current weights."""
        key = ("dw", vb)
        struct = self._struct_cache.get(key)
        if struct is None:
            indices = (self.host_graph.indices if self.host_graph is not None
                       else self.dst[:self.num_real_edges].cpu().numpy())
            host = relax.build_dw_layout(self.indptr, indices,
                                         self.num_nodes, vb=vb)
            dev = self.device
            struct = {
                **{k: torch.as_tensor(host[k]).to(dev)
                   for k in ("e_src", "e_dst", "edge_order", "blk_of_v")},
                **{k: host[k] for k in ("vb", "nb", "em")},
            }
            self._struct_cache[key] = struct
        w_tile = self._by_dst_cache.get(key)
        if w_tile is None:
            w_tile = self._gather_weights_with_holes(struct["edge_order"])
            self._by_dst_cache[key] = w_tile
        return {**struct, "w_tile": w_tile}

    def gs_layout(self, vb: int) -> dict | None:
        """The blocked Gauss-Seidel layout (``ops.gauss_seidel
        .build_gs_layout``: RCM relabeling and destination-block edge
        buckets), structure cached across reweight, the block weights
        gathered from the current weights. None without a host CSR."""
        if self.host_graph is None:
            return None
        key = ("gs", vb)
        struct = self._struct_cache.get(key)
        if struct is None:
            g = self.host_graph
            host = build_gs_layout(g.indptr, g.indices, None, g.num_nodes,
                                   vb=vb)
            dev = self.device
            struct = {
                "rank_host": host["rank"],
                "rank": torch.as_tensor(host["rank"]).to(dev),
                "src_blk": torch.as_tensor(host["src_blk"]).to(dev),
                "dstl_blk": torch.as_tensor(host["dstl_blk"]).to(dev),
                "edge_order": torch.as_tensor(host["edge_order"]).to(dev),
                # Host int64 per-block real-edge counts, for the exact
                # work accounting.
                "real_edges_host": host["real_edges_blk"],
                "vb": host["vb"],
                "v_pad": host["v_pad"],
                "halo": host["halo"],
                "in_adj": host["in_adj"],
            }
            self._struct_cache[key] = struct
        w_blk = self._by_dst_cache.get(key)
        if w_blk is None:
            w_blk = self._gather_weights_with_holes(struct["edge_order"])
            self._by_dst_cache[key] = w_blk
        return {**struct, "w_blk": w_blk}

    def _in_edges(self) -> dict:
        struct = self._struct_cache.get("in_edges")
        if struct is None:
            e = self.num_real_edges
            struct = build_in_edge_layout(
                self.src[:e], self.dst[:e], self.num_nodes
            )
            self._struct_cache["in_edges"] = struct
        return struct

    def _by_dst(self, struct: dict):
        e = self.num_real_edges
        w_in = self._by_dst_cache.get("w_in")
        if w_in is None:
            w_in = self.weights[:e][struct["order"]].contiguous()
            self._by_dst_cache["w_in"] = w_in
        return struct["indptr_in"], struct["src_in"], w_in

    def by_dst(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The real edges sorted by destination (stable), as the in-edge
        CSC the fan-out sweep pulls over: (indptr_in int32[V+1], src_in
        int32[E], w_in f32[E]), with ``w_in`` gathered from the CURRENT
        weights."""
        return self._by_dst(self._in_edges())

    def work_items(self) -> WorkItems:
        """The sweep kernel's work items over the in-edge CSC."""
        return self._in_edges()["work_items"]

    def fanout_layout(self):
        """``(by_dst(), work_items())`` from ONE read of the structure
        cache. The pipelined fan-out's worker thread may clear the caches
        while a batch starts; a sweep then still pairs its CSC with the
        work items of the same build."""
        struct = self._in_edges()
        return self._by_dst(struct), struct["work_items"]

    def vm_edges(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The padded COO sorted by destination (stable), the reference's
        ``by_dst()``: (src, dst, w) for route ``vm``. The padding stays in
        so the edge chunks, and so the sweep counts, match the
        reference's."""
        order = self._struct_cache.get("vm_order")
        if order is None:
            order = torch.argsort(self.dst, stable=True)
            self._struct_cache["vm_order"] = order
        cached = self._by_dst_cache.get("vm")
        if cached is None:
            cached = (self.src[order], self.dst[order], self.weights[order])
            self._by_dst_cache["vm"] = cached
        return cached

    def vm_blocked_layout(self, vb: int, ec: int) -> dict:
        """The ``vm-blocked`` layout (``relax.build_vm_blocked_layout``, or
        its device builder from ``VMB_DEVICE_BUILD_MIN_EDGES`` edges): the
        weight-independent chunk structure is cached across reweighting,
        the chunk weights ``w_ck`` are gathered from the current weights.
        ``base_ck`` stays a host array (the sweep's loop reads it)."""
        key = ("vmb", vb, ec)
        e = self.num_real_edges
        struct = self._struct_cache.get(key)
        if struct is None:
            v_pad = vb * max(1, -(-self.num_nodes // vb))
            if e >= VMB_DEVICE_BUILD_MIN_EDGES:
                counts = torch.bincount(
                    self.dst[:e].long() // vb, minlength=v_pad // vb
                ).cpu().numpy()
                lay = relax.build_vm_blocked_layout_device(
                    self.src[:e], self.dst[:e], self.weights[:e], counts,
                    vb=vb, ec=ec)
                self._by_dst_cache[key] = lay.pop("w_ck")
            else:
                lay = relax.build_vm_blocked_layout(
                    self.indptr, self.dst[:e].cpu().numpy(), self.num_nodes,
                    vb=vb, ec=ec)
                for name in ("src_ck", "dstl_ck", "edge_order"):
                    lay[name] = torch.as_tensor(lay[name]).to(self.device)
            struct = {**lay, "v_pad": v_pad}
            self._struct_cache[key] = struct
        w_ck = self._by_dst_cache.get(key)
        if w_ck is None:
            if "order" in struct:
                w_ck = relax.regather_vm_blocked_weights(
                    self.weights, struct["order"], struct["slots"],
                    struct["src_ck"].numel(), tuple(struct["src_ck"].shape))
            else:
                w_ck = self._gather_weights_with_holes(struct["edge_order"])
            self._by_dst_cache[key] = w_ck
        return {**struct, "w_ck": w_ck}


class TorchBackend(Backend):
    """PyTorch backend: hand CUDA kernels on the card, plain PyTorch on
    the CPU."""

    name = "torch"

    def __init__(self, config=None, device="cuda") -> None:
        super().__init__(config)
        self.device = resolve_device(device)
        # The hand kernels' build directory (compilation_cache_dir /
        # $PJ_COMPILE_CACHE), fixed before the first library loads.
        enable_compilation_cache(self.config.compilation_cache_dir)
        self._copy_stream = None  # side stream of stage_rows_async
        # Analytic cost records, only when a profile store is configured
        # (``SolverConfig.profile_store`` / ``PJ_PROFILE_DIR``).
        self.cost_capture = observe.CostCapture(
            enabled=observe.resolve_profile_dir(self.config.profile_store)
            is not None,
            platform=observe.current_platform(self.device))

    @property
    def _dtype(self) -> torch.dtype:
        return torch.float64 if self.config.precision == "f64" else torch.float32

    def upload(self, graph: CSRGraph) -> TorchDeviceGraph:
        g = graph.pad_edges(self.config.edge_pad_multiple)
        dev = self.device
        return TorchDeviceGraph(
            src=torch.as_tensor(g.src, dtype=torch.int32).to(dev),
            dst=torch.as_tensor(g.indices, dtype=torch.int32).to(dev),
            weights=torch.as_tensor(
                g.weights.astype(self.config.np_dtype)
            ).to(dev),
            indptr=graph.indptr,
            num_nodes=graph.num_nodes,
            num_real_edges=graph.num_real_edges,
            host_graph=graph,
        )

    def download_graph(self, dgraph: TorchDeviceGraph) -> CSRGraph:
        e = dgraph.num_real_edges
        g = CSRGraph(
            indptr=dgraph.indptr,
            indices=dgraph.dst[:e].cpu().numpy(),
            weights=dgraph.weights[:e].cpu().numpy(),
        )
        g.__dict__["_src"] = dgraph.src[:e].cpu().numpy()
        return g

    def clear_caches(self, dgraph: TorchDeviceGraph) -> None:
        """Drop every rebuildable layout held by ``dgraph``; the next
        kernel call rebuilds on demand."""
        dgraph._struct_cache.clear()
        dgraph._by_dst_cache.clear()

    def _pipeline_depth(self, dgraph: TorchDeviceGraph) -> int:
        """The fan-out's in-flight window: ``config.pipeline_depth``, else
        the profile-tuned depth for this (platform, shape bucket), else
        ``DEFAULT_PIPELINE_DEPTH`` (``observe.tuning.resolve_param``). The
        solver resolves this same function for its window, so the window
        and the memory budget agree."""
        value, _ = observe.resolve_param(
            "pipeline_depth", self.config.pipeline_depth,
            observe.DEFAULT_PIPELINE_DEPTH, config=self.config,
            platform=self._platform, num_nodes=dgraph.num_nodes,
            num_edges=dgraph.num_real_edges,
            validate=lambda d: isinstance(d, int) and d >= 1)
        return max(1, int(value))

    def suggested_source_batch(self, dgraph: TorchDeviceGraph,
                               with_pred: bool = False) -> int:
        """Cap the [B, V] distance block to the memory budget: half the
        card's free memory (``torch.cuda.mem_get_info``, which counts the
        caching allocator's cached blocks as used), or a 4 GB constant on
        the CPU, over ``BATCH_BLOCKS`` blocks (``PRED_BATCH_BLOCKS`` with
        predecessors) plus the pipeline's carry slots and, on the card,
        the sweep's scratch rows (sparse route; tight_pred's partial keys
        with predecessors) or the min-plus split-K partials (dense
        route).

        On a mesh the budget is a device's, divided among the ranks that
        share it (each holds its [B / n_sources, V] blocks; on a 2-D mesh
        every "edges" rank of a source group holds its group's rows), and
        the batch is that per-rank width times the "sources" ranks, kept a
        multiple of them."""
        v = max(dgraph.num_nodes, 1)
        itemsize = torch.empty((), dtype=self._dtype).element_size()
        blocks = PRED_BATCH_BLOCKS if with_pred else BATCH_BLOCKS
        carry_slots = self._pipeline_depth(dgraph) - 1
        blocks += carry_slots * (2 if with_pred else 1)
        rows = blocks * v
        mesh = self._mesh()
        if self.device.type == "cuda":
            free = min(torch.cuda.mem_get_info(d)[0]
                       for d in set(mesh.devices) | {self.device})
            budget = free // 2
            if self._use_dense(dgraph):
                rows += MAX_SPLITS * v  # the min-plus split-K partials
            else:
                # The sweep's f32 partial minima; with predecessors,
                # tight_pred's int64 partial keys after them (two rows).
                rows += dgraph.work_items().n_split * (2 if with_pred else 1)
        else:
            budget = CPU_BUDGET_BYTES
        sharing = max(mesh.devices.count(d) for d in set(mesh.devices))
        n = self._sources_axis_size()
        b = budget // sharing // (rows * itemsize) * n
        b = int(max(1, min(b, 1 << 16)))
        if b > n:
            b -= b % n  # keep shards even on the mesh
        return b

    def stage_rows_async(self, *tensors) -> None:
        """Start the device-to-host copy of each CUDA tensor of
        ``tensors`` without blocking: an event recorded on the current
        (compute) stream, a side stream that waits on it, and there a
        ``non_blocking`` copy into fresh page-locked host memory.
        ``record_stream`` keeps the caching allocator from handing the
        tensor's block to later work before the copy has read it. The
        copy rides on the tensor as ``staged_copy`` (a
        :class:`StagedCopy`); ``solver.johnson.to_numpy`` collects it.
        ``None``, CPU tensors and tensors already staged are skipped."""
        todo = [t for t in tensors
                if isinstance(t, torch.Tensor) and t.is_cuda
                and getattr(t, "staged_copy", None) is None]
        if not todo:
            return
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        side = self._copy_stream
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        side.wait_event(ready)
        with torch.cuda.stream(side):
            for t in todo:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                t.record_stream(side)
                done = torch.cuda.Event(blocking=True)
                done.record(side)
                t.staged_copy = StagedCopy(host, done)

    # -- observability: cost records and the trajectory ----------------------

    @property
    def _platform(self) -> str:
        return observe.current_platform(self.device)

    def _observe_analytic(self, route: str, cost: dict, dgraph, batch=1):
        """The analytic cost record of one kernel call (``observe.costs``),
        or None when no profile store is configured."""
        return self.cost_capture.analytic(
            route, cost, num_nodes=dgraph.num_nodes,
            num_edges=dgraph.num_real_edges, batch=batch)

    def _observe_unavailable(self, route: str, dgraph, batch=1, *,
                             reason: str | None = None):
        """The explicit marker of a route with no analytic model."""
        return self.cost_capture.unavailable(
            route, reason or f"no analytic cost model for route {route!r}",
            num_nodes=dgraph.num_nodes, num_edges=dgraph.num_real_edges,
            batch=batch)

    def _observe_sweeps(self, res: KernelResult, dgraph, batch=1):
        """``res.cost`` of a sweep route: ``res.iterations`` full sweeps
        of a [V, B] block over the real edges."""
        res.cost = self._observe_analytic(
            res.route, costs.sweep_cost(
                dgraph.num_nodes, dgraph.num_real_edges, batch,
                res.iterations, self._itemsize), dgraph, batch)
        return res

    @property
    def _itemsize(self) -> int:
        return torch.empty((), dtype=self._dtype).element_size()

    def _traj_cap(self) -> int | None:
        """Trajectory buffer rows for this solve, or None when nothing is
        recorded: ``convergence=True`` records, ``False`` never does, and
        ``"auto"`` records when something consumes the trajectory: a
        telemetry sink or a profile store."""
        flag = self.config.convergence
        if flag is False:
            return None
        if flag is not True and not (self.config.telemetry is not None
                                     or self.cost_capture.enabled):
            return None
        return conv.DEFAULT_TRAJ_CAP

    def _attach_trajectory(self, res: KernelResult, counts, resid,
                           dgraph: TorchDeviceGraph, batch: int = 1,
                           iterations: int | None = None) -> KernelResult:
        """Decode one kernel call's trajectory buffers onto ``res`` (their
        one device-to-host copy) and summarize them, after the int32
        addend wrap guard. Never fatal: a decode failure drops the
        trajectory, not the solve."""
        try:
            warn_if_traj_counter_wrapped(batch, dgraph.num_nodes,
                                         where=res.route or "trajectory")
            iters = res.iterations if iterations is None else iterations
            traj = conv.decode_trajectory(counts, resid, iters)
            res.trajectory = traj
            # Size-biased mean degree, cached per structure.
            bias = dgraph._struct_cache.get("degree_bias", "unset")
            if bias == "unset":
                bias = conv.degree_bias_from_degrees(np.diff(dgraph.indptr))
                dgraph._struct_cache["degree_bias"] = bias
            res.convergence = conv.summarize_trajectory(
                traj, num_nodes=dgraph.num_nodes, batch=batch,
                num_edges=dgraph.num_real_edges, iterations=iters,
                degree_bias=bias)
        except Exception as e:  # noqa: BLE001 — observability is never fatal
            warnings.warn(f"convergence trajectory dropped: "
                          f"{type(e).__name__}: {e}", RuntimeWarning,
                          stacklevel=2)
        return res

    def _fixpoint(self, sweep, dist0, max_iter: int, batch_axis):
        """``relax._sweeps_to_fixpoint`` of ``sweep``, or its recording
        twin when the trajectory is on (:meth:`_traj_cap`): (dist,
        iterations, improving, trajectory buffers or None)."""
        cap = self._traj_cap()
        if cap is None:
            return (*relax._sweeps_to_fixpoint(sweep, dist0, max_iter), None)
        d, i, improving, counts, resid = conv.instrumented_fixpoint(
            sweep, dist0, max_iter=max_iter, cap=cap, batch_axis=batch_axis)
        return d, i, improving, (counts, resid)

    # -- the planner: priced walks over the plan registries -----------------

    def _auto_route_failed(self, flag_attr: str, message: str, *,
                           forced: bool) -> None:
        """An auto-selected route raised (call from the active ``except``
        block): a forced route propagates; otherwise warn once, set
        ``flag_attr`` on this backend instance so the route is not
        retried, and let the walk fall through to the next plan."""
        if forced:
            raise
        if not getattr(self, flag_attr, False):
            setattr(self, flag_attr, True)
            warnings.warn(message, RuntimeWarning, stacklevel=3)
            traceback.print_exc(file=sys.stderr)

    def _planner_model(self):
        """The fitted ``CostModel`` the walks are priced with, or None (the
        declared priority order): on when ``config.planner`` is not False
        and the profile store holds records; the fit is cached against the
        store file's identity (``observe.tuning.cached_records``), so a
        multi-batch fan-out reads the store at most once per solve."""
        if self.config.planner is False:
            return None
        store_dir = observe.resolve_profile_dir(self.config.profile_store)
        if store_dir is None:
            return None
        records = observe.cached_records(store_dir)
        if not records:
            return None
        cached = getattr(self, "_planner_model_cache", None)
        if cached is not None and cached[0] is records:
            return cached[1]
        model = observe.CostModel.fit(records)
        self._planner_model_cache = (records, model)
        return model

    def _walk(self, plans, ctx, *, batch: int, what: str) -> KernelResult:
        """``planner.select`` over ``plans``, then the ranking built in
        order: an auto plan that raises runs its failure policy (warn
        once, disable, fall through), a forced one propagates, and a build
        that returns None (a layout that does not apply) hands over to the
        next plan. The decision rides on ``KernelResult.plan``."""
        decision = planner.select(
            plans, ctx, model=self._planner_model(), platform=self._platform,
            num_edges=ctx.dgraph.num_real_edges, batch=batch,
            config=self.config)
        self.last_plan_decision = decision
        for cand in decision.ranking:
            try:
                res = cand.plan.build(ctx)
            except Exception:
                if cand.plan.failure is None:
                    raise
                # From this active except block, so a forced plan's bare
                # ``raise`` propagates the original error.
                cand.plan.failure(self, ctx)
                continue
            if res is None:
                continue
            decision.params.update(ctx.params)
            res.plan = decision.as_dict(built=cand.plan.name)
            return res
        raise RuntimeError(f"planner: every qualified {what} plan failed "
                           "(the registry ends in an unconditional plan)")

    def plan_preview(self, dgraph: TorchDeviceGraph, batch: int) -> dict:
        """The fan-out decision at ``batch`` columns without building
        anything: the chosen plan, its reason and the candidates, each
        with its qualification reason and price (or ``unpriced``)."""
        b = max(1, int(batch))
        ctx = _FanoutCtx(backend=self, dgraph=dgraph,
                         sources=torch.zeros(b, dtype=torch.int64),
                         batch=b, max_iter=self.config.max_iterations
                         or dgraph.num_nodes, mesh=self._mesh(),
                         layout=self._resolve_layout())
        decision = planner.select(
            FANOUT_PLANS, ctx, model=self._planner_model(),
            platform=self._platform, num_edges=dgraph.num_real_edges,
            batch=b, config=self.config)
        decision.params.setdefault("fw_tile", self._fw_tile(dgraph)[0])
        return decision.as_dict()

    def _resolve_layout(self) -> str:
        """``fanout_layout`` with ``"auto"`` read as ``"vertex_major"``."""
        layout = self.config.fanout_layout
        return "vertex_major" if layout == "auto" else layout

    # -- the mesh (parallel.mesh) --------------------------------------------

    def _mesh(self):
        """The fan-out mesh over this backend's device type:
        ``mesh_shape=(n,)`` or None a 1-D "sources" mesh (None: one rank
        unless ``PJ_MESH_DEVICES`` lists more,
        ``parallel.mesh.default_devices``), ``(n_s, n_e)`` the 2-D
        ("sources", "edges") mesh. After a sharded failure on CPU ranks
        (:meth:`_sharded_fallback`) it is one rank."""
        cached = getattr(self, "_mesh_cache", None)
        if cached is None:
            if getattr(self, "_sharded_disabled", False):
                cached = mesh_ops.make_mesh((1,), device=self.device)
            else:
                shape = self.config.mesh_shape
                if shape is not None and len(shape) == 2:
                    cached = mesh_ops.make_mesh_2d(shape, device=self.device)
                else:
                    cached = mesh_ops.make_mesh(shape, device=self.device)
            self._mesh_cache = cached
        return cached

    def close(self) -> None:
        """Shut the cached meshes' process groups down (a later sharded
        solve builds fresh ones)."""
        for attr in ("_mesh_cache", "_edge_mesh_cache"):
            mesh = getattr(self, attr, None)
            if mesh is not None:
                mesh.close()

    def _edge_mesh(self):
        """The "edges" mesh over the fan-out mesh's ranks, for
        edge-sharded B=1 Bellman-Ford."""
        cached = getattr(self, "_edge_mesh_cache", None)
        if cached is None:
            cached = mesh_ops.make_edge_mesh(self.config.mesh_shape,
                                             device=self.device)
            self._edge_mesh_cache = cached
        return cached

    def _sources_axis_size(self) -> int:
        """Ranks along the "sources" axis (the axis [B, V] row blocks
        shard over; on a 2-D mesh rows replicate over "edges")."""
        mesh = self._mesh()
        return int(mesh.shape.get("sources", mesh.size))

    def _use_edge_shard(self, dgraph: TorchDeviceGraph) -> bool:
        """Edge sharding is the only way a multi-rank mesh helps a B=1
        solve: ``edge_shard=True`` forces it on such a mesh; ``"auto"``
        defers to the frontier, GS, DIA and bucket routes where they
        apply, as in the reference."""
        flag = self.config.edge_shard
        if flag is False or self._mesh().size <= 1:
            return False
        if getattr(self, "_edge_shard_disabled", False):
            return False
        if flag is True:
            return True
        return not (self._use_frontier(dgraph) or self._use_gs(dgraph)
                    or self._use_dia(dgraph) or self._use_bucket(dgraph))

    @property
    def _telemetry(self):
        """The solve's telemetry (or None), handed to the sharded entry
        points so each lands as a span on the flight record."""
        return self.config.telemetry

    def _shard_fault_hook(self):
        """The fault-injection hook of the sharded entry points
        (``config.fault_plan`` stage ``"sharded_fanout"``): fires inside
        the sharded path, so an injected failure surfaces where a real
        collective failure would. None without a plan."""
        plan = self.config.fault_plan
        if plan is None:
            return None

        def hook():
            active = plan.fire("sharded_fanout")
            if active is not None:
                active.wrap(lambda: None)()

        return hook

    def _sharded_fallback(self, exc: BaseException, dgraph, sources, *,
                          pred_sweep: bool = False) -> KernelResult:
        """A sharded fan-out raised. An OOM re-raises for the solver's
        batch degrader (which keeps the mesh); so does any failure on a
        CUDA mesh (a card's failure is not a lost host to route around).
        On CPU ranks, as the reference does: warn once, pin this backend
        instance to one rank, and solve the same batch on the single-device
        routes, tagged ``+1dev-fallback``."""
        if resilience.is_oom_error(exc) or self.device.type == "cuda":
            raise exc
        self._auto_route_failed(
            "_sharded_disabled",
            "sharded fan-out failed (collective failure); falling back to "
            "single-device solves for this backend instance",
            forced=False)
        self.close()
        self._mesh_cache = None  # _mesh() rebuilds as a one-rank mesh
        if pred_sweep:
            res = self._multi_source_pred_sweep(dgraph, sources)
        else:
            res = self.multi_source(dgraph, sources)
        res.route = f"{res.route or 'sweep'}+1dev-fallback"
        return res

    def _sharded_cost(self, route: str, dgraph, batch: int):
        return self._observe_unavailable(
            route, dgraph, batch,
            reason="sharded collective executables are not cost-instrumented")

    # -- B=1 route gates (the reference's, in its plan order) ----------------

    @staticmethod
    def _low_degree_family(dgraph: TorchDeviceGraph) -> bool:
        """The road/grid family the frontier and Gauss-Seidel routes
        target: V >= 512 and max out-degree in 1..32 (a hub would pad
        every gather tile to its degree)."""
        return dgraph.num_nodes >= 512 and 0 < dgraph.max_degree <= 32

    def _use_frontier(self, dgraph: TorchDeviceGraph) -> bool:
        """The reference's gate on every device: ``frontier=True`` /
        ``False`` force; ``"auto"`` takes the low-degree family, except
        where E reaches the examined counter's addend bound."""
        flag = self.config.frontier
        if flag != "auto":
            return bool(flag)
        if dgraph.num_real_edges >= relax.FRONTIER_ADDEND_MAX:
            return False
        return self._low_degree_family(dgraph)

    def _frontier_capacity(self, dgraph: TorchDeviceGraph) -> int:
        """The frontier id buffer: ``frontier_capacity``, else V/8 floored
        at 1024 and capped at V (the reference's rule: road and grid
        frontiers rarely overflow it)."""
        if self.config.frontier_capacity is not None:
            return int(self.config.frontier_capacity)
        v = dgraph.num_nodes
        return int(min(v, max(1024, v // 8)))

    # The reference's "auto" gates of gs, dia and bucket engage only on a
    # TPU. The port's CUDA gates keep them off (on an NVIDIA H100 80GB
    # HBM3 at 700 W each lost to the default route, PERF.md §6), so
    # "auto" declines and True forces. (So the reference's
    # _qual_sssp_bucket, which keeps an auto bucket off the
    # virtual-source pass, has nothing left to decide.)

    def _use_gs(self, dgraph: TorchDeviceGraph) -> bool:
        return (self.config.gauss_seidel is True
                and dgraph.host_graph is not None)

    def _use_dia(self, dgraph: TorchDeviceGraph) -> bool:
        """``dia=True`` on a labeling the DIA layout accepts; a labeling it
        rejects falls through to the next route, as in the reference."""
        return self.config.dia is True and self.dia_bundle(dgraph) is not None

    def dia_bundle(self, dgraph: TorchDeviceGraph) -> dict | None:
        return dgraph.dia_layout(self.config.dia_max_offsets)

    def _use_bucket(self, dgraph: TorchDeviceGraph) -> bool:
        return self.config.bucket is True

    def _bucket_delta(self, dgraph: TorchDeviceGraph) -> float:
        """The bucket width: ``SolverConfig.delta``, else the profile-tuned
        width for this (platform, shape bucket), else ``auto_delta`` from
        the mean |weight| of the CURRENT weights (two reductions); cached
        until the next reweight."""
        if self.config.delta is not None:
            return float(self.config.delta)
        cached = dgraph._by_dst_cache.get("bucket_delta")
        if cached is None:
            tuned, source = observe.resolve_param(
                "delta", None, None, config=self.config,
                platform=self._platform, num_nodes=dgraph.num_nodes,
                num_edges=dgraph.num_real_edges,
                validate=lambda d: isinstance(d, (int, float)) and d > 0)
            if source == "profile-tuned":
                cached = float(tuned)
            else:
                w = dgraph.weights
                finite = torch.isfinite(w)
                mean_w = float(
                    torch.where(finite, w.abs(), torch.zeros_like(w)).sum()
                    / finite.sum().clamp_min(1))
                cached = auto_delta(mean_w, dgraph.num_nodes,
                                    dgraph.num_real_edges)
            dgraph._by_dst_cache["bucket_delta"] = cached
        return cached

    # -- the dirty window ----------------------------------------------------

    def _use_dw(self, dgraph: TorchDeviceGraph, batch: int) -> bool:
        """The dirty-window route (``vm-blocked+dw``, and ``gs+dw`` inside
        a Gauss-Seidel solve): True forces, False disables; ``"auto"``
        engages only on the profile store's evidence
        (:meth:`_dw_decision`), never blindly."""
        flag = self.config.dirty_window
        if flag is False or getattr(self, "_dw_disabled", False):
            return False
        if dgraph.num_nodes == 0:
            return False
        if flag is True:
            return True
        if dgraph.num_real_edges >= relax.FRONTIER_ADDEND_MAX:
            return False  # the examined counter's full-sweep addend
        return bool(self._dw_decision(dgraph, batch).get("engage"))

    def _dw_decision(self, dgraph: TorchDeviceGraph, batch: int) -> dict:
        """The evidence decision for this graph, cached per device graph
        and power-of-two batch: ``observe.convergence.dw_decision`` over
        the store's ``kind: "trajectory"`` records of this shape bucket,
        then a priced veto when the store's ``CostModel`` prices both
        ``vm-blocked+dw`` and the route that would otherwise serve.

        The reference compares with ``("vm-blocked", "vm", "sweep-sm")``.
        Here the route that would otherwise serve is the hand sweep
        ``pallas-vm`` whenever ``use_pallas`` allows it, so the list
        starts with it: a store that shows a collapsing frontier does not
        move the card off its hand kernel onto a plain-torch sweep unless
        the dirty window is priced cheaper than that kernel."""
        key = ("dw_decision", max(1, int(batch) - 1).bit_length())
        cached = dgraph._by_dst_cache.get(key)
        if cached is not None:
            return cached
        store_dir = observe.resolve_profile_dir(self.config.profile_store)
        if store_dir is None:
            decision = {
                "engage": False,
                "reason": "no profile store configured (auto engages "
                          "only from recorded trajectory evidence)",
            }
        else:
            try:
                records = observe.ProfileStore(store_dir).records()
                decision = conv.dw_decision(
                    records, num_nodes=dgraph.num_nodes,
                    num_edges=dgraph.num_real_edges,
                    platform=self._platform)
                if decision.get("engage"):
                    decision = self._dw_priced_veto(decision, records,
                                                    dgraph, batch)
            except (OSError, ValueError) as e:
                decision = {
                    "engage": False,
                    "reason": f"profile store unreadable: "
                              f"{type(e).__name__}: {e}",
                }
        dgraph._by_dst_cache[key] = decision
        return decision

    def _dw_priced_veto(self, decision: dict, records, dgraph, batch) -> dict:
        """Keep ``decision`` unless the cost model prices both the dirty
        window and the plain route and the dirty window is dearer (an
        unpriced route reads as unpriced, never as free or infinite)."""
        model = observe.CostModel.fit(records)
        price = lambda route: model.predict(  # noqa: E731
            route, num_edges=dgraph.num_real_edges, batch=batch,
            platform=self._platform)
        dw = price("vm-blocked+dw")
        plain_routes = ("vm-blocked", "vm", "sweep-sm")
        if self.config.use_pallas is not False:
            plain_routes = ("pallas-vm",) + plain_routes
        plain = next((p for p in map(price, plain_routes) if p is not None),
                     None)
        if dw is not None and plain is not None and (
                dw["predicted_s"] > plain["predicted_s"]):
            return {
                "engage": False,
                "reason": (f"cost model prices dw at {dw['predicted_s']:.4g}s"
                           f" vs {plain['route']} "
                           f"{plain['predicted_s']:.4g}s"),
                "summary": decision.get("summary"),
            }
        return decision

    def _dw_capacity(self, nb: int, em: int, batch: int) -> int:
        """The dirty buffer: ``frontier_capacity``, else nb/4 floored at
        1024 (the reference's measured choice), clamped by
        ``relax.dw_capacity_clamp``."""
        if self.config.frontier_capacity is not None:
            cap = int(self.config.frontier_capacity)
        else:
            cap = max(1024, nb // 4)
        return relax.dw_capacity_clamp(cap, nb, em, batch)

    # -- B=1 Bellman-Ford ----------------------------------------------------

    def bellman_ford(self, dgraph: TorchDeviceGraph,
                     source: int | None) -> KernelResult:
        """B=1 Bellman-Ford; ``source=None`` is the virtual-source pass
        (dist0 = 0 everywhere). A ``planner.select`` walk over
        :data:`SSSP_PLANS` (see the module docstring)."""
        v = dgraph.num_nodes
        if source is None:
            dist0 = torch.zeros(v, dtype=self._dtype, device=self.device)
        else:
            dist0 = torch.full((v,), float("inf"), dtype=self._dtype,
                               device=self.device)
            dist0[source] = 0.0
        ctx = _SsspCtx(backend=self, dgraph=dgraph, source=source,
                       dist0=dist0,
                       max_iter=self.config.max_iterations or v,
                       chunk=relax.edge_chunk_for(1, dgraph.src.shape[0]))
        return self._walk(SSSP_PLANS, ctx, batch=1, what="B=1")

    def _sssp_build_edge_sharded(self, ctx) -> KernelResult:
        """B=1 Bellman-Ford with the edge list sharded over the ranks
        (``parallel.mesh.edge_sharded_bellman_ford``): one MIN all-reduce
        of the [V] distances per sweep."""
        dgraph, max_iter = ctx.dgraph, ctx.max_iter
        emesh = self._edge_mesh()
        dist, iters, improving = mesh_ops.edge_sharded_bellman_ford(
            emesh, ctx.dist0, dgraph.src, dgraph.dst, dgraph.weights,
            max_iter=max_iter,
            edge_chunk=relax.edge_chunk_for(
                1, -(-dgraph.src.shape[0] // emesh.size)),
            fault_hook=self._shard_fault_hook(), telemetry=self._telemetry)
        return KernelResult(
            dist=dist,
            negative_cycle=improving and max_iter >= dgraph.num_nodes,
            converged=not improving,
            iterations=iters,
            # Each round relaxes the full edge list (across the ranks).
            edges_relaxed=iters * dgraph.num_real_edges,
            route="edge-sharded",
            cost=self._sharded_cost("edge-sharded", dgraph, 1),
        )

    def _sssp_build_dia(self, ctx) -> KernelResult:
        dgraph, max_iter = ctx.dgraph, ctx.max_iter
        lay = self.dia_bundle(dgraph)
        dist, iters, improving, traj = self._fixpoint(
            lambda d: dia_sweep(d, lay["w_diag"], offsets=lay["offsets"]),
            ctx.dist0, max_iter, None)
        res = KernelResult(
            dist=dist,
            negative_cycle=improving and max_iter >= dgraph.num_nodes,
            converged=not improving,
            iterations=iters,
            # Each chained sweep examines every stored diagonal entry
            # once (= E: the layout stores every real edge).
            edges_relaxed=iters * lay["num_entries"],
            route="dia",
        )
        self._observe_sweeps(res, dgraph)
        if traj is not None:
            self._attach_trajectory(res, *traj, dgraph)
        return res

    def _sssp_build_bucket(self, ctx) -> KernelResult:
        dgraph, max_iter = ctx.dgraph, ctx.max_iter
        v = dgraph.num_nodes
        # A generous step budget: converging solves take ~hop-diameter
        # steps; exhausting it hands the distances to the full sweep,
        # which finishes and certifies negative cycles.
        dist, steps, busy, examined, *traj = bellman_ford_bucketed(
            ctx.dist0, dgraph.src, dgraph.dst, dgraph.weights,
            dgraph.indptr_dev(), self._bucket_delta(dgraph),
            max_steps=2 * max_iter + 64,
            capacity=auto_capacity(v, dgraph.max_degree),
            max_degree=dgraph.max_degree,
            num_real_edges=dgraph.num_real_edges, edge_chunk=ctx.chunk,
            traj_cap=self._traj_cap(),
        )
        examined = relax.examined_exact(examined)
        if not busy:
            # Empty masks certify the global fixpoint: no reachable
            # negative cycle.
            res = KernelResult(dist=dist, negative_cycle=False,
                               converged=True, iterations=steps,
                               edges_relaxed=examined, route="bucket")
        else:
            dist, it2, improving = relax.bellman_ford_sweeps(
                dist, dgraph.src, dgraph.dst, dgraph.weights,
                max_iter=max_iter, edge_chunk=ctx.chunk)
            res = KernelResult(
                dist=dist,
                negative_cycle=improving and max_iter >= v,
                converged=not improving,
                iterations=steps + it2,
                edges_relaxed=examined + it2 * dgraph.num_real_edges,
                route="bucket+sweep",
            )
        res.cost = self._observe_unavailable(res.route, dgraph)
        if traj:
            # The trajectory covers the bucket steps only.
            self._attach_trajectory(res, *traj, dgraph, iterations=steps)
        return res

    def _sssp_build_gs(self, ctx) -> KernelResult:
        dgraph, max_iter, source = ctx.dgraph, ctx.max_iter, ctx.source
        v = dgraph.num_nodes
        lay = dgraph.gs_layout(self.config.gs_block_size)
        dist0_gs = torch.full((lay["v_pad"],), float("inf"),
                              dtype=self._dtype, device=self.device)
        if source is None:
            dist0_gs[:v] = 0.0  # every real vertex; pads stay +inf
        else:
            dist0_gs[int(lay["rank_host"][source])] = 0.0
        inner_cap = self.config.gs_inner_cap
        # The dirty window: the exact block in-adjacency gates the inner
        # visits instead of the halo window (value-exact either way).
        in_adj = lay["in_adj"] if self._use_dw(dgraph, 1) else None
        dist, rounds, improving, iters_blk, *traj = sssp_gs_blocks(
            dist0_gs, lay["src_blk"], lay["dstl_blk"], lay["w_blk"],
            vb=lay["vb"], halo=lay["halo"], max_outer=max_iter,
            inner_cap=inner_cap, traj_cap=self._traj_cap(), in_adj=in_adj,
        )
        res = KernelResult(
            dist=dist[lay["rank"].long()],
            negative_cycle=improving and max_iter >= v,
            converged=not improving,
            iterations=rounds,
            edges_relaxed=_gs_examined_exact(
                iters_blk, lay["real_edges_host"], 1, rounds=rounds,
                inner_cap=inner_cap),
            route="gs+dw" if in_adj is not None else "gs",
        )
        res.cost = self._observe_unavailable(res.route, dgraph)
        if traj:
            self._attach_trajectory(res, *traj, dgraph)
        return res

    def _sssp_build_frontier(self, ctx) -> KernelResult:
        dgraph, max_iter = ctx.dgraph, ctx.max_iter
        dist, iters, improving, examined = relax.bellman_ford_frontier(
            ctx.dist0, dgraph.src, dgraph.dst, dgraph.weights,
            dgraph.indptr_dev(), max_iter=max_iter,
            capacity=self._frontier_capacity(dgraph),
            max_degree=dgraph.max_degree,
            num_real_edges=dgraph.num_real_edges, edge_chunk=ctx.chunk,
        )
        return KernelResult(
            dist=dist,
            negative_cycle=improving and max_iter >= dgraph.num_nodes,
            converged=not improving,
            iterations=iters,
            edges_relaxed=relax.examined_exact(examined),
            route="frontier",
            cost=self._observe_unavailable("frontier", dgraph),
        )

    def _sssp_build_sweep(self, ctx) -> KernelResult:
        dgraph, max_iter = ctx.dgraph, ctx.max_iter
        dist, iters, improving, traj = self._fixpoint(
            lambda d: relax.relax_sweep(d, dgraph.src, dgraph.dst,
                                        dgraph.weights, edge_chunk=ctx.chunk),
            ctx.dist0, max_iter, None)
        res = KernelResult(
            dist=dist,
            negative_cycle=improving and max_iter >= dgraph.num_nodes,
            converged=not improving,
            iterations=iters,
            edges_relaxed=iters * dgraph.num_real_edges,
            route="sweep",
        )
        self._observe_sweeps(res, dgraph)
        if traj is not None:
            self._attach_trajectory(res, *traj, dgraph)
        return res

    def reweight(self, dgraph: TorchDeviceGraph, potentials) -> TorchDeviceGraph:
        """w' = (w + h[src]) - h[dst] >= 0 on the device. The in-edge
        structure survives (same dict object); the gathered ``w_in`` is
        re-derived from the new weights at next use."""
        h = torch.as_tensor(potentials).to(self.device, self._dtype)
        return dataclasses.replace(
            dgraph,
            weights=relax.reweight_weights(
                dgraph.weights, dgraph.src, dgraph.dst, h
            ),
            _by_dst_cache={},
        )

    def _use_dense(self, dgraph: TorchDeviceGraph) -> bool:
        """The reference's dense gate: V <= dense_threshold and E >=
        dense_min_density x V^2."""
        v = dgraph.num_nodes
        if v > self.config.dense_threshold or v == 0:
            return False
        return dgraph.num_real_edges >= self.config.dense_min_density * v * v

    # -- blocked Floyd-Warshall (ops.fw) ------------------------------------

    def _fw_tile(self, dgraph: TorchDeviceGraph) -> tuple[int, str]:
        """The FW tile before ``effective_tile`` shrinks it to small
        graphs, as ``(value, source)``: an explicit ``config.fw_tile``,
        else the profile-tuned tile for this (platform, shape bucket),
        else ``DEFAULT_FW_TILE`` (``observe.tuning.resolve_param``).
        Cached per device graph so the gate and the build agree."""
        cached = dgraph._by_dst_cache.get("fw_tile_resolved")
        if cached is None:
            value, source = observe.resolve_param(
                "fw_tile", self.config.fw_tile, fw_ops.DEFAULT_FW_TILE,
                config=self.config, platform=self._platform,
                num_nodes=dgraph.num_nodes, num_edges=dgraph.num_real_edges,
                validate=lambda t: isinstance(t, int) and t >= 128
                and t % 128 == 0)
            cached = (int(value), source)
            dgraph._by_dst_cache["fw_tile_resolved"] = cached
        return cached

    def _use_fw(self, dgraph: TorchDeviceGraph, batch: int) -> bool:
        """The reference's gate, on every device as there: ``True``
        forces, ``False`` (or an earlier auto failure) disables; ``"auto"``
        engages when (a) most rows are wanted anyway (2B >= V, the
        squaring regime), (b) the graph is dense (``dense_min_density``),
        (c) V is within ``fw_threshold``, and (d) the exact MAC counts say
        the blocked closure beats squaring."""
        flag = self.config.fw
        if flag is False or getattr(self, "_fw_disabled", False):
            return False
        v = dgraph.num_nodes
        if v == 0:
            return False
        if flag is True:
            return True
        if v > self.config.fw_threshold:
            return False
        regime, per_iter = relax.dense_fanout_regime(v, batch)
        if regime != "squaring":
            return False
        if dgraph.num_real_edges < self.config.dense_min_density * v * v:
            return False
        tile = fw_ops.effective_tile(v, self._fw_tile(dgraph)[0])
        fw_macs = fw_ops.fw_mac_count(fw_ops.pad_tiles(v, tile), tile)
        return fw_macs < relax.squaring_steps(v) * per_iter

    # -- the fan-out ---------------------------------------------------------

    def multi_source(self, dgraph: TorchDeviceGraph,
                     sources: np.ndarray) -> KernelResult:
        return self._fanout(dgraph, sources)[0]

    def _fanout(self, dgraph: TorchDeviceGraph, sources: np.ndarray):
        """The fan-out: a ``planner.select`` walk over
        :data:`FANOUT_PLANS` (see the module docstring). Returns
        (KernelResult with dist [B, V], the vertex-major [V, B] block the
        route converged, or None for the routes that keep [B, V])."""
        sources = torch.as_tensor(np.asarray(sources), dtype=torch.int64)
        sources = sources.to(self.device)
        b = int(sources.shape[0])
        ctx = _FanoutCtx(backend=self, dgraph=dgraph, sources=sources,
                         batch=b, max_iter=self.config.max_iterations
                         or dgraph.num_nodes, mesh=self._mesh(),
                         layout=self._resolve_layout())
        res = self._walk(FANOUT_PLANS, ctx, batch=b, what="fan-out")
        return res, ctx.dist_vm

    def _vm_lay_chunk(self, dgraph: TorchDeviceGraph, b: int) -> int:
        """The vm-blocked layout's chunk: the reference's rule, from the
        batch rounded up to a power of two so ragged last batches reuse
        the layout."""
        return relax.edge_chunk_for(1 << max(0, b - 1).bit_length(),
                                    dgraph.src.shape[0])

    def _plan_build_dia(self, ctx) -> KernelResult:
        """The DIA stencil fan-out over [B, V] distances: every sweep is K
        contiguous roll + add + min passes."""
        dgraph, b = ctx.dgraph, ctx.batch
        lay = self.dia_bundle(dgraph)
        if ctx.mesh.size > 1:
            # Rows sharded over the ranks, the [K, V] diagonals replicated,
            # no per-round collective.
            dist, iters, improving, examined = mesh_ops.sharded_dia_fanout(
                ctx.mesh, ctx.sources, lay["w_diag"],
                num_nodes=dgraph.num_nodes, offsets=lay["offsets"],
                max_iter=ctx.max_iter, num_entries=lay["num_entries"],
                fault_hook=self._shard_fault_hook(),
                telemetry=self._telemetry)
            return KernelResult(
                dist=dist, converged=not improving, iterations=iters,
                edges_relaxed=examined, route="dia-sharded",
                cost=self._sharded_cost("dia-sharded", dgraph, b))
        dist, iters, improving, traj = self._fixpoint(
            lambda d: dia_sweep(d, lay["w_diag"], offsets=lay["offsets"]),
            relax.multi_source_init(ctx.sources, dgraph.num_nodes,
                                    self._dtype),
            ctx.max_iter, 0)
        res = KernelResult(dist=dist, converged=not improving,
                           iterations=iters,
                           edges_relaxed=iters * lay["num_entries"] * b,
                           route="dia")
        self._observe_sweeps(res, dgraph, b)
        if traj is not None:
            self._attach_trajectory(res, *traj, dgraph, batch=b)
        return res

    def _plan_build_gs(self, ctx) -> KernelResult:
        """The blocked Gauss-Seidel fan-out (vertex-major, relabeled ids),
        rows mapped back to the original labels; ``gs+dw`` when the dirty
        window engages (the block in-adjacency gates the visits)."""
        dgraph, b = ctx.dgraph, ctx.batch
        lay = dgraph.gs_layout(self.config.gs_block_size)
        inner_cap = self.config.gs_inner_cap
        if ctx.mesh.size > 1:
            # The block schedule per rank on its batch slice, the layout
            # replicated, no per-round collective.
            dist, rounds, improving, examined = mesh_ops.sharded_gs_fanout(
                ctx.mesh, ctx.sources, lay["src_blk"], lay["dstl_blk"],
                lay["w_blk"], lay["rank"], v_pad=lay["v_pad"], vb=lay["vb"],
                halo=lay["halo"], max_outer=ctx.max_iter, inner_cap=inner_cap,
                real_edges_host=lay["real_edges_host"],
                fault_hook=self._shard_fault_hook(),
                telemetry=self._telemetry)
            return KernelResult(
                dist=dist, converged=not improving, iterations=rounds,
                edges_relaxed=examined, route="gs-sharded",
                cost=self._sharded_cost("gs-sharded", dgraph, b))
        in_adj = lay["in_adj"] if self._use_dw(dgraph, b) else None
        dist, rounds, improving, iters_blk, *traj = fanout_gs_body(
            ctx.sources, lay["src_blk"], lay["dstl_blk"], lay["w_blk"],
            lay["rank"], v_pad=lay["v_pad"], vb=lay["vb"], halo=lay["halo"],
            max_outer=ctx.max_iter, inner_cap=inner_cap,
            traj_cap=self._traj_cap(), in_adj=in_adj,
        )
        route = "gs+dw" if in_adj is not None else "gs"
        res = KernelResult(
            dist=dist, converged=not improving, iterations=rounds,
            edges_relaxed=_gs_examined_exact(
                iters_blk, lay["real_edges_host"], b, rounds=rounds,
                inner_cap=inner_cap),
            route=route,
            cost=self._observe_unavailable(route, dgraph, b),
        )
        if traj:
            self._attach_trajectory(res, *traj, dgraph, batch=b)
        return res

    def _plan_build_fw(self, ctx) -> KernelResult:
        """Blocked min-plus Floyd-Warshall: route ``fw`` when the padded
        graph is one tile, else ``fw-tile``; ``iterations`` is the number
        of k-steps and ``edges_relaxed`` the exact tropical MACs. The
        closure is recomputed for every source batch, as in the
        reference."""
        dgraph = ctx.dgraph
        v = dgraph.num_nodes
        tile, tile_source = self._fw_tile(dgraph)
        tile = fw_ops.effective_tile(v, tile)
        ctx.params["fw_tile"] = tile
        ctx.params["fw_tile_source"] = tile_source
        vp = fw_ops.pad_tiles(v, tile)
        dist, neg = _fw_apsp_kernel(
            ctx.sources, dgraph.src, dgraph.dst, dgraph.weights, num_nodes=v,
            tile=tile, dtype=self._dtype)
        route = "fw" if vp == tile else "fw-tile"
        return KernelResult(
            dist=dist,
            negative_cycle=neg,
            converged=not neg,
            iterations=vp // tile,
            edges_relaxed=fw_ops.fw_mac_count(vp, tile),
            route=route,
            cost=self._observe_analytic(
                route, fw_ops.fw_analytic_cost(vp, tile, self._itemsize),
                dgraph, ctx.batch),
        )

    def _plan_build_dw(self, ctx) -> KernelResult:
        """The dirty-window fan-out (route ``vm-blocked+dw``,
        ``relax.bellman_ford_sweeps_dw``): examined work follows the
        collapsing frontier instead of rounds x E."""
        dgraph, b = ctx.dgraph, ctx.batch
        v = dgraph.num_nodes
        lay = dgraph.dw_layout(max(1, int(self.config.dw_block
                                          or relax.DW_BLOCK)))
        capacity = self._dw_capacity(lay["nb"], lay["em"], b)
        src_bd, dst_bd, w_bd = dgraph.vm_edges()
        cap = self._traj_cap()
        dist_vm, rounds, improving, examined, fulls, *traj = (
            relax.bellman_ford_sweeps_dw(
                self._dist0_vm(v, ctx.sources), lay["e_src"], lay["e_dst"],
                lay["w_tile"], lay["blk_of_v"], src_bd, dst_bd, w_bd,
                vb=lay["vb"], capacity=capacity, max_iter=ctx.max_iter,
                num_real_edges=dgraph.num_real_edges,
                edge_chunk=relax.edge_chunk_for(b, dgraph.src.shape[0]),
                traj_cap=cap))
        # Exact counters (Python ints): the device count is in edge slots.
        examined_slots = relax.examined_exact(examined)
        ctx.dist_vm = dist_vm
        res = KernelResult(
            dist=dist_vm.t().contiguous(),
            converged=not improving,
            iterations=rounds,
            edges_relaxed=examined_slots * b,
            route="vm-blocked+dw",
            cost=self._observe_analytic(
                "vm-blocked+dw",
                relax.dw_analytic_cost(examined_slots, b, self._itemsize),
                dgraph, b),
        )
        if traj:
            counts, resid, dirty_ct = traj
            self._attach_trajectory(res, counts, resid, dgraph, batch=b)
            if res.convergence is not None:
                # The dirty-block curve, downsampled like the frontier's.
                curve = dirty_ct[:min(rounds, dirty_ct.shape[0])]
                res.convergence.update(
                    dirty_blocks_total=int(curve.sum()),
                    dirty_block_curve=conv.frontier_curve(
                        np.stack([curve, curve, curve], axis=1)),
                    num_blocks=int(lay["nb"]),
                    full_sweep_rounds=int(fulls),
                    examined_edge_slots=int(examined_slots),
                    skipped_edge_slots=int(
                        rounds * dgraph.num_real_edges - examined_slots))
        return res

    def _plan_build_sharded_2d(self, ctx) -> KernelResult:
        """The 2-D ("sources", "edges") mesh: rows and edge slices
        sharded, one MIN all-reduce per sweep over each "edges" group
        (vertex-major: one hand ``fanout_sweep`` launch per sweep on each
        rank's slice). A failure degrades through
        :meth:`_sharded_fallback`."""
        dgraph, mesh, b = ctx.dgraph, ctx.mesh, ctx.batch
        ns, ne = int(mesh.shape["sources"]), int(mesh.shape["edges"])
        chunk = relax.edge_chunk_for(-(-b // ns),
                                     -(-dgraph.src.shape[0] // ne))
        edges = (dgraph.vm_edges() if ctx.layout == "vertex_major"
                 else (dgraph.src, dgraph.dst, dgraph.weights))
        try:
            dist, iters, improving, row_sweeps = mesh_ops.sharded_fanout_2d(
                mesh, ctx.sources, *edges, num_nodes=dgraph.num_nodes,
                max_iter=ctx.max_iter, edge_chunk=chunk, layout=ctx.layout,
                with_row_sweeps=True, fault_hook=self._shard_fault_hook(),
                telemetry=self._telemetry)
        except Exception as e:
            return self._sharded_fallback(e, dgraph, ctx.sources)
        return self._sharded_result(dgraph, dist, iters, improving,
                                    row_sweeps, "sharded-2d", b)

    def _plan_build_sharded_1d(self, ctx) -> KernelResult:
        """The 1-D sources mesh: rows sharded, the CSR replicated; each
        rank runs the hand fan-out sweep to its fixpoint on its
        [V, B / n] block (vertex-major) or the source-major sweep."""
        dgraph, mesh, b = ctx.dgraph, ctx.mesh, ctx.batch
        # Ceil: the batch is padded to a rank multiple.
        chunk = relax.edge_chunk_for(-(-b // mesh.size), dgraph.src.shape[0])
        in_edges = None
        if ctx.layout == "vertex_major":
            csc, items = dgraph.fanout_layout()
            in_edges = (*csc, items)
        try:
            dist, iters, improving, row_sweeps = mesh_ops.sharded_fanout(
                mesh, ctx.sources, dgraph.src, dgraph.dst, dgraph.weights,
                num_nodes=dgraph.num_nodes, max_iter=ctx.max_iter,
                edge_chunk=chunk, layout=ctx.layout, with_row_sweeps=True,
                in_edges=in_edges, fault_hook=self._shard_fault_hook(),
                telemetry=self._telemetry)
        except Exception as e:
            return self._sharded_fallback(e, dgraph, ctx.sources)
        return self._sharded_result(dgraph, dist, iters, improving,
                                    row_sweeps, "sharded-1d", b)

    def _sharded_result(self, dgraph, dist, iters, improving, row_sweeps,
                        route, b) -> KernelResult:
        """A sharded sweep's result: the work is the exact per-rank row
        sweeps x E (``parallel.mesh._row_sweeps_exact``)."""
        return KernelResult(
            dist=dist,
            converged=not improving,
            iterations=iters,
            edges_relaxed=int(row_sweeps) * dgraph.num_real_edges,
            route=route,
            cost=self._sharded_cost(route, dgraph, b),
        )

    def _plan_build_dense(self, ctx) -> KernelResult:
        """The dense min-plus fan-out: the hand product
        (``dense-{regime}-pallas``; on the card the iterate regime through
        ``minplus_fixpoint``) unless ``use_pallas=False`` asks for the
        plain product (``dense-{regime}``)."""
        dgraph, sources, b = ctx.dgraph, ctx.sources, ctx.batch
        v = dgraph.num_nodes
        hand = self.config.use_pallas is not False
        a = relax.dense_adjacency(dgraph.src, dgraph.dst, dgraph.weights, v,
                                  dtype=self._dtype)
        fixpoint = (minplus_fixpoint
                    if hand and self.device.type == "cuda" else None)
        dist, iters, improving = relax.dense_fanout(
            a, sources, max_iter=ctx.max_iter,
            mp=minplus_kernel if hand else relax.minplus, fixpoint=fixpoint)
        regime, work_per_iter = relax.dense_fanout_regime(v, b)
        route = f"dense-{regime}" + ("-pallas" if hand else "")
        rows = v if regime == "squaring" else b
        return KernelResult(
            dist=dist,
            converged=not improving,
            iterations=iters,
            edges_relaxed=iters * work_per_iter,
            route=route,
            cost=self._observe_analytic(
                route, costs.minplus_cost(rows, v, v, iters, self._itemsize),
                dgraph, b),
        )

    def _plan_build_pallas_vm(self, ctx) -> KernelResult:
        """The hand fan-out sweep (``ops.fanout_sweep``: the CUDA kernel on
        the card, its plain version on the CPU) to its fixpoint."""
        dgraph, b = ctx.dgraph, ctx.batch
        (indptr_in, src_in, w_in), items = dgraph.fanout_layout()
        dist_vm, iters, improving = fanout_fixpoint(
            self._dist0_vm(dgraph.num_nodes, ctx.sources), indptr_in, src_in,
            w_in, max_iter=ctx.max_iter, items=items)
        ctx.dist_vm = dist_vm
        res = self._sweep_result(dgraph, dist_vm.t().contiguous(), iters,
                                 improving, b, "pallas-vm")
        return self._observe_sweeps(res, dgraph, b)

    def _plan_build_vm_blocked(self, ctx) -> KernelResult:
        dgraph, b = ctx.dgraph, ctx.batch
        v = dgraph.num_nodes
        lay = dgraph.vm_blocked_layout(VM_BLOCK, self._vm_lay_chunk(dgraph, b))
        # Pad rows are +inf and never improve: the counts stay exact.
        dist_vm, iters, improving, traj = self._fixpoint(
            lambda d: relax.relax_sweep_vm_blocked(
                d, lay["src_ck"], lay["dstl_ck"], lay["w_ck"],
                lay["base_ck"], vb=lay["vb"]),
            self._dist0_vm(lay["v_pad"], ctx.sources), ctx.max_iter, 1)
        return self._vm_result(ctx, dist_vm[:v], iters, improving, traj,
                               "vm-blocked")

    def _plan_build_vm(self, ctx) -> KernelResult:
        dgraph, b = ctx.dgraph, ctx.batch
        src, dst, w = dgraph.vm_edges()
        chunk = relax.edge_chunk_for(b, dgraph.src.shape[0])
        dist_vm, iters, improving, traj = self._fixpoint(
            lambda d: relax.relax_sweep_vm(d, src, dst, w, edge_chunk=chunk),
            self._dist0_vm(dgraph.num_nodes, ctx.sources), ctx.max_iter, 1)
        return self._vm_result(ctx, dist_vm, iters, improving, traj, "vm")

    def _vm_result(self, ctx, dist_vm, iters, improving, traj, route):
        ctx.dist_vm = dist_vm
        res = self._sweep_result(ctx.dgraph, dist_vm.t().contiguous(), iters,
                                 improving, ctx.batch, route)
        self._observe_sweeps(res, ctx.dgraph, ctx.batch)
        if traj is not None:
            self._attach_trajectory(res, *traj, ctx.dgraph, batch=ctx.batch)
        return res

    def _plan_build_sweep_sm(self, ctx) -> KernelResult:
        """The source-major scatter sweep over [B, V] distances."""
        dgraph, b = ctx.dgraph, ctx.batch
        src, dst, w = dgraph.src, dgraph.dst, dgraph.weights
        chunk = relax.edge_chunk_for(b, dgraph.src.shape[0])
        dist, iters, improving, traj = self._fixpoint(
            lambda d: relax.relax_sweep(d, src, dst, w, edge_chunk=chunk),
            relax.multi_source_init(ctx.sources, dgraph.num_nodes,
                                    self._dtype), ctx.max_iter, 0)
        res = self._sweep_result(dgraph, dist, iters, improving, b,
                                 "sweep-sm")
        self._observe_sweeps(res, dgraph, b)
        if traj is not None:
            self._attach_trajectory(res, *traj, dgraph, batch=b)
        return res

    def _dist0_vm(self, rows: int, sources: torch.Tensor) -> torch.Tensor:
        """[rows, B] of +inf with 0 at (sources[c], c)."""
        b = sources.shape[0]
        dist0 = torch.full((rows, b), float("inf"), dtype=self._dtype,
                           device=self.device)
        dist0[sources, torch.arange(b, device=self.device)] = 0.0
        return dist0

    @staticmethod
    def _sweep_result(dgraph, dist, iters, improving, b, route):
        """A sweep route's result: every row takes every sweep, so the
        work is iterations x B x E."""
        return KernelResult(
            dist=dist,
            converged=not improving,
            iterations=iters,
            edges_relaxed=iters * b * dgraph.num_real_edges,
            route=route,
        )

    # -- predecessor trees ---------------------------------------------------

    def _use_pred_extraction(self) -> bool:
        """The tight-edge pass serves predecessor solves unless
        ``pred_extraction=False`` asks for the argmin sweep."""
        return self.config.pred_extraction is not False

    def _pred_fallback(self, why: str) -> None:
        """Send a predecessor solve to the argmin sweep with a warning, or
        raise when ``pred_extraction=True`` forced the extraction."""
        if self.config.pred_extraction is True:
            raise RuntimeError(
                f"pred_extraction=True but {why}; the legacy argmin "
                "sweep (pred_extraction=False) handles this case"
            )
        warnings.warn(
            "tight-edge predecessor extraction fell back to the legacy "
            f"argmin sweep: {why}",
            RuntimeWarning,
            stacklevel=3,
        )

    def _extract(self, dgraph: TorchDeviceGraph, dist_vm, dist, sources):
        """(pred [B, V] int32, ok): the tight-edge pass over the in-edge
        CSC on the vertex-major distances ``dist_vm`` (the hand kernel on
        the card), which masks the sources and raises the tree flags, then
        the tree check on them: one host read of the flags, and the
        pointer-doubling walk only when a predecessor is not strictly
        closer (``ops.pred.certify_pred``)."""
        (indptr_in, src_in, w_in), items = dgraph.fanout_layout()
        sources = np.asarray(sources).reshape(-1)
        pred, flags = tight_pred_pass(dist_vm, indptr_in, src_in, w_in,
                                      items=items, sources=sources)
        pred, ok = certify_pred(pred.t().contiguous(), dist, sources,
                                flags=flags)
        return pred, bool(ok)

    def _add_pred_cost(self, res: KernelResult, dgraph, batch: int) -> None:
        """Tag ``res`` with its ``+pred`` route and add the tight-edge
        pass to its analytic cost (a route without a model keeps the
        marker)."""
        res.route = f"{res.route}+pred"
        if res.cost is None:
            return
        if "cost_analysis_unavailable" in res.cost:
            res.cost = self._observe_unavailable(res.route, dgraph, batch)
        else:
            res.cost = self._observe_analytic(res.route, costs.add_costs(
                res.cost, costs.tight_pred_cost(
                    dgraph.num_nodes, dgraph.num_real_edges, batch,
                    self._itemsize)), dgraph, batch)

    def bellman_ford_pred(self, dgraph: TorchDeviceGraph,
                          source: int | None) -> KernelResult:
        """``bellman_ford`` with its shortest-path tree: route
        ``sweep+pred`` (one extraction pass: E more edges relaxed), else
        ``pred-sweep``."""
        if source is None:
            raise NotImplementedError(
                "virtual-source Bellman-Ford has no predecessor tree"
            )
        if self._use_pred_extraction():
            res = self.bellman_ford(dgraph, source)
            if res.negative_cycle or not res.converged:
                return res  # no tree to extract
            pred, ok = self._extract(dgraph, res.dist.unsqueeze(1),
                                     res.dist.unsqueeze(0), [source])
            if ok:
                res.pred = pred[0]
                self._add_pred_cost(res, dgraph, 1)
                res.edges_relaxed += dgraph.num_real_edges
                return res
            self._pred_fallback(
                "the tree check rejected the one-pass extraction "
                "(zero-weight tight cycle on a shortest path)"
            )
        return self._bellman_ford_pred_sweep(dgraph, source)

    def _bellman_ford_pred_sweep(self, dgraph: TorchDeviceGraph,
                                 source: int) -> KernelResult:
        """The argmin-carrying sweep from one source (route
        ``pred-sweep``)."""
        v = dgraph.num_nodes
        dist0 = torch.full((v,), float("inf"), dtype=self._dtype,
                           device=self.device)
        dist0[source] = 0.0
        max_iter = self.config.max_iterations or v
        dist, pred, iters, improving = relax.bellman_ford_sweeps_pred(
            dist0, dgraph.src, dgraph.dst, dgraph.weights, max_iter=max_iter,
            edge_chunk=relax.edge_chunk_for(1, dgraph.src.shape[0]),
        )
        return KernelResult(
            dist=dist,
            pred=pred,
            negative_cycle=improving and max_iter >= v,
            converged=not improving,
            iterations=iters,
            edges_relaxed=iters * dgraph.num_real_edges,
            route="pred-sweep",
        )

    def multi_source_pred(self, dgraph: TorchDeviceGraph,
                          sources: np.ndarray) -> KernelResult:
        """``multi_source`` on the same route, then one tight-edge pass
        (``<route>+pred``, B x E more edges relaxed). A zero-weight tight
        cycle fails the tree check and falls back to ``pred-sweep``."""
        if self._use_pred_extraction():
            res, dist_vm = self._fanout(dgraph, sources)
            if not res.converged:
                return res  # the solver raises ConvergenceError; no tree
            mesh = self._mesh()
            if mesh.size > 1:
                # Each rank's rows against the replicated in-edge CSC, no
                # collective but the AND of the tree checks.
                csc, items = dgraph.fanout_layout()
                pred, ok = mesh_ops.sharded_tight_pred(
                    mesh, res.dist, sources, dgraph.src, dgraph.dst,
                    dgraph.weights, num_nodes=dgraph.num_nodes,
                    in_edges=(*csc, items), telemetry=self._telemetry)
            else:
                if dist_vm is None:
                    dist_vm = res.dist.t().contiguous()
                pred, ok = self._extract(dgraph, dist_vm, res.dist, sources)
            del dist_vm
            if ok:
                res.pred = pred
                self._add_pred_cost(res, dgraph, len(sources))
                res.edges_relaxed += len(sources) * dgraph.num_real_edges
                return res
            self._pred_fallback(
                "the tree check rejected the one-pass extraction "
                "(zero-weight tight cycle on a shortest path)"
            )
        return self._multi_source_pred_sweep(dgraph, sources)

    def _multi_source_pred_sweep(self, dgraph: TorchDeviceGraph,
                                 sources: np.ndarray) -> KernelResult:
        """The argmin-carrying fan-out (route ``pred-sweep``); on a mesh
        of more than one rank, sharded over a 1-D "sources" mesh of the
        same ranks (the argmin sweep has no edges-sharded merge)."""
        sources = torch.as_tensor(np.asarray(sources), dtype=torch.int64)
        sources = sources.to(self.device)
        b = int(sources.shape[0])
        v = dgraph.num_nodes
        max_iter = self.config.max_iterations or v
        mesh = self._mesh().as_sources_mesh()
        if mesh.size > 1:
            try:
                dist, iters, improving, pred, row_sweeps = (
                    mesh_ops.sharded_fanout(
                        mesh, sources, dgraph.src, dgraph.dst, dgraph.weights,
                        num_nodes=v, max_iter=max_iter,
                        edge_chunk=relax.edge_chunk_for(
                            -(-b // mesh.size), dgraph.src.shape[0]),
                        with_pred=True, with_row_sweeps=True,
                        fault_hook=self._shard_fault_hook(),
                        telemetry=self._telemetry))
            except Exception as e:
                return self._sharded_fallback(e, dgraph, sources,
                                              pred_sweep=True)
            res = self._sharded_result(dgraph, dist, iters, improving,
                                       row_sweeps, "pred-sweep", b)
            res.cost = self._sharded_cost("pred-sweep-sharded", dgraph, b)
            res.pred = pred
            return res
        dist, pred, iters, improving = relax.bellman_ford_sweeps_pred(
            relax.multi_source_init(sources, v, self._dtype),
            dgraph.src, dgraph.dst, dgraph.weights, max_iter=max_iter,
            edge_chunk=relax.edge_chunk_for(b, dgraph.src.shape[0]),
        )
        res = self._sweep_result(dgraph, dist, iters, improving, b,
                                 "pred-sweep")
        res.pred = pred
        return res

    # -- many small graphs ---------------------------------------------------

    def _batch_slab(self, g: int, v: int) -> int:
        """Graphs per disjoint union: ``BATCH_APSP_BLOCKS`` [v, v] blocks
        per graph within the memory budget (half the card's free memory,
        or ``CPU_BUDGET_BYTES`` on the CPU)."""
        itemsize = torch.empty((), dtype=self._dtype).element_size()
        if self.device.type == "cuda":
            budget = torch.cuda.mem_get_info(self.device)[0] // 2
        else:
            budget = CPU_BUDGET_BYTES
        per_graph = BATCH_APSP_BLOCKS * v * v * itemsize
        return int(max(1, min(g, budget // max(per_graph, 1))))

    def _batch_union(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                     v: int):
        """Johnson on the disjoint union of a slab of stacked graphs
        (graph g's vertex u is g.v + u; the (0, 0, +inf) pad edges are
        dropped). Returns (dist [G, v, v], phase-2 sweeps, negative
        cycle, real edges of the union)."""
        g = src.shape[0]
        n = g * v
        off = (np.arange(g, dtype=np.int64) * v)[:, None]
        keep = ~np.isposinf(w)
        dev, dtype = self.device, self._dtype
        s_t = torch.as_tensor((src + off)[keep].astype(np.int32)).to(dev)
        d_t = torch.as_tensor((dst + off)[keep].astype(np.int32)).to(dev)
        w_t = torch.as_tensor(w[keep]).to(dev, dtype)
        e = int(s_t.shape[0])
        h = None
        if bool((w_t < 0).any()):
            # Phase 1 at B = 1 from 0 everywhere, as the reference's
            # per_graph runs it: one chunk, so every sweep is the Jacobi
            # sweep of each graph alone. No component has more than v
            # vertices, so "still improving after v sweeps" is the
            # reference's any(neg).
            h_vm, _, neg = relax.bellman_ford_sweeps_vm(
                torch.zeros((n, 1), dtype=dtype, device=dev), s_t, d_t, w_t,
                max_iter=v, edge_chunk=max(e, 1))
            if neg:
                return None, 0, True, e
            h = h_vm[:, 0]
            w_t = relax.reweight_weights(w_t, s_t, d_t, h)
        lay = build_in_edge_layout(s_t, d_t, n)
        w_in = w_t[lay["order"]].contiguous()
        del s_t, d_t, w_t
        # Column b of graph g's rows is source b of graph g.
        dist0 = torch.full((n, v), float("inf"), dtype=dtype, device=dev)
        rows = torch.arange(n, device=dev)
        dist0[rows, rows % v] = 0.0
        del rows
        dist_vm, iters, _ = fanout_fixpoint(
            dist0, lay["indptr_in"], lay["src_in"], w_in, max_iter=v,
            items=lay["work_items"])
        del lay, w_in
        dist = dist_vm.view(g, v, v).transpose(1, 2).contiguous()
        del dist_vm
        if h is not None:
            # The reference's association: (d' - h[s]) + h[v].
            hg = h.view(g, v)
            dist = (dist - hg[:, :, None]) + hg[:, None, :]
        return dist, iters, False, e

    def batch_apsp(self, batch: dict) -> KernelResult:
        """APSP of a stacked batch of graphs (``stack_graphs``): the
        reference's vmapped Johnson (``_batch_johnson_kernel``) as one
        solve of each slab's disjoint union. Phase 1 (only when a weight
        is negative: with h = 0 the reweight and un-reweight change no
        bit) is ``relax.bellman_ford_sweeps_vm`` at B = 1; phase 2 is one
        ``fanout_fixpoint`` of ``v_max`` columns over the union's in-edge
        CSC (the hand sweep on the card), from 0 at (g.v_max + b, b).
        Returns dist [G, v_max, v_max] (on the device for one slab, host
        numpy for several; slabs by :meth:`_batch_slab`).

        Counters: route ``batch-vmapped`` (the reference's tag);
        ``iterations`` the union's sweep count, max over slabs (the
        reference's max over graphs: the Jacobi sweeps of disjoint graphs
        are independent); ``negative_cycle`` any; ``edges_relaxed`` the
        sum over slabs of iterations x E_union x v_max (the union has no
        per-graph counts; the reference sums each graph's own sweeps x
        E_max x v_max)."""
        src = np.asarray(batch["src"], np.int64)
        dst = np.asarray(batch["dst"], np.int64)
        w = np.asarray(batch["weights"])
        v = int(batch["v_max"])
        g = src.shape[0]
        slab = self._batch_slab(g, v)
        parts, iters, relaxed = [], 0, 0
        for g0 in range(0, g, slab):
            sl = slice(g0, g0 + slab)
            dist, it, neg, e = self._batch_union(src[sl], dst[sl], w[sl], v)
            if neg:
                return KernelResult(dist=None, negative_cycle=True,
                                    converged=False, route="batch-vmapped")
            iters = max(iters, it)
            relaxed += it * e * v
            parts.append(dist if slab >= g else dist.cpu().numpy())
        return KernelResult(
            dist=parts[0] if len(parts) == 1 else np.concatenate(parts),
            iterations=iters,
            edges_relaxed=relaxed,
            route="batch-vmapped",
        )


# -- the plan registries -----------------------------------------------------
#
# Each route declares a ``planner.Plan``: its qualification (the gates
# above, now data instead of branch order, each with its reason), its
# cost hook (the CostModel route tags), its build and its failure policy
# (warn once and disable on an auto route, propagate on a forced one).
# The names, priorities, price routes, forced flags, force overrides and
# tunables are the JAX package's, so ``candidates`` lists the same plans
# in both packages; with nothing priced the walk is the declared order.


@dataclasses.dataclass
class _FanoutCtx:
    """One fan-out dispatch's context (what the plan hooks see);
    ``dist_vm`` is set by the builds that converge a vertex-major block."""

    backend: "TorchBackend"
    dgraph: TorchDeviceGraph
    sources: torch.Tensor
    batch: int
    max_iter: int
    mesh: object
    layout: str
    params: dict = dataclasses.field(default_factory=dict)
    dist_vm: torch.Tensor | None = None


@dataclasses.dataclass
class _SsspCtx:
    """One B=1 (SSSP / virtual-source) dispatch's context."""

    backend: "TorchBackend"
    dgraph: TorchDeviceGraph
    source: int | None
    dist0: torch.Tensor
    max_iter: int
    chunk: int
    params: dict = dataclasses.field(default_factory=dict)


def _no_edges_axis(ctx) -> bool:
    return "edges" not in ctx.mesh.axis_names


def _single_device(ctx) -> bool:
    return _no_edges_axis(ctx) and ctx.mesh.size == 1


def _contract_gs(ctx) -> None:
    if not _no_edges_axis(ctx) and ctx.backend.config.gauss_seidel is True:
        # The GS layout is not edge-sharded: its sequential block schedule
        # needs the whole edge list per rank.
        raise NotImplementedError(
            "gauss_seidel=True fan-out shards sources only; use a 1-D "
            "mesh_shape=(n,) (or leave gauss_seidel='auto' to use the 2-D "
            "sharded sweep path on this mesh)")


def _contract_dia(ctx) -> None:
    if not _no_edges_axis(ctx) and ctx.backend.config.dia is True:
        # The stencil needs every diagonal per rank.
        raise NotImplementedError(
            "dia=True fan-out shards sources only; use a 1-D "
            "mesh_shape=(n,) (or leave dia='auto' to use the 2-D sharded "
            "sweep path on this mesh)")


def _contract_fw(ctx) -> None:
    if ctx.backend.config.fw is True and not _single_device(ctx):
        # The FW closure holds the whole [Vp, Vp] matrix on one device.
        raise NotImplementedError(
            "fw=True is a single-chip dense route; use mesh_shape=(1,)")


def _qual_dia(ctx):
    if not _no_edges_axis(ctx):
        return False, ("mesh has an edges axis (stencil needs every diagonal "
                       "per device)")
    if ctx.backend._use_dia(ctx.dgraph):
        return True, "diagonal labeling qualifies (gather-free stencil)"
    return False, ("dia gate declined (the port's CUDA gate keeps 'auto' "
                   "off; True forces on a diagonal labeling)")


def _qual_gs(ctx):
    if not _no_edges_axis(ctx):
        return False, ("mesh has an edges axis (GS needs the whole edge list "
                       "per device)")
    if ctx.backend._use_gs(ctx.dgraph):
        return True, "gauss_seidel=True forces the blocked GS fan-out"
    return False, ("gs gate declined (the port's CUDA gate keeps 'auto' "
                   "off; True forces)")


def _qual_fw(ctx):
    if not _single_device(ctx):
        return False, "fw is a single-chip dense route"
    if ctx.backend._use_fw(ctx.dgraph, ctx.batch):
        return True, ("squaring regime + density gate + exact-MAC win over "
                      "squaring")
    return False, ("fw gate declined (regime / density / V threshold / MAC "
                   "count)")


def _qual_dw(ctx):
    be = ctx.backend
    if not _single_device(ctx):
        return False, "dirty-window is a single-device route"
    if be._use_dense(ctx.dgraph):
        return False, "dense regime (dw targets the sparse batched sweep)"
    if be._use_dw(ctx.dgraph, ctx.batch):
        if be.config.dirty_window is True:
            return True, "dirty_window=True forces (no evidence required)"
        return True, be._dw_decision(ctx.dgraph, ctx.batch).get(
            "reason", "trajectory evidence clears the dw thresholds")
    if be.config.dirty_window is False or getattr(be, "_dw_disabled", False):
        return False, "dirty_window disabled"
    if ctx.dgraph.num_nodes == 0:
        return False, "empty graph"
    if ctx.dgraph.num_real_edges >= relax.FRONTIER_ADDEND_MAX:
        return False, "split examined counter's full-sweep addend would wrap"
    return False, be._dw_decision(ctx.dgraph, ctx.batch).get(
        "reason", "no trajectory evidence")


def _qual_sharded_2d(ctx):
    if "edges" in ctx.mesh.axis_names:
        return True, ctx.mesh.describe()
    return False, "no edges mesh axis"


def _qual_sharded_1d(ctx):
    if _no_edges_axis(ctx) and ctx.mesh.size > 1:
        return True, ctx.mesh.describe()
    return False, "single device (or edges axis owns the mesh)"


def _qual_dense(ctx):
    if not _single_device(ctx):
        return False, "dense min-plus is single-chip"
    if ctx.backend._use_dense(ctx.dgraph):
        return True, "graph clears the dense density + size gates"
    return False, "not dense enough (or above dense_threshold)"


def _qual_pallas_vm(ctx):
    if not _single_device(ctx):
        return False, "the hand sweep serves the single-device fan-out only"
    if ctx.backend._use_dense(ctx.dgraph):
        return False, "the hand sweep serves the sparse fan-out only"
    if ctx.layout != "vertex_major":
        return False, "the hand sweep needs the vertex-major layout"
    if ctx.backend.config.use_pallas is False:
        return False, "use_pallas=False takes the XLA routes in plain torch"
    return True, ("the port's CUDA gate: use_pallas='auto' takes the hand "
                  "sweep (csrc/fanout_sweep.cu on the card, its plain "
                  "version on the CPU)")


def _qual_vm_blocked(ctx):
    if not _single_device(ctx):
        return False, "blocked vm serves the single-device fan-out only"
    if ctx.backend._use_dense(ctx.dgraph):
        return False, "blocked vm serves the sparse fan-out only"
    if ctx.layout != "vertex_major":
        return False, "source-major layout configured"
    if ctx.dgraph.num_nodes <= VM_BLOCK:
        return False, (f"V <= {VM_BLOCK} (plain full-V segments are already "
                       "this small)")
    if getattr(ctx.backend, "_vmb_disabled", False):
        return False, "disabled after a prior failure on this backend instance"
    return True, f"V > {VM_BLOCK}: [vb, B] segment writes beat [V, B]"


def _qual_vm(ctx):
    if not _single_device(ctx):
        return False, "plain vm serves the single-device fan-out only"
    if ctx.backend._use_dense(ctx.dgraph):
        return False, "plain vm serves the sparse fan-out only"
    if ctx.layout != "vertex_major":
        return False, "source-major layout configured"
    return True, "vertex-major sorted segment reduction"


def _qual_sweep_sm(ctx):
    if not _single_device(ctx):
        return False, ("source-major sweep serves the single-device fan-out "
                       "only")
    if ctx.backend._use_dense(ctx.dgraph):
        return False, "source-major sweep serves the sparse fan-out only"
    if ctx.layout != "vertex_major":
        return True, "source-major layout configured"
    if ctx.backend.config.fanout_layout == "auto":
        return True, ("layout 'auto': behind vm by priority; promotable when "
                      "priced cheaper")
    return False, "vertex-major layout forced by config"


def _fail_dia(be, ctx) -> None:
    be._auto_route_failed(
        "_dia_disabled", "dia stencil route failed on this platform; "
        "falling back to the gather routes for this backend instance",
        forced=be.config.dia is True)


def _fail_gs(be, ctx) -> None:
    be._auto_route_failed(
        "_gs_disabled", "gauss_seidel kernel failed on this platform; "
        "falling back to the sweep routes for this backend instance",
        forced=be.config.gauss_seidel is True)


def _fail_fw(be, ctx) -> None:
    be._auto_route_failed(
        "_fw_disabled", "blocked Floyd-Warshall route failed on this "
        "platform; falling back to the dense/sparse routes for this backend "
        "instance", forced=be.config.fw is True)


def _fail_dw(be, ctx) -> None:
    be._auto_route_failed(
        "_dw_disabled", "dirty-window fan-out failed on this platform; "
        "falling back to the sweep routes for this backend instance",
        forced=be.config.dirty_window is True)


def _fail_vm_blocked(be, ctx) -> None:
    be._auto_route_failed(
        "_vmb_disabled", "dst-blocked vm fan-out failed on this platform; "
        "falling back to the plain vm sweep for this backend instance",
        forced=False)


FANOUT_PLANS = [
    planner.Plan(
        name="dia", entry="fanout", priority=10, qualify=_qual_dia,
        contract=_contract_dia,
        build=lambda ctx: ctx.backend._plan_build_dia(ctx),
        price_routes=("dia",), forced=lambda cfg: cfg.dia is True,
        failure=_fail_dia, force_overrides={"dia": True},
    ),
    planner.Plan(
        name="gs", entry="fanout", priority=20, qualify=_qual_gs,
        contract=_contract_gs,
        build=lambda ctx: ctx.backend._plan_build_gs(ctx),
        price_routes=("gs", "gs+dw"),
        forced=lambda cfg: cfg.gauss_seidel is True,
        failure=_fail_gs, force_overrides={"gauss_seidel": True},
    ),
    planner.Plan(
        name="fw", entry="fanout", priority=30, qualify=_qual_fw,
        contract=_contract_fw,
        build=lambda ctx: ctx.backend._plan_build_fw(ctx),
        price_routes=("fw", "fw-tile"), forced=lambda cfg: cfg.fw is True,
        failure=_fail_fw, force_overrides={"fw": True, "mesh_shape": (1,)},
        tunables=("fw_tile",),
    ),
    planner.Plan(
        name="vm-blocked+dw", entry="fanout", priority=40, qualify=_qual_dw,
        build=lambda ctx: ctx.backend._plan_build_dw(ctx),
        price_routes=("vm-blocked+dw",),
        forced=lambda cfg: cfg.dirty_window is True,
        failure=_fail_dw, force_overrides={"dirty_window": True},
    ),
    planner.Plan(
        name="sharded-2d", entry="fanout", priority=50,
        qualify=_qual_sharded_2d,
        build=lambda ctx: ctx.backend._plan_build_sharded_2d(ctx),
    ),
    planner.Plan(
        name="sharded-1d", entry="fanout", priority=60,
        qualify=_qual_sharded_1d,
        build=lambda ctx: ctx.backend._plan_build_sharded_1d(ctx),
    ),
    planner.Plan(
        name="dense", entry="fanout", priority=70, qualify=_qual_dense,
        build=lambda ctx: ctx.backend._plan_build_dense(ctx),
        price_routes=("dense-squaring", "dense-iterate"),
        force_overrides={"fw": False, "mesh_shape": (1,)},
    ),
    planner.Plan(
        name="pallas-vm", entry="fanout", priority=80,
        qualify=_qual_pallas_vm,
        build=lambda ctx: ctx.backend._plan_build_pallas_vm(ctx),
        price_routes=("pallas-vm",),
        force_overrides={"use_pallas": True, "fanout_layout": "vertex_major"},
    ),
    planner.Plan(
        name="vm-blocked", entry="fanout", priority=90,
        qualify=_qual_vm_blocked,
        build=lambda ctx: ctx.backend._plan_build_vm_blocked(ctx),
        price_routes=("vm-blocked",), failure=_fail_vm_blocked,
        force_overrides={"fanout_layout": "vertex_major",
                         "dirty_window": False},
    ),
    planner.Plan(
        name="vm", entry="fanout", priority=100, qualify=_qual_vm,
        build=lambda ctx: ctx.backend._plan_build_vm(ctx),
        price_routes=("vm",),
        force_overrides={"fanout_layout": "vertex_major",
                         "dirty_window": False},
    ),
    planner.Plan(
        name="sweep-sm", entry="fanout", priority=110,
        qualify=_qual_sweep_sm,
        build=lambda ctx: ctx.backend._plan_build_sweep_sm(ctx),
        price_routes=("sweep-sm",),
        force_overrides={"fanout_layout": "source_major",
                         "dirty_window": False},
    ),
]


def _qual_sssp_bucket(ctx) -> tuple[bool, str]:
    if not ctx.backend._use_bucket(ctx.dgraph):
        return False, ("bucket gate declined (the port's CUDA gate keeps "
                       "'auto' off; True forces)")
    if ctx.source is None and ctx.backend.config.bucket is not True:
        # An auto bucket skips the virtual-source pass: every vertex
        # starts active, so bucketing degrades to full sweeps.
        return False, "virtual-source pass (every vertex starts active)"
    return True, "bucket=True forces delta-stepping"


def _fail_sssp_edge_sharded(be, ctx) -> None:
    # An OOM re-raises (the solver's retry path owns it), as does any
    # failure on a CUDA mesh; on CPU ranks an auto edge shard is disabled
    # for this backend instance and the next plan serves the solve.
    exc = sys.exc_info()[1]
    if exc is not None and (resilience.is_oom_error(exc)
                            or be.device.type == "cuda"):
        raise
    be._auto_route_failed(
        "_edge_shard_disabled", "edge-sharded Bellman-Ford failed "
        "(collective failure); falling back to single-device sweeps for "
        "this backend instance", forced=be.config.edge_shard is True)


def _fail_sssp_bucket(be, ctx) -> None:
    be._auto_route_failed(
        "_bucket_disabled", "bucketed delta-stepping route failed on this "
        "platform; falling back to the gather routes for this backend "
        "instance", forced=be.config.bucket is True)


SSSP_PLANS = [
    planner.Plan(
        name="edge-sharded", entry="sssp", priority=10,
        qualify=lambda ctx: (
            (True, f"edge list sharded over the "
                   f"{ctx.backend._edge_mesh().describe()}")
            if ctx.backend._use_edge_shard(ctx.dgraph)
            else (False, "single device or frontier-family graph")),
        build=lambda ctx: ctx.backend._sssp_build_edge_sharded(ctx),
        failure=_fail_sssp_edge_sharded,
        forced=lambda cfg: cfg.edge_shard is True,
        force_overrides={"edge_shard": True},
    ),
    planner.Plan(
        name="dia", entry="sssp", priority=20,
        qualify=lambda ctx: (
            (True, "diagonal labeling qualifies")
            if ctx.backend._use_dia(ctx.dgraph)
            else (False, "dia gate declined (the port's CUDA gate keeps "
                         "'auto' off)")),
        build=lambda ctx: ctx.backend._sssp_build_dia(ctx),
        failure=_fail_dia, price_routes=("dia",),
        forced=lambda cfg: cfg.dia is True, force_overrides={"dia": True},
    ),
    planner.Plan(
        name="bucket", entry="sssp", priority=30, qualify=_qual_sssp_bucket,
        build=lambda ctx: ctx.backend._sssp_build_bucket(ctx),
        failure=_fail_sssp_bucket, price_routes=("bucket", "bucket+sweep"),
        forced=lambda cfg: cfg.bucket is True,
        force_overrides={"bucket": True}, tunables=("delta",),
    ),
    planner.Plan(
        name="gs", entry="sssp", priority=40,
        qualify=lambda ctx: (
            (True, "gauss_seidel=True forces blocked GS")
            if ctx.backend._use_gs(ctx.dgraph)
            else (False, "gs gate declined (the port's CUDA gate keeps "
                         "'auto' off)")),
        build=lambda ctx: ctx.backend._sssp_build_gs(ctx),
        failure=_fail_gs, price_routes=("gs", "gs+dw"),
        forced=lambda cfg: cfg.gauss_seidel is True,
        force_overrides={"gauss_seidel": True},
    ),
    planner.Plan(
        name="frontier", entry="sssp", priority=50,
        qualify=lambda ctx: (
            (True, "low-degree family (compacted frontier)")
            if ctx.backend._use_frontier(ctx.dgraph)
            else (False, "frontier gate declined")),
        build=lambda ctx: ctx.backend._sssp_build_frontier(ctx),
        price_routes=("frontier",), forced=lambda cfg: cfg.frontier is True,
        force_overrides={"frontier": True},
    ),
    planner.Plan(
        name="sweep", entry="sssp", priority=60,
        qualify=lambda ctx: (True, "unconditional full-sweep fallback"),
        build=lambda ctx: ctx.backend._sssp_build_sweep(ctx),
        price_routes=("sweep",),
    ),
]


register_backend("torch", TorchBackend)
