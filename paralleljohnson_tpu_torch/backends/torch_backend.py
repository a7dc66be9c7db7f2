"""``TorchBackend`` — the device execution engine of the PyTorch port.

Owns the device-resident COO buffers and dispatches the kernels of
Johnson's algorithm with the JAX package's gates and route tags:

  - ``bellman_ford`` (B=1: phase 1's virtual-source pass and ``sssp``)
    walks the reference's SSSP plans in their order: ``dia``
    (``dia=True`` on a diagonal labeling, ``ops.dia``), ``bucket``
    (``bucket=True``, ``ops.bucket``; ``bucket+sweep`` when its step
    budget runs out), ``gs`` (``gauss_seidel=True``,
    ``ops.gauss_seidel``), ``frontier`` (the low-degree family: V >= 512
    and max out-degree in 1..32, or ``frontier=True``;
    ``relax.bellman_ford_frontier``), else ``sweep``
    (``relax.bellman_ford_sweeps``). All plain PyTorch: the reference's
    are XLA code, not Pallas kernels. The auto gates of ``dia``, ``gs``
    and ``bucket`` are TPU-only in the reference, so they stay off here;
    ``True`` forces them;
  - ``multi_source`` takes, in the reference's plan order: ``dia`` and
    ``gs`` when forced (as above); blocked Floyd-Warshall ``fw`` /
    ``fw-tile`` (``_use_fw``: the squaring regime 2B >= V of a dense
    graph within ``fw_threshold`` where the exact MAC counts beat
    squaring, on every device as in the reference, or ``fw=True``;
    ``ops.fw``: the hand Kleene and min-plus kernels on the card); dense
    graphs
    (``_use_dense``: V <= ``dense_threshold`` and E >=
    ``dense_min_density`` x V^2) to ``dense-{regime}-pallas`` through the
    hand min-plus kernel (the iterate regime through
    ``minplus_fixpoint`` on the card), or to the plain product
    ``dense-{regime}`` under ``use_pallas=False``; then
    ``fanout_layout="source_major"`` to ``sweep-sm`` (the source-major
    scatter sweep); then ``use_pallas=False`` to the reference's XLA
    vertex-major routes in plain PyTorch, ``vm-blocked`` for V >
    ``VM_BLOCK`` and ``vm`` below; and every other graph to
    ``pallas-vm`` through the hand fan-out sweep;
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

``SolverConfig(convergence=True)`` records the per-iteration trajectory
counters (``observe.convergence``) on the routes the reference
instruments: ``sweep``, ``sweep-sm``, ``vm``, ``vm-blocked``, ``dia``,
``gs`` and ``bucket``.

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

from paralleljohnson_tpu_torch.backends.base import (
    Backend,
    KernelResult,
    register_backend,
)
from paralleljohnson_tpu_torch.config import DEFAULT_PIPELINE_DEPTH
from paralleljohnson_tpu_torch.graphs import CSRGraph
from paralleljohnson_tpu_torch.observe import convergence as conv
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
from paralleljohnson_tpu_torch.utils.metrics import (
    warn_if_counter_wrapped,
    warn_if_traj_counter_wrapped,
)

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
        self._copy_stream = None  # side stream of stage_rows_async

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
        ``DEFAULT_PIPELINE_DEPTH``. The solver resolves this same function
        for its window, so the window and the memory budget agree."""
        return max(1, int(self.config.pipeline_depth or DEFAULT_PIPELINE_DEPTH))

    def suggested_source_batch(self, dgraph: TorchDeviceGraph,
                               with_pred: bool = False) -> int:
        """Cap the [B, V] distance block to the memory budget: half the
        card's free memory (``torch.cuda.mem_get_info``, which counts the
        caching allocator's cached blocks as used), or a 4 GB constant on
        the CPU, over ``BATCH_BLOCKS`` blocks (``PRED_BATCH_BLOCKS`` with
        predecessors) plus the pipeline's carry slots and, on the card,
        the sweep's scratch rows (sparse route; tight_pred's partial keys
        with predecessors) or the min-plus split-K partials (dense
        route)."""
        v = max(dgraph.num_nodes, 1)
        itemsize = torch.empty((), dtype=self._dtype).element_size()
        blocks = PRED_BATCH_BLOCKS if with_pred else BATCH_BLOCKS
        carry_slots = self._pipeline_depth(dgraph) - 1
        blocks += carry_slots * (2 if with_pred else 1)
        rows = blocks * v
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            budget = free // 2
            if self._use_dense(dgraph):
                rows += MAX_SPLITS * v  # the min-plus split-K partials
            else:
                # The sweep's f32 partial minima; with predecessors,
                # tight_pred's int64 partial keys after them (two rows).
                rows += dgraph.work_items().n_split * (2 if with_pred else 1)
        else:
            budget = CPU_BUDGET_BYTES
        b = budget // (rows * itemsize)
        return int(max(1, min(b, 1 << 16)))

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

    # -- convergence trajectory ---------------------------------------------

    def _traj_cap(self) -> int | None:
        """Trajectory buffer rows for this solve, or None when nothing is
        recorded: ``convergence=True`` records. The reference's ``"auto"``
        records when a telemetry sink or a profile store can consume the
        trajectory; the port has neither, so ``"auto"`` records nothing."""
        return conv.DEFAULT_TRAJ_CAP if self.config.convergence is True else None

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
        twin under ``convergence=True``: (dist, iterations, improving,
        trajectory buffers or None)."""
        cap = self._traj_cap()
        if cap is None:
            return (*relax._sweeps_to_fixpoint(sweep, dist0, max_iter), None)
        d, i, improving, counts, resid = conv.instrumented_fixpoint(
            sweep, dist0, max_iter=max_iter, cap=cap, batch_axis=batch_axis)
        return d, i, improving, (counts, resid)

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
    # TPU; here, as off-TPU there, "auto" declines and True forces. (So
    # the reference's _qual_sssp_bucket, which keeps an auto bucket off
    # the virtual-source pass, has nothing left to decide, and
    # _contract_dia / _contract_gs guard an edges mesh axis the port
    # does not have.)

    def _use_gs(self, dgraph: TorchDeviceGraph) -> bool:
        return self.config.gauss_seidel is True and dgraph.host_graph is not None

    def _use_dia(self, dgraph: TorchDeviceGraph) -> bool:
        """``dia=True`` on a labeling the DIA layout accepts; a labeling it
        rejects falls through to the next route, as in the reference."""
        return self.config.dia is True and self.dia_bundle(dgraph) is not None

    def dia_bundle(self, dgraph: TorchDeviceGraph) -> dict | None:
        return dgraph.dia_layout(self.config.dia_max_offsets)

    def _use_bucket(self, dgraph: TorchDeviceGraph) -> bool:
        return self.config.bucket is True

    def _bucket_delta(self, dgraph: TorchDeviceGraph) -> float:
        """The bucket width: ``SolverConfig.delta``, else ``auto_delta``
        from the mean |weight| of the CURRENT weights (two reductions,
        cached until the next reweight)."""
        if self.config.delta is not None:
            return float(self.config.delta)
        cached = dgraph._by_dst_cache.get("bucket_delta")
        if cached is None:
            w = dgraph.weights
            finite = torch.isfinite(w)
            mean_w = float(
                torch.where(finite, w.abs(), torch.zeros_like(w)).sum()
                / finite.sum().clamp_min(1))
            cached = auto_delta(mean_w, dgraph.num_nodes,
                                dgraph.num_real_edges)
            dgraph._by_dst_cache["bucket_delta"] = cached
        return cached

    def bellman_ford(self, dgraph: TorchDeviceGraph,
                     source: int | None) -> KernelResult:
        """B=1 Bellman-Ford; ``source=None`` is the virtual-source pass
        (dist0 = 0 everywhere). The first route whose gate takes the
        graph runs it, in the reference's plan order (see the module
        docstring); ``sweep`` takes the rest."""
        v = dgraph.num_nodes
        if source is None:
            dist0 = torch.zeros(v, dtype=self._dtype, device=self.device)
        else:
            dist0 = torch.full((v,), float("inf"), dtype=self._dtype,
                               device=self.device)
            dist0[source] = 0.0
        max_iter = self.config.max_iterations or v
        chunk = relax.edge_chunk_for(1, dgraph.src.shape[0])
        for gate, build in ((self._use_dia, self._sssp_build_dia),
                            (self._use_bucket, self._sssp_build_bucket),
                            (self._use_gs, self._sssp_build_gs),
                            (self._use_frontier, self._sssp_build_frontier)):
            if gate(dgraph):
                return build(dgraph, source, dist0, max_iter, chunk)
        return self._sssp_build_sweep(dgraph, source, dist0, max_iter, chunk)

    def _sssp_build_dia(self, dgraph, source, dist0, max_iter, chunk):
        lay = self.dia_bundle(dgraph)
        dist, iters, improving, traj = self._fixpoint(
            lambda d: dia_sweep(d, lay["w_diag"], offsets=lay["offsets"]),
            dist0, max_iter, None)
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
        if traj is not None:
            self._attach_trajectory(res, *traj, dgraph)
        return res

    def _sssp_build_bucket(self, dgraph, source, dist0, max_iter, chunk):
        v = dgraph.num_nodes
        cap = self._traj_cap()
        # A generous step budget: converging solves take ~hop-diameter
        # steps; exhausting it hands the distances to the full sweep,
        # which finishes and certifies negative cycles.
        dist, steps, busy, examined, *traj = bellman_ford_bucketed(
            dist0, dgraph.src, dgraph.dst, dgraph.weights,
            dgraph.indptr_dev(), self._bucket_delta(dgraph),
            max_steps=2 * max_iter + 64,
            capacity=auto_capacity(v, dgraph.max_degree),
            max_degree=dgraph.max_degree,
            num_real_edges=dgraph.num_real_edges, edge_chunk=chunk,
            traj_cap=cap,
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
                max_iter=max_iter, edge_chunk=chunk)
            res = KernelResult(
                dist=dist,
                negative_cycle=improving and max_iter >= v,
                converged=not improving,
                iterations=steps + it2,
                edges_relaxed=examined + it2 * dgraph.num_real_edges,
                route="bucket+sweep",
            )
        if traj:
            # The trajectory covers the bucket steps only.
            self._attach_trajectory(res, *traj, dgraph, iterations=steps)
        return res

    def _sssp_build_gs(self, dgraph, source, dist0, max_iter, chunk):
        v = dgraph.num_nodes
        lay = dgraph.gs_layout(self.config.gs_block_size)
        dist0_gs = torch.full((lay["v_pad"],), float("inf"),
                              dtype=self._dtype, device=self.device)
        if source is None:
            dist0_gs[:v] = 0.0  # every real vertex; pads stay +inf
        else:
            dist0_gs[int(lay["rank_host"][source])] = 0.0
        inner_cap = self.config.gs_inner_cap
        dist, rounds, improving, iters_blk, *traj = sssp_gs_blocks(
            dist0_gs, lay["src_blk"], lay["dstl_blk"], lay["w_blk"],
            vb=lay["vb"], halo=lay["halo"], max_outer=max_iter,
            inner_cap=inner_cap, traj_cap=self._traj_cap(),
        )
        res = KernelResult(
            dist=dist[lay["rank"].long()],
            negative_cycle=improving and max_iter >= v,
            converged=not improving,
            iterations=rounds,
            edges_relaxed=_gs_examined_exact(
                iters_blk, lay["real_edges_host"], 1, rounds=rounds,
                inner_cap=inner_cap),
            route="gs",
        )
        if traj:
            self._attach_trajectory(res, *traj, dgraph)
        return res

    def _sssp_build_frontier(self, dgraph, source, dist0, max_iter, chunk):
        dist, iters, improving, examined = relax.bellman_ford_frontier(
            dist0, dgraph.src, dgraph.dst, dgraph.weights,
            dgraph.indptr_dev(), max_iter=max_iter,
            capacity=self._frontier_capacity(dgraph),
            max_degree=dgraph.max_degree,
            num_real_edges=dgraph.num_real_edges, edge_chunk=chunk,
        )
        return KernelResult(
            dist=dist,
            negative_cycle=improving and max_iter >= dgraph.num_nodes,
            converged=not improving,
            iterations=iters,
            edges_relaxed=relax.examined_exact(examined),
            route="frontier",
        )

    def _sssp_build_sweep(self, dgraph, source, dist0, max_iter, chunk):
        dist, iters, improving, traj = self._fixpoint(
            lambda d: relax.relax_sweep(d, dgraph.src, dgraph.dst,
                                        dgraph.weights, edge_chunk=chunk),
            dist0, max_iter, None)
        res = KernelResult(
            dist=dist,
            negative_cycle=improving and max_iter >= dgraph.num_nodes,
            converged=not improving,
            iterations=iters,
            edges_relaxed=iters * dgraph.num_real_edges,
            route="sweep",
        )
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

    def _fw_tile(self, dgraph: TorchDeviceGraph) -> int:
        """The FW tile before ``effective_tile`` shrinks it to small
        graphs: an explicit ``config.fw_tile``, else ``DEFAULT_FW_TILE``.
        The reference also consults a profile-tuned value and so caches
        the result per device graph, to keep its gate and its build in
        agreement; without a profile store both read the config."""
        return int(self.config.fw_tile or fw_ops.DEFAULT_FW_TILE)

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
        tile = fw_ops.effective_tile(v, self._fw_tile(dgraph))
        fw_macs = fw_ops.fw_mac_count(fw_ops.pad_tiles(v, tile), tile)
        return fw_macs < relax.squaring_steps(v) * per_iter

    def _fail_fw(self) -> None:
        """The fw build raised (call from the active ``except`` block):
        a forced ``fw=True`` propagates; ``"auto"`` warns once, disables
        fw for this backend instance and lets the walk fall through to
        the dense and sparse routes (the reference's ``_fail_fw``)."""
        if self.config.fw is True:
            raise
        if not getattr(self, "_fw_disabled", False):
            self._fw_disabled = True
            warnings.warn(
                "blocked Floyd-Warshall route failed on this platform; "
                "falling back to the dense/sparse routes for this backend "
                "instance", RuntimeWarning, stacklevel=3)
            traceback.print_exc(file=sys.stderr)

    def _plan_build_fw(self, dgraph: TorchDeviceGraph,
                       sources: torch.Tensor) -> KernelResult:
        """Blocked min-plus Floyd-Warshall: route ``fw`` when the padded
        graph is one tile, else ``fw-tile``; ``iterations`` is the number
        of k-steps and ``edges_relaxed`` the exact tropical MACs. The
        closure is recomputed for every source batch, as in the
        reference."""
        v = dgraph.num_nodes
        tile = fw_ops.effective_tile(v, self._fw_tile(dgraph))
        vp = fw_ops.pad_tiles(v, tile)
        dist, neg = _fw_apsp_kernel(
            sources, dgraph.src, dgraph.dst, dgraph.weights, num_nodes=v,
            tile=tile, dtype=self._dtype)
        return KernelResult(
            dist=dist,
            negative_cycle=neg,
            converged=not neg,
            iterations=vp // tile,
            edges_relaxed=fw_ops.fw_mac_count(vp, tile),
            route="fw" if vp == tile else "fw-tile",
        )

    def multi_source(self, dgraph: TorchDeviceGraph,
                     sources: np.ndarray) -> KernelResult:
        return self._fanout(dgraph, sources)[0]

    def _vm_lay_chunk(self, dgraph: TorchDeviceGraph, b: int) -> int:
        """The vm-blocked layout's chunk: the reference's rule, from the
        batch rounded up to a power of two so ragged last batches reuse
        the layout."""
        return relax.edge_chunk_for(1 << max(0, b - 1).bit_length(),
                                    dgraph.src.shape[0])

    def _fanout(self, dgraph: TorchDeviceGraph, sources: np.ndarray):
        """The fan-out on the route the config and the graph select (see
        the module docstring). Returns (KernelResult with dist [B, V], the
        vertex-major [V, B] block the route converged, or None for the
        fw, dense and source-major routes)."""
        sources = torch.as_tensor(np.asarray(sources), dtype=torch.int64)
        sources = sources.to(self.device)
        b = int(sources.shape[0])
        v = dgraph.num_nodes
        max_iter = self.config.max_iterations or v
        hand = self.config.use_pallas is not False
        if self._use_dia(dgraph):
            return self._plan_build_dia(dgraph, sources, max_iter), None
        if self._use_gs(dgraph):
            return self._plan_build_gs(dgraph, sources, max_iter), None
        if self._use_fw(dgraph, b):
            try:
                return self._plan_build_fw(dgraph, sources), None
            except Exception:  # noqa: BLE001 — auto degrades, forced raises
                self._fail_fw()
        if self._use_dense(dgraph):
            a = relax.dense_adjacency(
                dgraph.src, dgraph.dst, dgraph.weights, v, dtype=self._dtype
            )
            fixpoint = (minplus_fixpoint
                        if hand and self.device.type == "cuda" else None)
            dist, iters, improving = relax.dense_fanout(
                a, sources, max_iter=max_iter,
                mp=minplus_kernel if hand else relax.minplus,
                fixpoint=fixpoint,
            )
            regime, work_per_iter = relax.dense_fanout_regime(v, b)
            return KernelResult(
                dist=dist,
                converged=not improving,
                iterations=iters,
                edges_relaxed=iters * work_per_iter,
                route=f"dense-{regime}" + ("-pallas" if hand else ""),
            ), None
        chunk = relax.edge_chunk_for(b, dgraph.src.shape[0])
        if self.config.fanout_layout == "source_major":
            src, dst, w = dgraph.src, dgraph.dst, dgraph.weights
            dist, iters, improving, traj = self._fixpoint(
                lambda d: relax.relax_sweep(d, src, dst, w, edge_chunk=chunk),
                relax.multi_source_init(sources, v, self._dtype), max_iter, 0)
            res = self._sweep_result(dgraph, dist, iters, improving, b,
                                     "sweep-sm")
            dist_vm = None
        elif not hand and v > VM_BLOCK:
            lay = dgraph.vm_blocked_layout(VM_BLOCK,
                                           self._vm_lay_chunk(dgraph, b))
            # Pad rows are +inf and never improve: the counts stay exact.
            dist_vm, iters, improving, traj = self._fixpoint(
                lambda d: relax.relax_sweep_vm_blocked(
                    d, lay["src_ck"], lay["dstl_ck"], lay["w_ck"],
                    lay["base_ck"], vb=lay["vb"]),
                self._dist0_vm(lay["v_pad"], sources), max_iter, 1)
            dist_vm, route = dist_vm[:v], "vm-blocked"
        elif not hand:
            src, dst, w = dgraph.vm_edges()
            dist_vm, iters, improving, traj = self._fixpoint(
                lambda d: relax.relax_sweep_vm(d, src, dst, w,
                                               edge_chunk=chunk),
                self._dist0_vm(v, sources), max_iter, 1)
            route = "vm"
        else:
            (indptr_in, src_in, w_in), items = dgraph.fanout_layout()
            dist_vm, iters, improving = fanout_fixpoint(
                self._dist0_vm(v, sources), indptr_in, src_in, w_in,
                max_iter=max_iter, items=items,
            )
            route, traj = "pallas-vm", None
        if dist_vm is not None:
            res = self._sweep_result(dgraph, dist_vm.t().contiguous(), iters,
                                     improving, b, route)
        if traj is not None:
            self._attach_trajectory(res, *traj, dgraph, batch=b)
        return res, dist_vm

    def _plan_build_dia(self, dgraph, sources, max_iter) -> KernelResult:
        """The DIA stencil fan-out over [B, V] distances: every sweep is K
        contiguous roll + add + min passes."""
        lay = self.dia_bundle(dgraph)
        b = int(sources.shape[0])
        dist, iters, improving, traj = self._fixpoint(
            lambda d: dia_sweep(d, lay["w_diag"], offsets=lay["offsets"]),
            relax.multi_source_init(sources, dgraph.num_nodes, self._dtype),
            max_iter, 0)
        res = KernelResult(dist=dist, converged=not improving,
                           iterations=iters,
                           edges_relaxed=iters * lay["num_entries"] * b,
                           route="dia")
        if traj is not None:
            self._attach_trajectory(res, *traj, dgraph, batch=b)
        return res

    def _plan_build_gs(self, dgraph, sources, max_iter) -> KernelResult:
        """The blocked Gauss-Seidel fan-out (vertex-major, relabeled ids),
        rows mapped back to the original labels."""
        lay = dgraph.gs_layout(self.config.gs_block_size)
        b = int(sources.shape[0])
        inner_cap = self.config.gs_inner_cap
        dist, rounds, improving, iters_blk, *traj = fanout_gs_body(
            sources, lay["src_blk"], lay["dstl_blk"], lay["w_blk"],
            lay["rank"], v_pad=lay["v_pad"], vb=lay["vb"], halo=lay["halo"],
            max_outer=max_iter, inner_cap=inner_cap,
            traj_cap=self._traj_cap(),
        )
        res = KernelResult(
            dist=dist, converged=not improving, iterations=rounds,
            edges_relaxed=_gs_examined_exact(
                iters_blk, lay["real_edges_host"], b, rounds=rounds,
                inner_cap=inner_cap),
            route="gs",
        )
        if traj:
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
                res.route = f"{res.route}+pred"
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
            if dist_vm is None:
                dist_vm = res.dist.t().contiguous()
            pred, ok = self._extract(dgraph, dist_vm, res.dist, sources)
            del dist_vm
            if ok:
                res.pred = pred
                res.route = f"{res.route}+pred"
                res.edges_relaxed += len(sources) * dgraph.num_real_edges
                return res
            self._pred_fallback(
                "the tree check rejected the one-pass extraction "
                "(zero-weight tight cycle on a shortest path)"
            )
        return self._multi_source_pred_sweep(dgraph, sources)

    def _multi_source_pred_sweep(self, dgraph: TorchDeviceGraph,
                                 sources: np.ndarray) -> KernelResult:
        """The argmin-carrying fan-out (route ``pred-sweep``)."""
        sources = torch.as_tensor(np.asarray(sources), dtype=torch.int64)
        sources = sources.to(self.device)
        b = int(sources.shape[0])
        v = dgraph.num_nodes
        dist, pred, iters, improving = relax.bellman_ford_sweeps_pred(
            relax.multi_source_init(sources, v, self._dtype),
            dgraph.src, dgraph.dst, dgraph.weights,
            max_iter=self.config.max_iterations or v,
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


register_backend("torch", TorchBackend)
