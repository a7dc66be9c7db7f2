"""``TorchBackend`` — the device execution engine of the PyTorch port.

Owns the device-resident COO buffers and dispatches the two kernels of
Johnson's algorithm with the JAX package's own gates and route tags:

  - ``bellman_ford`` runs route ``sweep`` (``relax.bellman_ford_sweeps``,
    plain PyTorch: the reference's is XLA code, not a Pallas kernel);
  - ``multi_source`` sends dense graphs (``_use_dense``: V <=
    ``dense_threshold`` and E >= ``dense_min_density`` x V^2) to
    ``dense-{regime}-pallas`` through the hand min-plus kernel, and every
    other graph to ``pallas-vm`` through the hand fan-out sweep.

On a CUDA device the hand kernels are the main path; on the CPU their
plain PyTorch versions run (the wrappers choose by the tensors' device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from paralleljohnson_tpu_torch.backends.base import (
    Backend,
    KernelResult,
    register_backend,
)
from paralleljohnson_tpu_torch.graphs import CSRGraph
from paralleljohnson_tpu_torch.ops import relax
from paralleljohnson_tpu_torch.ops.fanout_sweep import (
    build_in_edge_layout,
    fanout_fixpoint,
)
from paralleljohnson_tpu_torch.ops.minplus import minplus_kernel

# Distance blocks of [B, V] the source batch is budgeted for: the
# reference's six. The sweep's two alternating [V, B] buffers, the
# transposed [B, V] result and the un-reweight's two temporaries fit.
BATCH_BLOCKS = 6
# Memory budget of one fan-out call on the CPU (the reference's constant).
CPU_BUDGET_BYTES = 4 << 30


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


@dataclasses.dataclass(frozen=True)
class TorchDeviceGraph:
    """Device-resident COO buffers (padded edges are (0, 0, +inf) no-ops)
    plus cached layouts.

    ``_struct_cache`` holds weight-independent structure (the in-edge CSC
    and its sort permutation) and survives :meth:`TorchBackend.reweight`;
    ``_by_dst_cache`` holds what is gathered from the current weights and
    is dropped by it.
    """

    src: torch.Tensor      # int32[E_pad]
    dst: torch.Tensor      # int32[E_pad]
    weights: torch.Tensor  # f32[E_pad]
    indptr: np.ndarray     # host int32[V+1]
    num_nodes: int
    num_real_edges: int
    _by_dst_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )
    _struct_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def device(self) -> torch.device:
        return self.weights.device

    def by_dst(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The real edges sorted by destination (stable), as the in-edge
        CSC the fan-out sweep pulls over: (indptr_in int32[V+1], src_in
        int32[E], w_in f32[E]), with ``w_in`` gathered from the CURRENT
        weights."""
        e = self.num_real_edges
        struct = self._struct_cache.get("in_edges")
        if struct is None:
            struct = build_in_edge_layout(
                self.src[:e], self.dst[:e], self.num_nodes
            )
            self._struct_cache["in_edges"] = struct
        w_in = self._by_dst_cache.get("w_in")
        if w_in is None:
            w_in = self.weights[:e][struct["order"]].contiguous()
            self._by_dst_cache["w_in"] = w_in
        return struct["indptr_in"], struct["src_in"], w_in


class TorchBackend(Backend):
    """PyTorch backend: hand CUDA kernels on the card, plain PyTorch on
    the CPU."""

    name = "torch"

    def __init__(self, config=None, device="cuda") -> None:
        super().__init__(config)
        self.device = resolve_device(device)

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

    def suggested_source_batch(self, dgraph: TorchDeviceGraph) -> int:
        """Cap the [B, V] distance block to the memory budget: half the
        card's free memory (``torch.cuda.mem_get_info``), or a 4 GB
        constant on the CPU, over ``BATCH_BLOCKS`` blocks."""
        v = max(dgraph.num_nodes, 1)
        itemsize = torch.empty((), dtype=self._dtype).element_size()
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            budget = free // 2
        else:
            budget = CPU_BUDGET_BYTES
        b = budget // (BATCH_BLOCKS * v * itemsize)
        return int(max(1, min(b, 1 << 16)))

    def bellman_ford(self, dgraph: TorchDeviceGraph,
                     source: int | None) -> KernelResult:
        """B=1 Bellman-Ford on route ``sweep``; ``source=None`` is the
        virtual-source pass (dist0 = 0 everywhere)."""
        v = dgraph.num_nodes
        if source is None:
            dist0 = torch.zeros(v, dtype=self._dtype, device=self.device)
        else:
            dist0 = torch.full((v,), float("inf"), dtype=self._dtype,
                               device=self.device)
            dist0[source] = 0.0
        max_iter = self.config.max_iterations or v
        dist, iters, improving = relax.bellman_ford_sweeps(
            dist0, dgraph.src, dgraph.dst, dgraph.weights,
            max_iter=max_iter,
            edge_chunk=relax.edge_chunk_for(1, dgraph.src.shape[0]),
        )
        return KernelResult(
            dist=dist,
            negative_cycle=improving and max_iter >= v,
            converged=not improving,
            iterations=iters,
            edges_relaxed=iters * dgraph.num_real_edges,
            route="sweep",
        )

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

    def multi_source(self, dgraph: TorchDeviceGraph,
                     sources: np.ndarray) -> KernelResult:
        sources = torch.as_tensor(np.asarray(sources), dtype=torch.int64)
        sources = sources.to(self.device)
        b = int(sources.shape[0])
        v = dgraph.num_nodes
        max_iter = self.config.max_iterations or v
        if self._use_dense(dgraph):
            a = relax.dense_adjacency(
                dgraph.src, dgraph.dst, dgraph.weights, v, dtype=self._dtype
            )
            dist, iters, improving = relax.dense_fanout(
                a, sources, max_iter=max_iter, mp=minplus_kernel,
            )
            regime, work_per_iter = relax.dense_fanout_regime(v, b)
            return KernelResult(
                dist=dist,
                converged=not improving,
                iterations=iters,
                edges_relaxed=iters * work_per_iter,
                route=f"dense-{regime}-pallas",
            )
        indptr_in, src_in, w_in = dgraph.by_dst()
        dist0 = torch.full((v, b), float("inf"), dtype=self._dtype,
                           device=self.device)
        dist0[sources, torch.arange(b, device=self.device)] = 0.0
        dist_vm, iters, improving = fanout_fixpoint(
            dist0, indptr_in, src_in, w_in, max_iter=max_iter
        )
        return KernelResult(
            dist=dist_vm.t().contiguous(),
            converged=not improving,
            iterations=iters,
            edges_relaxed=iters * b * dgraph.num_real_edges,
            route="pallas-vm",
        )


register_backend("torch", TorchBackend)
