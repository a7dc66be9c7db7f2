"""Batched fan-out sweep: the hand CUDA kernel, its plain version, the
in-edge layout with its work items, and the fixpoint loop.

The counterpart of the JAX package's ``ops/pallas_sweep.py``
(``pallas_fanout_sweep`` / ``pallas_fanout``). One sweep is the Jacobi
relaxation of the vertex-major distance block ``dist[V, B]``:

    new[v, b] = min(old[v, b], min over edges u->v of old[u, b] + w)

with every candidate read from ``old``. The reference bucketed edges by
(dst block, src block) to keep [vb, B] blocks in VMEM; this port pulls
over destination-sorted in-edges (a CSC: ``indptr_in``, ``src_in``,
``w_in``) instead. On the card (``csrc/fanout_sweep.cu``) the CSC is cut
into edge-balanced work items of at most ``ITEM_EDGES`` in-edges, one warp
each: a row of at most that many in-edges is one item, a longer row is
cut into pieces whose partial minima a second pass combines. Both
compute the same sweep, so the fixpoint and its iteration count agree
with ``pallas_fanout``.

At f64 the kernel also takes per-edge hub flags (:func:`hub_flags`):
the edges whose source is one of the few with the most out-edges, whose
rows it keeps in the card's L2 while the rest of the sweep streams past.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from paralleljohnson_tpu_torch.ops import _cuda, bump
from paralleljohnson_tpu_torch.ops.relax import edge_chunk_for
from paralleljohnson_tpu_torch.utils.metrics import Span, program_span

# L: the most in-edges one work item (one warp) takes. Chosen on the card
# from 128, 256, 512 and 1024 (the times are in PERF.md).
ITEM_EDGES = 512
# K: sweeps launched per host read of their flags in fanout_fixpoint.
SWEEPS_PER_SYNC = 16
# int32 words between two sweeps' flags: one 128-byte cache line.
FLAG_STRIDE = 32
# The f64 sweep's hub rows: the L2 bytes their slices, one pass wide, may
# fill (of the H100's 50 MB; tuned on the card, PERF.md), and the least
# out-degree a hub has: at least HUB_MIN_OUT_DEGREE and HUB_SKEW times
# the mean, so that a graph without skew (a grid, a uniform random
# graph) has none.
HUB_L2_BYTES = 24 << 20
HUB_MIN_OUT_DEGREE = 16
HUB_SKEW = 4
# ``hubs=AUTO``: the fixpoints build each chunk's hub flags themselves.
AUTO = "auto"


class WorkItems(NamedTuple):
    """Edge-balanced work items of an in-edge CSC (weight-independent).

    Every row with at most ``item_edges`` in-edges is one item, taken by
    its row number. A longer row is split into pieces of ``item_edges``
    edges (its last piece the remainder), listed in ``pieces``
    int32[n_split, 3] as (row, first edge, end edge), rows ascending, each
    row's pieces back to back; the kernel takes them first, and piece k
    writes row k of the partial-minimum scratch. ``split_rows`` int32[R]
    lists the split rows and ``split_ptr`` int32[R+1] their piece
    ranges."""

    pieces: torch.Tensor
    split_rows: torch.Tensor
    split_ptr: torch.Tensor
    item_edges: int

    @property
    def n_split(self) -> int:
        """Pieces of split rows: the scratch's row count."""
        return self.pieces.shape[0]


def build_work_items(indptr_in, item_edges: int = ITEM_EDGES) -> WorkItems:
    """The work items of a CSC, on ``indptr_in``'s device."""
    if item_edges < 1:
        raise ValueError(f"item_edges must be >= 1, got {item_edges}")
    dev = indptr_in.device
    indptr = indptr_in.long()
    deg = indptr[1:] - indptr[:-1]
    split = deg > item_edges
    split_rows = torch.nonzero(split).flatten()
    pieces = (deg[split_rows] + item_edges - 1) // item_edges
    split_ptr = torch.zeros(split_rows.shape[0] + 1, dtype=torch.int64,
                            device=dev)
    torch.cumsum(pieces, 0, out=split_ptr[1:])
    n_split = int(split_ptr[-1])
    row_s = torch.repeat_interleave(split_rows, pieces, output_size=n_split)
    piece = (torch.arange(n_split, device=dev)
             - torch.repeat_interleave(split_ptr[:-1], pieces,
                                       output_size=n_split))
    first_s = indptr[row_s] + piece * item_edges
    end_s = torch.minimum(first_s + item_edges, indptr[row_s + 1])
    pieces = torch.stack([row_s, first_s, end_s], 1).to(torch.int32)
    return WorkItems(pieces.contiguous(), split_rows.to(torch.int32),
                     split_ptr.to(torch.int32), item_edges)


def build_in_edge_layout(src, dst, num_nodes: int):
    """Weight-independent CSC structure of an edge list, on the edges'
    device: ``indptr_in`` int32[V+1], ``src_in`` int32[E], ``order``
    int64[E], the stable dst-sort permutation (``w_in = w[order]``), and
    ``work_items``, the kernel's :class:`WorkItems` at ``ITEM_EDGES``.

    Pass real edges only (no padding tail)."""
    e = src.shape[0]
    if e >= 1 << 31:
        raise ValueError(f"{e} edges exceed the kernel's int32 offsets")
    order = torch.argsort(dst, stable=True)
    counts = torch.bincount(dst.long(), minlength=num_nodes)
    indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dst.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return {
        "indptr_in": indptr.to(torch.int32),
        "src_in": src[order].to(torch.int32).contiguous(),
        "order": order,
        "work_items": build_work_items(indptr),
    }


def pass_columns(b: int, itemsize: int, *, hubs: bool = False) -> int:
    """Columns of one pass of the sweep kernel at width ``b``: 32 lanes x
    NV 16-byte vectors of ``16 // itemsize`` values, NV = 1, 2 or 4 by
    ``b``, and at most 2 for the f64 kernel with hub flags (``plan`` in
    ``csrc/fanout_sweep.cu``)."""
    lane = 32 * (16 // itemsize)
    widest = 2 if hubs and itemsize == 8 else 4
    return next((lane * nv for nv in (1, 2) if b <= lane * nv), widest * lane)


def hub_sources(out_degree, row_bytes: int, *, budget: int = HUB_L2_BYTES,
                min_degree: int | None = None):
    """The sources whose rows the f64 sweep keeps in L2: int64 vertex ids
    in descending out-degree, ties by ascending id, as many as
    ``budget // row_bytes``, none below ``min_degree`` out-edges (by
    default the larger of ``HUB_MIN_OUT_DEGREE`` and ``HUB_SKEW`` times
    the mean). ``out_degree`` is [V], on any device."""
    deg = out_degree.long()
    if min_degree is None:
        mean = float(deg.sum()) / max(1, deg.shape[0])
        min_degree = max(HUB_MIN_OUT_DEGREE, math.ceil(HUB_SKEW * mean))
    # Stable, so equal degrees keep ascending ids.
    order = torch.argsort(-deg, stable=True)[:max(0, budget // row_bytes)]
    return order[deg[order] >= min_degree]


def hub_row_bytes(b: int) -> int:
    """Bytes of one hub row's slice in one pass of the f64 kernel with hub
    flags at width ``b``: what a hub holds of the L2 at a time."""
    return min(b, pass_columns(b, 8, hubs=True)) * 8


def hub_flags(src_in, num_nodes: int, b: int, dtype: torch.dtype, *,
              budget: int = HUB_L2_BYTES):
    """The f64 sweep's per-edge hub flags over an in-edge CSC: uint8[E],
    1 where ``src_in[e]`` is one of :func:`hub_sources` for rows one pass
    (:func:`hub_row_bytes`) of width ``b`` wide, on ``src_in``'s device.
    None at f32, where the sweep takes no flags, and when no source
    qualifies: the f64 kernel then loads as the f32 one does."""
    if dtype != torch.float64:
        return None
    row_bytes = hub_row_bytes(b)
    s = src_in.long()
    hubs = hub_sources(torch.bincount(s, minlength=num_nodes), row_bytes,
                       budget=budget)
    if hubs.numel() == 0:
        return None
    is_hub = torch.zeros(num_nodes, dtype=torch.uint8, device=src_in.device)
    is_hub[hubs] = 1
    return is_hub[s]


def fanout_sweep_plain(dist, indptr_in, src_in, w_in):
    """One Jacobi sweep in plain PyTorch: ``index_select`` of the source
    rows plus ``scatter_reduce("amin", include_self=True)`` into a copy of
    ``dist``, chunked over edges so the [E_chunk, B] candidate block stays
    near 2^26 elements. Returns (new dist, improved) with ``improved`` a
    bool tensor."""
    v, b = dist.shape
    e = src_in.shape[0]
    counts = (indptr_in[1:] - indptr_in[:-1]).long()
    dst_in = torch.repeat_interleave(
        torch.arange(v, device=dist.device), counts, output_size=e
    )
    new = dist.clone()
    step = edge_chunk_for(b, e)
    for lo in range(0, e, step):
        cand = dist.index_select(0, src_in[lo:lo + step].long())
        cand += w_in[lo:lo + step].unsqueeze(1)
        idx = dst_in[lo:lo + step].unsqueeze(1).expand(-1, b)
        new.scatter_reduce_(0, idx, cand, "amin", include_self=True)
    return new, (new < dist).any()


def fanout_sweep(dist, indptr_in, src_in, w_in, *, items=None, out=None,
                 improved=None, prev=None, scratch=None, hubs=None):
    """One Jacobi sweep into ``out``: returns (out, improved).

    ``improved`` is an int32[1] flag set to 1 when an entry dropped
    (allocated zeroed when None; a caller's flag is not reset here).
    ``prev`` is an int32[1] flag: when it holds 0 the sweep is skipped and
    writes nothing (``fanout_fixpoint`` chains sweeps on it).

    CUDA tensors run the hand kernel (``csrc/fanout_sweep.cu``) over
    ``items`` (a :class:`WorkItems`; built from ``indptr_in`` when None),
    in ``dist``'s dtype, f32 or f64 (``w_in``, ``out`` and ``scratch``
    must have it too); ``scratch`` is its [items.n_split, B]
    partial-minimum buffer (allocated when None). At f64, ``hubs`` is
    :func:`hub_flags`'s uint8[E] (None: no hubs, plain loads); at f32 it
    must be None. Each call counts one in
    ``fanout_sweep.launches``: one sweep, which is the items kernel and,
    when the layout has split rows, the combine kernel after it. A sweep
    skipped on ``prev`` launches both all the same (they return at entry)
    and counts too, so ``launches`` can exceed the sweeps a fixpoint
    used by up to ``SWEEPS_PER_SYNC - 1``. CPU tensors run
    :func:`fanout_sweep_plain` and count nothing."""
    dev = dist.device
    if dev.type == "cpu":
        if improved is None:
            improved = torch.zeros(1, dtype=torch.int32)
        if prev is not None and not int(prev[0]):
            return out, improved
        new, imp = fanout_sweep_plain(dist, indptr_in, src_in, w_in)
        out = new if out is None else out.copy_(new)
        if bool(imp):
            improved.fill_(1)
        return out, improved
    if dev.type != "cuda":
        raise ValueError(f"fanout_sweep takes cpu or cuda tensors, got {dev}")
    dt = _cuda.value_type(dist, "dist")
    _cuda.check(dist, "dist", dt, dev, 2)
    _cuda.check(indptr_in, "indptr_in", torch.int32, dev, 1)
    _cuda.check(src_in, "src_in", torch.int32, dev, 1)
    _cuda.check(w_in, "w_in", dt, dev, 1)
    v, b = dist.shape
    if indptr_in.shape[0] != v + 1 or src_in.shape != w_in.shape:
        raise ValueError(
            f"layout does not fit dist[{v}, {b}]: indptr_in "
            f"{tuple(indptr_in.shape)}, src_in {tuple(src_in.shape)}, "
            f"w_in {tuple(w_in.shape)}"
        )
    if items is None:
        items = build_work_items(indptr_in)
    _cuda.check(items.pieces, "items.pieces", torch.int32, dev, 2)
    _cuda.check(items.split_rows, "items.split_rows", torch.int32, dev, 1)
    _cuda.check(items.split_ptr, "items.split_ptr", torch.int32, dev, 1)
    if hubs is not None:
        if dt != torch.float64:
            raise ValueError("hub flags are taken by the f64 sweep only")
        _cuda.check(hubs, "hubs", torch.uint8, dev, 1)
        if hubs.shape != src_in.shape:
            raise ValueError(f"hubs must be [{src_in.shape[0]}], got "
                             f"{tuple(hubs.shape)}")
    if out is None:
        out = torch.empty_like(dist)
    else:
        _cuda.check(out, "out", dt, dev, 2)
        if out.shape != dist.shape or out.data_ptr() == dist.data_ptr():
            raise ValueError("out must be a separate tensor shaped like dist")
    if scratch is None:
        scratch = torch.empty((items.n_split, b), dtype=dt, device=dev)
    else:
        _cuda.check(scratch, "scratch", dt, dev, 2)
        if scratch.shape != (items.n_split, b):
            raise ValueError(f"scratch must be [{items.n_split}, {b}], got "
                             f"{tuple(scratch.shape)}")
    if improved is None:
        improved = torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        _cuda.check(improved, "improved", torch.int32, dev, 1)
    if prev is None:
        prev = torch.ones(1, dtype=torch.int32, device=dev)
    else:
        _cuda.check(prev, "prev", torch.int32, dev, 1)
    f64 = () if dt != torch.float64 else (
        None if hubs is None else hubs.data_ptr(),)
    _cuda.launch(
        "fanout_sweep", dist.data_ptr(), out.data_ptr(), indptr_in.data_ptr(),
        src_in.data_ptr(), w_in.data_ptr(), *f64, items.pieces.data_ptr(),
        items.n_split, v, items.item_edges, scratch.data_ptr(),
        items.split_rows.data_ptr(), items.split_ptr.data_ptr(),
        items.split_rows.shape[0], prev.data_ptr(), improved.data_ptr(), b,
        device=dev, entry=_cuda.entry("pj_fanout_sweep", dt),
    )
    bump(fanout_sweep, "launches")
    return out, improved


fanout_sweep.launches = 0


def occupancy(b: int, *, vec: bool = True,
              dtype: torch.dtype = torch.float32, hubs: bool = True) -> dict:
    """Resident blocks per SM and gather depth (row gathers in flight per
    lane, U) of the items kernel a sweep of width ``b`` in ``dtype``
    launches, at f64 with hub flags or without (needs the card)."""
    blocks, depth = ctypes.c_int(0), ctypes.c_int(0)
    fn = getattr(_cuda.lib("fanout_sweep"),
                 _cuda.entry("pj_fanout_sweep_occupancy", dtype))
    f64 = (int(hubs),) if dtype == torch.float64 else ()
    err = fn(b, int(vec), *f64, ctypes.byref(blocks), ctypes.byref(depth))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return {"blocks_per_sm": blocks.value, "gather_depth": depth.value}


def fanout_fixpoint(dist0, indptr_in, src_in, w_in, *, max_iter: int,
                    items=None, hubs=AUTO):
    """Iterate :func:`fanout_sweep` to its fixpoint, at most ``max_iter``
    sweeps. The same contract as the reference's ``pallas_fanout``:
    (dist [V, B], iterations, still_improving), the last two host values.
    One chunk of :func:`fanout_fixpoint_chunks`: each sweep is Jacobi."""
    return fanout_fixpoint_chunks(
        dist0, [(indptr_in, src_in, w_in, items)], max_iter=max_iter,
        hubs=AUTO if hubs is AUTO else [hubs])


def fanout_fixpoint_chunks(dist0, chunks, *, max_iter: int, hubs=AUTO):
    """:func:`fanout_fixpoint` over an edge list cut into chunks, each a
    ``(indptr_in, src_in, w_in, items)`` in-edge layout (``items`` may
    be None; built on the card when needed). ``hubs`` lists each chunk's
    :func:`hub_flags`; ``AUTO`` builds them from each chunk's own edges
    (on the card, at f64). One sweep launches
    :func:`fanout_sweep` once per chunk, in order, each chunk reading
    what the one before it wrote: the chunk-level Gauss-Seidel sweep of
    the reference's ``relax.bellman_ford_sweeps_vm`` (``ops/hopset.py``
    lays out one chunk per reference edge chunk). A sweep's chunks share
    one improvement flag, and an entry that dropped in any chunk ends
    the sweep lower than it began, so the flag is the reference's
    ``any(new < old)``.

    Two buffers alternate as old and new (``dist0`` is consumed as one of
    them). Sweeps go out in groups of ``SWEEPS_PER_SYNC``: sweep j of a
    group writes ``flags[j]`` and is skipped when the sweep before it
    left its flag at 0, so the sweeps past the fixpoint write nothing; the
    host reads the group's flags once and stops at the first 0, returning
    the buffer that sweep wrote, as ``lax.while_loop`` would. The last
    group is cut so the cap is exact. Host reads (the first finiteness
    check and one per group) count in ``fanout_fixpoint.host_reads``,
    each a ``pj.fanout.host_read`` span."""
    with program_span(Span.FANOUT_HOST_READ):
        improving = bool(torch.isfinite(dist0).any())
    bump(fanout_fixpoint, "host_reads")
    if not improving or max_iter <= 0:
        return dist0, 0, improving
    dev = dist0.device
    n = len(chunks)
    v, b = dist0.shape
    if hubs is AUTO:
        hubs = [hub_flags(s, v, b, dist0.dtype) if dev.type == "cuda"
                else None for _, s, _, _ in chunks]
    if dev.type == "cuda":
        chunks = [(ip, s, w, build_work_items(ip) if it is None else it)
                  for ip, s, w, it in chunks]
        scratch = torch.empty((max(c[3].n_split for c in chunks), b),
                              dtype=dist0.dtype, device=dev)
    else:
        scratch = None
    bufs = (dist0, torch.empty_like(dist0))
    one = torch.ones(1, dtype=torch.int32, device=dev)
    # Flag j at word FLAG_STRIDE * j: each on a cache line of its own, so
    # the stores to one sweep's flag do not contend with the reads of the
    # flag before it.
    flags = torch.empty(SWEEPS_PER_SYNC * FLAG_STRIDE, dtype=torch.int32,
                        device=dev)
    i = 0
    while i < max_iter:
        k = min(SWEEPS_PER_SYNC, max_iter - i)
        flags.zero_()
        prev = one
        for j in range(k):
            flag = flags[FLAG_STRIDE * j:FLAG_STRIDE * j + 1]
            for c, (ip, src, w, items) in enumerate(chunks):
                launch = (i + j) * n + c
                fanout_sweep(bufs[launch % 2], ip, src, w, items=items,
                             out=bufs[(launch + 1) % 2], improved=flag,
                             prev=prev, scratch=(
                                 None if scratch is None
                                 else scratch[:items.n_split]),
                             hubs=hubs[c])
            prev = flag
        with program_span(Span.FANOUT_HOST_READ):
            got = flags[:FLAG_STRIDE * k:FLAG_STRIDE].tolist()
        bump(fanout_fixpoint, "host_reads")
        if 0 in got:
            j = got.index(0)
            return bufs[((i + j + 1) * n) % 2], i + j + 1, False
        i += k
    return bufs[(i * n) % 2], i, True


fanout_fixpoint.host_reads = 0
