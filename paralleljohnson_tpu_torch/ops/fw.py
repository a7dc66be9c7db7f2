"""Tiled blocked Floyd-Warshall over the min-plus semiring: the
counterpart of the JAX package's ``ops/fw.py``.

APSP over the tropical semiring is a blocked matrix product. For each
diagonal block k (the R-Kleene schedule):

  1. Kleene closure of the diagonal tile  C <- D[k,k]*
     (in-tile Floyd-Warshall: ``tile`` rank-1 min-plus steps; the hand
     kernel ``csrc/fw_kleene.cu`` on the card, one launch per closure on
     a thread-block cluster as :func:`kleene_plan` lays it out, and
     :func:`tile_kleene` on the CPU);
  2. row and column panels through the closed diagonal
     D[k,:] <- min(D[k,:], C (x) D[k,:]),
     D[:,k] <- min(D[:,k], D[:,k] (x) C);
  3. the trailing update D <- min(D, D[:,k] (x) D[k,:]) over every row,
     with the panels as step 2 left them.

The products of steps 2 and 3 go through the hand min-plus kernel
(``ops.minplus.minplus_kernel``) on the card and the plain product on
the CPU. Each candidate is one f32 add and min is exact, so the products
are order-independent, and the Kleene steps keep the reference's order
and its read-before-write: the closure is bitwise the reference's on
float weights, not only on integers. Negative edges are handled natively;
a negative diagonal entry after the closure certifies a negative cycle.

Where the reference's arrays are immutable, :func:`fw_apsp_blocked`
closes its argument in place (one [Vp, Vp] matrix, not two);
:func:`fw_closure` leaves its argument alone.

Work accounting: the tropical-MAC count is static, diag nb.t^3 + panels
2.nb.t^2.Vp + trailing nb.t.Vp^2 = Vp.(Vp + t)^2 (:func:`fw_mac_count`,
a host int), on the same padded scale as the squaring route's counters.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from paralleljohnson_tpu_torch.observe.tuning import DEFAULT_FW_TILE
from paralleljohnson_tpu_torch.ops import _cuda, bump, relax
from paralleljohnson_tpu_torch.ops.minplus import minplus_kernel

# Default tile edge (the reference's FW_TILE; the tuning layer's
# DEFAULT_FW_TILE is the same 512): the smallest 128-multiple whose
# trailing-update arithmetic intensity (t/8 flop/byte) clears the
# roofline ridge of the reference's device.
FW_TILE = 512

# k-blocking of the plain panel and trailing products on the CPU
# (relax.minplus's broadcast intermediate). It changes no bit.
FW_KBLOCK = 32

# Largest [rows, Vp] f32 temporary of one trailing product: the trailing
# update runs in row blocks of whole tiles below it (one product per
# k-step up to Vp = 8192 at t = 512; every row block reads the same
# panels and min is exact, so the blocking changes no bit).
FW_TRAIL_BYTES = 1 << 28

# The Kleene kernel (csrc/fw_kleene.cu). Its cluster variant closes
# tiles up to KLEENE_CLUSTER_MAX_T on one cluster of KLEENE_CLUSTER CTAs
# (the hardware's largest, non-portable size) laid out as
# KLEENE_CTAS_DOWN x KLEENE_CTAS_ACROSS blocks of the tile (4 CTAs down:
# a row goes to 4 CTAs as one 16-byte store per lane). Each CTA is
# KLEENE_THREAD_ROWS threads down, each thread holding RR tile rows of
# one column in registers, for the RR of KLEENE_ROWS it is built for.
# Its step variant runs blocks of 32 x 8 threads over 32 tile rows.
KLEENE_ROWS = (8, 16, 24, 32)
KLEENE_CLUSTER = 16
KLEENE_CTAS_DOWN = 4
KLEENE_CTAS_ACROSS = 4
KLEENE_THREAD_ROWS = 4
KLEENE_CLUSTER_MAX_T = 512
KLEENE_STEP_THREADS = 256
KLEENE_STEP_ROWS = 32


def pad_tiles(v: int, tile: int) -> int:
    """V padded up to a whole number of tiles (>= one tile)."""
    return tile * max(1, -(-int(v) // tile))


def effective_tile(v: int, tile: int = FW_TILE) -> int:
    """The 128-aligned tile actually used for a V-vertex solve: graphs
    smaller than ``tile`` shrink it to their own 128-padded size; larger
    graphs use ``tile`` and pad V up to a tile multiple."""
    vp128 = 128 * max(1, -(-int(v) // 128))
    if tile is None:
        tile = FW_TILE
    return min(int(tile), vp128)


def pad_dense(a: torch.Tensor, tile: int) -> torch.Tensor:
    """Pad a dense adjacency [V, V] (0 diagonal, +inf non-edges) to
    [Vp, Vp], Vp a ``tile`` multiple: +inf fill, 0 on the padded
    diagonal, so pad vertices are isolated no-ops. Returns ``a`` itself
    when no pad is needed."""
    v = a.shape[0]
    vp = pad_tiles(v, tile)
    if vp == v:
        return a
    out = torch.full((vp, vp), float("inf"), dtype=a.dtype, device=a.device)
    out[:v, :v] = a
    idx = torch.arange(v, vp, device=a.device)
    out[idx, idx] = 0.0
    return out


def tile_kleene(d: torch.Tensor) -> torch.Tensor:
    """Kleene closure of one [t, t] tile in plain PyTorch: t rank-1
    min-plus steps, each reading row k and column k from the state
    before it (the reference's loop body). The CPU path of
    :func:`fw_kleene` and its reference on the card. Returns a new
    tensor."""
    m = d
    for k in range(d.shape[0]):
        m = torch.minimum(m, m[:, k:k + 1] + m[k:k + 1, :])
    return m.clone() if m is d else m


def _check_tile(x: torch.Tensor, what: str, t: int, dev) -> None:
    """A [t, t] f32 view on ``dev`` with unit column stride (rows may be
    strided: a diagonal tile of a larger matrix)."""
    if x.device != dev:
        raise ValueError(f"{what} is on {x.device}, expected {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} must be torch.float32, got {x.dtype}")
    if tuple(x.shape) != (t, t):
        raise ValueError(f"{what} must be [{t}, {t}], got {tuple(x.shape)}")
    if t > 0 and (x.stride(1) != 1 or x.stride(0) < t):
        raise ValueError(f"{what} must have unit column stride and rows of "
                         f"at least {t}, got strides {x.stride()}")


class KleenePlan(NamedTuple):
    """How the kernel closes a [t, t] tile. ``variant`` "cluster": one
    launch of one cluster of ``cluster`` CTAs, each holding a ``rows`` x
    ``cols`` block of the tile (padded with +inf to whole CTAs) in
    registers, ``threads`` threads (``cols`` across) and ``smem_bytes``
    of dynamic shared memory (the hand-over buffers and their
    mbarriers). "step": t launches of a grid of ``threads``-thread
    blocks over ``rows`` x ``cols`` of the tile each, no shared memory,
    through an f32[2, t, t] scratch (``cluster`` is 1)."""

    variant: str
    cluster: int
    rows: int
    cols: int
    threads: int
    smem_bytes: int


def kleene_plan(t: int) -> KleenePlan:
    """The Kleene kernel's plan for a [t, t] tile, a pure function of the
    shape: the cluster variant up to ``KLEENE_CLUSTER_MAX_T`` (every
    default FW tile), with the fewest rows per thread of ``KLEENE_ROWS``
    that cover t; the step variant above (a choice by shape, not a
    fallback)."""
    t = int(t)
    if t > KLEENE_CLUSTER_MAX_T:
        return KleenePlan("step", 1, KLEENE_STEP_ROWS, 32, KLEENE_STEP_THREADS,
                          0)
    rr = next(r for r in KLEENE_ROWS
              if KLEENE_CTAS_DOWN * KLEENE_THREAD_ROWS * r >= t)
    padded = KLEENE_CTAS_DOWN * KLEENE_THREAD_ROWS * rr
    rows, cols = padded // KLEENE_CTAS_DOWN, padded // KLEENE_CTAS_ACROSS
    return KleenePlan("cluster", KLEENE_CLUSTER, rows, cols,
                      KLEENE_THREAD_ROWS * cols, 16 + 4 * (2 * cols + 3 * rows))


@functools.lru_cache(maxsize=None)
def cluster_occupancy(plan: KleenePlan, device: int) -> int:
    """Clusters of ``plan``'s shape card ``device`` (a CUDA index) can
    hold at once (``cudaOccupancyMaxActiveClusters``). 0 means the launch
    cannot run."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _cuda.lib("fw_kleene").pj_fw_kleene_occupancy(
            plan.rows, plan.cols, plan.threads, plan.smem_bytes,
            ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cluster occupancy query failed: cudaError {err}")
    return n.value


def fw_kleene(d: torch.Tensor, *, out=None, scratch=None) -> torch.Tensor:
    """Kleene closure of the [t, t] tile ``d`` through the hand CUDA
    kernel (``csrc/fw_kleene.cu``) for CUDA tensors; :func:`tile_kleene`
    for CPU tensors. ``d`` and ``out`` may be row-strided views of a
    larger matrix (a diagonal tile), and ``out`` may be ``d`` itself (in
    place). :func:`kleene_plan` (t) picks the variant. ``scratch`` is
    the step variant's f32[2, t, t] buffers (allocated when None); the
    cluster variant needs none and ignores it. Returns ``out`` (a new
    [t, t] tensor when None).

    Each CUDA call counts one in ``fw_kleene.launches``: one closure, one
    cluster launch or the step variant's t launches. A cluster the card
    cannot hold raises; nothing falls back. CPU tensors count nothing."""
    if d.dim() != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f"fw_kleene takes a square tile, got {tuple(d.shape)}")
    t = d.shape[0]
    if d.device.type == "cpu":
        closed = tile_kleene(d)
        return closed if out is None else out.copy_(closed)
    dev = d.device
    if dev.type != "cuda":
        raise ValueError(f"fw_kleene takes cpu or cuda tensors, got {dev}")
    _check_tile(d, "d", t, dev)
    if out is None:
        out = torch.empty((t, t), dtype=torch.float32, device=dev)
    else:
        _check_tile(out, "out", t, dev)
    plan = kleene_plan(t)
    if plan.variant == "cluster":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if cluster_occupancy(plan, index) < 1:
            raise RuntimeError(f"the card cannot hold the Kleene kernel's "
                               f"cluster: {plan}")
        _cuda.launch("fw_kleene", d.data_ptr(), d.stride(0), out.data_ptr(),
                     out.stride(0), t, plan.rows, plan.cols, plan.threads,
                     plan.smem_bytes, device=dev)
    else:
        if scratch is None:
            scratch = torch.empty((2, t, t), dtype=torch.float32, device=dev)
        else:
            _cuda.check(scratch, "scratch", torch.float32, dev, 3)
            if tuple(scratch.shape) != (2, t, t):
                raise ValueError(f"scratch must be [2, {t}, {t}], got "
                                 f"{list(scratch.shape)}")
        _cuda.launch("fw_kleene", d.data_ptr(), d.stride(0), out.data_ptr(),
                     out.stride(0), scratch[0].data_ptr(),
                     scratch[1].data_ptr(), t, device=dev,
                     entry="pj_fw_kleene_steps")
    bump(fw_kleene, "launches")
    return out


fw_kleene.launches = 0


def _minplus_into(d, a, out, k_block: int) -> None:
    """out <- d (x) a: the hand kernel on the card, the plain product
    (k-blocked by ``k_block``) on the CPU."""
    if d.device.type == "cuda":
        minplus_kernel(d, a, out=out)
    else:
        out.copy_(relax.minplus(d, a, k_block=k_block))


def _negative_diagonal(d: torch.Tensor) -> bool:
    """The negative-cycle flag: any(diagonal(d) < 0), one host read."""
    return bool((torch.diagonal(d) < 0).any())


def fw_apsp_blocked(a: torch.Tensor, *, tile: int = FW_TILE,
                    k_block: int = FW_KBLOCK):
    """Blocked Floyd-Warshall closure of ``a`` [Vp, Vp] (Vp a ``tile``
    multiple; 0 diagonal, +inf non-edges, negative edges allowed), IN
    PLACE.

    Returns ``(a, negative_cycle)``, ``negative_cycle`` a host bool: the
    exact min-plus closure, or (when the flag is set) distances that are
    undefined because a negative cycle exists."""
    vp = a.shape[0]
    if a.dim() != 2 or a.shape[1] != vp:
        raise ValueError(f"fw_apsp_blocked takes a square matrix, got "
                         f"{tuple(a.shape)}")
    if vp % tile:
        raise ValueError(
            f"fw_apsp_blocked: V={vp} is not a multiple of tile={tile}; "
            "pad with pad_dense/pad_tiles first"
        )
    nb = vp // tile
    dev = a.device
    scratch = (torch.empty((2, tile, tile), dtype=a.dtype, device=dev)
               if dev.type == "cuda" and kleene_plan(tile).variant == "step"
               else None)
    if nb == 1:
        fw_kleene(a, out=a, scratch=scratch)
        return a, _negative_diagonal(a)
    rows = tile * max(1, min(nb, FW_TRAIL_BYTES // (4 * vp * tile)))
    row_tmp = torch.empty((tile, vp), dtype=a.dtype, device=dev)
    col_tmp = torch.empty((vp, tile), dtype=a.dtype, device=dev)
    trail_tmp = torch.empty((rows, vp), dtype=a.dtype, device=dev)
    for k in range(nb):
        ks = slice(k * tile, (k + 1) * tile)
        # The closed diagonal goes to a tile of its own: the row panel
        # below reads the unclosed diagonal block, as in the reference.
        diag = fw_kleene(a[ks, ks], scratch=scratch)
        row = a[ks]
        _minplus_into(diag, row, row_tmp, k_block)
        torch.minimum(row, row_tmp, out=row)
        # The updated row panel, kept before the column write-back
        # lowers its diagonal block again: the trailing update reads it.
        row = row.clone()
        col = a[:, ks].contiguous()
        _minplus_into(col, diag, col_tmp, k_block)
        torch.minimum(col, col_tmp, out=col)
        a[:, ks] = col
        for i0 in range(0, vp, rows):
            blk = a[i0:i0 + rows]
            tmp = trail_tmp[:blk.shape[0]]
            _minplus_into(col[i0:i0 + rows], row, tmp, k_block)
            torch.minimum(blk, tmp, out=blk)
    return a, _negative_diagonal(a)


def fw_closure(a: torch.Tensor, *, tile: int, k_block: int = FW_KBLOCK):
    """:func:`fw_apsp_blocked` of a copy of ``a`` (``a`` is left as it
    is): the entry of ``solver.partitioned``'s closures."""
    return fw_apsp_blocked(a.clone(), tile=tile, k_block=k_block)


def fw_mac_count(v_pad: int, tile: int) -> int:
    """Exact tropical MACs of one blocked closure at padded size
    ``v_pad`` (host Python int, overflow-free): diag nb.t^3 + panels
    2.nb.t^2.Vp + trailing nb.t.Vp^2 = Vp.(Vp + t)^2."""
    vp, t = int(v_pad), int(tile)
    if vp % t:
        raise ValueError(f"v_pad={vp} not a multiple of tile={t}")
    return vp * (vp + t) * (vp + t)


def fw_analytic_cost(v_pad: int, tile: int, itemsize: int = 4) -> dict:
    """The reference's analytic pricing of one blocked closure (its
    tile-triple model): 2 flops per tropical MAC, 4 [t, t] tile
    transfers per t^3-MAC tile op -> bytes = 4.itemsize.MACs / t."""
    macs = fw_mac_count(v_pad, tile)
    return {
        "flops": 2.0 * macs,
        "bytes_accessed": 4.0 * itemsize * macs / tile,
        "transcendentals": 0.0,
    }
