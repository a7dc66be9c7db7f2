"""Relaxation primitives of the Johnson main path, in plain PyTorch.

The counterpart of the JAX package's ``ops/relax.py`` for the functions
this port's ``solve()`` runs. They are XLA code there, not Pallas
kernels, so plain tensor code is their port; the arithmetic and its
association are kept exactly, so both packages produce the same f32
values:

  - ``relax_sweep`` / ``bellman_ford_sweeps``: the source-major
    scatter-min sweep of phase 1 (route ``sweep``). Edges are streamed
    in ``edge_chunk`` blocks and later chunks see the distances earlier
    chunks lowered (chunk-level Gauss-Seidel, as in the reference).
  - ``reweight_weights``: ``(w + h[src]) - h[dst]``, clamped at 0, +inf
    kept.
  - ``dense_adjacency`` / ``minplus`` / ``apsp_minplus_squaring`` /
    ``dense_fanout``: the dense min-plus family; ``mp=`` takes the
    hand CUDA product (``ops.minplus.minplus_kernel``).
  - ``bellman_ford_frontier``: B=1 Bellman-Ford over a compacted
    active-vertex frontier (route ``frontier``), with a full sweep for
    the rounds whose frontier overflows its buffer.

Every function takes and returns tensors on the caller's device; loops
whose trip count depends on the data read one flag per iteration to the
host, unless a grouped fixpoint is passed in (``dense_fanout``'s
``fixpoint=``, ``ops.minplus.minplus_fixpoint`` on the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from paralleljohnson_tpu_torch.ops import bump
from paralleljohnson_tpu_torch.utils.paths import NO_PRED

INF = float("inf")
_I32_MAX = torch.iinfo(torch.int32).max

# Largest per-round addend of the examined counter of the frontier and
# bucket kernels (the reference's split int32 counter): both E (full-sweep
# rounds) and capacity x max_degree (frontier rounds) must stay below it.
# The port counts in int64, but keeps the bound so both packages gate and
# clamp the same graphs.
FRONTIER_ADDEND_MAX = (1 << 31) - (1 << 20)

# Bound on the elements of one [rows, chunk] relaxation intermediate
# (256 MB at f32), the JAX package's ``_edge_chunk_for`` budget.
EDGE_CHUNK_BUDGET = 1 << 26


def edge_chunk_for(batch: int, num_edges: int,
                   budget_elems: int = EDGE_CHUNK_BUDGET) -> int:
    """Edges per chunk so the [B, chunk] intermediate stays near
    ``budget_elems`` floats regardless of graph size — the reference's
    ``jax_backend._edge_chunk_for`` rule, so both packages cut the edge
    list at the same places."""
    chunk = max(1, budget_elems // max(batch, 1))
    return int(min(max(chunk, 1 << 12), max(num_edges, 1)))


def relax_sweep(dist, src, dst, w, *, edge_chunk: int = 1 << 20):
    """One full relaxation sweep: dist'[.., v] = min(dist[.., v],
    min over edges (u->v) of dist[.., u] + w).

    dist: [V] or [B, V]. Within a chunk the scatter-min reads the distances
    as they stood at the chunk's start; the next chunk sees its result.
    Returns a new tensor (``dist`` is not modified).
    """
    squeeze = dist.dim() == 1
    d = dist.unsqueeze(0) if squeeze else dist
    d = d.clone()
    e = src.shape[0]
    step = max(1, min(edge_chunk, e or 1))
    for lo in range(0, e, step):
        s = src[lo:lo + step].long()
        t = dst[lo:lo + step].long()
        cand = d[:, s] + w[lo:lo + step].unsqueeze(0)
        d.scatter_reduce_(
            1, t.unsqueeze(0).expand_as(cand), cand, "amin", include_self=True
        )
    return d[0] if squeeze else d


def bellman_ford_sweeps(dist0, src, dst, w, *, max_iter: int,
                        edge_chunk: int = 1 << 20):
    """Iterate relaxation sweeps to fixpoint, at most ``max_iter`` sweeps
    (pass |V| for Bellman-Ford semantics: a |V|-th sweep that still
    improves proves a reachable negative cycle).

    Returns (dist, iterations, still_improving) with the last two as host
    values; ``still_improving`` after exit is the negative-cycle flag.
    """
    return _sweeps_to_fixpoint(
        lambda d: relax_sweep(d, src, dst, w, edge_chunk=edge_chunk),
        dist0, max_iter)


def relax_sweep_pred(dist, pred, src, dst, w, *, edge_chunk: int = 1 << 20):
    """:func:`relax_sweep` that also carries predecessors: ``pred[b, v]``
    is the source of the edge that last lowered ``dist[b, v]`` (``NO_PRED``
    for sources and unreached vertices). Among the edges reaching a
    chunk's minimum the smallest source id wins. Returns new (dist, pred)."""
    squeeze = dist.dim() == 1
    d = dist.unsqueeze(0) if squeeze else dist
    p = pred.unsqueeze(0) if squeeze else pred
    d, p = d.clone(), p.clone()
    e = src.shape[0]
    step = max(1, min(edge_chunk, e or 1))
    for lo in range(0, e, step):
        s = src[lo:lo + step].long()
        t = dst[lo:lo + step].long().unsqueeze(0).expand(d.shape[0], -1)
        cand = d[:, s] + w[lo:lo + step].unsqueeze(0)
        upd = torch.full_like(d, INF).scatter_reduce_(1, t, cand, "amin")
        win = cand == upd.gather(1, t)
        cand_src = torch.where(win, s.to(torch.int32), _I32_MAX)
        winner = torch.full(d.shape, _I32_MAX, dtype=torch.int32,
                            device=d.device).scatter_reduce_(1, t, cand_src,
                                                             "amin")
        p = torch.where(upd < d, winner, p)
        d = torch.minimum(d, upd)
    return (d[0], p[0]) if squeeze else (d, p)


def bellman_ford_sweeps_pred(dist0, src, dst, w, *, max_iter: int,
                             edge_chunk: int = 1 << 20):
    """Predecessor-carrying :func:`bellman_ford_sweeps` (route
    ``pred-sweep``): returns (dist, pred, iterations, still_improving),
    ``pred`` int32 with ``NO_PRED`` at sources and unreached vertices."""
    d = dist0
    p = torch.full(dist0.shape, NO_PRED, dtype=torch.int32,
                   device=dist0.device)
    improving = bool(torch.isfinite(dist0).any())
    i = 0
    while improving and i < max_iter:
        nd, p = relax_sweep_pred(d, p, src, dst, w, edge_chunk=edge_chunk)
        improving = bool((nd < d).any())
        d = nd
        i += 1
    return d, p, i, improving


# -- vertex-major (dst-sorted) sweeps: routes vm and vm-blocked --------------
#
# The reference's default fan-out keeps dist vertex-major ([V, B]) over
# destination-sorted edges: each chunk gathers source rows and min-reduces
# them into destination rows. ``vm`` reduces every chunk into all V rows;
# ``vm-blocked`` buckets the edges by destination block of ``vb`` vertices,
# so a chunk touches one [vb, B] slice. Both carry the distances from
# chunk to chunk (chunk-level Gauss-Seidel), as the reference does, so
# the iteration counts agree with it.


def relax_sweep_vm(dist_vm, src, dst, w, *, edge_chunk: int = 1 << 20):
    """One sweep in vertex-major layout over edges sorted by ``dst``:
    each chunk's candidates ``dist[src] + w`` are gathered from the carry
    at the chunk's start and min-reduced into their rows. Returns a new
    tensor."""
    d = dist_vm.clone()
    b = d.shape[1]
    e = src.shape[0]
    step = max(1, min(edge_chunk, e or 1))
    for lo in range(0, e, step):
        cand = d.index_select(0, src[lo:lo + step].long())
        cand += w[lo:lo + step].unsqueeze(1)
        idx = dst[lo:lo + step].long().unsqueeze(1).expand(-1, b)
        d.scatter_reduce_(0, idx, cand, "amin")
    return d


def bellman_ford_sweeps_vm(dist0_vm, src, dst, w, *, max_iter: int,
                           edge_chunk: int = 1 << 20):
    """:func:`relax_sweep_vm` to its fixpoint: (dist_vm, iterations,
    still_improving), the last two host values."""
    return _sweeps_to_fixpoint(
        lambda d: relax_sweep_vm(d, src, dst, w, edge_chunk=edge_chunk),
        dist0_vm, max_iter)


def bucket_edges_by_dst_block(dst, vb: int, nb: int):
    """(order, counts) of host ``dst``: the edge permutation sorted by
    (dst block, dst), stable, and the edges per block."""
    block = dst // vb
    order = np.lexsort((dst, block))
    counts = np.bincount(block, minlength=nb)
    return order, counts


def build_vm_blocked_layout(indptr: np.ndarray, indices: np.ndarray,
                            num_nodes: int, *, vb: int, ec: int) -> dict:
    """Host layout of ``vm-blocked`` (numpy, once per graph structure):
    edges sorted by destination, bucketed by destination block of ``vb``
    vertices, each block padded to a multiple of the chunk size ``ec``.
    int32 arrays ``src_ck`` [NC, ec] (0 at pads), ``dstl_ck`` [NC, ec]
    (block-local destination, ``vb`` at pads), ``base_ck`` [NC] (each
    chunk's first vertex) and ``edge_order`` [NC, ec] (CSR edge index, -1
    at pads: the current weights are gathered through it, so the layout
    survives reweighting), plus ``vb``. Real edges only (``indptr[-1]``)."""
    v = num_nodes
    e = int(indptr[-1])
    src = np.repeat(np.arange(v, dtype=np.int32), np.diff(indptr))
    dst = indices[:e].astype(np.int32)
    nb = max(1, -(-v // vb))
    order, counts = bucket_edges_by_dst_block(dst, vb, nb)
    padded = -(-np.maximum(counts, 1) // ec) * ec  # >= 1 chunk per block
    total = int(padded.sum())
    src_f = np.zeros(total, np.int32)
    dstl_f = np.full(total, vb, np.int32)
    order_f = np.full(total, -1, np.int32)
    base_f = np.empty(total, np.int32)
    starts_in = np.concatenate([[0], np.cumsum(counts)])
    starts_out = np.concatenate([[0], np.cumsum(padded)])
    for j in range(nb):
        c = int(counts[j])
        o = int(starts_out[j])
        sl = order[starts_in[j]: starts_in[j] + c]
        src_f[o: o + c] = src[sl]
        dstl_f[o: o + c] = dst[sl] - j * vb
        order_f[o: o + c] = sl
        base_f[o: o + int(padded[j])] = j * vb
    nc = total // ec
    return {
        "src_ck": src_f.reshape(nc, ec),
        "dstl_ck": dstl_f.reshape(nc, ec),
        "base_ck": base_f.reshape(nc, ec)[:, 0].copy(),
        "edge_order": order_f.reshape(nc, ec),
        "vb": vb,
    }


def build_vm_blocked_layout_device(src, dst, weights, counts: np.ndarray, *,
                                   vb: int, ec: int) -> dict:
    """:func:`build_vm_blocked_layout` on the edges' device, for large
    edge lists: a stable sort by ``dst`` (the same order as the host's
    (block, dst) sort, block = dst // vb being monotone in dst) and a
    scatter into the padded slots; only ``counts`` (real edges per block)
    comes from the host. ``src`` / ``dst`` / ``weights`` are the real
    edges. Returns the host builder's ``src_ck`` / ``dstl_ck`` as tensors
    and its ``base_ck`` (no ``edge_order``), ``w_ck`` gathered from
    ``weights``, and ``order`` / ``slots`` for
    :func:`regather_vm_blocked_weights`."""
    nb = counts.shape[0]
    if int(counts.sum()) != int(dst.shape[0]):
        raise ValueError(
            f"counts sum ({int(counts.sum())}) != number of edges "
            f"({int(dst.shape[0])}): pass real edges only"
        )
    dev = dst.device
    padded = -(-np.maximum(counts, 1) // ec) * ec
    total = int(padded.sum())
    starts_in = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)])[:-1],
                                device=dev)
    starts_out = torch.as_tensor(
        np.concatenate([[0], np.cumsum(padded)])[:-1], device=dev)
    nc = total // ec
    base_ck = np.repeat(np.arange(nb, dtype=np.int32) * vb,
                        (padded // ec).astype(np.int64))
    order = torch.argsort(dst, stable=True)
    dst_s = dst[order].long()
    block_s = dst_s // vb
    # Slot of sorted edge p: starts_out[block] + (p - starts_in[block]).
    p = torch.arange(dst.shape[0], device=dev)
    slots = starts_out[block_s] + p - starts_in[block_s]
    return {
        "src_ck": _slot_scatter(src[order].to(torch.int32), slots, total,
                                (nc, ec), 0),
        "dstl_ck": _slot_scatter((dst_s - block_s * vb).to(torch.int32),
                                 slots, total, (nc, ec), vb),
        "base_ck": base_ck,
        "w_ck": regather_vm_blocked_weights(weights, order, slots, total,
                                            (nc, ec)),
        "order": order,
        "slots": slots,
        "vb": vb,
    }


def _slot_scatter(vals, slots, total: int, shape, fill):
    out = torch.full((total,), fill, dtype=vals.dtype, device=vals.device)
    out[slots] = vals
    return out.view(shape)


def regather_vm_blocked_weights(weights, order, slots, total: int, shape):
    """The current ``weights`` in the padded chunk slots of a device-built
    layout (+inf at pads): the builder's and the post-reweight gather."""
    return _slot_scatter(weights[order], slots, total, shape, INF)


def relax_sweep_vm_blocked(dist_vm, src_ck, dstl_ck, w_ck, base_ck, *,
                           vb: int):
    """One vertex-major sweep over dst-blocked chunks: chunk k gathers its
    candidates from the carry and min-reduces them into rows base_ck[k]
    .. base_ck[k] + vb (``dist_vm`` has a multiple of ``vb`` rows, pad rows
    +inf). Pad slots (+inf weight) are no-ops and go to the block's last
    row. Returns a new tensor."""
    d = dist_vm.clone()
    b = d.shape[1]
    for k in range(src_ck.shape[0]):
        base = int(base_ck[k])
        cand = d.index_select(0, src_ck[k].long())
        cand += w_ck[k].unsqueeze(1)
        idx = dstl_ck[k].long().clamp_max(vb - 1).unsqueeze(1).expand(-1, b)
        d[base:base + vb].scatter_reduce_(0, idx, cand, "amin")
    return d


def bellman_ford_sweeps_vm_blocked(dist0_vm, src_ck, dstl_ck, w_ck, base_ck,
                                   *, vb: int, max_iter: int):
    """:func:`relax_sweep_vm_blocked` to its fixpoint: (dist_vm,
    iterations, still_improving), the last two host values."""
    return _sweeps_to_fixpoint(
        lambda d: relax_sweep_vm_blocked(d, src_ck, dstl_ck, w_ck, base_ck,
                                         vb=vb),
        dist0_vm, max_iter)


def _sweeps_to_fixpoint(sweep, dist0, max_iter: int):
    """Apply ``sweep`` until nothing drops or ``max_iter`` sweeps ran:
    (dist, iterations, still_improving), one host read per sweep (and
    one before), counted in ``_sweeps_to_fixpoint.host_reads``."""
    d = dist0
    improving = bool(torch.isfinite(dist0).any())
    i = 0
    while improving and i < max_iter:
        nd = sweep(d)
        improving = bool((nd < d).any())
        d = nd
        i += 1
    bump(_sweeps_to_fixpoint, "host_reads", i + 1)
    return d, i, improving


_sweeps_to_fixpoint.host_reads = 0


def multi_source_init(sources, num_nodes: int, dtype=torch.float32):
    """dist0[B, V]: +inf everywhere, 0 at each row's source."""
    b = sources.shape[0]
    dist0 = torch.full((b, num_nodes), INF, dtype=dtype, device=sources.device)
    dist0[torch.arange(b, device=sources.device), sources.long()] = 0.0
    return dist0


def reweight_weights(w, src, dst, h):
    """Johnson reweighting w'(u,v) = (w + h(u)) - h(v), clamped at 0
    against float residue, with +inf (padding / unreachable) preserved."""
    wp = (w + h[src.long()]) - h[dst.long()]
    return torch.where(
        torch.isfinite(wp), torch.clamp_min(wp, 0.0),
        torch.full_like(wp, INF),
    )


def dense_adjacency(src, dst, w, num_nodes: int, dtype=torch.float32):
    """A[u, v] = w(u, v), +inf where no edge, 0 diagonal (path of length 0).
    Parallel edges resolve to the min via scatter-min."""
    v = num_nodes
    a = torch.full((v * v,), INF, dtype=dtype, device=w.device)
    flat = src.long() * v + dst.long()
    a.scatter_reduce_(0, flat, w.to(dtype), "amin", include_self=True)
    a = a.view(v, v)
    diag = torch.arange(v, device=w.device)
    a[diag, diag] = torch.clamp_max(a[diag, diag], 0.0)
    return a


def minplus(d, a, *, k_block: int = 128, budget_elems: int = 1 << 26):
    """Min-plus product out[i, j] = min_k d[i, k] + a[k, j] (plain).

    Blocked over k (``k_block``) and, when the [rows, k_block, J]
    broadcast intermediate would exceed ``budget_elems``, over rows too.
    Every entry is the exact min of exactly rounded f32 sums, so the
    blocking never changes a bit of the result.
    """
    i, k = d.shape
    k2, j = a.shape
    if k != k2:
        raise ValueError(f"minplus shapes disagree: {tuple(d.shape)} x {tuple(a.shape)}")
    out = torch.full((i, j), INF, dtype=d.dtype, device=d.device)
    if i == 0 or j == 0 or k == 0:
        return out
    kb = min(k_block, k)
    rows = max(1, min(i, budget_elems // max(kb * j, 1)))
    for r0 in range(0, i, rows):
        acc = out[r0:r0 + rows]
        for k0 in range(0, k, kb):
            db = d[r0:r0 + rows, k0:k0 + kb]
            ab = a[k0:k0 + kb]
            torch.minimum(
                acc, (db.unsqueeze(2) + ab.unsqueeze(0)).amin(dim=1), out=acc
            )
    return out


def minplus_padded_k(k: int, k_block: int = 128) -> int:
    """K after the reference ``minplus``'s internal padding (K rounded up
    to a ``min(k_block, K)`` multiple) — the scale of the dense route's
    work accounting, kept so both packages report the same counters."""
    kb = min(k_block, max(int(k), 1))
    return kb * -(-int(k) // kb)


def squaring_steps(v: int) -> int:
    """Squarings :func:`apsp_minplus_squaring` performs: ceil(log2 V),
    floored at 1."""
    return max(1, math.ceil(math.log2(max(int(v), 2))))


def apsp_minplus_squaring(a, *, mp=None):
    """Full APSP of a dense adjacency by repeated min-plus squaring:
    D <- D (x) D doubles the path length covered, so ceil(log2 V)
    squarings reach the fixpoint (no negative cycles: use after
    reweighting). Returns (dist[V, V], squarings)."""
    mp = mp or minplus
    steps = squaring_steps(a.shape[0])
    d = a
    for _ in range(steps):
        d = mp(d, d)
    return d, steps


def dense_fanout(a, sources, *, max_iter: int, mp=None, fixpoint=None):
    """N-source fan-out on a dense adjacency (0 diagonal, +inf non-edges).

    Two regimes, picked by source count (:func:`dense_fanout_regime`):
      - 2B >= V: min-plus squaring of the whole matrix, then a row gather;
      - otherwise iterate D <- D (x) A to fixpoint (diameter iterations).

    ``fixpoint(d0, a, max_iter=)``, when given, runs the iterate regime's
    loop (``ops.minplus.minplus_fixpoint`` on the card: one host read per
    group of products); otherwise the loop below reads one flag per
    product. Returns (dist[B, V], iterations, still_improving), the last
    two host values. Weights must be non-negative (post-reweighting).
    """
    mp = mp or minplus
    v = a.shape[0]
    b = sources.shape[0]
    if dense_fanout_regime(v, b)[0] == "squaring":
        full, steps = apsp_minplus_squaring(a, mp=mp)
        return full[sources.long(), :], steps, False
    d = multi_source_init(sources, v, a.dtype)
    if fixpoint is not None:
        return fixpoint(d, a, max_iter=max_iter)
    improving = True
    i = 0
    while improving and i < max_iter:
        nd = mp(d, a)  # a's 0 diagonal keeps nd <= d
        improving = bool((nd < d).any())
        d = nd
        i += 1
    return d, i, improving


def dense_fanout_regime(v: int, b: int, *, k_block: int = 128) -> tuple[str, int]:
    """(regime, work_per_iter) for :func:`dense_fanout` at shapes (V, B):
    ``("squaring", V*Kp*V)`` when 2B >= V, else ``("iterate", B*Kp*V)``,
    with Kp the reference's padded K (:func:`minplus_padded_k`)."""
    kp = minplus_padded_k(v, k_block)
    if 2 * b >= v:
        return "squaring", v * kp * v
    return "iterate", b * kp * v


# -- compacted-frontier Bellman-Ford (B=1, route frontier) -------------------
#
# On a road-like grid only the out-edges of the vertices whose distance
# changed last round can improve anything, and that frontier is ~sqrt(V)
# vertices, not V. The frontier is compacted into a fixed ``capacity`` id
# buffer, its out-edges are gathered through the CSR indptr padded to the
# graph's max degree, and a round whose frontier overflows the buffer runs
# one full chunked sweep instead. Round r subsumes Jacobi round r, so
# "still active after max_iter >= V rounds" certifies a reachable negative
# cycle, as for the sweeps.


def compact(mask, values, capacity: int, fill: int):
    """``values`` at the first ``capacity`` True entries of ``mask`` in
    index order, ``fill`` after them: ``jnp.nonzero(mask, size=capacity,
    fill_value=...)`` then a gather, without reading the count on the
    host. ``mask`` and ``values`` are 1-D of one length."""
    pos = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (pos < capacity), pos,
                       torch.full_like(pos, capacity))
    out = torch.full((capacity + 1,), fill, dtype=values.dtype,
                     device=values.device)
    # Entries past the buffer all land in the spare last slot.
    out.scatter_(0, slot, values)
    return out[:capacity]


def out_edge_tile(indptr_ext, dst, w, ids, max_degree: int, num_nodes: int):
    """The out-edges of the vertex ids ``ids`` [K] (id ``num_nodes`` is an
    empty row) as a [K, max_degree] tile: (t, wt, valid) with destination
    ``num_nodes`` and weight +inf at the invalid slots. ``indptr_ext`` is
    the int64 CSR indptr with its last entry repeated."""
    starts = indptr_ext[ids]
    ends = indptr_ext[ids + 1]
    eidx = starts[:, None] + torch.arange(max_degree, device=ids.device)
    valid = eidx < ends[:, None]
    eidx = eidx.clamp_max(max(dst.shape[0] - 1, 0))
    t = torch.where(valid, dst[eidx].long(), num_nodes)
    wt = torch.where(valid, w[eidx], torch.full_like(w[:1], INF))
    return t, wt, valid


def bellman_ford_frontier(dist0, src, dst, w, indptr, *, max_iter: int,
                          capacity: int, max_degree: int,
                          num_real_edges: int, edge_chunk: int = 1 << 20):
    """Fixpoint Bellman-Ford over an active-vertex frontier (B=1), the
    reference's ``relax.bellman_ford_frontier``.

    ``src``/``dst``/``w`` are in CSR (src-sorted) order with ``indptr``
    ([V+1], host or device) describing the real edges; the padded tail
    edges are (0, 0, +inf) no-ops only the full sweep touches. The
    distances live in a [V+1] buffer whose last slot takes the empty
    rows' sentinel destination ``V`` (the reference's dropped scatter
    index) and stays +inf. Winner ids may repeat (ties, several improving
    edges into one vertex): they are kept, so the examined count matches
    the reference's.

    One host read per round (the frontier count, which picks the branch
    and ends the loop), counted in ``bellman_ford_frontier.host_reads``.
    Returns (dist [V], rounds, still_improving, examined) with
    ``examined`` an int64 device count of candidate relaxations (full
    sweeps add E); decode with :func:`examined_exact`."""
    if num_real_edges >= FRONTIER_ADDEND_MAX:
        raise ValueError(
            "bellman_ford_frontier: E="
            f"{num_real_edges} >= 2^31 - 2^20 breaks the examined "
            "counter's full-sweep addend bound the reference enforces; "
            "use the sweep routes"
        )
    v = dist0.shape[0]
    dev = dist0.device
    capacity = int(min(capacity, v))
    if max_degree > 0:
        capacity = max(1, min(capacity, (FRONTIER_ADDEND_MAX - 1) // max_degree))
    indptr = torch.as_tensor(indptr).to(dev, torch.int64)
    indptr_ext = torch.cat([indptr, indptr[-1:]])
    vertex_ids = torch.arange(v, device=dev)
    d = torch.cat([dist0, torch.full((1,), INF, dtype=dist0.dtype,
                                     device=dev)])
    examined = torch.zeros((), dtype=torch.int64, device=dev)

    def frontier_round(ids):
        t, wt, valid = out_edge_tile(indptr_ext, dst, w, ids, max_degree, v)
        t = t.reshape(-1)
        cand = (d[ids][:, None] + wt).reshape(-1)
        old = d[t]
        d.scatter_reduce_(0, t, cand, "amin")
        # Winner edges strictly improved their destination AND reached the
        # post-scatter minimum; their destinations are the next frontier.
        winner = (cand < old) & (cand == d[t])
        return compact(winner, t, capacity, v), winner.sum(), valid.sum()

    def full_round():
        nd = relax_sweep(d[:v], src, dst, w, edge_chunk=edge_chunk)
        improved = nd < d[:v]
        d[:v] = nd
        return (compact(improved, vertex_ids, capacity, v), improved.sum(),
                num_real_edges)

    active0 = torch.isfinite(dist0)
    ids = compact(active0, vertex_ids, capacity, v)
    count = int(active0.sum())
    bump(bellman_ford_frontier, "host_reads")
    i = 0
    while count > 0 and i < max_iter:
        ids, ncount, ex = (frontier_round(ids) if count <= capacity
                           else full_round())
        examined += ex
        count = int(ncount)
        bump(bellman_ford_frontier, "host_reads")
        i += 1
    return d[:v], i, count > 0, examined


bellman_ford_frontier.host_reads = 0


def examined_exact(examined) -> int:
    """The examined counter of :func:`bellman_ford_frontier` /
    ``ops.bucket.bellman_ford_bucketed`` as a Python int (one host
    read)."""
    return int(examined)



# -- dirty-window compacted fan-out (route ``vm-blocked+dw``) ---------------
#
# The batched routes relax every edge every round, though on road graphs
# most vertices stop changing long before the fixpoint. This route keeps
# one activity bit per destination block of ``vb`` vertices: a block is
# dirty when any of its vertices' distances changed last round. Each
# round the dirty blocks are compacted into a static buffer and only
# their out-edge tiles are gathered and relaxed, a [capacity x Em, B]
# tile instead of the full [E, B] sweep; a round with more dirty blocks
# than the buffer holds runs one full chunked sweep instead. Round r
# subsumes Jacobi round r, so "still active after max_iter >= V rounds"
# keeps the negative-cycle certificate.
#
# The skip is value-exact: a block is skipped only when none of its
# vertices changed last round, so its out-edges were last relaxed with
# their sources' current values. Converged distances are bitwise those of
# plain ``vm`` (every label is the min over left-to-right f32 path sums,
# and min is exact in any order). The reference measured the granularity
# (numpy schedule simulation, scrambled 96x96 grid): coarse blocks collect
# 35-80% of the skippable work, single vertices 89-98%, so DW_BLOCK = 1.

# Default dirty-block height (vertices per activity bit).
DW_BLOCK = 1


def build_dw_layout(indptr: np.ndarray, indices: np.ndarray,
                    num_nodes: int, *, vb: int = DW_BLOCK) -> dict:
    """Host layout of the dirty-window route (numpy, once per graph
    structure): per-SOURCE-block out-edge tiles padded to the largest
    block's edge count rounded up to a power of two. CSR order keeps each
    block's out-edges contiguous, so the build is a padded reshape.

    Weight-independent: ``edge_order`` holds each slot's CSR edge
    position (-1 = pad), so callers gather the CURRENT weights and the
    layout survives reweighting.

    Returns a dict with ``e_src`` / ``e_dst`` / ``edge_order`` int32
    [NB+1, Em] (source id, 0 at pads; destination id, ``NB*vb`` >= V at
    pads; CSR edge index, -1 at pads), ``real_ck`` int32 [NB+1] (real
    out-edges per block), ``blk_of_v`` int32 [V], and ``vb``, ``nb``,
    ``em``. Row NB is the all-pad row that an under-full dirty buffer's
    fill value selects."""
    v = num_nodes
    vb = max(1, int(vb))
    nb = max(1, -(-v // vb))
    e = int(indptr[-1])
    bounds = indptr[np.minimum(np.arange(nb + 1) * vb, v)].astype(np.int64)
    counts = np.diff(bounds)
    em = 1 << int(max(int(counts.max(initial=1)), 1) - 1).bit_length()
    edge_order = np.full(((nb + 1) * em,), -1, np.int32)
    src = np.repeat(np.arange(v, dtype=np.int32), np.diff(indptr))
    eidx = np.arange(e, dtype=np.int64)
    blk = src.astype(np.int64) // vb
    edge_order[blk * em + (eidx - bounds[blk])] = eidx.astype(np.int32)
    edge_order = edge_order.reshape(nb + 1, em)
    safe = np.maximum(edge_order, 0)
    e_src = np.where(edge_order >= 0, src[safe], 0)
    e_dst = np.where(edge_order >= 0,
                     np.asarray(indices[:e]).astype(np.int32)[safe],
                     np.int32(nb * vb))
    return {
        "e_src": e_src.astype(np.int32),
        "e_dst": e_dst.astype(np.int32),
        "edge_order": edge_order,
        "real_ck": np.concatenate([counts, [0]]).astype(np.int32),
        "blk_of_v": (np.arange(v, dtype=np.int32) // vb).astype(np.int32),
        "vb": vb,
        "nb": nb,
        "em": em,
    }


def dw_capacity_clamp(capacity: int, nb: int, em: int, batch: int) -> int:
    """The dirty-buffer capacity used: clamped so one round's examined
    addend capacity x Em stays below ``FRONTIER_ADDEND_MAX`` and the
    gathered [capacity x Em, B] candidate tile within 2^24 elements
    (64 MB at f32). Smaller buffers overflow into full sweeps more
    often; the distances never change."""
    capacity = int(min(capacity, nb))
    if em > 0:
        capacity = min(capacity, (FRONTIER_ADDEND_MAX - 1) // em)
        capacity = min(capacity, max(1, (1 << 24) // (em * max(batch, 1))))
    return max(1, capacity)


def bellman_ford_sweeps_dw(dist0_vm, e_src, e_dst, w_tile, blk_of_v,
                           src_bd, dst_bd, w_bd, *, vb: int, capacity: int,
                           max_iter: int, num_real_edges: int,
                           edge_chunk: int = 1 << 20,
                           traj_cap: int | None = None):
    """Dirty-window fixpoint at batch width (see the section note above),
    the reference's ``relax.bellman_ford_sweeps_dw``.

    ``dist0_vm`` is [V, B] vertex-major; ``e_src`` / ``e_dst`` /
    ``w_tile`` the [NB+1, Em] tiles of :func:`build_dw_layout` (weights
    gathered from the current ones); ``src_bd`` / ``dst_bd`` / ``w_bd``
    the destination-sorted COO of the full-sweep fallback
    (:func:`relax_sweep_vm`'s input). Two compacted tiers: the buffer
    holds ``capacity`` blocks (clamped here with
    :func:`dw_capacity_clamp`), and a round with at most a quarter of
    that (at least 64) gathers the smaller tile, so quiet rounds are not
    billed at flood cost.

    The distances live in a [V+1, B] buffer whose last row takes the pad
    slots (the reference's dropped scatter index) and stays +inf. One
    host read per round (the dirty count, which picks the tier and ends
    the loop), counted in ``bellman_ford_sweeps_dw.host_reads``.

    Returns ``(dist_vm, rounds, still_improving, examined, full_rounds)``
    and, with ``traj_cap``, ``(counts, resid, dirty_ct)`` after them:
    the trajectory buffers and the per-round dirty-block counts (host
    int64 [traj_cap]). ``examined`` is an int64 device count of the edge
    SLOTS examined (multiply by B for relaxations; decode with
    :func:`examined_exact`); ``full_rounds`` counts the overflow rounds
    (a host int)."""
    v, b = dist0_vm.shape
    nb = e_src.shape[0] - 1
    em = e_src.shape[1]
    if num_real_edges >= FRONTIER_ADDEND_MAX:
        raise ValueError(
            f"bellman_ford_sweeps_dw: E={num_real_edges} >= 2^31 - 2^20 "
            "breaks the examined counter's full-sweep addend bound the "
            "reference enforces; use the plain sweep routes"
        )
    capacity = dw_capacity_clamp(capacity, nb, em, b)
    cap_small = max(1, min(capacity, max(64, capacity // 4)))
    dev = dist0_vm.device
    e_src = e_src.long()
    e_dst = e_dst.long().clamp_max(v)  # pad slots -> the sentinel row V
    blk_ext = torch.cat([blk_of_v.long(),
                         torch.full((1,), nb, dtype=torch.long, device=dev)])
    block_ids = torch.arange(nb, device=dev)
    d = torch.cat([dist0_vm, torch.full((1, b), INF, dtype=dist0_vm.dtype,
                                        device=dev)])
    examined = torch.zeros((), dtype=torch.int64, device=dev)

    def mark(blocks, hits):
        """Activity bitmap of the blocks ``blocks`` with a True ``hits``
        (block ``nb`` is the pads' and is dropped)."""
        bits = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
        bits.index_add_(0, blocks, hits.to(torch.int32))
        return bits[:nb] > 0

    def frontier_round(changed, cap):
        ids = compact(changed, block_ids, cap, nb)
        s = e_src[ids].reshape(-1)
        t = e_dst[ids].reshape(-1)
        wt = w_tile[ids].reshape(-1)
        cand = d.index_select(0, s) + wt.unsqueeze(1)     # [cap*Em, B]
        old = d.index_select(0, t)
        d.scatter_reduce_(0, t.unsqueeze(1).expand(-1, b), cand, "amin")
        # Winner slots strictly improved their destination in some column
        # AND reached the post-scatter minimum: their destination blocks
        # are next round's dirty ones.
        winner = (cand < old) & (cand == d.index_select(0, t))
        return mark(blk_ext[t], winner.any(1)), (wt < INF).sum(), 0

    def full_round():
        nd = relax_sweep_vm(d[:v], src_bd, dst_bd, w_bd,
                            edge_chunk=edge_chunk)
        improved = (nd < d[:v]).any(1)
        d[:v] = nd
        return mark(blk_ext[:v], improved), num_real_edges, 1

    if traj_cap is not None:
        from paralleljohnson_tpu_torch.observe.convergence import (
            traj_init,
            traj_record,
        )

        counts, resid = traj_init(traj_cap, dev)
        dirty_ct = np.zeros(int(traj_cap), np.int64)
    changed = mark(blk_ext[:v], torch.isfinite(dist0_vm).any(1))
    count = int(changed.sum())
    bump(bellman_ford_sweeps_dw, "host_reads")
    i = fulls = 0
    while count > 0 and i < max_iter:
        prev = d[:v].clone() if traj_cap is not None else None
        if count > capacity:
            changed, ex, full = full_round()
        else:
            changed, ex, full = frontier_round(
                changed, cap_small if count <= cap_small else capacity)
        examined += ex
        fulls += full
        if prev is not None:
            traj_record(counts, resid, i, prev, d[:v], batch_axis=1)
            dirty_ct[min(i, dirty_ct.shape[0] - 1)] += count
        count = int(changed.sum())
        bump(bellman_ford_sweeps_dw, "host_reads")
        i += 1
    out = (d[:v], i, count > 0, examined, fulls)
    if traj_cap is not None:
        return (*out, counts, resid, dirty_ct)
    return out


bellman_ford_sweeps_dw.host_reads = 0


def dw_analytic_cost(examined_slots: int, batch: int, itemsize: int) -> dict:
    """Analytic cost of a dirty-window solve, of the EXAMINED work only
    (the route's point): per examined slot and batch column, an add and a
    min (2 operations) and three touches of a distance (source-row
    gather, destination read, scatter-min write)."""
    cand = float(examined_slots) * float(max(batch, 1))
    return {
        "flops": 2.0 * cand,
        "bytes_accessed": 3.0 * float(itemsize) * cand,
        "transcendentals": 0.0,
    }
