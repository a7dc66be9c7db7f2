"""Blocked Gauss-Seidel SSSP / fan-out (route ``gs``) — the PyTorch
port of the JAX package's ``ops/gauss_seidel.py``.

The Jacobi sweeps need ~diameter rounds on a road grid. Blocked
Gauss-Seidel attacks the round COUNT:

  1. vertices are relabeled by reverse Cuthill-McKee (host, scipy), so
     every edge runs between nearby labels;
  2. the relabeled vertices are cut into NB blocks of ``vb``, each
     storing its INCOMING edges (dst-sorted, block-local dst ids);
  3. an outer round sweeps the blocks forward, then backward, and
     iterates each block to a local fixpoint (at most ``inner_cap``
     inner iterations), so later blocks see earlier blocks' updates and
     one half-round carries distances along the whole ribbon;
  4. a block none of whose ``[j - halo, j + halo]`` window (or, with
     ``in_adj``, none of whose in-neighbour blocks) changed since its
     last fix provably cannot improve and is skipped.

Dirty-flag protocol (exact): ``c_prev`` holds each block's change flag
from the previous half-round, ``c_cur`` the current half-round's so far;
a block's last fix was at most one half-round ago, so the union of the
two covers every change since then.

The schedule is the reference's, step for step, so the outer rounds and
the per-block inner iteration counts (``iters_blk``, the work account)
agree with it. The reference runs it inside one ``lax.while_loop``; here
the loop runs on the host with one read per inner iteration (the block's
"changed" flag, which also decides the skips), counted in
``_gs_engine.host_reads``. The block flags live on the host.

Correctness: relaxation is monotone and the skips are value-exact, so
outer round r subsumes Jacobi round r: still improving after
``max_outer >= V`` rounds certifies a reachable negative cycle.
"""

from __future__ import annotations

import numpy as np
import torch

from paralleljohnson_tpu_torch.ops.relax import (
    INF,
    bucket_edges_by_dst_block,
)


def _gs_engine(dist0, src_blk, dstl_blk, w_blk, *, vb: int, halo: int,
               max_outer: int, inner_cap: int, traj_cap: int | None = None,
               in_adj=None):
    """Shared fixpoint engine. ``dist0`` is [NB*vb] (SSSP) or [NB*vb, B]
    (vertex-major fan-out), in relabeled ids; see the module docstring
    for the schedule.

    ``traj_cap``: record each OUTER round's improved vertices / labels /
    residual mass (``observe.convergence``) and append ``(traj_counts,
    traj_resid)`` to the return. None runs the loop without recording.

    ``in_adj``: an optional host bool [NB, >=NB] block in-adjacency mask
    (``in_adj[j, i]`` True iff an edge runs from block i into block j):
    the dirty test then reads exactly the in-neighbour blocks instead of
    the ``halo`` window.

    Returns (dist, outer_rounds, still_improving, iters_blk) where
    ``iters_blk`` is a host int64 [NB] array: each block's inner
    iterations over all its visits (the reference's int32 counter; the
    caller checks its bound, ``utils.metrics.warn_if_counter_wrapped``).
    """
    nb = src_blk.shape[0]
    batched = dist0.dim() == 2
    win = 2 * halo + 1
    flags_len = max(nb, win)
    if in_adj is not None:
        in_adj = np.asarray(in_adj, bool)
        if in_adj.shape[1] < flags_len:
            in_adj = np.pad(in_adj, ((0, 0), (0, flags_len - in_adj.shape[1])))
    d = dist0.clone()
    seg_shape = (vb + 1, d.shape[1]) if batched else (vb + 1,)
    iters_blk = np.zeros(nb, np.int64)

    def block_fix(j: int) -> tuple[int, bool]:
        """Iterate block j's incoming edges to its local fixpoint (at most
        ``inner_cap`` iterations): (inner iterations, ever changed)."""
        s = src_blk[j].long()
        t = dstl_blk[j].long()
        wt = w_blk[j]
        if batched:
            wt = wt[:, None]
            t = t[:, None].expand(-1, d.shape[1])
        blk = d[j * vb:(j + 1) * vb]
        i, changed, ever = 0, True, False
        while changed and i < inner_cap:
            cand = d[s] + wt
            upd = torch.full(seg_shape, INF, dtype=d.dtype, device=d.device)
            upd = upd.scatter_reduce_(0, t, cand, "amin")[:vb]
            changed = bool((upd < blk).any())
            _gs_engine.host_reads += 1
            torch.minimum(blk, upd, out=blk)
            i += 1
            ever = ever or changed
        return i, ever

    def half_round(order, c_prev) -> tuple[np.ndarray, bool]:
        c_cur = np.zeros(flags_len, bool)
        any_changed = False
        for j in order:
            if in_adj is None:
                start = min(max(j - halo, 0), flags_len - win)
                dirty = bool((c_prev[start:start + win]
                              | c_cur[start:start + win]).any())
            else:
                dirty = bool((in_adj[j] & (c_prev | c_cur)).any())
            if dirty:
                iters, changed = block_fix(j)
                iters_blk[j] += iters
                c_cur[j] = changed
                any_changed = any_changed or changed
        return c_cur, any_changed

    if traj_cap is not None:
        from paralleljohnson_tpu_torch.observe.convergence import (
            traj_init,
            traj_record,
        )

        counts, resid = traj_init(traj_cap, d.device)
    changed = bool(torch.isfinite(dist0).any())
    _gs_engine.host_reads += 1
    c_prev = np.ones(flags_len, bool)
    rounds = 0
    while changed and rounds < max_outer:
        before = d.clone() if traj_cap is not None else None
        c_fwd, ch_f = half_round(range(nb), c_prev)
        c_prev, ch_b = half_round(range(nb - 1, -1, -1), c_fwd)
        changed = ch_f or ch_b
        if traj_cap is not None:
            traj_record(counts, resid, rounds, before, d,
                        batch_axis=1 if batched else None)
        rounds += 1
    if traj_cap is None:
        return d, rounds, changed, iters_blk
    return d, rounds, changed, iters_blk, counts, resid


_gs_engine.host_reads = 0


def sssp_gs_blocks(dist0, src_blk, dstl_blk, w_blk, *, vb: int, halo: int,
                   max_outer: int, inner_cap: int = 64,
                   traj_cap: int | None = None, in_adj=None):
    """Blocked Gauss-Seidel SSSP on a layout from :func:`build_gs_layout`:
    ``dist0`` f32[NB*vb] in RELABELED ids (+inf, 0 at the source's new
    label; pad vertices +inf); ``src_blk`` int32[NB, Em] global source
    ids bucketed by destination block (pads 0 with +inf weight);
    ``dstl_blk`` int32[NB, Em] block-local destinations in [0, vb], ``vb``
    the pad sentinel; ``w_blk`` f32[NB, Em]; ``halo`` the bound on
    |block(src) - block(dst)|. Returns :func:`_gs_engine`'s tuple."""
    return _gs_engine(dist0, src_blk, dstl_blk, w_blk, vb=vb, halo=halo,
                      max_outer=max_outer, inner_cap=inner_cap,
                      traj_cap=traj_cap, in_adj=in_adj)


def fanout_gs_blocks(dist0_vm, src_blk, dstl_blk, w_blk, *, vb: int,
                     halo: int, max_outer: int, inner_cap: int = 64,
                     traj_cap: int | None = None, in_adj=None):
    """Multi-source :func:`sssp_gs_blocks`: dist [NB*vb, B] vertex-major
    on the same layout. Callers multiply ``iters_blk`` by the per-block
    real edges AND the batch width B."""
    return _gs_engine(dist0_vm, src_blk, dstl_blk, w_blk, vb=vb, halo=halo,
                      max_outer=max_outer, inner_cap=inner_cap,
                      traj_cap=traj_cap, in_adj=in_adj)


def fanout_gs_body(srcs, src_blk, dstl_blk, w_blk, rank, *, v_pad: int,
                   vb: int, halo: int, max_outer: int, inner_cap: int,
                   traj_cap: int | None = None, in_adj=None):
    """The fan-out from the ORIGINAL source ids ``srcs``: dist0 seeded at
    ``rank[srcs]``, the blocked engine, rows mapped back to the original
    labels. Returns (dist [B, V], rounds, still_improving, iters_blk),
    plus the trajectory buffers when ``traj_cap`` is set (frontier counts
    do not depend on the labels)."""
    b = srcs.shape[0]
    dist0 = torch.full((v_pad, b), INF, dtype=w_blk.dtype,
                       device=w_blk.device)
    dist0[rank[srcs.long()].long(),
          torch.arange(b, device=w_blk.device)] = 0.0
    out = fanout_gs_blocks(dist0, src_blk, dstl_blk, w_blk, vb=vb, halo=halo,
                           max_outer=max_outer, inner_cap=inner_cap,
                           traj_cap=traj_cap, in_adj=in_adj)
    dist, rounds, improving, iters_blk = out[:4]
    return (dist[rank.long(), :].t().contiguous(), rounds, improving,
            iters_blk, *out[4:])


def build_gs_layout(
    indptr: np.ndarray, indices: np.ndarray, weights: np.ndarray | None,
    num_nodes: int, *, vb: int = 4096, pad_multiple: int = 512,
):
    """Host preprocessing for the blocked Gauss-Seidel kernels
    (numpy/scipy, once per graph STRUCTURE): RCM relabeling +
    per-destination-block edge bucketing.

    Weight-independent: the RCM permutation and the bucketing use
    structure alone, and ``edge_order`` (original edge index per slot,
    -1 = pad) lets callers gather CURRENT device weights per solve —
    so the layout survives Johnson reweighting.
    ``weights=None`` skips the convenience ``w_blk``.

    Returns a dict with
      perm   int32[V]  — new label -> old vertex id
      rank   int32[V]  — old vertex id -> new label
      src_blk / dstl_blk  — [NB, Em] arrays (see kernel docs)
      edge_order int32[NB, Em] — original edge index, -1 = pad
      w_blk  — [NB, Em] weights (+inf pads); only when ``weights`` given
      real_edges_blk int64[NB], vb, v_pad (= NB*vb),
      halo   int — max |block(src) - block(dst)| over edges (dirty-window
                   radius; small after RCM on road-like graphs)
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    v = num_nodes
    # Real edges only: ``indices`` may carry a pad tail (a re-uploaded
    # pad_edges graph), but ``indptr`` always describes the real edges.
    e = int(indptr[-1])
    indices = indices[:e]
    src = np.repeat(np.arange(v, dtype=np.int32), np.diff(indptr))
    a = sp.csr_matrix(
        (np.ones(e, np.int8), indices.astype(np.int64), indptr.astype(np.int64)),
        shape=(v, v),
    )
    # RCM wants a symmetric structure; direction does not matter for
    # bandwidth reduction.
    perm = reverse_cuthill_mckee(
        (a + a.T).tocsr(), symmetric_mode=True
    ).astype(np.int32)
    rank = np.empty(v, np.int32)
    rank[perm] = np.arange(v, dtype=np.int32)

    src_n = rank[src]
    dst_n = rank[indices]
    nb = max(1, -(-v // vb))
    v_pad = nb * vb
    halo = int(np.abs(src_n // vb - dst_n // vb).max()) if e else 0
    # Exact block-to-block in-adjacency (the dirty-window extension):
    # in_adj[j, i] True iff an edge runs from block i into block j. A strict subset of the halo window wherever the RCM
    # bandwidth bound is loose; bool[NB, NB] is tiny next to the edge
    # buckets.
    in_adj = np.zeros((nb, nb), bool)
    if e:
        in_adj[dst_n // vb, src_n // vb] = True
    order, counts = bucket_edges_by_dst_block(dst_n, vb, nb)
    src_n, dst_n = src_n[order], dst_n[order]
    em = int(max(counts.max(), 1))
    em = -(-em // pad_multiple) * pad_multiple

    src_blk = np.zeros((nb, em), np.int32)
    dstl_blk = np.full((nb, em), vb, np.int32)  # pad sentinel
    order_blk = np.full((nb, em), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for j in range(nb):
        c = counts[j]
        sl = slice(starts[j], starts[j] + c)
        src_blk[j, :c] = src_n[sl]
        dstl_blk[j, :c] = dst_n[sl] - j * vb
        order_blk[j, :c] = order[sl]

    out = {
        "perm": perm,
        "rank": rank,
        "src_blk": src_blk,
        "dstl_blk": dstl_blk,
        "edge_order": order_blk,
        "real_edges_blk": counts.astype(np.int64),
        "vb": vb,
        "v_pad": v_pad,
        "halo": halo,
        "in_adj": in_adj,
    }
    if weights is not None:
        # The same gather the device-side path applies to edge_order.
        out["w_blk"] = np.where(
            order_blk >= 0,
            weights[:e][np.maximum(order_blk, 0)],
            np.inf,
        ).astype(weights.dtype)
    return out
