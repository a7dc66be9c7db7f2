"""Condense-solve-expand partitioned APSP (route ``condensed+fw``): the
counterpart of the JAX package's ``solver/partitioned.py``.

Large sparse graphs pay for APSP as B independent gather-bound sweeps.
This route buys them a dense core instead:

  1. **Partition** the vertices around k seeded pivots, each vertex to
     its hop-nearest pivot over the undirected structure (partition
     quality only moves work between stages; stranded vertices go
     round-robin).
  2. **Close each part locally**: blocked FW (``ops.fw``) on the part's
     dense submatrix, exact distances using only that part's vertices.
  3. **Condense**: boundary vertices (endpoints of cross-part edges) form
     the core, seeded with each part's local boundary-to-boundary
     closure min'd with the raw cross edges; blocked FW on the dense core
     gives exact boundary-to-boundary distances in the full graph.
  4. **Expand**, per source part P: ``s2core = local_P[S, dP] (x)
     core[dP, :]`` and, for targets in part Q, ``min(local_P[S, Q] if Q
     == P, s2core[:, dQ] (x) local_Q[dQ, Q])``.

Exact, not an approximation: a shortest path splits into within-part
runs joined by cross edges, priced by steps 2-4. Distances are bitwise
the reference's whenever the weights are exact in f32 (integers); with
general f32 weights the route agrees to ULP-level reassociation with
other routes. Negative edges need no Johnson phases (FW is
sign-agnostic); a cycle inside a part turns a local closure's diagonal
negative, one across parts the core's.

The partition, the block gathers and the assembly are host numpy; the
closures and the min-plus products run on ``device`` (the hand Kleene
and min-plus kernels on the card, their plain versions on the CPU).
``info["seconds"]`` splits the route's wall into partition, local
closures, core closure, expansion and predecessors.

Work accounting: exact tropical MACs, host ints: each closure's
``fw_mac_count`` plus the expansion products' 128-padded MAC counts.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from paralleljohnson_tpu_torch.graphs import CSRGraph
from paralleljohnson_tpu_torch.ops import fw
from paralleljohnson_tpu_torch.ops.minplus import minplus_kernel

ROUTE_TAG = "condensed+fw"


def auto_num_parts(v: int) -> int:
    """Default partition count: ~sqrt(V)/8 clamped to [2, 32]. Any value
    is correct; this only shapes the work split."""
    return max(2, min(32, int(math.isqrt(max(v, 4))) // 8 or 2))


def partition_by_pivots(
    graph: CSRGraph, num_parts: int, *, seed: int = 0
) -> np.ndarray:
    """int64[V] part label per vertex: k pivots drawn with
    ``np.random.default_rng(seed).choice`` (the reference's draw, so both
    packages partition identically), then hop-layered BFS over the
    UNDIRECTED structure. Ties break to the smallest pivot label.
    Vertices unreachable from every pivot are assigned round-robin."""
    v = graph.num_nodes
    k = max(1, min(int(num_parts), max(v, 1)))
    rng = np.random.default_rng(seed)
    pivots = np.sort(rng.choice(v, size=k, replace=False))
    labels = np.full(v, -1, np.int64)
    labels[pivots] = np.arange(k)
    e = graph.num_real_edges
    us = np.concatenate([graph.src[:e], graph.indices[:e]])
    vs = np.concatenate([graph.indices[:e], graph.src[:e]])
    while True:
        cand = np.full(v, np.iinfo(np.int64).max, np.int64)
        live = labels[us] >= 0
        np.minimum.at(cand, vs[live], labels[us[live]])
        fresh = (labels < 0) & (cand < np.iinfo(np.int64).max)
        if not fresh.any():
            break
        labels[fresh] = cand[fresh]
    left = np.flatnonzero(labels < 0)
    if left.size:
        labels[left] = np.arange(left.size) % k
    return labels


def _fw_closed(a_np: np.ndarray, tile_cfg: int, device):
    """Blocked-FW closure of one dense block on ``device`` (host in, host
    out). Returns (closed [n, n], negative_cycle bool, macs int, k_steps
    int). Zero-sized blocks short-circuit."""
    n = a_np.shape[0]
    if n == 0:
        return a_np, False, 0, 0
    tile = fw.effective_tile(n, tile_cfg)
    vp = fw.pad_tiles(n, tile)
    closed, neg = fw.fw_closure(
        fw.pad_dense(torch.as_tensor(a_np).to(device), tile), tile=tile)
    return (closed[:n, :n].cpu().numpy(), neg, fw.fw_mac_count(vp, tile),
            vp // tile)


def _pad128(n: int) -> int:
    return 128 * max(1, -(-n // 128))


def _mp(d: np.ndarray, a: np.ndarray, device) -> np.ndarray:
    """One expansion min-plus product ([B, K] (x) [K, N]) on ``device``
    (``minplus_kernel``), back on the host. All three dims are padded to
    128 multiples with +inf no-ops, as the reference pads them, so
    :func:`_mp_macs` counts the work the product does."""
    b, k = d.shape
    n = a.shape[1]
    bp, kp, np_ = _pad128(b), _pad128(k), _pad128(n)
    dp = np.full((bp, kp), np.inf, d.dtype)
    dp[:b, :k] = d
    ap = np.full((kp, np_), np.inf, a.dtype)
    ap[:k, :n] = a
    out = minplus_kernel(torch.as_tensor(dp).to(device),
                         torch.as_tensor(ap).to(device))
    return out[:b, :n].cpu().numpy()


def _mp_macs(b: int, k: int, n: int) -> int:
    """Exact candidate ops of one padded expansion product (the pad
    no-ops are performed, so they are counted)."""
    return _pad128(b) * _pad128(k) * _pad128(n)


def _dense_block(graph, verts, lid, part_mask_src, src, dst, w):
    """Dense [n, n] submatrix of ``verts`` (0 diagonal, +inf non-edges,
    parallel edges resolved to the min) from the within-part edges."""
    n = verts.size
    a = np.full((n, n), np.inf, dtype=graph.dtype)
    np.fill_diagonal(a, 0.0)
    sel = np.flatnonzero(part_mask_src)
    if sel.size:
        np.minimum.at(a, (lid[src[sel]], lid[dst[sel]]), w[sel])
    return a


def solve_condensed(
    graph: CSRGraph,
    sources: np.ndarray | None = None,
    *,
    config=None,
    predecessors: bool = False,
    num_parts: int | None = None,
    seed: int = 0,
    device="cpu",
):
    """Exact partitioned APSP (see the module docstring) on ``device``.

    Returns ``(dist [B, V] host float, pred [B, V] int32 or None, info)``;
    ``info`` carries the route tag, exact MAC totals, k-step count, part
    and core sizes, ``pred_ok`` (None without predecessors; False when
    the tree check rejected the one-pass extraction, and the caller falls
    back to the standard route), the resolved ``params`` with their
    ``params_source`` (an explicit config value or argument, else the
    default: ``DEFAULT_FW_TILE`` and :func:`auto_num_parts`), and
    ``seconds`` by stage. Raises ``NegativeCycleError`` on any reachable
    negative cycle."""
    from paralleljohnson_tpu_torch.solver.johnson import NegativeCycleError

    device = torch.device(device)
    v = graph.num_nodes
    sources = (
        np.arange(v, dtype=np.int64)
        if sources is None
        else np.asarray(sources, np.int64)
    )
    cfg_tile = getattr(config, "fw_tile", None)
    tile_cfg = int(cfg_tile) if cfg_tile is not None else fw.DEFAULT_FW_TILE
    tile_source = "config" if cfg_tile is not None else "default"
    explicit = num_parts or getattr(config, "partition_parts", None)
    k = int(explicit) if explicit is not None else auto_num_parts(v)
    parts_source = "config" if explicit is not None else "default"
    seconds = {}
    t0 = time.perf_counter()

    labels = partition_by_pivots(graph, k, seed=seed)
    part_ids = np.unique(labels)
    parts = [np.flatnonzero(labels == p) for p in part_ids]

    e = graph.num_real_edges
    src, dst, w = graph.src[:e], graph.indices[:e], graph.weights[:e]
    cross = labels[src] != labels[dst]
    boundary_mask = np.zeros(v, bool)
    boundary_mask[src[cross]] = True
    boundary_mask[dst[cross]] = True
    boundary = np.flatnonzero(boundary_mask)
    core_idx = np.full(v, -1, np.int64)
    core_idx[boundary] = np.arange(boundary.size)
    nc = boundary.size
    seconds["partition"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    macs = 0
    k_steps = 0
    lids = np.full(v, -1, np.int64)  # local id within own part
    locals_closed: list[np.ndarray] = []
    blocal: list[np.ndarray] = []  # per part: local ids of boundary verts
    bcore: list[np.ndarray] = []   # per part: core ids of those verts
    for p, verts in zip(part_ids, parts):
        lids[verts] = np.arange(verts.size)
        closed, neg, m, ks = _fw_closed(
            _dense_block(
                graph, verts, lids,
                (labels[src] == p) & ~cross, src, dst, w,
            ),
            tile_cfg, device,
        )
        if neg:
            raise NegativeCycleError(
                "negative-weight cycle inside a partition (condensed route)"
            )
        macs += m
        k_steps += ks
        locals_closed.append(closed)
        bv = verts[boundary_mask[verts]]
        blocal.append(lids[bv])
        bcore.append(core_idx[bv])
    seconds["local_closures"] = time.perf_counter() - t0

    # Condensed dense core: each part's local boundary-to-boundary
    # closure min'd with the raw cross edges, then closed with FW.
    t0 = time.perf_counter()
    core = np.full((nc, nc), np.inf, dtype=graph.dtype)
    if nc:
        np.fill_diagonal(core, 0.0)
        for closed, bl, bc in zip(locals_closed, blocal, bcore):
            if bl.size:
                core[np.ix_(bc, bc)] = np.minimum(
                    core[np.ix_(bc, bc)], closed[np.ix_(bl, bl)]
                )
        np.minimum.at(
            core, (core_idx[src[cross]], core_idx[dst[cross]]), w[cross]
        )
    core_closed, neg, m, ks = _fw_closed(core, tile_cfg, device)
    if neg:
        raise NegativeCycleError(
            "negative-weight cycle across partitions (condensed route)"
        )
    macs += m
    k_steps += ks
    seconds["core_closure"] = time.perf_counter() - t0

    # Expansion: one batched min-plus fan-out per source partition. A
    # (source part P -> target part Q) product whose s2core slice for Q
    # is all +inf can lower nothing and is skipped exactly (the
    # reference's dirty-window gate; dirty_window=False disables it),
    # its padded MACs counted as skipped.
    t0 = time.perf_counter()
    dw_gate = getattr(config, "dirty_window", "auto") is not False
    expand_skipped = 0
    macs_skipped = 0
    dist = np.full((sources.size, v), np.inf, dtype=graph.dtype)
    src_rows_seen: dict[int, list[int]] = {}
    for i, s in enumerate(sources):
        src_rows_seen.setdefault(int(s), []).append(i)
    for pi, (p, verts) in enumerate(zip(part_ids, parts)):
        rows = [r for s in verts for r in src_rows_seen.get(int(s), [])]
        if not rows:
            continue
        rows = np.asarray(rows, np.int64)
        ls = lids[sources[rows]]
        local_p = locals_closed[pi]
        dist[np.ix_(rows, verts)] = local_p[ls]
        if nc == 0 or blocal[pi].size == 0:
            continue  # no way out of this part: local rows are final
        s2core = _mp(local_p[np.ix_(ls, blocal[pi])], core_closed[bcore[pi]],
                     device)
        macs += _mp_macs(rows.size, blocal[pi].size, nc)
        for qi, (q, verts_q) in enumerate(zip(part_ids, parts)):
            if blocal[qi].size == 0:
                continue  # no way into q from outside
            entry = s2core[:, bcore[qi]]
            if dw_gate and not np.isfinite(entry).any():
                expand_skipped += 1
                macs_skipped += _mp_macs(
                    rows.size, blocal[qi].size, verts_q.size
                )
                continue
            upd = _mp(entry, locals_closed[qi][blocal[qi]], device)
            macs += _mp_macs(rows.size, blocal[qi].size, verts_q.size)
            dist[np.ix_(rows, verts_q)] = np.minimum(
                dist[np.ix_(rows, verts_q)], upd
            )
    seconds["expansion"] = time.perf_counter() - t0

    route = ROUTE_TAG
    pred = None
    pred_ok = None
    if predecessors:
        t0 = time.perf_counter()
        pred, pred_ok = _extract_pred(graph, dist, sources, config, device)
        if pred_ok:
            route = ROUTE_TAG + "+pred"
        else:
            pred = None
        seconds["predecessors"] = time.perf_counter() - t0

    info = {
        "route": route,
        "macs": int(macs),
        "k_steps": int(k_steps),
        "num_parts": len(parts),
        "core_size": int(nc),
        "part_sizes": [int(p.size) for p in parts],
        "pred_ok": pred_ok,
        "expand_products_skipped": int(expand_skipped),
        "expand_macs_skipped": int(macs_skipped),
        "params": {"fw_tile": tile_cfg, "partition_parts": int(k)},
        "params_source": {"fw_tile": tile_source,
                          "partition_parts": parts_source},
        "seconds": seconds,
    }
    return dist, pred, info


def _extract_pred(graph: CSRGraph, dist: np.ndarray, sources: np.ndarray,
                  config, device):
    """One tight-edge extraction pass over the expanded distances and its
    tree check, as every route's trees come (``TorchBackend._extract``:
    the hand ``tight_pred`` kernel on the card). Returns (pred [B, V]
    int32 host, ok)."""
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend
    from paralleljohnson_tpu_torch.config import SolverConfig

    backend = TorchBackend(config or SolverConfig(), device=device)
    dgraph = backend.upload(graph)
    d = torch.as_tensor(dist).to(device)
    pred, ok = backend._extract(dgraph, d.t().contiguous(), d, sources)
    return pred.cpu().numpy(), ok
