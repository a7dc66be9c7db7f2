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

Every function takes and returns tensors on the caller's device; loops
whose trip count depends on the data read one flag per iteration to the
host, unless a grouped fixpoint is passed in (``dense_fanout``'s
``fixpoint=``, ``ops.minplus.minplus_fixpoint`` on the card).
"""

from __future__ import annotations

import math

import torch

INF = float("inf")

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
    d = dist0
    improving = bool(torch.isfinite(dist0).any())
    i = 0
    while improving and i < max_iter:
        nd = relax_sweep(d, src, dst, w, edge_chunk=edge_chunk)
        improving = bool((nd < d).any())
        d = nd
        i += 1
    return d, i, improving


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
