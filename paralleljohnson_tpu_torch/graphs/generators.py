"""Synthetic graph generators: Erdős–Rényi G(n,p) and R-MAT.

Rebuild of the reference's attested generators (SURVEY.md §2 #10-#11; ER
1k/p=0.01 and RMAT-20/22 configs, BASELINE.json:7,10). Fully vectorized
numpy; R-MAT uses per-bit quadrant sampling so scale-22 (4.2M vertices,
~67M edges at edge_factor=16) generates in seconds.
"""

from __future__ import annotations

import numpy as np

from paralleljohnson_tpu_torch.graphs.csr import CSRGraph


def erdos_renyi(
    num_nodes: int,
    p: float,
    *,
    weight_range: tuple[float, float] = (1.0, 10.0),
    negative_fraction: float = 0.0,
    seed: int = 0,
    dtype=np.float32,
) -> CSRGraph:
    """Directed G(n, p) with uniform weights.

    ``negative_fraction`` of edges get their weight negated (uniformly at
    random) — used to exercise the Bellman-Ford path. Note negated weights
    can create negative cycles; tests that need cycle-free graphs use
    :func:`random_dag` or keep the fraction at 0.
    """
    rng = np.random.default_rng(seed)
    # Sample edge count then distinct pairs — O(E) memory, not O(V^2).
    max_pairs = num_nodes * (num_nodes - 1)
    num_edges = rng.binomial(max_pairs, p) if max_pairs else 0
    # Sample linear indices over the V*(V-1) off-diagonal slots without
    # replacement via a float-key argsort trick on oversampled candidates.
    flat = rng.choice(max_pairs, size=num_edges, replace=False) if num_edges else np.array([], np.int64)
    src = flat // (num_nodes - 1) if num_nodes > 1 else flat
    rem = flat % (num_nodes - 1) if num_nodes > 1 else flat
    dst = rem + (rem >= src)  # skip the diagonal slot
    w = rng.uniform(*weight_range, size=num_edges).astype(dtype)
    if negative_fraction > 0:
        neg = rng.random(num_edges) < negative_fraction
        w = np.where(neg, -w, w)
    return CSRGraph.from_edges(src, dst, w, num_nodes, dtype=dtype)


def random_dag(
    num_nodes: int,
    p: float,
    *,
    weight_range: tuple[float, float] = (1.0, 10.0),
    negative_fraction: float = 0.3,
    seed: int = 0,
    dtype=np.float32,
) -> CSRGraph:
    """ER graph restricted to forward edges (u < v) under a random vertex
    permutation: guaranteed acyclic, so any negative_fraction is safe for
    Johnson (negative weights, never a negative cycle)."""
    g = erdos_renyi(
        num_nodes, p, weight_range=weight_range,
        negative_fraction=negative_fraction, seed=seed, dtype=dtype,
    )
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(num_nodes).astype(np.int64)
    src, dst = perm[g.src], perm[g.indices]
    keep = src < dst
    return CSRGraph.from_edges(src[keep], dst[keep], g.weights[keep],
                               num_nodes, dtype=dtype)


def rmat(
    scale: int,
    edge_factor: int = 16,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    weight_range: tuple[float, float] = (1.0, 10.0),
    seed: int = 0,
    dedupe: bool = True,
    dtype=np.float32,
) -> CSRGraph:
    """R-MAT (Graph500-style) power-law generator: V = 2**scale,
    E = edge_factor * V before dedupe. Quadrant probabilities (a, b, c, d)
    with d = 1-a-b-c; each of the ``scale`` address bits of (src, dst) is
    sampled independently per edge (vectorized over all edges at once)."""
    d = 1.0 - a - b - c
    if d < 0:
        raise ValueError("a + b + c must be <= 1")
    rng = np.random.default_rng(seed)
    num_nodes = 1 << scale
    num_edges = edge_factor * num_nodes
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    for _ in range(scale):
        r = rng.random(num_edges)
        src_bit = r >= a + b          # quadrants c, d set the src bit
        dst_bit = (r >= a) & (r < a + b) | (r >= a + b + c)  # b or d
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    # Permute vertex labels to break the high-degree-at-0 artifact.
    perm = rng.permutation(num_nodes)
    src, dst = perm[src], perm[dst]
    keep = src != dst  # drop self-loops
    src, dst = src[keep], dst[keep]
    w = rng.uniform(*weight_range, size=len(src)).astype(dtype)
    return CSRGraph.from_edges(src, dst, w, num_nodes, dedupe=dedupe, dtype=dtype)


def permute_labels(graph: CSRGraph, *, seed: int = 0) -> CSRGraph:
    """The same graph under a uniformly random vertex relabeling
    (weights carried per edge, structure otherwise identical).

    Why this exists (round-5 verdict next #3): the benchmark stand-ins'
    NATURAL labelings carry structure the real datasets do not — a
    ``grid2d`` in row-major order puts every edge on 4 index diagonals,
    which is exactly what qualifies the DIA route, while a real DIMACS
    file's labeling is effectively arbitrary. Scrambling the labels
    produces the honest proxy: same distances (up to the relabeling),
    same degree profile and diameter, no labeling gift."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(graph.num_nodes).astype(np.int64)
    return CSRGraph.from_edges(
        perm[graph.src], perm[graph.indices], graph.weights,
        graph.num_nodes, dtype=graph.weights.dtype,
    )


def random_graph_batch(
    batch: int,
    num_nodes: int,
    p: float,
    *,
    weight_range: tuple[float, float] = (1.0, 10.0),
    seed: int = 0,
    dtype=np.float32,
) -> list[CSRGraph]:
    """The many-small-graphs config (BASELINE.json:11): ``batch`` independent
    ER graphs. Returned as a list; :func:`stack_graphs` pads them."""
    return [
        erdos_renyi(num_nodes, p, weight_range=weight_range, seed=seed + i,
                    dtype=dtype)
        for i in range(batch)
    ]


def grid2d(
    rows: int,
    cols: int,
    *,
    weight_range: tuple[float, float] = (1.0, 10.0),
    negative_fraction: float = 0.0,
    seed: int = 0,
    dtype=np.float32,
) -> CSRGraph:
    """Road-network-like graph: a 2-D lattice with bidirectional edges and
    O(rows+cols) diameter — the high-diameter stress profile of the DIMACS
    road graphs (BASELINE.json:8 "DIMACS-NY"), which cannot be downloaded
    in this zero-egress environment; benchmarks use this as the documented
    stand-in (DIMACS-NY: 264k nodes / 733k arcs / diameter ~700; a 515x515
    grid matches the node count and stresses the same sweep-count regime).

    ``negative_fraction`` of the *forward* edges (right/down, u < v) get a
    negative weight drawn from (−0.99·w_min, 0). Any lattice cycle takes
    equally many forward and backward steps, and every backward edge costs
    at least w_min, so a cycle's weight is ≥ k·(w_min − 0.99·w_min) > 0 —
    strictly no negative cycles for any fraction and any weight_range.
    """
    rng = np.random.default_rng(seed)
    n = rows * cols
    idx = np.arange(n, dtype=np.int64).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()])
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()])
    fwd = np.concatenate([right, down], axis=1)
    src = np.concatenate([fwd[0], fwd[1]])
    dst = np.concatenate([fwd[1], fwd[0]])
    w = rng.uniform(*weight_range, size=src.shape[0]).astype(dtype)
    if negative_fraction > 0:
        forward = src < dst
        neg = (rng.random(src.shape[0]) < negative_fraction) & forward
        neg_w = -0.99 * weight_range[0] * rng.random(src.shape[0])
        w = np.where(neg, neg_w, w).astype(dtype)
    return CSRGraph.from_edges(src, dst, w, n, dtype=dtype)
