"""The Graph 500 Kronecker generator, on the device.

As the specification's reference generator draws it: ``edge_factor *
2**scale`` undirected edges; for each of the ``scale`` bits of an edge's
endpoints (i, j), i's bit is set with probability C + D and j's bit with
probability B / (A + B) or D / (C + D) after it; then the vertex labels
are permuted at random. Each undirected edge becomes two arcs with one
integer weight drawn from ``weights`` (the specification draws reals in
[0, 1); integers keep every path sum exact in float32). Self-loops are
dropped and, of parallel arcs, the lightest is kept. Everything is drawn
from one ``torch.Generator`` on ``device`` seeded with ``seed``, and
sorted there; only the CSR arrays come to the host.
"""

from __future__ import annotations

import torch


def build(params: dict, seed: int, device) -> dict:
    """The CSR arrays of the configuration ``params`` drawn from ``seed``."""
    scale = int(params["scale"])
    n = 1 << scale
    m = int(params["edge_factor"]) * n
    a, b, c, d = (float(x) for x in params["initiator"])
    if abs(a + b + c + d - 1.0) > 1e-9:
        raise ValueError("the initiator's four probabilities must sum to 1")
    lo, hi = int(params["weights"]["low"]), int(params["weights"]["high"])
    if not 1 <= lo <= hi or hi >= 1 << 8:
        raise ValueError("integer weights must lie in [1, 255]")
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    ab, c_norm, a_norm = a + b, c / (c + d), a / (a + b)
    i = torch.zeros(m, dtype=torch.int64, device=dev)
    j = torch.zeros(m, dtype=torch.int64, device=dev)
    for bit in range(scale):
        i_bit = torch.rand(m, generator=g, device=dev) > ab
        j_thr = torch.where(i_bit, c_norm, a_norm)
        j_bit = torch.rand(m, generator=g, device=dev) > j_thr
        i |= i_bit.to(torch.int64) << bit
        j |= j_bit.to(torch.int64) << bit
        del i_bit, j_thr, j_bit
    w = torch.randint(lo, hi + 1, (m,), generator=g, device=dev)
    perm = torch.randperm(n, generator=g, device=dev)
    i, j = perm[i], perm[j]
    del perm
    u = torch.cat([i, j])
    v = torch.cat([j, i])
    w = torch.cat([w, w])
    del i, j
    keep = u != v
    # One int64 key per arc: (u, v, w) in 22 + 22 + 8 bits at scale 22, so
    # that one sort orders the arcs by (u, v) with the lightest first.
    key = ((u << (scale + 8)) | (v << 8) | w)[keep]
    del u, v, w, keep
    key = torch.sort(key).values
    pair = key >> 8
    first = torch.ones_like(pair, dtype=torch.bool)
    first[1:] = pair[1:] != pair[:-1]
    key = key[first]
    del pair, first
    u = key >> (scale + 8)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(u, minlength=n), 0)
    out = {
        "indptr": indptr.to(torch.int32).cpu().numpy(),
        "indices": ((key >> 8) & (n - 1)).to(torch.int32).cpu().numpy(),
        "weights": (key & 0xFF).to(torch.float32).cpu().numpy(),
    }
    del key, u, indptr
    return out


def count(params: dict) -> dict:
    """Vertices and the arcs drawn before self-loops and parallel arcs go."""
    n = 1 << int(params["scale"])
    return {"vertices": n, "arcs_drawn": 2 * int(params["edge_factor"]) * n}
