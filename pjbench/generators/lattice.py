"""A bidirectional 2-D lattice with negative forward arcs, on the device.

A graph with negative arcs and no negative cycle, for phase 1 and the
check of its potentials: ``rows x cols`` vertices, an arc each way
between lattice neighbours, integer weights uniform in ``weights``; a
share ``negative_fraction`` of the forward arcs (right and down, u < v)
get an integer weight in [-``negative_magnitude``, -1]. Every lattice
cycle takes as many forward steps as backward ones, and a backward arc
weighs at least ``weights.low`` > ``negative_magnitude``, so no cycle is
negative. Drawn from one ``torch.Generator`` on ``device`` seeded with
``seed``; only the CSR arrays come to the host.
"""

from __future__ import annotations

import torch


def build(params: dict, seed: int, device) -> dict:
    """The CSR arrays of the configuration ``params`` drawn from ``seed``."""
    rows, cols = int(params["rows"]), int(params["cols"])
    lo, hi = int(params["weights"]["low"]), int(params["weights"]["high"])
    neg_mag = int(params["negative_magnitude"])
    frac = float(params["negative_fraction"])
    if not 0 <= neg_mag < lo <= hi:
        raise ValueError("need 0 <= negative_magnitude < low <= high, so "
                         "that no lattice cycle is negative")
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    n = rows * cols
    idx = torch.arange(n, dtype=torch.int64, device=dev).view(rows, cols)
    fwd_src = torch.cat([idx[:, :-1].reshape(-1), idx[:-1, :].reshape(-1)])
    fwd_dst = torch.cat([idx[:, 1:].reshape(-1), idx[1:, :].reshape(-1)])
    src = torch.cat([fwd_src, fwd_dst])
    dst = torch.cat([fwd_dst, fwd_src])
    e = src.shape[0]
    w = torch.randint(lo, hi + 1, (e,), generator=g, device=dev)
    if frac > 0 and neg_mag > 0:
        neg = (torch.rand(e, generator=g, device=dev) < frac) & (src < dst)
        neg_w = -torch.randint(1, neg_mag + 1, (e,), generator=g, device=dev)
        w = torch.where(neg, neg_w, w)
    order = torch.argsort(src * n + dst)
    src, dst, w = src[order], dst[order], w[order]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return {
        "indptr": indptr.to(torch.int32).cpu().numpy(),
        "indices": dst.to(torch.int32).cpu().numpy(),
        "weights": w.to(torch.float32).cpu().numpy(),
    }


def count(params: dict) -> dict:
    rows, cols = int(params["rows"]), int(params["cols"])
    return {"vertices": rows * cols,
            "arcs_drawn": 4 * rows * cols - 2 * rows - 2 * cols}
