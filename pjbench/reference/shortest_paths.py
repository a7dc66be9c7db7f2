"""Bellman-Ford and a min, in plain PyTorch ops.

Distances are a vertex-major [V, B] block (one column per source). One
sweep gathers each arc's source row, adds the arc's weight and folds the
candidates into their target rows with ``index_reduce_(..., "amin")``,
in chunks of arcs, until a sweep changes nothing. ``dtype`` is the
precision the whole computation runs in: float32 as the configurations
state it, or a lower one for the control.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

# Elements of one chunk's candidate block ([arcs, B]).
CHUNK_ELEMENTS = 1 << 28
# Sweeps between two checks of the fixpoint.
CHECK_EVERY = 8


class Arcs:
    """The arcs of a host CSR on ``device``: int64 sources and targets,
    weights in ``dtype``."""

    def __init__(self, csr: dict, device, dtype=torch.float32) -> None:
        indptr = torch.as_tensor(np.asarray(csr["indptr"], np.int64))
        self.num_nodes = int(indptr.shape[0] - 1)
        e = int(indptr[-1])
        deg = indptr[1:] - indptr[:-1]
        self.device = torch.device(device)
        self.dtype = dtype
        self.src = torch.repeat_interleave(
            torch.arange(self.num_nodes), deg).to(self.device)
        self.dst = torch.as_tensor(
            np.asarray(csr["indices"][:e], np.int64)).to(self.device)
        self.w = torch.as_tensor(
            np.asarray(csr["weights"][:e], np.float32)).to(self.device, dtype)

    def reweighted(self, h: torch.Tensor) -> "Arcs":
        """A copy whose weights are w(u, v) + h(u) - h(v)."""
        out = object.__new__(Arcs)
        out.__dict__.update(self.__dict__)
        hh = h.to(self.device, self.dtype)
        out.w = self.w + hh[self.src] - hh[self.dst]
        return out


def relax_to_fixpoint(arcs: Arcs, dist: torch.Tensor) -> torch.Tensor:
    """Sweep ``dist`` [V, B] (in place) until a sweep changes nothing.
    Raises ``RuntimeError`` after V sweeps (a negative cycle)."""
    v, b = dist.shape
    e = arcs.src.shape[0]
    chunk = max(1, CHUNK_ELEMENTS // max(b, 1))
    snap = dist.clone()
    for sweep in range(1, v + 2):
        for lo in range(0, e, chunk):
            hi = min(e, lo + chunk)
            cand = dist[arcs.src[lo:hi]] + arcs.w[lo:hi, None]
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # "in beta"
                dist.index_reduce_(0, arcs.dst[lo:hi], cand, "amin")
            del cand
        if sweep % CHECK_EVERY == 0:
            if torch.equal(dist, snap):
                return dist
            snap.copy_(dist)
    raise RuntimeError("no fixpoint after V sweeps: a negative cycle")


def potentials(arcs: Arcs) -> torch.Tensor:
    """Johnson's h: distances from a virtual source with a 0-weight arc to
    every vertex, [V]."""
    dist = torch.zeros(arcs.num_nodes, 1, dtype=arcs.dtype,
                       device=arcs.device)
    return relax_to_fixpoint(arcs, dist)[:, 0]


def rows(arcs: Arcs, sources, h: torch.Tensor | None = None) -> torch.Tensor:
    """[S, V] distance rows from ``sources``: Bellman-Ford over the arcs
    reweighted by ``h`` (when given), then d(s, v) = d'(s, v) - h(s) +
    h(v)."""
    src = torch.as_tensor(np.asarray(sources, np.int64), device=arcs.device)
    graph = arcs if h is None else arcs.reweighted(h)
    dist = torch.full((arcs.num_nodes, src.shape[0]), float("inf"),
                      dtype=arcs.dtype, device=arcs.device)
    dist[src, torch.arange(src.shape[0], device=arcs.device)] = 0
    dist = relax_to_fixpoint(graph, dist).t()
    if h is not None:
        hh = h.to(arcs.device, arcs.dtype)
        dist = dist - hh[src][:, None] + hh[None, :]
    return dist.contiguous()

