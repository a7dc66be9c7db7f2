"""Post-fixpoint predecessor extraction: the tight-edge pass, its hand CUDA
kernel, and the tree certificate.

The counterpart of the JAX package's ``ops/pred.py``. Any route converges
to its distances first; one pass over the edges then picks, for every
(row, vertex), the predecessor

    pred[b, v] = the (dist[b, u], u)-lexicographic minimum over in-edges
                 (u, v, w) that are tight: |dist[b, u] + w - dist[b, v]|
                 <= TOL_SCALE * eps * max(|dist[b, v]|, 1)

(``NO_PRED`` where no in-edge is tight), computed in the distances'
dtype. Preferring a strictly closer predecessor breaks would-be cycles,
and the id breaks ties, so the tree does not depend on edge order. A
zero-weight cycle whose members see only equal keys is the one case the
rule cannot resolve; :func:`pred_reaches_root` finds it and the backend
falls back to the argmin sweep (``relax.bellman_ford_sweeps_pred``).

Two entry points, one result:

  - :func:`tight_pred_pass_plain`: the reference's, over a COO edge list
    in any order, with ``dist`` source-major ``[B, V]``;
  - :func:`tight_pred_pass`: the wrapper the backend calls, over the
    fan-out's in-edge CSC with ``dist`` vertex-major ``[V, B]``. CUDA
    tensors run the hand kernel (``csrc/tight_pred.cu``), CPU tensors
    :func:`tight_pred_pass_plain` over the CSC's edges. Given the
    sources, it also masks them and raises the two flags of
    :func:`tree_flags_plain`, with which :func:`certify_pred` skips the
    pointer-doubling walk on trees that strictly descend in ``dist``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from paralleljohnson_tpu_torch.ops import _cuda, bump
from paralleljohnson_tpu_torch.ops.fanout_sweep import build_work_items
from paralleljohnson_tpu_torch.ops.relax import edge_chunk_for
from paralleljohnson_tpu_torch.utils.paths import NO_PRED

# Relative tolerance of the tight test, in units of eps(dtype) x |dist[v]|
# (floored at eps x 1): the reference's 4 ULPs.
TOL_SCALE = 4.0

_I32_MAX = torch.iinfo(torch.int32).max


def _tight(du, w, dv):
    """The tight mask of candidates ``du + w`` against ``dv`` (broadcast
    shapes), in the distances' dtype."""
    eps = TOL_SCALE * torch.finfo(du.dtype).eps
    cand = du + w
    tol = eps * torch.clamp_min(dv.abs(), 1.0)
    return torch.isfinite(cand) & torch.isfinite(dv) & ((cand - dv).abs() <= tol)


def tight_pred_pass_plain(dist, src, dst, w, *, edge_chunk: int = 1 << 20):
    """The reference's pass over a COO edge list (any order; padded
    (0, 0, +inf) edges are never tight). ``dist`` [V] or [B, V], converged.
    Returns int32 ``pred`` of ``dist``'s shape.

    Two passes over edge chunks: the least tight ``du`` per (row, dst),
    then the least source id among tight edges with that ``du`` (float
    equality, so -0.0 and +0.0 tie)."""
    squeeze = dist.dim() == 1
    d = dist.unsqueeze(0) if squeeze else dist
    b, v = d.shape
    e = src.shape[0]
    step = max(1, min(edge_chunk, e or 1))
    best_du = torch.full((b, v), float("inf"), dtype=d.dtype, device=d.device)
    best_u = torch.full((b, v), _I32_MAX, dtype=torch.int32, device=d.device)

    def chunks():
        for lo in range(0, e, step):
            s = src[lo:lo + step].long()
            t = dst[lo:lo + step].long()
            du = d[:, s]
            tight = _tight(du, w[lo:lo + step].to(d.dtype), d[:, t])
            yield s, t.unsqueeze(0).expand_as(du), du, tight

    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    for _, t, du, tight in chunks():
        best_du.scatter_reduce_(1, t, torch.where(tight, du, inf), "amin")
    for s, t, du, tight in chunks():
        win = tight & (du == best_du.gather(1, t))
        u = torch.where(win, s.to(torch.int32), _I32_MAX)
        best_u.scatter_reduce_(1, t, u, "amin")
    pred = torch.where(best_u < _I32_MAX, best_u, NO_PRED).to(torch.int32)
    return pred[0] if squeeze else pred


def _rows_of_edges(indptr_in, e: int):
    """int64[E]: the row (destination) of each CSC edge."""
    indptr = indptr_in.long()
    return torch.repeat_interleave(
        torch.arange(indptr.shape[0] - 1, device=indptr.device),
        indptr[1:] - indptr[:-1], output_size=e)


def tree_flags_plain(pred, dist, sources):
    """The source mask and the tree flags of ``pred`` / ``dist`` [B, V]
    (``sources`` [B]), in plain torch: returns (a copy of ``pred`` with
    ``NO_PRED`` at each row's source, int32[2] flags). ``flags[0]``
    (uncovered): some non-source entry with finite ``dist`` has no
    predecessor. ``flags[1]`` (nondescending): some predecessor ``u`` of
    ``v`` has ``not dist[u] < dist[v]``. With neither raised, every walk
    strictly descends in ``dist`` and so ends at a root."""
    b = pred.shape[0]
    rows = torch.arange(b, device=pred.device)
    src = torch.as_tensor(sources, device=pred.device).long().reshape(-1)
    pred = pred.clone()
    pred[rows, src] = NO_PRED
    is_src = torch.zeros(pred.shape, dtype=torch.bool, device=pred.device)
    is_src[rows, src] = True
    has = pred != NO_PRED
    uncovered = (~has & torch.isfinite(dist) & ~is_src).any()
    du = torch.gather(dist, 1, pred.clamp_min(0))
    nondescending = (has & ~(du < dist)).any()
    return pred, torch.stack([uncovered, nondescending]).to(torch.int32)


def tight_pred_pass(dist_vm, indptr_in, src_in, w_in, *, items=None,
                    sources=None):
    """The tight-edge pass on vertex-major distances ``dist_vm`` [V, B]
    and the in-edge CSC (``indptr_in``, ``src_in``, ``w_in``) the fan-out
    sweep pulls over. Returns int32 ``pred_vm`` [V, B], ``NO_PRED`` where
    no in-edge is tight; given ``sources`` [B] (column c's source), returns
    (``pred_vm`` with ``NO_PRED`` at (sources[c], c), int32[2] flags of
    :func:`tree_flags_plain`).

    CUDA tensors run the hand kernel (``csrc/tight_pred.cu``) over
    ``items`` (a ``WorkItems``; built from ``indptr_in`` when None), with
    an int64[items.n_split, B] scratch for the split rows' partial keys;
    each call counts one in ``tight_pred_pass.launches`` (the items kernel
    and, when the layout has split rows, the combine kernel). CPU tensors
    run :func:`tight_pred_pass_plain` over the CSC's edges (then
    :func:`tree_flags_plain`), ``items`` unused, and count nothing."""
    dev = dist_vm.device
    if dev.type == "cpu":
        pred = tight_pred_pass_plain(
            dist_vm.t(), src_in, _rows_of_edges(indptr_in, src_in.shape[0]),
            w_in, edge_chunk=edge_chunk_for(dist_vm.shape[1], src_in.shape[0]),
        )
        if sources is None:
            return pred.t().contiguous()
        pred, flags = tree_flags_plain(pred, dist_vm.t(), sources)
        return pred.t().contiguous(), flags
    if dev.type != "cuda":
        raise ValueError(f"tight_pred_pass takes cpu or cuda tensors, got {dev}")
    _cuda.check(dist_vm, "dist_vm", torch.float32, dev, 2)
    _cuda.check(indptr_in, "indptr_in", torch.int32, dev, 1)
    _cuda.check(src_in, "src_in", torch.int32, dev, 1)
    _cuda.check(w_in, "w_in", torch.float32, dev, 1)
    v, b = dist_vm.shape
    if indptr_in.shape[0] != v + 1 or src_in.shape != w_in.shape:
        raise ValueError(
            f"layout does not fit dist_vm[{v}, {b}]: indptr_in "
            f"{tuple(indptr_in.shape)}, src_in {tuple(src_in.shape)}, "
            f"w_in {tuple(w_in.shape)}"
        )
    if items is None:
        items = build_work_items(indptr_in)
    _cuda.check(items.pieces, "items.pieces", torch.int32, dev, 2)
    _cuda.check(items.split_rows, "items.split_rows", torch.int32, dev, 1)
    _cuda.check(items.split_ptr, "items.split_ptr", torch.int32, dev, 1)
    flags = src_ptr = flags_ptr = None
    if sources is not None:
        sources = torch.as_tensor(sources).reshape(-1)
        if sources.shape[0] != b:
            raise ValueError(f"sources has {sources.shape[0]} entries, "
                             f"dist_vm {b} columns")
        # A fresh int32 buffer: 16-byte aligned, as the float4 lanes load it.
        sources = torch.empty(b, dtype=torch.int32, device=dev).copy_(sources)
        flags = torch.zeros(2, dtype=torch.int32, device=dev)
        src_ptr, flags_ptr = sources.data_ptr(), flags.data_ptr()
    out = torch.empty((v, b), dtype=torch.int32, device=dev)
    scratch = torch.empty((items.n_split, b), dtype=torch.int64, device=dev)
    _cuda.launch(
        "tight_pred", dist_vm.data_ptr(), out.data_ptr(), indptr_in.data_ptr(),
        src_in.data_ptr(), w_in.data_ptr(), items.pieces.data_ptr(),
        items.n_split, v, items.item_edges, scratch.data_ptr(),
        items.split_rows.data_ptr(), items.split_ptr.data_ptr(),
        items.split_rows.shape[0], src_ptr, flags_ptr, b, device=dev,
    )
    bump(tight_pred_pass, "launches")
    return out if flags is None else (out, flags)


tight_pred_pass.launches = 0


def occupancy(b: int, *, vec: bool = True) -> dict:
    """Resident blocks per SM and gathers per batch of the ``tight_pred``
    items kernel at width ``b`` (on the card)."""
    blocks, depth = ctypes.c_int(0), ctypes.c_int(0)
    err = _cuda.lib("tight_pred").pj_tight_pred_occupancy(
        b, int(vec), ctypes.byref(blocks), ctypes.byref(depth))
    if err != 0:
        raise RuntimeError(f"tight_pred occupancy query failed: cudaError {err}")
    return {"blocks_per_sm": blocks.value, "gather_depth": depth.value}


def pred_reaches_root(pred):
    """[.., V] bool: following ``pred`` from each vertex reaches the
    ``NO_PRED`` root. False exactly on vertices on (or draining into) a
    predecessor cycle. At most ceil(log2 V) pointer-doubling gathers
    (int32 indices, as ``pred`` holds them): after k of them each pointer
    has advanced 2^k hops, ``NO_PRED`` absorbing. The doubling stops once
    every pointer is at a root (one host read per step): a tree of depth
    D takes ceil(log2 D) steps. Each call counts one in
    ``pred_reaches_root.walks``."""
    bump(pred_reaches_root, "walks")
    squeeze = pred.dim() == 1
    q = pred.unsqueeze(0) if squeeze else pred
    steps = max(1, math.ceil(math.log2(max(q.shape[1], 2))))
    for _ in range(steps):
        pending = q >= 0
        if not bool(pending.any()):
            break
        hop = torch.gather(q, 1, q.clamp_min(0))
        q = torch.where(pending, hop, q)
    reaches = q == NO_PRED
    return reaches[0] if squeeze else reaches


pred_reaches_root.walks = 0


def certify_pred(pred, dist, sources, flags=None):
    """Certify the forest ``pred`` [B, V]: returns (pred, ok) with ``ok``
    a bool tensor, True iff every finite-distance non-source vertex has a
    predecessor and every walk ends at a root.

    Without ``flags``, force each row's source to ``NO_PRED`` (in place)
    and walk (:func:`pred_reaches_root`). With the int32[2] ``flags`` of
    ``tight_pred_pass(..., sources=)``, whose ``pred`` is already masked,
    one host read decides: uncovered, False; neither flag, True with no
    walk (every walk strictly descends in ``dist``); only nondescending,
    the walk. ``dist`` [B, V] and ``sources`` [B] serve the first form."""
    if flags is not None:
        uncovered, nondescending = (bool(f) for f in flags.tolist())
        if uncovered or not nondescending:
            return pred, torch.tensor(not uncovered)
        return pred, pred_reaches_root(pred).all()
    b = pred.shape[0]
    rows = torch.arange(b, device=pred.device)
    src = torch.as_tensor(sources, device=pred.device).long()
    pred[rows, src] = NO_PRED
    covered = (pred != NO_PRED) | ~torch.isfinite(dist)
    covered[rows, src] = True
    return pred, pred_reaches_root(pred).all() & covered.all()


def extract_pred(dist, sources, src, dst, w, *, edge_chunk: int = 1 << 20):
    """The reference's checked extraction over a COO edge list: (pred
    int32 of ``dist``'s shape, ok bool tensor). ``ok=False`` (a zero-weight
    tight cycle, or distances that were not a fixpoint) is the backend's
    signal to fall back to the argmin sweep."""
    squeeze = dist.dim() == 1
    d = dist.unsqueeze(0) if squeeze else dist
    pred = tight_pred_pass_plain(d, src, dst, w, edge_chunk=edge_chunk)
    pred, ok = certify_pred(pred, d, torch.as_tensor(sources).reshape(-1))
    return (pred[0] if squeeze else pred), ok
