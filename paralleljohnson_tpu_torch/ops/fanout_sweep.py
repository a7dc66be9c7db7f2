"""Batched fan-out sweep: the hand CUDA kernel, its plain version, the
in-edge layout and the fixpoint loop.

The counterpart of the JAX package's ``ops/pallas_sweep.py``
(``pallas_fanout_sweep`` / ``pallas_fanout``). One sweep is the Jacobi
relaxation of the vertex-major distance block ``dist[V, B]``:

    new[v, b] = min(old[v, b], min over edges u->v of old[u, b] + w)

with every candidate read from ``old``. The reference bucketed edges by
(dst block, src block) to keep [vb, B] blocks in VMEM; this port pulls
over destination-sorted in-edges (a CSC: ``indptr_in``, ``src_in``,
``w_in``) instead, one warp per destination row on the card
(``csrc/fanout_sweep.cu``). Both compute the same sweep, so the fixpoint
and its iteration count agree with ``pallas_fanout``.
"""

from __future__ import annotations

import torch

from paralleljohnson_tpu_torch.ops import _cuda
from paralleljohnson_tpu_torch.ops.relax import edge_chunk_for


def build_in_edge_layout(src, dst, num_nodes: int):
    """Weight-independent CSC structure of an edge list, on the edges'
    device: ``indptr_in`` int32[V+1], ``src_in`` int32[E] and ``order``
    int64[E], the stable dst-sort permutation (``w_in = w[order]``).

    Pass real edges only (no padding tail)."""
    e = src.shape[0]
    if e >= 1 << 31:
        raise ValueError(f"{e} edges exceed the kernel's int32 offsets")
    order = torch.argsort(dst, stable=True)
    counts = torch.bincount(dst.long(), minlength=num_nodes)
    indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dst.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return {
        "indptr_in": indptr.to(torch.int32),
        "src_in": src[order].to(torch.int32).contiguous(),
        "order": order,
    }


def fanout_sweep_plain(dist, indptr_in, src_in, w_in):
    """One Jacobi sweep in plain PyTorch: ``index_select`` of the source
    rows plus ``scatter_reduce("amin", include_self=True)`` into a copy of
    ``dist``, chunked over edges so the [E_chunk, B] candidate block stays
    near 2^26 elements. Returns (new dist, improved) with ``improved`` a
    bool tensor."""
    v, b = dist.shape
    e = src_in.shape[0]
    counts = (indptr_in[1:] - indptr_in[:-1]).long()
    dst_in = torch.repeat_interleave(
        torch.arange(v, device=dist.device), counts, output_size=e
    )
    new = dist.clone()
    step = edge_chunk_for(b, e)
    for lo in range(0, e, step):
        cand = dist.index_select(0, src_in[lo:lo + step].long())
        cand += w_in[lo:lo + step].unsqueeze(1)
        idx = dst_in[lo:lo + step].unsqueeze(1).expand(-1, b)
        new.scatter_reduce_(0, idx, cand, "amin", include_self=True)
    return new, (new < dist).any()


def fanout_sweep(dist, indptr_in, src_in, w_in, *, out=None, improved=None):
    """One Jacobi sweep: returns (new dist [V, B], improved).

    CUDA tensors run the hand kernel (``csrc/fanout_sweep.cu``) into
    ``out`` (allocated when None) and set ``improved`` (an int32[1] device
    flag, allocated when None; zeroed here) when any entry dropped. CPU
    tensors run :func:`fanout_sweep_plain`. Counts kernel launches in
    ``fanout_sweep.launches``."""
    if dist.device.type == "cpu":
        return fanout_sweep_plain(dist, indptr_in, src_in, w_in)
    dev = dist.device
    if dev.type != "cuda":
        raise ValueError(f"fanout_sweep takes cpu or cuda tensors, got {dev}")
    _cuda.check(dist, "dist", torch.float32, dev, 2)
    _cuda.check(indptr_in, "indptr_in", torch.int32, dev, 1)
    _cuda.check(src_in, "src_in", torch.int32, dev, 1)
    _cuda.check(w_in, "w_in", torch.float32, dev, 1)
    v, b = dist.shape
    if indptr_in.shape[0] != v + 1 or src_in.shape != w_in.shape:
        raise ValueError(
            f"layout does not fit dist[{v}, {b}]: indptr_in "
            f"{tuple(indptr_in.shape)}, src_in {tuple(src_in.shape)}, "
            f"w_in {tuple(w_in.shape)}"
        )
    if out is None:
        out = torch.empty_like(dist)
    else:
        _cuda.check(out, "out", torch.float32, dev, 2)
        if out.shape != dist.shape or out.data_ptr() == dist.data_ptr():
            raise ValueError("out must be a separate tensor shaped like dist")
    if improved is None:
        improved = torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        _cuda.check(improved, "improved", torch.int32, dev, 1)
        improved.zero_()
    _cuda.launch(
        "fanout_sweep", dist.data_ptr(), out.data_ptr(),
        indptr_in.data_ptr(), src_in.data_ptr(), w_in.data_ptr(),
        improved.data_ptr(), v, b, device=dev,
    )
    fanout_sweep.launches += 1
    return out, improved


fanout_sweep.launches = 0


def fanout_fixpoint(dist0, indptr_in, src_in, w_in, *, max_iter: int):
    """Iterate :func:`fanout_sweep` to its fixpoint, at most ``max_iter``
    sweeps. The same contract as the reference's ``pallas_fanout``:
    (dist [V, B], iterations, still_improving), the last two host values.

    Two buffers alternate as old and new — ``dist0`` is consumed as one
    of them, so on the card the loop holds two [V, B] blocks — and the
    device flag is read once per sweep (one host sync per sweep)."""
    improving = bool(torch.isfinite(dist0).any())
    d = dist0
    spare = flag = None
    i = 0
    while improving and i < max_iter:
        nd, flag = fanout_sweep(d, indptr_in, src_in, w_in,
                                out=spare, improved=flag)
        improving = bool(flag.item())
        spare, d = d, nd
        i += 1
    return d, i, improving
