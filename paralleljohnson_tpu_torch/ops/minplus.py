"""Min-plus (tropical) product: the hand CUDA kernel, its plain version,
the kernel's launch plan and the iterate-regime fixpoint.

The counterpart of the JAX package's ``ops/pallas_kernels.py``
(``minplus_pallas``): ``out[i, j] = min_k d[i, k] + a[k, j]`` with +inf as
the identity. It serves the dense fan-out (``relax.dense_fanout``) and
min-plus squaring (``relax.apsp_minplus_squaring``) through their
``mp=`` argument, and the iterate regime's loop through
:func:`minplus_fixpoint`. The kernel (``csrc/minplus.cu``) runs on the
FP32 pipes of the card at f32 and on the FP64 pipes at f64; see its
header for the design.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from paralleljohnson_tpu_torch.ops import _cuda, bump
from paralleljohnson_tpu_torch.ops.fanout_sweep import FLAG_STRIDE
from paralleljohnson_tpu_torch.ops.relax import minplus as _minplus

# The kernel's tiles: `rows` x TILE_COLS outputs per block, rows in
# TILE_ROWS (TILE_ROWS_F64 at f64), K in stages of TILE_K. RESIDENT is
# each tile's resident blocks per SM at f32 (its launch bounds;
# chip_smoke.py checks it on the card), RESIDENT_F64 the same at f64,
# whose tiles hold a 4x4 micro-tile of doubles a thread over 128 or 256
# threads: 16 warps an SM at either (a 64-row tile of 512 threads timed
# no faster on the H100; PERF.md).
TILE_ROWS = (16, 32, 128)
TILE_ROWS_F64 = (16, 32)
TILE_COLS = 128
TILE_K = 16
RESIDENT = {16: 7, 32: 4, 128: 2}
RESIDENT_F64 = {16: 4, 32: 2}
# Streaming multiprocessors of an H100 SXM.
SMS = 132
# Split-K limits: at most 16 splits (the partials' traffic stays a small
# share of the product at K = 1024), each at least 64 deep.
MAX_SPLITS = 16
MIN_SPLIT_K = 64
# Products launched per host read of their flags in minplus_fixpoint.
PRODUCTS_PER_SYNC = 16


class MinplusPlan(NamedTuple):
    """How the kernel cuts an [I, K] x [K, J] product: output tiles of
    ``rows`` x ``TILE_COLS``, and K in ``splits`` ranges of ``k_split`` (a
    multiple of ``TILE_K``), split z covering [z k_split, min(K, (z + 1)
    k_split))."""

    rows: int
    splits: int
    k_split: int

    def grid(self, i: int, j: int) -> tuple[int, int, int]:
        """Blocks along J, I and K."""
        return -(-j // TILE_COLS), -(-i // self.rows), self.splits


@functools.lru_cache(maxsize=1024)
def minplus_plan(i: int, k: int, j: int, itemsize: int = 4) -> MinplusPlan:
    """The kernel's plan for an [i, k] x [k, j] product of values of
    ``itemsize`` bytes (4 or 8), a pure function of the shape (tuned on
    the H100 at the dense route's shapes, and at f64 also at FW's panel
    products; PERF.md).

    Tile rows: 16 for i <= 16, 32 for i <= 128, so a narrow source batch
    is neither padded to a wide tile nor left with a handful of blocks;
    above that, at f32, the 128-row tile (an 8x8 micro-tile per thread,
    the most math per shared-memory read) unless 32-row tiles pad fewer
    rows; at f64 32 rows (``TILE_ROWS_F64``). K is split as many times as
    the card's resident block slots (``SMS`` x ``RESIDENT``, or
    ``RESIDENT_F64``) can take more copies of the output tiles, at most
    ``MAX_SPLITS`` times and no split shallower than ``MIN_SPLIT_K``;
    splits that would be empty are dropped."""
    n = max(i, 1)
    if n <= 16:
        rows = 16
    elif (n <= 128 or itemsize == 8
          or -(-n // 32) * 32 < -(-n // 128) * 128):
        rows = 32
    else:
        rows = 128
    tiles = -(-n // rows) * -(-max(j, 1) // TILE_COLS)
    resident = RESIDENT_F64 if itemsize == 8 else RESIDENT
    splits = min(MAX_SPLITS, max(1, SMS * resident[rows] // tiles),
                 max(1, k // MIN_SPLIT_K))
    k_split = TILE_K * max(1, math.ceil(math.ceil(k / splits) / TILE_K))
    return MinplusPlan(rows, max(1, -(-k // k_split)), k_split)


def minplus_plain(d: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch min-plus product (``relax.minplus``): the CPU
    path of :func:`minplus_kernel` and its reference on the card."""
    return _minplus(d, a)


def minplus_kernel(d: torch.Tensor, a: torch.Tensor, *, out=None,
                   improved=None, prev=None, scratch=None) -> torch.Tensor:
    """Min-plus product through the hand CUDA kernel for CUDA tensors;
    the plain version for CPU tensors. Takes [I, K] and [K, J] of one
    dtype, f32 or f64, and returns [I, J] in it (``out`` when given, else
    a new tensor).

    ``improved``, an int32[1] flag (K == J only), is set to 1 when any
    out[i, j] < d[i, j]; it is not reset here. ``prev``, an int32[1]
    flag: when it holds 0 the product is skipped and writes nothing
    (:func:`minplus_fixpoint` chains products on it). ``scratch`` is the
    split-K partials' [splits, I, J] under :func:`minplus_plan`
    (allocated when None and the plan splits K).

    Each CUDA call counts one in ``minplus_kernel.launches`` (the tile
    kernel and, when K is split, the fold after it), skipped products
    included. CPU tensors count nothing."""
    if d.device.type == "cpu" and a.device.type == "cpu":
        if prev is not None and not int(prev[0]):
            return out
        new = minplus_plain(d, a)
        if improved is not None and bool((new < d).any()):
            improved.fill_(1)
        return new if out is None else out.copy_(new)
    dev = d.device
    if dev.type != "cuda":
        raise ValueError(f"minplus_kernel takes cpu or cuda tensors, got {dev}")
    dt = _cuda.value_type(d, "d")
    _cuda.check(d, "d", dt, dev, 2)
    _cuda.check(a, "a", dt, dev, 2)
    i, k = d.shape
    k2, j = a.shape
    if k != k2:
        raise ValueError(
            f"minplus shapes disagree: {tuple(d.shape)} x {tuple(a.shape)}"
        )
    if out is None:
        out = torch.empty((i, j), dtype=dt, device=dev)
    else:
        _cuda.check(out, "out", dt, dev, 2)
        if out.shape != (i, j) or out.data_ptr() in (d.data_ptr(),
                                                     a.data_ptr()):
            raise ValueError(f"out must be a separate [{i}, {j}] tensor")
    for flag, what in ((improved, "improved"), (prev, "prev")):
        if flag is not None:
            _cuda.check(flag, what, torch.int32, dev, 1)
    if improved is not None and k != j:
        raise ValueError(f"the improved flag needs K == J, got {k} and {j}")
    plan = minplus_plan(i, k, j, d.element_size())
    if plan.splits > 1:
        shape = (plan.splits, i, j)
        if scratch is None:
            scratch = torch.empty(shape, dtype=dt, device=dev)
        else:
            _cuda.check(scratch, "scratch", dt, dev, 3)
            if scratch.shape != shape:
                raise ValueError(f"scratch must be {list(shape)}, got "
                                 f"{list(scratch.shape)}")
    _cuda.launch(
        "minplus", d.data_ptr(), a.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if plan.splits > 1 else None, i, k, j, plan.rows,
        plan.splits, plan.k_split, None if prev is None else prev.data_ptr(),
        None if improved is None else improved.data_ptr(), device=dev,
        entry=_cuda.entry("pj_minplus", dt),
    )
    bump(minplus_kernel, "launches")
    return out


minplus_kernel.launches = 0


def occupancy(rows: int, dtype: torch.dtype = torch.float32) -> int:
    """Resident blocks per SM of the tile kernel for ``rows`` in
    ``dtype`` (needs the card)."""
    blocks = ctypes.c_int(0)
    fn = getattr(_cuda.lib("minplus"),
                 _cuda.entry("pj_minplus_occupancy", dtype))
    err = fn(rows, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return blocks.value


def minplus_fixpoint(d0, a, *, max_iter: int):
    """Iterate ``d <- d (x) a`` while some entry drops, at most
    ``max_iter`` products: the iterate regime of the reference's
    ``dense_fanout`` (its ``lax.while_loop``), with the same (dist [B, V],
    iterations, still_improving), the last two host values. ``a`` is
    [V, V] with a 0 (or negative) diagonal, so every product is <= d.

    Two buffers alternate (``d0`` is consumed as one of them). Products
    go out in groups of ``PRODUCTS_PER_SYNC``: product j of a group sets
    ``flags[j]`` when an entry dropped and is skipped when the product
    before it left its flag at 0; the host reads the group's flags once
    and stops at the first 0, returning what that product wrote. The
    last group is cut so the cap is exact. Host reads count in
    ``minplus_fixpoint.host_reads``."""
    b, v = d0.shape
    if a.shape != (v, v):
        raise ValueError(f"a must be [{v}, {v}], got {tuple(a.shape)}")
    if max_iter <= 0:
        return d0, 0, True
    dev = d0.device
    plan = minplus_plan(b, v, v, d0.element_size())
    scratch = (torch.empty((plan.splits, b, v), dtype=d0.dtype, device=dev)
               if dev.type == "cuda" and plan.splits > 1 else None)
    bufs = (d0, torch.empty_like(d0))
    one = torch.ones(1, dtype=torch.int32, device=dev)
    flags = torch.empty(PRODUCTS_PER_SYNC * FLAG_STRIDE, dtype=torch.int32,
                        device=dev)
    # Flag j at word FLAG_STRIDE * j, on a cache line of its own.
    flag = [flags[FLAG_STRIDE * j:FLAG_STRIDE * j + 1]
            for j in range(PRODUCTS_PER_SYNC)]
    i = 0
    while i < max_iter:
        n = min(PRODUCTS_PER_SYNC, max_iter - i)
        flags.zero_()
        for j in range(n):
            minplus_kernel(bufs[(i + j) % 2], a, out=bufs[(i + j + 1) % 2],
                           prev=flag[j - 1] if j else one, improved=flag[j],
                           scratch=scratch)
        got = flags[:FLAG_STRIDE * n:FLAG_STRIDE].tolist()
        bump(minplus_fixpoint, "host_reads")
        if 0 in got:
            j = got.index(0)
            return bufs[(i + j + 1) % 2], i + j + 1, False
        i += n
    return bufs[i % 2], i, True


minplus_fixpoint.host_reads = 0
