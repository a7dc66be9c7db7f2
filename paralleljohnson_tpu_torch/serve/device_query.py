"""Device-resident query path: megabatched lookups over the hot tier.

The hot tier of :class:`~paralleljohnson_tpu_torch.serve.store.TileStore`
keeps the rows a single-batch solve returned on the card, but the host
lookup path (``QueryEngine._answer``) indexes them one source at a time:
one gather plus one device-to-host copy PER QUERY. This module answers a
whole aggregated batch at once instead: the engine flattens its
concurrent clients' lookups into index vectors, the functions below
gather them from a stacked ``[B, V]`` tile (exact hits) and from the
landmark row blocks (certified bounds for misses and shed answers), and
one copy returns each result.

The counterpart of the JAX package's ``serve/device_query.py``, whose
four jitted functions (``gather_pairs``, ``gather_rows``, ``lm_pairs``,
``lm_rows``) are XLA, not Pallas kernels: here they are plain torch ops
on the engine's device.

Bitwise identity with the host path is a design invariant, not a
tolerance:

- **Exact hits** gather f32 row entries; a gather moves bits, and the
  f32 -> f64 conversion both paths end with is exact.
- **Landmark bounds** are computed on the device in f64, but ONLY the
  raw part: elementwise add/sub plus min/max reductions, which are
  correctly rounded and order-independent over never-NaN inputs, so
  they match numpy bit for bit (there is no multiply, so no FMA
  contraction). The widening, which multiplies, and the estimate / error
  derivation always run on the host through the SAME helpers the host
  path uses (:func:`~paralleljohnson_tpu_torch.serve.landmarks.widen_bounds`
  / :func:`finish_estimates`). Torch holds real f64 on the card and on
  the CPU, so the landmark sub-path runs on the device on both (the
  JAX package keeps it on the host where the TPU has no f64).

The tile is a cached ``torch.stack`` of the store's non-stale hot rows,
keyed by :meth:`TileStore.hot_token`: any put / evict / stale transition
invalidates it (a stable row -> tile-slot mapping in between). Stale rows
are excluded at build: a gather can never read a row the host path would
flag.

Request tracing: the engine wraps the whole launch group in one
``device_megabatch`` span tagged with every sampled ``trace`` that rides
it; the functions here stay trace-agnostic.
"""

from __future__ import annotations

import numpy as np
import torch

from paralleljohnson_tpu_torch.observe import current_platform

# Full-row landmark queries materialise a [k, chunk, V] f64 temporary;
# chunking bounds it (k is small, V can be large).
_LM_ROW_CHUNK = 8


def gather_pairs(tile, slots, dsts):
    """``[P]`` entries ``tile[slots[i], dsts[i]]``: the flattened
    one-to-many gather (per-query dst lists flatten into one index
    vector; the engine re-segments on the host)."""
    return tile[slots, dsts]


def gather_rows(tile, slots):
    """``[Q, V]`` full rows of the tile."""
    return tile.index_select(0, slots)


def lm_pairs(fwd, rev, s, t):
    """Raw triangle-inequality bounds per flattened (s, t) pair: the
    torch twin of ``LandmarkIndex.raw_bounds_row`` (see its docstring
    for why only THIS part may run on the device). ``fwd`` / ``rev`` are
    f64 ``[k, V]``; returns f64 ``(lower[P], upper[P])``."""
    d_s_L = rev[:, s]           # [k, P]  d(s, L)
    d_L_s = fwd[:, s]           # [k, P]  d(L, s)
    fwd_t = fwd[:, t]           # [k, P]  d(L, t)
    rev_t = rev[:, t]           # [k, P]  d(t, L)
    upper = torch.amin(d_s_L + fwd_t, dim=0)
    neg_inf = torch.tensor(-float("inf"), dtype=fwd.dtype, device=fwd.device)
    a = torch.where(torch.isfinite(d_L_s), fwd_t - d_L_s, neg_inf)
    b = torch.where(torch.isfinite(rev_t), d_s_L - rev_t, neg_inf)
    lower = torch.maximum(torch.amax(a, dim=0), torch.amax(b, dim=0))
    return lower, upper


def lm_rows(fwd, rev, s):
    """Raw bounds for Q full-row queries at once: ``[Q, V]`` outputs."""
    d_s_L = rev[:, s]           # [k, Q]
    d_L_s = fwd[:, s]           # [k, Q]
    upper = torch.amin(d_s_L[:, :, None] + fwd[:, None, :], dim=0)
    neg_inf = torch.tensor(-float("inf"), dtype=fwd.dtype, device=fwd.device)
    a = torch.where(torch.isfinite(d_L_s)[:, :, None],
                    fwd[:, None, :] - d_L_s[:, :, None], neg_inf)
    b = torch.where(torch.isfinite(rev)[:, None, :],
                    d_s_L[:, :, None] - rev[:, None, :], neg_inf)
    lower = torch.maximum(torch.amax(a, dim=0), torch.amax(b, dim=0))
    return lower, upper


def _index(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int64), device=device)


class DeviceQueryPath:
    """Megabatched lookups over a store's hot tier (+ landmark index) on
    ``device`` (a ``torch.device``; the engine's). One instance per
    engine; NOT thread-safe on its own: the engine's batch lock already
    serialises every caller."""

    def __init__(self, store, landmarks=None, *, device) -> None:
        self.store = store
        self.landmarks = landmarks
        self.device = torch.device(device)
        self._token: object = object()  # never equal to a store token
        self._slots: dict[int, int] = {}
        self._tile = None
        # source -> (the store's row object, its copy on the device): a
        # rebuild uploads only the rows it has not seen.
        self._dev_rows: dict = {}
        self._lm_fwd = None
        self._lm_rev = None
        self._f64_ok: bool | None = None
        self.tile_rebuilds = 0

    # -- qualification --------------------------------------------------------

    def platform(self) -> str:
        return current_platform(self.device)

    def f64_supported(self) -> bool:
        """One-time probe: does the device hold and add REAL f64? (A
        silent f32 demotion would break bitwise parity, which is what
        the dtype and value check catch.)"""
        if self._f64_ok is None:
            x = torch.tensor([1.5, 2.5], dtype=torch.float64,
                             device=self.device)
            y = x + x
            self._f64_ok = bool(y.dtype == torch.float64
                                and float(y[0].item()) == 3.0)
        return self._f64_ok

    def landmark_device_ok(self) -> bool:
        return (self.landmarks is not None and self.landmarks.k > 0
                and self.f64_supported())

    # -- the cached device tile ----------------------------------------------

    def refresh(self) -> dict[int, int]:
        """Validate / rebuild the ``[B, V]`` tile against the store's
        token; returns the stable source -> tile-slot mapping (empty
        when nothing is hot or everything is stale). The common case is
        one integer-tuple compare."""
        token = self.store.hot_token()
        if token == self._token:
            return self._slots
        token, items = self.store.hot_view()
        # Rows from an uncheckpointed single-batch solve on the card are
        # device tensors; rows of checkpointed or multi-batch solves and
        # cold promotions are host numpy, each uploaded once: a store
        # that changes one row a batch re-stacks the tile but uploads
        # only that row.
        dev_rows = {}
        for s, r in items:
            seen = self._dev_rows.get(int(s))
            dev_rows[int(s)] = (r, seen[1] if seen is not None and seen[0] is r
                                else torch.as_tensor(r).to(self.device))
        self._dev_rows = dev_rows
        if items:
            self._tile = torch.stack([dev_rows[int(s)][1] for s, _ in items])
            self._slots = {int(s): i for i, (s, _) in enumerate(items)}
        else:
            self._tile = None
            self._slots = {}
        self._token = token
        self.tile_rebuilds += 1
        return self._slots

    def _lm_dev(self):
        if self._lm_fwd is None:
            self._lm_fwd = torch.as_tensor(self.landmarks.fwd).to(self.device)
            self._lm_rev = torch.as_tensor(self.landmarks.rev).to(self.device)
        return self._lm_fwd, self._lm_rev

    # -- megabatched lookups --------------------------------------------------

    def exact_pairs(self, slot_idx, dst_idx) -> np.ndarray:
        """f32 ``[P]`` tile entries for flattened (slot, dst) pairs: one
        gather, one copy to the host."""
        out = gather_pairs(self._tile, _index(slot_idx, self.device),
                           _index(dst_idx, self.device))
        return out.cpu().numpy()

    def exact_rows(self, slot_idx) -> np.ndarray:
        """f32 ``[Q, V]`` full rows for the given tile slots."""
        return gather_rows(self._tile, _index(slot_idx, self.device)
                           ).cpu().numpy()

    def landmark_pairs(self, s_idx, t_idx):
        """RAW f64 ``(lower[P], upper[P])`` bounds for flattened (s, t)
        pairs: finish through ``widen_bounds`` / ``finish_estimates``."""
        fwd, rev = self._lm_dev()
        lo, up = lm_pairs(fwd, rev, _index(s_idx, self.device),
                          _index(t_idx, self.device))
        return lo.cpu().numpy(), up.cpu().numpy()

    def landmark_rows(self, s_idx):
        """RAW f64 ``(lower[Q, V], upper[Q, V])`` bounds for full-row
        landmark queries, chunked to bound the [k, chunk, V] temporary."""
        fwd, rev = self._lm_dev()
        lows, ups = [], []
        for i in range(0, len(s_idx), _LM_ROW_CHUNK):
            lo, up = lm_rows(fwd, rev,
                             _index(s_idx[i:i + _LM_ROW_CHUNK], self.device))
            lows.append(lo.cpu().numpy())
            ups.append(up.cpu().numpy())
        return np.concatenate(lows), np.concatenate(ups)

    # -- introspection --------------------------------------------------------

    def describe(self) -> dict:
        """The path's state, without touching the device: the periodic
        stats writer calls this from its own thread."""
        return {
            "available": True,
            "reason": f"torch on {self.device}",
            "platform": self.platform(),
            "f64_device_bounds": bool(
                self.landmarks is not None and self.landmarks.k > 0
                and self._f64_ok),
            "tile_slots": len(self._slots),
            "tile_rebuilds": self.tile_rebuilds,
        }
