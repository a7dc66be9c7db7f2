"""Device-aware array reductions, shared by the solver and the smoke run.

Rows from the torch backend stay on their device (a single-batch solve,
and every batch of ``solve_reduced``); every reduction here runs where
the rows live, so reducing a device-resident [B, V] block moves only the
(small) result to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def xp(rows):
    """numpy for host arrays, torch for tensors."""
    if isinstance(rows, torch.Tensor):
        return torch
    return np


def finite_frac(rows) -> float:
    """Fraction of finite entries."""
    if isinstance(rows, torch.Tensor):
        return float(torch.isfinite(rows).float().mean())
    return float(np.isfinite(rows).mean())


def finite_checksum(rows) -> float:
    """Sum of finite entries (the streamed-rows reduction of the RMAT
    benchmark config).

    Accumulates per-ROW partial sums in the rows' dtype where the rows
    live, then combines them in float64 on the host, as the JAX package
    does: a flat f32 accumulation over ~1e9 entries is sensitive to
    reduction order, while per-row sums (~V terms each) keep the device
    reduction cheap and the f64 host combine removes the cross-row order
    sensitivity."""
    if isinstance(rows, torch.Tensor):
        row_sums = torch.where(torch.isfinite(rows), rows, 0.0).sum(dim=-1)
        row_sums = row_sums.cpu().numpy()
    else:
        row_sums = np.where(np.isfinite(rows), rows, 0.0).sum(axis=-1)
    return float(np.asarray(row_sums, dtype=np.float64).sum())
