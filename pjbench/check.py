"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample
of the rows the window delivered, drawn from the seed, is computed again
by the plain reference (``reference/``) from the benchmark's own CSR
arrays, and compared:

- ``rows_differing``: entries of the sampled rows that differ from the
  reference's (an unreachable vertex is +inf on both sides);
- ``potentials_differing``: entries of each delivered request's
  potentials that differ from the reference's Johnson potentials (cells
  whose graph has negative arcs and whose traffic returns them; without
  negative arcs there are none to compute, and the control could not
  tell the two apart).

The configurations state integer weights, so every path sum is exact in
float32 and each comparison is exact: the limits are in the
configuration file (``check.limits``), and are 0.
"""

from __future__ import annotations

import numpy as np
import torch

from pjbench.reference import shortest_paths as ref

def differing(a: np.ndarray, b: np.ndarray) -> int:
    """Entries of ``a`` and ``b`` that are not equal (inf equals inf)."""
    return int(np.count_nonzero(np.asarray(a) != np.asarray(b)))


def sample(run, conf: dict) -> list:
    """The retained rows checked: those delivered in the window, at most
    ``check.sample_rows`` of them drawn from the seed."""
    rows = [r for r in run.retained if run.in_window(r.t)]
    n = min(len(rows), int(conf["check"]["sample_rows"]))
    rng = np.random.default_rng([run.seed, 3])
    pick = np.sort(rng.choice(len(rows), n, replace=False)) if n else []
    return [rows[i] for i in pick]


def reference_rows(arcs, sources, h, block: int) -> np.ndarray:
    out = []
    for i in range(0, len(sources), block):
        out.append(ref.rows(arcs, sources[i:i + block], h).float().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, arcs.num_nodes))


def check_run(run, csr: dict, conf: dict, *, dtype=torch.float32):
    """``(numbers, checked)``: each compared number with its limit, and
    how much was checked."""
    limits = conf["check"]["limits"]
    picked = sample(run, conf)
    arcs = ref.Arcs(csr, run.device, dtype)
    negative = bool((np.asarray(csr["weights"]) < 0).any())
    h = ref.potentials(arcs) if negative else None
    numbers = {}
    checked = {"rows": len(picked), "potentials": 0}
    pots = [p for t, p in run.potentials if run.in_window(t)]
    if pots and negative:
        hh = h.float().cpu().numpy()
        numbers["potentials_differing"] = sum(differing(p, hh) for p in pots)
        checked["potentials"] = len(pots)
    sources = np.array([r.source for r in picked], np.int64)
    got = reference_rows(arcs, sources, h, int(conf["check"]["block_rows"]))
    got = got.astype(np.float32)
    numbers["rows_differing"] = sum(
        differing(r.row, got[i]) for i, r in enumerate(picked))
    del arcs, h
    return ({k: {"value": v, "limit": limits[k]} for k, v in numbers.items()},
            checked)


def passed(numbers: dict) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
