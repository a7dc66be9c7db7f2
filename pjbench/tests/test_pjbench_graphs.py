"""Each generator's sizes and shapes, and that no graph it makes has a
negative cycle."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import LATTICE, ROOT
from pjbench import manifest
from pjbench.reference import shortest_paths as ref

CONFIGS = {p.stem: json.loads(p.read_text())
           for p in (ROOT / "pjbench" / "configs").glob("*.json")}


def _arcs(csr):
    v = len(csr["indptr"]) - 1
    src = np.repeat(np.arange(v), np.diff(csr["indptr"]))
    return src, csr["indices"].astype(np.int64), csr["weights"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_declared_sizes_are_the_generators(name):
    conf = CONFIGS[name]
    counted = manifest.generator(ROOT, conf["generator"]).count(conf)
    assert counted == {"vertices": conf["vertices"],
                       "arcs_drawn": conf["arcs_drawn"]}


@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_kronecker_shape(seed):
    conf = dict(CONFIGS["graph500-rmat22"], scale=10)
    csr = manifest.generator(ROOT, "kronecker").build(conf, seed, "cpu")
    v = 1 << 10
    src, dst, w = _arcs(csr)
    assert csr["indptr"].dtype == np.int32 and csr["indices"].dtype == np.int32
    assert csr["weights"].dtype == np.float32
    assert len(csr["indptr"]) == v + 1
    assert 0 < len(dst) <= 2 * 16 * v
    assert not np.any(src == dst)
    pairs = src * v + dst
    assert np.all(np.diff(pairs) > 0)  # sorted, no parallel arcs
    assert w.min() >= 1 and w.max() <= 255 and np.all(w == np.round(w))
    # Undirected: every arc has its reverse, with the same weight.
    rev = dict(zip(dst * v + src, w))
    assert all(rev[p] == x for p, x in zip(pairs, w))
    # Power law: the busiest vertex has far more arcs than the mean.
    deg = np.diff(csr["indptr"])
    assert deg.max() > 8 * deg.mean()


def test_kronecker_is_the_seeds():
    conf = dict(CONFIGS["graph500-rmat22"], scale=9)
    gen = manifest.generator(ROOT, "kronecker")
    a, b, c = (gen.build(conf, s, "cpu") for s in (5, 5, 6))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["indices"], c["indices"])


@pytest.mark.parametrize("rows,cols", [(24, 24), (7, 31)])
def test_lattice_shape_and_no_negative_cycle(rows, cols):
    conf = dict(LATTICE, rows=rows, cols=cols)
    gen = manifest.generator(ROOT, "lattice")
    csr = gen.build(conf, 2**31 + 1, "cpu")
    src, dst, w = _arcs(csr)
    assert len(dst) == gen.count(conf)["arcs_drawn"]
    assert set(np.abs(src - dst)) <= {1, cols}
    neg = w < 0
    assert neg.any() and np.all(src[neg] < dst[neg])
    assert w[neg].min() >= -conf["negative_magnitude"]
    assert w[~neg].min() >= conf["weights"]["low"]
    assert w[~neg].max() <= conf["weights"]["high"]
    share = neg.sum() / (len(w) / 2)
    assert 0.1 < share < 0.3
    # Potentials exist (Bellman-Ford reaches a fixpoint): no negative cycle.
    h = ref.potentials(ref.Arcs(csr, "cpu"))
    assert torch.all(h <= 0)
