"""The plain reference agrees with the program (on the CPU, its plain
versions) and with scipy on tiny graphs of the configuration and of a
lattice with negative arcs, and one precision lower it does not."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import johnson

import paralleljohnson_tpu_torch as pjt
from paralleljohnson_tpu_torch.solver.johnson import to_numpy
from conftest import LATTICE, ROOT
from pjbench import manifest
from pjbench.reference import shortest_paths as ref

CASES = [("graph500-rmat22", {"scale": 10}),
         ("lattice", {"rows": 20, "cols": 23})]


def _graph(name, change, seed):
    if name == "lattice":
        conf = dict(LATTICE)
    else:
        conf = json.loads(
            (ROOT / "pjbench" / "configs" / f"{name}.json").read_text())
    conf.update(change)
    return manifest.generator(ROOT, conf["generator"]).build(conf, seed, "cpu")


@pytest.mark.parametrize("name,change", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_reference_equals_program_and_scipy(name, change, seed):
    csr = _graph(name, change, seed)
    v = len(csr["indptr"]) - 1
    sources = np.random.default_rng(seed).choice(v, 12, replace=False)
    arcs = ref.Arcs(csr, "cpu")
    negative = bool((csr["weights"] < 0).any())
    h = ref.potentials(arcs) if negative else None
    got = ref.rows(arcs, sources, h).numpy()

    graph = pjt.CSRGraph(csr["indptr"], csr["indices"], csr["weights"])
    res = pjt.ParallelJohnsonSolver(
        pjt.SolverConfig(mesh_shape=(1,)), device="cpu").solve(graph, sources)
    assert np.array_equal(got, to_numpy(res.dist))
    if negative:
        assert np.array_equal(h.numpy(), to_numpy(res.potentials))

    m = csr_matrix((csr["weights"].astype(np.float64), csr["indices"],
                    csr["indptr"]), shape=(v, v))
    want = johnson(m, indices=sources)
    assert np.array_equal(got, want.astype(np.float32))


def test_lower_precision_rows_differ():
    """bfloat16 cannot hold the lattice's distances: the control's rows
    differ from float32's."""
    csr = _graph("lattice", {"rows": 20, "cols": 20}, 3)
    hi = ref.rows(ref.Arcs(csr, "cpu", torch.float32), [0, 17])
    lo = ref.rows(ref.Arcs(csr, "cpu", torch.bfloat16), [0, 17]).float()
    assert not torch.equal(hi, lo)
