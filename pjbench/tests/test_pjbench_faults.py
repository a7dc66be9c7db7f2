"""The check catches a broken program: a run on the CPU, past the look
for a card, with the timed path broken underneath, ends with ``correct``
false, for each fault a cell can have; and the control (the reference
one precision lower in the program's place) fails the limits."""

from __future__ import annotations

import pytest
import torch

from conftest import CELL, CELL_X4, SEED, add_lattice_cell, run_tiny
from paralleljohnson_tpu_torch.backends import torch_backend
from paralleljohnson_tpu_torch.parallel import mesh as mesh_ops


def _unchanged_fixpoint(dist0, *args, **kwargs):
    """A fixpoint whose sweeps return their state unchanged."""
    return dist0, 1, False


def _wrap_fanout(monkeypatch, alter):
    real = torch_backend.TorchBackend.multi_source

    def multi_source(self, dgraph, sources):
        res = real(self, dgraph, sources)
        res.dist = alter(res.dist.clone(), sources)
        return res

    monkeypatch.setattr(torch_backend.TorchBackend, "multi_source",
                        multi_source)


def _half_left_out(dist, sources):
    """Only the first half of the batch solved; the rest keep their
    starting rows (0 at the source, +inf elsewhere)."""
    b = dist.shape[0]
    rest = torch.full_like(dist[b // 2:], float("inf"))
    idx = torch.as_tensor(sources[b // 2:], dtype=torch.int64)
    rest[torch.arange(rest.shape[0]), idx] = 0
    dist[b // 2:] = rest
    return dist


def _answer_altered(dist, sources):
    """Each row's largest finite distance altered by one."""
    finite = torch.where(torch.isfinite(dist), dist,
                         torch.full_like(dist, -float("inf")))
    far = finite.argmax(1)
    dist[torch.arange(dist.shape[0]), far] += 1
    return dist


FAULTS = {
    "state_unchanged": lambda mp: mp.setattr(
        torch_backend, "fanout_fixpoint", _unchanged_fixpoint),
    "half_batch_left_out": lambda mp: _wrap_fanout(mp, _half_left_out),
    "answer_altered": lambda mp: _wrap_fanout(mp, _answer_altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", [CELL, "lattice.table"])
def test_fault_makes_the_run_incorrect(tiny_root, monkeypatch, workload,
                                       fault):
    if workload == "lattice.table":
        add_lattice_cell(tiny_root)
    assert run_tiny(tiny_root, workload)["correct"] is True
    FAULTS[fault](monkeypatch)
    out = run_tiny(tiny_root, workload)
    assert out["correct"] is False
    assert any(n["value"] > n["limit"] for n in out["check"].values())


def test_phase1_state_unchanged_is_caught(tiny_root, monkeypatch):
    """Phase 1 returning its starting state (h = 0) still yields right
    rows (Bellman-Ford takes negative arcs), so the potentials must be
    what the check catches."""
    real = torch_backend.TorchBackend.bellman_ford

    def bellman_ford(self, dgraph, source):
        res = real(self, dgraph, source)
        if source is None:
            res.dist = torch.zeros_like(res.dist)
        return res

    monkeypatch.setattr(torch_backend.TorchBackend, "bellman_ford",
                        bellman_ford)
    out = run_tiny(tiny_root, add_lattice_cell(tiny_root))
    assert out["correct"] is False
    assert out["check"]["potentials_differing"]["value"] > 0


def test_exchange_left_out_is_caught(tiny_root, monkeypatch):
    """Four ranks whose rows never reach the caller: rank 0's block
    stands for every rank's."""
    monkeypatch.setenv("PJ_MESH_DEVICES", "cpu*4")
    cell = CELL_X4
    assert run_tiny(tiny_root, cell)["correct"] is True

    def gather_rows(mesh, outs, index, dev, *, stride=1):
        ranks = outs[::stride]
        return mesh_ops._assemble([ranks[0][index]] * len(ranks), dev)

    monkeypatch.setattr(mesh_ops, "_gather_rows", gather_rows)
    out = run_tiny(tiny_root, cell)
    assert out["correct"] is False
    # The program's own guard (a row's source entry must be 0) refuses the
    # wrong rows, so each request fails and nothing is delivered.
    assert out["failed"] > 0 or out["check"]["rows_differing"]["value"] > 0


@pytest.mark.parametrize("workload", [CELL, "lattice.table"])
def test_control_fails_the_limits(tiny_root, workload):
    from pjbench import check, control

    if workload == "lattice.table":
        add_lattice_cell(tiny_root)
    numbers = control.readings(tiny_root, workload, SEED, torch.device("cpu"))
    plain = {k: v for k, v in numbers.items() if "_phase1" not in k}
    assert not check.passed(plain)
    assert numbers["rows_differing"]["value"] > 0
    if workload == "lattice.table":
        assert numbers["potentials_differing_phase1_unchanged"]["value"] > 0
