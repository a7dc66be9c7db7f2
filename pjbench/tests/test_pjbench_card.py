"""On the card (skipped without one): a whole traced run of each cell at
the CPU tests' sizes, through the hand kernels."""

from __future__ import annotations

import pytest

from conftest import CELL, SEED, add_lattice_cell


@pytest.mark.card
@pytest.mark.parametrize("workload", [CELL, "lattice.table"])
def test_traced_cell_on_the_card(card, tiny_root, workload):
    from pjbench import harness, manifest

    if workload == "lattice.table":
        add_lattice_cell(tiny_root)
    out = harness.run_cell(tiny_root, workload, SEED, 2.0, True,
                           device=card, log=lambda msg: None)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    wanted = {m["name"] for m in manifest.cell(tiny_root, workload).per_layer}
    assert set(out["metrics"]) == wanted
    if "fanout_sweep_roofline" in wanted:
        roofline = out["metrics"]["fanout_sweep_roofline"]["value"]
        assert 0 < roofline <= 100
        assert 0 <= out["metrics"]["device_idle_pct"]["value"] < 100
