"""The port's examples (``examples_torch/``) stay runnable: each runs in
a subprocess on CPU ranks, under a time limit of its own."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_multichip_mesh_example_on_eight_cpu_ranks():
    """``03_multichip_mesh.py --device cpu`` over eight CPU ranks
    (``PJ_MESH_DEVICES``): the default mesh takes all eight and the
    fan-out runs ``sharded-1d``."""
    env = dict(os.environ, PJ_MESH_DEVICES="cpu*8", OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, str(REPO / "examples_torch" / "03_multichip_mesh.py"),
         "--device", "cpu", "--sources", "64"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=180)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "mesh: 8-rank sources mesh on cpu x8" in p.stdout
    assert "sharded fan-out (sharded-1d): dist (64, 4096)" in p.stdout
