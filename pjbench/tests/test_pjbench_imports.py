"""What a run loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``paralleljohnson_tpu`` (compared whole: the
program's own name begins with the JAX package's), and the reference
loads nothing of the program. Each in a fresh interpreter."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import CELL, ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "paralleljohnson_tpu"]


def _python(code: str, cwd) -> dict:
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
           "HOME": str(cwd), "TMPDIR": str(cwd)}
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tiny_root, tmp_path):
    got = _python(f"""
import json, sys
from pjbench import harness
out = harness.run_cell({str(tiny_root)!r}, {CELL!r}, 7, 0.5, True,
                       device="cpu", log=lambda m: None)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": out["correct"], "tops": tops,
                   "flagged": harness.forbidden_loaded()}}))
""", tmp_path)
    assert got["correct"] is True
    assert "paralleljohnson_tpu_torch" in got["tops"]
    assert not set(got["tops"]) & set(FORBIDDEN)
    assert got["flagged"] == []


def test_the_check_and_reference_load_nothing_of_the_program(tmp_path):
    got = _python("""
import json, sys
import pjbench.check, pjbench.control, pjbench.reference.shortest_paths
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""", tmp_path)
    assert "paralleljohnson_tpu_torch" not in got
    assert not set(got) & set(FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    from pjbench import harness

    monkeypatch.setitem(sys.modules, "paralleljohnson_tpu_torch_x", sys)
    assert "paralleljohnson_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "paralleljohnson_tpu.cli", sys)
    assert harness.forbidden_loaded() == ["paralleljohnson_tpu"]


def test_run_without_a_card_exits_without_a_result(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, str(ROOT / "pjbench" / "run.py"), "--workload",
         CELL, "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
