#!/usr/bin/env python3
"""Build the hand kernels and report their f64 instantiations on the card.

    python3 scripts/torch_f64_sass.py

Prints one JSON line per kernel source: each f64 instantiation's ptxas
registers, stack frame and spill bytes (``-Xptxas -v``), and, from the
built library's SASS (``cuobjdump -sass``), the count of each
floating-point add and min opcode in each min-plus tile kernel at both
value types: whether ``fmin`` on doubles is one instruction (``DMNMX``)
or a compare and selects decides the f64 product's operations bound.
Then the card's ``nvidia-smi`` name and power limit. Needs the card (the
build) and the CUDA toolkit's ``cuobjdump``; exits 1 without a card.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Opcodes of an add-and-min candidate at f32 and f64.
OPCODES = ("FADD", "FMNMX", "DADD", "DMNMX", "DSETP", "FSEL", "SEL")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_f64_sass: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import f64_templates
    from paralleljohnson_tpu_torch.ops import _cuda

    logs = _cuda.build_all()
    for name, fns in f64_templates(logs).items():
        print(json.dumps({"source": name, "f64_ptxas": fns}), flush=True)
    cuobjdump = Path(_cuda.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_cuda._target("minplus"))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if fn is not None and m:
            op = m.group(1).split(".")[0]
            if op in OPCODES:
                counts[fn][op] += 1
    tiles = {f: dict(c) for f, c in counts.items() if "minplus_tiles" in f}
    print(json.dumps({"source": "minplus", "sass_opcodes": tiles}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
