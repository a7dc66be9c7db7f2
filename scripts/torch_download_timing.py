#!/usr/bin/env python3
"""Time the device-to-host copy of one fan-out batch's rows on one CUDA
card, for the choice of host buffer behind
``TorchBackend.stage_rows_async``.

    python3 scripts/torch_download_timing.py

The block is one R-MAT-20 batch of 256 sources: f32 [256, 2^20], 1 GiB.
Each measurement runs 3 times, on the host clock around a
``torch.cuda.synchronize()``:

1. ``pinned_alloc_cold_s`` / ``pinned_alloc_warm_s``: allocating 1 GiB
   of page-locked memory with ``torch.empty(pin_memory=True)``, with
   PyTorch's host cache emptied first (a ``cudaHostAlloc``) and with a
   freed block of that size in the cache;
2. ``staged_fresh_cold_s`` / ``staged_fresh_warm_s``: what the port does
   per batch — ``stage_rows_async`` (a fresh page-locked buffer, the copy
   on a side stream) and ``StagedCopy.wait()``, cold and warm as in 1;
3. ``staged_slot_s``: the other design — a page-locked buffer kept per
   in-flight slot and reused, the copy into it, then a host copy out into
   a new numpy array (the rows must outlive the slot);
4. ``pageable_s``: ``tensor.cpu()`` (pageable memory, a blocking copy);
5. ``copy_out_s``: the host copy of 3 alone, and ``concat_4_s``:
   ``np.concatenate`` of 4 such blocks (what a 4-batch solve ends with).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import sync_time  # noqa: E402

SHAPE = (256, 1 << 20)
REPS = 3


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_download_timing: no CUDA device", file=sys.stderr)
        return 2
    from paralleljohnson_tpu_torch.backends.torch_backend import TorchBackend

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    backend = TorchBackend(device=dev)
    rows = torch.rand(SHAPE, device=dev)
    want = rows.cpu().numpy()
    nbytes = rows.numel() * rows.element_size()

    def empty_host_cache():
        torch.cuda.synchronize()
        torch._C._host_emptyCache()

    def times(fn, *, before=None):
        out = []
        for _ in range(REPS):
            if before is not None:
                before()
            result, secs = sync_time(fn)
            out.append(secs)
            del result
        return out

    def pinned():
        return torch.empty(SHAPE, dtype=torch.float32, pin_memory=True)

    def staged_fresh():
        t = rows.clone()
        backend.stage_rows_async(t)
        return t.staged_copy.wait()

    slot = pinned()
    ready = torch.cuda.Event()
    side = torch.cuda.Stream(dev)

    def staged_slot():
        ready.record()
        side.wait_event(ready)
        with torch.cuda.stream(side):
            slot.copy_(rows, non_blocking=True)
        side.synchronize()
        return slot.numpy().copy()

    for design in (staged_fresh, staged_slot):
        if not np.array_equal(design(), want):
            raise AssertionError(f"{design.__name__}: the copy differs")
    result = {"shape": list(SHAPE), "GB": nbytes / 1e9, "device": smi}
    result["pinned_alloc_cold_s"] = times(pinned, before=empty_host_cache)
    result["pinned_alloc_warm_s"] = times(pinned)
    result["staged_fresh_cold_s"] = times(staged_fresh,
                                          before=empty_host_cache)
    result["staged_fresh_warm_s"] = times(staged_fresh)
    result["staged_slot_s"] = times(staged_slot)
    result["pageable_s"] = times(lambda: rows.cpu())
    src = slot.numpy()
    result["copy_out_s"] = times(lambda: src.copy())
    blocks = [want.copy() for _ in range(4)]
    result["concat_4_s"] = times(lambda: np.concatenate(blocks, axis=0))
    for key in ("staged_fresh_warm_s", "staged_slot_s", "pageable_s"):
        result[key[:-2] + "_GB_s"] = [nbytes / t / 1e9 for t in result[key]]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
