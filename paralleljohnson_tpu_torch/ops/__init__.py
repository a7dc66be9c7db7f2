"""Device operations of the PyTorch port: plain relaxation primitives
(``relax``) and the hand CUDA kernels with their plain versions
(``fanout_sweep``, ``minplus``, ``pred``'s ``tight_pred``, ``fw``'s
``fw_kleene``; built by ``_cuda``)."""

import threading

_counter_lock = threading.Lock()


def bump(fn, counter: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``fn.<counter>`` (a kernel's launches, a
    host loop's reads) under one lock: the mesh's rank threads launch
    concurrently, and ``+=`` on an attribute is a read and a write that
    two threads can interleave."""
    with _counter_lock:
        setattr(fn, counter, getattr(fn, counter) + n)


def kernel_launches() -> dict[str, int]:
    """Each hand kernel's launch count in this process (the counters its
    wrapper adds one to per CUDA launch; CPU tensors never count)."""
    from paralleljohnson_tpu_torch.ops.fanout_sweep import fanout_sweep
    from paralleljohnson_tpu_torch.ops.fw import fw_kleene
    from paralleljohnson_tpu_torch.ops.minplus import minplus_kernel
    from paralleljohnson_tpu_torch.ops.pred import tight_pred_pass

    return {"fanout_sweep": fanout_sweep.launches,
            "minplus": minplus_kernel.launches,
            "tight_pred": tight_pred_pass.launches,
            "fw_kleene": fw_kleene.launches}
