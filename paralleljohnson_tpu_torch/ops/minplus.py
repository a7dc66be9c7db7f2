"""Min-plus (tropical) product: the hand CUDA kernel and its plain version.

The counterpart of the JAX package's ``ops/pallas_kernels.py``
(``minplus_pallas``): ``out[i, j] = min_k d[i, k] + a[k, j]`` with +inf as
the identity. It serves the dense fan-out (``relax.dense_fanout``) and
min-plus squaring (``relax.apsp_minplus_squaring``) through their
``mp=`` argument. The kernel (``csrc/minplus.cu``) runs on the FP32
pipes of the card; see its header for the design.
"""

from __future__ import annotations

import torch

from paralleljohnson_tpu_torch.ops import _cuda
from paralleljohnson_tpu_torch.ops.relax import minplus as _minplus


def minplus_plain(d: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch min-plus product (``relax.minplus``): the CPU
    path of :func:`minplus_kernel` and its reference on the card."""
    return _minplus(d, a)


def minplus_kernel(d: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Min-plus product through the hand CUDA kernel for CUDA tensors;
    the plain version for CPU tensors. Takes f32 [I, K] and [K, J],
    returns a new f32 [I, J]. Counts its kernel launches in
    ``minplus_kernel.launches``."""
    if d.device.type == "cpu" and a.device.type == "cpu":
        return minplus_plain(d, a)
    dev = d.device
    if dev.type != "cuda":
        raise ValueError(f"minplus_kernel takes cpu or cuda tensors, got {dev}")
    _cuda.check(d, "d", torch.float32, dev, 2)
    _cuda.check(a, "a", torch.float32, dev, 2)
    i, k = d.shape
    k2, j = a.shape
    if k != k2:
        raise ValueError(
            f"minplus shapes disagree: {tuple(d.shape)} x {tuple(a.shape)}"
        )
    out = torch.empty((i, j), dtype=torch.float32, device=dev)
    _cuda.launch(
        "minplus", d.data_ptr(), a.data_ptr(), out.data_ptr(), i, k, j,
        device=dev,
    )
    minplus_kernel.launches += 1
    return out


minplus_kernel.launches = 0
