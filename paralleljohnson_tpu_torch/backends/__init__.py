"""Backend plugin registry.

Importing this package registers the built-in backends: ``torch`` (device
tensors, hand CUDA kernels on the card), ``numpy`` (the scipy oracle) and
``cpp`` (the C++/OpenMP baseline, built by ``g++`` at first use).
"""

from paralleljohnson_tpu_torch.backends.base import (
    Backend,
    KernelResult,
    available_backends,
    get_backend,
    register_backend,
)
import paralleljohnson_tpu_torch.backends.numpy_backend  # noqa: F401  (registers)
import paralleljohnson_tpu_torch.backends.torch_backend  # noqa: F401  (registers)
import paralleljohnson_tpu_torch.backends.cpp_backend  # noqa: F401  (registers)

__all__ = [
    "Backend",
    "KernelResult",
    "available_backends",
    "get_backend",
    "register_backend",
]
