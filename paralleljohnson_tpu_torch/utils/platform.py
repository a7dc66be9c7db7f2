"""Device choice and the kernels' build directory, shared by the CLI and
the torch backend.

The JAX package's ``honor_cpu_platform_request`` reads
``JAX_PLATFORMS``; the port never does: a run goes to the card unless its
caller passes ``--device cpu`` (``device="cpu"``), whatever the
environment says. Its ``enable_compilation_cache`` turns on jax's
persistent compile cache; here the counterpart is the directory
``nvcc`` builds the hand kernels into (``ops._cuda``), which is what a
re-run skips rebuilding.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path


def cli_device(requested: str = "cuda"):
    """The ``torch.device`` a command runs on: ``requested`` (``cuda``
    unless the caller asked for the CPU). A CUDA request without a card
    raises ``RuntimeError`` (``resolve_device``'s, naming the flag that
    runs on the CPU instead): nothing falls back to the CPU."""
    from paralleljohnson_tpu_torch.backends.torch_backend import resolve_device

    try:
        return resolve_device(requested)
    except RuntimeError as e:
        raise RuntimeError(
            f"{e} (on the command line: pass --device cpu)"
        ) from None


def build_dir(cache_dir: str | None = None) -> Path:
    """The build directory a backend with ``compilation_cache_dir =
    cache_dir`` asks for: ``cache_dir``, else ``$PJ_COMPILE_CACHE``, else
    ``paralleljohnson_tpu_torch/_build/``. Creates nothing."""
    from paralleljohnson_tpu_torch.ops import _cuda

    path = cache_dir or os.environ.get("PJ_COMPILE_CACHE") or None
    return Path(path).expanduser() if path else _cuda.DEFAULT_BUILD_DIR


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Build the hand kernels into ``cache_dir`` or ``$PJ_COMPILE_CACHE``
    (created if needed) and return the directory in use; with neither,
    the directory stays as it is (the default unless an earlier call
    moved it). Once a kernel library has loaded, its directory stays for
    the process (``_cuda.set_build_dir`` warns). A directory that cannot
    be created warns and leaves the default build directory in place:
    the kernels are still built, only not where the caller asked."""
    from paralleljohnson_tpu_torch.ops import _cuda

    if not (cache_dir or os.environ.get("PJ_COMPILE_CACHE")):
        return str(_cuda.BUILD_DIR)
    path = build_dir(cache_dir)
    try:
        return str(_cuda.set_build_dir(path))
    except OSError as e:
        warnings.warn(
            f"cannot build the kernels into {str(path)!r}: "
            f"{type(e).__name__}: {e}; using {_cuda.DEFAULT_BUILD_DIR}",
            RuntimeWarning,
            stacklevel=2,
        )
        return str(_cuda.set_build_dir(_cuda.DEFAULT_BUILD_DIR))
