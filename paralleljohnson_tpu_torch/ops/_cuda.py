"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` into its
own shared library under ``paralleljohnson_tpu_torch/_build/`` at first
use, then loaded with ``ctypes``. The library name carries a hash of the
source and the flags, so an edited source never loads a stale build.
Nothing here runs at import time: the CPU tests import every module, and
the CPU has neither ``nvcc`` nor a card.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3``, and
deliberately no ``--use_fast_math``: flushing subnormals to zero or
approximate adds would break the bitwise agreement with the plain
PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_L = ctypes.c_longlong
# C entry point and its argument types, per source file.
SIGNATURES = {
    "fanout_sweep": (
        "pj_fanout_sweep", (_P, _P, _P, _P, _P, _P, _L, _L, _P),
    ),
    "minplus": ("pj_minplus", (_P, _P, _P, _L, _L, _L, _P)),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc`` as PyTorch
    resolves it)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start_build(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` unless its library exists.
    Returns None or (process, temporary output, final library path)."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish_build(name: str, started) -> str:
    """Wait for a build from :func:`_start_build`; move the library into
    place (atomically, so a concurrent loader never sees half a file)."""
    if started is None:
        return ""
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)
    return out


def build_all() -> dict[str, str]:
    """Compile every kernel source at once (one ``nvcc`` per file, all
    started together) and load them. Returns each build's compiler output
    (``-Xptxas -v``: registers, shared memory, spills; empty when the
    library was already built)."""
    logs, errors = {}, []
    with _lock:
        started = {name: _start_build(name) for name in SIGNATURES}
        for name, s in started.items():  # wait for every nvcc, even after a failure
            try:
                logs[name] = _finish_build(name, s)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for name in SIGNATURES:
        lib(name)
    return logs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        cached = _libs.get(name)
        if cached is not None:
            return cached
        _finish_build(name, _start_build(name))
        handle = ctypes.CDLL(str(_target(name)))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(handle, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _libs[name] = handle
        return handle


def launch(name: str, *args, device: torch.device) -> None:
    """Call ``csrc/<name>.cu``'s entry point on ``device``'s current
    stream; raise if the launch was refused (the C function returns
    ``cudaGetLastError()``)."""
    handle = lib(name)
    fn = getattr(handle, SIGNATURES[name][0])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError {err}"
        )


def check(t: torch.Tensor, what: str, dtype: torch.dtype, device: torch.device,
          ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions on ``device`` — what every kernel wrapper requires."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
