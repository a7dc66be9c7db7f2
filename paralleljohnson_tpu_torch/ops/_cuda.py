"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` into its
own shared library under ``paralleljohnson_tpu_torch/_build/`` (or the
directory :func:`set_build_dir` names) at first use, then loaded with
``ctypes``. The library name carries a hash of the
source and the flags, so an edited source never loads a stale build.
Nothing here runs at import time: the CPU tests import every module, and
the CPU has neither ``nvcc`` nor a card.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3``, and
deliberately no ``--use_fast_math``: flushing subnormals to zero or
approximate adds would break the bitwise agreement with the plain
PyTorch versions.

Every source has an f32 and an f64 version of each entry point
(``pj_<name>`` and ``pj_<name>_f64``, one template instantiated twice);
a wrapper takes the one of its call's value type (:func:`value_type`,
:func:`entry`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# Where the libraries are built and loaded from: ``set_build_dir``
# (``SolverConfig.compilation_cache_dir`` / ``$PJ_COMPILE_CACHE``).
BUILD_DIR = DEFAULT_BUILD_DIR
# ``-I``: the headers the sources share (``csrc/*.h``), also for a copy of
# a source compiled from elsewhere (the timing scripts' variants).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", f"-I{CSRC}",
)

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
# C functions and their argument types, per source file. Each source's
# launch entry point is ``pj_<name>`` (``fw_kleene`` has a second one),
# its last argument the stream; each has an ``_f64`` twin with the same
# arguments (doubles where the f32 one takes floats) and the ones
# ``_F64_EXTRA_ARGS`` adds: the sweep's and ``tight_pred``'s per-edge hub
# flags (and their occupancy queries' "with hubs") and ``tight_pred``'s
# second array of split-row partials.
_F32_SIGNATURES = {
    "fanout_sweep": {
        "pj_fanout_sweep": (_P, _P, _P, _P, _P, _P, _L, _L, _I, _P, _P, _P,
                            _L, _P, _P, _L, _P),
        "pj_fanout_sweep_occupancy": (_L, _I, _P, _P),
    },
    "minplus": {
        "pj_minplus": (_P, _P, _P, _P, _L, _L, _L, _I, _I, _L, _P, _P, _P),
        "pj_minplus_occupancy": (_I, _P),
    },
    "fw_kleene": {
        "pj_fw_kleene": (_P, _L, _P, _L, _I, _I, _I, _I, _I, _P),
        "pj_fw_kleene_occupancy": (_I, _I, _I, _I, _P),
        "pj_fw_kleene_steps": (_P, _L, _P, _L, _P, _P, _I, _P),
    },
    "tight_pred": {
        "pj_tight_pred": (_P, _P, _P, _P, _P, _P, _L, _L, _I, _P, _P, _P,
                          _L, _P, _P, _L, _P),
        "pj_tight_pred_occupancy": (_L, _I, _P, _P),
    },
}
# (position, type) of each argument an f64 entry point adds, inserted in
# this order.
_F64_EXTRA_ARGS = {
    "pj_tight_pred": ((5, _P), (11, _P)),     # hub flags after w; partial_u
    "pj_tight_pred_occupancy": ((2, _I),),     # with hubs
    "pj_fanout_sweep": ((5, _P),),             # hub flags, after w
    "pj_fanout_sweep_occupancy": ((2, _I),),   # with hubs
}


def _with_f64(fns: dict) -> dict:
    out = dict(fns)
    for fn, args in fns.items():
        for at, kind in _F64_EXTRA_ARGS.get(fn, ()):
            args = args[:at] + (kind,) + args[at:]
        out[f"{fn}_f64"] = args
    return out


SIGNATURES = {name: _with_f64(fns) for name, fns in _F32_SIGNATURES.items()}
# The value types the kernels take, and the entry-point suffix of each.
VALUE_TYPES = {torch.float32: "", torch.float64: "_f64"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def set_build_dir(path) -> Path:
    """Build and load the libraries under ``path`` (created if needed;
    ``OSError`` where it cannot be). Once a library has loaded, the
    directory stays: another ``path`` warns and changes nothing. Returns
    the directory in use."""
    global BUILD_DIR
    path = Path(path).expanduser().resolve()
    with _lock:
        if path == BUILD_DIR:
            return BUILD_DIR
        if _libs:
            warnings.warn(
                f"kernel libraries already loaded from {BUILD_DIR}; "
                f"not switching the build directory to {path}",
                RuntimeWarning,
                stacklevel=3,
            )
            return BUILD_DIR
        path.mkdir(parents=True, exist_ok=True)
        BUILD_DIR = path
        return BUILD_DIR


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc`` as PyTorch
    resolves it)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.h")))
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
    place (atomically, so a concurrent loader never sees half a file),
    its compiler output beside it. Returns that output (the stored one
    when the library was already built)."""
    log = _target(name).with_suffix(".log")
    if started is None:
        return log.read_text() if log.exists() else ""
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    log.write_text(out)
    os.replace(tmp, target)
    return out


def build_all() -> dict[str, str]:
    """Compile every kernel source at once (one ``nvcc`` per file, all
    started together) and load them. Returns each build's compiler output
    (``-Xptxas -v``: registers, shared memory, spills)."""
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
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(handle, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _libs[name] = handle
        return handle


def launch(name: str, *args, device: torch.device, entry: str = "") -> None:
    """Call ``csrc/<name>.cu``'s entry point (``pj_<name>``, or ``entry``)
    on ``device``'s current stream; raise if the launch was refused (the
    C function returns ``cudaGetLastError()``)."""
    fn = getattr(lib(name), entry or f"pj_{name}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError {err}"
        )


def value_type(t: torch.Tensor, what: str) -> torch.dtype:
    """The value type of a kernel call: ``t``'s dtype, f32 or f64
    (``TypeError`` otherwise). Every other float argument of the call is
    then checked for the same dtype (:func:`check`)."""
    if t.dtype not in VALUE_TYPES:
        raise TypeError(f"{what} must be torch.float32 or torch.float64, "
                        f"got {t.dtype}")
    return t.dtype


def entry(fn: str, dtype: torch.dtype) -> str:
    """The C entry point ``fn`` for values of ``dtype``: ``fn`` itself
    at f32, ``fn + "_f64"`` at f64."""
    return fn + VALUE_TYPES[dtype]


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
