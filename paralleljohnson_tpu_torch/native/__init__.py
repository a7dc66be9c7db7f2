"""Build and load the native C++/OpenMP kernel library.

The library is compiled at first use with the system ``g++`` (no pip/apt
dependencies) into ``paralleljohnson_tpu_torch/_build/native/``, keyed
by a hash of the source text and compile flags, so edits rebuild and
later loads reuse the cached ``.so``. A file lock serializes concurrent
builds (pytest-xdist). A failed build raises ``RuntimeError`` carrying
the compiler's stderr.

Env knobs:
  PJ_NATIVE_CXX       compiler (default g++)
  PJ_NATIVE_TSAN=1    ThreadSanitizer build (-fsanitize=thread -O1 -g)
  PJ_NATIVE_FLAGS     extra compile flags
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from pathlib import Path

_SRC = Path(__file__).parent / "pj_native.cpp"
_BUILD_DIR = Path(__file__).parent.parent / "_build" / "native"

_lib: ctypes.CDLL | None = None


def _flags() -> list[str]:
    flags = ["-std=c++17", "-shared", "-fPIC", "-fopenmp"]
    if os.environ.get("PJ_NATIVE_TSAN") == "1":
        flags += ["-fsanitize=thread", "-O1", "-g"]
    else:
        flags += ["-O3", "-funroll-loops"]
    extra = os.environ.get("PJ_NATIVE_FLAGS")
    if extra:
        flags += extra.split()
    return flags


def library_path() -> Path:
    """Compile (if needed) and return the shared-library path."""
    cxx = os.environ.get("PJ_NATIVE_CXX", "g++")
    flags = _flags()
    key = hashlib.sha256(
        (_SRC.read_text() + cxx + " ".join(flags)).encode()
    ).hexdigest()[:16]
    out = _BUILD_DIR / f"pj_native_{key}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lock = _BUILD_DIR / f".{key}.lock"
    with open(lock, "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(".so.tmp")
            try:
                proc = subprocess.run(
                    [cxx, *flags, str(_SRC), "-o", str(tmp)],
                    capture_output=True, text=True,
                )
            except OSError as e:
                raise RuntimeError(
                    f"cannot run the C++ compiler {cxx!r}: {e}"
                ) from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {_SRC.name} failed ({cxx}, exit "
                    f"{proc.returncode}):\n{proc.stderr}"
                )
            tmp.replace(out)  # atomic: readers never see a partial .so
    return out


def load_library() -> ctypes.CDLL:
    """Load (building if necessary) and type the native library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(library_path()))

    i32, i64 = ctypes.c_int32, ctypes.c_int64
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    p_f64 = ctypes.POINTER(ctypes.c_double)

    lib.pj_version.restype = i32
    lib.pj_num_threads.restype = i32
    for suffix, p_t in (("f32", p_f32), ("f64", p_f64)):
        bf = getattr(lib, f"pj_bellman_ford_{suffix}")
        bf.restype = i32
        bf.argtypes = [i32, i64, p_i32, p_i32, p_t, p_t, i32, p_i32, p_i64]
        dj = getattr(lib, f"pj_dijkstra_fanout_{suffix}")
        dj.restype = None
        dj.argtypes = [i32, p_i32, p_i32, p_t, i32, p_i32, p_t, p_i64]
        djp = getattr(lib, f"pj_dijkstra_fanout_pred_{suffix}")
        djp.restype = None
        djp.argtypes = [i32, p_i32, p_i32, p_t, i32, p_i32, p_t, p_i32, p_i64]
        ex = getattr(lib, f"pj_extract_predecessors_{suffix}")
        ex.restype = None
        ex.argtypes = [i32, p_i32, p_i32, p_t, p_t, i32, p_i32]
        bj = getattr(lib, f"pj_batch_johnson_{suffix}")
        bj.restype = i64
        bj.argtypes = [i32, i64, p_i32, i32, p_i32, p_i32, p_t, p_t, p_i32]
    _lib = lib
    return lib
