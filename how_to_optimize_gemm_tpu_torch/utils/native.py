"""ctypes loader for the paged-KV allocator's native backend.

Counterpart: ``how_to_optimize_gemm_tpu/utils/native.py``
(``paged_alloc_lib``). The C++ source is the repository's
``csrc/paged_alloc.cpp``, which compiles on its own. At first use it is
built with ``g++ -O3 -fPIC -shared -std=c++17`` into
``build/native/`` at the repository root (named by a hash of the source
and flags, so an edited source is rebuilt), then loaded; nothing is
built when this module is imported, and nothing is written under
``csrc/``. A missing compiler raises RuntimeError: the caller asked for
the native backend, and the Python one is not substituted.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = ROOT / "csrc" / "paged_alloc.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LIB: ctypes.CDLL | None = None


def _build() -> pathlib.Path:
    """The built library's path, compiling it first when needed."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} not found: the native allocator "
                           "needs a checkout of the repository")
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f"libpaged_alloc-{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native allocator cannot be "
                           "built (alloc_backend='py' needs no compiler)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{res.stderr}")
    os.replace(tmp, out)       # atomic: concurrent builders agree
    return out


def paged_alloc_lib() -> ctypes.CDLL:
    """The loaded library with the ``pa_*`` prototypes attached."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(_build()))
    h, i64 = ctypes.c_void_p, ctypes.c_int64
    tok_ptr = ctypes.POINTER(ctypes.c_int32)
    protos = {
        "pa_new": ([i64, i64, i64, i64, ctypes.c_int], h),
        "pa_delete": ([h], None),
        "pa_grow_slot": ([h, i64, i64], ctypes.c_int),
        "pa_release_slot": ([h, i64], None),
        "pa_attach_prefix": ([h, i64, tok_ptr, i64, i64], i64),
        "pa_register_prefix": ([h, i64, tok_ptr, i64, i64], None),
        "pa_table_ptr": ([h], h),
        "pa_free_pages": ([h], i64),
        "pa_cached_pages": ([h], i64),
        "pa_hit_tokens": ([h], i64),
        "pa_slot_npages": ([h, i64], i64),
    }
    for name, (argtypes, restype) in protos.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _LIB = lib
    return lib
