"""Builds and loads the port's ``csrc/wf_runtime.cpp`` with ctypes.

The library is compiled with ``g++ -O2 -std=c++17 -shared -fPIC`` into
``build/wf_runtime/`` at the repository root (beside the CUDA kernels'
``build/wf_torch_kernels/``), named by the source's content hash, and
published with an atomic rename, so concurrent processes build it at most
once each and never load a half-written file. Plain C ABI: the signatures
are the JAX package's (``wrinklefree_tpu/native/build.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

CSRC = Path(__file__).resolve().parent.parent / "csrc" / "wf_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wf_runtime"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i32p, vpp = c.POINTER(c.c_int32), c.POINTER(c.c_void_p)
    sigs = {
        "wf_alloc_create": (c.c_void_p, [c.c_int32]),
        "wf_alloc_destroy": (None, [c.c_void_p]),
        "wf_alloc_num_free": (c.c_int64, [c.c_void_p]),
        "wf_alloc_alloc": (c.c_int32, [c.c_void_p, c.c_int32, i32p]),
        "wf_alloc_retain": (c.c_int32, [c.c_void_p, c.c_int32]),
        "wf_alloc_release": (c.c_int32, [c.c_void_p, c.c_int32]),
        "wf_alloc_refcount": (c.c_int32, [c.c_void_p, c.c_int32]),
        "wf_radix_create": (c.c_void_p, [c.c_void_p, c.c_int32]),
        "wf_radix_destroy": (None, [c.c_void_p]),
        "wf_radix_match": (c.c_int64, [c.c_void_p, i32p, c.c_int64, i32p, vpp,
                                        c.POINTER(c.c_int64)]),
        "wf_radix_lock": (None, [c.c_void_p, vpp, c.c_int64]),
        "wf_radix_unlock": (None, [c.c_void_p, vpp, c.c_int64]),
        "wf_radix_insert": (c.c_int64, [c.c_void_p, i32p, c.c_int64, i32p, c.c_int64]),
        "wf_radix_evict": (c.c_int64, [c.c_void_p, c.c_int64]),
        "wf_radix_num_cached": (c.c_int64, [c.c_void_p]),
        "wf_radix_reset": (None, [c.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def library_path() -> Path:
    """Where the library for the current source lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + CSRC.read_bytes())
    return BUILD_DIR / f"wf_runtime_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already on disk; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(CSRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic publish
    finally:
        tmp.unlink(missing_ok=True)
    logger.info("built the native runtime: %s", out)
    return out


def load_runtime() -> Optional[ctypes.CDLL]:
    """The compiled library, or None (the caller falls back to Python). One
    attempt per process."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        _lib = _configure(ctypes.CDLL(str(build())))
    except Exception as e:  # no compiler, a read-only tree, ...
        logger.warning("native runtime unavailable (%s); using the Python classes", e)
        _lib = None
    return _lib
