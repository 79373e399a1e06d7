"""Build and load the port's CUDA kernels (``wrinklefree_tpu_torch/csrc/*.cu``).

The sources have a plain C interface and are bound with ctypes: each ``.cu``
compiles to an object with ``nvcc -gencode arch=compute_90a,code=sm_90a
-O3`` (all sources at once, one process each), and the objects link into one
shared library under ``build/wf_torch_kernels/``, named by a hash of the
sources, their headers (``*.cuh``) and flags so an edited source never loads a stale build. The build
runs at first use, never at import: this module imports on hosts without
``nvcc`` or a GPU.

No ``--use_fast_math``: the kernels rely on IEEE division, ``sqrtf`` and
``expf`` to match their plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "wf_torch_kernels"
FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    "wf_ternary_fused": [_P, _I, _I, _I, _I, _I, _P, _F, _P, _P, _I, _I, _P, _P, _I, _P, _P],
    "wf_mlp_mega": [_P, _I, _I, _I, _I, _P, _P, _F, _P, _P, _I, _P, _P, _I,
                    _P, _P, _P, _P, _P, _P, _P, _P],
    "wf_kv_write": [_P, _P, _P, _P, _I, _I, _LL, _LL, _P],
    "wf_flash_paged_prefill": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                               _P],
    "wf_flash_paged_prefill_pool": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _F, _I, _I, _P],
    "wf_attn_mega": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _F, _P, _P, _I, _P, _P, _I,
                     _P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "wf_flash_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _F, _I, _I, _P],
    "wf_flash_paged_decode_occupancy": [_I, _P],
    "wf_ternary_matmul": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "wf_flash_prefill": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                         _P],
    "wf_stream_touch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
}
# K8 takes K5's arguments (without the stream), then K2's after h, B and H
SIGNATURES["wf_layer_mega"] = SIGNATURES["wf_attn_mega"][:-1] + SIGNATURES["wf_mlp_mega"][3:]


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libwf_torch_kernels-{h.hexdigest()[:12]}.so"


# builds this process ran (a library already on disk is no build: a cache
# hit), and their seconds: the serving bench counts those inside its measured
# window (utils/torchcache.py's CompileWatcher)
BUILDS = {"count": 0, "seconds": 0.0, "cache_hits": 0}


_BUILD_LOCK = threading.Lock()  # one build at a time (the server's threads)


def build() -> Path:
    """Compile every source in parallel and link the shared library (skipped
    when the library for these sources already exists). The compiler's
    register and shared-memory report, with each source's compile seconds,
    goes to ``ptxas.txt`` beside it. Threads that ask at once wait for one
    build."""
    with _BUILD_LOCK:
        return _build()


def _build() -> Path:
    so = _library_path()
    if so.exists():
        BUILDS["cache_hits"] += 1
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / (s.stem + "-" + so.stem[-12:] + ".o") for s in sources]
    logs = [o.with_suffix(".log") for o in objs]
    t0 = time.perf_counter()
    procs = []
    for s, o, log in zip(sources, objs, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen([nvcc, *FLAGS, "-c", str(s), "-o", str(o)],
                                          stdout=f, stderr=subprocess.STDOUT))
    secs = {}
    while len(secs) < len(procs):
        for s, p in zip(sources, procs):
            if s.name not in secs and p.poll() is not None:
                secs[s.name] = time.perf_counter() - t0
        time.sleep(0.02)
    report = []
    failed = []
    for s, p, log in zip(sources, procs, logs):
        report.append(f"== {s.name} ({secs[s.name]:.1f} s)\n{log.read_text()}")
        if p.returncode != 0:
            failed.append(s.name)
    (BUILD_DIR / "ptxas.txt").write_text("\n".join(report))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(report))
    tmp = so.with_suffix(".tmp.so")
    link = subprocess.run(
        [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
         *map(str, objs)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    tmp.replace(so)
    BUILDS["count"] += 1
    BUILDS["seconds"] += time.perf_counter() - t0
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.wf_error_string.argtypes = [ctypes.c_int]
    lib.wf_error_string.restype = ctypes.c_char_p
    return lib


def timed_build() -> float:
    """Load the library, building it if needed; returns the seconds taken."""
    t0 = time.perf_counter()
    library()
    return time.perf_counter() - t0


def call(name: str, *args) -> None:
    """Call a kernel entry point and raise if it reports a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: {lib.wf_error_string(rc).decode()}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the C entry points take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (read once per device)."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {t.device}")
