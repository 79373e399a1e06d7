"""The kernels' build cache and an in-window compile guard (PyTorch port of
``wrinklefree_tpu/utils/jaxcache.py``).

The eager port compiles two kinds of programs: the CUDA kernels, which
``ops/cuda_lib.py`` builds with nvcc into one shared library named by a hash
of the sources (a library already on disk is a cache hit), and CUDA graphs,
which the decode bench (``bench/decode.py``) and the calibration
(``bench/calibrate.py``) capture.

- ``enable_persistent_cache`` points the kernels' build cache
  (``cuda_lib.BUILD_DIR``, ``build/wf_torch_kernels/`` of the checkout by
  default) at the directory that ``$WF_KERNEL_CACHE_DIR`` names, or at
  ``default_dir``, so that separate checkouts or processes share one build.
  Call it before the first kernel launch: a library already loaded stays.
- ``CompileWatcher`` counts, process-wide, the kernel builds
  (``cuda_lib.BUILDS``) and the CUDA-graph captures, so that a bench can
  check that none happened inside its measured window
  (``bench/serving.py``'s ``in_window_compiles``).
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path

ENV_VAR = "WF_KERNEL_CACHE_DIR"

_lock = threading.Lock()
_installed = False
_captures = 0
_capture_secs = 0.0


def enable_persistent_cache(default_dir: str | None = None) -> str | None:
    """Point the kernels' build cache at ``$WF_KERNEL_CACHE_DIR`` (or
    ``default_dir``). Returns the directory in effect, or None if neither is
    set (the cache then stays where it is). Idempotent."""
    from ..ops import cuda_lib

    d = os.environ.get(ENV_VAR) or default_dir
    if not d:
        return None
    path = Path(d).resolve()
    path.mkdir(parents=True, exist_ok=True)
    cuda_lib.BUILD_DIR = path
    return str(path)


def _install_capture_hooks() -> None:
    """Wrap ``torch.cuda.CUDAGraph``'s capture_begin/capture_end (once per
    process) to count the captures and their seconds."""
    global _installed
    with _lock:
        if _installed:
            return
        import torch

        graph_cls = torch.cuda.CUDAGraph
        begin, end = graph_cls.capture_begin, graph_cls.capture_end

        def capture_begin(self, *args, **kwargs):
            self._wf_capture_t0 = time.perf_counter()
            return begin(self, *args, **kwargs)

        def capture_end(self):
            out = end(self)
            note_capture(time.perf_counter() - getattr(self, "_wf_capture_t0", time.perf_counter()))
            return out

        graph_cls.capture_begin = capture_begin
        graph_cls.capture_end = capture_end
        _installed = True


def note_capture(seconds: float) -> None:
    """Count one finished CUDA-graph capture that took ``seconds``."""
    global _captures, _capture_secs
    with _lock:
        _captures += 1
        _capture_secs += seconds


class CompileWatcher:
    """Process-wide compile counter.

    >>> w = CompileWatcher()          # installs the capture hooks (idempotent)
    >>> ... warmup ...
    >>> snap = w.snapshot()
    >>> ... measured window ...
    >>> delta = w.delta(snap)         # {"compiles": n, "compile_s": s,
    ...                               #  "cache_hits": h, "builds": b,
    ...                               #  "graph_captures": g}

    ``compiles`` counts the kernel builds and the CUDA-graph captures;
    ``cache_hits`` the kernel libraries found already built on disk. For an
    in-window guard, any nonzero ``compiles`` means the warmup missed a
    program.
    """

    def __init__(self) -> None:
        _install_capture_hooks()

    def snapshot(self) -> tuple:
        from ..ops import cuda_lib

        b = cuda_lib.BUILDS
        with _lock:
            return (b["count"], b["seconds"], b["cache_hits"], _captures, _capture_secs)

    def delta(self, snap: tuple) -> dict:
        b0, s0, h0, c0, cs0 = snap
        b1, s1, h1, c1, cs1 = self.snapshot()
        return {
            "compiles": (b1 - b0) + (c1 - c0),
            "compile_s": round((s1 - s0) + (cs1 - cs0), 3),
            "cache_hits": h1 - h0,
            "builds": b1 - b0,
            "graph_captures": c1 - c0,
        }
