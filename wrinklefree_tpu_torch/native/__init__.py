"""Native (C++) host runtime for the engine's bookkeeping.

``load_runtime()`` returns the compiled ``csrc/wf_runtime.cpp`` library
(built with g++ on first use), or None when it cannot be built; the engine
then falls back to the Python classes. Counterpart of
``wrinklefree_tpu/native``.
"""

from .build import load_runtime
from .runtime import NativePageAllocator, NativeRadixCache, native_available

__all__ = ["load_runtime", "NativePageAllocator", "NativeRadixCache", "native_available"]
