"""ctypes wrappers: native replacements for ``engine.page_allocator.
PageAllocator`` and ``engine.radix_cache.RadixCache`` with the same API.
Radix nodes are opaque handles (ints) instead of Python objects: callers
keep them only to hand them back to ``lock``/``unlock``, and insert pages,
not nodes. Counterpart of ``wrinklefree_tpu/native/runtime.py``."""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

from .build import load_runtime


def native_available() -> bool:
    return load_runtime() is not None


def _i32_array(seq: Sequence[int]) -> "ctypes.Array":
    return (ctypes.c_int32 * len(seq))(*seq)


def _handles(nodes: Sequence[int]) -> "ctypes.Array":
    return (ctypes.c_void_p * len(nodes))(*nodes)


class NativePageAllocator:
    """C++ refcounted LIFO page allocator; page 0 (the trash page) is never
    handed out and releasing it is a no-op."""

    TRASH_PAGE = 0

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self._lib = load_runtime()
        if self._lib is None:
            raise RuntimeError("native runtime not available")
        self._h = self._lib.wf_alloc_create(num_pages)
        self.num_pages = num_pages

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.wf_alloc_destroy(h)
            self._h = None

    @property
    def num_free(self) -> int:
        return self._lib.wf_alloc_num_free(self._h)

    def alloc(self, n: int = 1) -> List[int]:
        out = (ctypes.c_int32 * n)()
        if self._lib.wf_alloc_alloc(self._h, n, out) != 0:
            raise MemoryError(f"out of KV pages (want {n}, free {self.num_free})")
        return list(out)

    def retain(self, page: int) -> None:
        if self._lib.wf_alloc_retain(self._h, page) != 0:
            raise AssertionError(f"retain of free page {page}")

    def release(self, page: int) -> None:
        if self._lib.wf_alloc_release(self._h, page) != 0:
            raise AssertionError(f"double free of page {page}")

    def release_all(self, pages) -> None:
        for p in pages:
            self.release(p)

    def refcount(self, page: int) -> int:
        return self._lib.wf_alloc_refcount(self._h, page)


class NativeRadixCache:
    """C++ radix prefix tree over full KV pages (LRU eviction of unlocked
    leaves); ``match`` returns node handles."""

    def __init__(self, allocator: NativePageAllocator, page_size: int):
        if not isinstance(allocator, NativePageAllocator):
            raise TypeError("NativeRadixCache needs a NativePageAllocator")
        self._lib = allocator._lib
        self.allocator = allocator
        self.page_size = page_size
        self._h = self._lib.wf_radix_create(allocator._h, page_size)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.wf_radix_destroy(h)
            self._h = None

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int], List[int]]:
        """(matched token count, page ids, node handles) of the longest
        full-page prefix; lock the handles before using the pages."""
        cap = max(1, len(tokens) // self.page_size)
        pages = (ctypes.c_int32 * cap)()
        nodes = (ctypes.c_void_p * cap)()
        count = ctypes.c_int64()
        matched = self._lib.wf_radix_match(self._h, _i32_array(tokens), len(tokens), pages,
                                           nodes, ctypes.byref(count))
        k = count.value
        return int(matched), list(pages[:k]), list(nodes[:k])

    def lock(self, nodes: Sequence[int]) -> None:
        self._lib.wf_radix_lock(self._h, _handles(nodes), len(nodes))

    def unlock(self, nodes: Sequence[int]) -> None:
        self._lib.wf_radix_unlock(self._h, _handles(nodes), len(nodes))

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        adopted = self._lib.wf_radix_insert(self._h, _i32_array(tokens), len(tokens),
                                            _i32_array(pages), len(pages))
        if adopted < 0:
            raise AssertionError("insert adopted a free page")
        return adopted

    def evict(self, num_pages: int) -> int:
        return self._lib.wf_radix_evict(self._h, num_pages)

    @property
    def num_cached_pages(self) -> int:
        return self._lib.wf_radix_num_cached(self._h)

    def reset(self):
        self._lib.wf_radix_reset(self._h)
