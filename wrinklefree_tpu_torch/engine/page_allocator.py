"""Refcounted page allocator for the paged KV pool.

Host-side bookkeeping for the device pools in kv/paged.py: a LIFO free
list plus refcounts for radix prefix sharing. Page 0 is reserved as the
trash page and is never allocated. A copy of
``wrinklefree_tpu/engine/page_allocator.py`` (the port imports nothing of
the reference package).
"""

from __future__ import annotations

from typing import List


class PageAllocator:
    TRASH_PAGE = 0

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        # LIFO free list; page 0 reserved
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref = [0] * num_pages

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"out of KV pages (want {n}, free {len(self._free)})")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def retain(self, page: int) -> None:
        assert self._ref[page] > 0, f"retain of free page {page}"
        self._ref[page] += 1

    def release(self, page: int) -> None:
        if page == self.TRASH_PAGE:
            return
        assert self._ref[page] > 0, f"double free of page {page}"
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)

    def release_all(self, pages) -> None:
        for p in pages:
            self.release(p)

    def refcount(self, page: int) -> int:
        return self._ref[page]
