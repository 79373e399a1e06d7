"""Radix prefix cache at KV-page granularity.

Completed sequences are inserted as chains of full pages keyed by their
page_size-token chunks; new prompts match the longest full-page prefix and
reuse those pages (refcount++), skipping prefill for the shared part. A
copy of ``wrinklefree_tpu/engine/radix_cache.py``.

Eviction: LRU over refcount-0 leaves, releasing pages back to the
allocator.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

from .page_allocator import PageAllocator


class _Node:
    __slots__ = ("chunk", "page", "children", "parent", "last_used", "lock_refs")

    def __init__(self, chunk: Tuple[int, ...], page: int, parent: "_Node | None"):
        self.chunk = chunk
        self.page = page
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.last_used = time.monotonic()
        self.lock_refs = 0  # in-flight requests currently using this node


class RadixCache:
    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self.root = _Node((), -1, None)
        self._nodes = 0

    # -- matching --------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int], List["_Node"]]:
        """Longest full-page prefix match.

        Returns (matched_token_count, page_ids, matched_nodes). The caller
        MUST call lock(nodes) to pin them (refcounts the pages) before
        using the pages, and unlock(nodes) when done.
        """
        ps = self.page_size
        node = self.root
        pages: List[int] = []
        nodes: List[_Node] = []
        i = 0
        while i + ps <= len(tokens):
            chunk = tuple(tokens[i : i + ps])
            child = node.children.get(chunk)
            if child is None:
                break
            pages.append(child.page)
            nodes.append(child)
            child.last_used = time.monotonic()
            node = child
            i += ps
        return i, pages, nodes

    def lock(self, nodes: Sequence[_Node]) -> None:
        for n in nodes:
            n.lock_refs += 1
            self.allocator.retain(n.page)

    def unlock(self, nodes: Sequence[_Node]) -> None:
        for n in nodes:
            n.lock_refs -= 1
            self.allocator.release(n.page)

    # -- insertion -------------------------------------------------------

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Insert full pages of a finished sequence.

        `pages[j]` holds tokens [j*ps, (j+1)*ps). Pages newly adopted by
        the tree gain a reference (the tree's own); pages for chunks that
        already exist are NOT adopted (caller keeps/releases its ref).
        Returns number of pages adopted.
        """
        ps = self.page_size
        node = self.root
        adopted = 0
        for j in range(min(len(pages), len(tokens) // ps)):
            chunk = tuple(tokens[j * ps : (j + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                page = pages[j]
                self.allocator.retain(page)  # tree's reference
                child = _Node(chunk, page, node)
                node.children[chunk] = child
                self._nodes += 1
                adopted += 1
            child.last_used = time.monotonic()
            node = child
        return adopted

    # -- eviction --------------------------------------------------------

    def evict(self, num_pages: int) -> int:
        """Evict up to num_pages LRU unlocked leaves; returns count evicted."""
        evicted = 0
        while evicted < num_pages:
            leaves = [
                n
                for n in self._iter_nodes()
                if not n.children and n.lock_refs == 0 and n.parent is not None
            ]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: n.last_used)
            del victim.parent.children[victim.chunk]
            self.allocator.release(victim.page)
            self._nodes -= 1
            evicted += 1
        return evicted

    def _iter_nodes(self):
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                yield n
            stack.extend(n.children.values())

    @property
    def num_cached_pages(self) -> int:
        return self._nodes

    def reset(self):
        for n in list(self._iter_nodes()):
            self.allocator.release(n.page)
        self.root.children.clear()
        self._nodes = 0
