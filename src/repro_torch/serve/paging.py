"""Fixed-size page allocator for the paged KV/state cache.

A *page* is ``page_size`` consecutive sequence positions of every attention
(or MLA latent) layer's cache at once — one physical page id indexes each
layer's page array, so a request carries a single page table shared by all
layers (vLLM-style).  Pages are reference counted: prefix sharing and the
prefix cache hold extra references, and a page returns to the free list only
when its count reaches zero.

Page 0 is reserved as the *scratch* page: idle decode slots point their page
tables at it so the batched decode step always has a legal write target.  It
is never allocated and never counted as in use.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, List

SCRATCH_PAGE = 0


class OutOfPages(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


class PagePool:
    """Free-list allocator with reference counting over ``num_pages`` pages."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least one page beyond the scratch page")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = deque(range(1, num_pages))
        self._refcount = [0] * num_pages
        self._refcount[SCRATCH_PAGE] = 1  # pinned forever

    # ------------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Pages with a live reference, excluding the pinned scratch page."""
        return sum(1 for i, c in enumerate(self._refcount) if c > 0) - 1

    def refcount(self, page: int) -> int:
        return self._refcount[page]

    # ------------------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` fresh pages (refcount 1 each)."""
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._refcount[p] = 1
        return pages

    def share(self, pages: Iterable[int]) -> None:
        """Take an extra reference on already-allocated pages."""
        for p in pages:
            if p == SCRATCH_PAGE:
                raise ValueError("cannot share the scratch page")
            if self._refcount[p] == 0:
                raise ValueError(f"page {p} is not allocated")
            self._refcount[p] += 1

    def free(self, pages: Iterable[int]) -> None:
        """Drop one reference per page; pages hitting zero become reusable."""
        for p in pages:
            if p == SCRATCH_PAGE:
                raise ValueError("cannot free the scratch page")
            if self._refcount[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(p)

    # ------------------------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        """Number of pages covering ``n_tokens`` positions."""
        return -(-n_tokens // self.page_size)
