"""Slot-based paged KV-cache accounting (port of the page-accounting part
of ``repro/runtime/serving/cache.py``'s ``PagedKVCacheManager``).

The device arena is one preallocated slot-major tensor; "paging" is the
admission-control model over it: the manager tracks which fixed-size pages
each slot owns and refuses admissions or growth that would oversubscribe
the pool.  The prefix index, ``fork`` and ``cache_insert`` are not ported:
prefill writes the slot's arena rows in place, and prefix sharing is a
later slice (ROADMAP Open items 1.7.1).
"""
from __future__ import annotations

import math


class PagedKVCacheManager:
    """``num_pages`` pages of ``page_size`` tokens each, shared by all
    slots; handed out from a LIFO free list and returned on :meth:`free`."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError((num_pages, page_size))
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._table: dict[int, list[int]] = {}     # slot -> owned page ids

    def pages_for(self, length: int) -> int:
        return max(1, math.ceil(length / self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def allocate(self, slot: int, length: int) -> bool:
        """Give ``slot`` pages for ``length`` tokens; False (nothing taken)
        if the pool can't cover it."""
        if slot in self._table:
            raise ValueError(f"slot {slot} already allocated")
        need = self.pages_for(length)
        if need > self.free_pages:
            return False
        self._table[slot] = [self._free.pop() for _ in range(need)]
        return True

    def extend(self, slot: int, new_length: int) -> bool:
        """Grow ``slot`` to ``new_length`` tokens; False => out of pages
        (the caller preempts), the slot keeps what it had."""
        if slot not in self._table:
            raise ValueError(f"slot {slot} not allocated")
        need = self.pages_for(new_length) - len(self._table[slot])
        if need > self.free_pages:
            return False
        self._table[slot].extend(self._free.pop() for _ in range(max(0, need)))
        return True

    def free(self, slot: int) -> None:
        for page in reversed(self._table.pop(slot, [])):
            self._free.append(page)
