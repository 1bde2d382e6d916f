"""Slot-based paged KV-cache accounting (port of the page-accounting part
of ``repro/runtime/serving/cache.py``'s ``PagedKVCacheManager``).

The device arena is one preallocated slot-major tensor; "paging" is the
admission-control model over it: the manager tracks which fixed-size pages
each slot owns and refuses admissions or growth that would oversubscribe
the pool.  For a scaled KV format (int8, fp8) each page out of the pool
also holds a scale sidecar: the f32 scale rows beside its quantized K/V
rows, taken with the page and released exactly when the page returns.
The prefix index, ``fork`` and ``cache_insert`` are not ported: prefill
writes the slot's arena rows in place (monolithic prefill through a slot
view, each chunk by device index, its slot and start read as data by the
captured chunk step), and prefix sharing is a later slice (ROADMAP Open
items 1.7.1), whose shared chunk step takes that path too.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core import kv_format as kvf


class PagedKVCacheManager:
    """``num_pages`` pages of ``page_size`` tokens each, shared by all
    slots; handed out from a LIFO free list and returned on :meth:`free`."""

    def __init__(self, num_pages: int, page_size: int, *,
                 kv_format: str = "fp32", row_bytes: Optional[int] = None):
        """``kv_format``: the arena's storage format; a scaled one keeps
        a scale sidecar per page out of the pool.  ``row_bytes``: resident
        arena bytes of one token row (K + V + scales, all layers), for
        :meth:`resident_kv_bytes` (reference cache.py:170-196)."""
        if num_pages < 1 or page_size < 1:
            raise ValueError((num_pages, page_size))
        self.num_pages = num_pages
        self.page_size = page_size
        self.kv_format = kv_format
        self._scaled = kvf.get(kv_format).scaled
        self.row_bytes = row_bytes
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._table: dict[int, list[int]] = {}     # slot -> owned page ids
        # pages whose scale sidecar is live: the pages out of the pool,
        # when the format is scaled
        self._scale_pages: set[int] = set()
        self.stats = {"scale_sidecar_pages": 0}

    def pages_for(self, length: int) -> int:
        return max(1, math.ceil(length / self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def scale_sidecar_pages(self) -> int:
        """Pages with a live scale sidecar (0 for an unscaled format); for
        a scaled one, the pages out of the pool."""
        return len(self._scale_pages)

    def resident_kv_bytes(self, slot: int) -> int:
        """Arena bytes accounted to ``slot``'s pages (K + V + scales); 0
        without ``row_bytes``."""
        if self.row_bytes is None:
            return 0
        return len(self._table.get(slot, ())) * self.page_size \
            * self.row_bytes

    def _take(self, n: int) -> list[int]:
        pages = [self._free.pop() for _ in range(n)]
        if self._scaled:
            self._scale_pages.update(pages)
            self.stats["scale_sidecar_pages"] = len(self._scale_pages)
        return pages

    def allocate(self, slot: int, length: int) -> bool:
        """Give ``slot`` pages for ``length`` tokens; False (nothing taken)
        if the pool can't cover it."""
        if slot in self._table:
            raise ValueError(f"slot {slot} already allocated")
        need = self.pages_for(length)
        if need > self.free_pages:
            return False
        self._table[slot] = self._take(need)
        return True

    def extend(self, slot: int, new_length: int) -> bool:
        """Grow ``slot`` to ``new_length`` tokens; False => out of pages
        (the caller preempts), the slot keeps what it had."""
        if slot not in self._table:
            raise ValueError(f"slot {slot} not allocated")
        need = self.pages_for(new_length) - len(self._table[slot])
        if need > self.free_pages:
            return False
        self._table[slot].extend(self._take(max(0, need)))
        return True

    def free(self, slot: int) -> None:
        for page in reversed(self._table.pop(slot, [])):
            self._free.append(page)
            self._scale_pages.discard(page)
        self.stats["scale_sidecar_pages"] = len(self._scale_pages)
