"""Slot-based paged KV-cache management, prefix sharing and copy-on-write
(port of ``repro/runtime/serving/cache.py``'s ``PagedKVCacheManager``,
:58-565, with ``AllocResult``, ``PrefixMatch`` and the chained page keys).

The device arena is one preallocated slot-major tensor; "paging" is the
admission-control model over it: the manager tracks which fixed-size pages
each slot owns and refuses admissions or growth that would oversubscribe
the pool.  Pure host logic: no tensor passes through it.

The manager is page-centric: every page carries a refcount, and pages
holding a prompt prefix can be *registered* in a hash-consed prefix index
(a page's key is the hash of its token ids chained on its parent page's
key, so two prompts share a chain exactly as far as their token ids agree
on page boundaries).  :meth:`fork` maps a new request onto a registered
chain: the matched pages are taken by reference (refcount bump, no
ingestion) and the request copy-on-write-splits at the divergence point;
writes only ever target its private tail (the engine starts the chunk
cursor at the boundary, decode rows land past the prompt).  ``free`` drops
references; a page returns to the pool only at refcount zero, so shared
pages survive their donor's retirement or preemption.  Registered pages
live in the donor slot's region of the arena, so a region still hosting
live shared pages is *pinned*: :meth:`allocate` refuses that slot until the
last reference drops (the scheduler picks another free slot).  A recurrent
family's entry may carry a *snapshot* of the donor's state at the page's
end (an opaque object the manager holds and never touches; the engine
makes and splices it).  Under a chain cap (``max_chains``) the index holds
a reference of its own, so a chain outlives its last holder until it is
the least recently forked orphan beyond the cap.

For a scaled KV format (int8, fp8) each page out of the pool also holds a
scale sidecar: the f32 scale rows beside its quantized K/V rows, taken
with the page, shared by reference on a fork and released exactly when the
page returns to the pool.

All mutators return an :class:`AllocResult`, truthy on success, so
``bool(result)`` keeps the older bool contract.  A ``fault`` hook (the
engine binds its fault injector) refuses :meth:`allocate` / :meth:`extend`
with ``reason="fault-injected"`` when the ``alloc`` site fires.  Left out:
the reference's ``cache_insert``: prefill writes the slot's arena rows in
place (monolithic prefill through a slot view, each chunk by device
index).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Optional

import numpy as np

from repro_torch.core import kv_format as kvf


@dataclasses.dataclass(frozen=True)
class AllocResult:
    """Outcome of a page-table mutation: truthy iff it succeeded.

    ``taken``     pages newly handed out from the free pool
    ``shared``    existing prefix pages mapped by reference (fork)
    ``freed``     pages returned to the pool (refcount hit zero)
    ``retained``  pages this slot released that stay live via other holders
    ``shared_len``tokens covered by ``shared`` (the divergence boundary)
    ``src_slot``  arena region physically hosting the shared pages
    ``reason``    why it was refused (``"no-pages"``, ``"region-pinned"``,
                  ``"no-prefix"``, ``"chain-in-use"``); None on success
    """
    ok: bool
    reason: Optional[str] = None
    taken: tuple = ()
    shared: tuple = ()
    freed: tuple = ()
    retained: tuple = ()
    shared_len: int = 0
    src_slot: Optional[int] = None

    def __bool__(self) -> bool:
        return self.ok


@dataclasses.dataclass
class _PrefixEntry:
    """One registered prefix page: ``key`` = H(parent key ‖ page token
    ids), so a key match implies the whole prefix up to this page matches.
    ``snapshot``: the donor's recurrent state just after this page's last
    token (opaque here).  ``held``: the index holds a reference (chain
    cap)."""
    key: bytes
    page: int
    src_slot: int        # arena region the page physically lives in
    idx: int             # page index within the prefix (0-based)
    snapshot: Any = None
    held: bool = False


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of :meth:`PagedKVCacheManager.lookup`."""
    entries: tuple          # matched _PrefixEntry chain, idx order
    src_slot: int
    shared_len: int         # tokens covered (= len(entries) * page_size)

    @property
    def pages(self) -> tuple:
        return tuple(e.page for e in self.entries)

    @property
    def snapshot(self) -> Any:
        return self.entries[-1].snapshot if self.entries else None


def _chain_keys(tokens, n_pages: int, page_size: int,
                _H=hashlib.blake2b) -> list[bytes]:
    """Chained content keys of the first ``n_pages`` full pages of a
    prompt: key_i = H(key_{i-1} ‖ tokens[i·ps:(i+1)·ps]) (int32 bytes, as
    the reference hashes them)."""
    toks = np.asarray(tokens, np.int32)
    keys, prev = [], b""
    for i in range(n_pages):
        h = _H(prev, digest_size=16)
        h.update(toks[i * page_size:(i + 1) * page_size].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


class PagedKVCacheManager:
    """``num_pages`` pages of ``page_size`` tokens each, shared by all
    slots; handed out from a LIFO free list and returned when their
    refcount drops to zero."""

    def __init__(self, num_pages: int, page_size: int, *,
                 max_chains: Optional[int] = None,
                 fault: Optional[Any] = None, kv_format: str = "fp32",
                 row_bytes: Optional[int] = None):
        """``max_chains``: None keeps a chain's pages only while a slot
        holds them; an int makes the index hold one reference per
        registered page, so chains outlive their last holder, and evicts
        the least recently forked orphaned chain while more than
        ``max_chains`` regions host chains.  ``fault``: a callable
        ``fault(site) -> bool``; when ``fault("alloc")`` fires,
        :meth:`allocate` / :meth:`extend` refuse with ``reason=
        "fault-injected"`` and the recovery machinery (admission backoff,
        preemption) takes over (reference cache.py:146-165).
        ``kv_format``: the arena's storage format; a scaled one keeps a
        scale sidecar per page out of the pool.  ``row_bytes``: resident
        arena bytes of one token row (K + V + scales, all layers), for
        :meth:`resident_kv_bytes`."""
        if num_pages < 1 or page_size < 1:
            raise ValueError((num_pages, page_size))
        if max_chains is not None and max_chains < 1:
            raise ValueError(f"max_chains must be >= 1 or None, "
                             f"got {max_chains}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_chains = max_chains
        self._fault = fault
        self.kv_format = kv_format
        self._scaled = kvf.get(kv_format).scaled
        self.row_bytes = row_bytes
        # pages whose scale sidecar is live: the pages out of the pool,
        # when the format is scaled
        self._scale_pages: set[int] = set()
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._table: dict[int, list[int]] = {}     # slot -> owned page ids
        self._length: dict[int, int] = {}          # slot -> token count
        self._ref: dict[int, int] = {}             # page -> holder count
        self._index: dict[bytes, _PrefixEntry] = {}
        self._entry_of_page: dict[int, _PrefixEntry] = {}
        # regions hosting live registered pages (slot -> pages); one with
        # entries here and no occupant is pinned
        self._hosted: dict[int, set[int]] = {}
        # chain LRU clock: region -> tick of its last fork / registration
        # (a counter, so eviction order replays identically)
        self._chain_tick: dict[int, int] = {}
        self._tick = 0
        self.stats = {"forks": 0, "shared_pages": 0, "max_page_ref": 0,
                      "peak_pages_used": 0, "registered_pages": 0,
                      "evicted_chains": 0, "scale_sidecar_pages": 0}

    # -- queries -------------------------------------------------------------
    def pages_for(self, length: int) -> int:
        return max(1, math.ceil(length / self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_allocate(self, length: int) -> bool:
        return self.pages_for(length) <= self.free_pages

    def page_table(self, slot: int) -> tuple[int, ...]:
        return tuple(self._table.get(slot, ()))

    def length(self, slot: int) -> int:
        return self._length.get(slot, 0)

    def utilization(self) -> float:
        return 1.0 - self.free_pages / self.num_pages

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def hosts_registered(self, slot: int) -> bool:
        """``slot``'s region physically hosts registered prefix pages,
        occupied or not."""
        return bool(self._hosted.get(slot))

    def region_pinned(self, slot: int) -> bool:
        """``slot``'s region hosts live registered pages and has no
        occupant: a new one would overwrite rows forks still read."""
        return bool(self._hosted.get(slot)) and slot not in self._table

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

    def _sidecar_take(self, pages) -> None:
        if self._scaled:
            self._scale_pages.update(pages)
            self.stats["scale_sidecar_pages"] = len(self._scale_pages)

    def _pool(self, page: int) -> None:
        """Return ``page`` to the pool (its refcount is gone): the index
        entry and the scale sidecar die with it."""
        self._ref.pop(page, None)
        self._unregister(page)
        if self._scaled:
            self._scale_pages.discard(page)
            self.stats["scale_sidecar_pages"] = len(self._scale_pages)
        self._free.append(page)

    def _drop(self, pages, freed: list, retained: list) -> None:
        """Drop one reference to each of ``pages``, pooling those that
        reach zero."""
        for page in pages:
            n = self._ref.get(page, 1) - 1
            if n <= 0:
                self._pool(page)
                freed.append(page)
            else:
                self._ref[page] = n
                retained.append(page)

    def _note_usage(self) -> None:
        used = self.num_pages - len(self._free)
        if used > self.stats["peak_pages_used"]:
            self.stats["peak_pages_used"] = used

    def _take(self, n: int) -> list[int]:
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self._sidecar_take(pages)
        return pages

    # -- allocation ----------------------------------------------------------
    def allocate(self, slot: int, length: int) -> AllocResult:
        """Give ``slot`` private pages for ``length`` tokens; refused
        (nothing taken) if the pool can't cover it or the slot's region is
        pinned."""
        if slot in self._table:
            raise ValueError(f"slot {slot} already allocated")
        if self._fault is not None and self._fault("alloc"):
            return AllocResult(False, reason="fault-injected")
        if self.region_pinned(slot):
            return AllocResult(False, reason="region-pinned")
        need = self.pages_for(length)
        if need > self.free_pages:
            return AllocResult(False, reason="no-pages")
        taken = self._take(need)
        self._table[slot] = taken
        self._length[slot] = length
        self._note_usage()
        if taken and not self.stats["max_page_ref"]:
            self.stats["max_page_ref"] = 1
        return AllocResult(True, taken=tuple(taken))

    def extend(self, slot: int, new_length: int) -> AllocResult:
        """Grow ``slot`` to ``new_length`` tokens; falsy => out of pages
        (the caller preempts), the slot keeps what it had."""
        if slot not in self._table:
            raise ValueError(f"slot {slot} not allocated")
        if self._fault is not None and self._fault("alloc"):
            return AllocResult(False, reason="fault-injected")
        need = self.pages_for(new_length) - len(self._table[slot])
        if need > self.free_pages:
            return AllocResult(False, reason="no-pages")
        taken = self._take(max(0, need))
        self._table[slot].extend(taken)
        self._length[slot] = new_length
        self._note_usage()
        return AllocResult(True, taken=tuple(taken))

    def free(self, slot: int) -> AllocResult:
        """Drop ``slot``'s references; a page returns to the pool only at
        refcount zero, shared pages stay (and keep their region pinned)."""
        freed, retained = [], []
        self._drop(reversed(self._table.pop(slot, [])), freed, retained)
        self._length.pop(slot, None)
        # the departing holder may have orphaned a retained chain
        self._evict_lru(keep=-1)
        return AllocResult(True, freed=tuple(freed), retained=tuple(retained))

    # -- prefix index --------------------------------------------------------
    def register_prefix(self, slot: int, tokens, upto: int,
                        snapshot: Any = None) -> int:
        """Publish ``slot``'s ingested prompt prefix: register every full
        page covering tokens [0, upto) not yet indexed (the engine calls
        this for pure, unforked slots only).  ``snapshot`` goes on the page
        whose last token is ``upto - 1`` (``upto`` page-aligned).  A chain
        colliding with a live foreign entry is not re-registered (first
        publisher wins).  Returns the number of new pages."""
        table = self._table.get(slot)
        if table is None:
            raise ValueError(f"slot {slot} not allocated")
        n_pages = min(upto, len(np.asarray(tokens))) // self.page_size
        n_pages = min(n_pages, len(table))
        if n_pages <= 0:
            return 0
        new = 0
        for i, key in enumerate(_chain_keys(tokens, n_pages,
                                            self.page_size)):
            ent = self._index.get(key)
            if ent is None:
                ent = _PrefixEntry(key=key, page=table[i], src_slot=slot,
                                   idx=i, held=self.max_chains is not None)
                self._index[key] = ent
                self._entry_of_page[table[i]] = ent
                self._hosted.setdefault(slot, set()).add(table[i])
                if ent.held:
                    # the index's own reference
                    self._ref[table[i]] = self._ref.get(table[i], 0) + 1
                new += 1
            if (snapshot is not None and ent.src_slot == slot
                    and (i + 1) * self.page_size == upto):
                ent.snapshot = snapshot
        self.stats["registered_pages"] += new
        if new:
            self._touch_chain(slot)
            self._evict_lru(keep=slot)
        return new

    def _touch_chain(self, src_slot: int) -> None:
        self._tick += 1
        self._chain_tick[src_slot] = self._tick

    def _evictable(self, src_slot: int) -> bool:
        """Orphaned: the region has no occupant and every registered
        page's only reference is the index's."""
        pages = self._hosted.get(src_slot, ())
        return (bool(pages) and src_slot not in self._table
                and all(self._entry_of_page[p].held
                        and self._ref.get(p, 0) == 1 for p in pages))

    def _lru_orphan(self, keep: int = -1) -> Optional[int]:
        victims = [s for s in self._hosted
                   if s != keep and self._evictable(s)]
        if not victims:
            return None
        return min(victims, key=lambda s: self._chain_tick.get(s, 0))

    def _evict_lru(self, keep: int) -> None:
        """While more regions host chains than ``max_chains``, evict the
        least recently forked orphaned chain (never ``keep``); live chains
        are never evicted."""
        if self.max_chains is None:
            return
        while len(self._hosted) > self.max_chains:
            victim = self._lru_orphan(keep)
            if victim is None:
                return
            self.evict_chain(victim)

    def reclaim_orphan(self) -> bool:
        """Admission pressure: evict the least recently forked orphaned
        chain so its pages and region go to a real occupant.  True iff one
        was evicted (never without a cap: then no chain is orphaned)."""
        victim = self._lru_orphan()
        return victim is not None and bool(self.evict_chain(victim))

    def evict_chain(self, src_slot: int) -> AllocResult:
        """Drop an orphaned chain: unregister every entry hosted by
        ``src_slot``'s region and return the pages to the pool (unpinning
        the region); refused while the chain is in use."""
        if not self._evictable(src_slot):
            return AllocResult(False, reason="chain-in-use")
        pages = sorted(self._hosted.get(src_slot, ()),
                       key=lambda p: self._entry_of_page[p].idx)
        for page in reversed(pages):
            self._pool(page)
        self.stats["evicted_chains"] += 1
        return AllocResult(True, freed=tuple(reversed(pages)))

    def _unregister(self, page: int) -> None:
        ent = self._entry_of_page.pop(page, None)
        if ent is None:
            return
        self._index.pop(ent.key, None)
        hosted = self._hosted.get(ent.src_slot)
        if hosted is not None:
            hosted.discard(page)
            if not hosted:
                del self._hosted[ent.src_slot]
                self._chain_tick.pop(ent.src_slot, None)

    def lookup(self, tokens, limit: int, *,
               require_snapshot: bool = False) -> Optional[PrefixMatch]:
        """Longest registered prefix of ``tokens`` covering at most
        ``limit`` tokens, contiguous in one region (a chain stitched across
        two donors would read two slots at once).  ``require_snapshot``
        cuts it back to the longest chain whose last page carries a
        snapshot (a recurrence resumes only at a checkpoint)."""
        n_pages = min(limit, len(np.asarray(tokens))) // self.page_size
        if n_pages <= 0:
            return None
        entries: list[_PrefixEntry] = []
        for i, key in enumerate(_chain_keys(tokens, n_pages,
                                            self.page_size)):
            ent = self._index.get(key)
            if (ent is None or ent.idx != i
                    or (entries and ent.src_slot != entries[0].src_slot)):
                break
            entries.append(ent)
        if require_snapshot:
            while entries and entries[-1].snapshot is None:
                entries.pop()
        if not entries:
            return None
        return PrefixMatch(entries=tuple(entries),
                           src_slot=entries[0].src_slot,
                           shared_len=len(entries) * self.page_size)

    def fork(self, slot: int, match: PrefixMatch) -> AllocResult:
        """Copy-on-write split: ``slot`` (already holding a private
        allocation covering its prompt) releases its first
        ``len(match.entries)`` pages and takes the chain's pages by
        reference instead; the rest is its private tail."""
        table = self._table.get(slot)
        if table is None:
            raise ValueError(f"slot {slot} not allocated")
        k = len(match.entries)
        if k == 0:
            return AllocResult(False, reason="no-prefix")
        if k > len(table):
            raise ValueError(
                f"fork of slot {slot}: match covers {k} pages but the slot "
                f"holds {len(table)}")
        if any(self._index.get(e.key) is not e or self._ref.get(e.page, 0) < 1
               for e in match.entries):
            return AllocResult(False, reason="no-prefix")
        dropped = table[:k]
        shared = [e.page for e in match.entries]
        # take the new references before releasing the old ones: a slot
        # re-forking onto a chain it already shares would otherwise drive
        # the overlapping pages through refcount 0
        for p in shared:
            self._ref[p] = self._ref.get(p, 0) + 1
        freed, retained = [], []
        self._drop(dropped, freed, retained)
        self._table[slot] = shared + table[k:]
        self.stats["forks"] += 1
        self.stats["shared_pages"] += k
        ref = max(self._ref[p] for p in shared)
        if ref > self.stats["max_page_ref"]:
            self.stats["max_page_ref"] = ref
        self._touch_chain(match.src_slot)
        self._evict_lru(keep=match.src_slot)
        return AllocResult(True, shared=tuple(shared),
                           freed=tuple(freed), retained=tuple(retained),
                           shared_len=match.shared_len,
                           src_slot=match.src_slot)
