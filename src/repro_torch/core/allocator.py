"""SPMC page-pool allocator (paper Sec. 3.1, "FastFlow allocator").

The paper's observation: in a streaming network, allocation is asymmetric —
*one* entity allocates (the Emitter materialising tasks) and *other*
entities free (Workers/Collector).  Exploiting that asymmetry, the allocator
needs no lock at all: frees travel back to the allocating entity over
per-freer SPSC rings, and every mutation of the pool happens on the
allocator's own thread.

The port's copy of ``repro.core.allocator``.  Here the same design backs
the production use-case of this repo: the **paged KV-cache pool** of the
serving farm (`launch/serve.py`).  The
admitter (Emitter) allocates pages for new requests; decode workers release
pages of finished requests through their private free-rings.  This is the
2026 re-materialisation of the paper's SPMC allocator — vLLM-style paging
with FastFlow's synchronisation-free bookkeeping.

Pages are integer ids into an optional caller-owned backing store, so the
allocator is equally usable for host numpy slabs and for device KV pages
(where the id indexes a page table fed to the decode step).
"""
from __future__ import annotations

from typing import List, Optional

from .spsc import SPSCQueue

__all__ = ["PagePool", "PoolExhausted"]


class PoolExhausted(RuntimeError):
    pass


class PagePool:
    """Lock-free SPMC pool of ``npages`` integer page ids.

    Contract (enforced by discipline, checked by tests):
      * ``alloc``/``drain`` are called only from the allocator entity's thread;
      * ``free(page, freer)`` is called only from freer ``freer``'s thread.
    """

    def __init__(self, npages: int, nfreers: int = 1, ring_capacity: Optional[int] = None):
        assert npages >= 1 and nfreers >= 1
        self.npages = npages
        self.nfreers = nfreers
        self._free_list: List[int] = list(range(npages - 1, -1, -1))
        cap = ring_capacity or (npages + 2)
        self._free_rings = [SPSCQueue(cap) for _ in range(nfreers)]
        self.allocated = 0
        self.freed = 0

    # -- allocator-thread side ----------------------------------------------
    def drain(self) -> int:
        """Pull returned pages from all free-rings back into the pool."""
        n = 0
        for ring in self._free_rings:
            while True:
                page = ring.pop()
                if page is SPSCQueue._EMPTY:
                    break
                self._free_list.append(page)
                n += 1
        return n

    def alloc(self) -> int:
        if not self._free_list:
            self.drain()
        if not self._free_list:
            raise PoolExhausted(f"all {self.npages} pages in flight")
        self.allocated += 1
        return self._free_list.pop()

    def try_alloc(self) -> Optional[int]:
        try:
            return self.alloc()
        except PoolExhausted:
            return None

    def alloc_many(self, n: int) -> List[int]:
        pages = []
        try:
            for _ in range(n):
                pages.append(self.alloc())
        except PoolExhausted:
            # all-or-nothing: return what we grabbed
            self._free_list.extend(pages)
            self.allocated -= len(pages)
            raise
        return pages

    def available(self) -> int:
        """Lower bound (free-rings may hold more)."""
        return len(self._free_list)

    # -- freer-thread side ----------------------------------------------------
    def free(self, page: int, freer: int = 0) -> None:
        assert 0 <= page < self.npages
        self._free_rings[freer].push_wait(page)
        self.freed += 1

    def free_many(self, pages: List[int], freer: int = 0) -> None:
        for p in pages:
            self.free(p, freer)
