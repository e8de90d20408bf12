"""Paged KV cache: fixed-size pages in a preallocated pool.

Host-side copy of ``apex_tpu/serve/cache.py`` (the port imports nothing of
the JAX package).  The device holds ONE preallocated pool per K and V,
shaped

    (num_layers, num_pages, page_size, num_heads, head_dim)

and every request owns a host-side **page table** — a fixed-length list
of pool page indices, one per ``page_size`` tokens of its context
window.  The pool never grows: admission and decode-time growth
allocate pages from a host-side free list (:class:`PagePool`), and
exhaustion raises the typed :class:`KVCacheExhaustedError` that the
scheduler turns into graceful request shedding — a full cache degrades
service, it never runs the device out of memory.

Page 0 is a reserved SCRATCH page, never allocated: unbacked page-table
slots point at it, so gathers over a fixed-width table stay in-bounds.
Scratch contents are arbitrary (concurrent writers race into it) but
always finite, and the decode attention masks every position beyond a
request's context length to exactly-zero contribution, so mid-flight page
recycling is invisible to surviving requests.

All bookkeeping here is host-side python over ints — the pool tensors
are owned by the engine and this module performs zero device work and
zero host syncs.
"""
from __future__ import annotations

import dataclasses
from typing import List

__all__ = ["CacheConfig", "PagePool", "KVCacheExhaustedError",
           "SCRATCH_PAGE"]

#: reserved pool page unbacked table slots point at (never allocated)
SCRATCH_PAGE = 0


class KVCacheExhaustedError(RuntimeError):
    """The page pool cannot satisfy an allocation.  Typed so the
    scheduler can shed the requesting request (metered in the serve
    ledger's ``shed`` class) instead of letting the device OOM."""

    def __init__(self, requested: int, free: int):
        self.requested = int(requested)
        self.free = int(free)
        super().__init__(
            f"KV cache exhausted: requested {requested} page(s), "
            f"{free} free — shedding instead of growing the pool")


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Static paged-cache geometry.

    ``max_ctx`` is the fixed context window every decode step gathers
    (prompt + generated tokens must fit); it must be a whole number of
    pages so a request's gathered window is exactly its page table."""
    page_size: int = 16
    num_pages: int = 64
    max_ctx: int = 64

    def __post_init__(self):
        if self.page_size < 1 or self.num_pages < 2 or self.max_ctx < 1:
            raise ValueError(f"bad cache geometry {self}")
        if self.max_ctx % self.page_size:
            raise ValueError(
                f"max_ctx {self.max_ctx} must be a multiple of page_size "
                f"{self.page_size} (whole-page context windows)")

    @property
    def pages_per_request(self) -> int:
        return self.max_ctx // self.page_size

    def pages_for(self, num_tokens: int) -> int:
        """Pages needed to back ``num_tokens`` of context."""
        return -(-int(num_tokens) // self.page_size)


class PagePool:
    """Host-side free list over pool pages ``[1, num_pages)`` (page 0
    is the reserved scratch page).  Allocation is all-or-nothing:
    a request that cannot get every page it asked for gets none, so a
    shed request never leaks partial allocations."""

    def __init__(self, cfg: CacheConfig):
        self.cfg = cfg
        self._free: List[int] = list(range(1, cfg.num_pages))
        self._allocated = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return self._allocated

    def alloc(self, n: int) -> List[int]:
        n = int(n)
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise KVCacheExhaustedError(n, len(self._free))
        pages, self._free = self._free[:n], self._free[n:]
        self._allocated += n
        return pages

    def free(self, pages: List[int]) -> None:
        """Return pages to the pool (mid-flight eviction recycling)."""
        for p in pages:
            p = int(p)
            if not (0 < p < self.cfg.num_pages):
                raise ValueError(f"free of out-of-range page {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
        self._free.extend(int(p) for p in pages)
        self._allocated -= len(pages)
