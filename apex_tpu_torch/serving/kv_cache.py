"""Paged KV cache: block-granular allocation as index arithmetic
(counterpart of ``apex_tpu/serving/kv_cache.py``).

Device side: K and V each live as one ``[layers, h, num_pages, page_size,
head_dim]`` tensor. Allocating a page to a sequence is writing its index
into that sequence's page-table row; freeing it is forgetting the index.
The tensors never change shape for the life of an engine. The head axis
leads the page axis, the layout the decode kernel
(``csrc/decode_attention.cu``) reads a ``[page_size, head_dim]`` page
block from.

Host side: :class:`PageAllocator`, an explicit free list over pages
``1..num_pages-1``. Page 0 is reserved as the null page: padded page-table
tails and padded prefill tokens point at it, so a garbage index never
aliases a live sequence's data.
"""

import torch


def init_cache(num_layers, num_heads, num_pages, page_size, head_dim,
               dtype=torch.bfloat16, device=None):
    """Zeroed cache dict ``{"k", "v"}`` of
    ``[layers, h, num_pages, page_size, head_dim]`` tensors (bf16 or fp32;
    the int8 tier is not ported yet)."""
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"init_cache: unsupported cache dtype {dtype}")
    shape = (num_layers, num_heads, num_pages, page_size, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def pages_needed(tokens, page_size):
    """Pages to hold ``tokens`` positions at this page size."""
    return -(-int(tokens) // int(page_size))


class PageAllocator:
    """Explicit-free-list page allocator (host side).

    Pages ``1..num_pages-1`` are allocatable; page 0 is the reserved null
    page. Allocation is all-or-nothing per request: :meth:`alloc` returns
    the page list or None when the free list is short, and the scheduler
    then leaves the request queued.
    """

    def __init__(self, num_pages):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = int(num_pages)
        # LIFO free list: recently freed pages are re-used first
        self._free = list(range(1, self.num_pages))
        self._owned = {}  # owner id -> list of page indices

    @property
    def free_count(self):
        return len(self._free)

    def live_pages(self, owner=None):
        if owner is not None:
            return list(self._owned.get(owner, ()))
        return [p for pages in self._owned.values() for p in pages]

    def alloc(self, owner, n):
        """Allocate ``n`` pages to ``owner`` (appending to any it already
        holds); returns the new page list or None when the free list
        cannot cover the request (state unchanged)."""
        n = int(n)
        if n == 0:
            return []
        if len(self._free) < n:
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(pages)
        return pages

    def free(self, owner):
        """Return all of ``owner``'s pages to the free list."""
        for p in self._owned.pop(owner, ()):
            self._free.append(p)

    def check_invariants(self):
        """Raise AssertionError on aliasing or accounting drift: no page
        owned twice, no page both free and owned, page 0 never handed
        out, free + live == allocatable."""
        live = self.live_pages()
        assert len(live) == len(set(live)), (
            f"page aliasing across live owners: {sorted(live)}")
        assert 0 not in live and 0 not in self._free, (
            "null page 0 escaped the reservation")
        overlap = set(live) & set(self._free)
        assert not overlap, f"pages both free and owned: {overlap}"
        assert len(live) + len(self._free) == self.num_pages - 1, (
            f"accounting drift: {len(live)} live + "
            f"{len(self._free)} free != {self.num_pages - 1}")
