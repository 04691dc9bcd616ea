"""Block-level prefix caching over the paged int8 KV pool.

A copy of ``protoquant_tpu/engine/prefix_cache.py`` (pure Python), over the
port's page allocator (``protoquant_tpu_torch.native.PageAllocator``).

Mechanism (vLLM-style automatic prefix caching): a KV page holding prompt
positions [i*ps, (i+1)*ps) is fully determined by the token prefix
prompt[: (i+1)*ps]. Absolute positions, causal attention and deterministic
per-token quantization make the page content bit-identical across requests
sharing that prefix. So each FULL prompt page is published under a
cumulative blake2b hash of its prefix; a later request walks its own prefix
hashes and adopts the longest chain of resident pages, skipping their
prefill (the engine starts the slot at ``lengths = matched_tokens`` and
prefills only the tail).

Safety invariants:
- Only full pages holding ONLY prompt tokens are published (pages that take
  decode writes, or the partial prompt tail, stay private).
- At least one prompt token is always left to prefill (the engine needs the
  final-position logits), so a page-aligned cached prompt matches at most
  (len-1)//ps pages.
- A published page is never written: writes go through the mapped table at
  each slot's length frontier, and every slot mapping a shared page has its
  frontier strictly beyond it.
- Pages go back to the allocator only from the zero-reference LRU (eviction
  under pool pressure) or when they were never published (private pages).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict


def _page_keys(prompt, page_size: int, n_pages: int) -> list[bytes]:
    """Cumulative content hash per full prompt page (chained blake2b)."""
    keys = []
    h = b"\x00" * 16
    for i in range(n_pages):
        chunk = prompt[i * page_size:(i + 1) * page_size]
        m = hashlib.blake2b(h, digest_size=16)
        m.update(b",".join(str(int(t)).encode() for t in chunk))
        h = m.digest()
        keys.append(h)
    return keys


class PrefixCache:
    """Host-side refcounted prefix store wrapping a PageAllocator.

    Pages move through three states: *live* (refs > 0, mapped by at least one
    request), *cached* (refs == 0, content kept, eviction-ordered in an LRU)
    and *free* (back in the allocator).
    """

    def __init__(self, allocator):
        self.allocator = allocator
        self.page_by_key: dict[bytes, int] = {}
        self.key_by_page: dict[int, bytes] = {}
        self.refs: dict[int, int] = {}
        self.lru: "OrderedDict[int, None]" = OrderedDict()
        self.hit_tokens = 0
        self.evictions = 0

    def match(self, prompt, page_size: int) -> tuple[list[int], int]:
        """Longest resident chain of full prompt pages (capped so at least
        one prompt token remains to prefill). Takes a reference on every
        matched page. Returns (pages, matched_tokens)."""
        max_pages = (len(prompt) - 1) // page_size
        pages: list[int] = []
        for key in _page_keys(prompt, page_size, max_pages):
            page = self.page_by_key.get(key)
            if page is None:
                break
            pages.append(page)
        for p in pages:
            self._ref(p)
        return pages, len(pages) * page_size

    def _ref(self, page: int):
        self.refs[page] = self.refs.get(page, 0) + 1
        self.lru.pop(page, None)

    def unref(self, pages):
        """Drop references; zero-ref pages become cached (LRU), not freed."""
        for p in pages:
            n = self.refs.get(p, 0) - 1
            if n <= 0:
                self.refs.pop(p, None)
                if p in self.key_by_page:
                    self.lru[p] = None
                    self.lru.move_to_end(p)
                else:  # an unpublished page: free it
                    self.allocator.free([p])
            else:
                self.refs[p] = n

    def publish(self, prompt, chain, page_size: int, already_shared: int):
        """Publish the request's freshly prefilled full prompt pages.

        ``chain`` is the slot's page chain (shared prefix + fresh pages);
        entries [already_shared : len(prompt)//ps] hold only prompt tokens.
        A key already in the store wins; the later page stays private (freed
        at retirement). Returns the pages this request now holds references
        on (shared + newly published)."""
        n_full = len(prompt) // page_size
        keys = _page_keys(prompt, page_size, n_full)
        held = list(chain[:already_shared])
        for i in range(already_shared, n_full):
            key, page = keys[i], chain[i]
            if key in self.page_by_key:
                continue
            self.page_by_key[key] = page
            self.key_by_page[page] = key
            self.refs[page] = self.refs.get(page, 0) + 1
            held.append(page)
        return held

    def alloc(self, n: int):
        """All-or-nothing allocation, evicting zero-ref cached pages (oldest
        first) under pool pressure."""
        while True:
            pages = self.allocator.alloc(n)
            if pages is not None:
                return pages
            if not self.lru:
                return None
            page, _ = self.lru.popitem(last=False)
            key = self.key_by_page.pop(page)
            self.page_by_key.pop(key, None)
            self.allocator.free([page])
            self.evictions += 1

    @property
    def cached_pages(self) -> int:
        return len(self.key_by_page)

    @property
    def reusable_pages(self) -> int:
        """Zero-ref cached pages (evictable capacity)."""
        return len(self.lru)
