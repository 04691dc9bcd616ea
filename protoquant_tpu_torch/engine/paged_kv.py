"""Paged int8 KV cache: page pools addressed through a page table.

Counterpart of ``protoquant_tpu/engine/paged_kv.py`` (without
``reorder_tail``, which belongs to tree speculation).

Device side: per-layer int8 page pools with per-token, per-head scales,
addressed through a [B, max_pages_per_seq] page table. The table and
lengths are kept in each layer's cache object (a few KB), so the paged
cache keeps the dense cache's ``update_and_attend(q, k, v, advance)`` and
the model stays layout-agnostic.

Host side: the engine takes pages from the native free list
(``protoquant_tpu_torch.native.PageAllocator``) when it admits a request
and gives them back when it retires it, so a request reserves
ceil((prompt + max_new) / page_size) pages instead of a max_seq row.

Unlike the JAX cache, an immutable pytree, this one is updated IN PLACE,
like the port's dense cache: writes land in the pools, ``lengths`` advances
on the same object, and ``slot_view`` shares the pools and views one row of
the table and lengths.

Attention: decode steps (T == 1) run ``paged_int8_attention``, which walks
the page table itself (with ALiBi slopes, if given), so no window is
gathered. Prefill chunks gather the mapped pages into a contiguous window
and run ``int8_kv_attention`` over it (the JAX package runs its XLA
formulation there; both compute the same function). So do decode steps
with a sliding window, a score scale or a softcap: the page-walk kernel is
full-causal, as in the JAX package, which sends the same cases to its
gathered XLA path; ALiBi goes along to either.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.numerics import SCALE_EPS
from ..models.kv_cache import quantize_kv
from ..ops.attention import int8_kv_attention, reject_variants
from ..ops.kv_scatter import page_slots, paged_kv_scatter_decode
from ..ops.paged_attention import gather_window, paged_int8_attention
from ..utils.device import resolve_device

_POOLS = ("kq", "ks", "vq", "vs")


@dataclasses.dataclass
class PagedInt8KVCache:
    """kq/vq: [num_pages, KV, page_size, Dh] int8 (head-major pages, so one
    (page, head) tile of (ps, Dh) is contiguous); ks/vs: [num_pages, KV, 1,
    page_size] f32; page_table: [B, max_pages] int32 (-1 = unmapped);
    lengths: [B] int32."""

    kq: torch.Tensor
    ks: torch.Tensor
    vq: torch.Tensor
    vs: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    page_size: int

    @classmethod
    def init(cls, batch, num_pages, max_pages_per_seq, page_size, kv_heads, head_dim,
             device=None):
        """``num_pages`` INCLUDES one reserved trash page (the last index):
        writes through unmapped table entries land there, so an idle slot
        with a cleared table can never write into a live page. The pools
        live on ``device`` (default cuda)."""
        device = resolve_device(device)
        payload = (num_pages, kv_heads, page_size, head_dim)
        scales = (num_pages, kv_heads, 1, page_size)
        return cls(
            kq=torch.zeros(payload, dtype=torch.int8, device=device),
            ks=torch.full(scales, SCALE_EPS, dtype=torch.float32, device=device),
            vq=torch.zeros(payload, dtype=torch.int8, device=device),
            vs=torch.full(scales, SCALE_EPS, dtype=torch.float32, device=device),
            page_table=torch.full((batch, max_pages_per_seq), -1, dtype=torch.int32,
                                  device=device),
            lengths=torch.zeros(batch, dtype=torch.int32, device=device),
            page_size=page_size,
        )

    @property
    def window(self) -> int:
        """Most tokens one sequence can address."""
        return self.page_table.shape[1] * self.page_size

    def _write(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Quantize k/v [B, T, KV, Dh] and write them at each slot's length
        through its page table.

        Decode (T == 1) goes through ``paged_kv_scatter_decode``. Prefill
        writes with one indexed assignment per pool; positions whose table
        entry is unmapped, or that lie past the window (padded prefill
        rows), go to the trash page, never into a live page.
        """
        B, T, KV, Dh = k.shape
        k8, ks_new = quantize_kv(k)
        v8, vs_new = quantize_kv(v)
        if T == 1:
            paged_kv_scatter_decode(
                self.kq, self.ks, self.vq, self.vs, self.page_table, self.lengths,
                k8.reshape(B, KV, 1, Dh), ks_new.reshape(B, KV, 1),
                v8.reshape(B, KV, 1, Dh), vs_new.reshape(B, KV, 1))
            return
        pos = self.lengths.long()[:, None] + torch.arange(T, device=k.device)[None, :]
        page, off = page_slots(self.page_table, pos, self.page_size, self.kq.shape[0])
        # advanced indices on dims 0 and 2 put [B, T] first: [B, T, KV, ...]
        self.kq[page, :, off] = k8
        self.vq[page, :, off] = v8
        self.ks[page, :, 0, off] = ks_new
        self.vs[page, :, 0, off] = vs_new

    def _advance(self, T: int, advance) -> None:
        if advance is None:
            self.lengths += T
        else:
            self.lengths += advance.to(torch.int32)

    def update(self, k, v, advance=None) -> "PagedInt8KVCache":
        """Append k/v [B, T, KV, Dh] at each slot's length, in place;
        ``advance`` [B] overrides how far each length moves (default T)."""
        self._write(k, v)
        self._advance(k.shape[1], advance)
        return self

    def update_and_attend(self, q, k, v, advance=None, window=0, scale=0.0, softcap=0.0,
                          tree_mask=None, alibi_slopes=None, sink_logits=None):
        """Write k/v, attend q [B, T, H, Dh] over the slot's pages with the
        lengths from before this step, then advance. Returns [B, T, H, Dh].
        Learned sinks raise: the JAX paged cache takes none, so GPT-OSS is
        not served paged."""
        reject_variants("PagedInt8KVCache (the JAX paged cache takes no learned sinks: "
                        "serve GPT-OSS over a dense cache)", tree_mask=tree_mask,
                        sink_logits=sink_logits)
        self._write(k, v)
        pools = (self.kq, self.ks, self.vq, self.vs)
        if q.shape[1] == 1 and not (window or scale or softcap):
            out = paged_int8_attention(q, *pools, self.page_table, self.lengths,
                                       alibi_slopes=alibi_slopes)
        else:
            out = int8_kv_attention(q, *gather_window(*pools, self.page_table),
                                    self.lengths, window=window, scale=scale,
                                    softcap=softcap, alibi_slopes=alibi_slopes)
        self._advance(k.shape[1], advance)
        return out

    # -- host-side table management ---------------------------------------

    def map_slot(self, slot: int, pages: list[int], start_len: int = 0):
        """Give ``slot`` the page chain ``pages``. ``start_len`` > 0 adopts
        the first ``start_len`` tokens already resident in the chain's
        leading pages (prefix caching): the slot's frontier starts past
        them, so the shared pages are read-only for this tenant."""
        row = torch.full((self.page_table.shape[1],), -1, dtype=torch.int32)
        row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
        self.page_table[slot] = row.to(self.page_table.device)
        self.lengths[slot] = start_len
        return self

    def reset_slot(self, slot: int):
        """Retire a slot: zero its length AND unmap its pages (they are about
        to be freed and handed out again; a stale entry would let this idle
        slot's decode writes reach the next tenant)."""
        self.lengths[slot] = 0
        self.page_table[slot] = -1
        return self

    def slot_view(self, slot: int) -> "PagedInt8KVCache":
        """A batch-1 cache sharing the pools, with views of one row of the
        table and lengths (writes land in this cache)."""
        return dataclasses.replace(self, page_table=self.page_table[slot:slot + 1],
                                   lengths=self.lengths[slot:slot + 1])

    def merge_slot(self, small: "PagedInt8KVCache", slot: int):
        """Take a batch-1 cache back into slot ``slot`` (nothing to copy for
        a view made by ``slot_view``)."""
        for f in _POOLS + ("page_table", "lengths"):
            src = getattr(small, f)
            dst = getattr(self, f) if f in _POOLS else getattr(self, f)[slot:slot + 1]
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        return self
