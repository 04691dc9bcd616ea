"""Dense int8 KV cache with per-token, per-head scales.

Layout as in the JAX package: kq/vq [B, KV, S, Dh] int8 (head-major, so one
(batch, kv head) row of the cache is contiguous), ks/vs [B, KV, S] f32,
lengths [B] int32 with a length per slot, so the same cache serves
single-request generation and the continuous-batching engine.

Unlike the JAX cache, which is an immutable pytree, this one is updated IN
PLACE: ``update`` and ``update_and_attend`` write the new tokens into the
cache tensors and advance ``lengths`` on the same object, and
``slot_view`` returns views, so writes through a slot view land in the
full cache.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.numerics import SCALE_EPS, quantize_rowwise
from ..ops.attention import int8_kv_attention
from ..ops.kv_scatter import kv_scatter_decode
from ..utils.device import resolve_device

_FIELDS = ("kq", "ks", "vq", "vs", "lengths")


def quantize_kv(x: torch.Tensor):
    """Per-token, per-head symmetric int8: x [B, T, KV, Dh] ->
    (q int8 same shape, scale f32 [B, T, KV])."""
    return quantize_rowwise(x)


@dataclasses.dataclass
class Int8KVCache:
    """kq/vq: [B, KV, S, Dh] int8; ks/vs: [B, KV, S] f32; lengths: [B] int32."""

    kq: torch.Tensor
    ks: torch.Tensor
    vq: torch.Tensor
    vs: torch.Tensor
    lengths: torch.Tensor

    @classmethod
    def init(cls, batch, max_seq, kv_heads, head_dim, device=None):
        """An empty cache on ``device`` (default cuda)."""
        device = resolve_device(device)
        payload = (batch, kv_heads, max_seq, head_dim)
        scales = (batch, kv_heads, max_seq)
        return cls(
            kq=torch.zeros(payload, dtype=torch.int8, device=device),
            ks=torch.full(scales, SCALE_EPS, dtype=torch.float32, device=device),
            vq=torch.zeros(payload, dtype=torch.int8, device=device),
            vs=torch.full(scales, SCALE_EPS, dtype=torch.float32, device=device),
            lengths=torch.zeros(batch, dtype=torch.int32, device=device),
        )

    @property
    def max_seq(self) -> int:
        return self.kq.shape[2]

    def _write(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Quantize k/v [B, T, KV, Dh] and write them at each slot's length.

        Decode (T == 1) goes through ``kv_scatter_decode``. Prefill writes
        with a masked index_put: positions at or past S are dropped, as the
        JAX scatter drops out-of-bounds indices (padded prefill buckets can
        reach them; ``index_put_`` would raise instead).
        """
        B, T, KV, Dh = k.shape
        k8, ks_new = quantize_kv(k)
        v8, vs_new = quantize_kv(v)
        if T == 1:
            kv_scatter_decode(
                self.kq, self.ks, self.vq, self.vs, self.lengths,
                k8.reshape(B, KV, 1, Dh), ks_new.reshape(B, KV, 1),
                v8.reshape(B, KV, 1, Dh), vs_new.reshape(B, KV, 1))
            return
        pos = self.lengths.long()[:, None] + torch.arange(T, device=k.device)[None, :]
        keep = pos < self.max_seq
        b_idx = torch.arange(B, device=k.device)[:, None].expand(B, T)[keep]
        s_idx = pos[keep]
        self.kq[b_idx, :, s_idx] = k8[keep]
        self.vq[b_idx, :, s_idx] = v8[keep]
        self.ks[b_idx, :, s_idx] = ks_new[keep]
        self.vs[b_idx, :, s_idx] = vs_new[keep]

    def _advance(self, T: int, advance) -> None:
        if advance is None:
            self.lengths += T
        else:
            self.lengths += advance.to(torch.int32)

    def update(self, k, v, advance=None) -> "Int8KVCache":
        """Append k/v [B, T, KV, Dh] at each slot's length, in place.

        ``advance`` [B] overrides how far each slot's length moves (default
        T): padded prefill advances only by the true prompt length and
        inactive decode slots by 0, so their extra rows stay masked and are
        overwritten by the slot's next real token.
        """
        self._write(k, v)
        self._advance(k.shape[1], advance)
        return self

    def update_and_attend(self, q, k, v, advance=None):
        """Write k/v, attend q [B, T, H, Dh] over the cache with the lengths
        from before this step, then advance. Returns [B, T, H, Dh]."""
        self._write(k, v)
        out = int8_kv_attention(q, self.kq, self.ks, self.vq, self.vs, self.lengths)
        self._advance(k.shape[1], advance)
        return out

    def slot_view(self, slot: int) -> "Int8KVCache":
        """A batch-1 cache of views into slot ``slot`` (writes land here)."""
        return Int8KVCache(*(getattr(self, f)[slot:slot + 1] for f in _FIELDS))

    def merge_slot(self, small: "Int8KVCache", slot: int) -> "Int8KVCache":
        """Copy a batch-1 cache into slot ``slot`` (nothing to copy for a
        view made by ``slot_view``)."""
        for f in _FIELDS:
            dst, src = getattr(self, f)[slot:slot + 1], getattr(small, f)
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        return self

    def reset_slot(self, slot: int) -> "Int8KVCache":
        """Zero one slot's length (its rows are masked by length)."""
        self.lengths[slot] = 0
        return self
