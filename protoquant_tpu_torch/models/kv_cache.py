"""Dense KV caches: ``BF16KVCache`` (K/V unquantized, the reference's
default), int8 with per-token, per-head scales, the ring ``RingInt8KVCache``
(int8, O(window) columns for sliding-window and StreamingLLM serving), the
mixed ``MixedKVCache`` (int8 K, packed int4 V per token), and the KIVI
capacity tiers ``K4V8KVCache`` (int4 K, int8 V) and ``Int4KVCache`` (int4 K
and V), each with an int8 tail of the latest 2G tokens (below).

Int8 layout as in the JAX package: kq/vq [B, KV, S, Dh] int8 (head-major, so one
(batch, kv head) row of the cache is contiguous), ks/vs [B, KV, S] f32,
lengths [B] int32 with a length per slot, so the same cache serves
single-request generation and the continuous-batching engine.

Unlike the JAX caches, which are immutable pytrees, these are updated IN
PLACE: ``update`` and ``update_and_attend`` write the new tokens into the
cache tensors and advance ``lengths`` on the same object, and
``slot_view`` returns views, so writes through a slot view land in the
full cache.

Every ``update_and_attend`` takes the keyword arguments of its JAX
counterpart: ``window`` (sliding window), ``scale`` (score scale),
``softcap`` (Gemma-2 logit cap), ``alibi_slopes`` (BLOOM), ``sink_logits``
(GPT-OSS's learned sinks), ``tree_mask``. The bf16, int8 and KIVI caches
attend with the first five; the ring with the first four and the K8V4
cache with ``scale`` alone: they raise on the others as the JAX ones do
(the JAX ring takes no learned sinks, so GPT-OSS is served over neither).
Tree masks are not ported. A cache raises ``NotImplementedError`` before
it writes anything.
``mha_attention`` and ``BF16KVCache`` apply ALiBi before the softcap (the
JAX model's ``mha_attention``), the int8 and KIVI kernels after it (its
``int8_kv_attention_xla``).
"""

from __future__ import annotations

import dataclasses

import torch

# kivi_chunk_quantize and the nibble helpers live in core.numerics; they are
# named here too, where the JAX package keeps them
from ..core.numerics import (QMAX4, SCALE_EPS, kivi_chunk_quantize,  # noqa: F401
                             pack_nib_pair, quantize_rowwise, unpack_nib_pair)
from ..ops.attention import (int4_kv_attention, int8_kv_attention, k4v8_attention,
                             kivi_dequant_k, kivi_dequant_v4, mixed_kv_attention,
                             reject_variants, score_scale, softmax_with_sinks, unpack_v4)
from ..ops.kv_scatter import (k4v8_decode_update, kivi4_decode_update,
                              kv_mixed_scatter_decode, kv_scatter_decode, merge_nibble)
from ..utils.device import resolve_device


def quantize_kv(x: torch.Tensor):
    """Per-token, per-head symmetric int8: x [B, T, KV, Dh] ->
    (q int8 same shape, scale f32 [B, T, KV])."""
    return quantize_rowwise(x)


def quantize_kv4(x: torch.Tensor):
    """Per-token, per-head symmetric int4: x [B, T, KV, Dh] -> (nibble
    values as int8 in [-7, 7], unpacked, and scale f32 [B, T, KV]);
    s = max(amax / 7, 1e-12) by true division, codes round(x / s) half to
    even, as the JAX package's ``quantize_kv4`` run eagerly."""
    return quantize_rowwise(x, QMAX4)


def mha_attention(q, k, v, q_positions, k_positions, window: int = 0, scale: float = 0.0,
                  softcap: float = 0.0, alibi_slopes=None, sink_logits=None):
    """Plain causal GQA attention over unquantized keys and values (the
    scoring path, and ``BF16KVCache``'s attention), in f32.

    q [B, T, H, Dh]; k/v [B, S, KV, Dh]; a key is visible to a query iff its
    position is not greater than the query's and, with ``window`` > 0, more
    than window - 1 positions behind it. ``scale`` > 0 replaces Dh^-0.5;
    ``alibi_slopes`` [H] subtract slope_h * (query position - key position)
    from the scaled scores; ``softcap`` > 0 then caps them, cap * tanh(s /
    cap), before the mask; ``sink_logits`` [H] join the softmax without a
    value (``protoquant_tpu/models/llama.py:mha_attention``)."""
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    group = H // KV
    qf = q.reshape(B, T, KV, group, Dh).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * score_scale(Dh, scale)
    if alibi_slopes is not None:
        dist = (q_positions[:, :, None] - k_positions[:, None, :]).float()  # [B, T, S]
        sl = alibi_slopes.float().reshape(KV, group)
        scores = scores - sl[None, :, :, None, None] * dist[:, None, None]
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    kp = k_positions[:, None, None, None, :]
    qp = q_positions[:, None, None, :, None]
    mask = kp <= qp
    if window > 0:
        mask &= kp > qp - window
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = softmax_with_sinks(scores, sink_logits, KV, group)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(B, T, H, Dh).to(q.dtype)


def _prefill_positions(lengths, T: int, S: int):
    """Where a prefill of T tokens lands: (batch index, position) of each
    token below S, and the mask [B, T] of those tokens. Positions at or past
    S are dropped, as the JAX scatter drops out-of-bounds indices (padded
    prefill buckets can reach them; ``index_put_`` would raise instead)."""
    B, dev = lengths.shape[0], lengths.device
    pos = lengths.long()[:, None] + torch.arange(T, device=dev)[None, :]
    keep = pos < S
    return torch.arange(B, device=dev)[:, None].expand(B, T)[keep], pos[keep], keep


class _DenseSlots:
    """Slot handling shared by the dense caches, whose tensor fields
    (``FIELDS``, ``lengths`` last) are all batch-major."""

    FIELDS = ()

    def slot_view(self, slot: int):
        """A batch-1 cache of views into slot ``slot`` (writes land here)."""
        return dataclasses.replace(
            self, **{f: getattr(self, f)[slot:slot + 1] for f in self.FIELDS})

    def merge_slot(self, small, slot: int):
        """Copy a batch-1 cache into slot ``slot`` (nothing to copy for a
        view made by ``slot_view``)."""
        for f in self.FIELDS:
            dst, src = getattr(self, f)[slot:slot + 1], getattr(small, f)
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        return self

    def reset_slot(self, slot: int):
        """Zero one slot's length (its rows are masked by length)."""
        self.lengths[slot] = 0
        return self

    def _advance(self, T: int, advance) -> None:
        if advance is None:
            self.lengths += T
        else:
            self.lengths += advance.to(torch.int32)

    def update(self, k, v, advance=None):
        """Append k/v [B, T, KV, Dh] at each slot's length, in place.

        ``advance`` [B] overrides how far each slot's length moves (default
        T): padded prefill advances only by the true prompt length and
        inactive decode slots by 0, so their extra rows stay masked and are
        overwritten by the slot's next real token.
        """
        self._write(k, v)
        self._advance(k.shape[1], advance)
        return self


@dataclasses.dataclass
class BF16KVCache(_DenseSlots):
    """k/v: [B, S, KV, Dh] in a float dtype (bf16 by default); lengths: [B]
    int32. The JAX package's default cache: plain PyTorch, as the JAX one is
    plain XLA (no TPU kernel backs it)."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    FIELDS = ("k", "v", "lengths")

    @classmethod
    def init(cls, batch, max_seq, kv_heads, head_dim, dtype=torch.bfloat16, device=None):
        """An empty cache of ``dtype`` on ``device`` (default cuda)."""
        device = resolve_device(device)
        shape = (batch, max_seq, kv_heads, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   lengths=torch.zeros(batch, dtype=torch.int32, device=device))

    @property
    def max_seq(self) -> int:
        return self.k.shape[1]

    def _write(self, k, v) -> None:
        b_idx, s_idx, keep = _prefill_positions(self.lengths, k.shape[1], self.max_seq)
        self.k[b_idx, s_idx] = k[keep].to(self.k.dtype)
        self.v[b_idx, s_idx] = v[keep].to(self.v.dtype)

    def update_and_attend(self, q, k, v, advance=None, window=0, scale=0.0, softcap=0.0,
                          sink_logits=None, tree_mask=None, alibi_slopes=None):
        """Write k/v, attend q [B, T, H, Dh] (query t at position lengths +
        t, before this step) over every cached key, then advance."""
        reject_variants("BF16KVCache", tree_mask=tree_mask)
        B, T = k.shape[:2]
        self._write(k, v)
        dev = q.device
        q_pos = self.lengths.long()[:, None] + torch.arange(T, device=dev)[None, :]
        k_pos = torch.arange(self.max_seq, device=dev)[None, :].expand(B, self.max_seq)
        out = mha_attention(q, self.k, self.v, q_pos, k_pos, window, scale, softcap,
                            alibi_slopes, sink_logits)
        self._advance(T, advance)
        return out


@dataclasses.dataclass
class Int8KVCache(_DenseSlots):
    """kq/vq: [B, KV, S, Dh] int8; ks/vs: [B, KV, S] f32; lengths: [B] int32."""

    kq: torch.Tensor
    ks: torch.Tensor
    vq: torch.Tensor
    vs: torch.Tensor
    lengths: torch.Tensor

    FIELDS = ("kq", "ks", "vq", "vs", "lengths")

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

    def _write_k(self, k8, ks_new, b_idx, s_idx, keep) -> None:
        """Prefill: K codes and scales at the kept positions."""
        self.kq[b_idx, :, s_idx] = k8[keep]
        self.ks[b_idx, :, s_idx] = ks_new[keep]

    def _write(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Quantize k/v [B, T, KV, Dh] and write them at each slot's length:
        decode (T == 1) through ``kv_scatter_decode``, prefill with masked
        index writes (``_prefill_positions``)."""
        B, T, KV, Dh = k.shape
        k8, ks_new = quantize_kv(k)
        v8, vs_new = quantize_kv(v)
        if T == 1:
            kv_scatter_decode(
                self.kq, self.ks, self.vq, self.vs, self.lengths,
                k8.reshape(B, KV, 1, Dh), ks_new.reshape(B, KV, 1),
                v8.reshape(B, KV, 1, Dh), vs_new.reshape(B, KV, 1))
            return
        b_idx, s_idx, keep = _prefill_positions(self.lengths, T, self.max_seq)
        self._write_k(k8, ks_new, b_idx, s_idx, keep)
        self.vq[b_idx, :, s_idx] = v8[keep]
        self.vs[b_idx, :, s_idx] = vs_new[keep]

    def update_and_attend(self, q, k, v, advance=None, window=0, scale=0.0, softcap=0.0,
                          sink_logits=None, tree_mask=None, alibi_slopes=None):
        """Write k/v, attend q [B, T, H, Dh] over the cache with the lengths
        from before this step (and the window, scale, softcap, ALiBi slopes
        and learned sinks given), then advance. Returns [B, T, H, Dh]."""
        reject_variants("Int8KVCache", tree_mask=tree_mask)
        self._write(k, v)
        out = int8_kv_attention(q, self.kq, self.ks, self.vq, self.vs, self.lengths,
                                window=window, scale=scale, softcap=softcap,
                                alibi_slopes=alibi_slopes, sink_logits=sink_logits)
        self._advance(k.shape[1], advance)
        return out


def ring_positions(lengths, capacity: int, sinks: int = 0) -> torch.Tensor:
    """The absolute position each ring column holds once a slot's length is
    ``lengths`` [B] (after this step's writes), as [B, capacity] int32,
    negative for a column never written: the first ``sinks`` columns hold
    their own positions, the others the latest position >= sinks that maps
    to them (``RingInt8KVCache.update_and_attend`` of the JAX package)."""
    L = lengths.long()[:, None]
    c = torch.arange(capacity, device=lengths.device)[None, :]
    if sinks == 0:
        return ((L - 1) - ((L - 1 - c) % capacity)).to(torch.int32)
    R = capacity - sinks
    rot = (L - 1) - ((L - 1 - c) % R)
    rot = torch.where(rot >= sinks, rot, torch.full_like(rot, -1))
    pinned = torch.where(c < L, c, torch.full_like(c, -1))
    return torch.where(c < sinks, pinned, rot).to(torch.int32)


@dataclasses.dataclass
class RingInt8KVCache(_DenseSlots):
    """Ring-buffer int8 cache for sliding-window and StreamingLLM serving:
    O(window) columns per slot instead of O(max_seq). The layout of
    ``Int8KVCache`` (kq/vq [B, KV, C, Dh] int8, ks/vs [B, KV, C] f32,
    lengths [B] int32) over a ring of C = capacity >= sinks + window +
    max_chunk columns: position p < sinks lives in column p forever
    (StreamingLLM sinks), any other in column sinks + (p - sinks) mod (C -
    sinks), so a T-token update never overwrites a column any of its own
    queries still needs. Attention rebuilds each column's position from the
    length after the write (``ring_positions``) and masks on it, so the
    result is the dense windowed cache's. Port of
    ``protoquant_tpu/models/kv_cache.py:RingInt8KVCache``, updated in place;
    the write is plain PyTorch, as the JAX one is plain XLA."""

    kq: torch.Tensor
    ks: torch.Tensor
    vq: torch.Tensor
    vs: torch.Tensor
    lengths: torch.Tensor
    window: int
    sinks: int = 0

    FIELDS = ("kq", "ks", "vq", "vs", "lengths")

    @classmethod
    def init(cls, batch, window, max_chunk, kv_heads, head_dim, sinks=0, device=None):
        """An empty ring on ``device`` (default cuda) of capacity sinks +
        window + max_chunk rounded up to a multiple of 32."""
        device = resolve_device(device)
        cap = -(-(sinks + window + max_chunk) // 32) * 32
        payload = (batch, kv_heads, cap, head_dim)
        scales = (batch, kv_heads, cap)
        return cls(
            kq=torch.zeros(payload, dtype=torch.int8, device=device),
            ks=torch.full(scales, SCALE_EPS, dtype=torch.float32, device=device),
            vq=torch.zeros(payload, dtype=torch.int8, device=device),
            vs=torch.full(scales, SCALE_EPS, dtype=torch.float32, device=device),
            lengths=torch.zeros(batch, dtype=torch.int32, device=device),
            window=window, sinks=sinks)

    @property
    def capacity(self) -> int:
        return self.kq.shape[2]

    @property
    def max_seq(self) -> int:
        """A ring imposes no position limit (the engine bounds lengths)."""
        return 1 << 30

    def _column(self, pos):
        """Ring column of absolute position(s) ``pos``."""
        R = self.capacity - self.sinks
        return torch.where(pos < self.sinks, pos, self.sinks + (pos - self.sinks) % R)

    def _write(self, k, v) -> None:
        """Quantize k/v [B, T, KV, Dh] and write all T tokens (padding
        included, as the JAX cache does) at their ring columns."""
        B, T = k.shape[:2]
        slack = self.capacity - self.window - self.sinks
        if T > slack:
            raise ValueError(f"chunk {T} exceeds ring slack {slack} (init with max_chunk >= "
                             "prefill chunk)")
        k8, ks_new = quantize_kv(k)
        v8, vs_new = quantize_kv(v)
        pos = self.lengths.long()[:, None] + torch.arange(T, device=k.device)[None, :]
        b_idx = torch.arange(B, device=k.device)[:, None]
        col = self._column(pos)
        self.kq[b_idx, :, col] = k8
        self.ks[b_idx, :, col] = ks_new
        self.vq[b_idx, :, col] = v8
        self.vs[b_idx, :, col] = vs_new

    def update_and_attend(self, q, k, v, advance=None, window=0, scale=0.0, softcap=0.0,
                          sink_logits=None, tree_mask=None, alibi_slopes=None):
        """Write k/v, attend q [B, T, H, Dh] over the ring's columns at the
        positions they hold after the write (the window is ``window``, or
        the ring's own), then advance. Returns [B, T, H, Dh]."""
        reject_variants("RingInt8KVCache (the JAX ring takes no learned sinks: serve GPT-OSS "
                        "over a dense cache)", sink_logits=sink_logits, tree_mask=tree_mask)
        T = k.shape[1]
        self._write(k, v)
        k_pos = ring_positions(self.lengths + T, self.capacity, self.sinks)
        out = int8_kv_attention(q, self.kq, self.ks, self.vq, self.vs, self.lengths,
                                window=window if window > 0 else self.window, scale=scale,
                                softcap=softcap, k_positions=k_pos, sinks=self.sinks,
                                alibi_slopes=alibi_slopes)
        self._advance(T, advance)
        return out


@dataclasses.dataclass
class MixedKVCache(Int8KVCache):
    """K8V4: K int8 per token as ``Int8KVCache`` (kq [B, KV, S, Dh], ks [B,
    KV, S]); V int4 per token, packed by token pair as ``Int4KVCache``'s V:
    vq [B, KV, S/2, Dh] int8 (row r: token 2r in the low nibble, 2r + 1 in
    the high one), vs [B, KV, 2, S/2] f32 (plane 0 even tokens, 1 odd).
    Full-causal attention only, with a score scale. Port of
    ``protoquant_tpu/models/kv_cache.py:MixedKVCache`` (``kv_dtype="k8v4"``);
    updated in place. Prefill drops V writes at or past S, as the decode
    writer does (the JAX prefill clamps them onto position S - 1)."""

    @classmethod
    def init(cls, batch, max_seq, kv_heads, head_dim, device=None):
        """An empty cache on ``device`` (default cuda); ``max_seq`` even."""
        if max_seq % 2:
            raise ValueError("mixed KV needs an even max_seq (V pair packing)")
        device = resolve_device(device)
        B, KV, S, Dh = batch, kv_heads, max_seq, head_dim
        return cls(
            kq=torch.zeros(B, KV, S, Dh, dtype=torch.int8, device=device),
            ks=torch.full((B, KV, S), SCALE_EPS, dtype=torch.float32, device=device),
            vq=torch.zeros(B, KV, S // 2, Dh, dtype=torch.int8, device=device),
            vs=torch.full((B, KV, 2, S // 2), SCALE_EPS, dtype=torch.float32, device=device),
            lengths=torch.zeros(B, dtype=torch.int32, device=device))

    def _write(self, k, v) -> None:
        """Quantize K to int8 and V to int4 and write them at each slot's
        length: decode through ``kv_mixed_scatter_decode``; prefill writes K
        as ``Int8KVCache`` and V by two sequential parity merges, even
        tokens first (the JAX ``_write_v_parity``)."""
        B, T, KV, Dh = k.shape
        k8, ks_new = quantize_kv(k)
        v4, vs_new = quantize_kv4(v)
        if T == 1:
            kv_mixed_scatter_decode(
                self.kq, self.ks, self.vq, self.vs, self.lengths,
                k8.reshape(B, KV, 1, Dh), ks_new.reshape(B, KV, 1),
                v4.reshape(B, KV, 1, Dh), vs_new.reshape(B, KV, 1))
            return
        b_idx, s_idx, keep = _prefill_positions(self.lengths, T, self.max_seq)
        self._write_k(k8, ks_new, b_idx, s_idx, keep)
        v4, vs_new = v4[keep], vs_new[keep]
        for parity in (0, 1):
            sel = s_idx % 2 == parity
            b, row = b_idx[sel], s_idx[sel] // 2
            self.vq[b, :, row] = merge_nibble(self.vq[b, :, row], v4[sel], parity)
            self.vs[b, :, parity, row] = vs_new[sel]

    def _unpack_v(self):
        """V as per-token nibble values [B, KV, S, Dh] int8 and scales [B,
        KV, S] (the JAX ``_unpack_v``)."""
        return unpack_v4(self.vq, self.vs)

    def update_and_attend(self, q, k, v, advance=None, window=0, scale=0.0, softcap=0.0,
                          sink_logits=None, tree_mask=None, alibi_slopes=None):
        """Write k/v, attend q [B, T, H, Dh] over the cache with the lengths
        from before this step, then advance. Returns [B, T, H, Dh]. A
        window, a softcap, sinks or ALiBi raise, as in the JAX cache."""
        reject_variants("MixedKVCache (full-causal rope attention only, as the JAX one; no "
                        "GPT-OSS learned sinks)", window=window,
                         softcap=softcap, sink_logits=sink_logits, tree_mask=tree_mask,
                         alibi_slopes=alibi_slopes)
        self._write(k, v)
        out = mixed_kv_attention(q, self.kq, self.ks, self.vq, self.vs, self.lengths,
                                 scale=scale)
        self._advance(k.shape[1], advance)
        return out


# -- KIVI capacity tiers: K4V8KVCache and Int4KVCache ---------------------------

# Default KIVI chunk size (tokens per per-channel K scale). A module global
# read when a cache is made, as in the JAX package, so tests can lower it.
INT4_KV_GROUP = 64

_KIVI_FIELDS = ("kq", "kchs", "vq", "vs", "ktail", "kts", "vtail", "vts", "lengths")


@dataclasses.dataclass
class _KiviKVCache(_DenseSlots):
    """The K side shared by both KIVI tiers (G = ``group``, F = (length //
    G) G): kq [B, KV, S/2, Dh] int8 packed K nibbles of completed chunks
    (row r: token 2r low nibble, 2r + 1 high), kchs [B, KV, S/G, Dh] f32
    per-(chunk, channel) K scales, ktail [B, KV, 2G, Dh] int8 + kts [B, KV,
    2G] f32 per-token int8 tail (row j: the latest token with position = j
    mod 2G), and the V tail vtail/vts of the same shape. Every token goes to
    the tail first; a chunk is requantized from its tail rows once complete
    (``core.numerics.kivi_chunk_quantize``), so chunked prefill and
    token-by-token decode give the same cache bit for bit. Updated in place,
    as ``Int8KVCache``."""

    kq: torch.Tensor
    kchs: torch.Tensor
    vq: torch.Tensor
    vs: torch.Tensor
    ktail: torch.Tensor
    kts: torch.Tensor
    vtail: torch.Tensor
    vts: torch.Tensor
    lengths: torch.Tensor
    group: int = 64

    V4 = False  # Int4KVCache: V packed like K (per-token scales)
    FIELDS = _KIVI_FIELDS

    @classmethod
    def init(cls, batch, max_seq, kv_heads, head_dim, group=None, device=None):
        """An empty cache on ``device`` (default cuda); ``group`` defaults
        to INT4_KV_GROUP, at most max_seq."""
        device = resolve_device(device)
        group = min(INT4_KV_GROUP if group is None else group, max_seq)
        if max_seq % group or group % 2:
            raise ValueError(f"{cls.__name__} needs max_seq % group == 0 and an even group "
                             f"(max_seq={max_seq}, group={group})")
        B, KV, S, Dh, G = batch, kv_heads, max_seq, head_dim, group

        def eps(*shape):
            return torch.full(shape, SCALE_EPS, dtype=torch.float32, device=device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int8, device=device)

        if cls.V4:
            vq, vs = zeros(B, KV, S // 2, Dh), eps(B, KV, 2, S // 2)
        else:
            vq, vs = zeros(B, KV, S, Dh), eps(B, KV, S)
        return cls(kq=zeros(B, KV, S // 2, Dh), kchs=eps(B, KV, S // G, Dh), vq=vq, vs=vs,
                   ktail=zeros(B, KV, 2 * G, Dh), kts=eps(B, KV, 2 * G),
                   vtail=zeros(B, KV, 2 * G, Dh), vts=eps(B, KV, 2 * G),
                   lengths=torch.zeros(B, dtype=torch.int32, device=device), group=G)

    @property
    def max_seq(self) -> int:
        return self.kq.shape[2] * 2

    def _tensors(self):
        return tuple(getattr(self, f) for f in _KIVI_FIELDS[:-1])

    def _write(self, k, v, adv) -> None:
        """Quantize k/v [B, T, KV, Dh] to per-token int8 and write them, in
        place, without advancing ``lengths``: one call of the tier's update
        (route "decode" at T == 1, "prefill" above)."""
        k8, ks8 = quantize_kv(k)
        v8, vs8 = quantize_kv(v)
        self._update(*self._tensors(), self.lengths, k8.transpose(1, 2), ks8.transpose(1, 2),
                     v8.transpose(1, 2), vs8.transpose(1, 2), group=self.group, adv=adv)

    def _adv(self, T, advance):
        if advance is None:
            return torch.full_like(self.lengths, T)
        return advance.to(torch.int32)

    def update(self, k, v, advance=None):
        """Append k/v [B, T, KV, Dh] at each slot's length, flush every
        chunk the update completes, in place; ``advance`` [B] overrides how
        far each length moves (default T; lengths keep counting past S)."""
        adv = self._adv(k.shape[1], advance)
        self._write(k, v, adv)
        self.lengths += adv
        return self

    def update_and_attend(self, q, k, v, advance=None, window=0, scale=0.0, softcap=0.0,
                          sink_logits=None, tree_mask=None, alibi_slopes=None):
        """Write k/v, attend q [B, T, H, Dh] with the lengths from before
        (and the frontier from after) this step, and the window, scale,
        softcap, ALiBi slopes and learned sinks given, then advance."""
        reject_variants(type(self).__name__, tree_mask=tree_mask)
        adv = self._adv(k.shape[1], advance)
        new_lengths = self.lengths + adv
        self._write(k, v, adv)
        out = self._attention(q, *self._tensors(), self.lengths, new_lengths,
                              group=self.group, window=window, scale=scale, softcap=softcap,
                              alibi_slopes=alibi_slopes, sink_logits=sink_logits)
        self.lengths.copy_(new_lengths)
        return out

    def dequant_fp(self):
        """f32 K/V [B, KV, S, Dh] at the current lengths (the plain
        attention's operands; ``dequant_fp(lane=f32)`` of the JAX caches)."""
        k = kivi_dequant_k(self.kq, self.kchs, self.ktail, self.kts, self.lengths,
                           self.group)
        if self.V4:
            v = kivi_dequant_v4(self.vq, self.vs, self.vtail, self.vts, self.lengths,
                                self.group)
        else:
            v = self.vq.float() * self.vs[..., None]
        return k, v



class K4V8KVCache(_KiviKVCache):
    """K4V8: the KIVI K side with per-token int8 values. vq [B, KV, S, Dh]
    int8 + vs [B, KV, S] f32 hold V at every position; vtail/vts mirror the
    last 2G V rows. Port of ``protoquant_tpu/models/kv_cache.py:K4V8KVCache``
    (the JAX CLI's ``--kv-bits 6``)."""

    def _update(self, *args, **kw):
        k4v8_decode_update(*args, **kw)

    def _attention(self, *args, **kw):
        return k4v8_attention(*args, **kw)


class Int4KVCache(_KiviKVCache):
    """Int4 (KIVI): V packed like K, with per-token scales, parity-split:
    vq [B, KV, S/2, Dh] int8, vs [B, KV, 2, S/2] f32 (plane 0 even tokens,
    1 odd). Port of ``protoquant_tpu/models/kv_cache.py:Int4KVCache`` (the
    JAX CLI's ``--kv-bits 4``)."""

    V4 = True

    def _update(self, *args, **kw):
        kivi4_decode_update(*args, **kw)

    def _attention(self, *args, **kw):
        return int4_kv_attention(*args, **kw)
