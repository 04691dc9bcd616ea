"""Decode attention over the paged int8 KV pool: kernel and plain version.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas kernel
``protoquant_tpu/ops/paged_attention.py:_kernel``: it walks each row's page
table itself, so no contiguous window is ever gathered. The plain version
is the JAX package's gather path (``PagedInt8KVCache._gather_window``, then
the dense attention's plain version). Both take ALiBi slopes, as the JAX
function does, and raise ``NotImplementedError`` on any other variant
(learned sinks, which the JAX function does not take either).
"""

from __future__ import annotations

import torch

from . import _build
from .attention import int8_kv_attention_ref, reject_variants

_KERNEL_HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 8  # query heads per kv head the kernel holds
_MAX_PAGE = 256


def gather_window(kq, ks, vq, vs, page_table):
    """Each row's pages as a contiguous window: ([B, KV, maxP*ps, Dh] int8,
    [B, KV, maxP*ps] f32) for K and V; unmapped entries read page 0."""
    B, P = page_table.shape
    KV, ps = kq.shape[1], kq.shape[2]
    page = page_table.long().clamp_min(0)

    def payload(pool):
        return pool[page].transpose(1, 2).reshape(B, KV, P * ps, -1)

    def scales(pool):
        return pool[page][:, :, :, 0].transpose(1, 2).reshape(B, KV, P * ps)

    return payload(kq), scales(ks), payload(vq), scales(vs)


def paged_int8_attention_ref(q, kq, ks, vq, vs, page_table, lengths, alibi_slopes=None,
                             **variants):
    """Plain version (same contract as :func:`paged_int8_attention`)."""
    reject_variants("paged_int8_attention_ref", **variants)
    return int8_kv_attention_ref(q, *gather_window(kq, ks, vq, vs, page_table), lengths,
                                 alibi_slopes=alibi_slopes)


def paged_int8_attention(q, kq, ks, vq, vs, page_table, lengths, alibi_slopes=None,
                         **variants):
    """Decode attention through the page table.

    q: [B, 1, H, Dh] (this step's query, after RoPE); kq/vq: [P, KV, ps, Dh]
    int8 pools already holding this step's token; ks/vs: [P, KV, 1, ps] f32;
    page_table: [B, maxP] int32 (-1 unmapped, read as page 0); lengths: [B]
    int32, the lengths from before this step's write. Key slot s of table
    entry j sits at position j * ps + s and is visible iff that is <=
    lengths[b]. GQA: query head h * G + g reads kv head h. ``alibi_slopes``
    [H] f32: ALiBi, slope_h * (lengths[b] - position) off each score.
    Returns [B, 1, H, Dh] in q.dtype.
    """
    reject_variants("paged_int8_attention", **variants)
    if q.device.type == "cpu":
        return paged_int8_attention_ref(q, kq, ks, vq, vs, page_table, lengths, alibi_slopes)
    B, T, H, Dh = q.shape
    P, KV, ps, _ = kq.shape
    width = page_table.shape[1]
    if T != 1:
        raise ValueError(f"paged_int8_attention: decode only, got T={T}")
    if (H % KV or kq.shape != (P, KV, ps, Dh) or vq.shape != kq.shape
            or ks.shape != (P, KV, 1, ps) or vs.shape != ks.shape
            or page_table.shape != (B, width) or lengths.shape != (B,)):
        raise ValueError(f"paged_int8_attention: q {tuple(q.shape)}, pools "
                         f"{tuple(kq.shape)} / {tuple(ks.shape)}, table "
                         f"{tuple(page_table.shape)}, lengths {tuple(lengths.shape)}")
    if Dh not in _KERNEL_HEAD_DIMS or H // KV > _MAX_GROUP or not 0 < ps <= _MAX_PAGE:
        raise ValueError(f"paged_int8_attention: head_dim {Dh} (kernel takes "
                         f"{_KERNEL_HEAD_DIMS}), group {H // KV} (<= {_MAX_GROUP}), "
                         f"page_size {ps} (<= {_MAX_PAGE})")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"paged_int8_attention: unsupported dtype {q.dtype}")
    if kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise TypeError("paged_int8_attention: pools must be int8")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError("paged_int8_attention: pool scales must be float32")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_int8_attention: page_table and lengths must be int32")
    extra = []
    if alibi_slopes is not None:
        if tuple(alibi_slopes.shape) != (H,) or alibi_slopes.dtype != torch.float32:
            raise ValueError(f"paged_int8_attention: alibi_slopes must be [{H}] float32")
        extra.append(alibi_slopes)
    q = q.contiguous()
    dev = _build.same_device_contiguous("paged_int8_attention", q, kq, ks, vq, vs,
                                        page_table, lengths, *extra)
    if kq.data_ptr() % 16 or vq.data_ptr() % 16:
        raise ValueError("paged_int8_attention: pools must be 16-byte aligned")
    out = torch.empty_like(q)
    err = _build.lib().pq_paged_int8_attention(
        q.data_ptr(), _build.DTYPE_CODES[q.dtype], kq.data_ptr(), ks.data_ptr(),
        vq.data_ptr(), vs.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        None if alibi_slopes is None else alibi_slopes.data_ptr(), out.data_ptr(),
        B, H, KV, width, ps, Dh, float(Dh**-0.5),
        _build.stream_ptr(dev))
    _build.check(err, "pq_paged_int8_attention")
    paged_int8_attention.launches += 1
    return out


paged_int8_attention.launches = 0
