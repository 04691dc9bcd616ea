"""Decode attention over the paged int8 KV pool: kernels and plain version.

Two kernels replace the Pallas kernel
``protoquant_tpu/ops/paged_attention.py:_kernel``, both walking each row's
page table themselves, so no contiguous window is ever gathered. A call
whose query rows a kv head fit one split block (:func:`paged_split_plan`:
every paged decode of every model, G <= 8 at Dh 64 and 128, G <= 4 at 256)
takes the split-S design of the dense caches (``csrc/attn_split.cuh``
with its paged addressing, instanced in ``attn_split_paged.cu``, merged by
``split_merge.cu``: blocks over fixed ranges of the table's columns, sized
from the table's width, dead ones exiting at once);
:func:`paged_attention_partials_ref` spells it out in plain PyTorch. Any
other call (G 8 at Dh 256) takes ``csrc/paged_attention.cu``, one block per
(kv head, b) walking the row's pages in series. The route is decided by
shape before launch. The plain version is the JAX package's gather path
(``PagedInt8KVCache._gather_window``, then the dense attention's plain
version). All take ALiBi slopes, as the JAX function does, and raise
``NotImplementedError`` on any other variant (learned sinks, which the JAX
function does not take either).
"""

from __future__ import annotations

import torch

from . import _build
from .attention import dense_attention_partials_ref, int8_kv_attention_ref, reject_variants

_KERNEL_HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 8  # query heads per kv head the kernels hold
_MAX_PAGE = 256
# The split design's geometry (csrc/attn_split.cuh): the columns of a split
# (AsGeom::SPAN), the query rows a block holds at each head dim
# (AsGeom::MAX_RB) and the most splits the merge takes (SP_MAX_SPLITS).
SPLIT_SPAN = 128
SPLIT_MAX_ROWS = {64: 16, 128: 8, 256: 4}
SPLIT_MAX_SPLITS = 2048


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


def paged_split_plan(H, KV, max_pages, page_size, head_dim):
    """(span, n_split) of the split decode over a table of ``max_pages``
    entries of ``page_size`` keys, or None where ``csrc/paged_attention.cu``
    takes the call: n_split = ceil(max_pages * page_size / span), sized from
    the table's width and never from the lengths; None where the G = H / KV
    query rows of a kv head do not fit a block (G > ``SPLIT_MAX_ROWS``) or
    the merge would take more than ``SPLIT_MAX_SPLITS``. The same plan as
    ``pq_paged_split_plan`` in ``csrc/attn_split.cu``, whose entry refuses
    a call that disagrees with it."""
    width = max_pages * page_size
    if KV <= 0 or H % KV or max_pages <= 0 or page_size <= 0 or width > 2**30:
        return None
    if H // KV > SPLIT_MAX_ROWS.get(head_dim, 0):
        return None
    n_split = -(-width // SPLIT_SPAN)
    return (SPLIT_SPAN, n_split) if n_split <= SPLIT_MAX_SPLITS else None


def paged_split_workspace(B, H, KV, head_dim, plan):
    """Shapes of the split decode's partials for ``plan`` (from
    :func:`paged_split_plan`): acc [B, KV, n_split, G, Dh] and (m, l) [B,
    KV, n_split, G, 2], f32, as :func:`paged_attention_partials_ref` returns
    them."""
    n_split = plan[1]
    return (B, KV, n_split, H // KV, head_dim), (B, KV, n_split, H // KV, 2)


def paged_attention_partials_ref(q, kq, ks, vq, vs, page_table, lengths, *, span,
                                 alibi_slopes=None):
    """The split design of the paged decode in plain PyTorch: for each (b,
    kv head), split i holds the table's virtual columns [i span, (i + 1)
    span) of its max_pages * page_size, column c read from pool[max(
    page_table[b, c // ps], 0), h, c % ps] (:func:`gather_window`), key c
    visible iff c <= lengths[b], ALiBi's slope * (lengths[b] - c) off its
    score. Per split and query row g: m = the largest visible score, l = sum
    e^(score - m), acc = sum e^(score - m) vs v; a split past the row's
    length is empty (m = NEG_INF, l = 0, acc = 0). Returns acc [B, KV,
    n_split, G, Dh], m and l [B, KV, n_split, G], f32, for
    ``merge_partials_ref``."""
    return dense_attention_partials_ref(q, *gather_window(kq, ks, vq, vs, page_table), lengths,
                                        span=span, alibi_slopes=alibi_slopes)


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
    if P * KV * ps >= 2**32:
        raise ValueError(f"paged_int8_attention: {P * KV * ps} pool rows (at most 2^32)")
    out = torch.empty_like(q)
    head = (q.data_ptr(), _build.DTYPE_CODES[q.dtype], kq.data_ptr(), ks.data_ptr(),
            vq.data_ptr(), vs.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            None if alibi_slopes is None else alibi_slopes.data_ptr(), out.data_ptr())
    plan = paged_split_plan(H, KV, width, ps, Dh)
    if plan is None:
        route, c_name = "walk", "pq_paged_int8_attention"
        err = _build.lib().pq_paged_int8_attention(*head, B, H, KV, width, ps, Dh,
                                                   float(Dh**-0.5), _build.stream_ptr(dev))
    else:  # the partials' workspace, from PyTorch's allocator: nothing kept between calls
        route, c_name = "split", "pq_paged_int8_attention_split"
        acc_shape, ml_shape = paged_split_workspace(B, H, KV, Dh, plan)
        part_acc = torch.empty(acc_shape, dtype=torch.float32, device=dev)
        part_ml = torch.empty(ml_shape, dtype=torch.float32, device=dev)
        err = _build.lib().pq_paged_int8_attention_split(
            *head, part_acc.data_ptr(), part_ml.data_ptr(), B, H, KV, width, ps, Dh,
            float(Dh**-0.5), plan[1], _build.stream_ptr(dev))
    _build.check(err, c_name)
    paged_int8_attention.launches += 1
    paged_int8_attention.routes[route] += 1
    return out


paged_int8_attention.launches = 0
# launches by kernel: "split" (attn_split_paged.cu and the merge), "walk"
# (paged_attention.cu)
paged_int8_attention.routes = {"split": 0, "walk": 0}
