"""In-place decode writes into the int8 KV cache, dense and paged: kernels
and plain versions.

The kernels (``csrc/kv_scatter.cu``) replace the Pallas kernels
``protoquant_tpu/ops/kv_scatter.py:_scatter_kernel`` (dense) and
``_paged_scatter_kernel`` (paged). Every version updates the cache tensors
in place. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build


def kv_scatter_decode_ref(kq, ks, vq, vs, lengths, k8, ks_new, v8, vs_new):
    """Plain version (same contract as :func:`kv_scatter_decode`). A row at
    capacity rewrites the last position with its own value, so nothing on
    the host depends on the data (no sync; capturable in a CUDA graph)."""
    B, KV, S, Dh = kq.shape
    pos = lengths.long().clamp_min(0)
    keep = pos < S
    p = pos.clamp_max(S - 1)
    b = torch.arange(B, device=kq.device)
    for cache, new in ((kq, k8.reshape(B, KV, Dh)), (vq, v8.reshape(B, KV, Dh)),
                       (ks, ks_new.reshape(B, KV)), (vs, vs_new.reshape(B, KV))):
        mask = keep.reshape(B, *([1] * (new.dim() - 1)))
        cache[b, :, p] = torch.where(mask, new, cache[b, :, p])
    return kq, ks, vq, vs


def kv_scatter_decode(kq, ks, vq, vs, lengths, k8, ks_new, v8, vs_new):
    """Write one decode token per batch row into the int8 cache, in place.

    kq/vq: [B, KV, S, Dh] int8;  ks/vs: [B, KV, S] f32;  lengths: [B] int32
    k8/v8: [B, KV, 1, Dh] int8;  ks_new/vs_new: [B, KV, 1] f32
    Row b goes to position max(lengths[b], 0); a row at capacity
    (position >= S) drops its write. Returns the four cache tensors.
    """
    if kq.device.type == "cpu":
        return kv_scatter_decode_ref(kq, ks, vq, vs, lengths, k8, ks_new, v8, vs_new)
    B, KV, S, Dh = kq.shape
    shapes = {"ks": (ks, (B, KV, S)), "vq": (vq, (B, KV, S, Dh)),
              "vs": (vs, (B, KV, S)), "lengths": (lengths, (B,)),
              "k8": (k8, (B, KV, 1, Dh)), "v8": (v8, (B, KV, 1, Dh)),
              "ks_new": (ks_new, (B, KV, 1)), "vs_new": (vs_new, (B, KV, 1))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"kv_scatter_decode: {name} shape "
                             f"{tuple(t.shape)}, want {want}")
    for t, dt in ((kq, torch.int8), (vq, torch.int8), (k8, torch.int8),
                  (v8, torch.int8), (ks, torch.float32), (vs, torch.float32),
                  (ks_new, torch.float32), (vs_new, torch.float32),
                  (lengths, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"kv_scatter_decode: {t.dtype} where {dt} is due")
    dev = _build.same_device_contiguous("kv_scatter_decode", kq, ks, vq, vs, lengths,
                              k8, ks_new, v8, vs_new)
    err = _build.lib().pq_kv_scatter_decode(
        kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        lengths.data_ptr(), k8.data_ptr(), ks_new.data_ptr(), v8.data_ptr(),
        vs_new.data_ptr(), B, KV, S, Dh, _build.stream_ptr(dev))
    _build.check(err, "pq_kv_scatter_decode")
    kv_scatter_decode.launches += 1
    return kq, ks, vq, vs


kv_scatter_decode.launches = 0


def page_slots(page_table, pos, page_size: int, num_pages: int):
    """Where absolute positions ``pos`` [B, T] of each row live in the
    pools: (page [B, T], offset [B, T]), page ``page_table[b, pos // ps]``
    at ``pos % ps``. A write through an unmapped entry (-1) or past the
    table goes to the trash page ``num_pages - 1``, never into a live page.
    """
    width = page_table.shape[1]
    idx = pos // page_size
    page = page_table.long().gather(1, idx.clamp_max(width - 1))
    trash = torch.full_like(page, num_pages - 1)
    return torch.where((page < 0) | (idx >= width), trash, page), pos % page_size


def paged_kv_scatter_decode_ref(kq, ks, vq, vs, page_table, lengths,
                                k8, ks_new, v8, vs_new):
    """Plain version (same contract as :func:`paged_kv_scatter_decode`);
    nothing on the host depends on the data (no sync; capturable in a CUDA
    graph)."""
    P, KV, ps, Dh = kq.shape
    B = page_table.shape[0]
    page, off = page_slots(page_table, lengths.long().clamp_min(0)[:, None], ps, P)
    page, off = page[:, 0], off[:, 0]
    # advanced indices on dims 0 and 2 put the batch first: [B, KV, ...]
    kq[page, :, off] = k8.reshape(B, KV, Dh)
    vq[page, :, off] = v8.reshape(B, KV, Dh)
    ks[page, :, 0, off] = ks_new.reshape(B, KV)
    vs[page, :, 0, off] = vs_new.reshape(B, KV)
    return kq, ks, vq, vs


def paged_kv_scatter_decode(kq, ks, vq, vs, page_table, lengths,
                            k8, ks_new, v8, vs_new):
    """Write one decode token per batch row into its mapped page, in place.

    kq/vq: [P, KV, ps, Dh] int8 pools;  ks/vs: [P, KV, 1, ps] f32
    page_table: [B, maxP] int32 (-1 unmapped);  lengths: [B] int32
    k8/v8: [B, KV, 1, Dh] int8;  ks_new/vs_new: [B, KV, 1] f32
    Row b goes to page ``page_table[b, len // ps]`` at offset ``len % ps``
    (len = max(lengths[b], 0)); an unmapped entry, or ``len // ps >= maxP``,
    sends the write to the trash page P - 1. Returns the four pools.
    """
    if kq.device.type == "cpu":
        return paged_kv_scatter_decode_ref(kq, ks, vq, vs, page_table, lengths,
                                           k8, ks_new, v8, vs_new)
    P, KV, ps, Dh = kq.shape
    B, width = page_table.shape
    shapes = {"ks": (ks, (P, KV, 1, ps)), "vq": (vq, (P, KV, ps, Dh)),
              "vs": (vs, (P, KV, 1, ps)), "lengths": (lengths, (B,)),
              "k8": (k8, (B, KV, 1, Dh)), "v8": (v8, (B, KV, 1, Dh)),
              "ks_new": (ks_new, (B, KV, 1)), "vs_new": (vs_new, (B, KV, 1))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"paged_kv_scatter_decode: {name} shape "
                             f"{tuple(t.shape)}, want {want}")
    for t, dt in ((kq, torch.int8), (vq, torch.int8), (k8, torch.int8),
                  (v8, torch.int8), (ks, torch.float32), (vs, torch.float32),
                  (ks_new, torch.float32), (vs_new, torch.float32),
                  (page_table, torch.int32), (lengths, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"paged_kv_scatter_decode: {t.dtype} where {dt} is due")
    dev = _build.same_device_contiguous("paged_kv_scatter_decode", kq, ks, vq, vs,
                                        page_table, lengths, k8, ks_new, v8, vs_new)
    err = _build.lib().pq_paged_kv_scatter_decode(
        kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), k8.data_ptr(), ks_new.data_ptr(),
        v8.data_ptr(), vs_new.data_ptr(), B, width, P, KV, ps, Dh,
        _build.stream_ptr(dev))
    _build.check(err, "pq_paged_kv_scatter_decode")
    paged_kv_scatter_decode.launches += 1
    return kq, ks, vq, vs


paged_kv_scatter_decode.launches = 0
