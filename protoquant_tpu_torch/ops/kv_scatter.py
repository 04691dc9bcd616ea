"""In-place writes into the KV caches: kernels and plain versions.

The int8 kernels (``csrc/kv_scatter.cu``) replace the Pallas kernels
``protoquant_tpu/ops/kv_scatter.py:_scatter_kernel`` (dense) and
``_paged_scatter_kernel`` (paged), and its mixed K8V4 writer
``_scatter_mixed_kernel`` (int8 K, a nibble of packed int4 V); the KIVI
updates (``csrc/kivi_update.cu``) replace ``k4v8_decode_update`` and
``kivi4_decode_update`` of the same file, and take the JAX caches' XLA
update of a prefill chunk too (``_xla_update``, the same function for T >
1 new rows a slot): each call is one launch (tail writes and every chunk
flush), counted on route "decode" (T = 1) or "prefill" (T > 1). Every
version updates the cache tensors in place. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..core import numerics
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


def _dense_scatter_launch(name, fn, v4, kq, ks, vq, vs, lengths, k8, ks_new, v8, vs_new):
    """Check the operands of a dense decode writer of ``csrc/kv_scatter.cu``
    (V int8 per token, or with ``v4`` packed token pairs with parity-split
    scales), launch it in place and count the launch on ``fn``."""
    B, KV, S, Dh = kq.shape
    v_shape = ((B, KV, S // 2, Dh), (B, KV, 2, S // 2)) if v4 else ((B, KV, S, Dh), (B, KV, S))
    if v4 and S % 2:
        raise ValueError(f"{name}: max_seq {S} must be even")
    shapes = {"ks": (ks, (B, KV, S)), "vq": (vq, v_shape[0]),
              "vs": (vs, v_shape[1]), "lengths": (lengths, (B,)),
              "k8": (k8, (B, KV, 1, Dh)), "v8": (v8, (B, KV, 1, Dh)),
              "ks_new": (ks_new, (B, KV, 1)), "vs_new": (vs_new, (B, KV, 1))}
    for key, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)}, want {want}")
    for t, dt in ((kq, torch.int8), (vq, torch.int8), (k8, torch.int8),
                  (v8, torch.int8), (ks, torch.float32), (vs, torch.float32),
                  (ks_new, torch.float32), (vs_new, torch.float32),
                  (lengths, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name}: {t.dtype} where {dt} is due")
    dev = _build.same_device_contiguous(name, kq, ks, vq, vs, lengths, k8, ks_new, v8, vs_new)
    c_name = "pq_kv_mixed_scatter_decode" if v4 else "pq_kv_scatter_decode"
    err = getattr(_build.lib(), c_name)(
        kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        lengths.data_ptr(), k8.data_ptr(), ks_new.data_ptr(), v8.data_ptr(),
        vs_new.data_ptr(), B, KV, S, Dh, _build.stream_ptr(dev))
    _build.check(err, c_name)
    fn.launches += 1
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
    return _dense_scatter_launch("kv_scatter_decode", kv_scatter_decode, False, kq, ks, vq,
                                 vs, lengths, k8, ks_new, v8, vs_new)


kv_scatter_decode.launches = 0


def merge_nibble(cur, nib, parity):
    """Bytes ``cur`` with the nibble of ``parity`` (0 low, 1 high; a tensor
    broadcasting against them) replaced by the nibble values ``nib``, the
    other nibble kept: the read-modify-write of one packed int4 token."""
    c, n = cur.to(torch.int32), nib.to(torch.int32) & 0x0F
    low = torch.as_tensor(parity, device=cur.device) == 0
    merged = torch.where(low, (c & ~0x0F) | n, (c & 0x0F) | (n << 4))
    return (merged & 0xFF).to(torch.uint8).view(torch.int8)


def kv_mixed_scatter_decode_ref(kq, ks, vq, vs, lengths, k8, ks_new, v4, vs_new):
    """Plain version (same contract as :func:`kv_mixed_scatter_decode`);
    masked writes at clamped positions, no host sync."""
    B, KV, S, Dh = kq.shape
    pos = lengths.long().clamp_min(0)
    keep = pos < S
    p = pos.clamp_max(S - 1)
    b = torch.arange(B, device=kq.device)
    _put_row(kq, ks, k8.reshape(B, KV, Dh), ks_new.reshape(B, KV), b, p, keep)
    row, parity = p // 2, p % 2
    merged = merge_nibble(vq[b, :, row], v4.reshape(B, KV, Dh), parity[:, None, None])
    vq[b, :, row] = torch.where(keep[:, None, None], merged, vq[b, :, row])
    vs[b, :, parity, row] = torch.where(keep[:, None], vs_new.reshape(B, KV),
                                        vs[b, :, parity, row])
    return kq, ks, vq, vs


def kv_mixed_scatter_decode(kq, ks, vq, vs, lengths, k8, ks_new, v4, vs_new):
    """Write one decode token per batch row into the K8V4 cache, in place.

    kq: [B, KV, S, Dh] int8;  ks: [B, KV, S] f32;  lengths: [B] int32
    vq: [B, KV, S/2, Dh] int8 packed token pairs;  vs: [B, KV, 2, S/2] f32
    k8: [B, KV, 1, Dh] int8;  v4: [B, KV, 1, Dh] int8 nibbles in [-7, 7]
    ks_new/vs_new: [B, KV, 1] f32.
    With ln = max(lengths[b], 0) < S: K row ln and its scale; the nibble of
    parity ln % 2 of byte row ln // 2 (the other nibble kept) and vs[b, :,
    ln % 2, ln // 2]. A row at capacity drops its write. Returns the four
    cache tensors. Replaces ``protoquant_tpu/ops/kv_scatter.py:
    kv_mixed_scatter_decode`` (``_scatter_mixed_kernel``).
    """
    if kq.device.type == "cpu":
        return kv_mixed_scatter_decode_ref(kq, ks, vq, vs, lengths, k8, ks_new, v4, vs_new)
    return _dense_scatter_launch("kv_mixed_scatter_decode", kv_mixed_scatter_decode, True,
                                 kq, ks, vq, vs, lengths, k8, ks_new, v4, vs_new)


kv_mixed_scatter_decode.launches = 0


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


# -- KIVI decode updates (K4V8 and Int4 caches) ----------------------------------


def _put_row(tail, ts, new, new_s, b, row, keep):
    """Row ``row[b]`` of tail [B, KV, n, Dh] / ts [B, KV, n] takes the new
    token (new [B, KV, Dh], new_s [B, KV]) where ``keep[b]``."""
    tail[b, :, row] = torch.where(keep[:, None, None], new, tail[b, :, row])
    ts[b, :, row] = torch.where(keep[:, None], new_s, ts[b, :, row])


def gather_rows(x, rows):
    """x [B, KV, n, ...] at rows ``rows`` [B, m] of dim 2 -> [B, KV, m, ...]."""
    idx = rows[:, None, :]
    if x.dim() == 4:
        idx = idx[..., None]
    return x.gather(2, idx.expand(*x.shape[:2], rows.shape[1], *x.shape[3:]))


def put_chunk(kq, kchs, packed_k, s_ch, c, flush, G):
    """Where ``flush[b]``, write chunk ``c[b]``'s packed rows c*G/2 ... and
    its channel scales; elsewhere rewrite what is there (no host branch).
    Returns the packed rows [B, G/2] written."""
    B, NC = kq.shape[0], kchs.shape[2]
    b = torch.arange(B, device=kq.device)
    cc = c.clamp(0, NC - 1)
    rows = cc[:, None] * (G // 2) + torch.arange(G // 2, device=kq.device)
    cur = kq[b[:, None], :, rows]  # [B, G/2, KV, Dh]
    kq[b[:, None], :, rows] = torch.where(flush[:, None, None, None],
                                          packed_k.transpose(1, 2), cur)
    kchs[b, :, cc] = torch.where(flush[:, None, None], s_ch, kchs[b, :, cc])
    return rows


def put_v_chunk(vq, vs, packed_v, s_v, rows, flush):
    """Int4 cache: where ``flush[b]``, write the packed V rows ``rows[b]``
    (from :func:`put_chunk`) and their per-token scales, even tokens into
    plane 0 of vs [B, KV, 2, S/2], odd ones into plane 1."""
    b = torch.arange(vq.shape[0], device=vq.device)[:, None]
    vq[b, :, rows] = torch.where(flush[:, None, None, None], packed_v.transpose(1, 2),
                                 vq[b, :, rows])
    for parity in (0, 1):
        vs[b, :, parity, rows] = torch.where(
            flush[:, None, None], s_v[:, :, parity::2].transpose(1, 2), vs[b, :, parity, rows])


def _decode_flush_state(lengths, adv, G, S):
    """(ln, chunk index, flush mask, tail rows of the chunk [B, G]): chunk
    ``ln // G`` flushes when this step's advance completes it."""
    ln = lengths.long().clamp_min(0)
    c = ln // G
    new_len = (lengths.long() + adv.long()).clamp(0, S)
    flush = ((c + 1) * G <= new_len) & ((c + 1) * G > ln)
    crow = ((c * G) % (2 * G))[:, None] + torch.arange(G, device=lengths.device)
    return ln, c, flush, crow


def kivi_route(T: int) -> str:
    """The route of a KIVI update of T new rows a slot: "decode" (T = 1,
    the decode step's semantics) or "prefill" (T > 1)."""
    return "decode" if T == 1 else "prefill"


def _full(lengths, T):
    return torch.full_like(lengths, T, dtype=torch.int32)


def _kivi4_decode_ref(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                      k8, ks_new, v8, vs_new, G, adv):
    """The decode route of :func:`kivi4_decode_update_ref`."""
    B, KV, S2, Dh = kq.shape
    S = 2 * S2
    ln, c, flush, crow = _decode_flush_state(lengths, adv, G, S)
    b = torch.arange(B, device=kq.device)
    row, keep = ln % (2 * G), ln < S
    _put_row(ktail, kts, k8.reshape(B, KV, Dh), ks_new.reshape(B, KV), b, row, keep)
    _put_row(vtail, vts, v8.reshape(B, KV, Dh), vs_new.reshape(B, KV), b, row, keep)
    packed_k, s_ch, packed_v, s_v = numerics.kivi_chunk_quantize(
        gather_rows(ktail, crow), gather_rows(kts, crow),
        gather_rows(vtail, crow), gather_rows(vts, crow))
    rows = put_chunk(kq, kchs, packed_k, s_ch, c, flush, G)
    put_v_chunk(vq, vs, packed_v, s_v, rows, flush)


def _k4v8_decode_ref(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                     k8, ks_new, v8, vs_new, G, adv):
    """The decode route of :func:`k4v8_decode_update_ref`."""
    B, KV, S, Dh = vq.shape
    ln, c, flush, crow = _decode_flush_state(lengths, adv, G, S)
    b = torch.arange(B, device=kq.device)
    row, keep = ln % (2 * G), ln < S
    _put_row(ktail, kts, k8.reshape(B, KV, Dh), ks_new.reshape(B, KV), b, row, keep)
    _put_row(vtail, vts, v8.reshape(B, KV, Dh), vs_new.reshape(B, KV), b, row, keep)
    _put_row(vq, vs, v8.reshape(B, KV, Dh), vs_new.reshape(B, KV), b, ln.clamp_max(S - 1), keep)
    packed_k, s_ch = numerics.kivi_chunk_quantize_k(gather_rows(ktail, crow),
                                                    gather_rows(kts, crow))
    put_chunk(kq, kchs, packed_k, s_ch, c, flush, G)


def kivi_prefill_update_ref(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                            k8, ks_new, v8, vs_new, *, group: int, adv=None, v4: bool):
    """The prefill route (T > 1 new rows a slot) of the KIVI updates, plain:
    :func:`kivi4_decode_update_ref` with ``v4``, else
    :func:`k4v8_decode_update_ref`; the JAX caches' ``_xla_update``.

    k8/v8 [B, KV, T, Dh] int8, ks_new/vs_new [B, KV, T] f32; adv [B] (default
    T). With L = max(lengths, 0): up to (G - 1 + T) // G chunk flushes
    (chunk c = L // G + f while (c + 1) G <= min(L + adv, S)) whose token
    rows come from the old tails (positions below L) or from the new rows
    (position p: row min(p - L, T - 1)); then the tails take the latest new
    rows, anchored at [L, L + T) (positions past S included, as in the JAX
    package); K4V8's V rows go to vq/vs at the positions below S. Masked
    writes only, no host branch on the lengths. Returns the eight tensors."""
    B, KV, T, Dh = k8.shape
    G, S, dev = group, 2 * kq.shape[2], k8.device
    adv = _full(lengths, T) if adv is None else adv
    L_old = lengths.long().clamp_min(0)
    L_new = (L_old + adv.long()).clamp_max(S)
    if not v4:  # V: direct int8 writes at [L, L + T), past S dropped
        pos = L_old[:, None] + torch.arange(T, device=dev)[None, :]
        keep = pos < S
        bi, si = torch.arange(B, device=dev)[:, None].expand(B, T)[keep], pos[keep]
        vq[bi, :, si] = v8.transpose(1, 2)[keep]
        vs[bi, :, si] = vs_new.transpose(1, 2)[keep]

    def chunk_rows(x8, xs8, xtail, xts, pos, use_tail):
        idx = (pos - L_old[:, None]).clamp(0, T - 1)
        row = pos % (2 * G)
        c8 = torch.where(use_tail[:, None, :, None], gather_rows(xtail, row),
                         gather_rows(x8, idx))
        cs = torch.where(use_tail[:, None, :], gather_rows(xts, row), gather_rows(xs8, idx))
        return c8, cs

    j = torch.arange(G, device=dev)
    for f in range((G - 1 + T) // G):
        c = L_old // G + f
        flush = (c + 1) * G <= L_new
        pos = c[:, None] * G + j[None, :]
        use_tail = pos < L_old[:, None]
        packed_k, s_ch = numerics.kivi_chunk_quantize_k(
            *chunk_rows(k8, ks_new, ktail, kts, pos, use_tail))
        rows = put_chunk(kq, kchs, packed_k, s_ch, c, flush, G)
        if v4:
            packed_v, s_v = numerics.kivi_chunk_quantize_v(
                *chunk_rows(v8, vs_new, vtail, vts, pos, use_tail))
            put_v_chunk(vq, vs, packed_v, s_v, rows, flush)

    j2 = torch.arange(2 * G, device=dev)[None, :]
    w_last = L_old[:, None] + T - 1
    p_j = w_last - (w_last - j2) % (2 * G)  # the latest written position = j mod 2G
    fresh = p_j >= L_old[:, None]
    idx = (p_j - L_old[:, None]).clamp(0, T - 1)
    for tail, ts, x8, xs8 in ((ktail, kts, k8, ks_new), (vtail, vts, v8, vs_new)):
        tail.copy_(torch.where(fresh[:, None, :, None], gather_rows(x8, idx), tail))
        ts.copy_(torch.where(fresh[:, None, :], gather_rows(xs8, idx), ts))
    return kq, kchs, vq, vs, ktail, kts, vtail, vts


def kivi4_decode_update_ref(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                            k8, ks_new, v8, vs_new, *, group: int, adv=None):
    """Plain version of :func:`kivi4_decode_update` (same contract), by
    route. Masks and index writes at clamped positions: at T = 1 nothing on
    the host depends on the data (no sync)."""
    T = k8.shape[2]
    adv = _full(lengths, T) if adv is None else adv
    if kivi_route(T) == "prefill":
        return kivi_prefill_update_ref(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                                       k8, ks_new, v8, vs_new, group=group, adv=adv, v4=True)
    _kivi4_decode_ref(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, k8, ks_new, v8,
                      vs_new, group, adv)
    return kq, kchs, vq, vs, ktail, kts, vtail, vts


def k4v8_decode_update_ref(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                           k8, ks_new, v8, vs_new, *, group: int, adv=None):
    """Plain version of :func:`k4v8_decode_update` (same contract), by
    route."""
    T = k8.shape[2]
    adv = _full(lengths, T) if adv is None else adv
    if kivi_route(T) == "prefill":
        return kivi_prefill_update_ref(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                                       k8, ks_new, v8, vs_new, group=group, adv=adv, v4=False)
    _k4v8_decode_ref(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths, k8, ks_new, v8,
                     vs_new, group, adv)
    return kq, kchs, vq, vs, ktail, kts, vtail, vts


def kivi_div_check(xs: torch.Tensor) -> int:
    """How many quotients x / s of the KIVI update kernel's division differ
    in their bits from IEEE division, over s = every f32 significand in [1,
    2) and x in ``xs`` (f32 on the card). A check for the card tests."""
    if xs.device.type != "cuda" or xs.dtype != torch.float32 or not xs.is_contiguous():
        raise ValueError("kivi_div_check: a contiguous f32 CUDA tensor")
    bad = torch.zeros(1, dtype=torch.int64, device=xs.device)
    _build.check(_build.lib().pq_kivi_div_check(xs.data_ptr(), xs.numel(), bad.data_ptr(),
                                                _build.stream_ptr(xs.device)),
                 "pq_kivi_div_check")
    return int(bad.item())


# head dims the KIVI update kernel is instanced for (csrc/kivi_update.cu)
KIVI_UPDATE_HEAD_DIMS = (32, 64, 128, 256)


def _row_strides(t):
    """Element strides of ``t`` with 0 for its dims of size 1 (never stepped)."""
    return tuple(s if n > 1 else 0 for n, s in zip(t.shape, t.stride()))


def _kivi_update_launch(name, fn, v4, kq, kchs, vq, vs, ktail, kts, vtail, vts,
                        lengths, k8, ks_new, v8, vs_new, group, adv):
    """Check the operands of a KIVI update, launch ``csrc/kivi_update.cu``
    on the route of its T and count it on ``fn``."""
    B, KV, S2, Dh = kq.shape
    S, G, T = 2 * S2, group, k8.shape[2]
    route = kivi_route(T)
    if G < 2 or G % 2 or S % G:
        raise ValueError(f"{name}: group {G} must be even and divide max_seq {S}")
    if Dh not in KIVI_UPDATE_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {Dh} must be one of {KIVI_UPDATE_HEAD_DIMS}")
    if T < 1:
        raise ValueError(f"{name}: no new rows")
    adv = _full(lengths, T) if adv is None else adv
    v_shape = ((B, KV, S2, Dh), (B, KV, 2, S2)) if v4 else ((B, KV, S, Dh), (B, KV, S))
    shapes = {"kchs": (kchs, (B, KV, S // G, Dh)), "vq": (vq, v_shape[0]),
              "vs": (vs, v_shape[1]), "ktail": (ktail, (B, KV, 2 * G, Dh)),
              "kts": (kts, (B, KV, 2 * G)), "vtail": (vtail, (B, KV, 2 * G, Dh)),
              "vts": (vts, (B, KV, 2 * G)), "lengths": (lengths, (B,)), "adv": (adv, (B,)),
              "k8": (k8, (B, KV, T, Dh)), "v8": (v8, (B, KV, T, Dh)),
              "ks_new": (ks_new, (B, KV, T)), "vs_new": (vs_new, (B, KV, T))}
    for key, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)}, want {want}")
    for t in (kq, vq, ktail, vtail, k8, v8):
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: {t.dtype} where torch.int8 is due")
    for t in (kchs, vs, kts, vts, ks_new, vs_new):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t.dtype} where torch.float32 is due")
    if lengths.dtype != torch.int32 or adv.dtype != torch.int32:
        raise TypeError(f"{name}: lengths and adv must be int32")
    dev = _build.same_device_contiguous(name, kq, kchs, vq, vs, ktail, kts, vtail, vts,
                                        lengths, adv)
    # the new rows: any strides, each row's Dh bytes contiguous and 16-byte aligned
    rows, scales = _row_strides(k8), _row_strides(ks_new)
    if _row_strides(v8) != rows or _row_strides(vs_new) != scales:
        raise ValueError(f"{name}: k8/v8 and ks_new/vs_new must share their strides")
    if rows[3] not in (0, 1) or min(rows + scales) < 0:
        raise ValueError(f"{name}: each new row's {Dh} bytes must be contiguous")
    if any(t.data_ptr() % 16 for t in (kq, vq, ktail, vtail, k8, v8)) or any(
            s % 16 for s in rows[:3]):
        raise ValueError(f"{name}: the int8 rows must start at 16-byte aligned addresses")
    for t in (k8, ks_new, v8, vs_new):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    c_name = "pq_kivi4_decode_update" if v4 else "pq_k4v8_decode_update"
    err = getattr(_build.lib(), c_name)(
        kq.data_ptr(), kchs.data_ptr(), vq.data_ptr(), vs.data_ptr(), ktail.data_ptr(),
        kts.data_ptr(), vtail.data_ptr(), vts.data_ptr(), lengths.data_ptr(),
        adv.data_ptr(), k8.data_ptr(), ks_new.data_ptr(), v8.data_ptr(),
        vs_new.data_ptr(), B, KV, S, Dh, G, T, *rows[:3], *scales, int(route == "prefill"),
        _build.stream_ptr(dev))
    _build.check(err, c_name)
    fn.launches += 1
    fn.routes[route] += 1
    return kq, kchs, vq, vs, ktail, kts, vtail, vts


def kivi4_decode_update(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                        k8, ks_new, v8, vs_new, *, group: int, adv=None):
    """T new K/V rows per batch row into the Int4 (KIVI) cache, in place:
    the whole update in one launch, on route "decode" (T = 1) or "prefill"
    (T > 1, :func:`kivi_prefill_update_ref`'s contract).

    kq/vq: [B, KV, S/2, Dh] int8 packed nibbles;  kchs: [B, KV, S/G, Dh] f32
    vs: [B, KV, 2, S/2] f32 (parity-split);  ktail/vtail: [B, KV, 2G, Dh]
    int8;  kts/vts: [B, KV, 2G] f32;  lengths/adv: [B] int32 (adv default T)
    k8/v8: [B, KV, T, Dh] int8;  ks_new/vs_new: [B, KV, T] f32 (any strides
    with each row's Dh bytes contiguous).
    Decode, with ln = max(lengths, 0): the new K/V rows go to tail row ln
    mod 2G when ln < S; chunk c = ln // G is requantized from the updated
    tails into the packed store (K per channel, V per token) when (c + 1) G
    <= min(lengths + adv, S). Returns the eight cache tensors.
    Replaces ``protoquant_tpu/ops/kv_scatter.py:kivi4_decode_update`` (its
    XLA insert and flush math and its Pallas ``_kivi4_flush_kernel``) and
    the JAX ``Int4KVCache._xla_update``.
    """
    if kq.device.type == "cpu":
        return kivi4_decode_update_ref(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                                       k8, ks_new, v8, vs_new, group=group, adv=adv)
    return _kivi_update_launch("kivi4_decode_update", kivi4_decode_update, True, kq, kchs,
                               vq, vs, ktail, kts, vtail, vts, lengths, k8, ks_new, v8,
                               vs_new, group, adv)


kivi4_decode_update.launches = 0
kivi4_decode_update.routes = {"decode": 0, "prefill": 0}


def k4v8_decode_update(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                       k8, ks_new, v8, vs_new, *, group: int, adv=None):
    """T new rows per batch row into the K4V8 cache, in place: the K side
    of :func:`kivi4_decode_update` (tail writes, K chunk flushes), the V
    rows and scales written at their positions below S into vq [B, KV, S,
    Dh] / vs [B, KV, S] and into the V tail mirror; the same two routes.
    Returns the eight cache tensors. Replaces
    ``protoquant_tpu/ops/kv_scatter.py:k4v8_decode_update`` (its XLA math
    and its Pallas ``_k4v8_write_kernel``) and the JAX
    ``K4V8KVCache._xla_update``."""
    if kq.device.type == "cpu":
        return k4v8_decode_update_ref(kq, kchs, vq, vs, ktail, kts, vtail, vts, lengths,
                                      k8, ks_new, v8, vs_new, group=group, adv=adv)
    return _kivi_update_launch("k4v8_decode_update", k4v8_decode_update, False, kq, kchs,
                               vq, vs, ktail, kts, vtail, vts, lengths, k8, ks_new, v8,
                               vs_new, group, adv)


k4v8_decode_update.launches = 0
k4v8_decode_update.routes = {"decode": 0, "prefill": 0}
